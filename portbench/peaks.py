"""Published peak rates of the cards the benchmark may run on.

NVIDIA's data sheets, dense rates, at the card's full power limit (the
run prints ``power.limit`` beside every number).  Integer ALU rates are
not published; a Hopper SM has 64 INT32 lanes against 128 FP32 lanes,
so the integer rate is taken as half the float32 rate (a multiply-add
counting 2, as in the float32 rate).
"""
from __future__ import annotations

__all__ = ["PEAKS", "card_peaks", "least_seconds"]

#: name fragment (matched in order against torch.cuda.get_device_name())
#: -> (memory bytes/s, float32 FLOP/s outside the tensor cores, int32 op/s)
PEAKS = (
    ("H100 PCIe", 2.0e12, 51.2e12, 25.6e12),
    ("H100 NVL", 3.9e12, 60.0e12, 30.0e12),
    ("H200", 4.8e12, 67.0e12, 33.5e12),
    ("H100", 3.35e12, 67.0e12, 33.5e12),
)


def card_peaks(name: str):
    """(bytes/s, float op/s, int op/s) of the card, or None if unknown."""
    for key, bw, flops, iops in PEAKS:
        if key in name:
            return bw, flops, iops
    return None


def least_seconds(nbytes: float, ops: float, integer: bool, name: str):
    """The least time the card could take for the work, or None."""
    peaks = card_peaks(name)
    if peaks is None:
        return None
    bw, flops, iops = peaks
    return max(nbytes / bw, ops / (iops if integer else flops))
