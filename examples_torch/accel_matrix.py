"""The accel-matrix test app: every impl x dtype x layout, pass/fail.

The port of ``examples/accel_matrix.py`` on ``libdwt_torch``: the
kernel-strategy axis (impl=separable/fused/streamed, plus the
interleaved in-place layout) x f32/f64/i32, each cell fwd -> inv ->
compare (float eps=1e-3; int exact).  On the card 'fused' and 'streamed'
run the fused and streamed pyramid kernels.

    python examples_torch/accel_matrix.py [--size 256] [--levels 3] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.api import waverec2, wavedec2  # noqa: E402
from libdwt_torch.ops.interleaved import fdwt2_interleaved, idwt2_interleaved  # noqa: E402
from libdwt_torch.ops.streamed import streamed_supported  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def roundtrip(impl, dtype, layout, size, levels, wavelet, device):
    x = torch.as_tensor(test_image(size, size, dtype=dtype), device=device)
    if layout == "interleaved":
        y = fdwt2_interleaved(x, wavelet, levels)
        r = idwt2_interleaved(y, wavelet, levels)
    else:
        coeffs = wavedec2(x, wavelet, levels, impl=impl)
        r = waverec2(coeffs, wavelet, impl=impl)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return bool((r == x).all())
    return float((r - x).abs().max()) <= 1e-3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cells = []
    for impl in ("separable", "fused", "streamed"):
        for dtype, wavelet in ((np.float32, "cdf97"), (np.float64, "cdf97"),
                               (np.int32, "cdf53")):
            if impl != "separable" and dtype == np.float64:
                continue  # the reference's grid: float32/int for the kernels
            cells.append((impl, dtype, wavelet, "packed"))
    cells.append(("inplace", np.float32, "cdf53", "interleaved"))
    cells.append(("inplace", np.int32, "cdf53", "interleaved"))

    failures = 0
    for impl, dtype, wavelet, layout in cells:
        if impl == "streamed" and not streamed_supported(
                (args.size, args.size), wavelet, 0,
                levels=min(args.levels, 2)):
            # the strip pipeline legitimately declines tiny frames
            # (>= 2 strips needed); the reference's accel types skip
            # unsupported configs the same way
            print(f"{impl:10s} {np.dtype(dtype).name:8s} {wavelet:6s} "
                  f"{layout:12s} skip (geometry)")
            continue
        try:
            ok = roundtrip(impl, dtype, layout, args.size, args.levels,
                           wavelet, dev)
            msg = "ok" if ok else "FAIL (tolerance)"
        except Exception as e:  # noqa: BLE001 - the grid reports, like test.c
            ok, msg = False, f"FAIL ({type(e).__name__}: {str(e)[:50]})"
        failures += not ok
        print(f"{impl:10s} {np.dtype(dtype).name:8s} {wavelet:6s} "
              f"{layout:12s} {msg}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
