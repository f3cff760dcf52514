"""Device self-test: run the round-trip matrix on a device.

The port of ``libdwt_tpu.selftest``, the analogue of libdwt's self-check
layer: dwt_util_test (libdwt.c:20114) and the dwt_util_test_cdf97_2_*
round-trip family (:23788-24334) exercised over every kernel variant by
examples/test/test.c:29-61.  Returns a report dict; every entry is True
on a healthy install.

Each case reads back one scalar error per round trip.  On the card the
fused round trip is the single-level kernels B1 then B4; on the CPU their
plain versions.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["selftest"]


def selftest(size: int = 64, verbose: bool = False, device=None) -> Dict[str, bool]:
    """Round-trip every wavelet x dtype x impl combination on ``device``
    (default: the card; without CUDA that raises, pass ``device='cpu'``);
    returns {case_name: passed}."""
    from libdwt_torch import REGISTRY, fdwt2, idwt2, wavedec2, waverec2
    from libdwt_torch.ops.fused import (fused_dwt2_level, fused_idwt2_level,
                                        fused_supported)
    from libdwt_torch.utils.device import as_tensor
    from libdwt_torch.utils.testimg import EPS, test_image

    report: Dict[str, bool] = {}
    imgf = as_tensor(test_image(size, size, dtype=np.float32), device)
    imgi = as_tensor(test_image(size, size, dtype=np.int32), device)

    def max_err(fn, x):
        """Transform, invert, read back the scalar max|err|."""
        return float((fn(x) - x).abs().max().item())

    for name, wavelet in sorted(REGISTRY.items()):
        report[f"{name}_f32_packed"] = (
            max_err(lambda a, n=name: idwt2(fdwt2(a, n, 3), n, 3), imgf)
            <= EPS
        )
        report[f"{name}_f32_pytree"] = (
            max_err(lambda a, n=name: waverec2(wavedec2(a, n, 3), n), imgf)
            <= EPS
        )
        if wavelet.has_int:
            report[f"{name}_i32_exact"] = (
                max_err(lambda a, n=name: idwt2(fdwt2(a, n, 3), n, 3), imgi)
                == 0.0
            )
        if fused_supported(name):
            def rt_fused(a, n=name):
                bands = fused_dwt2_level(a, n)
                return fused_idwt2_level(*bands, n)

            try:
                report[f"{name}_fused"] = max_err(rt_fused, imgf) <= EPS
            except Exception:
                report[f"{name}_fused"] = False

    if verbose:
        for k, ok in sorted(report.items()):
            print(f"  {'PASS' if ok else 'FAIL'} {k}")
    return report


if __name__ == "__main__":
    from libdwt_torch.utils.perf import info

    rep = selftest(verbose=True)
    bad = [k for k, v in rep.items() if not v]
    print(f"{len(rep) - len(bad)}/{len(rep)} self-tests passed on "
          f"{info()['device_kind']}")
    raise SystemExit(1 if bad else 0)
