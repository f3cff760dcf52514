"""The reference's 'simple' program family in one program: float32,
float64, reversible integer and interpolating-wavelet round trips.

The port of ``examples/simple_variants.py`` on ``libdwt_torch`` (simple,
simple-double, simple-int, simple-interpl).  Each prints the round-trip
error; integers must reconstruct EXACTLY.

    python examples_torch/simple_variants.py --size 512 --levels 3 [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from libdwt_torch import fdwt2, idwt2
    from libdwt_torch.utils.device import resolve_device
    from libdwt_torch.utils.testimg import psnr, test_image

    dev = resolve_device(args.device)
    n, j = args.size, args.levels
    img = test_image(n, n)

    # float32 (the 'simple' program)
    x = torch.as_tensor(img, dtype=torch.float32, device=dev)
    rec = idwt2(fdwt2(x, "cdf97", j), "cdf97", j)
    err = float((rec - x).abs().max())
    print(f"float32  cdf97  J={j}: max|err|={err:.3e} "
          f"psnr={psnr(x, rec):.1f} dB")
    assert err <= 1e-3  # the reference's epsilon (libdwt.c:1593-1620)

    # float64 (the 'simple-double' program)
    xd = torch.as_tensor(img, dtype=torch.float64, device=dev)
    recd = idwt2(fdwt2(xd, "cdf97", j), "cdf97", j)
    errd = float((recd - xd).abs().max())
    print(f"float64  cdf97  J={j}: max|err|={errd:.3e}")
    assert errd < 1e-9

    # reversible integer CDF 5/3 (the 'simple-int' program): bit-exact
    xi = torch.as_tensor((img * 255).astype(np.int32), device=dev)
    reci = idwt2(fdwt2(xi, "cdf53", j), "cdf53", j)
    exact = bool((reci == xi).all())
    print(f"int32    cdf53  J={j}: bit-exact={exact}")
    assert exact

    # interpolating 5/3 (the 'simple-interpl' program)
    ri = idwt2(fdwt2(x, "interp53", j), "interp53", j)
    erri = float((ri - x).abs().max())
    print(f"float32  interp53 J={j}: max|err|={erri:.3e}")
    assert erri <= 1e-3
    print("all simple variants round-trip OK")


if __name__ == "__main__":
    main()
