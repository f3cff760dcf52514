"""Print library / platform / device information.

The port of ``examples/info.py`` on ``libdwt_torch`` (dwt_util_print_info:
version, platform, defaults); equivalent to ``python -m libdwt_torch``.

    python examples_torch/info.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import libdwt_torch
    from libdwt_torch.api import get_impl
    from libdwt_torch.utils.device import resolve_device
    from libdwt_torch.utils.perf import info

    resolve_device(args.device)
    print(f"libdwt_torch {getattr(libdwt_torch, '__version__', 'dev')}")
    for key, val in info().items():
        print(f"  {key}: {val}")
    print(f"  default impl: {get_impl()}")
    from libdwt_torch.models.wavelets import REGISTRY

    print(f"  wavelets: {', '.join(sorted(REGISTRY))}")


if __name__ == "__main__":
    main()
