"""CLI entry: ``python -m libdwt_torch [--json]`` prints system/device info.

The port of ``libdwt_tpu.__main__``, the analogue of dwt_util_print_info
(libdwt.c:20604-20638) and the examples/info program: platform, device,
host geometry, native backend availability, and registered wavelets.
"""
import json
import sys

from libdwt_torch import REGISTRY, __version__
from libdwt_torch.utils.perf import info


def main():
    data = {"version": __version__, **info(), "wavelets": sorted(REGISTRY)}
    if "--json" in sys.argv:
        print(json.dumps(data))
    else:
        print("libdwt_torch", __version__)
        for k, v in data.items():
            if k != "version":
                print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
