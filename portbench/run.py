#!/usr/bin/env python3
"""Run one cell of the benchmark of libdwt_torch once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and ``libdwt_torch/``.  Earlier lines say what ran (the
impl that 'auto' took, the kernel counters, the card and its power
limit, peak memory); the last lines on standard error give each number
compared beside its limit; the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; ``checks`` comes last.

Exits non-zero, with no result, when CUDA is missing or has fewer cards
than the cell asks for, when the program cannot be imported, or when
JAX or the JAX package was loaded.  Builds stay inside the checkout
(``build/``); the tune table is the program's packaged one.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def set_environment() -> None:
    """Caches at fixed paths inside the checkout; a tune file that does not
    exist, so that the program's packaged table decides 'auto'."""
    build = ROOT / "build"
    os.environ["LIBDWT_TORCH_BUILD"] = str(build / "libdwt_torch")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(build / "portbench" / sub)
    tune = Path(tempfile.gettempdir()) / "portbench-packaged-table-only" / "autotune.json"
    if tune.exists():
        raise SystemExit(f"{tune} exists: remove it, a tune file there would replace "
                         "the packaged table")
    os.environ["LIBDWT_TORCH_TUNE_FILE"] = str(tune)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: needs {cell.chips} CUDA card(s), found {count}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START, log=lambda line: print(line, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} (JAX or the JAX package); no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
