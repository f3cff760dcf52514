#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 2]

In one process (one build, one set-up of the card): for each of
``--seeds`` a run of the cell as ``run.py`` makes it, with a window of
``--seconds`` at the cell's own load, and its numbers; for each of
``--control-seeds`` the control's numbers on ``sample_frames`` frames of
that seed's pool: the reference in the program's place, in bfloat16 for
a float32 configuration (float32 for float64), or with the integer
rounding toward zero for an integer one.  One JSON line a seed; the
benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, set_environment  # noqa: E402


def control_numbers(cell, seed: int, device):
    """The control's numbers over ``sample_frames`` frames of the pool of
    ``seed`` (the largest of each number)."""
    from portbench import check, harness

    cfg, mix = cell.cfg, cell.mix
    pool = harness.make_pool(cfg, mix, seed, device)
    inputs = list(pool) if mix["direction"] == "encode" else harness.decode_inputs(cfg, pool)
    worst = {}
    for x in inputs[:mix["sample_frames"]]:
        for name, value in check.compare(cfg, mix["direction"], x, None,
                                         control=check.control_of(cfg)).items():
            worst[name] = max(worst.get(name, 0.0), value)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import check, harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    t = T_START
    for seed in seeds:
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", t,
                               log=lambda line: None)
        t = time.perf_counter()
        print(json.dumps({"workload": cell.name, "side": "program", "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "numbers": {k: v["value"] for k, v in res["checks"].items()},
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
              flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        print(json.dumps({"workload": cell.name, "side": "control", "seed": seed,
                          "control": repr(check.control_of(cell.cfg)),
                          "numbers": control_numbers(cell, seed, "cuda")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
