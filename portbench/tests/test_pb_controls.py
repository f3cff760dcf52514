"""The control of each cell comes out as not correct: the reference in the
program's place, in bfloat16 for the float32 cells and with the integer
rounding toward zero for the lossless one, held to the cell's own limit
at a size a test run holds (3 x 216 x 408, the cells' 5 levels)."""
import json
from pathlib import Path

import pytest
import torch

from portbench import check, harness
from portbench.reference import lifting as ref

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_the_cells_limit_and_the_program_passes_it(cell):
    c = harness.load_cell(cell, ROOT / "BENCHMARK.json")
    cfg = dict(c.cfg, rows=216, columns=408)
    mix = dict(c.mix, pool_frames=2)
    pool = harness.make_pool(cfg, mix, 2**31 + 5, "cpu")
    direction = mix["direction"]
    inputs = list(pool) if direction == "encode" else harness.decode_inputs(cfg, pool)
    program = harness.Program(cfg, direction)
    for x in inputs:
        control = check.compare(cfg, direction, x, None, control=check.control_of(cfg))
        sound = check.compare(cfg, direction, x, program(x))
        assert any(v > c.limits[k]["limit"] for k, v in control.items()), control
        assert all(v <= c.limits[k]["limit"] for k, v in sound.items()), sound


def test_int16_would_not_serve_as_the_lossless_control():
    """The 5/3 coefficients of 12-bit frames fit int16, so a narrower
    integer type computes them exactly: the control is the rounding."""
    cfg = json.loads((ROOT / "portbench/configs/j2k4k_cdf53_i32.json").read_text())
    cfg.update(rows=216, columns=408)
    x = harness.make_pool(cfg, {"pool_frames": 1}, 7, "cpu")[0]
    wide = check.leaves(ref.wavedec2(x, "cdf53", 5))
    narrow = check.leaves(ref.wavedec2(x.to(torch.int16), "cdf53", 5))
    assert all(torch.equal(a, b.to(torch.int32)) for a, b in zip(wide, narrow, strict=True))
