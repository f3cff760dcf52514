"""The harness driven on the CPU at a small size: cells found by name from
files dropped into a directory, sound runs correct, runs with the timed
path broken underneath not correct, and run.py refusing without a card."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from libdwt_torch import api
from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
#: small stand-ins of the configurations: same wavelet, dtype, levels
SMALL = {"small97": "dci4k_cdf97_f32", "small53": "j2k4k_cdf53_i32"}
CELLS = [("small97", "encode"), ("small53", "encode"), ("small97", "decode"),
         ("small53", "decode")]


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    """A benchmark directory holding only new files: two small configs, the
    mixes with a small pool, the limits of the real cells, the readers."""
    d = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH / "metrics", d / "metrics")
    for sub in ("configs", "mixes", "limits"):
        (d / sub).mkdir()
    for small, real in SMALL.items():
        cfg = json.loads((BENCH / "configs" / f"{real}.json").read_text())
        cfg.update(name=small, rows=88, columns=136)
        (d / "configs" / f"{small}.json").write_text(json.dumps(cfg))
    for mix in ("encode", "decode"):
        m = json.loads((BENCH / "mixes" / f"{mix}.json").read_text())
        m.update(name=f"{mix}", pool_frames=3, sample_frames=3)
        (d / "mixes" / f"{mix}.json").write_text(json.dumps(m))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": f"{c}.{m}", "config": c, "traffic": m, "chips": 1,
                          "why": "small"} for c, m in CELLS]
    for c, m in CELLS:
        real = f"{SMALL[c]}.encode" if SMALL[c].startswith("j2k") else f"{SMALL[c]}.{m}"
        shutil.copy(BENCH / "limits" / f"{real}.json", d / "limits" / f"{c}.{m}.json")
    for metric in spec["end_to_end"] + spec["per_layer"]:
        metric.pop("workloads", None)
    (d / "BENCHMARK.json").write_text(json.dumps(spec))
    return d


def run(bench_dir, cell, seconds=0.3, trace=False, seed=2**31 + 11):
    c = harness.load_cell(cell, bench_dir / "BENCHMARK.json", bench_dir)
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(),
                            log=lambda line: None)


@pytest.mark.parametrize("cell", [f"{c}.{m}" for c, m in CELLS])
def test_a_dropped_in_cell_runs_and_is_correct(bench_dir, cell):
    res = run(bench_dir, cell)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"frame_ms_p95", "setup_s"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_traced_run_reports_per_layer_metrics_only(bench_dir):
    res = run(bench_dir, "small97.encode", trace=True)
    assert res["correct"] is True
    # no device trace on the CPU: the trace readers find nothing and are left out
    assert set(res["metrics"]) == {"host_submit_ms", "mpix_per_s"}


def _bands(out, fn):
    if isinstance(out, torch.Tensor):
        return fn(out)
    return type(out)(_bands(o, fn) for o in out)


def stale(real):
    """A step that returns its state unchanged: every call after the first
    returns the first call's output."""
    first = []

    def f(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]
    return f


def half_batch(real):
    """Half of the batch left out: the components past the first half are
    not transformed (left zero)."""
    def f(*a, **k):
        def cut(t):
            t = t.clone()
            t[(t.shape[0] + 1) // 2:] = 0
            return t
        return _bands(real(*a, **k), cut)
    return f


def altered(real):
    """An answer altered where it is produced: one value of every output
    replaced by its neighbour's (an off-by-one write)."""
    def f(*a, **k):
        out = real(*a, **k)
        flat = (out if isinstance(out, torch.Tensor) else out[0]).view(-1)
        flat[flat.numel() // 3] = flat[flat.numel() // 3 + 1]
        return out
    return f


@pytest.mark.parametrize("fault", [stale, half_batch, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", [f"{c}.{m}" for c, m in CELLS])
def test_a_broken_timed_path_is_not_correct(bench_dir, cell, fault, monkeypatch):
    name = "wavedec2" if cell.endswith("encode") else "waverec2"
    monkeypatch.setattr(api, name, fault(getattr(api, name)))
    res = run(bench_dir, cell)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_a_call_that_raises_counts_as_failed(bench_dir, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(api, "wavedec2", broken)
    res = run(bench_dir, "small97.encode")
    assert res["correct"] is False and res["failed"] == res["attempted"] > 0


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "dci4k_cdf97_f32.encode", "--seed", "3000000001", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env=_no_card_env(), timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "metrics" not in res.stderr


def test_a_directory_of_the_benchmark_alone_runs_nothing(tmp_path):
    """BENCHMARK.json and portbench/ without the program: the harness's
    run (here on the CPU) fails on the import and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    script = ("import sys, time; sys.path.insert(0, '.'); from portbench import harness; "
              "c = harness.load_cell('dci4k_cdf97_f32.encode', harness.Path('BENCHMARK.json')); "
              "c.cfg.update(rows=64, columns=64); c.mix.update(pool_frames=2); "
              "print(harness.run_cell(c, 1, 0.1, False, 'cpu', time.perf_counter()))")
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, env=_no_card_env(), timeout=120)
    assert res.returncode != 0
    assert "libdwt_torch" in res.stderr
    assert "correct" not in res.stdout
