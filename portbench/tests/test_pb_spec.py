"""BENCHMARK.json against the contract, and the files its names lead to."""
import json
import re
from pathlib import Path

import pytest

from portbench import check, harness, work

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _all_names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[key]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_all_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


def test_names_are_unique_and_units_allowed():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_texts_are_one_line():
    texts = [w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]
    texts += [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_workload_finds_its_files(w):
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert config["file"] == f"portbench/configs/{w['config']}.json"
    cell = harness.load_cell(w["name"], ROOT / "BENCHMARK.json")
    assert cell.cfg["name"] == w["config"]
    assert cell.cfg["reduced"] == config["reduced"]
    assert cell.mix["name"] == w["traffic"]
    assert cell.mix["direction"] in ("encode", "decode")
    assert set(cell.limits) == set(check.number_names(cell.cfg, cell.mix["direction"]))
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_every_metric_has_its_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_per_layer_metrics_move_what_their_cells_report():
    cells = [w["name"] for w in SPEC["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)


def test_every_config_is_used_and_every_cell_reports_an_e2e_metric_besides_setup():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        reported = [m["name"] for m in SPEC["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert set(reported) - {"setup_s"}


@pytest.mark.parametrize("config", ["dci4k_cdf97_f32", "j2k4k_cdf53_i32"])
def test_frame_bytes_and_operations(config):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    assert work.samples_per_frame(cfg) == 26_542_080
    assert work.bytes_per_frame(cfg) == 212_336_640
    assert work.level_shapes(2160, 4096, 5) == [(2160, 4096), (1080, 2048), (540, 1024),
                                                (270, 512), (135, 256)]
    per = 13 if cfg["wavelet"] == "cdf97" else 7
    assert work.ops_per_frame(cfg) == per * 3 * 11_784_960


def test_byte_bound_of_a_frame_on_the_h100():
    from portbench.peaks import least_seconds

    cfg = json.loads((BENCH / "configs" / "dci4k_cdf97_f32.json").read_text())
    least = least_seconds(work.bytes_per_frame(cfg), work.ops_per_frame(cfg), False,
                          "NVIDIA H100 80GB HBM3")
    assert least == pytest.approx(212_336_640 / 3.35e12)
    assert least_seconds(1, 1, False, "some other card") is None
