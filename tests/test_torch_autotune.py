"""Port vs reference: the measured 'auto' dispatch table (autotune).

Ports of ``tests/test_autotune.py`` (``_pick_impl`` takes ``on_cuda=True``
where the reference patches ``_on_tpu``; the tuner runs with
``device='cpu'``), then parity with ``libdwt_tpu.autotune`` and
``libdwt_tpu.api`` on the same tables: ``_bucket``, ``_bytes_per_pixel``,
``_drop_implausible``, ``validate_table``, ``_entry_impl``,
``dispatch_choice``, ``volume_choice`` and ``_pick_impl``/``_pick_impl3``
with both packages' device kind patched to one name and both tune files
pointed at one JSON file.  No JAX transform runs: the reference's table
logic is plain Python.
"""
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.api as japi
from libdwt_tpu import autotune as jat
from libdwt_torch import api, autotune

KIND = "NVIDIA H100 80GB HBM3"
H100_BW = 3350.0
#: dtype name -> (the port's dtype, the reference's)
DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64),
          "int32": (torch.int32, jnp.int32)}
WAVELETS = ("cdf97", "cdf53", "haar", "d4")


@pytest.fixture
def tuned(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("LIBDWT_TORCH_TUNE_FILE", str(path))
    autotune.clear_cache()
    yield path
    autotune.clear_cache()


def _write(path, kind, entries):
    path.write_text(json.dumps({kind: entries}))


# ------------------------------------------------ ports of test_autotune.py


def test_dispatch_choice_consults_disk(tuned):
    kind = autotune._device_kind()
    _write(tuned, kind, {
        "512:float32:cdf97": {"impl": "fused", "secs": {}},
        "1024:float32:cdf97": {"impl": "separable", "secs": {}},
    })
    assert autotune.dispatch_choice(512, 640, torch.float32, "cdf97") == "fused"
    assert autotune.dispatch_choice(1024, 4096, torch.float32, "cdf97") == "separable"
    # untuned bucket / tiny size -> None (threshold fallback)
    assert autotune.dispatch_choice(64, 64, torch.float32, "cdf97") is None
    assert autotune.dispatch_choice(512, 512, torch.int32, "cdf97") is None
    # the key is numpy's dtype name, whichever spelling the caller uses
    assert autotune.dispatch_choice(512, 640, np.float32, "cdf97") == "fused"
    assert autotune._dtype_name(torch.float32) == "float32"


def test_pick_impl_obeys_measured_table(tuned):
    kind = autotune._device_kind()
    _write(tuned, kind, {
        "512:float32:cdf97": {"impl": "fused", "secs": {}},
        "2048:float32:cdf97": {"impl": "separable", "secs": {}},
    })

    def pick(n, impl):
        return api._pick_impl(n, n, "cdf97", impl, True, torch.float32)

    # tuned buckets override the _AUTO_MIN_SIZE=1024 threshold both ways
    assert pick(512, None) == "fused"
    assert pick(2048, None) == "separable"
    # a bucket between tuned ones reads the largest tuned bucket below it
    assert pick(1024, None) == "fused"
    # explicit impl always wins
    assert pick(2048, "fused") == "fused"
    assert pick(512, "separable") == "separable"
    # a CPU tensor never reads the table
    assert api._pick_impl(512, 512, "cdf97", None, False, torch.float32) == "separable"
    # an untuned dtype falls back to the thresholds
    assert api._pick_impl(1024, 1024, "cdf97", None, True, torch.float64) == "fused"


def test_autotune_dwt2_measures_and_caches(tuned):
    cfg = autotune.autotune_dwt2((64, 64), "cdf97", trials=1, device="cpu")
    assert cfg["impl"] in ("separable", "fused") and cfg["secs"] > 0
    assert cfg["impl"] == "separable" or cfg["tile"] in autotune._TILES
    assert autotune.best_config((64, 64), "cdf97", device="cpu") == cfg
    assert autotune.best_config((64, 64), "cdf97", torch.float64, device="cpu") is None


def test_tune_dispatch_records_failed_candidates(tuned, monkeypatch):
    """A candidate that fails on the device lands in the entry's 'failed'
    map (counting as attempted), stamped with the torch version."""

    def fake_candidates(wavelet, levels, direction, shape=None, dtype=None):
        from libdwt_torch.ops.separable import wavedec2 as sep

        def boom(a):
            raise RuntimeError("CUDA error: no kernel image is available")

        return [("separable", lambda a: sep(a, wavelet, levels)), ("streamed", boom)]

    monkeypatch.setattr(autotune, "_pyramid_candidates", fake_candidates)
    mine = autotune.tune_dispatch(sizes=(128,), levels=2, trials=1, device="cpu")
    entry = mine["128:float32:cdf97"]
    assert entry["impl"] == "separable"
    assert "streamed" in entry.get("failed", {})
    assert "no kernel image" in entry["failed"]["streamed"]
    assert entry["failed_torch"] == torch.__version__
    assert {"separable", "streamed"} <= set(entry["secs"]) | set(entry["failed"])
    # saved under the device kind and read back by a fresh load
    autotune.clear_cache()
    assert autotune._load_disk()["cpu"]["128:float32:cdf97:inv"]["impl"] == "separable"


def test_validate_table_flags_contamination():
    mine = {
        # winner implausibly far ahead of the runner-up
        "512:float32:cdf97": {
            "impl": "streamed", "measured_at": 512,
            "secs": {"streamed": 5.47e-05, "separable": 1.08e-3, "fused": 9.95e-4},
        },
        # the smaller bucket slower than the larger one
        "1024:float32:cdf97": {
            "impl": "fused", "measured_at": 1024,
            "secs": {"fused": 8.09e-4, "separable": 8.33e-4},
        },
        "2048:float32:cdf97": {
            "impl": "fused", "measured_at": 2048,
            "secs": {"fused": 1.60e-4, "separable": 1.91e-4},
        },
    }
    findings = autotune.validate_table(mine, bw_gbps=H100_BW)
    assert any("512:float32:cdf97" in f and "ahead of the runner-up" in f
               for f in findings)
    assert any("1024" in f and "2048" in f for f in findings)


def test_validate_table_flags_impossible_bandwidth():
    # 4096^2 pixels * 8 B in 10 us -> 13.4 TB/s, impossible on any H100
    mine = {"4096:float32:cdf97": {
        "impl": "fused", "measured_at": 4096,
        "secs": {"fused": 1e-5, "separable": 2e-5},
    }}
    findings = autotune.validate_table(mine, bw_gbps=H100_BW)
    assert any("bandwidth" in f for f in findings)


def test_validate_table_accepts_consistent_entries():
    mine = {
        "1024:float32:cdf97": {
            "impl": "fused", "measured_at": 1024,
            "secs": {"fused": 5.0e-5, "separable": 7.0e-5},
        },
        "2048:float32:cdf97": {
            "impl": "fused", "measured_at": 2048,
            "secs": {"fused": 1.6e-4, "separable": 1.9e-4},
        },
        # a rectangular measured_at counts its true pixels
        "2048:bfloat16:cdf97": {
            "impl": "fused", "measured_at": [2144, 4096],
            "secs": {"fused": 3.4e-4, "separable": 4.2e-4},
        },
        # failed-only entries and volume keys are ignored
        "512:float32:cdf97": {"failed": {"streamed": "RuntimeError"},
                              "failed_torch": "2.0"},
        "vol:float32:cdf97": {"impl": "fused", "secs": {"fused": 1e-3}},
    }
    assert autotune.validate_table(mine, bw_gbps=H100_BW) == []


def test_drop_implausible_removes_timing_artifacts():
    rows = {"streamed": 5.47e-05, "separable": 1.08e-3, "fused": 9.95e-4}
    kept = autotune._drop_implausible(rows, 512 * 512, "fwd", H100_BW)
    assert "streamed" not in kept
    assert min(kept, key=kept.get) == "fused"
    rows2 = {"fused": 1.6e-4, "separable": 1.9e-4}
    assert autotune._drop_implausible(rows2, 2048 * 2048, "fwd", H100_BW) == rows2
    # a single candidate is never dropped, however fast it claims to be
    rows3 = {"separable": 1e-9}
    assert autotune._drop_implausible(rows3, 2048 * 2048, "fwd", H100_BW) == rows3


def test_packaged_table_is_consistent():
    """The table that ships passes its own validation, each card's rows at
    that card's bandwidth, and holds no TPU row."""
    path = autotune._packaged_table()
    assert os.path.exists(path)
    with open(path) as f:
        table = json.load(f)
    assert table
    for kind, mine in table.items():
        assert "TPU" not in kind
        findings = autotune.validate_table(mine, autotune._nominal_bw_gbps(kind))
        assert findings == [], f"{kind}: {findings}"
        for key, entry in mine.items():
            assert entry["impl"] in entry["secs"] and not entry.get("failed"), key
            assert key.split(":")[1] in DTYPES


def test_inverse_candidates_split_poly_and_mxu():
    """The inverse candidates offer the polyphase streamed body wherever
    the streamed geometry holds (its CUDA build has no size limit, so the
    2144x4096 frame too) and the banded body as its own candidate."""
    small = [n for n, _ in autotune._pyramid_candidates(
        "cdf97", 5, "inv", shape=(1024, 1024), dtype=torch.float32)]
    assert "streamed" in small and "streamed-mxu" in small
    big = [n for n, _ in autotune._pyramid_candidates(
        "cdf97", 5, "inv", shape=(2144, 4096), dtype=torch.float32)]
    assert "streamed" in big and "streamed-mxu" in big
    # integers: no banded candidate (bit-exactness needs the polyphase body)
    ints = [n for n, _ in autotune._pyramid_candidates(
        "cdf53", 5, "inv", shape=(1024, 1024), dtype=torch.int32)]
    assert "streamed" in ints and "streamed-mxu" not in ints


def test_drop_implausible_keeps_slope_winner_vs_upper_bounds():
    rows = {"fused": 4.7e-5, "separable": 7.8e-4, "streamed": 8.1e-4}
    kinds = {"fused": "slope", "separable": "upper", "streamed": "upper"}
    kept = autotune._drop_implausible(rows, 512 * 512, "inv", H100_BW, kinds=kinds)
    assert "fused" in kept and min(kept, key=kept.get) == "fused"
    kinds_same = {k: "slope" for k in rows}
    kept2 = autotune._drop_implausible(rows, 512 * 512, "inv", H100_BW, kinds=kinds_same)
    assert "fused" not in kept2


def test_bytes_per_pixel_tracks_dtype():
    assert autotune._bytes_per_pixel("fwd", 4) == 8.0
    assert autotune._bytes_per_pixel("inv", 4) == 16.0
    assert autotune._bytes_per_pixel("fwd", 8) == 16.0
    assert autotune._bytes_per_pixel("inv", 2) == 8.0


def test_entry_impl_demotes_probe_failed_winner():
    entry = {
        "impl": "streamed",
        "secs": {"streamed": 1.1e-3, "fused": 1.5e-3, "separable": 1.7e-3},
        "probe": {"streamed": "timeout", "fused": "ok"},
    }
    assert autotune._entry_impl(entry) == "fused"
    entry["probe"]["streamed"] = "ok"
    assert autotune._entry_impl(entry) == "streamed"
    assert autotune._entry_impl({"impl": "streamed", "secs": {}}) == "streamed"
    entry2 = {
        "impl": "streamed",
        "secs": {"streamed": 1.1e-3, "fused": 1.5e-3, "separable": 1.7e-3},
        "probe": {"streamed": "timeout", "fused": "error: rc=1"},
    }
    assert autotune._entry_impl(entry2) == "separable"


def test_volume_choice_follows_the_packaged_table_and_its_probes(monkeypatch, tuned):
    """With no tune file, 'auto' reads the packaged table (each card's
    entry, probe verdicts applied); a tune file with a probe-failed
    winner demotes it."""
    with open(autotune._packaged_table()) as f:
        table = json.load(f)
    monkeypatch.delenv("LIBDWT_TORCH_TUNE_FILE")
    for kind, mine in table.items():
        monkeypatch.setattr(autotune, "_device_kind", lambda *a, k=kind: k)
        autotune.clear_cache()
        for direction, suffix in (("fwd", ""), ("inv", ":inv")):
            entry = mine.get("vol:float32:cdf97" + suffix)
            want = None if entry is None else autotune._entry_impl(entry)
            assert autotune.volume_choice(torch.float32, "cdf97", direction) == want
    monkeypatch.setenv("LIBDWT_TORCH_TUNE_FILE", str(tuned))
    _write(tuned, KIND, {"vol:float32:cdf97:inv": {
        "impl": "streamed", "secs": {"streamed": 1e-3, "fused": 2e-3, "separable": 3e-3},
        "probe": {"streamed": "timeout", "fused": "ok"}}})
    monkeypatch.setattr(autotune, "_device_kind", lambda *a: KIND)
    autotune.clear_cache()
    assert autotune.volume_choice(torch.float32, "cdf97", "inv") == "fused"
    assert autotune.volume_choice(torch.float32, "cdf97", "fwd") is None


def test_probe_volume_compile_subprocess_bounded(monkeypatch):
    """The probe is a real subprocess with a hard timeout: a wedged run
    costs timeout_s and returns 'timeout', never hangs the tune."""
    monkeypatch.setattr(autotune, "_PROBE_SNIPPET",
                        "import time\ntime.sleep(3600)\n# {z}{y}{x}{impl}{dtype}{wavelet}")
    t0 = time.perf_counter()
    out = autotune.probe_volume_compile((8, 32, 32), "cdf97", impl="streamed", timeout_s=2.0)
    assert out == "timeout" and time.perf_counter() - t0 < 30
    monkeypatch.setattr(autotune, "_PROBE_SNIPPET",
                        "print('PROBE_OK', {z}, {y}, {x}, {impl!r}, {dtype!r}, "
                        "{wavelet!r}, {direction!r})")
    assert autotune.probe_volume_compile((8, 32, 32), "cdf97", impl="streamed",
                                         timeout_s=30.0) == "ok"
    monkeypatch.setattr(autotune, "_PROBE_SNIPPET",
                        "raise SystemExit('boom {z}{y}{x}{impl}{dtype}{wavelet}')")
    out = autotune.probe_volume_compile((8, 32, 32), "cdf97", impl="streamed", timeout_s=30.0)
    assert out.startswith("error")


def test_probe_runs_the_named_kernel_in_each_direction():
    """The real snippet in a fresh process (the plain versions off the
    card): the forward and the inverse kernel of each volume impl."""
    for impl in ("fused", "streamed"):
        for direction in ("fwd", "inv"):
            assert autotune.probe_volume_compile(
                (8, 16, 16), "cdf97", torch.float32, impl=impl, timeout_s=120.0,
                direction=direction) == "ok", (impl, direction)


# ------------------------------------------------ the measuring side


def _indexed_stacks(*ks):
    return {k: torch.arange(k, dtype=torch.float32).view(k, 1, 1).expand(k, 4, 4).clone()
            for k in ks}


def test_chain_slope_measures_a_known_per_frame_time():
    """Frames that sleep 10 ms each, plus 20 ms at the first frame of a
    chain (a fixed cost): the slope is the per-frame time."""
    def frame(a):
        time.sleep(0.01 + (0.02 if float(a[0, 0]) == 0 else 0.0))
        return [a]

    secs, kind = autotune._chain_slope_secs(frame, _indexed_stacks(8, 32), trials=3)
    assert kind == "slope"
    assert 0.8 * 0.01 <= secs <= 1.2 * 0.01


def test_chain_slope_falls_back_to_the_bound_for_a_fixed_cost():
    def frame(a):
        if float(a[0, 0]) == 0:
            time.sleep(0.3)
        return [a]

    secs, kind = autotune._chain_slope_secs(frame, _indexed_stacks(8, 32), trials=2)
    assert kind == "upper", secs
    assert secs >= 0.3 / 32


def test_make_stacks_draws_the_reference_data():
    st = autotune._make_stacks((6, 10), torch.float32, 2, 3, device="cpu")
    rng = np.random.RandomState(0)
    for k in (2, 3):
        assert st[k].dtype == torch.float32 and st[k].device.type == "cpu"
        np.testing.assert_array_equal(st[k].numpy(), rng.rand(k, 6, 10).astype(np.float32))


def test_nominal_bandwidth_per_card():
    assert autotune._nominal_bw_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert autotune._nominal_bw_gbps("NVIDIA H100 PCIe") == 2000.0
    assert autotune._nominal_bw_gbps("NVIDIA H100 NVL") == 3900.0
    assert autotune._nominal_bw_gbps("cpu") == 2000.0


def test_tune_file_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("LIBDWT_TORCH_TUNE_FILE", raising=False)
    monkeypatch.setenv("LIBDWT_TPU_TUNE_FILE", "/nonexistent/tpu.json")
    assert autotune.tune_file().endswith(os.path.join(".cache", "libdwt_torch",
                                                      "autotune.json"))
    assert autotune._packaged_table().endswith(
        os.path.join("libdwt_torch", "data", "autotune.json"))


# ------------------------------------------------ parity with libdwt_tpu


def test_bucket_and_bytes_per_pixel_match_the_reference():
    assert [autotune._bucket(e, 5001 - e) for e in range(1, 5001)] == [
        jat._bucket(e, 5001 - e) for e in range(1, 5001)]
    assert [autotune._bucket(e, e) for e in range(1, 5001)] == [
        jat._bucket(e, e) for e in range(1, 5001)]
    for d in ("fwd", "inv"):
        for item in (1, 2, 4, 8):
            assert autotune._bytes_per_pixel(d, item) == jat._bytes_per_pixel(d, item)


CANDS2 = ("separable", "fused", "streamed", "streamed-mxu")
CANDS3 = ("separable", "fused", "streamed")
TABLE_DTYPES = ("float32", "float64", "int32", "bfloat16", "float16", "foo")


def _rows(rng, cands):
    names = [c for c in cands if rng.rand() < 0.8] or [cands[0]]
    secs = {c: float(10 ** rng.uniform(-7, -2)) for c in names}
    kinds = {c: ("slope" if rng.rand() < 0.6 else "upper") for c in names}
    return secs, kinds


def _synthetic_table(seed: int):
    rng = np.random.RandomState(seed)
    mine = {}
    for b in (128, 256, 512, 1024, 2048, 4096):
        for dt in TABLE_DTYPES:
            for wv in ("cdf97", "cdf53"):
                for suffix in ("", ":inv"):
                    if rng.rand() < 0.3:
                        continue
                    secs, kinds = _rows(rng, CANDS2)
                    entry = {"impl": min(secs, key=secs.get), "secs": secs}
                    if rng.rand() < 0.8:
                        entry["estimator"] = kinds
                    if rng.rand() < 0.7:
                        entry["measured_at"] = (b if rng.rand() < 0.5
                                                else [b + int(rng.randint(0, 100)), 2 * b])
                    mine[f"{b}:{dt}:{wv}{suffix}"] = entry
    for suffix in ("", ":inv"):
        secs, kinds = _rows(rng, CANDS3)
        mine[f"vol:float32:cdf97{suffix}"] = {"impl": min(secs, key=secs.get),
                                              "secs": secs, "estimator": kinds}
    mine["512:float32:haar"] = {"failed": {"fused": "RuntimeError"}, "failed_torch": "x"}
    return mine


@pytest.mark.parametrize("seed", range(6))
def test_drop_implausible_and_validate_table_match_the_reference(seed):
    mine = _synthetic_table(seed)
    rng = np.random.RandomState(100 + seed)
    for bw in (819.0, 2000.0, H100_BW):
        assert autotune.validate_table(mine, bw) == jat.validate_table(mine, bw)
    for _ in range(200):
        secs, kinds = _rows(rng, CANDS2)
        pixels = int(rng.choice([128, 512, 2048, 4096])) ** 2
        direction = "fwd" if rng.rand() < 0.5 else "inv"
        bw = float(rng.choice([819.0, H100_BW]))
        item = int(rng.choice([2, 4, 8]))
        k = kinds if rng.rand() < 0.8 else None
        assert autotune._drop_implausible(secs, pixels, direction, bw, k, item) == \
            jat._drop_implausible(secs, pixels, direction, bw, k, item)


def test_validate_table_matches_the_reference_on_its_packaged_table():
    with open(jat._packaged_table()) as f:
        tpu = json.load(f)
    for kind, mine in tpu.items():
        assert autotune.validate_table(mine, 819.0) == jat.validate_table(mine, 819.0)
        for key, entry in mine.items():
            if "secs" in entry:
                parts = key.split(":")
                d = "inv" if "inv" in parts else "fwd"
                px = jat._entry_pixels(entry, int(parts[0])) if parts[0].isdigit() else 1
                assert autotune._entry_pixels(entry, 512) == jat._entry_pixels(entry, 512)
                assert autotune._drop_implausible(
                    entry["secs"], px, d, 819.0, entry.get("estimator")) == \
                    jat._drop_implausible(entry["secs"], px, d, 819.0, entry.get("estimator"))


def test_entry_impl_matches_the_reference():
    rng = np.random.RandomState(7)
    verdicts = ("ok", "timeout", "error: rc=1")
    for _ in range(500):
        secs, _ = _rows(rng, CANDS3)
        entry = {"impl": str(rng.choice(list(secs))), "secs": secs}
        if rng.rand() < 0.8:
            entry["probe"] = {c: str(rng.choice(verdicts)) for c in secs if rng.rand() < 0.7}
        assert autotune._entry_impl(entry) == jat._entry_impl(entry)


def _dispatch_table(seed: int):
    """Winners over every candidate, some buckets, dtypes and directions
    missing (the lower-bucket and forward-entry fallbacks), volume entries
    with probe verdicts."""
    rng = np.random.RandomState(seed)
    mine = {}
    for b in (128, 256, 512, 1024, 2048, 4096):
        for dt in DTYPES:
            for wv in WAVELETS:
                for suffix in ("", ":inv"):
                    if rng.rand() < 0.35:
                        continue
                    secs, kinds = _rows(rng, CANDS2)
                    mine[f"{b}:{dt}:{wv}{suffix}"] = {
                        "impl": str(rng.choice(CANDS2)), "secs": secs, "estimator": kinds}
    for dt in DTYPES:
        for wv in WAVELETS:
            for suffix in ("", ":inv"):
                if rng.rand() < 0.25:
                    continue
                secs = {c: float(rng.rand()) for c in CANDS3}
                entry = {"impl": str(rng.choice(CANDS3)), "secs": secs}
                if rng.rand() < 0.5:
                    entry["probe"] = {c: str(rng.choice(["ok", "timeout"]))
                                      for c in ("fused", "streamed")}
                mine[f"vol:{dt}:{wv}{suffix}"] = entry
    for wv in WAVELETS:  # every strategy wins somewhere on the frame's buckets
        mine[f"2048:float32:{wv}"] = {"impl": "streamed-mxu", "secs": {}}
        mine[f"1024:float32:{wv}:inv"] = {"impl": "streamed", "secs": {}}
    return {KIND: mine}


@pytest.fixture
def shared_table(tmp_path, monkeypatch):
    """Point both packages at one tune file and one device kind, with the
    reference believing it runs on its accelerator."""
    path = tmp_path / "shared.json"
    monkeypatch.setenv("LIBDWT_TORCH_TUNE_FILE", str(path))
    monkeypatch.setenv("LIBDWT_TPU_TUNE_FILE", str(path))
    monkeypatch.setattr(autotune, "_device_kind", lambda *a: KIND)
    monkeypatch.setattr(jat, "_device_kind", lambda: KIND)
    monkeypatch.setattr(japi, "_on_tpu", lambda: True)
    assert api.get_impl() == "auto" and japi.get_impl() == "auto"

    def load(table):
        path.write_text(json.dumps(table))
        autotune.clear_cache()
        jat.clear_cache()

    yield load
    autotune.clear_cache()
    jat.clear_cache()


SHAPES2 = ((37, 41), (16, 24), (31, 64), (256, 260), (512, 512), (1024, 1030),
           (1024, 1024), (2144, 4096), (4096, 4096), (130, 258))
SHAPES3 = ((64, 512, 512), (32, 256, 256), (8, 16, 16), (6, 6, 6), (4, 8, 8),
           (5, 8, 8), (16, 32, 34), (2, 64, 64), (32, 128, 128), (256, 2048, 64))
IMPLS = (None, "auto", "fused", "separable", "streamed", "streamed-mxu", "bogus")


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return ValueError


@pytest.mark.parametrize("seed", range(3))
def test_dispatch_and_volume_choice_match_the_reference(shared_table, seed):
    shared_table(_dispatch_table(seed))
    for (h, w) in SHAPES2 + ((128, 127), (200, 3000), (5000, 4500)):
        for name, (tdt, jdt) in DTYPES.items():
            for wv in WAVELETS:
                for d in ("fwd", "inv"):
                    assert autotune.dispatch_choice(h, w, tdt, wv, d) == \
                        jat.dispatch_choice(h, w, jdt, wv, d), (h, w, name, wv, d)
    for name, (tdt, jdt) in DTYPES.items():
        for wv in WAVELETS:
            for d in ("fwd", "inv"):
                assert autotune.volume_choice(tdt, wv, d) == jat.volume_choice(jdt, wv, d)


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("seed", range(3))
def test_pick_impl_matches_the_reference(shared_table, seed, wavelet):
    shared_table(_dispatch_table(seed))
    seen = set()
    for (h, w) in SHAPES2:
        for name, (tdt, jdt) in DTYPES.items():
            for d in ("fwd", "inv"):
                for levels in (1, 2, 5):
                    for impl in IMPLS:
                        got = _outcome(lambda: api._pick_impl(
                            h, w, wavelet, impl, True, tdt, levels=levels, direction=d))
                        want = _outcome(lambda: japi._pick_impl(
                            h, w, wavelet, impl, jdt, direction=d, levels=levels))
                        assert got == want, (h, w, name, d, levels, impl)
                        if impl is None:
                            seen.add(got)
    # the tables drive 'auto' to every strategy, demotions included
    if wavelet != "d4":
        assert {"separable", "fused", "streamed", "streamed-mxu"} <= seen


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("seed", range(3))
def test_pick_impl3_matches_the_reference(shared_table, seed, wavelet):
    shared_table(_dispatch_table(seed))
    for shape3 in SHAPES3:
        for name, (tdt, jdt) in DTYPES.items():
            for d in ("fwd", "inv"):
                for impl in IMPLS:
                    got = _outcome(lambda: api._pick_impl3(shape3, wavelet, impl, True, tdt, d))
                    want = _outcome(lambda: japi._pick_impl3(shape3, wavelet, impl, jdt, d))
                    assert got == want, (shape3, name, d, impl)


def test_pick_impl_demotes_unrunnable_winners(shared_table):
    """A streamed winner on a geometry the streamed kernels refuse runs
    'fused'; a 'streamed-mxu' winner on a dtype the banded body refuses
    runs 'streamed'; a streamed volume winner the gate refuses, 'fused'."""
    mine = {f"1024:{dt}:cdf97": {"impl": "streamed-mxu", "secs": {}} for dt in DTYPES}
    mine["vol:float32:cdf97"] = {"impl": "streamed", "secs": {}}
    shared_table({KIND: mine})
    assert api._pick_impl(1024, 1024, "cdf97", None, True, torch.float32, levels=5) == \
        "streamed-mxu"
    assert api._pick_impl(1024, 1024, "cdf97", None, True, torch.int32, levels=5) == \
        "streamed"
    assert api._pick_impl(1025, 1031, "cdf97", None, True, torch.float32, levels=5) == "fused"
    assert api._pick_impl3((64, 512, 512), "cdf97", None, True, torch.float32) == "streamed"
    assert api._pick_impl3((256, 2048, 64), "cdf97", None, True, torch.float32) == "fused"
    # off the card the table is never read
    assert api._pick_impl(1024, 1024, "cdf97", None, False, torch.float32) == "separable"
    assert api._pick_impl3((64, 512, 512), "cdf97", None, False, torch.float32) == "separable"
