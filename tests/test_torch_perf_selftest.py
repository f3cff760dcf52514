"""Port vs reference: the measurement harness, the self-test, the CLI
(``libdwt_torch.utils.perf``, ``libdwt_torch.selftest``,
``python -m libdwt_torch``), and the public surface of every module of
this slice: the same ``__all__`` as the reference module and, for each
name, the same parameters with the same defaults (the port adds a
trailing ``device`` to the entry points that compute).

On the CPU ``measure`` times with ``time.perf_counter``; the sweeps make
their data from ``numpy.random.RandomState(0)`` as the reference's do;
``selftest(device='cpu')`` reports the reference's keys, all True;
``info()`` has the reference's keys.
"""
import importlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libdwt_tpu
import libdwt_torch
from libdwt_tpu.utils import perf as jperf
from libdwt_torch import selftest as tselftest
from libdwt_torch.utils import perf as tperf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the modules of this slice; interop's ``__all__`` also names the port's
#: two pyramid helpers, which the reference module does not have
MODULES = ["ops.gabor", "utils.io", "utils.nativelib", "utils.exr", "utils.cache", "image",
           "interop", "utils.perf", "selftest", "__main__"]
PORT_ONLY = {"interop": ["pyramid_from_numpy", "pyramid_to_numpy"]}


def _norm_default(v):
    """Dtype defaults compare by name (jnp/np/torch spell them apart)."""
    if isinstance(v, torch.dtype):
        return str(v).rsplit(".", 1)[-1]
    if isinstance(v, type) and v is not inspect.Parameter.empty:
        return np.dtype(v).name
    return v


def _params(fn):
    return [(p.name, p.kind, _norm_default(p.default))
            for p in inspect.signature(fn).parameters.values()]


def _same_signature(tfn, jfn, what):
    got, want = _params(tfn), _params(jfn)
    if got[-1:] and got[-1][0] == "device" and (not want or want[-1][0] != "device"):
        assert got[-1][2] is None, what  # the card by default
        got = got[:-1]
    assert got == want, what


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and inspect.isfunction(v) and v.__module__ == mod.__name__)


@pytest.mark.parametrize("name", MODULES)
def test_module_surface_matches_reference(name):
    tmod = importlib.import_module(f"libdwt_torch.{name}")
    jmod = importlib.import_module(f"libdwt_tpu.{name}")
    assert hasattr(tmod, "__all__") == hasattr(jmod, "__all__")
    assert _public(tmod) == _public(jmod) + PORT_ONLY.get(name, [])
    for n in _public(jmod) + [n for n in vars(jmod) if n in ("s_sigma", "gaussian_limit",
                                                               "measure_perf_1d")]:
        tv, jv = getattr(tmod, n), getattr(jmod, n)
        if inspect.isclass(jv):
            for m, jm in vars(jv).items():
                if m.startswith("_") or m in jv.__dataclass_fields__:
                    continue
                tm = vars(tv)[m]
                if isinstance(jm, property):
                    assert isinstance(tm, property), (n, m)
                    continue
                _same_signature(getattr(tv, m), getattr(jv, m), f"{name}.{n}.{m}")
            assert [f.name for f in tv.__dataclass_fields__.values()] == \
                [f.name for f in jv.__dataclass_fields__.values()]
        elif callable(jv):
            _same_signature(tv, jv, f"{name}.{n}")
        else:
            assert tv == jv, f"{name}.{n}"
    if name == "utils.nativelib":
        for n in ("c_i64", "c_i64_p", "c_f32_p", "c_u8_p"):
            assert getattr(tmod, n) is getattr(jmod, n)


def test_image_and_volume_at_the_top_level():
    assert libdwt_torch.Image is importlib.import_module("libdwt_torch.image").Image
    assert libdwt_torch.Volume is importlib.import_module("libdwt_torch.image").Volume
    assert {"Image", "Volume"} <= set(dir(libdwt_tpu))


# -------------------------------------------------------------------- perf


def test_measure_times_on_the_host_clock_and_fences():
    calls = []

    def fn(a):
        calls.append(a)
        return a * 2

    secs = tperf.measure(fn, torch.ones(8), trials=3, warmup=2)
    assert 0 < secs < 10 and len(calls) == 5
    fenced = tperf.measure(lambda a: ((a * 2).sum(), a), torch.ones(8), trials=2, fence=True)
    assert 0 < fenced < 10
    assert tperf.measure(lambda: 1, trials=1, warmup=0) >= 0


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_measure_perf_2d_rows_and_data_like_reference(dtype):
    from libdwt_torch.ops.separable import fdwt2

    seen = []

    def transform(a):
        seen.append(a.clone())
        return fdwt2(a, "cdf53", 1)

    rows = tperf.measure_perf_2d(transform, sizes=(32, 48), dtype=dtype, trials=1,
                                 device="cpu")
    want = jperf.measure_perf_2d(lambda a: a + 1, sizes=(32, 48), dtype=dtype, trials=1)
    assert [r[0] for r in rows] == [r[0] for r in want] == [32, 48]
    assert all(len(r) == len(w) == 3 and all(isinstance(v, type(u)) for v, u in zip(r, w))
               for r, w in zip(rows, want))
    for n, spp, mps in rows:
        assert spp > 0 and mps == pytest.approx(1.0 / spp / 1e6)
    rng = np.random.RandomState(0)
    for n, x in zip((32, 48), seen[::2]):  # the warm-up call and one trial per size
        data = rng.rand(n, n)
        if dtype is np.int32:
            data = data * 255
        np.testing.assert_array_equal(x.numpy(), data.astype(dtype))
    unfenced = tperf.measure_perf_2d(lambda a: a * 2, sizes=(16,), trials=1, fence=False,
                                     device="cpu")
    assert unfenced[0][0] == 16


def test_measure_perf_1d_rows_like_reference():
    seen = []
    rows = tperf.measure_perf_1d(lambda a: seen.append(a.clone()) or [a * 2, a], lengths=(64, 128),
                                 batch=3, trials=1, device="cpu")
    want = jperf.measure_perf_1d(lambda a: a * 2, lengths=(64, 128), batch=3, trials=1)
    assert [r[0] for r in rows] == [r[0] for r in want] == [64, 128]
    rng = np.random.RandomState(0)
    for n, x in zip((64, 128), seen[::2]):
        np.testing.assert_array_equal(x.numpy(), rng.rand(3, n).astype(np.float32))


def test_perf_data_goes_to_the_card_by_default():
    seen = []
    if torch.cuda.is_available():
        tperf.measure_perf_2d(lambda a: seen.append(a.device.type) or a, sizes=(8,), trials=1)
        assert seen == ["cuda", "cuda"]
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tperf.measure_perf_2d(lambda a: a, sizes=(8,))


def test_save_tsv_bytes_equal_reference(tmp_path):
    rows = [(32, 1.5e-9, 666.6666666666666), (64, 2e-09, 500.0), ("x", 1, 0.1)]
    pt, pj = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    tperf.save_tsv(pt, rows)
    jperf.save_tsv(pj, rows)
    assert open(pt, "rb").read() == open(pj, "rb").read()


def test_page_faults_info_and_pinning_like_reference():
    mn, mj = tperf.page_faults()
    assert isinstance(mn, int) and isinstance(mj, int) and mn >= 0 and mj >= 0
    got, want = tperf.info(), jperf.info()
    assert list(got) == list(want)
    assert got["native_backend"] == want["native_backend"]
    assert got["host_cpus"] == want["host_cpus"]
    if torch.cuda.is_available():
        assert got["platform"] == "gpu" and got["device_kind"] == torch.cuda.get_device_name()
    else:
        assert got["platform"] == "cpu"
    before = os.sched_getaffinity(0)
    try:
        cpu = min(before)
        assert tperf.pin_benchmark_env(cpu) is True
        assert os.sched_getaffinity(0) == {cpu}
    finally:
        os.sched_setaffinity(0, before)


# ---------------------------------------------------------------- selftest


def test_selftest_on_the_cpu_matches_reference_keys():
    from libdwt_tpu.selftest import selftest as jselftest

    got = tselftest.selftest(device="cpu")
    want = jselftest()
    assert list(got) == list(want)
    assert all(v is True for v in got.values()), got
    assert got == want


def test_selftest_verbose_and_default_device(capsys):
    rep = tselftest.selftest(size=32, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert out.count("PASS") == len(rep) and "FAIL" not in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tselftest.selftest()


# --------------------------------------------------------------------- CLI


def _run(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-m", "libdwt_torch", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_cli_prints_the_references_keys():
    data = json.loads(_run("--json"))
    want = {"version": libdwt_tpu.__version__, **jperf.info(),
            "wavelets": sorted(libdwt_tpu.REGISTRY)}
    assert list(data) == list(want)
    assert data["version"] == libdwt_torch.__version__ == want["version"]
    assert data["wavelets"] == want["wavelets"]
    text = _run()
    assert text.splitlines()[0] == f"libdwt_torch {libdwt_torch.__version__}"
    assert "  wavelets: ['cdf53', 'cdf97', 'd4', 'haar', 'interp53']" in text
