"""The readers of the program's spans and one-time events, on synthetic
run records; the idle gaps labelled by program spans; the records the
harness builds unchanged."""
import importlib.util
import sys
from pathlib import Path

import pytest

from portbench import harness, program_trace, tracing

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NEW = ("api_host_ms", "unframe_host_ms", "wrapper_host_ms", "launch_host_ms")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"pb_test_metric_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def record(program_spans=None, frames=2, traced=True):
    window = harness.Window(frames, 0.01, [0.001] * frames, [0.0005] * frames, 0)
    trace = harness.Trace(window, [], []) if traced else None
    if trace is not None and program_spans is not None:
        trace.program_spans = program_spans
        trace.program_counts = {"dispatch": {("wavedec2",): frames}}
    return harness.RunRecord({}, {}, "cpu", 1.0, window, trace)


MS = 1_000_000
#: two frames of a fused encode: api.wavedec2 holding dispatch, a driver
#: with its wrappers and their launches, and the stacks
FRAME = [
    ("api.wavedec2", 0, 10 * MS, 0),
    ("api.dispatch", 1 * MS, 2 * MS, 1),
    ("fused.wavedec2", 2 * MS, 7 * MS, 1),
    ("kernel.B2", 3 * MS, 5 * MS, 2),
    ("kernel.launch", 4 * MS, 5 * MS, 3),
    ("kernel.B3", 5 * MS, 7 * MS, 2),
    ("kernel.launch", 6 * MS, 7 * MS, 3),
    ("api.unframe", 8 * MS, 9 * MS, 1),
]
SPANS = FRAME + [(n, s + 20 * MS, e + 20 * MS, d) for n, s, e, d in FRAME]


def test_the_readers_split_a_frame_by_self_time():
    run = record(SPANS)
    got = {name: reader(name)(run) for name in NEW}
    # api: wavedec2's own 10 - 1 - 5 - 1 = 3, dispatch 1, unframe 1
    assert got == pytest.approx({"api_host_ms": 5.0, "unframe_host_ms": 1.0,
                                 "wrapper_host_ms": 3.0, "launch_host_ms": 2.0})
    assert sum(got.values()) - got["unframe_host_ms"] == pytest.approx(10.0)


def test_spans_but_none_of_a_kind_read_zero():
    run = record([("api.wavedec2", 0, 4 * MS, 0), ("separable.dwt2_level", MS, 3 * MS, 1)])
    got = {name: reader(name)(run) for name in NEW}
    assert got == pytest.approx({"api_host_ms": 1.0, "unframe_host_ms": 0.0,
                                 "wrapper_host_ms": 1.0, "launch_host_ms": 0.0})
    assert got["unframe_host_ms"] == 0.0 and got["launch_host_ms"] == 0.0


@pytest.mark.parametrize("case", ["no trace", "no spans", "cpu, no program spans"])
def test_nothing_recorded_reads_none(case):
    run = {"no trace": record(traced=False), "no spans": record([]),
           "cpu, no program spans": record()}[case]
    for name in NEW:
        assert reader(name)(run) is None
    if case == "no trace":
        assert reader("kernel_load_s")(run) is None


def test_kernel_load_s_sums_the_build_and_load_events(monkeypatch):
    from libdwt_torch.utils import trace

    read = reader("kernel_load_s")
    monkeypatch.setattr(trace, "_once", [])
    assert read(record()) == 0.0
    trace.once("cuda.build", 2.5, compiled=["fused2l.cu", "deep.cu"])
    trace.once("cuda.load", 0.25)
    trace.once("something.else", 9.0)
    assert read(record()) == pytest.approx(2.75)


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "libdwt_torch.utils.trace", None)
    assert reader("kernel_load_s")(record()) is None
    assert program_trace._measure(record()) is None


RECORDS = [("fwd2_kernel<float>(args)", 100, 50), ("deep_fwd_kernel<float>", 300, 20),
           ("CatArrayBatchedCopy", 500, 10), ("fwd2_kernel<float>(args)", 900, 50)]
HOST = [("in the program's call", 0, 450), ("in the program's call", 460, 890),
        ("waiting on a frame's completion", 890, 1000)]


def test_idle_gaps_without_program_spans_are_the_harness_labels_to_the_byte():
    for prog in (None, []):
        got = program_trace.idle_gaps(RECORDS, HOST, prog)
        assert repr(got) == repr(tracing.idle_gaps(RECORDS, HOST))
    assert repr(program_trace.idle_gaps(RECORDS, HOST)) == repr(tracing.idle_gaps(RECORDS, HOST))


def test_idle_gaps_take_the_innermost_program_span():
    prog = [("api.wavedec2", 0, 440, 0), ("fused.wavedec2", 10, 400, 1),
            ("kernel.B3", 200, 320, 2), ("kernel.launch", 210, 290, 3),
            ("api.wavedec2", 470, 880, 0), ("api.unframe", 600, 870, 1)]
    got = dict(program_trace.idle_gaps(RECORDS, HOST, prog))
    # gap 150-300 (mid 225): the launch inside B3 inside the driver
    assert got["kernel.launch; after fwd2_kernel<float>"] == pytest.approx(150e-9)
    # gap 320-500 (mid 410): in the harness's call span, after the driver's end
    assert got["api.wavedec2; after deep_fwd_kernel<float>"] == pytest.approx(180e-9)
    # gap 510-900 (mid 705): the stacks
    assert got["api.unframe; after CatArrayBatchedCopy"] == pytest.approx(390e-9)
    assert len(got) == 3


def test_a_gap_outside_every_program_span_keeps_the_harness_label():
    prog = [("api.wavedec2", 0, 120, 0)]
    got = dict(program_trace.idle_gaps(RECORDS, HOST, prog))
    assert "in the program's call; after fwd2_kernel<float>" in got
    assert "in the program's call; after CatArrayBatchedCopy" in got


def test_trace_with_three_positional_arguments_still_builds():
    window = harness.Window(1, 0.1, [0.1], [0.05], 0)
    t = harness.Trace(window, [("k", 0, 1)], [("in the program's call", 0, 2)])
    assert t.window is window and t.records == [("k", 0, 1)]
    assert program_trace.program_trace(harness.RunRecord({}, {}, "cpu", 0.0, window, t)) is None


@pytest.mark.parametrize("config,mix", [("dci4k_cdf97_f32", "encode"),
                                        ("dci4k_cdf97_f32", "decode")])
def test_the_sub_windows_rehearsed_on_the_cpu(config, mix, capsys):
    """The four sub-windows at a small size on the CPU: recorder closed,
    open, closed, open; the spans and counters of the two open ones."""
    import json

    bench = Path(__file__).resolve().parents[1]
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    cfg.update(rows=72, columns=136)
    m = json.loads((bench / "mixes" / f"{mix}.json").read_text())
    m.update(pool_frames=2, trace_frames=3)
    window = harness.Window(1, 1.0, [1.0], [1.0], 0)
    run = harness.RunRecord(cfg, m, "cpu", 1.0, window, harness.Trace(window, [], []))
    pt = program_trace._measure(run, device="cpu")
    assert [w.recorded for w in pt.windows] == [False, True, False, True]
    assert pt.frames == 6 and all(w.frames == 3 for w in pt.windows)
    entry = "wavedec2" if mix == "encode" else "waverec2"
    (key, n), = [(k, n) for k, n in pt.counts["dispatch"].items() if k[0] == entry]
    assert key[1:4] == ("fwd" if mix == "encode" else "inv", "separable", "72x136") and n == 6
    assert sum(1 for s in pt.spans if s[0] == f"api.{entry}" and s[3] == 0) == 6
    assert 0 < per_frame(pt, "api.") and 0 < per_frame(pt, "separable.")
    out = capsys.readouterr().out
    assert "program dispatch counter over 6 frames" in out and out.count("recorder o") == 4


def per_frame(pt, prefix):
    return program_trace.per_frame_ms(pt, lambda name: name.startswith(prefix))
