"""The port's host-side recorder (``libdwt_torch.utils.trace``): spans,
counters and one-time events, the 2-D API's spans and its ``dispatch``
counter on the CPU, and ``comm_stats`` counting through it.  Torch only;
a second or so in one process."""
import time
import tracemalloc
from collections import Counter

import pytest
import torch

from libdwt_torch import api
from libdwt_torch.parallel import comm_stats
from libdwt_torch.utils import trace


def test_off_a_site_returns_the_shared_no_op_and_records_nothing():
    assert not trace.enabled()
    assert trace.span("api.wavedec2") is trace.OFF
    assert trace.span("kernel.B2") is trace.OFF
    with trace.span("api.dispatch") as got:
        assert got is None
    trace.count("dispatch", ("wavedec2",))
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_off_a_site_allocates_nothing():
    def sites(n):
        for _ in range(n):
            with trace.span("api.wavedec2"):
                with trace.span("kernel.launch"):
                    pass
            trace.count("dispatch", "key")

    sites(100)  # warm the loop's own objects
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        sites(10_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [d for d in after.compare_to(before, "filename")
            if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert mine == []


def test_on_nesting_depth_and_self_time():
    with trace.recording() as rec:
        with trace.span("outer"):
            with trace.span("mid"):
                with trace.span("inner"):
                    time.sleep(0.002)
            with trace.span("mid"):
                pass
            time.sleep(0.002)
    by = {}
    for name, start, end, depth in rec.spans:
        by.setdefault(name, []).append((start, end, depth))
    assert [d for _, _, d in by["outer"]] == [0]
    assert sorted(d for _, _, d in by["mid"]) == [1, 1]
    assert [d for _, _, d in by["inner"]] == [1 + 1]
    (o0, o1, _), = by["outer"]
    (i0, i1, _), = by["inner"]
    m = sorted(by["mid"])
    assert o0 <= m[0][0] <= i0 <= i1 <= m[0][1] <= m[1][0] <= m[1][1] <= o1
    own = trace.self_ns(rec.spans)
    assert own["inner"] == i1 - i0
    assert own["mid"] == sum(e - s for s, e, _ in m) - (i1 - i0)
    assert own["outer"] == (o1 - o0) - sum(e - s for s, e, _ in m)
    assert sum(own.values()) == o1 - o0
    assert own["outer"] >= 2_000_000 and own["inner"] >= 2_000_000


def test_self_time_of_siblings_and_of_spans_that_touch():
    spans = [("a", 0, 10, 0), ("b", 2, 4, 1), ("b", 4, 7, 1), ("c", 4, 5, 2), ("a", 10, 12, 0)]
    assert trace.self_ns(spans) == {"a": 10 - 5 + 2, "b": 2 + 3 - 1, "c": 1}


def test_span_stamps_fall_between_two_host_clock_readings():
    with trace.recording() as rec:
        t0 = time.time_ns()
        with trace.span("x"):
            pass
        t1 = time.time_ns()
    (_, start, end, _), = rec.spans
    assert t0 <= start <= end <= t1


def test_counts_go_to_the_innermost_recorder():
    with trace.recording() as outer:
        trace.count("dispatch", "a")
        with trace.recording() as inner:
            trace.count("dispatch", "a", 2)
            with trace.span("s"):
                pass
        trace.count("dispatch", "a")
    assert outer.counts == {"dispatch": {"a": 2}} and outer.spans == []
    assert inner.counts == {"dispatch": {"a": 2}} and [s[0] for s in inner.spans] == ["s"]
    assert not trace.enabled()


def test_once_events_are_kept_with_the_recorder_off():
    assert not trace.enabled()
    n = len(trace.once_events())
    trace.once("cuda.build", 1.5, compiled=["fused2l.cu"])
    with trace.recording():
        trace.once("cuda.load", 0.25)
    events = trace.once_events()[n:]
    assert events == [("cuda.build", 1.5, {"compiled": ["fused2l.cu"]}),
                      ("cuda.load", 0.25, {})]


def test_collective_stats_keep_their_results_inside_an_open_recorder():
    def fn():
        comm_stats.record("ppermute", 64)
        comm_stats.record("ppermute", 32)
        api.dwt2(torch.zeros(8, 8), "cdf53")
        trace.count("dispatch", "other")

    with trace.recording() as outer:
        st = comm_stats.collective_stats(fn)
    assert st == {"ppermute": {"count": 2, "bytes": 96}}
    assert outer.counts == {} and outer.spans == []
    comm_stats.record("ppermute", 8)  # no recorder open: nothing, no error


def _run(impl):
    x = torch.rand(3, 64, 128, generator=torch.Generator().manual_seed(5))
    with trace.recording() as rec:
        coeffs = api.wavedec2(x, "cdf97", level=3, impl=impl)
        y = api.waverec2(coeffs, "cdf97", impl=impl)
    assert float((y - x).abs().max()) < 1e-4
    return Counter(s[0] for s in rec.spans), rec.counts["dispatch"], rec.spans


def test_api_spans_and_dispatch_counts_on_the_oracle():
    names, dispatch, spans = _run(None)
    key = ("float32", "cdf97")
    assert dispatch == {
        ("wavedec2", "fwd", "separable", "64x128", *key, 3): 1,
        ("dwt2", "fwd", "separable", "64x128", *key, 1): 1,
        ("dwt2", "fwd", "separable", "32x64", *key, 1): 1,
        ("dwt2", "fwd", "separable", "16x32", *key, 1): 1,
        ("waverec2", "inv", "separable", "64x128", *key, 3): 1,
        ("idwt2", "inv", "separable", "16x32", *key, 1): 1,
        ("idwt2", "inv", "separable", "32x64", *key, 1): 1,
        ("idwt2", "inv", "separable", "64x128", *key, 1): 1,
    }
    assert names == {"api.wavedec2": 1, "api.waverec2": 1, "api.dwt2": 3, "api.idwt2": 3,
                     "api.dispatch": 8, "separable.dwt2_level": 3,
                     "separable.idwt2_level": 3}
    depth = {(n, d) for n, _, _, d in spans}
    assert ("api.wavedec2", 0) in depth and ("api.dwt2", 1) in depth
    assert ("separable.dwt2_level", 2) in depth and ("api.dispatch", 2) in depth


def test_api_spans_and_dispatch_counts_on_the_fused_plain_versions():
    names, dispatch, _ = _run("fused")
    key = ("64x128", "float32", "cdf97", 3)
    assert dispatch == {("wavedec2", "fwd", "fused", *key): 1,
                        ("waverec2", "inv", "fused", *key): 1}
    # three frames: the deep tail (B3 / B6) each way, one unframe each way;
    # no launch on the CPU
    assert names == {"api.wavedec2": 1, "api.waverec2": 1, "api.dispatch": 2,
                     "fused.wavedec2": 3, "fused.waverec2": 3, "kernel.B3": 3,
                     "kernel.B6": 3, "api.unframe": 2}


@pytest.mark.parametrize("batch", [(3,), (2, 2)])
def test_unframe_keeps_the_batch_and_the_pytree(batch):
    x = torch.rand(*batch, 64, 128, generator=torch.Generator().manual_seed(1))
    got = api.wavedec2(x, "cdf97", level=2, impl="fused")
    want = api.wavedec2(x, "cdf97", level=2, impl="separable")
    assert isinstance(got, list) and all(isinstance(t, tuple) for t in got[1:])
    assert len(got) == len(want) == 3
    for g, w in zip([got[0]] + [b for lvl in got[1:] for b in lvl],
                    [want[0]] + [b for lvl in want[1:] for b in lvl]):
        assert g.shape == w.shape and float((g - w).abs().max()) < 1e-4
    bands = api.dwt2(x, "cdf97", impl="fused")
    assert isinstance(bands, tuple) and len(bands) == 4
    assert bands[0].shape == (*batch, 32, 64)
