"""Port vs reference: the banded-matmul body (B13) and its streamed kernels.

The port's banded module (``libdwt_torch.ops.banded``) against the JAX
package's (``libdwt_tpu.ops.banded``): the lifting matrices (1e-12), the
bf16 split of the matrices (bit for bit: torch rounds to nearest even as
ml_dtypes does), the 16-row blocking (1e-6), and the kernels' matrix
layout.  Then B8/B10/B11/B12 with ``body='mxu'`` on CPU tensors (their
plain versions) against the JAX kernels with the same body in interpret
mode, as ``tests/test_banded.py`` runs them, and against the separable
oracle: 1e-4 between the two banded bodies (each rounds at about 2^-17),
2e-4 against the oracle, round trips 2e-4 (two levels) and 5e-4 (the
pyramid).  Inputs come from a numpy seed.
"""
import numpy as np
import pytest
import torch

import libdwt_tpu.api as japi
import libdwt_tpu.ops.banded as jb
import libdwt_tpu.ops.separable as js
import libdwt_tpu.ops.streamed as jst
from libdwt_torch import api
from libdwt_torch.ops import _cuda
from libdwt_torch.ops import banded as tb
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import streamed as ts


def _leaves(t):
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _maxdiff(got, want) -> float:
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    worst = 0.0
    for a, b in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape
        worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()))
    return worst


def _t(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(s) for s in tree)
    return torch.from_numpy(np.array(tree))


def _rand(h, w, seed):
    return np.random.default_rng(seed).random((h, w), dtype=np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    tf.reset_counters()


# ------------------------------------------------------------ the matrices


@pytest.mark.parametrize("edges", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [16, 64, 96, 130])
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53", "haar"])
def test_lift_matrix_matches_reference(wavelet, n, inverse, edges):
    got = tb.lift_matrix(n, wavelet, inverse=inverse, edges=edges, dtype=np.float64)
    want = jb.lift_matrix(n, wavelet, inverse=inverse, edges=edges, dtype=np.float64)
    assert got.shape == (n, n)
    assert np.abs(got - want).max() <= 1e-12
    # and the default float32 cast agrees bit for bit
    assert np.array_equal(tb.lift_matrix(n, wavelet, inverse=inverse, edges=edges),
                          jb.lift_matrix(n, wavelet, inverse=inverse, edges=edges))


def _split_inputs():
    rng = np.random.default_rng(0)
    m = tb.lift_matrix(96, "cdf97").astype(np.float32)
    # halfway between two bf16 values: round to the even one
    ties = ((np.arange(64, dtype=np.uint32) + 0x3F00) << 16 | 0x8000).view(np.float32)
    wide = (rng.standard_normal(4096) * np.exp2(rng.integers(-40, 40, 4096))).astype(np.float32)
    return {"matrix": m, "ties": np.concatenate([ties, -ties]), "wide": wide,
            "canvases": tb.pass_matrix(72, "cdf97", True).hi.float().numpy()}


@pytest.mark.parametrize("case", ["matrix", "ties", "wide", "canvases"])
def test_split_bf16_matches_reference_bit_for_bit(case):
    m = _split_inputs()[case]
    hi, lo = tb.split_bf16(m)
    ref = jb.split_bf16(m.reshape(1, 1, -1) if m.ndim == 1 else m.reshape((1,) + m.shape))
    width = ref.shape[-1] // 2
    want_hi = ref[..., :width].view(np.uint16).reshape(m.shape)
    want_lo = ref[..., width:].view(np.uint16).reshape(m.shape)
    assert np.array_equal(hi.view(torch.int16).numpy().view(np.uint16), want_hi)
    assert np.array_equal(lo.view(torch.int16).numpy().view(np.uint16), want_lo)


def test_split_data_is_exact():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-60, 60, 1 << 16))).astype(np.float32))
    x0, x1, x2 = tb.split_data(x)
    for part in (x0, x1, x2):  # every part is a bf16 value
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.equal(x0 + x1 + x2, x)
    assert torch.equal((x0 + x1) + x2, x)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [16, 24, 40, 44, 72, 88, 96, 130, 256])
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53", "interp53", "haar"])
def test_blocks_reconstruct_the_product(wavelet, n, inverse):
    m = tb.lift_matrix(n, wavelet, inverse=inverse, dtype=np.float64)
    canvases, metas = tb.banded_blocks(m)
    x = np.random.default_rng(n).random((n, 7))
    n_pad = -(-n // tb.BLOCK) * tb.BLOCK
    xp = np.zeros((n_pad, 7))
    xp[:n] = x
    kw = canvases.shape[-1]
    assert kw % 16 == 0 and kw <= tb.KWIN and len(metas) == n_pad // 16
    got = np.concatenate([canvases[i] @ xp[k0:k0 + kw] for i, k0 in metas])[:n]
    assert all(k0 % 16 == 0 and k0 + kw <= n_pad for _, k0 in metas)
    assert np.abs(got - m @ x).max() <= 1e-6
    # interior blocks share one canvas
    assert len(canvases) <= 4
    # the dense hi + lo rebuilt from the blocked canvases is the float32
    # matrix to the split's 2^-17
    pm = tb.pass_matrix(n, wavelet, inverse)
    whi, wlo = pm.dense()
    w32 = m.astype(np.float32)
    assert np.abs((whi.double() + wlo.double()).numpy() - w32).max() <= 2e-5 * np.abs(w32).max()


def test_blocks_refuse_a_band_wider_than_the_window():
    m = np.triu(np.ones((64, 64)))
    with pytest.raises(ValueError, match="wider"):
        tb.banded_blocks(m)


def _emulate_pass(x, bm, frags, cols):
    """The index arithmetic of csrc/banded.cuh pass in numpy (float64,
    exact products) on ``x`` (lines, n): each tile's lanes apply their B
    fragments (hi + lo) to the samples their A fragments read, clamped into
    the window as the kernel clamps them (a row pass reads sample pairs, a
    column pass single samples)."""
    n = bm.n
    slots = tb.tile_slots(cols)
    out = np.zeros_like(x)
    for m in range(bm.ntiles):
        # (32 lanes, 8): Whi at the lane's K slots 2t, 2t + 1, 2t + 8, 2t + 9
        # (registers b0, b1, each a bf16 pair, low half first), then Wlo
        f = frags[bm.off + m]
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            q = 8 * m + slots[g]  # the output position of B column g
            if q >= n:
                continue
            for j, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                base = 8 * (m + k // 8) - 4  # the half of K slot k
                if cols:
                    p = min(max(base + slots[k % 8], 0), n - 1)
                else:
                    p = min(max(base + 2 * t, 0), n - 2) + k % 2
                out[:, q] += (f[lane, j] + f[lane, 4 + j]) * x[:, p]
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ty,tx", [(64, 64), (32, 48), (16, 20)])
def test_kernel_matrices_layout(inverse, ty, tx):
    """The MxuMats the CUDA body reads (offsets, tiles, each lane's B
    fragments in its pass's K and N orders) apply each of its four
    passes."""
    mats = tb.kernel_mats("cdf97", inverse, ty, tx, "cpu")
    buf = tb._kernel_cache[("cdf97", inverse, ty, tx, "cpu")][1]
    assert tuple(buf.shape) == (mats.tiles, 32, 8) and buf.dtype == torch.bfloat16
    frags = buf.double().numpy()
    rng = np.random.default_rng(ty + tx)
    for i, (n, cols) in enumerate(zip(tb.pass_lengths(inverse, ty, tx),
                                      tb.pass_columns(inverse))):
        bm = mats.m[i]
        assert (bm.n, bm.ntiles) == (n, -(-n // 8))
        x = rng.standard_normal((5, n))
        got = _emulate_pass(x, bm, frags, cols)
        whi, wlo = tb.pass_matrix(n, "cdf97", inverse).dense()
        want = x @ (whi.double() + wlo.double()).numpy().T
        assert np.abs(got - want).max() <= 1e-12


def test_plain_pass_matches_the_float64_product():
    pm = tb.pass_matrix(88, "cdf97", False)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 88, 40)).astype(np.float32))
    whi, wlo = pm.dense()
    want = (whi.double() + wlo.double()) @ x.double()
    got = tb.apply_packed_plain(x, pm, -2)
    assert float((got.double() - want).abs().max()) <= 5e-6
    got_rows = tb.apply_packed_plain(x.transpose(-1, -2).contiguous(), pm, -1)
    assert float((got_rows.double() - want.transpose(-1, -2)).abs().max()) <= 5e-6
    with pytest.raises(ValueError, match="88-sample pass"):
        tb.apply_packed_plain(x, pm, -1)


def test_window_lift_matches_the_polyphase_lift_inside_the_halo():
    """A 2-D banded lift of a window equals the polyphase lift of the same
    window on every position at least 4 from its edges."""
    t = torch.from_numpy(np.random.default_rng(3).random((2, 1, 96, 88), dtype=np.float32))
    table, scales = tf._step_table(tf.get_wavelet("cdf97"), False, False)
    poly = tf._lift2d(t.clone(), table, scales, False, None)
    band = tb.analysis2d_packed(t, "cdf97")
    assert float((band - poly)[..., 4:-4, 4:-4].abs().max()) <= 2e-5
    table_i, scales_i = tf._step_table(tf.get_wavelet("cdf97"), False, True)
    back = tb.synthesis2d_packed(poly, "cdf97")
    ipoly = tf._lift2d(poly.clone(), table_i, scales_i, True, None)
    assert float((back - ipoly)[..., 8:-8, 8:-8].abs().max()) <= 2e-5


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("shape", [(256, 128), (288, 256), (260, 132)])
def test_b8_mxu_matches_reference(shape):
    h, w = shape
    x = _rand(h, w, h + w)
    want = jst.streamed_dwt2_2level(x, "cdf97", strip_rows=64, interpret=True, body="mxu")
    got = ts.streamed_dwt2_2level(torch.from_numpy(x), "cdf97", strip_rows=64, body="mxu")
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B8": 1, "B13": 1}
    for g, r in zip(_leaves(got), _leaves(want)):
        assert _maxdiff(g, r) <= 1e-4
    assert _maxdiff(got, js.wavedec2(x, "cdf97", 2)) <= 2e-4


@pytest.mark.parametrize("shape", [(256, 128), (288, 256), (260, 144)])
def test_b10_mxu_matches_reference(shape):
    h, w = shape
    x = _rand(h, w, h * w)
    c = js.wavedec2(x, "cdf97", 2)
    want = jst.streamed_idwt2_2level(c[0], tuple(c[1]), tuple(c[2]), "cdf97", strip_rows=64,
                                     interpret=True, body="mxu")
    got = ts.streamed_idwt2_2level(*_t([c[0], tuple(c[1]), tuple(c[2])]), "cdf97",
                                   strip_rows=64, body="mxu")
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B10": 1, "B13": 1}
    assert _maxdiff(got, want) <= 1e-4
    assert _maxdiff(got, x) <= 2e-4


def test_b11_b12_mxu_match_the_oracle():
    x = _rand(256, 256, 6)
    got = ts.streamed_wavedec2_deep(torch.from_numpy(x), "cdf97", 4, strip_rows=64, body="mxu")
    assert _maxdiff(got, js.wavedec2(x, "cdf97", 4)) <= 2e-4
    rec = ts.streamed_waverec2_deep(got, "cdf97", strip_rows=64, body="mxu")
    assert _maxdiff(rec, x) <= 5e-4
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {
        "B11": 1, "B12": 1, "B13": 2}
    # the deep levels stay polyphase: below LL2 the pyramid is the poly
    # deep tail's on the banded LL2
    ll2 = ts.streamed_dwt2_2level_plain(torch.from_numpy(x), "cdf97", body="mxu")[0]
    assert _maxdiff(got[:3], tf.fused_deep_wavedec2_plain(ll2, "cdf97", 2)) == 0


def test_api_streamed_mxu_matches_reference():
    x = _rand(512, 512, 7)
    want = japi.wavedec2(x, "cdf97", 3, impl="streamed-mxu")
    got = api.wavedec2(torch.from_numpy(x), "cdf97", 3, impl="streamed-mxu")
    assert _maxdiff(got, want) <= 1e-4
    rec_want = japi.waverec2(want, "cdf97", impl="streamed-mxu")
    rec = api.waverec2(_t([want[0]] + [tuple(b) for b in want[1:]]), "cdf97",
                       impl="streamed-mxu")
    assert _maxdiff(rec, rec_want) <= 1e-4
    assert _maxdiff(rec, x) <= 5e-4
    assert tf.KERNELS["B13"].calls == 2


def _both_raise(port_call, ref_call):
    with pytest.raises(ValueError):
        ref_call()
    with pytest.raises(ValueError):
        port_call()


@pytest.mark.parametrize("kernel", ["B8", "B10", "B11", "B12", "api"])
def test_int32_and_unknown_bodies_raise_as_in_reference(kernel):
    xi = np.random.default_rng(8).integers(0, 255, (256, 256)).astype(np.int32)
    xf = _rand(256, 256, 8)
    if kernel == "B8":
        for x, body in ((xi, "mxu"), (xf, "matmul")):
            _both_raise(lambda: ts.streamed_dwt2_2level(torch.from_numpy(x), "cdf53", body=body),
                        lambda: jst.streamed_dwt2_2level(x, "cdf53", body=body, interpret=True))
    elif kernel == "B10":
        for x, body in ((xi, "mxu"), (xf, "matmul")):
            c = js.wavedec2(x, "cdf53", 2)
            _both_raise(lambda: ts.streamed_idwt2_2level(*_t([c[0], tuple(c[1]), tuple(c[2])]),
                                                         "cdf53", body=body),
                        lambda: jst.streamed_idwt2_2level(c[0], tuple(c[1]), tuple(c[2]),
                                                          "cdf53", body=body, interpret=True))
    elif kernel == "B11":
        for x, body in ((xi, "mxu"), (xf, "matmul")):
            _both_raise(lambda: ts.streamed_wavedec2_deep(torch.from_numpy(x), "cdf53", 3,
                                                          body=body),
                        lambda: jst.streamed_wavedec2_deep(x, "cdf53", 3, body=body,
                                                           interpret=True))
    elif kernel == "B12":
        for x, body in ((xi, "mxu"), (xf, "matmul")):
            c = js.wavedec2(x, "cdf53", 3)
            _both_raise(lambda: ts.streamed_waverec2_deep(_t(c), "cdf53", body=body),
                        lambda: jst.streamed_waverec2_deep(c, "cdf53", body=body,
                                                           interpret=True))
    else:
        _both_raise(lambda: api.wavedec2(torch.from_numpy(xi), "cdf53", 2, impl="streamed-mxu"),
                    lambda: japi.wavedec2(xi, "cdf53", 2, impl="streamed-mxu"))
        c = js.wavedec2(xi, "cdf53", 2)
        _both_raise(lambda: api.waverec2(_t(c), "cdf53", impl="streamed-mxu"),
                    lambda: japi.waverec2(c, "cdf53", impl="streamed-mxu"))
    assert tf.KERNELS["B13"].calls == 0


def test_mxu_supported_is_importable_from_streamed():
    assert ts.mxu_supported is tb.mxu_supported
    assert tb.mxu_supported("cdf97", torch.float32)
    assert not tb.mxu_supported("cdf97", torch.float64)
    assert not tb.mxu_supported("d4", torch.float32)
    assert not tb.mxu_supported("cdf53", torch.int32)
