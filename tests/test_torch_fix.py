"""Port vs reference: Q-format fixed point (``libdwt_torch.utils.fix``).

The same seeded numpy inputs go through ``libdwt_tpu.utils.fix`` (under
``jax.jit``) and ``libdwt_torch.utils.fix`` on the CPU.  Bound: every
result is equal bit for bit, for FIX32 and FIX16, for cdf97, cdf53, haar
and d4, on even, odd and batched shapes.  The cases follow
tests/test_fix2d.py and the fixed-point cases of
tests/test_wavelets_extra.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.utils.fix as jf
import libdwt_torch.utils.fix as tf
from libdwt_tpu.models.wavelets import get_wavelet as jget
from libdwt_torch.models.wavelets import get_wavelet as tget

QS = [(tf.FIX32, jf.FIX32), (tf.FIX16, jf.FIX16)]
QIDS = ["fix32", "fix16"]
WAVELETS = ["cdf97", "cdf53", "haar", "d4"]


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _exact(got, want):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_qformats():
    for tq, jq in QS:
        assert (tq.name, tq.n, tq.one, tq.half) == (jq.name, jq.n, jq.one, jq.half)
        assert torch.empty(0, dtype=tq.dtype).numpy().dtype == np.dtype(jq.dtype)
        assert torch.empty(0, dtype=tq.wide).numpy().dtype == np.dtype(jq.wide)


@pytest.mark.parametrize("q", QS, ids=QIDS)
def test_to_fix_from_fix_exact(q):
    tq, jq = q
    # ties at every half step, both signs, and random values
    ties = (np.arange(-8, 9) + 0.5) / tq.one
    x = np.concatenate([ties, np.random.RandomState(1).uniform(-3, 3, 200)]).astype(np.float32)
    got = tf.to_fix(torch.from_numpy(x), tq)
    want = jax.jit(lambda a: jf.to_fix(a, jq))(jnp.asarray(x))
    _exact(got, want)
    _exact(tf.from_fix(got, tq), jf.from_fix(want, jq))
    assert int(tf.to_fix(2.5 / tf.FIX32.one, device="cpu")) == 3
    assert int(tf.to_fix(-2.5 / tf.FIX32.one, device="cpu")) == -3


def test_fix_mul_exact_near_int32_limits():
    """The reference splits the FIX32 product into int32 partial products;
    the port's int64 product must give the same bits, wrap included."""
    rng = np.random.RandomState(2)
    edge = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 1, 2**16, -2**16, 2**15],
                    np.int64)
    x = np.concatenate([edge, rng.randint(-2**31, 2**31, 500, dtype=np.int64)])
    y = np.concatenate([edge[::-1], rng.randint(-2**31, 2**31, 500, dtype=np.int64)])
    x, y = x.astype(np.int32), y.astype(np.int32)
    want = jax.jit(lambda a, b: jf.fix_mul(a, b, jf.FIX32))(jnp.asarray(x), jnp.asarray(y))
    _exact(tf.fix_mul(torch.from_numpy(x), torch.from_numpy(y), tf.FIX32), want)
    # x against itself squares the extremes too
    want = jax.jit(lambda a: jf.fix_mul(a, a, jf.FIX32))(jnp.asarray(x))
    _exact(tf.fix_mul(torch.from_numpy(x), torch.from_numpy(x), tf.FIX32), want)
    # FIX16 operands over the whole int16 range
    a = rng.randint(-2**15, 2**15, 500).astype(np.int16)
    b = rng.randint(-2**15, 2**15, 500).astype(np.int16)
    want = jax.jit(lambda u, v: jf.fix_mul(u, v, jf.FIX16))(jnp.asarray(a), jnp.asarray(b))
    _exact(tf.fix_mul(torch.from_numpy(a), torch.from_numpy(b), tf.FIX16), want)
    assert float(tf.from_fix(tf.fix_mul(tf.to_fix(0.5, device="cpu"),
                                        tf.to_fix(0.5, device="cpu")))) == 0.25


@pytest.mark.parametrize("q", QS, ids=QIDS)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_lift_and_dwt2_fix_exact(q, wavelet):
    """1-D lifting at lengths 0-3 (the small-N rule); the 2-D level and its
    inverse on a batch of two images with an even number of rows and an odd
    number of columns.  The reference runs every shape in one compiled
    call."""
    tq, jq = q
    shapes1 = [(0,), (1,), (2,), (3,)]
    shapes2 = [(2, 32, 47)]
    x1 = [tf.to_fix(torch.from_numpy(_img(sh, sum(sh))), tq) for sh in shapes1]
    x2 = [_img(sh, 3) for sh in shapes2]

    @jax.jit
    def ref(ones, twos):
        out1, out2 = [], []
        for a in ones:
            s, d = jf.lift_fwd_fix(a, wavelet, jq)
            out1.append((s, d, jf.lift_inv_fix(s, d, wavelet, jq)))
        for a in twos:
            bands = jf.dwt2_fix(jf.to_fix(a, jq), wavelet, jq)
            out2.append((bands, jf.idwt2_fix(*bands, wavelet, jq)))
        return out1, out2

    want1, want2 = ref([jnp.asarray(a.numpy()) for a in x1], [jnp.asarray(a) for a in x2])
    for xq, (s, d, rec) in zip(x1, want1):
        got = tf.lift_fwd_fix(xq, wavelet, tq)
        _exact(got, (s, d))
        _exact(tf.lift_inv_fix(*got, wavelet, tq), rec)
    for x, (bands, rec) in zip(x2, want2):
        got = tf.dwt2_fix(tf.to_fix(torch.from_numpy(x), tq), wavelet, tq)
        _exact(got, bands)
        back = tf.idwt2_fix(*got, wavelet, tq)
        _exact(back, rec)
        # the round trip is approximate, as in tests/test_fix2d.py
        tol = {"fix32": 1e-3, "fix16": 4e-2}[tq.name]
        if wavelet in ("cdf97", "cdf53"):
            assert float((tf.from_fix(back, tq) - torch.from_numpy(x)).abs().max()) <= tol


def test_single_rounding_per_symmetric_step():
    """A one-step wavelet: d + fix_mul(l + r, c), one rounded multiply on
    the sum, exactly as the reference."""
    x = tf.to_fix(torch.from_numpy(_img((16,))))
    st = tget("cdf97").steps[0]
    w1 = dataclasses.replace(tget("cdf97"), steps=(st,), scale_s=None, scale_d=None)
    jw1 = dataclasses.replace(jget("cdf97"), steps=(jget("cdf97").steps[0],),
                              scale_s=None, scale_d=None)
    s, d = x[0::2], x[1::2]
    want = d + tf.fix_mul(s + torch.cat([s[1:], s[-1:]]), tf.to_fix(st.coeff, device="cpu"))
    _exact(tf.lift_fwd_fix(x, w1)[1], want.numpy())
    _exact(tf.lift_fwd_fix(x, w1)[1], jf.lift_fwd_fix(jnp.asarray(x.numpy()), jw1)[1])


def test_inputs_stay_on_their_device_and_raw_input_goes_to_the_card():
    xq = tf.to_fix(np.ones((4, 6), np.float32), device="cpu")
    assert xq.device.type == "cpu" and xq.dtype == torch.int32
    assert all(b.device.type == "cpu" for b in tf.dwt2_fix(xq))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tf.to_fix(np.ones(4, np.float32))
