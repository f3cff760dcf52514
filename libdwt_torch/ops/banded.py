"""The banded-matmul body of the streamed strip kernels (B13; port of
``libdwt_tpu.ops.banded``).

Lifting is linear, so one whole 1-D lifting pass over a window (all steps
and the per-parity scaling) is one banded matrix.  The body applies it on
the tensor cores in bfloat16 with float32 sums.  The matrix is split, as
the reference splits it, into a bf16 high part and a bf16 remainder
(``W ~ Whi + Wlo``, about 2^-17 relative); the float32 data is split
exactly into three bf16 parts (``x = x0 + x1 + x2``), and the pass is the
five products ``Whi@(x0 + x1 + x2) + Wlo@(x0 + x1)``.  Float32 only,
symmetric-step wavelets only (:func:`mxu_supported`).

Why three data parts where the reference has two (``Whi@xhi + Whi@xlo +
Wlo@xhi``): with two, ``xhi + xlo`` rounds x at up to 2^-16 relative, and
two float32 sums of the same pass in different orders (the tensor cores'
and the plain version's) that differ by an ulp fall on two sides of that
rounding often enough to differ by 2.6e-5 after two levels (a 1072x2048
frame), above the 2e-5 the kernels are held to against their plain
versions.  With the exact split a pass is a continuous function of its
input and the two orders differ by 9.5e-7 (``tools/mxu_split_divergence.py``).

The CUDA body is ``csrc/banded.cuh``, run by the banded strip kernels of
B8/B10/B11/B12 (``csrc/streamed.cu`` ``sdeep_fwd_mxu``/``sdeep_inv_mxu``).
Their strip loads apply the whole-point border mirror through the source
index, so every window already holds mirrored data and one matrix per
(axis, level, direction, wavelet, window length) serves every strip:
``lift_matrix(n, edges=(False, False))``.  The window-edge positions it
gets wrong (dropped neighbours) are the halo the kernels discard, as the
polyphase body's stale edges are.  The forward applies the column pass,
then the row pass; the inverse the row pass, then the column pass (the
reference's order).

Kept from the reference: :func:`lift_matrix` (same arithmetic, float64)
and the matrix split (:func:`split_bf16`, round to nearest even as
ml_dtypes rounds).  Not carried over: the reference's
Mosaic workarounds (its dot-emission modes, lane panels, 128-row padding
and 480-row strip preference) and its per-strip mirror-fill matrices.
Nothing here reads an environment variable.

Blocking (:func:`banded_blocks`): 16 output rows per block, each with a
16-aligned contraction window of :data:`KWIN` columns that covers its
band; identical blocks (every interior block of a window) share one
canvas.  The plain body (:func:`apply_packed_plain`) multiplies by the
dense matrix rebuilt from those canvases, so it checks the blocking too.
The CUDA body reads the same matrices cut finer (:func:`kernel_mats`):
tiles of 8 output positions, each with the 16 samples from 4 before its
first (every supported wavelet's band is +-4), packed per lane as
``mma.m16n8k16`` B fragments in the kernel's K and N orders
(:func:`tile_slots`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.ops import _cuda
from libdwt_torch.ops.fused import fused_supported
from libdwt_torch.ops._cuda import MXU_MAX_TILES as MAX_TILES, MXU_TILE as TILE

__all__ = ["mxu_supported", "lift_matrix", "banded_blocks", "split_bf16",
           "split_data", "pass_matrix", "apply_packed_plain", "analysis2d_packed",
           "synthesis2d_packed", "kernel_mats", "tile_slots", "BLOCK", "KWIN"]

#: output rows per block: the M (or N) tile of one tensor-core product.
BLOCK = 16
#: contraction window per block: rows [16(b-1), 16(b+2)) hold a band of
#: +-16, and a lifting pass of 4 steps reaches +-4.
KWIN = 48


def mxu_supported(wavelet, dtype) -> bool:
    """The reference's gate of its banded-matmul body: float32 and a
    symmetric-step wavelet (the fused kernels' set)."""
    return dtype == torch.float32 and fused_supported(wavelet)


# ------------------------------------------------------------ construction


def _steps_weights(st) -> Tuple[float, float]:
    if st.is_symmetric:
        return float(st.coeff), float(st.coeff)
    return float(st.left or 0.0), float(st.right or 0.0)


def lift_matrix(n: int, wavelet, inverse: bool = False,
                edges: Tuple[bool, bool] = (False, False), scale: bool = True,
                dtype=np.float32) -> np.ndarray:
    """(n, n) matrix of the full interleaved 1-D lifting pass, built in
    float64: forward the steps then the per-parity scaling, inverse the
    inverse scaling then the reversed, negated steps.

    ``edges``: whole-point mirror at the low/high end; where False,
    out-of-range neighbour contributions are dropped."""
    wavelet = get_wavelet(wavelet)
    M = np.eye(n, dtype=np.float64)
    lo = hi = None
    if scale and wavelet.scale_s is not None:
        if inverse:
            lo = (wavelet.inv_scale_s if wavelet.inv_scale_s is not None
                  else wavelet.scale_d)
            hi = (wavelet.inv_scale_d if wavelet.inv_scale_d is not None
                  else wavelet.scale_s)
        else:
            lo, hi = wavelet.scale_s, wavelet.scale_d
    if inverse and lo is not None:
        d = np.where(np.arange(n) % 2 == 0, lo, hi)
        M *= d[:, None]
    steps = wavelet.steps[::-1] if inverse else wavelet.steps
    sgn = -1.0 if inverse else 1.0
    for st in steps:
        wl, wr = _steps_weights(st)
        wl, wr = sgn * wl, sgn * wr
        start = 1 if st.target == "d" else 0
        idx = np.arange(start, n, 2)
        il, ir = idx - 1, idx + 1
        # whole-point mirror: x[-1] = x[1], x[n] = x[n-2]
        if edges[0]:
            il = np.where(il < 0, 1, il)
        if edges[1]:
            ir = np.where(ir > n - 1, n - 2, ir)
        upd = np.zeros((len(idx), n))
        ok_l = (il >= 0) & (il < n)
        if wl and ok_l.any():
            upd[ok_l] += wl * M[il[ok_l]]
        ok_r = (ir >= 0) & (ir < n)
        if wr and ok_r.any():
            upd[ok_r] += wr * M[ir[ok_r]]
        M[idx] += upd
    if not inverse and lo is not None:
        d = np.where(np.arange(n) % 2 == 0, lo, hi)
        M *= d[:, None]
    return M.astype(dtype)


def banded_blocks(M: np.ndarray, block: int = BLOCK, kwin: int = KWIN):
    """Cut a banded (n, n) matrix into ``block``-row blocks for the tensor
    cores -> (canvases, metas).

    Block b (output rows [b*block, (b+1)*block)) reads the contraction
    window [k0, k0 + kw) with kw = min(kwin, n rounded up to ``block``) and
    k0 = clamp(block*(b-1), 0, n_pad - kw), both multiples of ``block``.
    ``canvases`` is a (K, block, kw) array of the distinct blocks (rows and
    columns past n are zero); ``metas[b] = (canvas index, k0)``.  Raises
    ``ValueError`` if a block's band leaves its window."""
    n_out, n_in = M.shape
    if n_out != n_in:
        raise ValueError("banded_blocks takes a square matrix")
    n_pad = -(-n_in // block) * block
    kw = min(kwin, n_pad)
    padded = np.zeros((n_pad, n_pad), M.dtype)
    padded[:n_out, :n_in] = M
    canvases: List[np.ndarray] = []
    index: dict = {}
    metas: List[Tuple[int, int]] = []
    for b in range(n_pad // block):
        k0 = min(max(block * (b - 1), 0), n_pad - kw)
        rows = padded[b * block:(b + 1) * block]
        if np.any(rows[:, :k0]) or np.any(rows[:, k0 + kw:]):
            raise ValueError(f"block {b}: band wider than its {kw}-column window")
        canvas = np.ascontiguousarray(rows[:, k0:k0 + kw])
        key = canvas.tobytes()
        if key not in index:
            index[key] = len(canvases)
            canvases.append(canvas)
        metas.append((index[key], k0))
    return np.stack(canvases), metas


def split_bf16(m) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 split of a float32 array: ``hi = bf16(m)``, ``lo = bf16(m -
    hi)``, both rounded to nearest even (as ml_dtypes rounds); ``m - hi``
    is exact in float32."""
    m = torch.as_tensor(m, dtype=torch.float32)
    hi = m.to(torch.bfloat16)
    lo = (m - hi.float()).to(torch.bfloat16)
    return hi, lo


class PassMatrix(NamedTuple):
    """One 1-D pass of ``n`` samples, blocked and bf16-split."""
    n: int
    wavelet: str
    inverse: bool
    kw: int
    hi: torch.Tensor  # (K, BLOCK, kw) bf16 canvases
    lo: torch.Tensor
    metas: tuple      # per block: (canvas index, k0)

    def dense(self, device="cpu"):
        """The (n, n) float32 matrices of the hi and lo parts (bf16-exact
        values), rebuilt from the blocked canvases (cached per device)."""
        return _dense(self.n, self.wavelet, self.inverse, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def pass_matrix(n: int, wavelet_name: str, inverse: bool) -> PassMatrix:
    """The banded matrix of one window pass (cached): ``lift_matrix(n,
    edges=(False, False))`` built in float64, cast to float32 as the
    reference's canvases are, blocked, then bf16-split."""
    m = lift_matrix(n, wavelet_name, inverse=inverse, dtype=np.float64)
    canvases, metas = banded_blocks(m.astype(np.float32))
    hi, lo = split_bf16(canvases)
    return PassMatrix(n, wavelet_name, inverse, canvases.shape[-1], hi, lo, tuple(metas))


@functools.lru_cache(maxsize=None)
def _dense(n: int, wavelet_name: str, inverse: bool, device: str):
    pm = pass_matrix(n, wavelet_name, inverse)
    n_pad = len(pm.metas) * BLOCK
    out = []
    for part in (pm.hi, pm.lo):
        d = torch.zeros(n_pad, n_pad)
        for b, (idx, k0) in enumerate(pm.metas):
            d[b * BLOCK:(b + 1) * BLOCK, k0:k0 + pm.kw] = part[idx].float()
        out.append(d[:n, :n].contiguous().to(device))
    return tuple(out)


# ------------------------------------------------------------ plain body


@contextlib.contextmanager
def _full_f32_products():
    """float32 products in full float32, as the reference pins HIGHEST:
    no TF32 on the card and no bf16 down-conversion on the CPU."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def split_data(x: torch.Tensor):
    """The exact three-part bf16 split of float32 data, as float32 tensors
    of bf16 values: ``x0 = bf16(x)``, ``x1 = bf16(x - x0)``, ``x2 = x - x0
    - x1`` (each difference is exact, and x2 fits in bf16)."""
    x0 = x.to(torch.bfloat16).float()
    r = x - x0
    x1 = r.to(torch.bfloat16).float()
    x2 = (r - x1).to(torch.bfloat16).float()
    return x0, x1, x2


def apply_packed_plain(x: torch.Tensor, pm: PassMatrix, axis: int) -> torch.Tensor:
    """One banded pass along ``axis`` (-2: columns, ``W @ x``; -1: rows,
    ``x @ W.T``) of the float32 windows ``x``: the five bf16-exact products
    summed in float32 in the kernel's grouping, the leading ``Whi.x0`` plus
    the sum of the small ``Wlo.x0 + Whi.x1 + Wlo.x1 + Whi.x2``."""
    if x.shape[axis] != pm.n:
        raise ValueError(f"window of {x.shape[axis]} samples for a {pm.n}-sample pass")
    x0, x1, x2 = split_data(x)
    whi, wlo = pm.dense(x.device)
    with _full_f32_products():
        if axis == -2:
            return whi @ x0 + (wlo @ x0 + whi @ x1 + wlo @ x1 + whi @ x2)
        return x0 @ whi.T + (x0 @ wlo.T + x1 @ whi.T + x1 @ wlo.T + x2 @ whi.T)


def analysis2d_packed(t: torch.Tensor, wavelet) -> torch.Tensor:
    """The forward 2-D lift of (..., ey, ex) interleaved windows by banded
    passes: columns, then rows (steps and scaling of both axes)."""
    name = get_wavelet(wavelet).name
    ey, ex = t.shape[-2:]
    u = apply_packed_plain(t, pass_matrix(ey, name, False), -2)
    return apply_packed_plain(u, pass_matrix(ex, name, False), -1)


def synthesis2d_packed(t: torch.Tensor, wavelet) -> torch.Tensor:
    """The inverse 2-D lift of (..., ey, ex) interleaved coefficient
    windows by banded passes: rows, then columns (inverse scaling
    included)."""
    name = get_wavelet(wavelet).name
    ey, ex = t.shape[-2:]
    u = apply_packed_plain(t, pass_matrix(ex, name, True), -1)
    return apply_packed_plain(u, pass_matrix(ey, name, True), -2)


# ------------------------------------------------------------ kernel matrices


def pass_lengths(inverse: bool, ty: int, tx: int) -> Tuple[int, int, int, int]:
    """Window lengths of the four passes of a streamed strip kernel, in the
    order it runs them: forward (level-1 columns, level-1 rows, level-2
    columns, level-2 rows) over the (ty + 32) x (tx + 24) level-1 window
    and the (ty/2 + 8) x (tx/2 + 8) LL1 window; inverse (level-2 rows,
    level-2 columns, level-1 rows, level-1 columns) over the
    (ty/2 + 16) x (tx/2 + 16) and (ty + 8) x (tx + 8) windows
    (csrc/streamed.cu)."""
    if inverse:
        return tx // 2 + 16, ty // 2 + 16, tx + 8, ty + 8
    return ty + 32, tx + 24, ty // 2 + 8, tx // 2 + 8


def pass_columns(inverse: bool) -> Tuple[bool, bool, bool, bool]:
    """Which of the four passes run along columns (the order of
    :func:`pass_lengths`)."""
    return (False, True, False, True) if inverse else (True, False, True, False)


def tile_slots(cols: bool) -> np.ndarray:
    """The sample of its 16-sample window that each K slot of the CUDA
    body's A fragment holds (slots 0-7 the lower half, 8-15 the upper);
    slot s < 8 is also the output position of N slot s.  The fragment
    gives lane t the slots 2t and 2t + 1 of each half: a row pass reads
    them as the sample pair 2t, 2t + 1; a column pass as the samples t and
    t + 4 (four consecutive window rows over the four lanes: no bank
    conflicts at a row stride of 8 mod 16 words)."""
    half = np.array([s // 2 + 4 * (s % 2) if cols else s for s in range(8)])
    return np.concatenate([half, 8 + half])


def _tile_fragments(hi: np.ndarray, lo: np.ndarray, cols: bool) -> np.ndarray:
    """(32, 8) float32 per lane of one tile's (8 positions x 16 samples,
    natural order) hi and lo matrices: the m16n8k16 B fragment registers
    (Whi b0, Whi b1, Wlo b0, Wlo b1), each two bf16 values, low half
    first.  Lane l = 4g + t holds B column g (output position slots[g])
    at K slots 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1)."""
    slots = tile_slots(cols)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    ks = slots[np.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], 1)]  # (32, 4)
    rows = slots[g][:, None]
    return np.concatenate([hi[rows, ks], lo[rows, ks]], 1)


_kernel_cache: dict = {}


def kernel_mats(wavelet, inverse: bool, ty: int, tx: int, device):
    """The :class:`MxuMats` of a strip kernel (built on the host from the
    plain version's matrices, packed, uploaded once per wavelet, direction,
    strip and card; cached): per pass, its tiles of 8 output positions,
    each with its window of 16 samples from 4 before the tile's first, as
    32 lanes x 8 bf16 of fragments (:func:`_tile_fragments`).  Raises
    ``ValueError`` where a window is longer than 256 samples or a band
    leaves its tile's window."""
    name = get_wavelet(wavelet).name
    device = torch.device(device)
    key = (name, inverse, ty, tx, str(device))
    if key not in _kernel_cache:
        mats = _cuda.MxuMats()
        frags, off = [], 0
        for i, (n, cols) in enumerate(zip(pass_lengths(inverse, ty, tx),
                                          pass_columns(inverse))):
            nt = -(-n // TILE)
            if nt > MAX_TILES:
                raise ValueError(f"banded body: a {n}-sample window needs {nt} tiles "
                                 f"(at most {MAX_TILES})")
            # the dense hi and lo matrices, 4 zero columns before and 12 after
            dense = [np.zeros((nt * TILE, n + 16), np.float32) for _ in range(2)]
            for d, part in zip(dense, pass_matrix(n, name, inverse).dense()):
                d[:n, 4:4 + n] = part.numpy()
            for m in range(nt):
                rows = slice(m * TILE, (m + 1) * TILE)
                hi, lo = (d[rows, m * TILE: m * TILE + 16] for d in dense)
                if any(np.count_nonzero(d[rows]) != np.count_nonzero(w)
                       for d, w in zip(dense, (hi, lo))):
                    raise ValueError(f"banded body: the band of a {n}-sample pass "
                                     f"leaves tile {m}'s 16-sample window")
                frags.append(_tile_fragments(hi, lo, cols))
            bm = mats.m[i]
            bm.n, bm.ntiles, bm.off = n, nt, off
            off += nt
        buf = torch.from_numpy(np.stack(frags)).to(torch.bfloat16).to(device)
        mats.frags, mats.tiles = buf.data_ptr(), off
        _kernel_cache[key] = (mats, buf)  # buf keeps the fragments alive
    return _kernel_cache[key][0]
