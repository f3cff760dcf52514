"""Separable multi-level DWT/MRA transforms — the port's correctness
oracle and its ``impl='separable'`` (port of ``libdwt_tpu.ops.separable``).

Per level, a row pass (along x) then a column pass (along y) over the
top-left region of size ceil(n / 2**j), libdwt's ``dwt_cdf97_2f_s``
order.  Two coefficient layouts:
  * packed — one tensor, L|H halves per level (fdwt*/idwt* functions);
  * pytree — list of subband tensors (wavedec*/waverec*).
Works on any device, in float32, float64 and int32.
"""
from __future__ import annotations

from typing import Optional

import torch

from libdwt_torch.ops.lifting import lift_fwd, lift_inv
from libdwt_torch.utils.subband import ceil_div_pow2, resolve_j

__all__ = [
    "dwt1", "idwt1", "dwt2_level", "idwt2_level", "dwt3_level", "idwt3_level",
    "wavedec1", "waverec1", "wavedec2", "waverec2", "wavedec3", "waverec3",
    "fdwt1", "idwt1_packed", "fdwt2", "idwt2", "fdwt3", "idwt3",
]


# ------------------------------------------------------------- single level

def dwt1(x, wavelet="cdf97", axis=-1):
    """Single-level 1-D forward transform -> (L, H)."""
    return lift_fwd(x, wavelet, axis=axis)


def idwt1(low, high, wavelet="cdf97", axis=-1, border="mirror"):
    """Single-level 1-D inverse transform ('mirror'/'hole'/'zero')."""
    return lift_inv(low, high, wavelet, axis=axis, border=border)


def dwt2_level(x, wavelet="cdf97"):
    """Single-level 2-D transform over the last two axes -> (LL, HL, LH, HH).
    Row pass (along x) then column pass (along y)."""
    l, h = lift_fwd(x, wavelet, axis=-1)
    ll, lh = lift_fwd(l, wavelet, axis=-2)
    hl, hh = lift_fwd(h, wavelet, axis=-2)
    return ll, hl, lh, hh


def idwt2_level(ll, hl, lh, hh, wavelet="cdf97", border="mirror"):
    """Inverse of :func:`dwt2_level`; ``border`` gives the sparse-
    reconstruction variants ('hole', 'zero')."""
    l = lift_inv(ll, lh, wavelet, axis=-2, border=border)
    h = lift_inv(hl, hh, wavelet, axis=-2, border=border)
    return lift_inv(l, h, wavelet, axis=-1, border=border)


def dwt3_level(x, wavelet="cdf97"):
    """Single-level 3-D transform over the last three axes -> dict keyed
    by subband name in (z, y, x) order ('LLL', 'LLH', ..., 'HHH').
    Axis order: x, then y, then z."""
    bands = {"": x}
    for axis in (-1, -2, -3):
        new = {}
        for name, arr in bands.items():
            lo, hi = lift_fwd(arr, wavelet, axis=axis)
            new["L" + name] = lo
            new["H" + name] = hi
        bands = new
    return bands


def idwt3_level(bands, wavelet="cdf97", border="mirror"):
    """Inverse of :func:`dwt3_level`."""
    for axis in (-3, -2, -1):
        new = {}
        for name in sorted({n[1:] for n in bands}):
            new[name] = lift_inv(bands["L" + name], bands["H" + name],
                                 wavelet, axis=axis, border=border)
        bands = new
    return bands[""]


# --------------------------------------------------------------- pytree MRA

def wavedec1(x, wavelet="cdf97", level: Optional[int] = None, axis=-1):
    """Multi-level 1-D MRA -> [L_J, H_J, ..., H_1]."""
    n = x.shape[axis]
    j = resolve_j(n, n, level)
    coeffs = []
    low = x
    for _ in range(j):
        low, high = lift_fwd(low, wavelet, axis=axis)
        coeffs.append(high)
    return [low] + coeffs[::-1]


def waverec1(coeffs, wavelet="cdf97", axis=-1):
    low = coeffs[0]
    for high in coeffs[1:]:
        low = lift_inv(low, high, wavelet, axis=axis)
    return low


def wavedec2(x, wavelet="cdf97", level: Optional[int] = None):
    """Multi-level 2-D MRA -> [LL_J, (HL_J, LH_J, HH_J), ..., (HL_1, LH_1, HH_1)]."""
    j = resolve_j(x.shape[-2], x.shape[-1], level)
    coeffs = []
    ll = x
    for _ in range(j):
        ll, hl, lh, hh = dwt2_level(ll, wavelet)
        coeffs.append((hl, lh, hh))
    return [ll] + coeffs[::-1]


def waverec2(coeffs, wavelet="cdf97", border="mirror"):
    ll = coeffs[0]
    for hl, lh, hh in coeffs[1:]:
        ll = idwt2_level(ll, hl, lh, hh, wavelet, border=border)
    return ll


def wavedec3(x, wavelet="cdf97", level: Optional[int] = None):
    """Multi-level 3-D MRA -> [LLL_J, bands_J, ..., bands_1]; bands_j is
    the dict of the 7 detail subbands at level j."""
    dims = x.shape[-3:]
    j = resolve_j(min(dims), min(dims), level)
    coeffs = []
    low = x
    for _ in range(j):
        bands = dwt3_level(low, wavelet)
        low = bands.pop("LLL")
        coeffs.append(bands)
    return [low] + coeffs[::-1]


def waverec3(coeffs, wavelet="cdf97", border="mirror"):
    low = coeffs[0]
    for bands in coeffs[1:]:
        full = dict(bands)
        full["LLL"] = low
        low = idwt3_level(full, wavelet, border=border)
    return low


# --------------------------------------------------------------- packed MRA

def _pack2(ll, hl, lh, hh):
    top = torch.cat([ll, hl], dim=-1)
    bot = torch.cat([lh, hh], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _unpack2(a, n_y, n_x):
    cy, cx = -(-n_y // 2), -(-n_x // 2)
    return (a[..., :cy, :cx], a[..., :cy, cx:n_x],
            a[..., cy:n_y, :cx], a[..., cy:n_y, cx:n_x])


def fdwt1(x, wavelet="cdf97", level: Optional[int] = None, axis=-1):
    """Multi-level packed 1-D forward transform (L|H halves in one tensor)."""
    y = torch.movedim(x, axis, -1).clone()
    n = y.shape[-1]
    for lvl in range(resolve_j(n, n, level)):
        nj = ceil_div_pow2(n, lvl)
        lo, hi = lift_fwd(y[..., :nj], wavelet, axis=-1)
        y[..., :nj] = torch.cat([lo, hi], dim=-1)
    return torch.movedim(y, -1, axis)


def idwt1_packed(y, wavelet="cdf97", level: Optional[int] = None, axis=-1,
                 border="mirror"):
    x = torch.movedim(y, axis, -1).clone()
    n = x.shape[-1]
    for lvl in range(resolve_j(n, n, level) - 1, -1, -1):
        nj = ceil_div_pow2(n, lvl)
        c = -(-nj // 2)
        x[..., :nj] = lift_inv(x[..., :c], x[..., c:nj], wavelet, axis=-1,
                               border=border)
    return torch.movedim(x, -1, axis)


def fdwt2(x, wavelet="cdf97", level: Optional[int] = None):
    """Multi-level packed 2-D forward transform (``dwt_cdf97_2f_s``
    semantics with the L|H halved layout)."""
    h, w = x.shape[-2], x.shape[-1]
    y = x.clone()
    for lvl in range(resolve_j(h, w, level)):
        hj, wj = ceil_div_pow2(h, lvl), ceil_div_pow2(w, lvl)
        y[..., :hj, :wj] = _pack2(*dwt2_level(y[..., :hj, :wj], wavelet))
    return y


def idwt2(y, wavelet="cdf97", level: Optional[int] = None, border="mirror"):
    """Inverse of :func:`fdwt2` (``dwt_cdf97_2i_s``)."""
    h, w = y.shape[-2], y.shape[-1]
    x = y.clone()
    for lvl in range(resolve_j(h, w, level) - 1, -1, -1):
        hj, wj = ceil_div_pow2(h, lvl), ceil_div_pow2(w, lvl)
        bands = _unpack2(x[..., :hj, :wj], hj, wj)
        x[..., :hj, :wj] = idwt2_level(*bands, wavelet, border=border)
    return x


def fdwt3(x, wavelet="cdf97", level: Optional[int] = None):
    """Multi-level packed 3-D forward transform over the last three axes."""
    dz, dy, dx = x.shape[-3:]
    j = resolve_j(min(dz, dy, dx), min(dz, dy, dx), level)
    y = x.clone()
    for lvl in range(j):
        sz = [ceil_div_pow2(d, lvl) for d in (dz, dy, dx)]
        bands = dwt3_level(y[..., : sz[0], : sz[1], : sz[2]], wavelet)
        # pack along x, then y, then z (names are in (z, y, x) order)
        xp = {zy: torch.cat([bands[zy + "L"], bands[zy + "H"]], dim=-1)
              for zy in ("LL", "LH", "HL", "HH")}
        yp = {z: torch.cat([xp[z + "L"], xp[z + "H"]], dim=-2) for z in ("L", "H")}
        y[..., : sz[0], : sz[1], : sz[2]] = torch.cat([yp["L"], yp["H"]], dim=-3)
    return y


def idwt3(yv, wavelet="cdf97", level: Optional[int] = None, border="mirror"):
    """Inverse of :func:`fdwt3`."""
    dz, dy, dx = yv.shape[-3:]
    j = resolve_j(min(dz, dy, dx), min(dz, dy, dx), level)
    x = yv.clone()
    for lvl in range(j - 1, -1, -1):
        sz = [ceil_div_pow2(d, lvl) for d in (dz, dy, dx)]
        cz, cy, cx = (-(-s // 2) for s in sz)
        region = x[..., : sz[0], : sz[1], : sz[2]]
        bands = {}
        for iz, zn in ((slice(0, cz), "L"), (slice(cz, sz[0]), "H")):
            for iy, yn in ((slice(0, cy), "L"), (slice(cy, sz[1]), "H")):
                for ix, xn in ((slice(0, cx), "L"), (slice(cx, sz[2]), "H")):
                    bands[zn + yn + xn] = region[..., iz, iy, ix]
        x[..., : sz[0], : sz[1], : sz[2]] = idwt3_level(bands, wavelet, border=border)
    return x
