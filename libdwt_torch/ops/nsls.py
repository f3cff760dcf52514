"""Non-separable 2-D lifting (NSLS) transform variant (port of
``libdwt_tpu.ops.nsls``).

Each lifting stage is ONE 2-D stencil sweep instead of a row pass and a
column pass.  Merging the x- and y-application of a step with
coefficient c gives, on the interleaved layout,

  odd-odd  (both passes):  t += c*(left+right) + c*(up+down)
                               + c^2*(four diagonals)
  odd-even (x pass only):  t += c*(left+right)
  even-odd (y pass only):  t += c*(up+down)

(libdwt's NSLS cores: squared coefficients, and the merged scaling
zeta^2 / 1/zeta^2 per quadrant parity).  The result equals the separable
transform in exact arithmetic and differs only in float rounding.

Borders: whole-point mirror extension, built from indices so that any
size works; the inverse mirrors each band in the channel domain.
"""
from __future__ import annotations

from typing import Tuple

import torch

from libdwt_torch.models.wavelets import Wavelet, get_wavelet
from libdwt_torch.ops.fused import CH, _mirror_index
from libdwt_torch.utils.device import as_tensor

__all__ = ["nsls_dwt2_level", "nsls_idwt2_level"]

_PAD = 4  # enough mirror halo for up to 4 lifting stages


def _parity(n: int, odd: bool, device) -> torch.Tensor:
    return torch.arange(n, device=device) % 2 == (1 if odd else 0)


def _merged_step(t, c, target_odd: bool):
    """One non-separable stage on interleaved data (dims -2, -1).

    ``target_odd`` selects the lifting target parity: True for predict
    stages (odd samples / high channel), False for update stages.
    """
    c2 = c * c
    up, down = torch.roll(t, 1, -2), torch.roll(t, -1, -2)
    row = torch.roll(t, 1, -1) + torch.roll(t, -1, -1)
    col = up + down
    diag = (torch.roll(up, 1, -1) + torch.roll(up, -1, -1)
            + torch.roll(down, 1, -1) + torch.roll(down, -1, -1))
    ox = _parity(t.shape[-1], target_odd, t.device)[None, :]
    oy = _parity(t.shape[-2], target_odd, t.device)[:, None]
    out = torch.where(ox & oy, t + c * row + c * col + c2 * diag, t)
    out = torch.where(ox & ~oy, t + c * row, out)
    return torch.where(~ox & oy, t + c * col, out)


def _merged_scale(t, wavelet: Wavelet, inverse: bool):
    if wavelet.scale_s is None:
        return t
    if inverse:
        lo = wavelet.inv_scale_s if wavelet.inv_scale_s is not None else wavelet.scale_d
        hi = wavelet.inv_scale_d if wavelet.inv_scale_d is not None else wavelet.scale_s
    else:
        lo, hi = wavelet.scale_s, wavelet.scale_d

    def factor(n):
        f = torch.full((n,), hi, dtype=t.dtype, device=t.device)
        f[0::2] = lo
        return f

    return t * factor(t.shape[-2])[:, None] * factor(t.shape[-1])[None, :]


def _check(wavelet):
    if any(not st.is_symmetric for st in wavelet.steps):
        raise ValueError("NSLS needs symmetric lifting steps (CDF families)")


def nsls_dwt2_level(x, wavelet="cdf97", device=None) -> Tuple[torch.Tensor, ...]:
    """Single-level 2-D forward via non-separable merged stages
    -> (LL, HL, LH, HH); equals dwt2_level up to float rounding."""
    x = as_tensor(x, device)
    wavelet = get_wavelet(wavelet)
    _check(wavelet)
    h, w = x.shape[-2], x.shape[-1]
    # numpy's mode='reflect' for any pad width: the whole-point mirror
    ry = _mirror_index(torch.arange(-_PAD, h + _PAD + h % 2, device=x.device), h)
    rx = _mirror_index(torch.arange(-_PAD, w + _PAD + w % 2, device=x.device), w)
    u = x[..., ry, :][..., rx]
    for st in wavelet.steps:
        u = _merged_step(u, st.coeff, st.target == "d")
    u = _merged_scale(u, wavelet, inverse=False)
    he, we = h + h % 2, w + w % 2
    v = u[..., _PAD : _PAD + he, _PAD : _PAD + we]
    cy, cx = -(-h // 2), -(-w // 2)
    fy, fx = h // 2, w // 2
    return (v[..., 0::2, 0::2][..., :cy, :cx], v[..., 0::2, 1::2][..., :cy, :fx],
            v[..., 1::2, 0::2][..., :fy, :cx], v[..., 1::2, 1::2][..., :fy, :fx])


def _pad_channel_mirror(c, n: int, is_low: bool, axis: int):
    """Extend a polyphase channel with the channel-domain whole-point
    mirror (from x[-k]=x[k] and x[n-1+k]=x[n-1-k] with s[i]=x[2i],
    d[i]=x[2i+1]):

      top (any n):        s[-m] = s[m]          d[-m] = d[m-1]
      bottom (n even):    s[Ns+m] = s[Ns-1-m]   d[Nh+m] = d[Nh-2-m]
      bottom (n odd):     s[Ns+m] = s[Ns-2-m]   d[Nh+m] = d[Nh-1-m]

    Adds CH samples on top.  On the bottom the high channel of an odd
    length also receives its missing ceil-grid sample, so both channels
    leave with ceil(n/2) + 2*CH samples.
    """
    c = torch.movedim(c, axis, 0)
    odd = n % 2 == 1
    top = torch.flip(c[1 : CH + 1] if is_low else c[0:CH], dims=(0,))
    flip = torch.flip(c, dims=(0,))
    if is_low:
        start, count = (1 if odd else 0), CH
    else:
        start, count = (0 if odd else 1), CH + (1 if odd else 0)
    bot = flip[start : start + count]
    return torch.movedim(torch.cat([top, c, bot], dim=0), 0, axis)


def nsls_idwt2_level(ll, hl, lh, hh, wavelet="cdf97", device=None):
    """Inverse of :func:`nsls_dwt2_level` (merged stages reversed with
    negated coefficients; the diagonal term is (-c)^2 = c^2)."""
    ll, hl, lh, hh = (as_tensor(b, device) for b in (ll, hl, lh, hh))
    wavelet = get_wavelet(wavelet)
    _check(wavelet)
    cy, cx = ll.shape[-2], ll.shape[-1]
    fy, fx = hh.shape[-2], hh.shape[-1]
    h, w = cy + fy, cx + fx
    if min(cy, cx, fy, fx) <= CH:
        # the channel mirror slices up to row CH; a shorter band would
        # silently build a wrong halo
        raise ValueError(
            f"nsls inverse needs bands > {CH} samples per axis; "
            f"got LL {tuple(ll.shape[-2:])} / HH {tuple(hh.shape[-2:])}"
        )

    # the interleaved extended tile: mirror channels by CH, interleave,
    # then run the merged inverse stages
    def ext(band, low_y, low_x):
        b = _pad_channel_mirror(band, h, low_y, axis=band.ndim - 2)
        return _pad_channel_mirror(b, w, low_x, axis=band.ndim - 1)

    llp = ext(ll, True, True)
    ny, nx = llp.shape[-2], llp.shape[-1]
    t = llp.new_zeros(llp.shape[:-2] + (2 * ny, 2 * nx))
    t[..., 0::2, 0::2] = llp
    t[..., 0::2, 1::2] = ext(hl, True, False)
    t[..., 1::2, 0::2] = ext(lh, False, True)
    t[..., 1::2, 1::2] = ext(hh, False, False)

    t = _merged_scale(t, wavelet, inverse=True)
    for st in wavelet.steps[::-1]:
        t = _merged_step(t, -st.coeff, st.target == "d")
    off = 2 * CH
    return t[..., off : off + h, off : off + w]
