"""Edge-avoiding wavelets (WCDF): data-dependent weighted lifting (port
of ``libdwt_tpu.ops.eaw``).

Per line and per level, prediction weights come from adjacent sample
differences,

    w[i] = 1 / (|x[i] - x[i+1]|^alpha + 1e-5)

and every lifting step becomes a weighted average,

    t[i] += 2*c * (wL*t[i-1] + wR*t[i+1]) / (wL + wR)

with libdwt's border rules (eaw-experimental.c).  The forward transform
returns the per-level weights, which the caller feeds back to the
inverse: they depend on the data and cannot be recomputed from the
coefficients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from libdwt_torch.models.wavelets import Wavelet, get_wavelet
from libdwt_torch.ops.lifting import _d_neighbors, _inv_scales, _s_neighbors, merge
from libdwt_torch.utils.device import as_tensor
from libdwt_torch.utils.subband import resolve_j

__all__ = [
    "eaw_weights",
    "eaw_lift_fwd",
    "eaw_lift_inv",
    "eaw_wavedec2",
    "eaw_waverec2",
]

EPS = 1.0e-5


def eaw_weights(x, alpha: float, device=None) -> torch.Tensor:
    """Adjacent-difference weights along the last axis, length N with the
    border patch w[N-1] := w[N-2]."""
    x = as_tensor(x, device)
    diff = torch.abs(x[..., :-1] - x[..., 1:])
    w = 1.0 / (diff ** alpha + EPS)
    return torch.cat([w, w[..., -1:]], dim=-1)


def _neighbors(s, d, w):
    """Mirrored value and weight neighbour channels: (l, r, wL, wR) of
    each odd target for d-steps, of each even target for s-steps."""
    nl, nh = s.shape[-1], d.shape[-1]
    we = w[..., 0::2]  # w at even i
    wo = w[..., 1::2]  # w at odd i

    # value channels: the mirror border rules of ops/lifting
    d_l, d_r = _d_neighbors(s, nh)
    s_l, s_r = _s_neighbors(d, nl)

    # d target i=2k+1: weights w[2k], w[2k+1]
    d_wl = we[..., :nh]
    d_wr = wo[..., :nh]
    # s target i=2k: weights w[2k-1], w[2k] (w[-1] := w[0]; wo/we[-1]
    # already carry the w[N-1] := w[N-2] patch)
    s_wl = torch.cat([we[..., :1], wo[..., : nl - 1]], dim=-1)
    s_wr = we[..., :nl]
    return (d_l, d_r, d_wl, d_wr), (s_l, s_r, s_wl, s_wr)


def _check_eaw_supported(wavelet: Wavelet) -> None:
    """The weighted step c*(wL*l + wR*r)/(wL + wR) is the weight-split of
    a SYMMETRIC step's 2c*(l+r)/2; asymmetric steps (haar, d4) have none
    (libdwt's EAW family is WCDF 5/3 / 9/7 only)."""
    if any(not st.is_symmetric for st in wavelet.steps):
        raise ValueError(
            f"edge-avoiding lifting needs symmetric steps; "
            f"'{wavelet.name}' is not supported (reference: WCDF 5/3, 9/7)"
        )


def _steps(s, d, w, wavelet: Wavelet, inverse: bool):
    steps = wavelet.steps[::-1] if inverse else wavelet.steps
    sgn = -1.0 if inverse else 1.0
    for st in steps:
        c = 2.0 * sgn * st.coeff
        (d_l, d_r, d_wl, d_wr), (s_l, s_r, s_wl, s_wr) = _neighbors(s, d, w)
        if st.target == "d":
            d = d + c * (d_wl * d_l + d_wr * d_r) / (d_wl + d_wr)
        else:
            s = s + c * (s_wl * s_l + s_wr * s_r) / (s_wl + s_wr)
    return s, d


def eaw_lift_fwd(x, wavelet="cdf97", alpha: float = 0.8, axis: int = -1,
                 weights=None, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward weighted 1-D lifting -> (low, high, weights)
    (dwt_eaw97_f_ex_stride_s semantics)."""
    wavelet = get_wavelet(wavelet)
    _check_eaw_supported(wavelet)
    x = torch.movedim(as_tensor(x, device), axis, -1)
    n = x.shape[-1]
    if n < 2:
        sc = wavelet.scale_s if wavelet.scale_s is not None else 1.0
        lo = torch.movedim(x * sc, -1, axis)
        return lo, torch.movedim(x[..., :0], -1, axis), torch.movedim(x * 0, -1, axis)
    w = (eaw_weights(x, alpha) if weights is None
         else torch.movedim(as_tensor(weights, x.device), axis, -1))
    s, d = _steps(x[..., 0::2], x[..., 1::2], w, wavelet, inverse=False)
    if wavelet.scale_s is not None:
        s = s * wavelet.scale_s
        d = d * wavelet.scale_d
    return (torch.movedim(s, -1, axis), torch.movedim(d, -1, axis),
            torch.movedim(w, -1, axis))


def eaw_lift_inv(low, high, weights, wavelet="cdf97", axis: int = -1,
                 device=None) -> torch.Tensor:
    """Inverse of :func:`eaw_lift_fwd` given the forward's weights
    (dwt_eaw97_i_ex_stride_s semantics)."""
    wavelet = get_wavelet(wavelet)
    _check_eaw_supported(wavelet)
    s = torch.movedim(as_tensor(low, device), axis, -1)
    d = torch.movedim(as_tensor(high, s.device), axis, -1)
    n = s.shape[-1] + d.shape[-1]
    inv_s, inv_d = _inv_scales(wavelet)
    if n < 2:
        sc = inv_s if inv_s is not None else 1.0
        return torch.movedim(s * sc, -1, axis)
    w = torch.movedim(as_tensor(weights, s.device), axis, -1)
    if wavelet.scale_s is not None:
        s = s * inv_s
        d = d * inv_d
    s, d = _steps(s, d, w, wavelet, inverse=True)
    return torch.movedim(merge(s, d, axis=-1), -1, axis)


# ------------------------------------------------------------ 2-D pyramids


def eaw_wavedec2(x, wavelet="cdf97", level: Optional[int] = None,
                 alpha: float = 0.8, device=None):
    """Multi-level 2-D EAW MRA -> (coeffs, weights).

    ``coeffs`` has the wavedec2 pytree layout; ``weights`` is a list
    (coarse first) of per-level (wH, wV) pairs: wH from the rows of the
    input at that level, wV from the columns of the row-transformed
    image (dwt_eaw97_2f_s's wH[]/wV[] convention).
    """
    x = as_tensor(x, device)
    j = resolve_j(x.shape[-2], x.shape[-1], level)
    coeffs = []
    wts = []
    ll = x
    for _ in range(j):
        lo, hi, wh = eaw_lift_fwd(ll, wavelet, alpha, axis=-1)
        row_t = torch.cat([lo, hi], dim=-1)
        wv = eaw_weights(row_t.transpose(-2, -1), alpha).transpose(-1, -2)
        cw = lo.shape[-1]
        ll2, lh2, _ = eaw_lift_fwd(lo, wavelet, alpha, axis=-2, weights=wv[..., :, :cw])
        hl2, hh2, _ = eaw_lift_fwd(hi, wavelet, alpha, axis=-2, weights=wv[..., :, cw:])
        coeffs.append((hl2, lh2, hh2))
        wts.append((wh, wv))
        ll = ll2
    return [ll] + coeffs[::-1], wts[::-1]


def eaw_waverec2(coeffs, weights, wavelet="cdf97", device=None):
    """Inverse of :func:`eaw_wavedec2` (dwt_eaw97_2i_s semantics)."""
    ll = as_tensor(coeffs[0], device)
    for (hl, lh, hh), (wh, wv) in zip(coeffs[1:], weights):
        hl, lh, hh, wh, wv = (as_tensor(a, ll.device) for a in (hl, lh, hh, wh, wv))
        cw = ll.shape[-1]
        lo = eaw_lift_inv(ll, lh, wv[..., :, :cw], wavelet, axis=-2)
        hi = eaw_lift_inv(hl, hh, wv[..., :, cw:], wavelet, axis=-2)
        ll = eaw_lift_inv(lo, hi, wh, wavelet, axis=-1)
    return ll
