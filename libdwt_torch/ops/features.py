"""Per-subband feature extraction and denoising thresholds (port of
``libdwt_tpu.ops.features``).

  * the per-band aggregates of libdwt's dwt_util_band_*_s;
  * the whole-transform vector forms, iterating HL, LH, HH per level
    j = 1..j_max-1;
  * the universal (BayesShrink-style) threshold of libdwt's denoise.c,
    and ``denoise2``, which runs the dispatching API's pyramid
    (``impl='fused'`` on a CUDA tensor: the hand-written kernels B2, B3,
    B6 and B5, once each).

Everything works on the packed-layout 2-D transform through
utils.subband.band_view, batched over leading axes.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from libdwt_torch import api
from libdwt_torch.utils.device import as_tensor
from libdwt_torch.utils.subband import band_rect, band_view

__all__ = [
    "band_wps",
    "band_med",
    "band_maxidx",
    "band_mean",
    "band_moment",
    "band_cmoment",
    "band_var",
    "band_stdev",
    "band_smoment",
    "band_skew",
    "band_kurt",
    "band_maxnorm",
    "band_lpnorm",
    "band_norm",
    "features",
    "FEATURES",
    "estimate_threshold",
    "soft_threshold",
    "hard_threshold",
    "denoise2",
]


# ----------------------------------------------------------- band features


def band_wps(a, j: int = 0):
    """Rectified wavelet power spectrum: sum(c^2) / 2^j."""
    return torch.sum(a * a, dim=(-2, -1)) / (1 << j)


def band_med(a):
    """Median with libdwt's convention sorted[size//2] (``torch.median``
    takes sorted[(size-1)//2], which differs for every even size)."""
    flat = a.reshape(a.shape[:-2] + (-1,))
    return torch.sort(flat, dim=-1).values[..., flat.shape[-1] // 2]


def band_maxidx(a):
    """Raster index of the first maximum magnitude, in the band's dtype."""
    flat = torch.abs(a).reshape(a.shape[:-2] + (-1,))
    return torch.argmax(flat, dim=-1).to(a.dtype)


def band_mean(a):
    return torch.mean(a, dim=(-2, -1))


def band_moment(a, n: int, center=0.0):
    """n-th moment about ``center``."""
    return torch.mean((a - center) ** n, dim=(-2, -1))


def band_cmoment(a, n: int):
    return band_moment(a, n, band_mean(a)[..., None, None])


def band_var(a):
    return band_cmoment(a, 2)


def band_stdev(a):
    return torch.sqrt(band_var(a))


def band_smoment(a, n: int):
    return band_cmoment(a, n) / band_stdev(a) ** n


def band_skew(a):
    return band_smoment(a, 3)


def band_kurt(a):
    """Excess kurtosis."""
    return band_smoment(a, 4) - 3.0


def band_maxnorm(a):
    return torch.amax(torch.abs(a), dim=(-2, -1))


def band_lpnorm(a, p: float):
    """libdwt's lp norm: sum(|c|^p)^(1/p) without dividing by the size,
    and p=inf -> maxnorm."""
    if math.isinf(p):
        return band_maxnorm(a)
    s = torch.sum(torch.abs(a) ** p, dim=(-2, -1))
    return s ** (1.0 / p)


def band_norm(a):
    return band_lpnorm(a, 2.0)


#: name -> callable(band) for the vector forms
FEATURES: Dict[str, Callable] = {
    "wps": band_wps,  # called with j via features()
    "maxidx": band_maxidx,
    "mean": band_mean,
    "med": band_med,
    "var": band_var,
    "stdev": band_stdev,
    "skew": band_skew,
    "kurt": band_kurt,
    "maxnorm": band_maxnorm,
    "lpnorm": lambda a: band_lpnorm(a, 0.5),
    "norm": band_norm,
}


def features(a, j_max: int, which: str = "wps", device=None):
    """Whole-transform feature vector over the detail subbands of a
    packed-layout transform ``a`` (2-D, optionally batched): j = 1 ..
    j_max-1 over (HL, LH, HH), skipping empty bands, as libdwt's vector
    forms do."""
    a = as_tensor(a, device)
    fn = FEATURES[which]
    out: List[torch.Tensor] = []
    h, w = a.shape[-2], a.shape[-1]
    for j in range(1, j_max):
        for band in ("HL", "LH", "HH"):
            ry, rx = band_rect(h, w, j, band)
            if ry.stop - ry.start and rx.stop - rx.start:
                v = a[..., ry, rx]
                out.append(fn(v, j) if which == "wps" else fn(v))
    if not out:  # j_max <= 1 or all bands empty: no features, as libdwt's loops
        return a.new_zeros(a.shape[:-2] + (0,))
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------- denoise


def _universal(med, h: int, w: int, dtype):
    """sigma * sqrt(2 log N) with sigma = median(|HH1|) / 0.6745."""
    n = torch.tensor(float(h * w), dtype=dtype, device=med.device)
    return med / 0.6745 * torch.sqrt(2.0 * torch.log(n))


def estimate_threshold(a, device=None):
    """Universal threshold from the level-1 HH band of a packed transform:
    sigma = median(|HH1|)/0.6745, lambda = sigma*sqrt(2*log(N))."""
    a = as_tensor(a, device)
    h, w = a.shape[-2], a.shape[-1]
    return _universal(band_med(torch.abs(band_view(a, 1, "HH"))), h, w, a.dtype)


def soft_threshold(a, lam, device=None):
    a = as_tensor(a, device)
    return torch.sign(a) * torch.clamp_min(torch.abs(a) - lam, 0)


def hard_threshold(a, lam, device=None):
    a = as_tensor(a, device)
    return torch.where(torch.abs(a) > lam, a, torch.zeros_like(a))


def denoise2(x, wavelet="cdf97", level: Optional[int] = None, mode: str = "soft",
             impl: Optional[str] = None, device=None):
    """Denoise a 2-D image: transform, threshold the detail bands with the
    universal threshold, inverse transform (libdwt's denoise path)."""
    x = as_tensor(x, device)
    coeffs = api.wavedec2(x, wavelet, level, impl=impl)
    # the universal threshold needs only |HH1|, which the pyramid already
    # holds (coeffs[-1][2]): no second level-1 transform
    h, w = x.shape[-2], x.shape[-1]
    lam = _universal(band_med(torch.abs(coeffs[-1][2])), h, w, x.dtype)
    thr = soft_threshold if mode == "soft" else hard_threshold
    shrunk = [coeffs[0]] + [tuple(thr(b, lam) for b in lvl) for lvl in coeffs[1:]]
    return api.waverec2(shrunk, wavelet, impl=impl)
