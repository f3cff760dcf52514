"""Gabor / time-frequency analysis: STFT, complex-Morlet CWT, S-transform.

The port of ``libdwt_tpu.ops.gabor``, libdwt's ``gabor.c``:
  * Gabor atom/function/wavelet and freq<->scale maps (:8-70);
  * per-bin complex kernel generation with the 4-sigma Gaussian window
    rule (gaussian_size/center, :70-93; gabor_gen_kernel :275-292;
    s_gen_kernel :330-360);
  * the TF plane routines gabor_ft_s (:531), gabor_wt_s (:632),
    gabor_st_s (:702) and their _arg_ (phase) variants, with the plane
    row order low-frequency-at-bottom (row bins-1-y);
  * phase_derivative_s (:874) and the three ridge detectors (:911,955,1111);
  * the chirp test-signal generator test_signal (:390).

The per-bin loop of complex dot products (cdot1_s, :105-160, a
zero-truncated centred correlation) is ONE ``conv1d`` of the zero-padded
signal with the real and imaginary kernel banks stacked as 2*bins output
channels: the ragged per-bin kernels are zero-padded into a
common-centre (bins, K) bank, and zero taps contribute nothing, so the
truncated overlap sum comes out exactly.  On the card the convolution
runs with TF32 off, so the planes keep float32 accuracy.

The kernels and test signals are made on the host in float64 (numpy);
the planes, phases and ridges are computed on the device of the input:
a tensor stays on its own device, anything else goes to ``device``
(default: the card; without CUDA that raises, pass ``device='cpu'``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from libdwt_torch.utils.device import as_tensor

__all__ = [
    "gabor_atom",
    "gabor_function",
    "gabor_wavelet",
    "gabor_freq",
    "gabor_scale",
    "gaussian_size",
    "gaussian_center",
    "gabor_ft",
    "gabor_wt",
    "gabor_st",
    "phase_derivative",
    "detect_ridges1",
    "detect_ridges2",
    "detect_ridges3",
    "strongest_ridges",
    "diff_points",
    "test_signal",
]

_TWO_PI = 2.0 * math.pi
#: the divisions by 2*pi below are products with the reciprocal: the
#: reference's ``x / (2*pi)`` compiles to that product under ``jax.jit``
#: (and a Python divisor on a CUDA tensor takes it too), so the port gives
#: the same bits on every device
_INV_TWO_PI = 1.0 / _TWO_PI


# ------------------------------------------------------------------ atoms


def gabor_atom(t, alpha: float, omega: float):
    """sqrt(alpha/pi) * exp(-alpha t^2) * exp(+i omega t) (gabor.c:8-21)."""
    t = np.asarray(t, np.float64)
    return (
        math.sqrt(alpha / math.pi)
        * np.exp(-alpha * t * t)
        * np.exp(1j * omega * t)
    )


def gabor_function(t, sigma: float, f: float):
    return gabor_atom(t, 1.0 / (2.0 * sigma * sigma), f)


def gabor_wavelet(t, sigma: float, f: float, a: float):
    """Scaled atom: (1/|a|) psi(t/a) (gabor.c:36-50)."""
    t = np.asarray(t, np.float64) / a
    return gabor_atom(t, 1.0 / (2.0 * sigma * sigma), f) / abs(a)


def gabor_freq(f: float, a: float) -> float:
    return f / a


def gabor_scale(f_c: float, f: float) -> float:
    return f_c / f


def gaussian_limit(sigma: float, a: float) -> float:
    return 4.0 * sigma * a  # the "3-sigma rule" with 4, as in gabor.c:70-76


def gaussian_size(sigma: float, a: float) -> int:
    return int(math.ceil(1.0 + 2.0 * gaussian_limit(sigma, a)))


def gaussian_center(sigma: float, a: float) -> int:
    return gaussian_size(sigma, a) // 2


# ----------------------------------------------------------- kernel banks


def _bank(kernels) -> Tuple[np.ndarray, int]:
    """Pack ragged (taps, center) kernels into a common-center bank."""
    left = max(c for _, c in kernels)
    right = max(len(t) - c for t, c in kernels)
    k = left + right
    bank = np.zeros((len(kernels), k), np.complex128)
    for b, (taps, c) in enumerate(kernels):
        bank[b, left - c : left - c + len(taps)] = taps
    return bank, left


def _tf_plane(sig: torch.Tensor, bank: np.ndarray, center: int):
    """Real and imaginary parts of the conjugate correlation responses for
    every bin, in one conv1d.

    out[..., b, i] = sum_j sig_zeropad[..., i + j - center] * conj(bank[b, j])
    (the cdot1_s overlap sum, gabor.c:105-160, with out-of-range terms
    contributing zero); batched over leading axes.  The imaginary part is
    ``0 - im``, the reference's ``re - 1j*im``, so that a zero ``im``
    gives +0 (the phase's sign where the real part is negative).
    """
    lead = sig.shape[:-1]
    n = sig.shape[-1]
    bins, k = bank.shape
    flat = sig.reshape((-1, 1, n))
    xp = nnf.pad(flat, (center, k - 1 - center))
    kern = torch.as_tensor(np.concatenate([np.real(bank), np.imag(bank)]),
                           dtype=sig.dtype, device=sig.device)[:, None, :]
    with torch.backends.cudnn.flags(enabled=True,
                                    benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn.deterministic,
                                    allow_tf32=False):
        out = nnf.conv1d(xp, kern)[:, :, :n]
    re, im = out[:, :bins], 0.0 - out[:, bins:]
    return re.reshape(lead + re.shape[1:]), im.reshape(lead + im.shape[1:])


def _plane_rows(resp, out: str) -> torch.Tensor:
    """Magnitude or phase, with the reference's bottom-up row order."""
    re, im = resp
    vals = torch.complex(re, im).abs() if out == "mag" else torch.atan2(im, re)
    return vals.flip(-2).to(torch.float32)


def gabor_ft(sig, bins: int, sigma: float, out: str = "mag",
             device=None) -> torch.Tensor:
    """Gabor transform (STFT) TF plane, (bins, N).

    Bin y uses freq = y/bins * pi at scale 1 (gabor_ft_s,
    gabor.c:531-580); row bins-1-y of the plane.
    ``out``: 'mag' (timefreq_line) or 'arg' (timefreq_arg_line).
    """
    kernels = []
    for y in range(bins):
        freq = y / bins * math.pi
        size = gaussian_size(sigma, 1.0)
        c = gaussian_center(sigma, 1.0)
        kernels.append((gabor_wavelet(np.arange(size) - c, sigma, freq, 1.0), c))
    bank, center = _bank(kernels)
    return _plane_rows(_tf_plane(as_tensor(sig, device), bank, center), out)


def gabor_wt(sig, bins: int, sigma: float, freq: float, out: str = "mag",
             device=None) -> torch.Tensor:
    """Complex-Morlet CWT TF plane (gabor_wt_s, gabor.c:632-700): bin y
    analyses f = (y+1)/bins*pi via scale a = freq/f of the mother wavelet."""
    kernels = []
    for y in range(bins):
        f = (y + 1) / bins * math.pi
        a = gabor_scale(freq, f)
        size = gaussian_size(sigma, a)
        c = gaussian_center(sigma, a)
        kernels.append((gabor_wavelet(np.arange(size) - c, sigma, freq, a), c))
    bank, center = _bank(kernels)
    return _plane_rows(_tf_plane(as_tensor(sig, device), bank, center), out)


def s_sigma(f: float) -> float:
    return math.sqrt(1.0 / (2.0 * f * f))


def gabor_st(sig, bins: int, out: str = "mag", device=None) -> torch.Tensor:
    """Stockwell (S-)transform plane (gabor_st_s, gabor.c:702-760): bin y
    analyses f = (y+1)/bins*0.5 cycles/sample with the frequency-dependent
    Gaussian alpha = f^2."""
    kernels = []
    for y in range(bins):
        f = (y + 1) / bins * 0.5
        alpha = f * f
        sigma = s_sigma(f)
        omega = 2.0 * math.pi * f
        size = gaussian_size(sigma, 1.0)
        c = gaussian_center(sigma, 1.0)
        kernels.append((gabor_atom(np.arange(size) - c, alpha, omega), c))
    bank, center = _bank(kernels)
    return _plane_rows(_tf_plane(as_tensor(sig, device), bank, center), out)


# -------------------------------------------------------- phase and ridges


def phase_derivative(angle, limit: float = math.pi, device=None) -> torch.Tensor:
    """Wrapped finite difference of phase along x, column 0 = 0
    (phase_derivative_s, gabor.c:874-909)."""
    angle = as_tensor(angle, device)
    d = angle[..., 1:] - angle[..., :-1]
    d = d - _TWO_PI * torch.ceil((d - limit) * _INV_TWO_PI).clamp(min=0)
    d = d + _TWO_PI * torch.ceil((-d - limit) * _INV_TWO_PI).clamp(min=0)
    return torch.cat([torch.zeros_like(angle[..., :1]), d], dim=-1)


def detect_ridges1(magnitude, threshold: float = 0.0, device=None) -> torch.Tensor:
    """Horizontal local-maximum ridge detector (detect_ridges1_s,
    gabor.c:911-953): ridge where -(m[x-1]-m[x])*(m[x]-m[x+1]) > 0 and
    m > threshold; output value m/(2*pi)."""
    m = as_tensor(magnitude, device)
    left = m[..., :-2]
    mid = m[..., 1:-1]
    right = m[..., 2:]
    factor = -(left - mid) * (mid - right)
    hit = (factor > 0) & (mid > threshold)
    core = torch.where(hit, mid * _INV_TWO_PI, torch.zeros_like(mid))
    zero = torch.zeros_like(m[..., :1])
    return torch.cat([zero, core, zero], dim=-1)


def detect_ridges2(inst_freq, threshold: float = 0.0, device=None) -> torch.Tensor:
    """Instantaneous-frequency sign detector (detect_ridges2_s,
    gabor.c:955-990): ridge where the phase derivative is negative with
    |.| > threshold; value |d|/(2*pi)."""
    d = as_tensor(inst_freq, device)
    hit = (d < 0) & (d.abs() > threshold)
    out = torch.where(hit, d.abs() * _INV_TWO_PI, torch.zeros_like(d))
    out[..., 0] = 0.0
    out[..., -1] = 0.0
    return out


def detect_ridges3(magnitude, threshold: float = 0.0, device=None) -> torch.Tensor:
    """Gradient-direction local-maximum detector (detect_ridges3_s,
    gabor.c:1111-1160): at each interior pixel, step one pixel in the
    quantized gradient direction; ridge where the value is >= that
    neighbour and > threshold."""
    m = as_tensor(magnitude, device)
    dx = (torch.roll(m, -1, -1) - torch.roll(m, 1, -1)) / 2.0
    dy = (torch.roll(m, -1, -2) - torch.roll(m, 1, -2)) / 2.0
    angle = torch.atan2(dy, dx)
    dirx = torch.cos(angle)
    diry = torch.sin(angle)
    nx = torch.where(dirx < -0.5, -1, torch.where(dirx > 0.5, 1, 0))
    ny = torch.where(diry < -0.5, -1, torch.where(diry > 0.5, 1, 0))
    h, w = m.shape[-2], m.shape[-1]
    yy = torch.arange(h, device=m.device)[:, None].expand(m.shape)
    xx = torch.arange(w, device=m.device)[None, :].expand(m.shape)
    ty = (yy + ny).clamp(0, h - 1)
    tx = (xx + nx).clamp(0, w - 1)
    # one gather on the flattened plane: two gathers along y then x would
    # sample ty at the wrong column for batched inputs
    flat = (ty * w + tx).reshape(m.shape[:-2] + (h * w,))
    nxt = torch.gather(m.reshape(m.shape[:-2] + (h * w,)), -1, flat).reshape(m.shape)
    hit = (m >= nxt) & (m > threshold)
    out = torch.where(hit, m * _INV_TWO_PI, torch.zeros_like(m))
    interior = (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)
    return torch.where(interior, out, torch.zeros_like(out))


# ------------------------------------------------------------ test signals


def test_signal(size: int, type: int = 0) -> np.ndarray:
    """Chirp/Gabor test signals (test_signal, gabor.c:390-529), types 0-3
    and 7-8.  Host float32."""
    i = np.arange(size, dtype=np.float64)
    t = i / size
    out = np.zeros(size, np.float64)
    if type == 0:
        f0 = 1.0 / 3.0 * (size - 1) / 2.0
        f1 = 2.0 / 3.0 * (size - 1) / 2.0
        out += np.where(i < 2 * size // 3, np.cos(t * 2 * math.pi * f0), 0.0)
        out += np.where(i > 1 * size // 3, np.cos(t * 2 * math.pi * f1), 0.0)
    elif type == 1:
        f0 = 1.0 / 3.0 * (size - 1) / 2.0
        f1 = 2.0 / 3.0 * (size - 1) / 2.0
        out = np.where(
            i < size // 2,
            np.cos(t * 2 * math.pi * f0),
            np.cos(t * 2 * math.pi * f1),
        )
    elif type == 2:
        f = (size - 1) / 2.0
        out = np.cos(0.5 * t * t * 2 * math.pi * f)
    elif type == 3:
        f = (size - 1) / 4.0
        omega = 2 * math.pi * f
        out = np.cos(0.5 * t * t * omega) + np.cos(0.5 * t * t * omega + 0.4 * t * omega)
    elif type == 7:
        center = size // 2
        # size/8 is C INTEGER division in gabor.c:498
        out = np.real(gabor_function(i - center, size // 8, 0.5))
    elif type == 8:
        c0, c1 = size // 4, 3 * size // 4
        out = np.real(gabor_function(i - c0, size // 16, 1.0)) + np.real(
            gabor_function(i - c1, size // 16, 2.0)
        )
    else:
        raise ValueError(f"unknown test signal type {type}")
    return out.astype(np.float32)


# -------------------------------------------------- blob/peak extraction


def strongest_ridges(plane, count: int, threshold: float = 0.0,
                     device=None) -> torch.Tensor:
    """Iteratively extract the ``count`` strongest ridge points of an
    S-transform magnitude plane (spectra_st_get_strongest_ridges,
    examples/spectra-blobs/spectra-experimental.c:120-180).

    Pipeline: ``detect_ridges1`` on the plane, then ``count`` rounds of
    global argmax (the first index on ties) -> record ``(x, y)`` -> damp
    the ridge image by ``1 - g`` where ``g`` is, per plane row, the S-atom
    Gaussian envelope of that row's analysis frequency
    (``sigma = s_sigma(f)``, 4-sigma integer support, unit center) placed
    at the peak column, the matched suppression of
    ``get_maximum``/``remove_ridge`` (spectra-experimental.c:27-118).
    The plane stores low frequencies at the bottom (:func:`gabor_st` row
    ``bins-1-y`` holds bin ``y``), so plane row ``r`` analyses
    ``f = (bins-r)/bins*0.5``, the same flip the reference applies by
    writing ``maxima`` at ``size_y-y-1`` (spectra-experimental.c:98-101).

    Returns a ``(count, 2)`` int32 tensor of ``(x, y)`` positions,
    strongest first, on the plane's device: ``count`` steps on the device,
    with no read back to the host between them.
    """
    plane = as_tensor(plane, device)
    if plane.ndim != 2:
        raise ValueError(f"expected a 2-D plane, got shape {tuple(plane.shape)}")
    bins, n = plane.shape
    dev = plane.device

    # per-row suppression geometry (numpy; rows are few)
    rows = np.arange(bins)
    f = (bins - rows) / bins * 0.5
    sig = np.sqrt(1.0 / (2.0 * f * f))
    size = np.ceil(1.0 + 2.0 * 4.0 * sig).astype(np.int64)
    center = size // 2
    inv_two_sig2 = torch.as_tensor((1.0 / (2.0 * sig * sig))[:, None],
                                   dtype=plane.dtype, device=dev)
    lo = torch.as_tensor((-center)[:, None], dtype=torch.int32, device=dev)
    hi = torch.as_tensor((size - 1 - center)[:, None], dtype=torch.int32, device=dev)

    ridges = detect_ridges1(plane, threshold)
    xx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    points = torch.zeros((count, 2), dtype=torch.int32, device=dev)
    for i in range(count):
        flat = torch.argmax(ridges)
        py = (flat // n).to(torch.int32)
        px = (flat % n).to(torch.int32)
        points[i, 0] = px
        points[i, 1] = py
        d = xx - px
        g = torch.exp(-(d.to(ridges.dtype) ** 2) * inv_two_sig2)
        inside = (d >= lo) & (d <= hi)
        ridges = ridges * (1.0 - torch.where(inside, g, torch.zeros_like(g)))
    return points


def diff_points(reference, tested, device=None) -> torch.Tensor:
    """Per-reference-point distance to the nearest tested point
    (spectra_diff_points,
    examples/spectra-blobs/spectra-experimental.c:182-215).  Both inputs
    are ``(k, 2)`` coordinate arrays; returns ``(k,)``."""
    ref = as_tensor(reference, device).to(torch.float32)
    tst = as_tensor(tested, ref.device).to(torch.float32)
    d2 = ((ref[:, None, :] - tst[None, :, :]) ** 2).sum(dim=-1)
    return torch.sqrt(d2.min(dim=1).values)
