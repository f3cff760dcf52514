"""Image and volume abstractions with wavelet dispatch.

The port of ``libdwt_tpu.image``, libdwt's data abstractions:
  * image_t (``image.h:12-206``): create/load/save, subband views,
    coefficient access, fdwt/idwt dispatch over ``enum wavelet_t {CDF97,
    CDF53, INTERP53}`` (image.h:166-189), MSE comparison
    (examples/cores/image2.h:63-76);
  * volume_t (``volume.h:14-91``): 3-D create/fill/copy/compare/save.

``data`` is a torch tensor on an explicit device: the constructors and
loaders take ``device=`` (default: the card; without CUDA that raises,
pass ``device='cpu'`` to stay on the CPU), and every transform runs on
the device the data is on.  ``fdwt``/``idwt`` run the separable oracle,
``wavedec`` the dispatching API (:func:`libdwt_torch.api.wavedec2`, the
main path's kernels with ``impl='fused'``; :func:`~libdwt_torch.api.wavedec3`
for a volume).  Comparisons compute in float64 on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from libdwt_torch.api import wavedec2, wavedec3
from libdwt_torch.ops.separable import fdwt2, fdwt3, idwt2, idwt3
from libdwt_torch.utils import io as dio
from libdwt_torch.utils.device import as_tensor, resolve_device
from libdwt_torch.utils.subband import band_view, resolve_j
from libdwt_torch.utils.testimg import test_image as _test_pattern

__all__ = ["Image", "Volume", "conv_show"]


def _host(t, dtype=None) -> np.ndarray:
    """A tensor's values as a host numpy array (``dtype`` if given)."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a if dtype is None else a.astype(dtype, copy=False)


def _max_abs_diff(a, b) -> float:
    return float(np.abs(_host(a, np.float64) - _host(b, np.float64)).max())


@dataclasses.dataclass
class Image:
    """A 2-D image (or packed transform) with wavelet dispatch.

    The image_t replacement: ``data`` is a tensor (..., H, W); ``j``
    tracks the decomposition depth like image_fdwt_s leaves the transform
    in place (``image.h:166-189``).
    """

    data: torch.Tensor
    j: int = 0  # current decomposition depth (0 = spatial domain)

    # ------------------------------------------------------- construction

    @classmethod
    def create(cls, size_y: int, size_x: int, dtype=torch.float32,
               device=None) -> "Image":
        return cls(torch.zeros((size_y, size_x), dtype=dtype,
                               device=resolve_device(device)))

    @classmethod
    def load_pgm(cls, path: str, device=None) -> "Image":
        return cls(as_tensor(dio.load_pgm(path), device))

    @classmethod
    def load_mat(cls, path: str, device=None) -> "Image":
        return cls(as_tensor(dio.load_mat(path), device))

    @classmethod
    def load_exr(cls, path: str, device=None) -> "Image":
        """HDR float image through the EXR codec (the analogue of
        libdwt's examples/hdr/exr.h).  Single-channel files load as
        (H, W); multi-channel as (C, H, W) in R, G, B, A order, the
        (..., H, W) layout every transform method assumes."""
        img, _ = dio.read_exr(path)
        if img.shape[2] == 1:
            return cls(as_tensor(img[:, :, 0], device))
        return cls(as_tensor(np.ascontiguousarray(np.moveaxis(img, -1, 0)), device))

    @classmethod
    def test_pattern(cls, size_y: int, size_x: int, rand: int = 0,
                     dtype=np.float32, device=None) -> "Image":
        """dwt_util_test_image_fill_s analogue (libdwt.c:1338)."""
        return cls(as_tensor(_test_pattern(size_y, size_x, rand, dtype=dtype), device))

    # -------------------------------------------------------------- I/O

    def save_pgm(self, path: str, **kw) -> None:
        dio.save_pgm(path, _host(self.data), **kw)

    def save_mat(self, path: str) -> None:
        dio.save_mat(path, _host(self.data))

    def save_exr(self, path: str) -> None:
        dio.write_exr(path, _host(self.data, np.float32))

    # ------------------------------------------------------------ access

    @property
    def size_y(self) -> int:
        return self.data.shape[-2]

    @property
    def size_x(self) -> int:
        return self.data.shape[-1]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    def subband(self, j: int, band: str) -> torch.Tensor:
        """View one subband of the packed transform
        (dwt_util_subband, libdwt.c:20731)."""
        return band_view(self.data, j, band)

    # -------------------------------------------------------- transforms

    def fdwt(self, wavelet="cdf97", level: Optional[int] = None) -> "Image":
        """Forward in-place-style packed transform (image_fdwt_s)."""
        j = resolve_j(self.size_y, self.size_x, level)
        return Image(fdwt2(self.data, wavelet, j), j)

    def wavedec(self, wavelet="cdf97", level: Optional[int] = None,
                impl: Optional[str] = None):
        """Pytree MRA through the dispatching API (``api.wavedec2``: the
        fused kernels with ``impl='fused'``)."""
        return wavedec2(self.data, wavelet, level, impl=impl)

    def idwt(self, wavelet="cdf97", level: Optional[int] = None) -> "Image":
        """Inverse packed transform (image_idwt_s)."""
        j = self.j if level is None else level
        return Image(idwt2(self.data, wavelet, j), 0)

    # ------------------------------------------------------- comparisons

    def mse(self, other: "Image") -> float:
        """Mean squared error (image2 compare, examples/cores/image2.h:63)."""
        a = _host(self.data, np.float64)
        b = _host(other.data, np.float64)
        return float(((a - b) ** 2).mean())

    def psnr(self, other: "Image", peak: float = 1.0) -> float:
        m = self.mse(other)
        return float("inf") if m == 0 else 10.0 * np.log10(peak * peak / m)

    def compare(self, other: "Image", eps: float = 1.0e-3) -> bool:
        """dwt_util_compare_s predicate (max abs diff <= eps,
        libdwt.c:1593-1620)."""
        return _max_abs_diff(self.data, other.data) <= eps


@dataclasses.dataclass
class Volume:
    """A 3-D volume (the volume_t analogue, ``volume.h``)."""

    data: torch.Tensor
    j: int = 0

    @classmethod
    def create(cls, size_z: int, size_y: int, size_x: int, dtype=torch.float32,
               device=None):
        return cls(torch.zeros((size_z, size_y, size_x), dtype=dtype,
                               device=resolve_device(device)))

    @classmethod
    def fill_test(cls, size_z: int, size_y: int, size_x: int, dtype=np.float32,
                  device=None):
        """volume_fill_s test pattern (volume.c:41): each z-slice is the
        2-D test image with a per-slice triangle-wave rand parameter
        (z&11 folded at 11/2)."""
        slices = []
        for z in range(size_z):
            rand = z & 11
            if rand > 11 // 2:
                rand = 11 - rand
            slices.append(_test_pattern(size_y, size_x, rand, dtype=dtype))
        return cls(as_tensor(np.stack(slices), device))

    @property
    def shape(self):
        return tuple(self.data.shape)

    def fdwt(self, wavelet="cdf97", level: Optional[int] = None) -> "Volume":
        dims = self.data.shape[-3:]
        j = resolve_j(min(dims), min(dims), level)
        return Volume(fdwt3(self.data, wavelet, j), j)

    def wavedec(self, wavelet="cdf97", level: Optional[int] = None,
                impl: Optional[str] = None):
        """Pytree 3-D MRA through the dispatching API (``api.wavedec3``:
        on the card 'auto' takes the fused volume kernel wherever the
        level's geometry allows)."""
        return wavedec3(self.data, wavelet, level, impl=impl)

    def idwt(self, wavelet="cdf97", level: Optional[int] = None) -> "Volume":
        j = self.j if level is None else level
        return Volume(idwt3(self.data, wavelet, j), 0)

    def compare(self, other: "Volume", eps: float = 1.0e-3) -> bool:
        """volume_compare_s (volume.c:99)."""
        return _max_abs_diff(self.data, other.data) <= eps


def _show(t: torch.Tensor) -> torch.Tensor:
    """|coefficients| in float64 on ``t``'s device, globally normalized
    and gamma-compressed to [0, 1]."""
    a = t.detach().to(torch.float64).abs()
    mx = float(a.max()) if a.numel() else 0.0
    return (a / (mx or 1.0)) ** 0.4


def conv_show(a, j: int = 0) -> np.ndarray:
    """Convert a transform to a viewable [0,1] image: absolute values
    normalized globally with gamma 0.4, the simple form of
    dwt_util_conv_show_s (libdwt.c:21075) that wtshow-type display needs
    (cvdwt.cpp:46).  Returns host float64."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return _host(_show(t))
