"""libdwt_torch — the PyTorch / CUDA port of libdwt_tpu for NVIDIA Hopper.

Ported so far: the wavelet registry, subband geometry, the lifting engine,
the separable oracle (1/2/3-D, f32/f64/int32), the 2-D and 3-D API, the
fused 2-D levels and pyramid on hand-written CUDA kernels (single level,
two-level and deep forward and inverse), the streamed 2-D kernels
(``impl='streamed'``: single levels, two levels per streamed pass, or the
whole pyramid in one launch), the fused and streamed 3-D levels,
forward and inverse, and the sharded transforms on a device mesh
(:mod:`libdwt_torch.parallel`, with the halo push kernel); and the riders
in plain torch: Q-format fixed point (:mod:`libdwt_torch.utils.fix`), the
interleaved layout, strided convolution, the stationary transform (SWT),
non-separable lifting (NSLS), edge-avoiding wavelets (EAW), band features
and denoising (:mod:`libdwt_torch.ops.features`, whose ``denoise2`` runs
the dispatching pyramid) and the vector helpers
(:mod:`libdwt_torch.utils.vecops`).  Entry points run on the card unless
given a CPU tensor or ``device='cpu'``.

Top-level names follow ``libdwt_tpu``: ``wavedec2`` & co. are the
separable oracle, ``wavedec2_fast`` & co. the dispatching API
(:mod:`libdwt_torch.api`).
"""
from libdwt_torch.models.wavelets import (CDF53, CDF97, INTERP53, REGISTRY,
                                          Wavelet, get_wavelet)
from libdwt_torch.ops.separable import (dwt1, dwt2_level, dwt3_level, fdwt1,
                                        fdwt2, fdwt3, idwt1, idwt1_packed,
                                        idwt2, idwt2_level, idwt3, idwt3_level,
                                        wavedec1, wavedec2, wavedec3, waverec1,
                                        waverec2, waverec3)
from libdwt_torch.utils.subband import (band_rect, band_view, ceil_div_pow2,
                                        count_subbands, j_limit, level_sizes,
                                        resolve_j, zero_padding_f,
                                        zero_padding_i)
from libdwt_torch.api import get_impl, set_impl
from libdwt_torch.api import dwt2 as dwt2_level_fast, idwt2 as idwt2_level_fast
from libdwt_torch.api import wavedec2 as wavedec2_fast, waverec2 as waverec2_fast
from libdwt_torch.api import wavedec3 as wavedec3_fast, waverec3 as waverec3_fast
from libdwt_torch.interop import pyramid_from_numpy, pyramid_to_numpy
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops.fused import (KERNELS, fused_deep_wavedec2,
                                    fused_deep_waverec2, fused_dwt2_2level,
                                    fused_dwt2_level, fused_idwt2_2level,
                                    fused_idwt2_level, fused_supported,
                                    fused_wavedec2, fused_waverec2,
                                    reset_counters)
from libdwt_torch.ops.fused3d import fused_dwt3_level, fused_idwt3_level
from libdwt_torch.ops.eaw import eaw_wavedec2, eaw_waverec2
from libdwt_torch.ops.interleaved import fdwt2_interleaved, idwt2_interleaved
from libdwt_torch.ops.nsls import nsls_dwt2_level, nsls_idwt2_level
from libdwt_torch.ops.conv import convolve1, find_max_pos
from libdwt_torch.ops.swt import (analysis_filters, iswt1, iswt2, swt1, swt2,
                                  swt_level)

__version__ = "0.1.0"
