"""Wavelet registry (a copy of the JAX package's, kept import-free so the
  port never imports it): lifting-scheme descriptions of every family.

A wavelet is described as a sequence of *lifting steps* applied to the
even/odd polyphase components (s = even samples -> lowpass channel,
d = odd samples -> highpass channel), plus an optional final scaling pair.

Float steps compute ``target += coeff * (left + right)`` where (left, right)
are the two mirrored neighbours from the opposite channel (whole-point
symmetric extension at the borders).

Integer (reversible) steps compute ``target +/-= (w*(left+right) + k) >> shift``
with C-style arithmetic shift, which round-trips bit-exactly.

Reference semantics (constants and step order):
  libdwt src/inline.h:304-342          (CDF 9/7 + CDF 5/3 float constants)
  libdwt src/libdwt.c:2024-2133        (float lifting step structure)
  libdwt src/libdwt.c:10901-10997      (integer 9/7-F and 5/3 steps)
  libdwt src/libdwt.c:11252-11292      (interpolating 5/3, predict-only)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FloatLiftStep:
    """One float lifting step.

    Symmetric form (left/right None): ``target += coeff * (l + r)`` —
    the CDF family shape, kept as one fused expression to match the
    reference's float rounding.

    Asymmetric form: ``target += left*l + right*r`` — needed for
    Haar/D4-style factorizations (e.g.
    libdwt examples/cores/cores-d4.c:36-49 where U1 uses
    beta*l + gamma*r).  For a 'd' target the neighbours are (s[k],
    s[k+1]); for an 's' target they are (d[k-1], d[k]).
    """

    target: str  # 'd' (predict, updates odd/high channel) or 's' (update, even/low)
    coeff: float = 0.0
    left: Optional[float] = None
    right: Optional[float] = None

    @property
    def is_symmetric(self) -> bool:
        return self.left is None and self.right is None


@dataclasses.dataclass(frozen=True)
class IntLiftStep:
    """One reversible integer lifting step.

    ``target = target + sign * ((wl*left + wr*right + k) >> shift)``

    with arithmetic (sign-propagating) right shift.  The symmetric CDF
    steps have wl == wr == w, matching the C expressions in the
    reference, e.g. ``tmp[i] -= (+203*(l+r) - (1<<6)) >> 7``
    (libdwt src/libdwt.c:10920).  One-sided steps (wl or wr
    zero) cover the Haar S-transform
    (libdwt examples/cores/cores-haar.c:10-31).
    """

    target: str  # 'd' or 's'
    sign: int  # +1 or -1
    w: int = 0  # symmetric weight; used for both sides when wl/wr unset
    k: int = 0
    shift: int = 0
    wl: Optional[int] = None
    wr: Optional[int] = None

    @property
    def weights(self) -> Tuple[int, int]:
        return (
            self.w if self.wl is None else self.wl,
            self.w if self.wr is None else self.wr,
        )


@dataclasses.dataclass(frozen=True)
class Wavelet:
    """A lifting-scheme wavelet description."""

    name: str
    # Float path.
    steps: Tuple[FloatLiftStep, ...] = ()
    # Final scaling: (low gets *= scale_s, high gets *= scale_d). None = no scaling.
    scale_s: Optional[float] = None
    scale_d: Optional[float] = None
    # Inverse scaling factors; default (None) means the CDF convention
    # scale_d/scale_s (valid because there scale_d == 1/scale_s).  D4's
    # zeta_e*zeta_o != 1 needs explicit values
    # (libdwt examples/cores/cores-d4.c:73-74).
    inv_scale_s: Optional[float] = None
    inv_scale_d: Optional[float] = None
    # Reversible integer path (None if the family has no integer variant).
    int_steps: Optional[Tuple[IntLiftStep, ...]] = None
    # Support of the equivalent analysis filters; determines the halo width
    # needed by tiled/sharded kernels (number of samples of one-sided overlap).
    support: int = 4

    @property
    def has_int(self) -> bool:
        return self.int_steps is not None

    @property
    def n_steps(self) -> int:
        return len(self.steps)


# --- CDF 9/7 -----------------------------------------------------------------
# Constants: Mallat 3rd ed. p. 370; reference libdwt src/inline.h:309-315.
CDF97_P1 = 1.58613434342059
CDF97_U1 = -0.0529801185729
CDF97_P2 = -0.8829110755309
CDF97_U2 = 0.4435068520439
CDF97_S1 = 1.1496043988602  # lowpass scale (zeta)
CDF97_S2 = 1.0 / CDF97_S1  # highpass scale

CDF97 = Wavelet(
    name="cdf97",
    steps=(
        FloatLiftStep("d", -CDF97_P1),
        FloatLiftStep("s", +CDF97_U1),
        FloatLiftStep("d", -CDF97_P2),
        FloatLiftStep("s", +CDF97_U2),
    ),
    scale_s=CDF97_S1,
    scale_d=CDF97_S2,
    # Reversible integer 9/7-F (Adams); reference libdwt src/libdwt.c:10918-10943.
    int_steps=(
        IntLiftStep("d", -1, +203, -(1 << 6), 7),
        IntLiftStep("s", +1, -217, +(1 << 11), 12),
        IntLiftStep("d", -1, -113, -(1 << 6), 7),
        IntLiftStep("s", +1, +1817, +(1 << 11), 12),
    ),
    support=4,
)

# --- CDF 5/3 -----------------------------------------------------------------
# Constants: reference libdwt src/inline.h:331-337.
CDF53_P1 = 0.5
CDF53_U1 = 0.25
CDF53_S1 = math.sqrt(2.0)
CDF53_S2 = 1.0 / math.sqrt(2.0)

CDF53 = Wavelet(
    name="cdf53",
    steps=(
        FloatLiftStep("d", -CDF53_P1),
        FloatLiftStep("s", +CDF53_U1),
    ),
    scale_s=CDF53_S1,
    scale_d=CDF53_S2,
    # Reversible integer 5/3 (JPEG2000); reference libdwt src/libdwt.c:10964-10981.
    #   d -= (l+r) >> 1 ; s += (l+r+2) >> 2
    int_steps=(
        IntLiftStep("d", -1, 1, 0, 1),
        IntLiftStep("s", +1, 1, 2, 2),
    ),
    support=2,
)

# --- Interpolating 5/3 (predict-only) ----------------------------------------
# Reference libdwt src/libdwt.c:11252-11292 (dwt_interp53_f_ex_stride_s):
# single predict step, no update, same scaling as CDF 5/3.
INTERP53 = Wavelet(
    name="interp53",
    steps=(FloatLiftStep("d", -CDF53_P1),),
    scale_s=CDF53_S1,
    scale_d=CDF53_S2,
    int_steps=None,
    support=1,
)

# --- Haar ---------------------------------------------------------------------
# Lifting factorization of unnormalized Haar, exactly the reference's
# core_fwd_haar_v2x1_f32 (libdwt examples/cores/cores-haar.c:10-31):
#   d -= s ; s += d/2 ; no scaling.
# Integer version is the classic reversible S-transform:
#   d -= s ; s += d >> 1 (floor), bit-exact round trip.  For a 'd'
# target the (left, right) neighbours are (s[k], s[k+1]), so "uses only
# s[k]" is the one-sided step wl=1, wr=0; for an 's' target they are
# (d[k-1], d[k]), so "uses d[k]" is wl=0, wr=1.
HAAR = Wavelet(
    name="haar",
    steps=(
        FloatLiftStep("d", left=-1.0, right=0.0),
        FloatLiftStep("s", left=0.0, right=0.5),
    ),
    int_steps=(
        IntLiftStep("d", -1, k=0, shift=0, wl=1, wr=0),
        IntLiftStep("s", +1, k=0, shift=1, wl=0, wr=1),
    ),
    support=1,
)

# --- Daubechies D4 ------------------------------------------------------------
# Lifting factorization from libdwt examples/cores/cores-d4.c:27-56:
#   P1: d += alpha * s_right
#   U1: s += beta * d_left + gamma * d_right
#   P2: d += delta * s_left
#   scale: s *= zeta_e, d *= zeta_o   (zeta_e * zeta_o = 1/3, so the
#   inverse multiplies by the explicit reciprocals, cores-d4.c:68-74).
_D4_SQRT3 = math.sqrt(3.0)
D4 = Wavelet(
    name="d4",
    steps=(
        FloatLiftStep("d", left=0.0, right=-1.0 / _D4_SQRT3),
        FloatLiftStep("s", left=(6.0 - 3.0 * _D4_SQRT3) / 4.0, right=_D4_SQRT3 / 4.0),
        FloatLiftStep("d", left=-1.0 / 3.0, right=0.0),
    ),
    scale_s=(3.0 + _D4_SQRT3) / (3.0 * math.sqrt(2.0)),
    scale_d=(3.0 - _D4_SQRT3) / (3.0 * math.sqrt(2.0)),
    inv_scale_s=(3.0 * math.sqrt(2.0)) / (3.0 + _D4_SQRT3),
    inv_scale_d=(3.0 * math.sqrt(2.0)) / (3.0 - _D4_SQRT3),
    support=3,
)

REGISTRY = {
    "cdf97": CDF97,
    "cdf53": CDF53,
    "interp53": INTERP53,
    "haar": HAAR,
    "d4": D4,
}


def get_wavelet(wavelet) -> Wavelet:
    """Resolve a wavelet spec (name or Wavelet) to a Wavelet."""
    if isinstance(wavelet, Wavelet):
        return wavelet
    try:
        return REGISTRY[str(wavelet).lower()]
    except KeyError:
        raise ValueError(
            f"unknown wavelet {wavelet!r}; known: {sorted(REGISTRY)}"
        ) from None
