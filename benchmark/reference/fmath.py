"""Deterministic float32 transcendentals on torch tensors.

The leveller's per-block gain math (leveller.c:178-206) must give the same
bits on every backend, so the JAX package computes it with integer
fixed-point polynomials and Newton steps and uses float only where one
IEEE operation is deterministic on its own (a lone multiply or add, a
power-of-two scale, an int <-> float conversion).  This module is the same
algorithm on torch tensors and gives the same bits as the NumPy branch of
the JAX package's ``core/fmath.py``.

torch has exact int64, so the 64-bit products that the JAX code assembles
from 16x16 partial products are formed directly; the words agree because
every intermediate is the same integer.  torch eager never fuses a float
``a*b + c`` into one FMA, so the lone float ops stay lone.

All functions take and return float32 tensors of any shape.
"""

from __future__ import annotations

import numpy as np
import torch

from . import qmath

_I32 = torch.int32
_I64 = torch.int64

# log2(m) on m in [sqrt(1/2), sqrt(2)) via z = (m-1)/(m+1):
# log2(m) = z * (c1 + c3 z^2 + c5 z^4 + c7 z^6 + c9 z^8), Q28 coefficients.
_LOG2_CQ = tuple(int(round(c * (1 << 28))) for c in (
    2.8853900818e0, 9.6179667816e-1, 5.7708263824e-1,
    4.1173083373e-1, 3.3963488222e-1))                   # c1 c3 c5 c7 c9

# 2^f on f in [0, 1): degree-7 fit, Q30 coefficients.
_EXP2_CQ = tuple(int(round(c * (1 << 30))) for c in (
    9.9999999986e-1, 6.9314719079e-1, 2.4022632913e-1, 5.5505401647e-2,
    9.6133378984e-3, 1.3431453553e-3, 1.4294822699e-4, 2.1646947857e-5))

# python floats that are exactly the float32 constants of the reference
_LOG10_2 = float(np.float32(0.30102999566398119521))
_LOG2_10 = float(np.float32(3.3219280948873623478))

_SQRT2_Q29 = int(np.float32(1.4142135624) * (1 << 29))
_RCP_SEED_A = int(round(24 / 17 * (1 << 29)))
_RCP_SEED_B = int(round(8 / 17 * (1 << 29)))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(_I32)


def _flt(b: torch.Tensor) -> torch.Tensor:
    return b.contiguous().view(torch.float32)


def _mul_shift(a, b, sh: int) -> torch.Tensor:
    """Low 32 bits of ((int64)a * b) >> sh (arithmetic), as int32."""
    if not isinstance(a, torch.Tensor):
        p = b.to(_I64) * int(a)
    else:
        p = a.to(_I64) * b.to(_I64)
    return qmath.wrap32(p >> sh)


def _recip_core(dn: torch.Tensor) -> torch.Tensor:
    """2^58 / dn for int32 dn in [2^29, 2^30): linear seed + three exact
    Q29 Newton steps."""
    y = _RCP_SEED_A - _mul_shift(_RCP_SEED_B, dn, 29)
    for _ in range(3):
        t = _mul_shift(dn, y, 29)
        y = _mul_shift(y, (1 << 30) - t, 29)
    return y


def det_recip(b: torch.Tensor) -> torch.Tensor:
    """Deterministic 1/b for normal, nonzero b (~1 ulp)."""
    bits = _bits(b)
    e = ((bits >> 23) & 0xFF) - 127
    m_q29 = ((bits & 0x7FFFFF) << 6) | (1 << 29)
    y = _recip_core(m_q29)
    sign = (bits >> 31) << 31
    exp_bits = ((127 - e).clamp(1, 254) << 23) | sign
    r = y.to(torch.float32) * 2.0 ** -29
    return r * _flt(exp_bits)


def det_div(a, b: torch.Tensor) -> torch.Tensor:
    """Deterministic a/b: one multiply by ``det_recip(b)``."""
    return torch.as_tensor(a, dtype=torch.float32, device=b.device) \
        * det_recip(b)


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """Deterministic float32 log2 for finite normal x > 0."""
    bits = _bits(x)
    e = ((bits >> 23) & 0xFF) - 127
    m_q29 = ((bits & 0x7FFFFF) << 6) | (1 << 29)
    big = m_q29 >= _SQRT2_Q29
    m_q29 = torch.where(big, m_q29 >> 1, m_q29)
    e = e + big.to(_I32)

    num = m_q29 - (1 << 29)
    den = m_q29 + (1 << 29)
    hi_den = den >= (1 << 30)
    dn = torch.where(hi_den, den >> 1, den)
    r = _recip_core(dn)
    r = torch.where(hi_den, r >> 1, r)
    z = _mul_shift(num, r, 28)                           # Q30

    z2 = _mul_shift(z, z, 30)
    p = torch.full_like(z, _LOG2_CQ[4])
    for c in _LOG2_CQ[3::-1]:
        p = _mul_shift(p, z2, 30) + c
    zp = _mul_shift(z, p, 28)
    return e.to(torch.float32) + zp.to(torch.float32) * 2.0 ** -30


def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """Deterministic float32 2**x for |x| < 126."""
    x = x.to(torch.float32)
    n = torch.floor(x)
    f = x - n
    f_q30 = qmath.f32_to_i32(f * float(1 << 30))
    p = torch.full_like(f_q30, _EXP2_CQ[7])
    for c in _EXP2_CQ[6::-1]:
        p = _mul_shift(p, f_q30, 30) + c
    n_i = n.to(_I32).clamp(-126, 127)
    scale = _flt((n_i + 127) << 23)
    r = p.to(torch.float32) * 2.0 ** -30
    return r * scale


def log10_f32(x: torch.Tensor) -> torch.Tensor:
    return log2_f32(x) * _LOG10_2


def exp10_f32(x: torch.Tensor) -> torch.Tensor:
    return exp2_f32(x * _LOG2_10)


def pow_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a**b for a > 0, with a == 0 -> 0 and a == 1 -> 1 exactly."""
    a = a.to(torch.float32)
    one = torch.ones_like(a)
    out = exp2_f32(b.to(torch.float32) * log2_f32(torch.where(a > 0, a, one)))
    out = torch.where(a == 0.0, torch.zeros_like(out), out)
    return torch.where(a == 1.0, torch.ones_like(out), out)


def mul_det(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a*b rounded to nearest even, computed in integers, with the
    firmware's FPSCR FZ semantics: denormal operands and results flush to
    a signed zero, overflow clamps to the largest finite float32."""
    abits = _bits(a)
    bbits = _bits(b)
    sign = ((abits ^ bbits) >> 31) << 31
    ea = (abits >> 23) & 0xFF
    eb = (bbits >> 23) & 0xFF
    ma = ((abits & 0x7FFFFF) | (1 << 23)).to(_I64)
    mb = ((bbits & 0x7FFFFF) | (1 << 23)).to(_I64)
    prod = ma * mb                                # in [2^46, 2^48)
    top = (prod >> 47) & 1                        # 1 iff product >= 2^47
    sh = top + 23
    keep = prod >> sh
    rem = prod & ((1 << sh) - 1)
    half = 1 << (sh - 1)
    round_up = ((rem > half) | ((rem == half) & ((keep & 1) == 1))).to(_I64)
    mant = keep + round_up                        # may carry to 2^24
    carry = (mant >> 24) & 1
    mant = torch.where(carry == 1, mant >> 1, mant).to(_I32)
    e = ea + eb - 127 + (top + carry).to(_I32)
    out_bits = torch.where(
        e <= 0, sign,
        torch.where(e >= 255, sign | 0x7F7FFFFF,
                    sign | (e << 23) | (mant & 0x7FFFFF)))
    zero = (ea == 0) | (eb == 0)
    return _flt(torch.where(zero, sign, out_bits))


def smooth_det(alpha: torch.Tensor, prev: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """``alpha*prev + (1-alpha)*target`` with both products rounded on
    their own (the firmware's expression under -ffp-contract=off)."""
    return mul_det(alpha, prev) + mul_det(1.0 - alpha, target)
