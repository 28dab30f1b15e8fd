"""Scalar exact-integer reference primitives for the golden model.

Python-int implementations of the firmware's int32 arithmetic with explicit
two's-complement wrapping.  Slow but unambiguous — this is the oracle the
vectorized paths (the chain's torch ops and the CUDA kernels) are tested
against.  The JAX package's ``golden/qref.py``, copied.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


def w32(x: int) -> int:
    """Wrap a Python int to signed int32 (two's complement)."""
    return ((x + 0x80000000) & _M32) - 0x80000000


def asr(x: int, n: int) -> int:
    """Arithmetic shift right; Python's >> on ints is already arithmetic."""
    return x >> n


def q28_mul(a: int, b: int) -> int:
    """fast_mul_q28 (dsp_pipeline.c:47-59), scalar exact."""
    ah = asr(a, 16)
    al = a & 0xFFFF
    bh = asr(b, 16)
    bl = b & 0xFFFF
    high = w32(ah * bh)
    mid = w32(w32(ah * bl) + w32(al * bh))
    return w32(w32(high << 4) + asr(mid, 12))


def q15_mul(s: int, g: int) -> int:
    """fast_mul_q15 (config.h:556-567), scalar exact."""
    sh = asr(s, 16)
    sl = s & 0xFFFF
    gh = asr(g, 16)
    gl = g & 0xFFFF
    hh = w32(sh * gh)
    mid = w32(w32(sh * gl) + w32(sl * gh))
    ll = (sl * gl) & _M32
    total = (((hh & _M32) << 17) + ((mid & _M32) << 1) + (ll >> 15)) & _M32
    return w32(total)


def clip_s24(x: int) -> int:
    if x > 0x7FFFFF:
        return 0x7FFFFF
    if x < -0x800000:
        return -0x800000
    return x


def q28_to_s24(x: int) -> int:
    """usb_audio.c:1254: clip_s24((x + (1<<5)) >> 6)."""
    return clip_s24(asr(w32(x + (1 << 5)), 6))


def f32_to_i32(x) -> int:
    """ARM vcvt.s32.f32: truncate toward zero with saturation."""
    import math

    xf = float(x)
    if math.isnan(xf):
        return 0
    if xf >= 2147483648.0:
        return 2147483647
    if xf <= -2147483648.0:
        return -2147483648
    return int(xf)  # int() truncates toward zero


def xorshift32(state: int) -> int:
    """PDM dither PRNG (pdm_generator.c:62-68)."""
    state ^= (state << 13) & _M32
    state ^= state >> 17
    state ^= (state << 5) & _M32
    return state & _M32
