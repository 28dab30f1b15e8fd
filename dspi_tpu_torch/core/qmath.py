"""Exact fixed-point primitives on int32 torch tensors.

Twins of the firmware's integer helpers, bit for bit:

  - ``q28_mul``  — ``fast_mul_q28`` (dsp_pipeline.c:47-59): 16-bit partial
    products combined as ``(high << 4) + ((mid1 + mid2) >> 12)``, truncating,
    with int32 wrap-around.
  - ``q15_mul``  — ``fast_mul_q15`` (config.h:556-567), in a
    ``dspi.q15_mul`` span; ``fast_mul_q15`` is the same product outside it.
  - ``clip_s24`` / ``q28_to_s24`` — S/PDIF sample conversion
    (config.h:547-551, usb_audio.c:1254-1255).
  - ``f32_to_i32`` — ARM ``vcvt.s32.f32`` (truncate toward zero, saturate,
    NaN -> 0).
  - ``xorshift32`` — the PDM dither PRNG (pdm_generator.c:62-68).

torch int32 add, sub, mul and left shift wrap two's-complement on the CPU
and on CUDA; ``>>`` on int32 is arithmetic.  torch has no usable uint32, so
the one unsigned product (``q15_mul``'s low partial) runs in int64, and
uint32 words (the PRNG state) are carried as their int32 bit patterns,
a logical right shift being the arithmetic one and a mask.
"""

from __future__ import annotations

import torch

from ..runtime.telemetry import span

_I32_MAX = (1 << 31) - 1


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def q28_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Firmware ``fast_mul_q28`` on int32 tensors."""
    ah = a >> 16
    al = a & 0xFFFF
    bh = b >> 16
    bl = b & 0xFFFF
    high = ah * bh
    mid = (ah * bl) + (al * bh)
    return (high << 4) + (mid >> 12)


def q15_mul(sample: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Firmware ``fast_mul_q15``: the sum is assembled mod 2^32 and read
    back as int32; the low partial product is unsigned, so it runs in
    int64 and is shifted there."""
    with span("dspi.q15_mul"):
        return fast_mul_q15(sample, gain)


def fast_mul_q15(sample: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """``q15_mul`` outside its span, for callers that open one span around
    several products (``kernels.q15_cuda``'s plain versions)."""
    sh = sample >> 16
    sl = sample & 0xFFFF
    gh = gain >> 16
    gl = gain & 0xFFFF
    hh = sh * gh
    mid = sh * gl + sl * gh
    ll = sl.to(torch.int64) * gl.to(torch.int64)
    total = ((hh.to(torch.int64) << 17) + (mid.to(torch.int64) << 1)
             + (ll >> 15))
    return wrap32(total)


def clip_s24(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-0x800000, 0x7FFFFF)


def q28_to_s24(x: torch.Tensor) -> torch.Tensor:
    """Q28 -> s24 with round-half-up then saturate."""
    return clip_s24((x + (1 << 5)) >> 6)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """``vcvt.s32.f32``: truncate toward zero, saturate, NaN -> 0.

    2**31-1 is not a float32, so the cast clamps to the largest float32
    below 2**31 and the saturated top is patched afterwards."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    out = x.clamp(-2147483648.0, 2147483520.0).trunc().to(torch.int32)
    return torch.where(x >= 2147483648.0,
                       torch.full_like(out, _I32_MAX), out)


def xorshift32(state: torch.Tensor) -> torch.Tensor:
    """The PDM dither PRNG (pdm_generator.c:62-68) on int32 tensors that
    hold the uint32 state's bit patterns; ``>> 17`` is logical, so the
    sign bits the arithmetic shift copies in are masked off."""
    state = state ^ (state << 13)
    state = state ^ ((state >> 17) & 0x7FFF)
    return state ^ (state << 5)
