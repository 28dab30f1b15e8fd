"""The Q28 chain's Q15 products: the matrix mix and the per-packet output
gains, their plain PyTorch versions and their kernel's wrappers.

Both are the firmware's ``fast_mul_q15`` (``core.qmath.q15_mul``) over a
whole [Ttot, B] plane.  ``q15_mix`` is PASS 4 (usb_audio.c:1075-1100):
every enabled output is ``q15(bl, gains[0, o]) + q15(br, gains[1, o])``
with int32 wrap-around, a disabled one zeros.  ``q15_gain`` applies one
output's gain of each packet (usb_audio.c:1203-1212) in place.  On a CUDA
tensor each launches ``csrc/q15.cu`` once or raises; on a CPU tensor it
runs its plain version, built from ``qmath.fast_mul_q15``.  Either way the
call is one ``dspi.q15_mul`` span, whatever the number of products.

Gains are int32 and the same for every lane or per lane: the mix's
[2, nout] or [2, nout, B], the gain's [Npkt, 1] or [Npkt, B].  Packets are
uniform (Ttot / Npkt rows each) or given by ``ends``, int32 [Npkt] on the
plane's device, each packet's end row (the 44.1 kHz schedule's cumsum).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.qmath import fast_mul_q15
from ..runtime.telemetry import span
from . import LAUNCHES, build

_I32 = torch.int32
MAX_OUT = 5                     # csrc/q15.cu's kMaxOut
_MAX_ROWS = 65535 * 32          # its grid's rows


def _check(name, planes, gain, gain_shapes):
    for v in (*planes, gain):
        if v.dtype != _I32:
            raise TypeError(f"{name} wants int32 tensors, got {v.dtype}")
        if v.device != planes[0].device:
            raise ValueError(f"{name}: a tensor on {v.device}, the plane "
                             f"on {planes[0].device}")
    shape = tuple(planes[0].shape)
    if len(shape) != 2 or 0 in shape or any(tuple(v.shape) != shape
                                            for v in planes) \
            or tuple(gain.shape) not in gain_shapes(shape[1]):
        raise ValueError(
            f"{name} wants planes [Ttot >= 1, B >= 1] and gains "
            f"{' or '.join(str(list(s)) for s in gain_shapes('B'))}; got "
            f"{[list(v.shape) for v in planes]} and {list(gain.shape)}")
    if not all(v.is_contiguous() for v in (*planes, gain)):
        raise ValueError(f"{name} wants contiguous tensors")
    if planes[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Q15 kernel for device {planes[0].device}")
    if shape[0] > _MAX_ROWS or shape[1] >= 2**31:
        raise ValueError(f"{name}: plane too large: {shape}")


def _check_mix(bl, br, gains, enabled):
    nout = len(enabled)
    _check("q15_mix", (bl, br), gains,
           lambda B: ((2, nout), (2, nout, B)))
    if sum(map(bool, enabled)) > MAX_OUT:
        raise ValueError(f"q15_mix takes at most {MAX_OUT} enabled outputs, "
                         f"got {enabled}")


def _check_gain(x, gain, ends):
    """Rows a packet, or None for packets given by ``ends``; raises on
    anything the gain does not take, packets that do not tile the plane
    included (ends are read on the CPU only: on the card the kernel stays
    in bounds whatever they hold)."""
    npkt = gain.shape[0]
    _check("q15_gain", (x,), gain, lambda B: ((npkt, 1), (npkt, B)))
    T = x.shape[0]
    if ends is None:
        if T % npkt:
            raise ValueError(f"q15_gain: {T} rows are not {npkt} uniform "
                             f"packets: pass their ends")
        return T // npkt
    if ends.dtype != _I32 or ends.device != x.device \
            or tuple(ends.shape) != (npkt,) or not ends.is_contiguous():
        raise ValueError(f"q15_gain wants ends int32 [{npkt}] on "
                         f"{x.device}, got {ends.dtype} "
                         f"{list(ends.shape)} on {ends.device}")
    if x.device.type == "cpu":
        steps = torch.diff(ends, prepend=ends.new_zeros(1))
        if int(ends[-1]) != T or bool((steps < 1).any()):
            raise ValueError(f"q15_gain: packet ends {ends.tolist()} do not "
                             f"tile {T} rows")
    return None


def q15_mix_plain(bl, br, gains, enabled):
    """bl, br int32 [Ttot, B]; gains int32 [2, nout] or [2, nout, B];
    ``enabled`` nout flags -> nout planes int32 [Ttot, B]."""
    _check_mix(bl, br, gains, enabled)
    return [fast_mul_q15(bl, gains[0, o]) + fast_mul_q15(br, gains[1, o])
            if on else torch.zeros_like(bl) for o, on in enumerate(enabled)]


def q15_gain_plain(x, gain, ends=None):
    """x int32 [Ttot, B], in place; gain int32 [Npkt, 1] or [Npkt, B];
    ``ends`` None (uniform packets) or int32 [Npkt] -> x, each row times
    its packet's gain."""
    tc = _check_gain(x, gain, ends)
    if tc is not None:
        y = fast_mul_q15(x.reshape(gain.shape[0], tc, -1), gain[:, None, :])
    else:
        reps = torch.diff(ends, prepend=ends.new_zeros(1))
        y = fast_mul_q15(x, torch.repeat_interleave(gain, reps, dim=0,
                                                    output_size=x.shape[0]))
    return x.copy_(y.reshape(x.shape))


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_q15_mix`` and ``dspi_q15_gain`` with their C
    signatures set."""
    mix, gain = lib.dspi_q15_mix, lib.dspi_q15_gain
    if mix.argtypes is None:
        mix.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        mix.restype = ctypes.c_int
        gain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        gain.restype = ctypes.c_int
    return mix, gain


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_mix(fn, bl, br, gains, enabled):
    """One launch of ``fn``, a bound ``dspi_q15_mix``, on checked CUDA
    tensors: the nout planes."""
    T, B = bl.shape
    live = [o for o, on in enumerate(enabled) if on]
    outs = [torch.empty_like(bl) if on else None for on in enabled]
    idx = (ctypes.c_int * len(live))(*live)
    ptrs = (ctypes.c_void_p * len(live))(*[outs[o].data_ptr() for o in live])
    with torch.cuda.device(bl.device):
        rc = fn(bl.data_ptr(), br.data_ptr(), gains.data_ptr(),
                int(gains.dim() == 3), len(enabled), len(live), idx, ptrs,
                T, B, _stream(bl))
    if rc != 0:
        raise RuntimeError(f"Q15 mix kernel launch failed: CUDA error {rc}")
    return [torch.zeros_like(bl) if o is None else o for o in outs]


def launch_gain(fn, x, gain, ends, tc):
    """One launch of ``fn``, a bound ``dspi_q15_gain``, on checked CUDA
    tensors: x, written in place."""
    T, B = x.shape
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), gain.data_ptr(),
                None if ends is None else ends.data_ptr(),
                int(gain.shape[1] != 1),
                gain.shape[0], tc or 0, T, B, _stream(x))
    if rc != 0:
        raise RuntimeError(f"Q15 gain kernel launch failed: CUDA error {rc}")
    return x


def q15_mix(bl, br, gains, enabled):
    """PASS 4 over a segment (signature of ``q15_mix_plain``); with no
    enabled output, zeros and no launch."""
    with span("dspi.q15_mul"):
        if bl.device.type == "cpu":
            return q15_mix_plain(bl, br, gains, enabled)
        _check_mix(bl, br, gains, enabled)
        if not any(enabled):
            return [torch.zeros_like(bl) for _ in enabled]
        out = launch_mix(bind(build.load("q15"))[0], bl, br, gains, enabled)
        LAUNCHES["q15_mix"] += 1
        return out


def q15_gain(x, gain, ends=None):
    """One output's per-packet gain over a segment, in place (signature of
    ``q15_gain_plain``)."""
    with span("dspi.q15_mul"):
        if x.device.type == "cpu":
            return q15_gain_plain(x, gain, ends)
        tc = _check_gain(x, gain, ends)
        out = launch_gain(bind(build.load("q15"))[1], x, gain, ends, tc)
        LAUNCHES["q15_gain"] += 1
        return out
