"""The segment tail of both chains: from the output buffers that PASS 4-5
leave to all that a segment reports of them (usb_audio.c:885-940 float,
:1203-1257 Q28), its plain PyTorch version and its kernel's wrapper.

For each output, in order: its gain of each packet (float ``g == 0 ? 0 :
y * g``; Q28 ``fast_mul_q15``), zeros if muted, left as it came if
disabled; its delay line (usb_audio.c:897-911 / 1213-1227), every output
of ``delayed`` whether enabled or not; then the peaks of the S/PDIF
channels and the sub, the S/PDIF channels' s24 words (float
``f32_to_i32(clamp(v, -1, 1) * 8388607)``, Q28 ``q28_to_s24``; zeros for a
pair with both channels disabled) and their sums a lane, and the sub as
the PDM modulator's Q28 input (float ``f32_to_i32(v * 2^28)``).  On a
CUDA tensor ``segment_tail`` launches ``csrc/tail.cu`` once or raises; on
a CPU tensor it runs ``segment_tail_plain``, which the kernel equals word
for word.

The planes' dtype picks the chain: float32, or the Q28 chain's int32.
Gains are [nout, Npkt, 1] or per lane [nout, Npkt, B], float32 or Q15
int32; packets are uniform (Ttot / Npkt rows each) or given by ``ends``,
int32 [Npkt] on the planes' device, each packet's end row (the 44.1 kHz
schedule's cumsum), as ``q15_cuda.q15_gain`` takes them.  Delays are
int32 [nd] or per lane [nd, B], each in 0..D; rings [nd, D, B] in the
planes' dtype, time-ordered (oldest first).

Returns a dict: ``peaks`` [spdif + 1, B] in the planes' dtype (the S/PDIF
channels', then the sub's, 0 for a disabled sub), ``s24_sum`` int32
[spdif, B] (each channel's words summed mod 2^32), ``sub`` int32 [Ttot, B]
(None unless ``sub``), ``ring`` the new rings (None without delayed
outputs), ``s24`` int32 [spdif, Ttot, B] (None unless ``words`` or
``full``) and ``out`` [nout, Ttot, B], the gained and delayed planes (None
unless ``full``).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.qmath import f32_to_i32, fast_mul_q15, q28_to_s24
from . import LAUNCHES, build

_F32 = torch.float32
_I32 = torch.int32
MAX_OUT = 9                     # csrc/tail.cu's kMaxOut
_MAX_ROWS = 65535 * 64          # its grid's rows: kRows a block


def _check(planes, gains, ends, delay, ring, enabled, muted, delayed,
           spdif):
    """Raises on anything the tail does not take.  Ends and delays are
    read on the CPU only: on the card the kernel stays in bounds whatever
    they hold."""
    nout = len(planes)
    x = planes[0] if planes else None
    if x is None or x.dtype not in (_F32, _I32):
        raise TypeError(f"segment_tail wants float32 or int32 planes, got "
                        f"{None if x is None else x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no tail kernel for device {x.device}")
    if not 1 <= nout <= MAX_OUT or len(enabled) != nout \
            or len(muted) != nout or spdif % 2 or not 0 <= spdif < nout:
        raise ValueError(
            f"segment_tail takes 1-{MAX_OUT} outputs with a flag each and "
            f"an even number of S/PDIF channels below them; got {nout} "
            f"planes, {len(enabled)} / {len(muted)} flags, spdif {spdif}")
    if len(set(delayed)) != len(delayed) \
            or not all(0 <= o < nout for o in delayed):
        raise ValueError(f"segment_tail: delayed outputs {delayed} are not "
                         f"distinct outputs of {nout}")
    gdt = x.dtype
    T, B = x.shape if x.dim() == 2 else (0, 0)
    rings = [ring] if delayed and ring is not None else []
    for name, v in (("planes", planes), ("gains", [gains]), ("ring", rings)):
        for t in v:
            if t.dtype != gdt:
                raise TypeError(f"segment_tail wants {gdt} {name}, got "
                                f"{t.dtype}")
            if t.device != x.device:
                raise ValueError(f"segment_tail: {name} on {t.device}, the "
                                 f"planes on {x.device}")
    npkt = gains.shape[1] if gains.dim() == 3 else 0
    if T < 1 or B < 1 or any(tuple(v.shape) != (T, B) for v in planes) \
            or gains.dim() != 3 or gains.shape[0] != nout or npkt < 1 \
            or gains.shape[2] not in (1, B):
        raise ValueError(
            f"segment_tail wants planes [Ttot >= 1, B >= 1] and gains "
            f"[{nout}, Npkt, 1 | B]; got {[list(v.shape) for v in planes]} "
            f"and {list(gains.shape)}")
    if not all(v.is_contiguous() for v in (*planes, gains)):
        raise ValueError("segment_tail wants contiguous planes and gains")
    if T > _MAX_ROWS or B >= 2**31:
        raise ValueError(f"segment_tail: planes too large: {[T, B]}")
    tc = None
    if ends is None:
        if T % npkt:
            raise ValueError(f"segment_tail: {T} rows are not {npkt} "
                             f"uniform packets: pass their ends")
        tc = T // npkt
    elif ends.dtype != _I32 or ends.device != x.device \
            or tuple(ends.shape) != (npkt,) or not ends.is_contiguous():
        raise ValueError(f"segment_tail wants ends int32 [{npkt}] on "
                         f"{x.device}, got {ends.dtype} {list(ends.shape)} "
                         f"on {ends.device}")
    elif x.device.type == "cpu":
        steps = torch.diff(ends, prepend=ends.new_zeros(1))
        if int(ends[-1]) != T or bool((steps < 1).any()):
            raise ValueError(f"segment_tail: packet ends {ends.tolist()} do "
                             f"not tile {T} rows")
    if not delayed:
        return tc
    nd = len(delayed)
    if delay is None or ring is None or delay.dtype != _I32 \
            or delay.device != x.device \
            or tuple(delay.shape) not in ((nd,), (nd, B)) \
            or ring.dim() != 3 or ring.shape[0] != nd or ring.shape[1] < 1 \
            or ring.shape[2] != B \
            or not (delay.is_contiguous() and ring.is_contiguous()):
        raise ValueError(
            f"segment_tail wants contiguous delays int32 [{nd}] or [{nd}, "
            f"B] and rings [{nd}, D, {B}] on {x.device} for delayed "
            f"outputs {delayed}; got "
            f"{None if delay is None else (delay.dtype, list(delay.shape))}"
            f" and {None if ring is None else list(ring.shape)}")
    if x.device.type == "cpu" and bool(((delay < 0)
                                        | (delay > ring.shape[1])).any()):
        raise ValueError(f"segment_tail: delays {delay.tolist()} outside "
                         f"0..{ring.shape[1]}")
    return tc


def per_packet(vals, ends, Ttot):
    """Broadcast a per-packet [Npkt, 1|B] array to [Ttot, 1|B] along the
    packets: uniform (``ends`` None) or ending at ``ends``."""
    if ends is None:
        reps = Ttot // vals.shape[0]
        return torch.repeat_interleave(vals, reps, dim=0, output_size=Ttot)
    reps = torch.diff(ends, prepend=ends.new_zeros(1)).long()
    return torch.repeat_interleave(vals, reps, dim=0, output_size=Ttot)


def _delay_apply(ring_k, buf, dly, T, D):
    """One output's delayed read over a whole segment (usb_audio.c:897-911).

    Rings are time-ordered (oldest first): the delayed stream is a window
    of concat(ring, buf) starting at D - dly.  ``dly`` stays a device
    tensor (an index_select, not a host read), so the host never waits on
    the card here.  A per-stream delay ([B]) reads through one gather over
    [D+T, B], its index built once.  Returns (delayed [T, B], ring' [D, B])."""
    comb = torch.cat([ring_k, buf], dim=0)                # [D+T, B]
    t = torch.arange(T, device=buf.device)
    start = D - dly.to(torch.int64)
    if start.dim() == 0:
        delayed = comb.index_select(0, start + t)
    else:
        delayed = torch.gather(comb, 0, start[None, :] + t[:, None])
    ring_new = buf[T - D:] if T >= D else comb[T:]
    return delayed, ring_new


def segment_tail_plain(planes, gains, ends=None, delay=None, ring=None, *,
                       enabled, muted, delayed=(), spdif, sub=True,
                       words=False, full=False):
    """The tail as whole-segment tensor ops (signature and returns in the
    module's docstring)."""
    _check(planes, gains, ends, delay, ring, enabled, muted, delayed, spdif)
    q28 = planes[0].dtype == _I32
    T, B = planes[0].shape
    nout = len(planes)
    bufs = list(planes)
    # output gains (usb_audio.c:885-894 / 1203-1212), per packet
    for o in range(nout):
        if not enabled[o]:
            continue
        if muted[o]:
            bufs[o] = torch.zeros_like(bufs[o])
            continue
        g = per_packet(gains[o], ends, T)                 # [T, 1|B]
        y = bufs[o]
        bufs[o] = (fast_mul_q15(y, g) if q28 else
                   torch.where(g == 0.0, torch.zeros_like(y), y * g))
    # the delay lines (usb_audio.c:897-911 / 1213-1227)
    rings = []
    for k, o in enumerate(delayed):
        bufs[o], ring_k = _delay_apply(ring[k], bufs[o], delay[k], T,
                                       ring.shape[1])
        rings.append(ring_k)
    # peaks: the S/PDIF channels and the sub
    peaks = [bufs[o].abs().amax(dim=0) for o in range(spdif)]
    peaks.append(bufs[-1].abs().amax(dim=0) if enabled[-1]
                 else torch.zeros_like(bufs[-1][0]))
    # S/PDIF conversion (usb_audio.c:934-940 / 1244-1257)
    s24 = []
    for pair in range(spdif // 2):
        on = enabled[2 * pair] or enabled[2 * pair + 1]
        for v in bufs[2 * pair:2 * pair + 2]:
            s24.append((q28_to_s24(v) if q28 else
                        f32_to_i32(v.clamp(-1.0, 1.0) * 8388607.0))
                       if on else torch.zeros((T, B), dtype=_I32,
                                              device=v.device))
    return {
        "peaks": torch.stack(peaks),
        "s24_sum": (torch.stack([v.sum(dim=0) for v in s24]).to(_I32)
                    if s24 else torch.zeros((0, B), dtype=_I32,
                                            device=planes[0].device)),
        "sub": ((bufs[-1] if q28 else f32_to_i32(bufs[-1] * float(1 << 28)))
                if sub else None),
        "ring": torch.stack(rings) if rings else None,
        "s24": (torch.stack(s24) if s24 else torch.zeros(
            (0, T, B), dtype=_I32, device=planes[0].device))
        if words or full else None,
        "out": torch.stack(bufs) if full else None,
    }


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_tail`` with its C signature set."""
    fn = lib.dspi_tail
    if fn.argtypes is None:
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [i, ctypes.POINTER(p), i, p, i, p, i, i, p, i,
                       ctypes.POINTER(i), p, p, i, u, u, i, p, p, p, p, p,
                       i, i, p]
        fn.restype = i
    return fn


def _ptr(v):
    return None if v is None else v.data_ptr()


def _bits(flags) -> int:
    return sum(1 << o for o, on in enumerate(flags) if on)


def launch(fn, planes, gains, ends, tc, delay, ring, *, enabled, muted,
           delayed, spdif, sub, words, full):
    """One launch of ``fn``, a bound ``dspi_tail``, on checked CUDA
    tensors: the dict ``segment_tail`` returns."""
    x = planes[0]
    T, B = x.shape
    nout = len(planes)
    q28 = x.dtype == _I32
    # the peaks' int32 keys start below every key: +0.0's bits, INT_MIN
    peak = torch.full((spdif + 1, B), -2**31 if q28 else 0, dtype=_I32,
                      device=x.device)
    total = torch.zeros((spdif, B), dtype=_I32, device=x.device)
    ring_out = torch.empty_like(ring) if delayed else None
    out = torch.empty((nout, T, B), dtype=x.dtype, device=x.device) \
        if full else None
    s24 = torch.empty((spdif, T, B), dtype=_I32, device=x.device) \
        if words or full else None
    sub_plane = torch.empty((T, B), dtype=_I32, device=x.device) \
        if sub else None
    line = [-1] * nout
    for k, o in enumerate(delayed):
        line[o] = k
    ptrs = (ctypes.c_void_p * nout)(*[v.data_ptr() for v in planes])
    with torch.cuda.device(x.device):
        rc = fn(int(q28), ptrs, nout, gains.data_ptr(),
                int(gains.shape[2] != 1), _ptr(ends), gains.shape[1],
                tc or 0, _ptr(delay) if delayed else None,
                int(bool(delayed) and delay.dim() == 2),
                (ctypes.c_int * nout)(*line),
                _ptr(ring) if delayed else None, _ptr(ring_out),
                ring.shape[1] if delayed else 0, _bits(enabled),
                _bits(muted), spdif, peak.data_ptr(), total.data_ptr(),
                _ptr(out), _ptr(s24), _ptr(sub_plane), T, B,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment tail kernel launch failed: CUDA error "
                           f"{rc}")
    return {"peaks": peak if q28 else peak.view(_F32), "s24_sum": total,
            "sub": sub_plane, "ring": ring_out, "s24": s24, "out": out}


def segment_tail(planes, gains, ends=None, delay=None, ring=None, *,
                 enabled, muted, delayed=(), spdif, sub=True, words=False,
                 full=False):
    """The segment tail (signature of ``segment_tail_plain``)."""
    kw = dict(enabled=enabled, muted=muted, delayed=tuple(delayed),
              spdif=spdif, sub=sub, words=words, full=full)
    if planes and planes[0].device.type == "cpu":
        return segment_tail_plain(planes, gains, ends, delay, ring, **kw)
    tc = _check(planes, gains, ends, delay, ring, enabled, muted,
                tuple(delayed), spdif)
    out = launch(bind(build.load("tail")), planes, gains, ends, tc, delay,
                 ring, **kw)
    LAUNCHES["tail"] += 1
    return out
