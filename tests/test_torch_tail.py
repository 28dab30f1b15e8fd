"""The segment tail (``kernels.tail_cuda``) on the CPU: its plain version
against a NumPy model of the firmware's tail, one sample at a time
(usb_audio.c:885-940 float, :1203-1257 Q28), on edge samples and gains,
both chains, uniform packets and the 44/45 schedule's ends, scalar and
per-lane gains and delays, muted, disabled and delayed-but-disabled
outputs, a pair with both channels off, a disabled sub and segments
shorter than the delay ring; the wrapper's refusals; and segments of both
chains through ``Engine`` calling it once, counting no launch on the CPU.
The kernel itself is held to the plain version on the card
(test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, pipeline
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.kernels import LAUNCHES
from dspi_tpu_torch.kernels.tail_cuda import (segment_tail,
                                              segment_tail_plain)

I32_MIN, I32_MAX = -2**31, 2**31 - 1
F32_EDGES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0,
                      1.0000001, -1.0000001, 2.5, -3.0, 1e-40, -1e-45,
                      1.1754942e-38, 1e30, 8.0, -8.0, 7.9999995, 0.999999,
                      -0.5, 3.0e-8], np.float32)
F32_GAINS = np.array([0.0, -0.0, 1.0, 0.8912509, 1e-39, 3.0, -1.0, 0.5],
                     np.float32)
Q28_EDGES = np.array([I32_MIN, I32_MAX, I32_MAX - 31, I32_MAX - 32,
                      I32_MIN + 1, 0, 1, -1, 31, 32, -32, -33,
                      (0x7FFFFF << 6) - 33, (0x7FFFFF << 6) - 32,
                      (0x7FFFFF << 6) + 31, (0x7FFFFF << 6) + 32,
                      -(0x800000 << 6) - 32, -(0x800000 << 6) - 33,
                      1 << 28, -(1 << 28)], np.int64).astype(np.int32)
Q15_GAINS = np.array([0, 32768, 32767, -32768, 65535, I32_MIN, I32_MAX,
                      10362, 1, -1], np.int64).astype(np.int32)
SCHED = (5, 6, 5, 6, 5, 6, 5, 6)            # a 44/45-like cadence, 44 rows
D = 64                                       # the delay ring

# (enabled, muted, delayed) for the float chain's 9 outputs (4 S/PDIF
# pairs and the sub) and the Q28 chain's 5 (2 pairs and the sub): a muted
# output, a disabled one in a live pair, a pair with both channels off
# (one of them delayed), a delayed muted output; then a disabled sub
FLAGS = {
    "float": ((True, True, False, True, True, True, False, False, True),
              (False, False, False, True, False, False, False, False, False),
              (1, 3, 4, 7, 8)),
    "q28": ((True, False, False, False, True),
            (False, True, False, False, False),
            (1, 2, 4)),
}
FLAGS_NOSUB = {
    "float": ((True,) * 8 + (False,), (False,) * 9, (0, 8)),
    "q28": ((True, True, True, True, False), (False,) * 5, (3, 4)),
}


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _q15(s: int, g: int) -> int:
    """fast_mul_q15 (config.h:556-567), the sum assembled mod 2^32."""
    sh, sl, gh, gl = s >> 16, s & 0xFFFF, g >> 16, g & 0xFFFF
    return _wrap32(((sh * gh) << 17) + ((sh * gl + sl * gh) << 1)
                   + ((sl * gl) >> 15))


def _vcvt(f) -> int:
    """vcvt.s32.f32: truncate toward zero, saturate, NaN -> 0."""
    f = float(f)
    if np.isnan(f):
        return 0
    if f >= 2.0**31:
        return I32_MAX
    if f <= -2.0**31:
        return I32_MIN
    return int(f)


def _sample_tail(x, g, q28):
    """One sample's output gain (usb_audio.c:885-894 / 1203-1212)."""
    if q28:
        return np.int32(_q15(int(x), int(g)))
    return np.float32(0.0) if g == 0 else np.float32(x * g)


def firmware_tail(planes, gains, ends, delay, ring, enabled, muted, delayed,
                  spdif, q28):
    """The firmware's PASS 5 tail a sample at a time, a lane at a time:
    gain, delay line through a circular buffer (write at t mod D, read at
    (t - dly) mod D), peak, S/PDIF word and sum, the sub's Q28.  Returns
    the dict segment_tail returns, as NumPy."""
    nout = len(planes)
    T, B = planes[0].shape
    pkt = np.searchsorted(ends, np.arange(T), side="right")
    dt = np.int32 if q28 else np.float32
    out = np.zeros((nout, T, B), dt)
    ring_new = None if ring is None else np.zeros_like(ring)
    for b in range(B):
        for o in range(nout):
            k = delayed.index(o) if o in delayed else None
            if k is not None:
                circ = ring[k, :, b].copy()
                d = int(delay[k, b] if delay.ndim == 2 else delay[k])
            for t in range(T):
                y = planes[o][t, b]
                if enabled[o]:
                    y = (dt(0) if muted[o] else _sample_tail(
                        y, gains[o, pkt[t], b if gains.shape[2] > 1 else 0],
                        q28))
                if k is not None:
                    circ[t % D] = y
                    y = circ[(t - d) % D]
                out[o, t, b] = y
            if k is not None:
                ring_new[k, :, b] = [circ[(T + j) % D] for j in range(D)]
    peaks = np.zeros((spdif + 1, B), dt)
    s24 = np.zeros((spdif, T, B), np.int32)
    sums = np.zeros((spdif, B), np.int32)
    sub = np.zeros((T, B), np.int32)
    for b in range(B):
        for c, o in enumerate(list(range(spdif)) + [nout - 1]):
            if c == spdif and not enabled[o]:
                continue
            v = out[o, :, b]
            if q28:                # |INT_MIN| wraps to INT_MIN
                peaks[c, b] = max(_wrap32(abs(int(w))) for w in v)
            else:                  # a NaN sample makes the peak NaN
                a = np.abs(v)
                peaks[c, b] = np.nan if np.isnan(a).any() else a.max()
        for o in range(spdif):
            if not (enabled[o & ~1] or enabled[o | 1]):
                continue
            total = 0
            for t in range(T):
                v = out[o, t, b]
                if q28:            # usb_audio.c:1254-1255
                    w = min(max(_wrap32(int(v) + 32) >> 6, -0x800000),
                            0x7FFFFF)
                else:              # usb_audio.c:934-940
                    c = np.float32(min(max(v, np.float32(-1.0)),
                                       np.float32(1.0))) \
                        if not np.isnan(v) else v
                    w = _vcvt(np.float32(c * np.float32(8388607.0)))
                s24[o, t, b] = w
                total += w
            sums[o, b] = _wrap32(total)
        with np.errstate(over="ignore"):
            for t in range(T):
                v = out[nout - 1, t, b]
                sub[t, b] = (v if q28 else
                             _vcvt(np.float32(v * np.float32(2**28))))
    return {"peaks": peaks, "s24_sum": sums, "sub": sub, "ring": ring_new,
            "s24": s24, "out": out}


def tail_case(chain, sched, gain_lane, dly_lane, T, B, seed, flags=FLAGS,
              ring_len=D):
    """Planes over edge samples (the edges in each plane's first rows, down
    its first lane and at random places), edge gains a packet, delays over
    0..ring_len - 1 with the ring's reach at both ends, a random ring of
    ``ring_len`` rows.  Packets: uniform (``sched`` False), SCHED's cadence
    (True) or a tuple of packet lengths repeated, the last packet taking
    the rows left.  Returns (positional args, keywords, packet ends) for
    segment_tail."""
    rng = np.random.default_rng(seed)
    q28 = chain == "q28"
    enabled, muted, delayed = flags[chain]
    nout, spdif = len(enabled), len(enabled) - 1
    edges = Q28_EDGES if q28 else F32_EDGES

    def plane():
        if q28:
            x = rng.integers(I32_MIN, I32_MAX + 1, size=(T, B),
                             dtype=np.int64).astype(np.int32)
            x[rng.random((T, B)) < 0.5] >>= 3
        else:
            x = (rng.standard_normal((T, B)) * 0.7).astype(np.float32)
        pos = rng.integers(0, T * B, size=len(edges))
        x.flat[pos] = edges
        n = min(len(edges), T)
        x[:n, 0] = edges[:n]
        x.flat[:min(len(edges), x.size)] = edges[:x.size]
        return x

    if sched:
        cad = np.array(SCHED if sched is True else sched)
        lengths = np.resize(cad, T // cad.min() + 1)
        lengths = lengths[np.cumsum(lengths) <= T]
        lengths[-1] += T - lengths.sum()
        ends = np.cumsum(lengths).astype(np.int32)
    else:
        tc = T // 4 if T % 4 == 0 else T
        ends = np.arange(tc, T + 1, tc, dtype=np.int32)
    npkt = len(ends)
    gvals = Q15_GAINS if q28 else F32_GAINS
    gains = rng.choice(gvals, size=(nout, npkt, B if gain_lane else 1))
    gains.flat[:min(len(gvals), gains.size)] = gvals[:gains.size]
    nd = len(delayed)
    delay = rng.integers(0, ring_len, size=(nd, B) if dly_lane else (nd,))
    delay.flat[:2] = [ring_len - 1, 0][:delay.size]
    delay = delay.astype(np.int32)
    shape = (nd, ring_len, B)
    ring = (rng.standard_normal(shape).astype(np.float32) if not q28
            else rng.integers(-2**30, 2**30, size=shape).astype(np.int32))
    n = min(ring_len, len(edges))
    ring[:, :n, 0] = edges[:n]
    planes = [torch.from_numpy(plane()) for _ in range(nout)]
    args = (planes, torch.from_numpy(np.ascontiguousarray(gains)),
            torch.from_numpy(ends) if sched else None,
            torch.from_numpy(delay), torch.from_numpy(ring))
    kw = dict(enabled=enabled, muted=muted, delayed=delayed, spdif=spdif)
    return args, kw, ends


def _same(got, want, what):
    """Word for word, a NaN for a NaN: float words are compared as bits
    where either is a number."""
    g = got.numpy() if isinstance(got, torch.Tensor) else got
    assert g.shape == want.shape, what
    if g.dtype == np.float32:
        nan = np.isnan(g) & np.isnan(want)
        g = np.where(nan, 0, g.view(np.int32))
        want = np.where(nan, 0, want.view(np.int32))
    bad = np.flatnonzero(g != want)
    assert bad.size == 0, (what, bad[:5], g.flat[bad[:5]], want.flat[bad[:5]])


@pytest.mark.parametrize("chain", ["float", "q28"])
@pytest.mark.parametrize("sched,gain_lane,dly_lane,T", [
    (False, False, False, 96), (True, False, False, 96),
    (False, True, True, 96), (True, True, False, 88),
    (False, False, True, 40), (True, True, True, 44)])
def test_plain_tail_equals_firmware_model(chain, sched, gain_lane, dly_lane,
                                          T):
    """Every output of the plain tail (peaks, s24 sums, the sub's Q28, the
    new rings, and with emit 'full' the delayed planes and the s24 words)
    word for word the per-sample model's; segments of 40 and 44 rows are
    shorter than the 64-row ring."""
    args, kw, ends = tail_case(chain, sched, gain_lane, dly_lane, T, 5,
                               seed=T * 7 + gain_lane * 2 + dly_lane)
    got = segment_tail_plain(*args, **kw, sub=True, full=True)
    planes, gains, _, delay, ring = args
    want = firmware_tail([p.numpy() for p in planes], gains.numpy(), ends,
                         delay.numpy(), ring.numpy(), kw["enabled"],
                         kw["muted"], kw["delayed"], kw["spdif"],
                         chain == "q28")
    for k in want:
        _same(got[k], want[k], k)


@pytest.mark.parametrize("chain", ["float", "q28"])
def test_plain_tail_disabled_sub(chain):
    """A disabled sub's peak is 0 (the Q28 row too, not |INT_MIN|), the
    rest as the model's; a pair of one disabled channel still converts
    both."""
    args, kw, ends = tail_case(chain, True, True, False, 44, 3, seed=9,
                               flags=FLAGS_NOSUB)
    got = segment_tail_plain(*args, **kw, sub=False, full=True)
    planes, gains, _, delay, ring = args
    want = firmware_tail([p.numpy() for p in planes], gains.numpy(), ends,
                         delay.numpy(), ring.numpy(), kw["enabled"],
                         kw["muted"], kw["delayed"], kw["spdif"],
                         chain == "q28")
    assert not want["peaks"][-1].any()
    assert got["sub"] is None
    for k in ("peaks", "s24_sum", "ring", "s24", "out"):
        _same(got[k], want[k], k)


@pytest.mark.parametrize("chain", ["float", "q28"])
@pytest.mark.parametrize("words,full", [(False, False), (True, False),
                                        (False, True)])
def test_plain_tail_outputs_asked_for(chain, words, full):
    """The s24 words come only with ``words`` or ``full``, the planes only
    with ``full``; what is reported either way is the same words."""
    args, kw, _ = tail_case(chain, False, False, False, 48, 4, seed=3)
    ref = segment_tail_plain(*args, **kw, full=True)
    got = segment_tail_plain(*args, **kw, words=words, full=full)
    assert (got["s24"] is None) == (not (words or full))
    assert (got["out"] is None) == (not full)
    for k, v in got.items():
        if v is not None:
            _same(v, ref[k].numpy(), k)
    assert torch.equal(ref["s24_sum"],
                       ref["s24"].sum(dim=1).to(torch.int32))


def _bad(kind):
    args, kw, _ = tail_case("q28", False, False, False, 48, 4, seed=1)
    planes, gains, ends, delay, ring = args
    planes = list(planes)
    if kind == "dtype":
        planes[1] = planes[1].to(torch.int64)
    elif kind == "gain_dtype":
        gains = gains.float()
    elif kind == "device":
        planes = [p.to("meta") for p in planes]
    elif kind == "shape":
        planes[2] = planes[2][:-1].contiguous()
    elif kind == "gain_shape":
        gains = gains[1:].contiguous()
    elif kind == "contiguous":
        planes[0] = torch.zeros(4, 48, dtype=torch.int32).t()
    elif kind == "ends":
        ends = torch.tensor([10, 20, 30, 47], dtype=torch.int32)
    elif kind == "delay":
        delay = delay.clone()
        delay[0] = D + 1
    elif kind == "ring":
        ring = ring[:, :, :2].contiguous()
    elif kind == "no_ring":
        ring = None
    elif kind == "flags":
        kw["enabled"] = kw["enabled"][:-1]
    elif kind == "spdif":
        kw["spdif"] = 3
    return (planes, gains, ends, delay, ring), kw


@pytest.mark.parametrize("kind", ["dtype", "gain_dtype", "device", "shape",
                                  "gain_shape", "contiguous", "ends", "delay",
                                  "ring", "no_ring", "flags", "spdif"])
def test_tail_refuses(kind):
    """The wrapper and the plain version raise on a wrong dtype, device or
    shape, non-contiguous planes, ends that do not tile the rows, delays
    past the ring, rings of another shape and bad flags."""
    args, kw = _bad(kind)
    for fn in (segment_tail, segment_tail_plain):
        with pytest.raises((TypeError, ValueError)):
            fn(*args, **kw)


@pytest.mark.parametrize("platform,rate", [(Platform.RP2350, 48000.0),
                                           (Platform.RP2040, 44100.0)])
def test_segment_calls_the_tail_once_and_counts_no_launch(monkeypatch,
                                                          platform, rate):
    """A CPU segment of either chain goes through ``segment_tail`` once (the
    plain version: LAUNCHES["tail"] stays where it was), and no Q15 gain
    call is left on the path."""
    from dspi_tpu_torch.chain import packet_geometry

    calls = []
    tail = pipeline.segment_tail

    def spy(*a, **k):
        calls.append(a[0][0].dtype)
        return tail(*a, **k)

    monkeypatch.setattr(pipeline, "segment_tail", spy)
    sched = packet_geometry(44100, 2)[1] if rate == 44100.0 else None
    eng = Engine(full_chain_config(platform, rate), 2, block_size=48,
                 emit="reduced", device="cpu", schedule=sched)
    shape = (2, sum(sched), 2) if sched else (2, 2, 48, 2)
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -20000, 20000, size=shape).astype(np.int32))
    n0 = dict(LAUNCHES)
    out = eng.process(x)
    assert calls == [torch.int32 if platform == Platform.RP2040
                     else torch.float32]
    assert dict(LAUNCHES) == n0
    assert {"peaks", "s24_sum", "pdm_sum"} <= set(out)
