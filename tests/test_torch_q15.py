"""The Q28 chain's Q15 products (``kernels.q15_cuda``) on the CPU: the
plain matrix mix and output gains word for word against ``qmath.q15_mul``
and the golden model's scalar ``q15_mul``, on edge samples and gains, both
gain layouts, uniform packets and the 44/45 schedule; the wrappers'
refusals; and Q28 segments of ``Engine`` and ``HeteroServer`` through the
wrappers equal to the per-product form they replace.  The kernel itself
is held to the plain versions on the card (test_torch_cuda.py)."""

import functools

import numpy as np
import pytest
import torch

from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, HeteroServer, pipeline
from dspi_tpu_torch.configs import full_chain_config, hetero_variants
from dspi_tpu_torch.core import qmath
from dspi_tpu_torch.golden import qref
from dspi_tpu_torch.kernels import LAUNCHES
from dspi_tpu_torch.kernels.q15_cuda import (q15_gain, q15_gain_plain,
                                             q15_mix, q15_mix_plain)
from dspi_tpu_torch.kernels.tail_cuda import segment_tail
from dspi_tpu_torch.params.types import Crosspoint

I32_MIN, I32_MAX = -2**31, 2**31 - 1
EDGES = np.array([0, 1, -1, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 32768, -32768,
                  -32769, 0x7FFF8000, I32_MIN, I32_MAX, I32_MIN + 1,
                  -0x10000, 0x12345678], np.int64).astype(np.int32)
GAIN_EDGES = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFF, 32768, -1, -32768,
                       -32769, -0x7FFF, I32_MIN, I32_MAX, 0x10000, 26028],
                      np.int64).astype(np.int32)


def _plane(rng, T, B):
    """int32 [T, B] over the whole range, the edge samples in its first
    rows and down its first lane."""
    x = rng.integers(I32_MIN, I32_MAX + 1, size=(T, B), dtype=np.int64)
    x = x.astype(np.int32)
    x.flat[:min(len(EDGES), x.size)] = EDGES[:x.size]
    x[:min(T, len(EDGES)), 0] = EDGES[:T]
    return torch.from_numpy(x)


def _gains(rng, shape):
    g = rng.choice(GAIN_EDGES, size=shape).astype(np.int32)
    g.flat[:min(len(GAIN_EDGES), g.size)] = GAIN_EDGES[:g.size]
    return torch.from_numpy(np.ascontiguousarray(g))


def _golden(s, g):
    """qref.q15_mul over two broadcast int32 tensors, element by element."""
    s, g = torch.broadcast_tensors(s, g)
    out = [qref.q15_mul(int(a), int(b))
           for a, b in zip(s.reshape(-1).tolist(), g.reshape(-1).tolist())]
    return torch.tensor(out, dtype=torch.int32).reshape(s.shape)


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("T,B", [(16, 16), (7, 5), (1, 1)])
def test_mix_plain_equals_products(lane, T, B):
    """Every enabled output is q15(bl, g0) + q15(br, g1) with int32 wrap,
    word for word with qmath.q15_mul and the golden model; disabled ones
    are zeros."""
    rng = np.random.default_rng(T * 31 + B + lane)
    bl, br = _plane(rng, T, B), _plane(rng, T, B).flip(0).contiguous()
    enabled = (True, False, True, True, True)
    gains = _gains(rng, (2, 5, B) if lane else (2, 5))
    got = q15_mix(bl, br, gains, enabled)
    assert len(got) == 5
    for o, on in enumerate(enabled):
        if not on:
            assert torch.equal(got[o], torch.zeros_like(bl))
            continue
        want = qmath.q15_mul(bl, gains[0, o]) + qmath.q15_mul(br, gains[1, o])
        assert torch.equal(got[o], want), o
        gold = (_golden(bl, gains[0, o]).long() + _golden(br, gains[1, o])
                + 2**31) % 2**32 - 2**31
        assert torch.equal(got[o], gold.to(torch.int32)), o


def test_q15_mul_edges_match_golden():
    """Every edge sample against every edge gain."""
    s = torch.from_numpy(EDGES)[:, None]
    g = torch.from_numpy(GAIN_EDGES)[None, :]
    assert torch.equal(qmath.q15_mul(s, g), _golden(s, g))
    assert torch.equal(qmath.fast_mul_q15(s, g), _golden(s, g))


def _ends(lengths):
    return torch.tensor(np.cumsum(lengths), dtype=torch.int32)


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("lengths,with_ends", [
    ((3, 3, 3, 3), False), ((3, 3, 3, 3), True), ((5,), False),
    ((44, 45), True), ((2, 3, 2, 3, 1), True)],
    ids=["uniform", "uniform-ends", "one", "44/45", "ragged"])
def test_gain_plain_equals_products(lane, lengths, with_ends):
    """Each row times its packet's gain, in place, word for word with
    qmath.q15_mul and the golden model; uniform packets with or without
    their ends, and schedules with them."""
    T, B = sum(lengths), 6
    rng = np.random.default_rng(T + lane)
    x = _plane(rng, T, B)
    gain = _gains(rng, (len(lengths), B if lane else 1))
    rows = torch.repeat_interleave(gain, torch.tensor(lengths), dim=0)
    want = qmath.q15_mul(x, rows)
    assert torch.equal(want, _golden(x, rows))
    ends = _ends(lengths) if with_ends else None
    y = x.clone()
    got = q15_gain(y, gain, ends)
    assert got is y
    assert torch.equal(y, want)
    assert torch.equal(q15_gain_plain(x.clone(), gain, ends), want)


def test_cpu_calls_launch_nothing():
    """The plain versions count no launch, and a chain with no enabled
    output mixes to zeros."""
    rng = np.random.default_rng(3)
    bl = _plane(rng, 4, 8)
    before = dict(LAUNCHES)
    out = q15_mix(bl, bl, _gains(rng, (2, 3)), (False, False, False))
    assert all(torch.equal(o, torch.zeros_like(bl)) for o in out)
    q15_gain(bl, _gains(rng, (2, 1)))
    q15_mix_plain(bl, bl, _gains(rng, (2, 1, 8)), (True,))
    assert dict(LAUNCHES) == before


def _bad_mix(bad):
    bl = torch.zeros(8, 12, dtype=torch.int32)
    br = torch.zeros(8, 12, dtype=torch.int32)
    g = torch.zeros(2, 3, dtype=torch.int32)
    if bad == "dtype":
        g = g.long()
    elif bad == "device":
        g = g.to("meta")
    elif bad == "shape":
        g = torch.zeros(2, 3, 5, dtype=torch.int32)
    elif bad == "layout":
        br = torch.zeros(12, 8, dtype=torch.int32).t()
    elif bad == "planes":
        br = torch.zeros(8, 13, dtype=torch.int32)
    elif bad == "outputs":
        g = torch.zeros(2, 6, dtype=torch.int32)
        return bl, br, g, (True,) * 6
    return bl, br, g, (True, False, True)


def _bad_gain(bad):
    x = torch.zeros(12, 8, dtype=torch.int32)
    g = torch.zeros(4, 1, dtype=torch.int32)
    ends = None
    if bad == "dtype":
        x = x.float()
    elif bad == "device":
        g = g.to("meta")
    elif bad == "shape":
        g = torch.zeros(4, 3, dtype=torch.int32)
    elif bad == "layout":
        g = torch.zeros(8, 4, dtype=torch.int32).t()
    elif bad == "planes":
        g = torch.zeros(5, 1, dtype=torch.int32)   # 12 rows, 5 packets
    elif bad == "outputs":
        ends = torch.tensor([3, 6, 9, 11], dtype=torch.int32)
    return x, g, ends


@pytest.mark.parametrize("fn", ["q15_mix", "q15_gain"])
@pytest.mark.parametrize("bad", ["dtype", "device", "shape", "layout",
                                 "planes", "outputs"])
def test_wrappers_refuse(fn, bad):
    """Another dtype or device, a wrong shape, a non-contiguous layout,
    mismatched planes, more outputs than the kernel takes (mix) or packet
    ends that do not tile the plane (gain) raise."""
    if fn == "q15_mix":
        args, call = _bad_mix(bad), q15_mix
    else:
        args, call = _bad_gain(bad), q15_gain
    with pytest.raises((TypeError, ValueError)):
        call(*args)


def test_wrapper_refuses_unknown_device():
    x = torch.zeros(4, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no Q15 kernel"):
        q15_mix(x, x, torch.zeros(2, 1, dtype=torch.int32, device="meta"),
                (True,))


# ---------------------------------------------------------------- segments

B, NPKT, BLOCK = 4, 2, 48
SCHED = (44, 45)


def _parent_mix(bl, br, gains, enabled):
    """PASS 4 as the chain ran it before the kernel: two q15_mul a live
    output."""
    return [qmath.q15_mul(bl, gains[0, o]) + qmath.q15_mul(br, gains[1, o])
            if on else torch.zeros_like(bl) for o, on in enumerate(enabled)]


def _parent_gain(x, gain, ends=None):
    """An output's gain as the chain ran it before the kernel, out of
    place: a q15_mul over [Npkt, T, B], or over the rows along the
    schedule."""
    T, b = x.shape
    if ends is None:
        return qmath.q15_mul(x.reshape(gain.shape[0], -1, b),
                             gain[:, None, :]).reshape(T, b)
    reps = torch.diff(ends, prepend=ends.new_zeros(1)).long()
    return qmath.q15_mul(x, torch.repeat_interleave(gain, reps, dim=0))


def _parent_tail(planes, gains, ends=None, delay=None, ring=None, **kw):
    """The segment tail with its output gains as the chain ran them before
    the tail kernel, one ``_parent_gain`` a live unmuted output, and the
    rest of the tail at unit Q15 gains (fast_mul_q15(x, 32768) == x for
    every int32 x)."""
    planes = [_parent_gain(x, g, ends) if on and not mute else x
              for x, g, on, mute in zip(planes, gains, kw["enabled"],
                                        kw["muted"])]
    return segment_tail(planes, torch.full_like(gains, 32768), ends, delay,
                        ring, **kw)


def _cfg(kind, i=0):
    cfg = (full_chain_config(Platform.RP2040, 44100.0) if kind == "sched"
           else hetero_variants(2, Platform.RP2040)[i] if kind == "hetero"
           else full_chain_config(Platform.RP2040))
    if kind == "gated":
        cfg.outputs[1].enabled = False
        cfg.outputs[2].mute = True
    if kind == "hetero" and i == 1:
        # a matrix of its own, so the mix's gains are per lane
        cfg.crosspoints[0][2] = Crosspoint(True, True, -3.5)
        cfg.crosspoints[1][0] = Crosspoint(True, False, -1.25)
    return cfg


def _path(kind):
    kw = dict(block_size=BLOCK, emit="full", pdm=False, device="cpu")
    if kind == "hetero":
        return HeteroServer([_cfg(kind, 0), _cfg(kind, 1)],
                            np.array([1, 0, 0, 1]), **kw)
    if kind == "sched":
        return Engine(_cfg(kind), n_streams=B, schedule=SCHED, **kw)
    return Engine(_cfg(kind), n_streams=B, **kw)


@functools.lru_cache(maxsize=None)
def _segments(kind):
    """Two segments of the path through the wrappers and two through the
    parent's products, on the same inputs: (outputs, states, wrapper
    calls a segment, the static chain, the mix's gains' rank).  Only the
    Q15 products are swapped (the output gains' inside the segment tail,
    ``_parent_tail``): both sides compute the outputs' float gains in the
    same batched [nout, Npkt, 1|B] pass.  That pass is held to the
    JAX engine's per-output gains by test_torch_q28.py
    (``test_q28_engine_matches_jax_engine``), test_torch_schedule.py
    (``test_engine_44k1_matches_jax``) and test_torch_grouped.py
    (``test_outputs_match_jax``, per-lane gains on ``hetero``)."""
    rng = np.random.default_rng(0x15)
    shape = (2, sum(SCHED), B) if kind == "sched" else (NPKT, 2, BLOCK, B)
    xs = [rng.integers(-30000, 30000, size=shape).astype(np.int32)
          for _ in range(2)]
    runs, calls, ranks = [], [], []
    for parent in (False, True):
        eng = _path(kind)
        mix, tail = ((_parent_mix, _parent_tail) if parent
                     else (q15_mix, segment_tail))

        def counted_mix(bl, br, gains, enabled, mix=mix):
            calls.append("mix")
            ranks.append(gains.dim())
            return mix(bl, br, gains, enabled)

        def counted_tail(*a, tail=tail, **kw):
            calls.append("tail")
            return tail(*a, **kw)

        saved = pipeline.q15_mix, pipeline.segment_tail
        pipeline.q15_mix, pipeline.segment_tail = counted_mix, counted_tail
        try:
            outs = [eng.process(x) for x in xs]
        finally:
            pipeline.q15_mix, pipeline.segment_tail = saved
        runs.append((outs, eng.state))
    static = eng.static
    return runs, calls[:len(calls) // 2], static, ranks[0]


@pytest.mark.parametrize("kind", ["full", "gated", "hetero", "sched"])
def test_segment_through_wrappers_equals_parent(kind):
    """Q28 segments of Engine (the headline chain; with an output disabled
    and one muted; on the 44/45 schedule) and of HeteroServer (two tenants
    with their own matrices: per-lane mix and gain gains) through the
    wrappers: every output and state word equal to the per-product form
    of the Q15 products (``_segments`` says what covers the float gains),
    one mix call and one segment tail call a segment, the tail gaining
    each live unmuted output."""
    runs, calls, st, rank = _segments(kind)
    (got, got_st), (want, want_st) = runs
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for f, a, b in zip(want_st._fields, want_st, got_st):
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f
    gains = [o for o in range(st.n_outputs)
             if st.output_enabled[o] and not st.output_mute[o]]
    assert gains == ([0, 3, 4] if kind == "gated" else [0, 1, 2, 3, 4])
    assert calls == ["mix", "tail"] * 2
    assert rank == (3 if kind == "hetero" else 2)
