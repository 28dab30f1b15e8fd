"""Tests of the port that need an NVIDIA card; they skip elsewhere.

This file imports neither JAX nor the JAX package, so it runs on a card
host that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dspi_tpu_torch.kernels import LAUNCHES, pdm_cuda
from dspi_tpu_torch.kernels.eq import q28_cascades_plain
from dspi_tpu_torch.kernels.eq_cuda import q28_cascades
from dspi_tpu_torch.kernels.eq_f32 import f32_cascades_plain
from dspi_tpu_torch.kernels.eq_f32_cuda import f32_cascades
from dspi_tpu_torch.kernels.pdm import pdm_words_plain
from dspi_tpu_torch.kernels.xf_cuda import (xf_f32, xf_f32_plain, xf_q28,
                                             xf_q28_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(96, 197), (5, 1), (48, 64), (6, 129),
                                 (6, 257), (6, 17409)])
def test_pdm_kernel_equals_plain(T, B):
    """The CUDA kernel against the plain version: ragged stream counts
    (129, 257, 17409: one stream or a few in the last 128-thread block),
    every machine mode, state rows word for word."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    rng = np.random.default_rng(33 + B)
    x = rng.integers(-(1 << 28), 1 << 28, size=(T, B)).astype(np.int32)
    s = np.zeros((16, B), np.int32)
    s[0:7] = rng.integers(-9000, 9000, size=(7, B))
    s[7] = rng.integers(-2**31, 2**31, size=B, dtype=np.int64)
    s[8] = rng.integers(0, 1025, size=B)          # fade position <= 1024
    # machine rows as the segment-start reactions leave them: enabled
    # streams run with no fade-out pending; disabled ones are fading out
    # (fout >= 1) or stopped (fout == 0)
    s[9] = rng.integers(0, 2, size=B)
    s[10] = np.where(s[9] == 1, 1, rng.integers(0, 2, size=B))
    s[11] = np.where((s[9] == 0) & (s[10] == 1),
                     rng.integers(1, 1025, size=B), 0)
    s[12] = rng.integers(-29500, 29500, size=B)
    s[13:] = rng.integers(-5, 5, size=(3, B))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    want_w, want_s = pdm_words_plain(xt, st)
    n0 = LAUNCHES["pdm"]
    got_w, got_s = pdm_cuda.pdm_words(xt.cuda(), st.cuda())
    torch.cuda.synchronize()
    assert LAUNCHES["pdm"] == n0 + 1
    np.testing.assert_array_equal(got_w.cpu().numpy(), want_w.numpy())
    np.testing.assert_array_equal(got_s.cpu().numpy(), want_s.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("has_loud,has_env,nb,B", [
    (False, False, 3, 197), (True, False, 2, 64), (True, True, 10, 4100),
    (False, True, 0, 33), (True, True, 12, 1)])
def test_eq_q28_kernel_equals_plain(has_loud, has_env, nb, B):
    """The cascade kernel against the plain version: ragged stream counts,
    every pair of loudness bypass flags, a different envelope alpha per
    cascade; outputs, envelopes and states word for word."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    G, tc, T = 4, 48, 96
    nr = (2 if has_loud else 0) + nb
    rng = np.random.default_rng(7 + nb)
    x = rng.integers(-2**31, 2**31, size=(G, T, B), dtype=np.int64)
    cf = rng.integers(-(1 << 27), 1 << 27, size=(G, nr, 5)) >> 2
    s0 = rng.integers(-(1 << 20), 1 << 20, size=(G, 2 * nr + has_env, B))
    a_rms = 260000000 - 9999999 * np.arange(G)
    scal = np.stack([np.arange(G) % 2, np.arange(G) // 2, a_rms,
                     (1 << 28) - a_rms], axis=1)
    args = [torch.from_numpy(v.astype(np.int32))
            for v in (x, cf, s0, scal)]
    kw = dict(nb=nb, has_loud=has_loud, has_env=has_env, tc=tc)
    want = q28_cascades_plain(*args, **kw)
    n0 = LAUNCHES["eq_q28"]
    got = q28_cascades(*[a.cuda() for a in args], **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["eq_q28"] == n0 + 1
    for name, g, w in zip(("y", "env", "state"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(96, 197), (1, 5), (48, 4100), (37, 197),
                                 (16, 65), (5733, 300)])
def test_xf_q28_kernel_equals_plain(T, B):
    """The crossfeed kernel against the plain version, where T is a
    multiple of its 16-sample tile or not (37, the 44.1 kHz path's 5733),
    one tile (16) or less (1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    rng = np.random.default_rng(40 + B)
    l, r = (rng.integers(-2**31, 2**31, size=(T, B), dtype=np.int64)
            for _ in range(2))
    coef = rng.integers(-2**31, 2**31, size=3, dtype=np.int64)
    s4 = rng.integers(-2**31, 2**31, size=(4, B), dtype=np.int64)
    args = [torch.from_numpy(v.astype(np.int32)) for v in (l, r, coef, s4)]
    want = xf_q28_plain(*args)
    n0 = LAUNCHES["xf_q28"]
    got = xf_q28(*[a.cuda() for a in args])
    torch.cuda.synchronize()
    assert LAUNCHES["xf_q28"] == n0 + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("lane,sched", [
    (True, None), (False, (44, 45, 44, 45)), (False, (44, 1, 45, 7)),
    (True, (45, 44, 1)), (True, (1,))],
    ids=["lane_cf", "sched", "sched_1", "lane_cf+sched", "lane_cf+T1"])
@pytest.mark.parametrize("has_loud,has_env,nb,B", [
    (True, True, 10, 4100), (False, False, 10, 197), (False, True, 0, 33),
    (True, False, 2, 64), (True, True, 12, 17), (False, False, 10, 23),
    (True, False, 1, 40), (True, True, 0, 50)])
def test_eq_q28_kernel_modes_equal_plain(has_loud, has_env, nb, B, lane,
                                         sched):
    """The cascade kernel's per-lane (lane_cf) and packet-schedule modes
    against the plain version: coefficients, bypass flags (mixed within a
    warp) and envelope alphas that differ lane by lane; a periodic 44/45
    schedule and one with a 1-sample packet; word for word.  For the
    per-lane kernel (one warp of streams a block, its bands skewed across
    samples): fewer streams than a warp (17) and stream counts that are no
    multiple of 32; 14 rows (loudness + 12 bands + envelope); loudness
    rows only (nb=0); T = 1, shorter than the skew's fill and drain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    G, tc = 4, 48
    T = sum(sched) if sched else 2 * tc
    nr = (2 if has_loud else 0) + nb
    rng = np.random.default_rng(70 + nb)
    x = rng.integers(-2**31, 2**31, size=(G, T, B), dtype=np.int64)
    s0 = rng.integers(-(1 << 20), 1 << 20, size=(G, 2 * nr + has_env, B))
    if lane:
        cf = rng.integers(-(1 << 27), 1 << 27, size=(G, nr, 5, B)) >> 2
        a_rms = rng.integers(200000000, 268000000, size=(G, B))
        scal = np.stack([rng.integers(0, 2, size=(G, B)),
                         rng.integers(0, 2, size=(G, B)), a_rms,
                         (1 << 28) - a_rms], axis=1)
    else:
        cf = rng.integers(-(1 << 27), 1 << 27, size=(G, nr, 5)) >> 2
        a_rms = 260000000 - 9999999 * np.arange(G)
        scal = np.stack([np.arange(G) % 2, np.arange(G) // 2, a_rms,
                         (1 << 28) - a_rms], axis=1)
    args = [torch.from_numpy(v.astype(np.int32))
            for v in (x, cf, s0, scal)]
    kw = dict(nb=nb, has_loud=has_loud, has_env=has_env, tc=tc, sched=sched)
    want = q28_cascades_plain(*args, **kw)
    n0 = dict(LAUNCHES)
    got = q28_cascades(*[a.cuda() for a in args], **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["eq_q28"] == n0.get("eq_q28", 0) + 1
    assert LAUNCHES["eq_q28_lane_cf"] == n0.get("eq_q28_lane_cf", 0) + lane
    assert LAUNCHES["eq_q28_sched"] == n0.get("eq_q28_sched", 0) + bool(sched)
    for name, g, w in zip(("y", "env", "state"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(96, 197), (48, 4100), (5, 64), (49, 1)])
def test_xf_q28_kernel_per_lane_equals_plain(T, B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    rng = np.random.default_rng(50 + B)
    l, r = (rng.integers(-2**31, 2**31, size=(T, B), dtype=np.int64)
            for _ in range(2))
    coef = rng.integers(-2**31, 2**31, size=(3, B), dtype=np.int64)
    s4 = rng.integers(-2**31, 2**31, size=(4, B), dtype=np.int64)
    args = [torch.from_numpy(v.astype(np.int32)) for v in (l, r, coef, s4)]
    want = xf_q28_plain(*args)
    got = xf_q28(*[a.cuda() for a in args])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())



def f32_rows(rng, shape):
    """Float cascade coefficient rows [..., 11] of stable filters: SVF
    columns (a1, a2, a3 from a tuning g and a damping k; mix terms in
    +-1.5) and TDF2 columns (b0..b2 in +-0.6; a conjugate pole pair inside
    radius 0.98), so that a row is stable whatever kind reads it."""
    g = rng.uniform(0.02, 1.2, shape)
    k = rng.uniform(0.4, 2.0, shape)
    a1 = 1.0 / (1.0 + g * (g + k))
    r = rng.uniform(0.5, 0.98, shape)
    th = rng.uniform(0.05, 3.0, shape)
    cols = [a1, g * a1, g * g * a1, *rng.uniform(-1.5, 1.5, (3,) + shape),
            *rng.uniform(-0.6, 0.6, (3,) + shape), -2 * r * np.cos(th),
            r * r]
    return np.stack(cols, axis=-1).astype(np.float32)


# band kinds of the float cascades: TDF2, SVF low-pass, high-pass,
# peaking, shelf, and SKIP (a pass-through that pads)
F32_KINDS = (1, 2, 3, 4, 5, 0)


def f32_args(rng, G, T, B, nb, has_loud, has_env, lane, mixed=True):
    """Inputs of the float cascades (kernels/eq_f32.py): kinds that differ
    across cascades at a band (``mixed``) or the headline's for every
    cascade; bypass flags in every pair, per cascade or lane by lane; on
    cascade 0's first 4 lanes a silent input, zero band states and a tiny
    envelope, so that the 1e-30 flush fires at a packet end.  Returns ((x, cf, s0, scal) as
    CPU tensors, kinds)."""
    head = (3, 4, 4, 5, 4, 4, 4, 1, 1, 1, 2, 5)
    kinds = tuple(tuple(F32_KINDS[(g + j) % 6] if mixed else head[j]
                        for j in range(nb)) for g in range(G))
    nr = (2 if has_loud else 0) + nb
    x = rng.uniform(-1.0, 1.0, (G, T, B)).astype(np.float32)
    s0 = rng.uniform(-0.1, 0.1, (G, 2 * nr + has_env, B)).astype(np.float32)
    if has_env:
        s0[:, -1] = rng.uniform(0.0, 0.3, (G, B))
        x[0, :, :4] = 0.0
        s0[0, :, :4] = 0.0
        s0[0, -1, :4] = 1e-31
    cf = np.moveaxis(f32_rows(rng, (B, G, nr)), 0, -1) if lane \
        else f32_rows(rng, (G, nr))
    if lane:
        byp = rng.integers(0, 2, (2, G, B)).astype(np.float32)
        a = rng.uniform(0.99, 0.9999, (G, B)).astype(np.float32)
    else:
        byp = np.stack([np.arange(G) % 2, np.arange(G) // 2 % 2]).astype(
            np.float32)
        a = np.linspace(0.995, 0.9999, G).astype(np.float32)
    scal = np.stack([byp[0], byp[1], a, np.float32(1.0) - a], axis=1)
    args = tuple(torch.from_numpy(np.ascontiguousarray(v))
                 for v in (x, cf, s0, scal))
    return args, kinds


@pytest.mark.cuda
@pytest.mark.parametrize("lane,sched", [
    (False, None), (True, None), (False, (44, 45, 44, 45)),
    (True, (45, 44, 1)), (False, (1,))],
    ids=["scalar", "lane", "sched", "lane+sched_1", "T1"])
@pytest.mark.parametrize("has_loud,has_env,nb,G,B,mixed", [
    (True, True, 10, 2, 4100, False), (False, False, 10, 9, 197, False),
    (True, True, 12, 6, 65, True), (False, True, 0, 2, 33, True),
    (True, False, 3, 7, 64, True), (False, False, 6, 6, 1, True)])
def test_eq_f32_kernel_equals_plain(has_loud, has_env, nb, G, B, mixed,
                                    lane, sched):
    """The float cascade kernel against the plain version, bit for bit:
    the headline's master call (G=2, loudness, 10 bands, envelope) and
    output call (G=9, 10 bands), and band kinds that differ across
    cascades (SKIP rows among them); bypass flags in every pair, per
    cascade or lane by lane; per-cascade and per-lane coefficients;
    uniform packets, a 44/45 schedule, one with a 1-sample packet, T = 1;
    the envelope's packet-end flush; ragged stream counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    tc = 48
    T = sum(sched) if sched else 2 * tc
    rng = np.random.default_rng(90 + nb + G)
    args, kinds = f32_args(rng, G, T, B, nb, has_loud, has_env, lane, mixed)
    kw = dict(kinds=kinds, has_loud=has_loud, has_env=has_env,
              tc=1 if T == 1 else tc, sched=sched)
    want = f32_cascades_plain(*args, **kw)
    n0 = dict(LAUNCHES)
    got = f32_cascades(*[a.cuda() for a in args], **kw)
    torch.cuda.synchronize()
    # one launch a distinct band-kinds signature of the cascades
    n = len(set(kinds))
    assert LAUNCHES["eq_f32"] == n0.get("eq_f32", 0) + n
    assert LAUNCHES["eq_f32_lane"] == n0.get("eq_f32_lane", 0) + n * lane
    assert LAUNCHES["eq_f32_sched"] == (n0.get("eq_f32_sched", 0)
                                        + n * bool(sched))
    for name, g, w in zip(("y", "env", "state"), got, want):
        if w is None:
            assert g is None
            continue
        assert torch.isfinite(w).all(), name
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.cuda
def test_eq_f32_launches_once_a_signature():
    """A call whose cascades carry three band-kinds signatures (two
    cascades share one) launches three times, each launch on its own
    cascades in place: the result equals the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    rng = np.random.default_rng(95)
    args, _ = f32_args(rng, 4, 96, 130, 4, True, True, False)
    kinds = ((1, 4, 0, 5), (3, 3, 2, 1), (1, 4, 0, 5), (0, 0, 0, 0))
    kw = dict(kinds=kinds, has_loud=True, has_env=True, tc=48)
    want = f32_cascades_plain(*args, **kw)
    n0 = LAUNCHES["eq_f32"]
    got = f32_cascades(*[a.cuda() for a in args], **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["eq_f32"] == n0 + 3
    for name, g, w in zip(("y", "env", "state"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.cuda
def test_eq_f32_entry_refuses_another_signature():
    """The C entry of a signature's library refuses any other packed
    signature with cudaErrorInvalidValue (1) and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    from dspi_tpu_torch.kernels import eq_f32_cuda

    rng = np.random.default_rng(96)
    (x, cf, s0, scal), kinds = f32_args(rng, 2, 8, 64, 3, False, False,
                                        False, mixed=False)
    sig = eq_f32_cuda.signature(kinds[0], False, False, False)
    fn = eq_f32_cuda.bind(eq_f32_cuda.libraries([sig])[sig])
    x, cf, s0, scal = (v.cuda() for v in (x, cf, s0, scal))
    y = torch.full_like(x, 7.0)
    s_out = torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream
    for code in (sig, eq_f32_cuda.signature((1, 1, 1), False, False, False),
                 sig | 1 << 6):
        rc = fn(code, x.data_ptr(), cf.data_ptr(), s0.data_ptr(),
                scal.data_ptr(), None, None, y.data_ptr(), None,
                s_out.data_ptr(), 2, 8, 64, 0, stream)
        torch.cuda.synchronize()
        if code == sig:
            assert rc == 0
            want = f32_cascades_plain(*(v.cpu() for v in (x, cf, s0, scal)),
                                      kinds=kinds)
            np.testing.assert_array_equal(y.cpu().numpy(), want[0].numpy())
            y.fill_(7.0)
        else:
            assert rc == 1                  # cudaErrorInvalidValue
            assert bool((y == 7.0).all())   # nothing ran


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,lane", [(96, 197, False), (1, 5, False),
                                      (48, 4100, True), (37, 197, True),
                                      (5733, 300, False), (5, 64, True)])
def test_xf_f32_kernel_equals_plain(T, B, lane):
    """The float crossfeed kernel against the plain version, bit for bit,
    with [3] and per-lane [3, B] coefficients, where T is a multiple of
    its 16-sample tile or not, or shorter than one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    rng = np.random.default_rng(60 + B)
    l, r = (rng.uniform(-1, 1, (T, B)).astype(np.float32) for _ in range(2))
    shape = (B,) if lane else ()
    coef = np.stack([rng.uniform(0.01, 0.3, shape),
                     rng.uniform(0.6, 0.99, shape),
                     rng.uniform(-0.9, -0.1, shape)]).astype(np.float32)
    s4 = rng.uniform(-0.5, 0.5, (4, B)).astype(np.float32)
    args = [torch.from_numpy(v) for v in (l, r, coef, s4)]
    want = xf_f32_plain(*args)
    n0 = LAUNCHES["xf_f32"]
    got = xf_f32(*[a.cuda() for a in args])
    torch.cuda.synchronize()
    assert LAUNCHES["xf_f32"] == n0 + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bit_depth", [16, 24])
def test_deframe_on_card_equals_cpu(bit_depth):
    """The on-device deframe on the card: the same planes as on the CPU,
    on the payload's device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch.kernels.deframe import make_pre

    rng = np.random.default_rng(5 + bit_depth)
    B, npkt, block = 4100, 3, 48
    if bit_depth == 16:
        fed = rng.integers(-2**31, 2**31, size=(B, npkt * block),
                           dtype=np.int64).astype(np.int32)
    else:
        fed = rng.integers(0, 256, size=(B, npkt * block * 6),
                           dtype=np.int64).astype(np.uint8)
    pre = make_pre(npkt, block, bit_depth)
    want = pre(torch.from_numpy(fed))
    got = pre(torch.from_numpy(fed).cuda())
    assert got.is_cuda and got.shape == (npkt, 2, block, B)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_chained_runner_on_card_equals_cpu():
    """A ChainedRunner on the Q28 chain fed payload words (pre=make_pre),
    on the card and on the CPU: folds, peaks, clips and every state word
    equal; the batch in flight is waited for on its event."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.kernels.deframe import make_pre
    from dspi_tpu_torch.runtime.executor import ChainedRunner

    rng = np.random.default_rng(77)
    B, depth, npkt = 16, 2, 6           # 12 ms: past the 10 ms lookahead
    batches = [rng.integers(-2**31, 2**31, size=(depth, B, npkt * 48),
                            dtype=np.int64).astype(np.int32)
               for _ in range(2)]
    results = []
    for dev in ("cuda", "cpu"):
        eng = Engine(full_chain_config(Platform.RP2040), n_streams=B,
                     emit="reduced", wire=True, device=dev)
        r = ChainedRunner(eng, depth=depth, pre=make_pre(npkt, 48))
        first = r.feed(batches[0])
        done = r.feed(batches[1])
        assert done is first
        if dev == "cuda":
            assert r._inflight[0][1] is not None    # an event a batch
        last = r.drain()
        results.append((first, last, eng.state))
    (f0, l0, s0), (f1, l1, s1) = results
    assert l1[1][2:].ne(0).any(), "the outputs are silent"
    for a, b in zip(f0 + l0, f1 + l1):
        assert torch.equal(a.cpu(), b)
    for f, a, b in zip(s1._fields, s0, s1):
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a.cpu(), b), f


@pytest.mark.cuda
@pytest.mark.parametrize("sched", [None, (44,) * 9 + (45,)],
                         ids=["uniform", "cadence"])
def test_eq_q28_schedule_upload_opens_the_sched_span(sched):
    """A Q28 cascade call with the envelope on a packet schedule uploads
    its packet ends inside ``dspi.sched``; one on uniform packets uploads
    none and opens no such span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    from torch.profiler import ProfilerActivity, profile

    G, nb, B, tc = 2, 10, 64, 45
    T = sum(sched) if sched else 2 * tc
    nr = 2 + nb
    rng = np.random.default_rng(441)
    x = rng.integers(-2**31, 2**31, size=(G, T, B), dtype=np.int64)
    cf = rng.integers(-(1 << 27), 1 << 27, size=(G, nr, 5)) >> 2
    s0 = np.zeros((G, 2 * nr + 1, B))
    a_rms = 260000000 - 9999999 * np.arange(G)
    scal = np.stack([np.zeros(G), np.zeros(G), a_rms, (1 << 28) - a_rms],
                    axis=1)
    args = [torch.from_numpy(v.astype(np.int32)).cuda()
            for v in (x, cf, s0, scal)]
    kw = dict(nb=nb, has_loud=True, has_env=True, tc=tc, sched=sched)
    q28_cascades(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        q28_cascades(*args, **kw)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert ("dspi.sched" in names) == (sched is not None)


@pytest.mark.cuda
def test_a_span_has_no_device_side_twin():
    """A span (``runtime.telemetry.span``) under a profile with CUDA
    activity is one host event: no ``dspi.*`` device event, so a trace's
    device operations stay what the card ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA activity has no CPU form")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dspi_tpu_torch.runtime.telemetry import SPAN_PREFIX, span

    x = torch.ones(4096, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("dspi.probe"):
            y = x * 2 + 1
        torch.cuda.synchronize()
    evs = prof.events()
    host = [e for e in evs if e.name == "dspi.probe"
            and e.device_type != DeviceType.CUDA]
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    assert len(host) == 1
    assert dev and not [e for e in dev if e.name.startswith(SPAN_PREFIX)]
    assert torch.equal(y, torch.full_like(x, 3.0))


# lev_cases.gain_edges' packets and how they are passed: one-sample
# packets by count or by their ends, the 44/45 schedule with one-sample
# packets by its ends
_EDGES = {"edges": ("ones", False), "edges_ends": ("ones", True),
          "edges_one": ("one", True)}


def _phase(chain, npkt, B, kind, lane, seed):
    """``lev_cases.phase_case``'s inputs (``gain_edges``' for an ``_EDGES``
    kind, B and lane then theirs) as CPU tensors, the packet ends (None
    for uniform packets) and the case itself."""
    from lev_cases import gain_edges, phase_case

    if kind in _EDGES:
        c = gain_edges(chain == "q28", npkt, _EDGES[kind][0], seed)
        by_ends = _EDGES[kind][1]
    else:
        c = phase_case(chain == "q28", npkt, B, kind, lane, seed)
        by_ends = kind != "uniform"
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()
         if k != "sched"}
    ends = torch.from_numpy(np.cumsum(c["sched"]).astype(np.int32)) \
        if by_ends else None
    return t, int(c["sched"].sum()), ends, c


def _card(v):
    return None if v is None else v.cuda()


def _same_bits(got, want, what, lanes=None):
    """``got`` on the card equals ``want`` bit for bit (over ``lanes``, a
    bool mask of the last axis, where given)."""
    assert (got is None) == (want is None), what
    if want is not None:
        assert got.is_cuda and got.dtype == want.dtype, what
        got, want = got.cpu(), want.cpu()
        if lanes is not None:
            got, want = got[..., lanes], want[..., lanes]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            what


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["float", "q28"])
@pytest.mark.parametrize("npkt,B,kind,lane", [
    (128, 16384, "uniform", False), (128, 16384, "uniform", True),
    (178, 17408, "44k1", False), (178, 17408, "44k1", True),
    (20, 65, "one", True), (1, 1, "uniform", False), (17, 5, "uniform", False),
    (24, None, "edges", True), (24, None, "edges_ends", True),
    (20, None, "edges_one", True)])
def test_lev_kernel_equals_plain(chain, npkt, B, kind, lane):
    """The leveller's packet-rate kernel (``lev_gain``: the gain computer,
    the smoothing recurrence and the linear gain) on the card against its
    plain version on the CPU and on the card, bit for bit: the cells'
    [128, 16,384] and the grouped 44.1 kHz [178, 17,408], a schedule with
    one-sample packets, scalar and per-lane parameters, ragged lane counts,
    ``lev_cases.phase_case``'s envelopes (0, denormal, under the gate,
    across the knee); one launch a call.  The ``_EDGES`` kinds put
    ``lev_cases.gain_edges``' edges through the recurrence: targets of 0,
    -0, +-1e-40, +-the smallest normal, +-3e38, 1e30; alphas of exactly 0,
    1 and 0.5; start gains of +-1e-40, the smallest normal, +-3.3e38; and
    the cancelling lane, whose first sum the kernel gives denormal.  There
    the linear gains are compared on the lanes in ``exp2_f32``'s domain
    (``lev_cases.exp2_domain``), the smoothed gain on all."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    from lev_cases import denormal_first, exp2_domain

    from dspi_tpu_torch.kernels.lev_cuda import lev_gain, lev_gain_plain

    t, ttot, ends, c = _phase(chain, npkt, B, kind, lane,
                              seed=npkt + (B or 0))
    live = torch.from_numpy(exp2_domain(c)) if kind in _EDGES else None
    args = [t[k] for k in ("env_l", "env_r", "lev", "gdb0", "g0")]
    want = lev_gain_plain(*args, ttot, ends)
    n0 = LAUNCHES["lev_gain"]
    got = lev_gain(*[a.cuda() for a in args], ttot, _card(ends))
    torch.cuda.synchronize()
    assert LAUNCHES["lev_gain"] == n0 + 1
    for name, g, w in zip(("g_cur", "lev_gain_db", "lev_gain",
                           "lev_gain_prev"), got, want):
        _same_bits(g, w, name, None if name == "lev_gain_db" else live)
    plain_card = lev_gain_plain(*[a.cuda() for a in args], ttot,
                                _card(ends))
    for name, g, w in zip(("g_cur", "lev_gain_db"), plain_card, want):
        _same_bits(g, w, f"plain on the card: {name}",
                   None if name == "lev_gain_db" else live)
    assert LAUNCHES["lev_gain"] == n0 + 1
    if kind in ("edges", "edges_ends"):
        # the first packet alone: its smoothed gain is the cancelling
        # lane's denormal sum, on the card as on the CPU
        first = [args[0][:1], args[1][:1], *args[2:]]
        got1 = lev_gain(*[a.cuda() for a in first], 1)
        want1 = lev_gain_plain(*first, 1)
        _same_bits(got1[1], want1[1], "first packet: lev_gain_db")
        assert denormal_first(got1[1].cpu()[None].numpy(), lane=0)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["float", "q28"])
@pytest.mark.parametrize("npkt,B,kind,lane,lookahead", [
    (128, 1024, "uniform", False, True), (130, 129, "44k1", True, True),
    (20, 65, "one", True, True), (2, 5, "uniform", False, True),
    (12, 64, "uniform", True, False), (1, 1, "uniform", False, True),
    (9, 257, "uniform", False, True)])
def test_lev_apply_kernel_equals_plain(chain, npkt, B, kind, lane,
                                       lookahead):
    """The leveller's sample-rate kernel (``lev_apply``: ramp, lookahead,
    limiter, gain) on the card against its plain version on the CPU and
    on the card, bit for bit, outputs and ring: uniform packets past the
    480-sample ring, segments shorter than it (the new ring keeps part of
    the old), the 44/45 schedule and one with one-sample packets,
    lookahead off, ragged lane counts; gains above unity against samples
    at the limiter's ceiling; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    from dspi_tpu_torch.kernels.lev_cuda import (lev_apply, lev_apply_plain,
                                                 lev_gain_plain)

    t, ttot, ends, _ = _phase(chain, npkt, B, kind, lane,
                              seed=7 * npkt + B)
    g_cur = lev_gain_plain(t["env_l"], t["env_r"], t["lev"], t["gdb0"],
                           t["g0"], ttot, ends)[0]
    args = [t["bl"], t["br"], g_cur, t["g0"],
            t["ring"] if lookahead else None]
    want = lev_apply_plain(*args, ends)
    n0 = LAUNCHES["lev_apply"]
    got = lev_apply(*[_card(a) for a in args], _card(ends))
    torch.cuda.synchronize()
    assert LAUNCHES["lev_apply"] == n0 + 1
    for name, g, w in zip(("out_l", "out_r", "lev_la"), got, want):
        _same_bits(g, w, name)
    plain_card = lev_apply_plain(*[_card(a) for a in args], _card(ends))
    for name, g, w in zip(("out_l", "out_r", "lev_la"), plain_card, want):
        _same_bits(g, w, f"plain on the card: {name}")
    assert LAUNCHES["lev_apply"] == n0 + 1
    unity = (1 << 28) if chain == "q28" else 1.0
    assert bool((g_cur > unity).any())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "contiguous",
                                 "ring"])
def test_lev_kernel_refuses(bad):
    """A tensor on another device, of another dtype, of a wrong shape, not
    contiguous, or a ring of another dtype or lane count raises before any
    launch, in each of the two wrappers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch.kernels.lev_cuda import lev_apply, lev_gain

    t, ttot, _, _ = _phase("q28", 4, 64, "uniform", False, seed=3)
    t = {k: v.cuda() for k, v in t.items()}
    gain = [t[k] for k in ("env_l", "env_r", "lev", "gdb0", "g0")]
    apply = [t["bl"], t["br"], t["env_l"], t["g0"], t["ring"]]
    if bad == "device":
        gain[3], apply[3] = gain[3].cpu(), apply[3].cpu()
    elif bad == "dtype":
        gain[0], apply[0] = gain[0].float(), apply[0].float()
    elif bad == "shape":
        gain[2], apply[2] = gain[2][:9], apply[2][:, :8]
    elif bad == "contiguous":
        gain[1] = gain[1].t().contiguous().t()
        apply[1] = apply[1].t().contiguous().t()
    else:
        gain[4] = gain[4].float()
        apply[4] = apply[4][:, :, :32]
    n0 = LAUNCHES["lev_gain"], LAUNCHES["lev_apply"]
    with pytest.raises((TypeError, ValueError)):
        lev_gain(*gain, ttot)
    with pytest.raises((TypeError, ValueError)):
        lev_apply(*apply)
    assert (LAUNCHES["lev_gain"], LAUNCHES["lev_apply"]) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["float", "q28"])
def test_lev_apply_stays_in_planes(chain):
    """Packet ends that do not tile the segment (one far past it, one
    before zero, one going back) reach ``lev_apply``'s kernel unchecked
    when launched past the wrapper, which reads ends on the CPU only: the
    kernel clamps each packet's rows to the planes, so the launch ends
    without a fault.  The samples it writes are then undefined, but the
    ring's rows that come from the old ring, which no packet end moves,
    equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from lev_cases import RING

    from dspi_tpu_torch.kernels import build
    from dspi_tpu_torch.kernels.lev_cuda import (bind, launch_apply,
                                                 lev_apply_plain,
                                                 lev_gain_plain)

    t, ttot, _, _ = _phase(chain, 4, 64, "uniform", False, seed=11)
    g_cur = lev_gain_plain(t["env_l"], t["env_r"], t["lev"], t["gdb0"],
                           t["g0"], ttot)[0]
    args = [t["bl"], t["br"], g_cur, t["g0"], t["ring"]]
    want = lev_apply_plain(*args)
    bad = torch.tensor([-100, 2**30, 96, 192], dtype=torch.int32)
    got = launch_apply(bind(build.load("lev"))[1], *[a.cuda() for a in args],
                       bad.cuda(), None)
    torch.cuda.synchronize()
    assert [tuple(v.shape) for v in got] == [tuple(v.shape) for v in want]
    keep = RING - ttot                      # the old ring's last rows
    _same_bits(got[2][:, :keep].contiguous(),
               want[2][:, :keep].contiguous(), "lev_la")


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["q28", "float"])
def test_leveller_segment_on_card_equals_cpu(monkeypatch, chain):
    """Two segments of each chain at 256 streams on the card and on the
    CPU.  Each segment launches ``lev_gain`` and ``lev_apply`` once each;
    their outputs in the segment equal their plain versions on their own
    inputs, bit for bit, and ``lev_gain``'s are the state's leveller
    gains.  Q28: ``lev_gain_db``, ``lev_gain`` and the reduced outputs
    equal card vs CPU.  Float (block lowering, whose products round in
    another order on the card, so the envelope the gain computer reads
    differs there): out/s24 within the float chain's 1e-6 relative RMS,
    peaks within 1 LSB, the leveller state within the 3e-6 that
    test_torch_chain.py holds the carried leveller leaves to (2.3e-6 read
    on an H100 for ``lev_gain_db``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, pipeline
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.kernels import lev_cuda

    calls = []

    def recorded(fn, plain):
        def call(*a):
            out = fn(*a)
            calls.append((plain, [_cpu(v) for v in a],
                          [_cpu(v) for v in out]))
            return out
        return call

    monkeypatch.setattr(pipeline, "lev_gain", recorded(
        lev_cuda.lev_gain, lev_cuda.lev_gain_plain))
    monkeypatch.setattr(pipeline, "lev_apply", recorded(
        lev_cuda.lev_apply, lev_cuda.lev_apply_plain))
    B, npkt = 256, 12
    plat = Platform.RP2040 if chain == "q28" else Platform.RP2350
    emit = "reduced" if chain == "q28" else "full"
    engs = [Engine(full_chain_config(plat), n_streams=B, emit=emit,
                   device=d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(91)
    n0 = LAUNCHES["lev_gain"], LAUNCHES["lev_apply"]
    for seg in range(2):
        x = rng.integers(-16000, 16000, size=(npkt, 2, 48, B)).astype(
            np.int32)
        k = len(calls)
        gpu = engs[0].process(x)
        assert (LAUNCHES["lev_gain"], LAUNCHES["lev_apply"]) == (
            n0[0] + seg + 1, n0[1] + seg + 1)
        assert len(calls) == k + 2
        for plain, args, out in calls[k:]:
            for g, w in zip(out, plain(*args)):
                assert (g is None) == (w is None)
                if w is not None:
                    assert torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
        st = engs[0].state
        for f, v in zip(("lev_gain_db", "lev_gain", "lev_gain_prev"),
                        calls[k][2][1:]):
            assert torch.equal(getattr(st, f).cpu(), v), f
        cpu = engs[1].process(x)
        assert set(gpu) == set(cpu)
        if chain == "q28":
            for key in cpu:
                assert torch.equal(gpu[key].cpu(), cpu[key]), key
        else:
            for key in ("out", "s24"):
                g, c = gpu[key].cpu().double(), cpu[key].double()
                err = float((g - c).pow(2).mean().sqrt()
                            / (c.pow(2).mean().sqrt() + 1e-30))
                assert err < 1e-6, (key, err)
            assert (gpu["peaks"].cpu() - cpu["peaks"]).abs().max() <= 1
    st_g, st_c = engs[0].state, engs[1].state
    errs = {}
    for f in ("lev_gain_db", "lev_gain", "lev_gain_prev"):
        g, c = getattr(st_g, f).cpu(), getattr(st_c, f)
        if chain == "q28":
            assert torch.equal(g, c), f
        else:
            errs[f] = float((g.double() - c.double()).pow(2).mean().sqrt()
                            / (c.double().pow(2).mean().sqrt() + 1e-30))
    assert all(e < 3e-6 for e in errs.values()), errs


def _cpu(v):
    """A tensor argument or output on the CPU (ints and None as they
    are)."""
    return v.cpu() if isinstance(v, torch.Tensor) else v


def _q15_case(T, B, lane, sched, seed):
    """A mix and a gain call's arguments on the card: int32 planes over the
    whole range with the edge words in their first rows, gains among the
    edge gains, the 44/45 schedule's ends or uniform 48-sample packets."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def plane():
        x = torch.randint(-2**31, 2**31, (T, B), generator=gen,
                          dtype=torch.int64, device="cuda").to(torch.int32)
        edges = torch.tensor([0, 1, -1, 0x7FFF, 0x8000, 0xFFFF, 32768,
                              -32768, -2**31, 2**31 - 1, 2**31 - 2,
                              -2**31 + 1], dtype=torch.int32, device="cuda")
        n = min(len(edges), B)
        x[:min(T, 12), :n] = edges[:n]
        x[:min(T, 12), 0] = edges[:min(T, 12)]
        return x

    gvals = torch.tensor([0, 1, 0x7FFF, 0x8000, 0xFFFF, 32768, -1, -32768,
                          -2**31, 2**31 - 1, 26028, 0x10000],
                         dtype=torch.int32, device="cuda")

    def gains(*shape):
        idx = torch.randint(0, len(gvals), shape, generator=gen,
                            device="cuda")
        return gvals[idx].contiguous()

    if sched:
        pattern = np.resize(((44,) * 9 + (45,)), T // 44 + 1)
        lengths = pattern[np.cumsum(pattern) <= T]
        lengths[-1] += T - lengths.sum()
        ends = torch.from_numpy(np.cumsum(lengths).astype(np.int32)).cuda()
        npkt = len(lengths)
    else:
        ends, npkt = None, T // 48
    bl, br = plane(), plane()
    mg = gains(2, 5, B) if lane else gains(2, 5)
    og = gains(npkt, B if lane else 1)
    return bl, br, mg, og, ends


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,lane,sched", [
    (6144, 16384, False, False), (6144, 16384, True, False),
    (6144, 17408, False, False), (6144, 17408, True, False),
    (5733, 16384, False, True), (5733, 17408, True, True),
    (96, 4101, True, False), (96, 197, False, True), (48, 3, True, False),
    (48, 1, False, False)])
def test_q15_kernels_equal_plain(T, B, lane, sched):
    """The Q15 mix and gain kernels against their plain versions on the
    card, bit for bit: the Q28 cells' [6144, 16,384] and [6144, 17,408],
    scalar and per-lane gains, the 44/45 schedule's packet ends, lane
    counts that are not a multiple of 4 (the one-lane-a-thread instances),
    all 5 outputs enabled as on the Q28 main paths and then one disabled;
    one launch a call.  At the smaller shapes also
    against the plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.kernels.q15_cuda import (q15_gain, q15_gain_plain,
                                                 q15_mix, q15_mix_plain)

    bl, br, mg, og, ends = _q15_case(T, B, lane, sched, seed=T + B + lane)
    main = tuple(o.enabled for o in full_chain_config(Platform.RP2040)
                 .outputs)
    assert main == (True,) * 5
    for enabled in (main, (True, True, False, True, True)):
        n0 = dict(LAUNCHES)
        got = q15_mix(bl, br, mg, enabled)
        torch.cuda.synchronize()
        assert LAUNCHES["q15_mix"] == n0.get("q15_mix", 0) + 1
        want = q15_mix_plain(bl, br, mg, enabled)
        for o in range(5):
            assert torch.equal(got[o], want[o]), (enabled, o)
        x = got[3]
        y = x.clone()
        out = q15_gain(y, og, ends)
        torch.cuda.synchronize()
        assert out is y
        assert LAUNCHES["q15_gain"] == n0.get("q15_gain", 0) + 1
        assert torch.equal(y, q15_gain_plain(x.clone(), og, ends))
        if T * B <= 96 * 4101:
            cpu = [v.cpu() for v in (bl, br, mg)]
            for g, w in zip(got, q15_mix_plain(*cpu, enabled)):
                assert torch.equal(g.cpu(), w)
            assert torch.equal(y.cpu(), q15_gain_plain(
                x.cpu(), og.cpu(), None if ends is None else ends.cpu()))
        del got, want, x, y
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["mix", "gain"])
@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "contiguous"])
def test_q15_kernels_refuse(fn, bad):
    """A tensor on another device, of another dtype, of a wrong shape or
    not contiguous raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch.kernels.q15_cuda import q15_gain, q15_mix

    x = torch.zeros(96, 64, dtype=torch.int32, device="cuda")
    g = torch.zeros((2, 3) if fn == "mix" else (2, 1), dtype=torch.int32,
                    device="cuda")
    if bad == "device":
        g = g.cpu()
    elif bad == "dtype":
        g = g.long()
    elif bad == "shape":
        g = torch.zeros((2, 3, 7) if fn == "mix" else (2, 7),
                        dtype=torch.int32, device="cuda")
    else:
        x = torch.zeros(64, 96, dtype=torch.int32, device="cuda").t()
    n0 = dict(LAUNCHES)
    with pytest.raises((TypeError, ValueError)):
        if fn == "mix":
            q15_mix(x, x, g, (True, False, True))
        else:
            q15_gain(x, g)
    assert dict(LAUNCHES) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["q28", "q28_hetero", "q28_44k1"])
def test_q28_segment_q15_on_card_equals_cpu(path):
    """Two Q28 segments at 256 streams on the card and on the CPU, every
    output and state word equal: the headline chain, HeteroServer over
    two tenants with their own matrices (per-lane mix and gain gains) and
    the 44/45 schedule; one mix launch and one segment tail launch a
    segment, and no Q15 gain launch: the output gains' Q15 products are
    the tail kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, HeteroServer
    from dspi_tpu_torch.configs import full_chain_config, hetero_variants
    from dspi_tpu_torch.params.types import Crosspoint

    B, npkt, sched = 256, 4, ((44,) * 9 + (45,))
    kw = dict(emit="full", pdm=False)

    def make(dev):
        if path == "q28_hetero":
            cfgs = hetero_variants(2, Platform.RP2040)
            cfgs[1].crosspoints[0][2] = Crosspoint(True, True, -3.5)
            return HeteroServer(cfgs, np.arange(B) % 2, device=dev, **kw)
        if path == "q28_44k1":
            return Engine(full_chain_config(Platform.RP2040, 44100.0), B,
                          schedule=sched, device=dev, **kw)
        return Engine(full_chain_config(Platform.RP2040), B, device=dev, **kw)

    engs = [make(d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(151)
    shape = ((2, sum(sched), B) if path == "q28_44k1"
             else (npkt, 2, 48, B))
    for seg in range(2):
        x = rng.integers(-30000, 30000, size=shape).astype(np.int32)
        n0 = dict(LAUNCHES)
        gpu = engs[0].process(x)
        torch.cuda.synchronize()
        assert LAUNCHES["q15_mix"] - n0.get("q15_mix", 0) == 1
        assert LAUNCHES["q15_gain"] - n0.get("q15_gain", 0) == 0
        assert LAUNCHES["tail"] - n0.get("tail", 0) == 1
        cpu = engs[1].process(x)
        assert set(gpu) == set(cpu)
        for key in cpu:
            assert torch.equal(gpu[key].cpu(), cpu[key]), (seg, key)
    for f, a, b in zip(engs[1].state._fields, engs[0].state, engs[1].state):
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a.cpu(), b), f


def _carry_case(N, A, Ry, S, G, P, seed):
    """Carry arguments on the card: y [N, *A, Ry, G], vx [N, *A, S, G] and
    s0 [*A, S, G] of unit scale; U [(P,) *A, Ry, S] and W with a spectral
    norm of 0.99 (a stable state map whose state rings over the whole
    segment), P matrices on a step axis, or one (P None)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if P is None else (P,)
    W = torch.randn((*lead, *A, S, S), generator=gen, device="cuda")
    W *= 0.99 / torch.linalg.matrix_norm(W, ord=2)[..., None, None]
    U = torch.randn((*lead, *A, Ry, S), generator=gen, device="cuda") / S**.5
    y = torch.randn((N, *A, Ry, G), generator=gen, device="cuda")
    vx = torch.randn((N, *A, S, G), generator=gen, device="cuda")
    s0 = torch.randn((*A, S, G), generator=gen, device="cuda")
    return y, vx, s0, U.contiguous(), W.contiguous()


def _rel_rms(got, want):
    return float((got.double() - want.double()).pow(2).mean().sqrt()
                 / want.double().pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("N,A,Ry,S,G,P", [
    (128, (), 48, 24, 16384, None),       # chain A, a master channel
    (128, (), 96, 4, 16384, None),        # the crossfeed
    (128, (9,), 48, 20, 16384, None),     # the batched outputs
    (147, (), 39, 24, 16384, None),       # 44.1 kHz: 147 blocks of 39
    (147, (9,), 39, 20, 16384, None),
    (128, (8,), 48, 24, 2176, None),      # grouped, K = 8 at 17,408 lanes
    (128, (8, 9), 48, 20, 2176, None),
    (130, (), 45, 24, 16384, 10),         # a periodic schedule, p = 10
    (130, (8,), 90, 4, 2176, 10),
    (40, (), 45, 28, 4099, 40),           # one matrix a packet
    (3, (3,), 7, 2, 1, 3)])
def test_carry_kernel_equals_plain(N, A, Ry, S, G, P):
    """The matrix carry's kernel against its plain version (cuBLAS
    products a step) on the card, at the cells' shapes and in the
    layouts no cell runs: y and sF within 1e-6 relative RMS, room for
    another summation order than the kernel's (an H100 read 0: cuBLAS's
    products matched it bit for bit, PERF.md §6); one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    from dspi_tpu_torch.kernels.carry_cuda import carry, carry_plain

    y, vx, s0, U, W = _carry_case(N, A, Ry, S, G, P, seed=N * G + S)
    want_y = y.clone()
    want_s = carry_plain(want_y, vx, s0, U, W)
    n0 = LAUNCHES["carry"]
    got_s = carry(y, vx, s0, U, W)
    torch.cuda.synchronize()
    assert LAUNCHES["carry"] == n0 + 1
    assert got_s.shape == want_s.shape
    assert _rel_rms(y, want_y) < 1e-6
    assert _rel_rms(got_s, want_s) < 1e-6


def _env_case(npkt, B, alpha, seed):
    """Envelope carry arguments on the card around the flush threshold
    (weighted sums and start values at 0, denormal, float32(1e-30) and its
    neighbours, 1e-31, 1e-29), as ``env_packet_ends`` passes them: aT an
    expanded scalar ("uniform"), [Npkt] (the padded grid), [Npkt, B]
    expanded from [B] ("lane") or [Npkt, B] ("lane_grid")."""
    t = float(np.float32(1e-30))
    edges = torch.tensor([0.0, -0.0, 1e-45, t, float(np.nextafter(
        np.float32(t), np.float32(0))), float(np.nextafter(
            np.float32(t), np.float32(1))), 1e-31, 1e-29, 0.25, 1.0],
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def pick(*shape):
        i = torch.randint(0, len(edges), shape, generator=gen, device="cuda")
        return (edges[i] * torch.rand(shape, generator=gen, device="cuda")
                .round()).contiguous()

    cl, cr, el0, er0 = pick(npkt, B), pick(npkt, B), pick(B), pick(B)
    a = torch.rand((npkt, B), generator=gen, device="cuda")
    aT = {"uniform": a[0, 0].expand(npkt), "grid": a[:, 0].contiguous(),
          "lane": a[0].expand(npkt, B), "lane_grid": a}[alpha]
    return aT, cl, cr, el0, er0


@pytest.mark.cuda
@pytest.mark.parametrize("npkt,B,alpha", [
    (128, 16384, "uniform"), (130, 16384, "grid"), (128, 17408, "lane"),
    (130, 17408, "lane_grid"), (5, 3, "lane")])
def test_env_carry_kernel_equals_plain(npkt, B, alpha):
    """The envelope carry's kernel equals its plain version bit for bit
    (on the card and on the CPU), on the uniform grid and the padded one,
    with one alpha and per lane, across the flush."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    from dspi_tpu_torch.kernels.carry_cuda import env_carry, env_carry_plain

    args = _env_case(npkt, B, alpha, seed=npkt + B)
    n0 = LAUNCHES["env_carry"]
    got = env_carry(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["env_carry"] == n0 + 1
    for want in (env_carry_plain(*args),
                 env_carry_plain(*(v.cpu() for v in args))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               w.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "device", "odd_s", "contiguous",
                                 "env_float64", "env_device"])
def test_carry_kernel_refuses(bad):
    """On the card the wrappers raise, and launch nothing, on float64
    (which the CPU's plain version takes), a tensor left on the CPU, an odd
    state size and a non-contiguous tensor: never the plain loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch.kernels.carry_cuda import carry, env_carry

    args = list(_carry_case(4, (2,), 5, 5 if bad == "odd_s" else 6, 8,
                            None, seed=1))
    env = list(_env_case(4, 8, "lane_grid", seed=1))
    if bad == "float64":
        args = [v.double() for v in args]
    elif bad == "device":
        args[1] = args[1].cpu()
    elif bad == "contiguous":
        args[0] = args[0].transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "env_float64":
        env = [v.double() for v in env]
    elif bad == "env_device":
        env[3] = env[3].cpu()
    n0 = LAUNCHES["carry"], LAUNCHES["env_carry"]
    with pytest.raises((TypeError, ValueError)):
        if bad.startswith("env"):
            env_carry(*env)
        else:
            carry(*args)
    assert (LAUNCHES["carry"], LAUNCHES["env_carry"]) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("rate,n_packets,steps", [(48000.0, 128, 640),
                                                  (44100.0, 130, 718)])
def test_block_segment_carries_in_five_launches(rate, n_packets, steps):
    """One segment of the headline float chain at the cells' packet counts
    on the card: 5 carry launches (4 ``carry``: the master channels, the
    crossfeed, the outputs; 1 ``env_carry``), ``carry_kernel_steps`` grows
    by the layout's 640 / 718 and ``carry_steps`` by 0 (an engagement of
    100%); against the same segment on the CPU, out and s24 within 1e-6
    relative RMS and peaks within 1 LSB, the float chain's card-vs-CPU
    budget (chip_smoke.py's ``float_close``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, mxu, packet_geometry
    from dspi_tpu_torch.configs import full_chain_config

    B = 16
    block, sched = packet_geometry(rate, n_packets)
    engs = [Engine(full_chain_config(Platform.RP2350, rate), n_streams=B,
                   block_size=block, schedule=sched, pdm=False, emit="full",
                   device=d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(23)
    shape = (2, sum(sched), B) if sched else (n_packets, 2, block, B)
    x = rng.integers(-16000, 16000, size=shape).astype(np.int32)
    n0 = (LAUNCHES["carry"], LAUNCHES["env_carry"],
          mxu.COUNTS["carry_kernel_steps"], mxu.COUNTS["carry_steps"])
    gpu = engs[0].process(x)
    torch.cuda.synchronize()
    assert (LAUNCHES["carry"], LAUNCHES["env_carry"],
            mxu.COUNTS["carry_kernel_steps"], mxu.COUNTS["carry_steps"]) \
        == (n0[0] + 4, n0[1] + 1, n0[2] + steps, n0[3])
    cpu = engs[1].process(x)
    for key in ("out", "s24"):
        err = _rel_rms(gpu[key].cpu(), cpu[key])
        assert err < 1e-6, (key, err)
    assert (gpu["peaks"].cpu() - cpu["peaks"]).abs().max() <= 1


# ---------------------------------------------------------- the segment tail

CADENCE = (44,) * 9 + (45,)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["float", "q28"])
@pytest.mark.parametrize("sched,gain_lane,dly_lane,T,B,mode", [
    (False, False, False, 1536, 512, "reduced"),
    (CADENCE, False, False, 882, 256, "reduced"),
    (False, True, False, 960, 384, "full"),
    (CADENCE, True, True, 882, 256, "full"),
    (False, True, False, 480, 4101, "full"),
    (False, False, True, 96, 64, "reduced"),
    (CADENCE, False, False, 45, 32, "full"),
    (False, False, False, 480, 512, "wire"),
    (CADENCE, True, False, 441, 128, "nosub"),
    (False, False, False, 480, 256, "zero_gains"),
], ids=["uniform", "ends", "lane_gains", "lane_gains_delays_ends",
        "4101_lanes", "short_lane_delays", "short_ends", "wire", "nosub",
        "zero_gains"])
def test_tail_kernel_equals_plain(chain, sched, gain_lane, dly_lane, T, B,
                                  mode):
    """The segment tail kernel against its plain version on the card, word
    for word: peaks (a NaN for a NaN: a lane's peak over NaNs of two
    payloads is one of them, as torch's amax picks it), s24 sums, the sub's
    Q28, the new rings, and the planes asked for (emit 'full': the delayed
    outputs and the s24 words; the wire: the words).  Edge samples (float
    NaN, +-inf, +-0, +-1, out of range, denormal; Q28 INT_MIN, INT_MAX,
    the s24 rounding edges), edge gains, a muted, a disabled and a
    delayed-but-disabled output and a pair with both channels off; uniform
    packets and the 44/45 ends; scalar and per-lane gains and delays;
    segments of 96 and 45 rows against a 256-row ring; 4,101 lanes; a
    disabled sub; zero gains.  One launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch.kernels.tail_cuda import (segment_tail,
                                                  segment_tail_plain)
    from test_torch_tail import FLAGS, FLAGS_NOSUB, tail_case

    args, kw, _ = tail_case(chain, sched, gain_lane, dly_lane, T, B,
                            seed=T + B + gain_lane + 2 * dly_lane,
                            flags=FLAGS_NOSUB if mode == "nosub" else FLAGS,
                            ring_len=256)
    planes, gains, ends, delay, ring = args
    if mode == "zero_gains":
        gains = torch.zeros_like(gains)
        if chain == "float":
            gains[::2] = -0.0
    kw.update(sub=mode != "nosub", words=mode == "wire",
              full=mode in ("full", "nosub"))
    card = ([v.cuda() for v in planes], gains.cuda(),
            None if ends is None else ends.cuda(), delay.cuda(), ring.cuda())
    n0 = LAUNCHES["tail"]
    got = segment_tail(*card, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["tail"] == n0 + 1
    want = segment_tail_plain(*card, **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if w is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "peaks" and g.is_floating_point():
            nan = torch.isnan(g) & torch.isnan(w)
            assert torch.equal(torch.isnan(g), torch.isnan(w)), k
            g = torch.where(nan, 0.0, g)
            w = torch.where(nan, 0.0, w)
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (k, (g != w).nonzero()[:5].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "contiguous"])
def test_tail_kernel_refuses(bad):
    """On the card the wrapper raises, and launches nothing, on planes of
    mixed devices, a wrong dtype or shape, or non-contiguous planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch.kernels.tail_cuda import segment_tail
    from test_torch_tail import tail_case

    args, kw, _ = tail_case("float", False, False, False, 96, 64, seed=2)
    planes, gains, ends, delay, ring = args
    planes = [v.cuda() for v in planes]
    gains, delay, ring = gains.cuda(), delay.cuda(), ring.cuda()
    if bad == "device":
        planes[3] = planes[3].cpu()
    elif bad == "dtype":
        gains = gains.double()
    elif bad == "shape":
        planes[1] = planes[1][:, :-1].contiguous()
    else:
        planes[2] = planes[2].t().contiguous().t()
    n0 = LAUNCHES["tail"]
    with pytest.raises((TypeError, ValueError)):
        segment_tail(planes, gains, ends, delay, ring, **kw)
    assert LAUNCHES["tail"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("platform", ["rp2350", "rp2040"])
def test_engine_segment_launches_the_tail_once(platform):
    """One segment of each chain's headline configuration through Engine
    on the card: LAUNCHES["tail"] grows by exactly 1 and the Q15 gain's by
    0; against the same segment on the CPU, the Q28 chain's outputs and
    state word for word, the float chain's out and s24 within 1e-6
    relative RMS, peaks within 1 LSB and clip flags equal (the float
    chain's card-vs-CPU budget: the block products round in another order
    on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    plat = Platform.RP2040 if platform == "rp2040" else Platform.RP2350
    B = 64
    engs = [Engine(full_chain_config(plat), B, emit="full", device=d)
            for d in ("cuda", "cpu")]
    # 16 packets: past the leveller's 480-sample lookahead, so the outputs
    # are not silent
    x = np.random.default_rng(25).integers(
        -16000, 16000, size=(16, 2, 48, B)).astype(np.int32)
    n0 = dict(LAUNCHES)
    gpu = engs[0].process(x)
    torch.cuda.synchronize()
    assert LAUNCHES["tail"] - n0.get("tail", 0) == 1
    assert LAUNCHES["q15_gain"] - n0.get("q15_gain", 0) == 0
    cpu = engs[1].process(x)
    assert set(gpu) == set(cpu)
    if plat == Platform.RP2040:
        for key in cpu:
            assert torch.equal(gpu[key].cpu(), cpu[key]), key
        for f, a, b in zip(engs[1].state._fields, engs[0].state,
                           engs[1].state):
            assert a is None or torch.equal(a.cpu(), b), f
    else:
        for key in ("out", "s24"):
            assert cpu[key].ne(0).any(), key
            err = _rel_rms(gpu[key].cpu(), cpu[key])
            assert err < 1e-6, (key, err)
        assert (gpu["peaks"].cpu() - cpu["peaks"]).abs().max() <= 1
        assert torch.equal(engs[0].state.clip_flags.cpu(),
                           engs[1].state.clip_flags)
