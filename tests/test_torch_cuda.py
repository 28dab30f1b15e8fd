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
from dspi_tpu_torch.kernels.xf_cuda import xf_q28, xf_q28_plain
from dspi_tpu_torch.kernels.xf_f32_cuda import xf_f32, xf_f32_plain


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
