"""The leveller's block phase, ``kernels.lev_cuda``: the packet
recurrence's plain version against a loop of the JAX package's
``fmath.smooth_det`` (the recurrence its ``lev_step`` scans), bit for bit
on seeded and edge inputs; the two wrappers' plain versions (``lev_gain``,
``lev_apply``) against the JAX package's block phase on its NumPy branch,
bit for bit, both chains, and their refusals; both chains through the two
wrappers, once each a segment; and one segment of each chain against the
JAX engine."""

import numpy as np
import pytest
import torch

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.core import fmath as jf
from dspi_tpu.core import qmath as jq
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, packet_geometry, pipeline
from dspi_tpu_torch.configs import full_chain_config, hetero_variants
from dspi_tpu_torch.kernels import LAUNCHES, lev_cuda

from lev_cases import (CEIL, RING, case, denormal_first, exp2_domain,
                       gain_edges, phase_case)
from util import make_input


def _jax_loop(gc, pow_att, pow_rel, gdb0):
    """The JAX package's recurrence on its NumPy branch, packet by
    packet: alpha by the target's side of the gain, then smooth_det."""
    gdb = gdb0
    out = []
    for k in range(gc.shape[0]):
        alpha = np.where(gc[k] < gdb, pow_att[k], pow_rel[k])
        gdb = jf.smooth_det(alpha, gdb, gc[k])
        out.append(gdb)
    return np.stack(out)


@pytest.mark.parametrize("npkt,rate,lane,B", [
    (128, 48000.0, False, 64), (128, 48000.0, True, 64),
    (130, 44100.0, False, 64), (130, 44100.0, True, 37),
    (1, 48000.0, False, 5), (3, 44100.0, True, 1)])
def test_plain_equals_jax_smooth_det(npkt, rate, lane, B):
    gc, pa, pr, g0 = case(npkt, B, lane, rate, seed=npkt * 7 + B)
    got = lev_cuda.lev_smooth_plain(*(torch.from_numpy(v) for v in
                                      (gc, pa, pr, g0))).numpy()
    want = _jax_loop(gc, pa, pr, g0)
    assert got.dtype == np.float32 and got.shape == (npkt, B)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if B >= 5:
        assert denormal_first(got)


@pytest.mark.parametrize("bad", ["dtype", "shape_alpha", "mixed_alpha",
                                 "gdb0", "empty"])
def test_wrapper_refuses(bad):
    gc, pa, pr, g0 = (torch.from_numpy(v) for v in
                      case(4, 6, False, 48000.0, seed=3))
    if bad == "dtype":
        gc = gc.double()
    elif bad == "shape_alpha":
        pa = pr = torch.zeros(4, 3)
    elif bad == "mixed_alpha":
        pr = torch.zeros(4, 6)
    elif bad == "gdb0":
        g0 = g0[:5]
    else:
        gc, pa, pr = gc[:0], pa[:0], pr[:0]
    with pytest.raises((TypeError, ValueError)):
        lev_cuda.lev_smooth_plain(gc, pa, pr, g0)


def test_kernel_constants_are_fmath_s():
    """``csrc/lev.cu`` spells out the reference's constants: the log2 and
    exp2 coefficients, sqrt(2) and the reciprocal's seed as integers, and
    the float32 constants as hexadecimal floats; each equals the JAX
    package's ``fmath`` and the leveller's float32 values exactly."""
    import re
    from pathlib import Path

    from dspi_tpu.core import constants as JC

    src = (Path(lev_cuda.__file__).parent / "csrc" / "lev.cu").read_text()
    ints = dict(re.findall(r"(k\w+) = (-?\d+)[,;]", src))
    want = {**{f"kLog2C{2 * i + 1}": c for i, c in enumerate(jf._LOG2_CQ)},
            **{f"kExp2C{i}": c for i, c in enumerate(jf._EXP2_CQ)},
            "kSqrt2Q29": jf._SQRT2_Q29, "kRcpSeedA": jf._RCP_SEED_A,
            "kRcpSeedB": jf._RCP_SEED_B}
    for name, c in want.items():
        assert int(ints[name]) == int(c), name
    floats = {k: float.fromhex(v[:-1]) for k, v in re.findall(
        r"constexpr float (k\w+) = (0x[0-9a-fA-F.p+-]+f);", src)}
    f32 = np.float32
    assert floats == {
        "kLog10of2": float(f32(jf._LOG10_2)), "kLog2of10": float(f32(
            jf._LOG2_10)), "kInv20": float(f32(1.0) / f32(20.0)),
        "kTiny": float(f32(1e-30)),
        "kCeil": float(f32(JC.LEVELLER_LIMITER_CEIL))}


def _jax_gain(c):
    """The packet half of the JAX package's leveller block phase
    (dspi_tpu/chain/pipeline.py:487-531 float, :964-1005 Q28) on
    ``lev_cases``' inputs, written out over its NumPy branch (``fmath``,
    ``qmath``): (g_cur, lev_gain_db, the gain before each packet)."""
    f32 = np.float32
    sched, lev = c["sched"], c["lev"]
    env_l, env_r = c["env_l"], c["env_r"]
    q28 = env_l.dtype == np.int32
    inv_q28 = f32(1.0) / f32(1 << 28)
    if q28:
        env_l = env_l.astype(f32) * inv_q28
        env_r = env_r.astype(f32) * inv_q28
    a_att, a_rel = lev[1], lev[2]
    thresh, knee, gate = lev[3], lev[4], lev[5]
    max_gain, makeup = lev[7], lev[8]
    slope, inv_two_knee = lev[9], lev[10]
    rms_db = 10.0 * jf.log10_f32(np.maximum(env_l, env_r) + f32(1e-30))
    half = knee * 0.5
    d = thresh + half - rms_db
    gc = np.where(rms_db > thresh + half, f32(0.0),
                  np.where(rms_db >= thresh - half,
                           slope * d * d * inv_two_knee,
                           (thresh - rms_db) * slope))
    gc = np.minimum(gc + makeup, max_gain)
    gc = np.where(rms_db < gate, f32(0.0), gc)
    counts_f = sched.astype(f32)[:, None]
    pow_att, pow_rel = jf.pow_f32(a_att, counts_f), jf.pow_f32(a_rel,
                                                               counts_f)
    inv20 = f32(1.0) / f32(20.0)
    gdb, g = c["gdb0"], c["g0"]
    g_prev, g_cur = [], []
    for k in range(len(sched)):                          # lev_step
        alpha = np.where(gc[k] < gdb, pow_att[k], pow_rel[k])
        gdb = jf.smooth_det(alpha, gdb, gc[k])
        g_n = jf.exp10_f32(gdb * inv20)
        if q28:
            g_n = jq.f32_to_i32(g_n * f32(1 << 28))
        g_prev.append(g)
        g_cur.append(g_n)
        g = g_n
    return np.stack(g_cur), gdb, np.stack(g_prev)


def _jax_phase(c, lookahead):
    """The JAX package's whole leveller block phase (dspi_tpu/chain/
    pipeline.py:487-577 float, :964-1063 Q28) on ``lev_cases.phase_case``'s
    inputs, the same way: (g_cur, lev_gain_db, lev_gain, lev_gain_prev,
    out_l, out_r, ring')."""
    f32 = np.float32
    sched = c["sched"]
    ttot, tmax = int(sched.sum()), int(sched.max())
    q28 = c["env_l"].dtype == np.int32
    inv_q28 = f32(1.0) / f32(1 << 28)
    g_cur, gdb, g_prev = _jax_gain(c)
    one = (sched == 1)[:, None]
    if q28:
        d_u = np.maximum(sched - 1, 1).astype(np.uint32)[:, None, None]
        diff = g_cur - g_prev
        neg = diff < 0
        a_u = np.where(neg, -diff, diff).astype(np.uint32)[:, None, :]
        i_vec = np.arange(tmax, dtype=np.uint32)[None, :, None]
        q = ((a_u // d_u) * i_vec + ((a_u % d_u) * i_vec) // d_u).astype(
            np.int32)
        gains = g_prev[:, None, :] + np.where(neg[:, None, :], -q, q)
        gains = np.where(one[:, :, None], g_cur[:, None, :], gains)
    else:
        inv = np.zeros(len(sched), f32)
        nz = sched > 1
        inv[nz] = f32(1.0) / (sched[nz] - 1).astype(f32)
        step = np.where(one, f32(0.0), (g_cur - g_prev) * inv[:, None])
        gi = np.where(one, g_cur, g_prev)
        rows = []
        for _ in range(tmax):
            rows.append(gi)
            gi = gi + step
        gains = np.stack(rows, axis=1)
    gains = np.concatenate([gains[k, :n] for k, n in enumerate(sched)])
    bl, br, ring = c["bl"], c["br"], None
    out_l, out_r = bl, br
    if lookahead:
        comb_l = np.concatenate([c["ring"][0], bl])
        comb_r = np.concatenate([c["ring"][1], br])
        out_l, out_r = comb_l[:ttot], comb_r[:ttot]
        ring = np.stack([comb_l[ttot:], comb_r[ttot:]])
    if q28:
        unity = np.int32(1 << 28)
        peak = np.maximum(np.abs(out_l.astype(f32) * inv_q28),
                          np.abs(out_r.astype(f32) * inv_q28))
        with np.errstate(over="ignore"):     # saturates, as in C
            max_g = jq.f32_to_i32(jf.det_div(CEIL, peak) * f32(1 << 28))
        g_eff = np.where((gains > unity) & (peak > 0.0) & (max_g < gains),
                         np.maximum(max_g, unity), gains)
        out_l, out_r = jq.q28_mul(out_l, g_eff), jq.q28_mul(out_r, g_eff)
    else:
        peak = np.maximum(np.abs(out_l), np.abs(out_r))
        max_g = jf.det_div(CEIL, peak)
        cap = np.where(max_g > 1.0, max_g, f32(1.0))
        g_eff = np.where((peak > 0.0) & (gains > 1.0) & (max_g < gains), cap,
                         gains)
        out_l, out_r = out_l * g_eff, out_r * g_eff
    return g_cur, gdb, g_cur[-1], g_prev[-1], out_l, out_r, ring


def _torch_phase(c, lookahead, ends=True):
    """The same through ``lev_gain_plain`` and ``lev_apply_plain`` on the
    CPU (``ends``: packet ends passed, or uniform packets by count)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()
         if k != "sched"}
    ttot = int(c["sched"].sum())
    e = torch.from_numpy(np.cumsum(c["sched"]).astype(np.int32)) \
        if ends else None
    g_cur, gdb, g, g_prev = lev_cuda.lev_gain_plain(
        t["env_l"], t["env_r"], t["lev"], t["gdb0"], t["g0"], ttot, e)
    out_l, out_r, ring = lev_cuda.lev_apply_plain(
        t["bl"], t["br"], g_cur, t["g0"], t["ring"] if lookahead else None,
        e)
    return g_cur, gdb, g, g_prev, out_l, out_r, ring


@pytest.mark.parametrize("chain", ["float", "q28"])
@pytest.mark.parametrize("npkt,B,kind,lane,lookahead", [
    (12, 6, "uniform", False, True), (13, 5, "44k1", True, True),
    (10, 4, "one", True, True), (2, 3, "uniform", False, True),
    (12, 4, "uniform", True, False), (1, 3, "uniform", False, True)])
def test_block_phase_plain_equals_jax(chain, npkt, B, kind, lane, lookahead):
    """``lev_gain_plain`` then ``lev_apply_plain`` against the JAX
    package's block phase on its NumPy branch, every output and state
    leaf bit for bit: uniform packets (past the 480-sample ring, and a
    2-packet and a 1-packet segment shorter than it, where the new ring
    keeps part of the old), the 44/45 schedule, one with one-sample
    packets, scalar and per-lane parameters, lookahead on and off;
    envelopes at 0, denormal, under the gate and across the knee, gains
    above unity against samples at the limiter's ceiling."""
    c = phase_case(chain == "q28", npkt, B, kind, lane,
                   seed=1000 * npkt + 10 * B + lane)
    want = _jax_phase(c, lookahead)
    got = _torch_phase(c, lookahead, ends=kind != "uniform")
    for name, w, g in zip(("g_cur", "lev_gain_db", "lev_gain",
                           "lev_gain_prev", "out_l", "out_r", "lev_la"),
                          want, got):
        if w is None:
            assert g is None, name
            continue
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=name)
    if lookahead:
        assert got[-1].shape == (2, RING, B)
    if kind == "uniform":
        # uniform packets by count give the same bits as their ends
        for a, b in zip(got, _torch_phase(c, lookahead)):
            assert a is None and b is None or torch.equal(a, b)
    # gains above unity, so the limiter's cap is computed and taken
    assert bool((got[0] > (1 << 28 if chain == "q28" else 1.0)).any())


@pytest.mark.parametrize("chain", ["float", "q28"])
@pytest.mark.parametrize("npkt,kind,ends", [
    (24, "ones", False), (24, "ones", True), (1, "ones", False),
    (20, "one", True)])
def test_gain_edges_plain_equals_jax(chain, npkt, kind, ends):
    """``lev_gain_plain`` against the JAX package's packet half on
    ``lev_cases.gain_edges``: targets of 0, -0, +-1e-40, +-the smallest
    normal, +-3e38, 1e30 and -65 dB, alphas of exactly 0, 1 and 0.5, start
    gains denormal, smallest-normal and +-3.3e38, gated packets among
    them; one-sample packets by count or by their ends, and the 44/45
    schedule with one-sample packets; g_cur and the three state leaves
    bit for bit (the linear gains on the lanes that stay in
    ``exp2_f32``'s domain: ``lev_cases.exp2_domain``), and the cancelling
    lane's first sum denormal."""
    c = gain_edges(chain == "q28", npkt, kind, seed=31 * npkt)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()
         if k != "sched"}
    ttot = int(c["sched"].sum())
    e = torch.from_numpy(np.cumsum(c["sched"]).astype(np.int32)) \
        if ends else None
    got = lev_cuda.lev_gain_plain(t["env_l"], t["env_r"], t["lev"],
                                  t["gdb0"], t["g0"], ttot, e)
    with np.errstate(over="ignore", invalid="ignore"):
        g_cur, gdb, g_prev = _jax_gain(c)
    live = exp2_domain(c)
    assert 0 < live.sum() < len(live)
    for name, g, w in zip(("g_cur", "lev_gain_db", "lev_gain",
                           "lev_gain_prev"), got,
                          (g_cur, gdb, g_cur[-1], g_prev[-1])):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name != "lev_gain_db":           # linear gains: exp2's domain
            g, w = g[..., live], w[..., live]
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=name)
    if kind == "ones":
        first = lev_cuda.lev_gain_plain(
            t["env_l"][:1], t["env_r"][:1], t["lev"], t["gdb0"], t["g0"], 1)
        assert denormal_first(first[1][None].numpy(), lane=0)


def _gain_args(bad):
    c = phase_case(False, 4, 6, "uniform", False, seed=7)
    a = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("env_l", "env_r", "lev", "gdb0", "g0")}
    ttot, ends = 192, None
    if bad == "dtype":
        a["env_l"] = a["env_l"].double()
    elif bad == "mixed":
        a["g0"] = a["g0"].to(torch.int32)
    elif bad == "lev":
        a["lev"] = a["lev"][:10]
    elif bad == "gdb0":
        a["gdb0"] = a["gdb0"][:5]
    elif bad == "device":
        a["lev"] = a["lev"].to("meta")
    elif bad == "contiguous":
        a["env_r"] = a["env_r"].t().contiguous().t()
    elif bad == "ends":
        ends = torch.tensor([48, 96, 144, 190], dtype=torch.int32)
    elif bad == "ttot":
        ttot = 190
    return (*a.values(), ttot, ends)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "lev", "gdb0", "device",
                                 "contiguous", "ends", "ttot"])
def test_gain_refuses(bad):
    """``lev_gain`` raises on envelopes of another dtype, a g0 of another
    dtype than theirs, a short parameter column, a gdb0 of another shape,
    a tensor on another device, a non-contiguous tensor, packet ends that
    do not tile the segment and a segment that is not whole packets."""
    with pytest.raises((TypeError, ValueError)):
        lev_cuda.lev_gain(*_gain_args(bad))
    lev_cuda.lev_gain(*_gain_args(None))


def _apply_args(bad):
    c = phase_case(True, 4, 6, "uniform", False, seed=8)
    a = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("bl", "br", "env_l", "g0", "ring")}
    a["env_l"] = a["env_l"].clone()                      # as g_cur [4, 6]
    ends = None
    if bad == "dtype":
        a = {k: v.to(torch.int16) for k, v in a.items()}
    elif bad == "mixed":
        a["br"] = a["br"].float()
    elif bad == "ring_dtype":
        a["ring"] = a["ring"].float()
    elif bad == "ring_shape":
        a["ring"] = a["ring"][:, :, :5]
    elif bad == "ring_sides":
        a["ring"] = a["ring"][:1]
    elif bad == "g0":
        a["g0"] = a["g0"][:5]
    elif bad == "device":
        a["ring"] = a["ring"].to("meta")
    elif bad == "contiguous":
        a["bl"] = a["bl"].t().contiguous().t()
    elif bad == "ends":
        ends = torch.tensor([48, 96, 96, 192], dtype=torch.int32)
    elif bad == "uniform":
        a["bl"], a["br"] = a["bl"][:190], a["br"][:190]
    return (*a.values(), ends)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "ring_dtype", "ring_shape",
                                 "ring_sides", "g0", "device", "contiguous",
                                 "ends", "uniform"])
def test_apply_refuses(bad):
    """``lev_apply`` raises on planes that are neither float32 nor int32,
    planes, gains and ring of mixed dtypes, a ring of another lane count
    or side count, a g0 of another shape, a tensor on another device, a
    non-contiguous plane, packet ends with an empty packet and planes
    that are not whole uniform packets."""
    with pytest.raises((TypeError, ValueError)):
        lev_cuda.lev_apply(*_apply_args(bad))
    lev_cuda.lev_apply(*_apply_args(None))


def _engine(path):
    """(engine, segment input) of a small CPU path."""
    B, npkt = 8, 3
    if path == "float_mxu":
        eng = Engine(full_chain_config(Platform.RP2350), n_streams=B,
                     emit="reduced", device="cpu")
    elif path == "float_scan":
        eng = Engine(full_chain_config(Platform.RP2350), n_streams=B,
                     emit="reduced", mxu=False, device="cpu")
    elif path in ("q28", "q28_lev_off", "q28_no_lookahead"):
        cfg = full_chain_config(Platform.RP2040)
        cfg.leveller.enabled = path != "q28_lev_off"
        cfg.leveller.lookahead = path != "q28_no_lookahead"
        eng = Engine(cfg, n_streams=B, emit="reduced", device="cpu")
    elif path == "q28_hetero":
        from dspi_tpu_torch.chain.grouped import HeteroServer

        ids = np.arange(B) % 3
        srv = HeteroServer(hetero_variants(3, Platform.RP2040), ids,
                           device="cpu")
        x = np.random.default_rng(5).integers(
            -16000, 16000, (npkt, 2, 48, B)).astype(np.int32)
        return srv, torch.from_numpy(x)
    else:                                           # 44.1 kHz
        sched = packet_geometry(44100.0, npkt)[1]
        plat = Platform.RP2350 if path == "float_44k1" else Platform.RP2040
        eng = Engine(full_chain_config(plat, 44100.0),
                     n_streams=B, emit="reduced", schedule=sched,
                     device="cpu")
        x = np.random.default_rng(5).integers(
            -16000, 16000, (2, int(sum(sched)), B)).astype(np.int32)
        return eng, torch.from_numpy(x)
    x = np.random.default_rng(5).integers(
        -16000, 16000, (npkt, 2, 48, B)).astype(np.int32)
    return eng, torch.from_numpy(x)


@pytest.mark.parametrize("path,calls", [
    ("float_mxu", 1), ("float_scan", 1), ("q28", 1), ("q28_hetero", 1),
    ("q28_44k1", 1), ("q28_lev_off", 0), ("float_44k1", 1),
    ("q28_no_lookahead", 1)])
def test_each_chain_calls_the_wrapper_once_a_segment(monkeypatch, path,
                                                     calls):
    """Both chains, both float lowerings, the grouped server, 44.1 kHz and
    a chain without lookahead reach the leveller's block phase through
    ``lev_gain`` and ``lev_apply`` alone, each once a segment (a chain with
    the leveller off never), with packet ends exactly on a schedule, and
    on the CPU they launch nothing."""
    seen = []

    def counted(fn):
        def call(*a):
            seen.append((fn.__name__, a[-1] is not None))
            return fn(*a)
        return call

    monkeypatch.setattr(pipeline, "lev_gain", counted(lev_cuda.lev_gain))
    monkeypatch.setattr(pipeline, "lev_apply", counted(lev_cuda.lev_apply))
    eng, x = _engine(path)
    before = dict(LAUNCHES)
    for _ in range(2):
        eng.process(x)
    sched = path.endswith("44k1")
    assert seen == [("lev_gain", sched), ("lev_apply", sched)] * 2 * calls
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("chain", ["float", "q28"])
def test_segment_equals_jax_engine(chain):
    """One segment of 12 packets (past the 10 ms lookahead) on the port
    and the JAX engine from the same params and state: the Q28 chain's
    output words and Q28 gains equal, the float chain's outputs and
    smoothed gain within 1e-6 relative RMS (test_torch_chain.py's
    holds)."""
    B, npkt = 3, 12
    rng = np.random.default_rng(0x1E7)
    if chain == "float":
        je = JEngine(bench.full_chain_config(JPlatform.RP2350), n_streams=B,
                     emit="full", mxu=True)
        te = Engine(full_chain_config(Platform.RP2350), n_streams=B,
                    emit="full", device="cpu")
    else:
        je = JEngine(bench.full_chain_config(JPlatform.RP2040), n_streams=B,
                     emit="full", unroll=1)
        te = Engine(full_chain_config(Platform.RP2040), n_streams=B,
                    emit="full", device="cpu")
    te.load_params_state(je.params, je.state)
    x = make_input(rng, npkt, 48, B)
    jo = {k: np.asarray(v) for k, v in je.process(x).items()}
    to = {k: v.numpy() for k, v in te.process(x).items()}
    assert set(jo) == set(to)
    if chain == "q28":
        for k in ("out", "s24", "peaks"):
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        np.testing.assert_array_equal(te.state.lev_gain.numpy(),
                                      np.asarray(je.state.lev_gain))
    else:
        for k in ("out", "s24"):
            err = np.sqrt(np.mean((to[k].astype(np.float64) - jo[k]) ** 2)
                          / np.mean(jo[k].astype(np.float64) ** 2))
            assert err < 1e-6, (k, err)
        g_t = te.state.lev_gain_db.numpy().astype(np.float64)
        g_j = np.asarray(je.state.lev_gain_db, np.float64)
        assert np.sqrt(np.mean((g_t - g_j) ** 2)
                       / (np.mean(g_j ** 2) + 1e-30)) < 1e-6
    assert np.abs(to["out"]).max() > 0


@pytest.mark.parametrize("chain,shape", [
    ("q28", "no_lookahead"), ("q28", "short"), ("float", "short"),
    ("float", "one_sample")])
def test_short_segments_equal_jax_engine(chain, shape):
    """Six segments of the shapes the block phase's plain versions are
    held to on the JAX block phase written out, here against the JAX
    engine itself, from the same params and state: the leveller's
    lookahead off (2 packets); segments of 2 packets, 96 samples, shorter
    than the 480-sample ring, which then keeps part of the old one; and a
    44.1 kHz schedule of 4 packets, two of them one sample long, 91 samples
    (past the ring's silence by the last segments).
    Q28: the outputs and every state leaf as test_torch_multi.py holds
    them; float: the outputs and the leveller's leaves (lev_gain_db,
    lev_gain, lev_gain_prev, the ring) within 1e-6 relative RMS, the
    float chain's budget."""
    from test_torch_multi import assert_state_matches_jax

    B = 3
    plat, jplat = ((Platform.RP2040, JPlatform.RP2040) if chain == "q28"
                   else (Platform.RP2350, JPlatform.RP2350))
    rate = 44100.0 if shape == "one_sample" else 48000.0
    sched = (44, 1, 45, 1) if shape == "one_sample" else None
    jcfg = bench.full_chain_config(jplat, rate)
    cfg = full_chain_config(plat, rate)
    jcfg.leveller.lookahead = cfg.leveller.lookahead = \
        shape != "no_lookahead"
    kw = {"mxu": True} if chain == "float" else {"unroll": 1}
    je = JEngine(jcfg, n_streams=B, emit="full", schedule=sched, **kw)
    te = Engine(cfg, n_streams=B, emit="full", schedule=sched, device="cpu")
    te.load_params_state(je.params, je.state)
    rng = np.random.default_rng(0x5E7)
    for _ in range(6):
        if sched is None:
            x = make_input(rng, 2, 48, B)
        else:
            x = rng.integers(-16000, 16000,
                             (2, sum(sched), B)).astype(np.int32)
        jo = {k: np.asarray(v) for k, v in je.process(x).items()}
        to = {k: v.numpy() for k, v in te.process(x).items()}
        assert set(jo) == set(to)
        if chain == "q28":
            for k in ("out", "s24", "peaks"):
                np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        else:
            for k in ("out", "s24"):
                err = np.sqrt(np.mean((to[k].astype(np.float64) - jo[k]) ** 2)
                              / (np.mean(jo[k].astype(np.float64) ** 2)
                                 + 1e-30))
                assert err < 1e-6, (k, err)
    if chain == "q28":
        assert_state_matches_jax(te.state, je.state)
    else:
        for f in ("lev_gain_db", "lev_gain", "lev_gain_prev", "lev_la"):
            t = getattr(te.state, f).numpy().astype(np.float64)
            j = np.asarray(getattr(je.state, f), np.float64)
            assert t.shape == j.shape, f
            assert np.sqrt(np.mean((t - j) ** 2)
                           / (np.mean(j ** 2) + 1e-30)) < 1e-6, f
    # the ring carries the last segments' samples, or without lookahead
    # stays as it was loaded, zero
    ring_live = bool(np.abs(te.state.lev_la.numpy()).max() > 0)
    assert ring_live == (shape != "no_lookahead")
    assert np.abs(to["out"]).max() > 0
