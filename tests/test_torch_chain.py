"""The whole slice: the port's Engine on the full headline chain against
the JAX package's Engine(mxu=True) run from the same params and state, and
against the firmware-semantics golden model.

Held to: ``out``/``s24`` <= 1e-6 relative RMS, clip flags equal, peaks
within 1 LSB, carried float state <= 1e-6 relative RMS, PDM words equal
for each stream up to the first sample whose modulator input
(pcm = x_q28 >> 14) differs between the two sides: the float chain is
ulp-faithful, not bit-frozen, so the modulator's input may legitimately
diverge after that sample, and the modulator is then chaotic."""

import functools

import numpy as np
import pytest
import torch

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.core.qmath import f32_to_i32
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu_torch import EqBand, FilterType, Platform
from dspi_tpu_torch.chain import Engine
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.core import constants as C

from test_torch_pack import _convert
from util import golden_run, make_input, rich_config

B, NPKT, BLOCK, NSEG, NGOLD = 3, 8, 48, 2, 2
RATE = 48000.0
SEED = 0x70C4
NOUT = 9


def _rel_rms(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (np.sqrt(np.mean((got - want) ** 2))
            / (np.sqrt(np.mean(want ** 2)) + 1e-30))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@functools.lru_cache(maxsize=None)
def _run(seed):
    """Both engines (and the golden model on the first NGOLD streams) over
    NSEG segments of NPKT packets, then one more segment after the same
    coefficient-only update_config on both engines.  Also returns both
    engines' leveller state and clip flags after the NSEG segments, the
    point the golden model has reached, as {"port": {...}, "jax": {...}}."""
    rng = np.random.default_rng(seed)
    jcfg = bench.full_chain_config(JPlatform.RP2350)
    je = JEngine(jcfg, n_streams=B, block_size=BLOCK, emit="full", mxu=True)
    te = Engine(full_chain_config(Platform.RP2350), n_streams=B,
                block_size=BLOCK, emit="full", device="cpu")
    te.load_params_state(je.params, je.state)
    xs = [make_input(rng, NPKT, BLOCK, B) for _ in range(NSEG + 1)]
    outs = []
    for i, x in enumerate(xs):
        if i == NSEG:
            at_nseg = {side: {f: _np(getattr(e.state, f)).copy()
                              for f in ("lev_env", "lev_gain_db",
                                        "clip_flags")}
                       for side, e in (("port", te), ("jax", je))}
            for eng, P in ((je, JPlatform), (te, Platform)):
                cfg = (bench.full_chain_config(P.RP2350) if eng is je
                       else full_chain_config(P.RP2350))
                cfg.eq[0][4] = type(cfg.eq[0][4])(
                    cfg.eq[0][4].type, 900.0, 1.1, 4.0)
                eng.update_config(cfg)
        jo = {k: _np(v) for k, v in je.process(x).items()}
        to = {k: _np(v) for k, v in te.process(x).items()}
        outs.append((jo, to))
    goldens = [GoldenDevice(bench.full_chain_config(JPlatform.RP2350))
               for _ in range(NGOLD)]
    gold = [[golden_run(g, x[..., s:s + 1]) for s, g in enumerate(goldens)]
            for x in xs[:NSEG]]
    return je, te, outs, gold, goldens, at_nseg


def _leveller_errors(seed=SEED):
    """Relative RMS of the leveller envelope and smoothed gain, all read
    after NSEG segments, where the golden model stops, on its first NGOLD
    streams: (port vs JAX engine, port vs golden model, JAX engine vs
    golden model)."""
    _, _, _, _, goldens, at_nseg = _run(seed)
    gold = {"lev_env": np.stack([g.lev_env for g in goldens], axis=-1),
            "lev_gain_db": np.array([g.lev_gain_smooth_db for g in goldens])}
    port = {f: at_nseg["port"][f][..., :NGOLD] for f in gold}
    jax_ = {f: at_nseg["jax"][f][..., :NGOLD] for f in gold}
    return {f: (_rel_rms(port[f], jax_[f]), _rel_rms(port[f], gold[f]),
                _rel_rms(jax_[f], gold[f]))
            for f in gold}


def _pcm_prefix_equal(words_a, words_b, sub_a, sub_b):
    """Words equal per stream up to the first differing modulator input.
    sub_*: float32 [Ttot, B] sub output; words_*: uint32 [Ttot, 8, B].
    Returns the number of samples compared."""
    pcm_a = f32_to_i32(sub_a * np.float32(1 << 28)) >> 14
    pcm_b = f32_to_i32(sub_b * np.float32(1 << 28)) >> 14
    n = 0
    for s in range(sub_a.shape[1]):
        diff = np.nonzero(pcm_a[:, s] != pcm_b[:, s])[0]
        k = int(diff[0]) if diff.size else sub_a.shape[0]
        np.testing.assert_array_equal(words_a[:k, :, s], words_b[:k, :, s],
                                      err_msg=f"stream {s}")
        n += k
    return n


def _flat(out, o):
    """emit='full' out [Npkt, nout, T, B] -> output o as [Ttot, B]."""
    return out[:, o].reshape(-1, out.shape[-1])


@pytest.mark.parametrize("seg", range(NSEG + 1))
def test_slice_matches_jax_engine(seg):
    _, _, outs, _, _, _ = _run(SEED)
    jo, to = outs[seg]
    assert set(jo) == set(to)
    assert np.isfinite(to["out"]).all()
    if seg > 0:                 # the 480-sample lookahead fills in segment 0
        assert np.sqrt(np.mean(jo["out"].astype(np.float64) ** 2)) > 1e-4
    assert _rel_rms(to["out"], jo["out"]) < 1e-6
    assert _rel_rms(to["s24"], jo["s24"]) < 1e-6
    assert np.abs(to["peaks"] - jo["peaks"]).max() <= 1
    n = _pcm_prefix_equal(to["pdm"].view(np.uint32), jo["pdm"],
                          _flat(to["out"], NOUT - 1),
                          _flat(jo["out"], NOUT - 1))
    assert n > 0


def test_carried_state_matches_jax_engine():
    """Every float field within 1e-6 relative RMS of the JAX engine's,
    except the leveller's envelope and smoothed gain.  Those two are read
    where the golden model stops, and there held to 2e-6: by the triangle
    inequality the engines differ by at most the port's distance to the
    golden model plus the JAX engine's, each under 1e-6
    (test_leveller_state_no_farther_from_golden_than_jax).  After one more
    segment and an update_config, where there is no golden reading, they
    read 2.0e-6 and 1.7e-6 (2.0e-6 and 1.9e-6 for seed 7); there they are
    held to 3e-6, a guard against growth that no triangle bounds."""
    je, te, _, _, _, at_nseg = _run(SEED)
    for f in te.state._fields:
        t, j = getattr(te.state, f), getattr(je.state, f)
        if t is None:
            assert j is None, f
            continue
        t, j = _np(t), np.asarray(j)
        if f == "pdm_rng":
            t = t.view(np.uint32)
        assert t.shape == j.shape, f
        if t.dtype.kind == "f":
            bound = 3e-6 if f in ("lev_env", "lev_gain_db") else 1e-6
            assert _rel_rms(t, j) < bound, (f, _rel_rms(t, j))
        elif f == "clip_flags":
            np.testing.assert_array_equal(t, j)
    for f in ("lev_env", "lev_gain_db"):
        err = _rel_rms(at_nseg["port"][f], at_nseg["jax"][f])
        assert err < 2e-6, (f, err)


def test_slice_matches_golden():
    _, _, outs, gold, _, _ = _run(SEED)
    for seg in range(NSEG):
        to = outs[seg][1]
        want = np.stack([np.stack([p["buf_out"] for p in gs])
                         for gs in gold[seg]], axis=-1)  # [Npkt, nout, T, S]
        got = to["out"][..., :NGOLD]
        assert _rel_rms(got, want) < 1e-6
        spdif = np.stack([np.stack([p["spdif"] for p in gs])
                          for gs in gold[seg]], axis=-1)  # [Npkt, 4, T, 2, S]
        want24 = np.moveaxis(spdif, 3, 2).reshape(NPKT, 8, BLOCK, NGOLD)
        assert _rel_rms(to["s24"][..., :NGOLD], want24) < 1e-6
        gpeaks = np.max([[p["peaks"] for p in gs] for gs in gold[seg]],
                        axis=1).T                            # [nch, S]
        assert np.abs(to["peaks"][:, :NGOLD] - gpeaks).max() <= 1
        for s, gs in enumerate(gold[seg]):
            gw = np.array([w for p in gs for w in p["pdm_words"]],
                          np.uint32).reshape(-1, 8)
            _pcm_prefix_equal(to["pdm"].view(np.uint32)[:, :, s:s + 1],
                              gw[:, :, None],
                              _flat(to["out"], NOUT - 1)[:, s:s + 1],
                              want[:, NOUT - 1].reshape(-1, NGOLD)[:, s:s + 1])


def test_carried_state_matches_golden():
    """Clip flags equal, and the leveller envelope and smoothed gain
    against the firmware's sequential recurrence, <= 1e-6."""
    _, _, _, _, goldens, at_nseg = _run(SEED)
    for f, errs in _leveller_errors(SEED).items():
        assert errs[1] < 1e-6, (f, errs)
    assert at_nseg["port"]["clip_flags"][:NGOLD].tolist() == [
        g.clip_flags for g in goldens]


def test_leveller_state_no_farther_from_golden_than_jax():
    """The leveller envelope and smoothed gain of both engines against the
    golden model, read where the golden model stops: the port within 1e-6
    of it, and no farther from it than the JAX engine is, which is itself
    within 1e-6.

    These two legs make the triangle behind the 2e-6 that
    test_carried_state_matches_jax_engine holds the two engines to at
    this point.  Here the port reads 7.37e-7 (envelope) and 2.82e-7
    (smoothed gain) from the golden model, the JAX engine 8.34e-7 and
    4.11e-7, and the two engines 1.42e-6 and 6.88e-7 from each other,
    under the sums 1.57e-6 and 6.93e-7.  The JAX engine's distance is the
    larger:
    it builds the envelope weights a^1..a^T with jnp.cumprod, which
    XLA:CPU lowers as an associative scan, 1.7e-7 off the float64 a^48
    for this config (the port's sequential product: 2.8e-8), and the
    envelope recurrence accumulates that over packets.
    ``PYTHONPATH=. python tests/test_torch_chain.py SEED...`` prints the
    three readings for each seed."""
    for f, (_, port, jax_) in _leveller_errors(SEED).items():
        assert port < 1e-6, (f, port)
        assert port <= jax_, (f, port, jax_)
        assert jax_ < 1e-6, (f, jax_)


def test_update_config_pdm_disable_and_reenable_mid_fade():
    """A runtime sub-output disable keeps the PDM stage and flips pdm_ena:
    the modulator fades out; a re-enable mid-fade turns the out-ramp into
    an in-ramp (pdm_generator.c:217-252)."""
    cfg = full_chain_config(Platform.RP2350)
    te = Engine(cfg, n_streams=2, block_size=BLOCK, emit="full",
                pdm_fade=False, device="cpu")
    rng = np.random.default_rng(3)
    x = make_input(rng, 2, BLOCK, 2)
    te.process(x)
    cfg.outputs[-1].enabled = False
    te.update_config(cfg)
    assert te.static.pdm_on and (te.state.pdm_ena == 0).all()
    te.process(x)
    n = 2 * BLOCK
    assert te.state.pdm_fout.tolist() == [C.PDM_FADE_IN_SAMPLES - n] * 2
    assert (te.state.pdm_run == 1).all()
    cfg.outputs[-1].enabled = True
    te.update_config(cfg)
    out = te.process(x)
    assert (out["pdm"].numpy().view(np.uint32)
            != np.uint32(C.PDM_SILENCE_WORD)).all(axis=1).any()
    assert te.state.pdm_fout.tolist() == [0, 0]
    assert te.state.pdm_fade.tolist() == [2 * n] * 2


def test_save_load_state_round_trip(tmp_path):
    te = Engine(full_chain_config(Platform.RP2350), n_streams=2,
                block_size=BLOCK, emit="reduced", device="cpu")
    rng = np.random.default_rng(4)
    te.process(make_input(rng, 2, BLOCK, 2))
    before = [None if v is None else v.clone() for v in te.state]
    path = tmp_path / "st.npz"
    te.save_state(str(path))
    assert np.load(path)["pdm_rng"].dtype == np.uint32
    te.process(make_input(rng, 2, BLOCK, 2))
    te.load_state(str(path))
    for f, a, b in zip(te.state._fields, before, te.state):
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_reduced_emit_is_the_full_emit_reduced():
    rng = np.random.default_rng(6)
    x = make_input(rng, 2, BLOCK, 2)
    full = Engine(full_chain_config(Platform.RP2350), n_streams=2,
                  block_size=BLOCK, emit="full", device="cpu").process(x)
    red = Engine(full_chain_config(Platform.RP2350), n_streams=2,
                 block_size=BLOCK, emit="reduced", device="cpu").process(x)
    s24 = full["s24"].to(torch.int64).sum(dim=(0, 2))
    assert torch.equal(red["s24_sum"], s24.to(torch.int32))
    words = full["pdm"].numpy().view(np.uint32)
    assert red["pdm_sum"].tolist() == words.sum(axis=(0, 1),
                                                dtype=np.uint32).tolist()
    assert torch.equal(red["peaks"], full["peaks"])


@pytest.mark.parametrize("kw", [dict(mxu=False), dict(wire=True),
                                dict(schedule=(44, 45)),
                                dict(q28=True, wire=True)])
def test_refused_features(kw):
    """Every case was refused before the port ran it, and now runs: the
    float chain's scan lowering (mxu=False; tests/test_torch_scan.py holds
    its numbers), the wire stage on both chains (tests/test_torch_wire.py
    holds its words) and the float chain's packet schedule
    (tests/test_torch_float_sched.py holds its numbers)."""
    platform = Platform.RP2040 if kw.pop("q28", False) else Platform.RP2350
    rate = 44100.0 if "schedule" in kw else RATE
    eng = Engine(full_chain_config(platform, rate), n_streams=2,
                 device="cpu", pdm=False, **kw)
    rng = np.random.default_rng(9)
    if "schedule" in kw:
        x = rng.integers(-16000, 16000, size=(2, 89, 2)).astype(np.int32)
    else:
        x = make_input(rng, 2, BLOCK, 2)
    out = eng.process(x)
    assert torch.isfinite(out["out"].double()).all()
    if "schedule" in kw:
        assert out["out"].shape == (NOUT, 89, 2)
    elif kw.get("mxu") is False:
        assert not eng.static.mxu and eng.blocks is None
        assert out["out"].shape == (2, NOUT, BLOCK, 2)
        assert out["s24"].shape == (2, 8, BLOCK, 2)
    else:
        pairs = eng.static.n_spdif
        assert {f"wire{p}" for p in range(pairs)} <= set(out)
        assert int(eng.state.wire_pos) == 2 * BLOCK


def test_refused_rate_change_to_44k1():
    """update_config to 44.1 kHz, once refused on the float chain, now
    re-packetizes it to the 44/45 cadence (as many packets as before,
    rounded up to whole 10 ms groups) and runs; then to 96 kHz."""
    eng = Engine(full_chain_config(Platform.RP2350), n_streams=2,
                 device="cpu", pdm=False)
    eng.update_config(full_chain_config(Platform.RP2350, 44100.0))
    assert eng.static.schedule == (44,) * 9 + (45,)
    assert eng.static.block_size == 45
    x = np.random.default_rng(10).integers(-16000, 16000, size=(2, 441, 2))
    out = eng.process(x.astype(np.int32))
    assert out["out"].shape == (NOUT, 441, 2)
    eng.update_config(full_chain_config(Platform.RP2350, 96000.0))
    assert eng.static.block_size == 96 and eng.static.schedule == ()


def test_float_24bit_input():
    """The float Engine at bit_depth=24 against the JAX engine (mxu=True)
    and the golden model, <= 1e-6 relative RMS
    (tests/test_runtime.py::test_float_24bit_input, on the port)."""
    jcfg = rich_config(JPlatform.RP2350, leveller=False, loudness=False,
                       pdm=False)
    je = JEngine(jcfg, n_streams=B, bit_depth=24, pdm=False, mxu=True,
                 unroll=2)
    te = Engine(_convert(jcfg), n_streams=B, bit_depth=24, pdm=False,
                device="cpu")
    assert te.params.unpack_gain.tolist() == np.asarray(
        je.params.unpack_gain).tolist()
    x = make_input(np.random.default_rng(11), 3, 48, B, bit_depth=24)
    got = _np(te.process(x)["out"])
    assert _rel_rms(got, np.asarray(je.process(x)["out"])) < 1e-6
    gold = [golden_run(GoldenDevice(jcfg.copy()), x[..., s:s + 1],
                       bit_depth=24) for s in range(B)]
    want = np.stack([np.stack([np.asarray(p["buf_out"]) for p in gs])
                     for gs in gold], axis=-1)
    assert np.sqrt(np.mean(want.astype(np.float64) ** 2)) > 1e-4
    assert _rel_rms(got, want) < 1e-6
    assert np.abs(got - want).max() < 1e-6


def test_eq_band_type_flip_zeroes_state():
    cfg = full_chain_config(Platform.RP2350)
    te = Engine(cfg, n_streams=2, block_size=BLOCK, pdm=False,
                device="cpu")
    te.process(make_input(np.random.default_rng(8), 2, BLOCK, 2))
    assert te.state.eq_c[0, 1].abs().sum() > 0
    cfg2 = full_chain_config(Platform.RP2350)
    cfg2.eq[0][1] = EqBand(FilterType.PEAKING, 16000.0, 4.0, 3.0)
    te.update_config(cfg2)
    for f in ("eq_a", "eq_b", "eq_c", "eq_d"):
        assert (getattr(te.state, f)[0, 1] == 0).all()


if __name__ == "__main__":
    import sys

    for arg in sys.argv[1:] or [str(SEED)]:
        for f, (vs_jax, vs_golden, jax_vs_golden) in _leveller_errors(
                int(arg, 0)).items():
            print(f"seed {arg} {f}, after {NSEG} segments on the first "
                  f"{NGOLD} streams: port vs JAX engine {vs_jax:.3e}, port "
                  f"vs golden model {vs_golden:.3e}, JAX engine vs golden "
                  f"model {jax_vs_golden:.3e}")
