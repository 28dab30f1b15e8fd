"""The float chain's scan lowering: the port's ``Engine(mxu=False)`` on the
CPU (the float cascade and crossfeed kernels' plain versions) against the
JAX package's ``Engine(mxu=False, unroll=1)`` run from the same params and
state, and against the firmware-semantics golden model.

Cases: the headline chain (``full_chain_config``) at 48 kHz with the PDM
sub, 2 segments of 6 packets (the state carried across); at 44.1 kHz on
the 44/45 cadence, 20 packets; ``rich_config`` (master channels of
unequal band counts, outputs with and without EQ, disabled outputs) at
24-bit input with the device wire words.

Held to the JAX package's own budget for its scan lowering against the
golden model (tests/test_chain.py:test_float_full_chain): ``out`` <= 3e-6
relative RMS, s24 within 16 counts, PDM words mismatched in < 1e-4 of
them.  Against the JAX scan engine: ``out`` and the carried float state
<= 1e-6 relative RMS (XLA:CPU contracts some of its products into fused
multiply-adds, the port rounds every operation), s24 equal wherever the
two engines' ``out`` samples are equal, peaks within 1 LSB, clip flags
equal, PDM words equal up to the first differing modulator input, wire
words equal wherever the two engines' s24 samples are.
"""

import functools

import numpy as np
import pytest

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu_torch.chain import Engine, packet_geometry
from dspi_tpu_torch.kernels import LAUNCHES

from test_torch_chain import _pcm_prefix_equal, _rel_rms
from test_torch_pack import _convert
from test_torch_q28 import _np
from test_torch_schedule import _golden_feed
from util import golden_run, make_input, rich_config

B = 2
SCHED441 = packet_geometry(44100, 20)[1]
# name: (JAX config, engine keywords, segments, packets a segment)
CASES = {
    "48k": (lambda: bench.full_chain_config(JPlatform.RP2350),
            dict(block_size=48), 2, 6),
    "44k1": (lambda: bench.full_chain_config(JPlatform.RP2350, 44100.0),
             dict(schedule=SCHED441, pdm=False), 1, len(SCHED441)),
    "rich_24bit_wire": (lambda: rich_config(JPlatform.RP2350),
                        dict(block_size=48, bit_depth=24, wire=True,
                             pdm=False), 1, 16),
}


@functools.lru_cache(maxsize=None)
def _run(name):
    """Both engines over the case's segments, the port from the JAX
    engine's params and state, and the golden model on every stream:
    ([(jax outputs, port outputs, golden [stream][packet])], je, te,
    the golden devices)."""
    make_cfg, kw, nseg, npkt = CASES[name]
    jcfg = make_cfg()
    je = JEngine(jcfg, n_streams=B, emit="full", mxu=False, unroll=1, **kw)
    te = Engine(_convert(jcfg), n_streams=B, emit="full", mxu=False,
                device="cpu", **kw)
    te.load_params_state(je.params, je.state)
    golds = [GoldenDevice(make_cfg()) for _ in range(B)]
    bits = kw.get("bit_depth", 16)
    rng = np.random.default_rng(0x5CA7)
    runs = []
    for _ in range(nseg):
        if "schedule" in kw:
            x = rng.integers(-16000, 16000,
                             size=(2, sum(kw["schedule"]), B)).astype(
                                 np.int32)
            gold = _golden_feed(golds, x, kw["schedule"], np.ones(npkt))
        else:
            x = make_input(rng, npkt, 48, B, bit_depth=bits)
            gold = [golden_run(g, x[..., s:s + 1], bit_depth=bits)
                    for s, g in enumerate(golds)]
        jo = {k: np.asarray(v) for k, v in je.process(x).items()}
        to = {k: _np(v) for k, v in te.process(x).items()}
        runs.append((jo, to, gold))
    return runs, je, te, golds


def _flat_out(out, sched):
    """emit='full' out -> [nout, Ttot, B] (time-flat already with a
    schedule)."""
    if sched:
        return out
    return np.moveaxis(out, 1, 0).reshape(out.shape[1], -1, out.shape[-1])


def _golden_planes(gold, key):
    """Golden [stream][packet] -> 'buf_out' [nout, Ttot, B] or 'spdif'
    [2*npair, Ttot, B]."""
    if key == "buf_out":
        return np.stack([np.concatenate([np.asarray(p[key]) for p in per],
                                        axis=-1) for per in gold], axis=-1)
    sp = np.stack([np.concatenate([np.asarray(p[key]) for p in per], axis=1)
                   for per in gold], axis=-1)          # [npair, Ttot, 2, B]
    return np.moveaxis(sp, 2, 1).reshape(-1, sp.shape[1], sp.shape[-1])


@pytest.mark.parametrize("name", list(CASES))
def test_scan_engine_matches_golden(name):
    """The JAX package's scan-lowering budget against the golden model."""
    runs, je, te, _ = _run(name)
    sched = te.static.schedule
    for seg, (_, to, gold) in enumerate(runs):
        got = _flat_out(to["out"], sched)
        want = _golden_planes(gold, "buf_out")
        if seg == len(runs) - 1:         # past the 480-sample lookahead
            assert np.sqrt(np.mean(want.astype(np.float64) ** 2)) > 1e-4
        assert _rel_rms(got, want) < 3e-6, (seg, _rel_rms(got, want))
        got24 = _flat_out(to["s24"], sched).astype(np.int64)
        assert np.abs(got24 - _golden_planes(gold, "spdif")).max() <= 16
        if "pdm" in to:
            want_pdm = np.stack([np.array(
                [w for p in per for w in p["pdm_words"]],
                dtype=np.uint32).reshape(-1, 8) for per in gold], axis=-1)
            mismatch = (to["pdm"].view(np.uint32) != want_pdm).mean()
            assert mismatch < 1e-4, (seg, mismatch)


@pytest.mark.parametrize("name", list(CASES))
def test_scan_engine_matches_jax_engine(name):
    runs, je, te, _ = _run(name)
    sched = te.static.schedule
    for seg, (jo, to, _) in enumerate(runs):
        assert set(jo) == set(to), seg
        assert to["out"].shape == jo["out"].shape
        assert _rel_rms(to["out"], jo["out"]) < 1e-6, seg
        same = (_flat_out(to["out"], sched) == _flat_out(jo["out"], sched))
        t24, j24 = (_flat_out(o["s24"], sched) for o in (to, jo))
        ns2 = t24.shape[0]
        assert same[:ns2].mean() > 0.5
        np.testing.assert_array_equal(t24[same[:ns2]], j24[same[:ns2]])
        assert np.abs(to["peaks"].astype(np.int64) - jo["peaks"]).max() <= 1
        if "pdm" in to:
            out_t, out_j = (_flat_out(o["out"], sched) for o in (to, jo))
            assert _pcm_prefix_equal(to["pdm"].view(np.uint32), jo["pdm"],
                                     out_t[-1], out_j[-1]) > 0
        for pair in range(len(te.static.wire)):
            # [Ttot, 4, B] S/PDIF words: L low/high, R low/high
            tw, jw = to[f"wire{pair}"].view(np.uint32), jo[f"wire{pair}"]
            for ch in range(2):
                eq = t24[2 * pair + ch] == j24[2 * pair + ch]     # [Ttot, B]
                w = slice(2 * ch, 2 * ch + 2)
                np.testing.assert_array_equal(
                    np.moveaxis(tw[:, w], 1, -1)[eq],
                    np.moveaxis(jw[:, w], 1, -1)[eq])
    np.testing.assert_array_equal(_np(te.state.clip_flags),
                                  np.asarray(je.state.clip_flags))
    for f in ("loud_a", "loud_b", "eq_a", "eq_b", "eq_c", "eq_d", "lev_gain",
              "xf_lp", "xf_ap", "delay", "lev_la"):
        t, j = _np(getattr(te.state, f)), np.asarray(getattr(je.state, f))
        assert _rel_rms(t, j) < 1e-6, f
    assert int(te.state.wire_pos) == int(je.state.wire_pos)


@pytest.mark.parametrize("name", list(CASES))
def test_scan_leveller_state(name):
    """The leveller's envelope and smoothed gain, which integrate every
    sample's rounding: the port within 1e-6 relative RMS of the golden
    model and no farther from it than the JAX engine (whose XLA:CPU
    program contracts some products into fused multiply-adds); the two
    engines within 3e-6, the end-of-run guard of
    tests/test_torch_chain.py."""
    _, je, te, golds = _run(name)
    gold = {"lev_env": np.stack([g.lev_env for g in golds], axis=-1),
            "lev_gain_db": np.array([g.lev_gain_smooth_db for g in golds])}
    for f, want in gold.items():
        t, j = _np(getattr(te.state, f)), np.asarray(getattr(je.state, f))
        assert _rel_rms(t, want) < 1e-6, (f, _rel_rms(t, want))
        assert _rel_rms(t, want) <= _rel_rms(j, want), f
        assert _rel_rms(t, j) < 3e-6, (f, _rel_rms(t, j))


def test_scan_engine_structure():
    """The scan engine builds no block matrices and, on the CPU, runs
    neither kernel (their plain versions); update_config keeps the
    lowering, as the JAX engine's does."""
    te = _run("48k")[2]
    assert te.blocks is None and not te.static.mxu
    assert te.segment_fn.keywords["blocks"] is None
    cfg = _convert(bench.full_chain_config(JPlatform.RP2350))
    cfg.master_volume_db = -20.0
    eng = Engine(cfg, n_streams=2, mxu=False, pdm=False, device="cpu")
    eng.update_config(_convert(bench.full_chain_config(JPlatform.RP2350,
                                                       44100.0)))
    assert not eng.static.mxu and eng.blocks is None
    assert eng.static.schedule == (44,) * 9 + (45,)
    n0 = dict(LAUNCHES)
    out = eng.process(np.zeros((2, 441, 2), np.int32))
    assert dict(LAUNCHES) == n0
    assert out["out"].shape == (9, 441, 2)
