"""The Q28 chain at 44.1 kHz: the firmware's 44/45-sample packets at 1 kHz
(current_architecture.md:1092), compiled in as a static per-packet
schedule, against the JAX package's ``Engine(schedule=...)`` (on the CPU,
its lax.scan path) and the golden model fed the same packets.

Held to: every output word and every state word equal to the JAX engine's
over two segments (``lev_gain_db`` excepted, the JAX engine's float
smoothed gain, which XLA:CPU computes with a fused multiply-add; held to
1e-5 relative as in ``tests/test_torch_multi.py``), and the outputs, PDM
words and the whole leveller state equal to the golden model's; for the
periodic cadence and for a schedule with one-sample packets, and across
``update_config`` 48 -> 44.1 -> 48 kHz.  The benchmark's ``rp2040_44k1``
deployment, built from its configuration file, is held to the benchmark's
own golden model (``benchmark/reference``, which imports neither JAX nor
the port): every output word, PDM word and state word.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import config as ref_config
from benchmark.reference import lanes as ref_lanes
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.chain import packet_geometry as jpacket_geometry
from dspi_tpu.chain import pipeline as jpipeline
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, packet_geometry, pipeline
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.core import packets
from dspi_tpu_torch.kernels import tail_cuda
from dspi_tpu_torch.params import types as program_types

from test_torch_multi import assert_state_matches_jax
from test_torch_pack import _convert
from test_torch_q28 import _GOLDEN_FIELDS, _np
from util import make_input, rich_config

B = 2
SCHEDULES = {
    "cadence": (44,) * 9 + (45,),
    "one_sample": (44, 1, 45, 44, 45, 1, 44, 45, 44, 7, 45, 44, 45),
}
MUTE_AT = 3                      # a preset-mute dip at this packet, segment 1


def _mute(n, seg):
    m = np.ones(n, np.float32)
    if seg:
        m[MUTE_AT:MUTE_AT + 2] = (0.5, 0.0)
    return m


def _golden_feed(goldens, x, sched, mute):
    """Feed each stream's golden device the same variable-size packets;
    returns [stream][packet] results."""
    outs = []
    for s, g in enumerate(goldens):
        off, per = 0, []
        for k, t in enumerate(sched):
            frames = np.stack([x[0, off:off + t, s], x[1, off:off + t, s]], 1)
            per.append(g.process_packet(frames, bit_depth=16,
                                        preset_mute_gain=float(mute[k])))
            off += t
        outs.append(per)
    return outs


@functools.lru_cache(maxsize=None)
def _run(name):
    sched = SCHEDULES[name]
    jcfg = rich_config(JPlatform.RP2040, sample_rate=44100.0)
    je = JEngine(jcfg, n_streams=B, schedule=sched, emit="full", unroll=1)
    te = Engine(_convert(jcfg), n_streams=B, schedule=sched, emit="full",
                device="cpu")
    golds = [GoldenDevice(jcfg.copy()) for _ in range(B)]
    rng = np.random.default_rng(0x441)
    outs, gold = [], []
    for seg in range(2):
        x = rng.integers(-16000, 16000,
                         size=(2, sum(sched), B)).astype(np.int32)
        mute = _mute(len(sched), seg)
        outs.append(({k: _np(v) for k, v in je.process(x, mute).items()},
                     {k: _np(v) for k, v in te.process(x, mute).items()}))
        gold.append(_golden_feed(golds, x, sched, mute))
    return outs, je.state, te, gold, golds


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_engine_44k1_matches_jax(name):
    outs, js, te, _, _ = _run(name)
    assert te.static.schedule == SCHEDULES[name]
    assert te.static.block_size == 45
    for seg, (jo, to) in enumerate(outs):
        assert set(jo) == set(to) == {"out", "s24", "peaks", "pdm"}
        assert to["out"].shape == (5, sum(SCHEDULES[name]), B)   # time-flat
        for k in jo:
            got = to[k].view(np.uint32) if k == "pdm" else to[k]
            np.testing.assert_array_equal(got, jo[k], err_msg=f"{seg} {k}")
    assert np.abs(outs[-1][1]["out"]).max() > 1 << 20
    assert_state_matches_jax(te.state, js)


def _run_deployment(name):
    """The benchmark's deployment ``name``, built from its configuration
    file on both sides, over three chained segments of one 441-sample
    group at 4 seeded streams with a preset-mute dip in segment 1: the
    port's CPU path and the reference's golden instances fed the same
    packets."""
    spec = ref_config.load(name)
    n = 4
    block, sched = packet_geometry(spec["device"]["sample_rate"], 10)
    te = Engine(ref_config.build(spec, program_types), n_streams=n,
                block_size=block, schedule=sched, emit="full", pdm=True,
                pdm_fade=False, device="cpu")
    golds = [ref_lanes.device_for(spec) for _ in range(n)]
    rng = np.random.default_rng(0x2040441)
    outs, gold = [], []
    for seg in range(3):
        x = rng.integers(-16000, 16000,
                         size=(2, sum(sched), n)).astype(np.int32)
        mute = _mute(len(sched), seg == 1)
        outs.append({k: _np(v) for k, v in te.process(x, mute).items()})
        gold.append(_golden_feed(golds, x, sched, mute))
    return outs, te, gold, golds, block


def _assert_reference_state(te, golds, block):
    """Every leaf of the port's state equal to the reference's instances',
    in the port's layout (``lev_gain_db`` bit for bit as float32)."""
    want = [ref_lanes.golden_state(g, block) for g in golds]
    for f, v in zip(te.state._fields, te.state):
        if f not in want[0] or want[0][f] is None:
            continue
        w = np.stack([np.asarray(r[f]) for r in want], axis=-1)
        got = _np(v)
        if f == "lev_gain_db":
            got, w = got.view(np.int32), w.astype(np.float32).view(np.int32)
        np.testing.assert_array_equal(
            got.astype(np.int64) & 0xFFFFFFFF,
            w.astype(np.int64) & 0xFFFFFFFF, err_msg=f)


@pytest.mark.parametrize("name", [*SCHEDULES, "rp2040_44k1"])
def test_engine_44k1_matches_golden(name):
    if name in SCHEDULES:
        outs, _, te, gold, golds = _run(name)
        outs = [to for _, to in outs]
    else:
        outs, te, gold, golds, block = _run_deployment(name)
        assert te.static.schedule == (44,) * 9 + (45,)
        assert np.abs(outs[-1]["out"]).max() > 1 << 20
        _assert_reference_state(te, golds, block)
    for seg, to in enumerate(outs):
        want = np.stack([np.concatenate([np.asarray(p["buf_out"])
                                         for p in per], axis=-1)
                         for per in gold[seg]], axis=-1)
        np.testing.assert_array_equal(to["out"], want, err_msg=str(seg))
        want_pdm = np.stack([np.array([w for p in per for w in p["pdm_words"]],
                                      np.uint32).reshape(-1, 8)
                             for per in gold[seg]], axis=-1)
        np.testing.assert_array_equal(to["pdm"].view(np.uint32), want_pdm)
    for f, a in _GOLDEN_FIELDS.items():
        want = np.stack([np.asarray(getattr(g, a)) for g in golds], axis=-1)
        got = _np(getattr(te.state, f))
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)


@functools.lru_cache(maxsize=None)
def _rate_changes():
    """48 -> 44.1 -> 48 kHz through update_config on both engines."""
    jcfg = rich_config(JPlatform.RP2040)
    je = JEngine(jcfg, n_streams=B, block_size=48, emit="full", unroll=1)
    te = Engine(_convert(jcfg), n_streams=B, block_size=48, emit="full",
                device="cpu")
    rng = np.random.default_rng(0x4810)
    steps = []
    for rate in (48000.0, 44100.0, 48000.0):
        if rate != 48000.0 or steps:
            c = rich_config(JPlatform.RP2040, sample_rate=rate)
            je.update_config(c)
            te.update_config(_convert(c))
        st = te.static
        steps.append((st.block_size, st.schedule))
        if st.schedule:
            x = rng.integers(-16000, 16000, size=(2, sum(st.schedule), B)
                             ).astype(np.int32)
        else:
            x = make_input(rng, 10, st.block_size, B)
        steps.append(({k: _np(v) for k, v in je.process(x).items()},
                      {k: _np(v) for k, v in te.process(x).items()}))
    return steps, je, te


def test_update_config_rate_changes_match_jax():
    steps, je, te = _rate_changes()
    geoms = steps[0::2]
    assert geoms == [(48, ()), (45, ((44,) * 9 + (45,))), (48, ())]
    for i, (jo, to) in enumerate(steps[1::2]):
        for k in jo:
            got = to[k].view(np.uint32) if k == "pdm" else to[k]
            assert got.shape == jo[k].shape, (i, k)
            np.testing.assert_array_equal(got, jo[k], err_msg=f"{i} {k}")
    assert je.static.schedule == te.static.schedule == ()
    assert_state_matches_jax(te.state, je.state)


@pytest.mark.parametrize("rate,n", [(44100, 1), (44100, 10), (44100, 13),
                                    (44100, 130), (48000, 7), (96000, 3)])
def test_packet_geometry_matches_jax(rate, n):
    assert packet_geometry(rate, n) == jpacket_geometry(rate, n)


@pytest.mark.parametrize("sched", [(48,) * 4, ((44,) * 9 + (45,)) * 2,
                                   (44, 45) * 3, (44, 1, 45, 7)])
def test_schedule_helpers_match_jax(sched):
    """_pattern_len, _pkts_to_flat and the segment tail's per-packet
    broadcast (``tail_cuda.per_packet``, from the packet ends) give the JAX
    package's words (the port gathers where the JAX package reshapes
    periodic schedules)."""
    s = np.asarray(sched, np.int64)
    ttot = int(s.sum())
    assert packets._pattern_len(s) == jpipeline._pattern_len(s)
    rng = np.random.default_rng(len(sched))
    arr = rng.integers(-2**31, 2**31, size=(len(s), int(s.max()), 3),
                       dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        packets._pkts_to_flat(torch.from_numpy(arr), s, ttot).numpy(),
        np.asarray(jpipeline._pkts_to_flat(jnp.asarray(arr), s, ttot)))
    for width in (1, 3):
        vals = arr[:, 0, :width].copy()
        np.testing.assert_array_equal(
            tail_cuda.per_packet(
                torch.from_numpy(vals),
                torch.from_numpy(np.cumsum(s).astype(np.int32)), ttot).numpy(),
            np.asarray(jpipeline._per_packet(jnp.asarray(vals), s, ttot)))


def test_float_schedule_refused():
    """The float chain's schedule, once refused, runs: an Engine built at
    44.1 kHz on the cadence and one moved there by update_config give the
    same words from the same start (tests/test_torch_float_sched.py holds
    them to the JAX engine and the golden model)."""
    sched = (44,) * 9 + (45,)
    built = Engine(full_chain_config(Platform.RP2350, 44100.0, pdm=False),
                   n_streams=2, schedule=sched, device="cpu")
    moved = Engine(full_chain_config(Platform.RP2350, pdm=False),
                   n_streams=2, device="cpu")
    moved.update_config(full_chain_config(Platform.RP2350, 44100.0,
                                          pdm=False))
    assert moved.static == built.static
    x = np.random.default_rng(12).integers(-16000, 16000,
                                           size=(2, 441, 2)).astype(np.int32)
    a, b = built.process(x), moved.process(x)
    assert a["out"].shape == (9, 441, 2)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_scheduled_input_shape_checked():
    eng = Engine(full_chain_config(Platform.RP2040, 44100.0), n_streams=2,
                 schedule=(44, 45), pdm=False, device="cpu")
    with pytest.raises(ValueError, match=r"x \[2, 89, B\]"):
        eng.process(np.zeros((2, 2, 45, 2), np.int32))
