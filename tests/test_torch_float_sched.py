"""The float chain at 44.1 kHz: the firmware's 44/45-sample packets at
1 kHz (current_architecture.md:1092) as a static per-packet schedule, on
the block-matmul lowering, against the JAX package's
``Engine(schedule=..., mxu=True)`` (on the CPU) and the golden model fed
the same packets (``tests/test_schedule.py::test_float_44k1_schedule``).

Schedules, one for each form of the LTI passes' layout (``mxu._layout``):

  * "cadence": the 44/45 cadence twice, 882 samples: the LTI passes
    re-block uniformly (T = 42), the leveller envelope keeps the periodic
    packet grid;
  * "one_sample": (44, 45, 44, 45, 44, 1), 223 samples (a prime, no block
    size): one embedded matrix a packet, an aperiodic envelope and a
    one-sample packet (the gain ramp jumps to its target);
  * "periodic": (44, 45, 44, 45, 45) twice, 446 samples (2 x 223): shared
    matrices per pattern position.

and, against the golden model alone, "rp2350_44k1": the benchmark's
configuration of that name (``benchmark/configs/rp2350_44k1.json``) on
``packet_geometry``'s cadence, as its cell ``rp2350_render_44k1`` builds
the engine, over 3 chained segments of 8 streams.

Held to: ``out``/``s24`` <= 1e-6 relative RMS against the JAX engine and
the golden model; peaks within 1 LSB; PDM words equal up to the first
differing modulator input; a uniform schedule word-equal to the blocked
program.  ``tests/test_torch_float_leveller.py`` reads the leveller after
130 packets.

The block lowering counts its packet-carry steps
(``mxu.COUNTS["carry_steps"]``) and opens the span ``dspi.sched`` around
the work a schedule adds, only where there is a schedule.
"""

import functools

import numpy as np
import pytest
import torch

from benchmark.reference import config as ref_config
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu.params import types as jtypes
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, mxu, packet_geometry
from dspi_tpu_torch.configs import full_chain_config

from test_torch_chain import _pcm_prefix_equal, _rel_rms
from test_torch_pack import _convert
from test_torch_q28 import _np
from test_torch_schedule import _golden_feed
from util import make_input, rich_config

B = 2
SCHEDULES = {
    "cadence": ((44,) * 9 + (45,)) * 2,
    "one_sample": (44, 45, 44, 45, 44, 1),
    "periodic": (44, 45, 44, 45, 45) * 2,
}
# the LTI layout of each: its block size (None: packet-sized matrices) and
# its period (None: uniform or aperiodic)
LTI = {"cadence": (42, 1), "one_sample": (None, None),
       "periodic": (None, 5)}
CELL_CONFIG, CELL_B, CELL_SEGMENTS = "rp2350_44k1", 8, 3


def _full(out):
    return {k: _np(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _run(name):
    """The JAX engine, the port (from the JAX engine's params and state)
    and the golden model over 2 segments, the second with a preset-mute
    dip."""
    sched = SCHEDULES[name]
    jcfg = rich_config(JPlatform.RP2350, sample_rate=44100.0)
    # the 480-sample lookahead would hold a short schedule's segments at 0
    jcfg.leveller.lookahead = sum(sched) > 480
    je = JEngine(jcfg, n_streams=B, schedule=sched, emit="full", mxu=True,
                 unroll=4)
    te = Engine(_convert(jcfg), n_streams=B, schedule=sched, emit="full",
                device="cpu")
    te.load_params_state(je.params, je.state)
    golds = [GoldenDevice(jcfg.copy()) for _ in range(B)]
    rng = np.random.default_rng(0x4410)
    outs, gold = [], []
    for seg in range(2):
        x = rng.integers(-16000, 16000,
                         size=(2, sum(sched), B)).astype(np.int32)
        mute = np.ones(len(sched), np.float32)
        if seg:
            mute[1:3] = (0.5, 0.0)
        outs.append((_full(je.process(x, mute)), _full(te.process(x, mute))))
        gold.append(_golden_feed(golds, x, sched, mute))
    return outs, je, te, gold


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lti_layout(name):
    """The LTI passes' layout, the JAX package's rule (``_lti_block``)."""
    static = Engine(full_chain_config(Platform.RP2350, 44100.0), 1,
                    schedule=SCHEDULES[name], pdm=False, device="cpu").static
    lay = mxu.sched_layout(static, 0, lti=True)
    block, period = LTI[name]
    assert lay.uniform == (block is not None)
    assert (lay.tmax == block) if block else lay.tmax == 45
    assert lay.period == period


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_float_44k1_matches_jax_engine(name):
    outs, _, te, _ = _run(name)
    ttot = sum(SCHEDULES[name])
    for seg, (jo, to) in enumerate(outs):
        assert set(jo) == set(to) == {"out", "s24", "peaks", "pdm"}
        assert to["out"].shape == (9, ttot, B)             # time-flat
        assert np.sqrt(np.mean(jo["out"].astype(np.float64) ** 2)) > 1e-4
        for k in ("out", "s24"):
            assert _rel_rms(to[k], jo[k]) < 1e-6, (seg, k)
        assert np.abs(to["peaks"] - jo["peaks"]).max() <= 1
        assert _pcm_prefix_equal(to["pdm"].view(np.uint32), jo["pdm"],
                                 to["out"][-1], jo["out"][-1]) > 0


@functools.lru_cache(maxsize=None)
def _run_cell():
    """The port on the benchmark's ``rp2350_44k1`` configuration, built as
    its cell builds it (``packet_geometry``'s cadence, one 10 ms group a
    segment, the PDM sub on without its fade-in), and the golden model on
    the same packets, over chained segments of seeded s16 at +-16000."""
    jcfg = ref_config.build(ref_config.load(CELL_CONFIG), jtypes)
    block, sched = packet_geometry(jcfg.sample_rate, 10)
    te = Engine(_convert(jcfg), n_streams=CELL_B, block_size=block,
                schedule=sched, emit="full", pdm_fade=False, device="cpu")
    golds = [GoldenDevice(jcfg.copy()) for _ in range(CELL_B)]
    rng = np.random.default_rng(0x44100)
    mute = np.ones(len(sched), np.float32)
    outs, gold = [], []
    for _ in range(CELL_SEGMENTS):
        x = rng.integers(-16000, 16000,
                         size=(2, sum(sched), CELL_B)).astype(np.int32)
        outs.append((None, _full(te.process(x, mute))))
        gold.append(_golden_feed(golds, x, sched, mute))
    return outs, gold


@pytest.mark.parametrize("name", list(SCHEDULES) + [CELL_CONFIG])
def test_float_44k1_matches_golden(name):
    if name == CELL_CONFIG:
        outs, gold = _run_cell()
        assert len(outs) == CELL_SEGMENTS
    else:
        outs, _, _, gold = _run(name)
    for seg, (_, to) in enumerate(outs):
        B = to["out"].shape[-1]
        want = np.stack([np.concatenate([np.asarray(p["buf_out"])
                                         for p in per], axis=-1)
                         for per in gold[seg]], axis=-1)
        assert _rel_rms(to["out"], want) < 1e-6, seg
        spdif = np.stack([np.concatenate([np.asarray(p["spdif"])
                                          for p in per], axis=1)
                          for per in gold[seg]], axis=-1)  # [4, Ttot, 2, B]
        want24 = np.moveaxis(spdif, 2, 1).reshape(8, -1, B)
        assert _rel_rms(to["s24"], want24) < 1e-6, seg
        gpeaks = np.max([[p["peaks"] for p in per] for per in gold[seg]],
                        axis=1).T
        assert np.abs(to["peaks"] - gpeaks).max() <= 1


def test_uniform_schedule_equals_blocked():
    """A uniform schedule reproduces the fixed-block program word for word
    (tests/test_schedule.py::test_uniform_schedule_equals_blocked, on the
    float chain): the same math, another plumbing."""
    cfg = _convert(rich_config(JPlatform.RP2350))
    rng = np.random.default_rng(0x48)
    blocked = Engine(cfg, n_streams=B, block_size=48, device="cpu")
    sched = Engine(cfg, n_streams=B, schedule=(48,) * 6, device="cpu")
    for _ in range(2):
        x4 = make_input(rng, 6, 48, B)
        out_b = blocked.process(x4)
        out_s = sched.process(np.moveaxis(x4, 1, 0).reshape(2, 6 * 48, B))
        want = out_b["out"].movedim(0, 1).reshape(out_s["out"].shape)
        assert torch.equal(out_s["out"], want)
        assert torch.equal(out_s["peaks"], out_b["peaks"])
        assert torch.equal(out_s["pdm"], out_b["pdm"])
    for f, a, b in zip(blocked.state._fields, blocked.state, sched.state):
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_update_config_48_to_44k1_matches_jax():
    """update_config 48 -> 44.1 kHz on both engines: the port re-packetizes
    to the 44/45 cadence, rebuilds its block matrices and carries its
    filter state, as the JAX engine does."""
    jcfg = rich_config(JPlatform.RP2350, leveller=False)
    je = JEngine(jcfg, n_streams=B, block_size=48, emit="full", mxu=True,
                 unroll=4)
    te = Engine(_convert(jcfg), n_streams=B, block_size=48, emit="full",
                device="cpu")
    rng = np.random.default_rng(0x4844)
    x = make_input(rng, 10, 48, B)
    outs = [(_full(je.process(x)), _full(te.process(x)))]
    c = rich_config(JPlatform.RP2350, sample_rate=44100.0, leveller=False)
    je.update_config(c)
    te.update_config(_convert(c))
    assert te.static.schedule == je.static.schedule == (44,) * 9 + (45,)
    assert te.static.block_size == 45
    for _ in range(2):
        x = rng.integers(-16000, 16000, size=(2, 441, B)).astype(np.int32)
        outs.append((_full(je.process(x)), _full(te.process(x))))
    for i, (jo, to) in enumerate(outs):
        for k in ("out", "s24"):
            assert to[k].shape == jo[k].shape, (i, k)
            assert _rel_rms(to[k], jo[k]) < 1e-6, (i, k)
    assert outs[-1][1]["out"].shape == (9, 441, B)


def _steps_a_segment(rate, n_packets):
    """The block lowering's carry steps a segment of the full chain at
    ``rate`` (``packet_geometry``'s packets): two master cascades, the
    crossfeed and the output cascades over the LTI layout's blocks, and the
    envelope over the real packets."""
    block, sched = packet_geometry(rate, n_packets)
    key = (tuple(sched or ()), block, len(sched or ()) or n_packets)
    return (4 * len(mxu._layout(*key, True).sched)
            + len(mxu._layout(*key, False).sched))


@pytest.mark.parametrize("rate,n_packets,steps,cell_packets,at_cell", [
    (44100.0, 10, 4 * 9 + 10, 130, 4 * 147 + 130),
    (48000.0, 4, 5 * 4, 128, 5 * 128)])
def test_carry_steps_count_the_layouts_steps(rate, n_packets, steps,
                                             cell_packets, at_cell):
    """``mxu.COUNTS["carry_steps"]`` grows by the layout's steps a segment
    (44.1 kHz: 441 samples re-blocked to 9 blocks of 49 and 10 packets; 48
    kHz: 4 packets), and the layout at the cells' shapes gives 718 (130
    packets: 147 blocks of 39) and 640 (128 packets of 48)."""
    assert _steps_a_segment(rate, n_packets) == steps
    assert _steps_a_segment(rate, cell_packets) == at_cell
    block, sched = packet_geometry(rate, n_packets)
    eng = Engine(full_chain_config(Platform.RP2350, rate), 2,
                 block_size=block, schedule=sched, pdm=False,
                 emit="reduced", device="cpu")
    x = (np.zeros((2, sum(sched), 2), np.int32) if sched
         else np.zeros((n_packets, 2, block, 2), np.int32))
    before = mxu.COUNTS["carry_steps"]
    for _ in range(2):
        eng.process(x)
    assert mxu.COUNTS["carry_steps"] - before == 2 * steps


@pytest.mark.parametrize("platform,rate,geometry", [
    (Platform.RP2350, 44100.0, None), (Platform.RP2350, 48000.0, None),
    (Platform.RP2040, 44100.0, (3, (2, 3), 2)),
    (Platform.RP2040, 48000.0, (3, None, 2))],
    ids=["44100.0", "48000.0", "rp2040-44100.0", "rp2040-48000.0"])
def test_sched_span_opens_only_on_a_schedule(platform, rate, geometry):
    """A profiled segment of either chain opens ``dspi.sched`` on a packet
    schedule (the float chain's 44/45 cadence), and none on uniform
    packets (48 kHz), whose segment runs no schedule work.  The Q28
    chain's plain sample loops leave ~0.4 s of profiler events a sample,
    so its cases take two packets of a few samples: (block, schedule,
    packets)."""
    block, sched, npkt = geometry or (*packet_geometry(rate, 10), 10)
    eng = Engine(full_chain_config(platform, rate), 2,
                 block_size=block, schedule=sched, pdm=False,
                 emit="reduced", device="cpu")
    x = (np.zeros((2, sum(sched), 2), np.int32) if sched
         else np.zeros((npkt, 2, block, 2), np.int32))
    eng.process(x)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.process(x)
    names = {e.name for e in prof.events()}
    assert "dspi.segment" in names
    assert ("dspi.sched" in names) == (sched is not None)
