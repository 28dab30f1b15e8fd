"""The port's runners (``dspi_tpu_torch.runtime.executor``): the twins of
``tests/test_executor.py``, held against the port's own Engine and against
the JAX package's ChainedRunner on the same inputs.

Held to: RP2040 (Q28) folds and every state word equal to the JAX
runner's (its float ``lev_gain_db`` within 1e-5 relative: XLA:CPU fuses
the gain computer into an FMA, README "Fidelity notes"); RP2350 float
state within 1e-6 relative RMS of the JAX runner's, and the folds equal to
the JAX fold formula applied to the port's own outputs; the runners equal
to feeding the segments one at a time; a split over several devices equal
to one device."""

import copy
import struct
import time

import numpy as np
import pytest
import torch

from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.chain.grouped import HeteroServer as JHeteroServer
from dspi_tpu.runtime.executor import ChainedRunner as JChainedRunner
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, HeteroServer, init_state
from dspi_tpu_torch.chain.pack import to_device, to_numpy
from dspi_tpu_torch.control import requests as R
from dspi_tpu_torch.control.device import VirtualDSPi
from dspi_tpu_torch.runtime.executor import (ChainedRunner, RunnerStats,
                                             StreamRunner, ack_fold,
                                             make_mesh, shard_engine)

from test_torch_pack import _convert
from util import make_input, rich_config

CPU = "cpu"
_UNSIGNED = ("pdm", "pdm_sum", "wire_sum")


def _rel_rms(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (np.sqrt(np.mean((got - want) ** 2))
            / (np.sqrt(np.mean(want ** 2)) + 1e-30))


def _jax_fold(out: dict) -> np.float32:
    """The JAX ChainedRunner's ack (executor.py:383-384) in NumPy: each
    output summed in its JAX dtype (int32 or uint32, wrapping), cast to
    float32, added in float32 in sorted key order."""
    total = None
    for k in sorted(out):
        v = out[k].numpy()
        if v.dtype.kind == "f":
            s = np.sum(v, dtype=np.float32)
        else:
            dt = np.uint32 if k in _UNSIGNED or k.startswith("wire") \
                else np.int32
            s = np.sum(v.astype(np.int64).astype(dt), dtype=dt)
        s = np.float32(s)
        total = s if total is None else np.float32(total + s)
    return total


def _states_equal(a, b):
    for f, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


# ----------------------------------------------------------------------------
# StreamRunner
# ----------------------------------------------------------------------------


def test_stream_runner_pipelines_segments(rng):
    """Five segments pumped with two in flight: the last drained output
    is the Engine's for the same segments."""
    cfg = _convert(rich_config(JPlatform.RP2040, leveller=False, pdm=False))
    B = 16
    eng = Engine(cfg, n_streams=B, pdm=False, device=CPU)
    runner = StreamRunner(eng, max_inflight=2)
    ref = Engine(cfg, n_streams=B, pdm=False, device=CPU)
    lasts = []
    for _ in range(5):
        x = make_input(rng, 2, 48, B)
        runner.feed(x)
        lasts.append(ref.process(x)["out"])
    assert len(runner._inflight) == 2
    out = runner.drain()
    assert torch.equal(out["out"], lasts[-1])
    assert runner.stats.segments == 5 and runner.stats.fill_pct == 0
    _states_equal(eng.state, ref.state)


def test_stream_runner_silence_template_resets_on_structural_commit(rng):
    cfg = _convert(rich_config(JPlatform.RP2350, pdm=False))
    eng = Engine(cfg, n_streams=2, pdm=False, device=CPU)
    runner = StreamRunner(eng, max_inflight=1, deadline_s=0.0)
    runner.feed(make_input(rng, 2, 48, 2))
    runner.drain()

    cfg2 = copy.deepcopy(cfg)
    cfg2.sample_rate = 96000.0
    eng.update_config(cfg2)
    time.sleep(0.01)                              # exceed the 0 s deadline
    runner.feed(make_input(rng, 2, 96, 2))        # starves: counted, and the
    out = runner.drain()                          # stale template was reset
    assert runner.stats.starvations_total > 0
    assert runner.stats.silence_segments == 0
    assert out["out"].shape[2] == 96
    assert not runner._inflight


def test_starvation_counting_matches_firmware_totals():
    st = RunnerStats(n_slots=2)
    st.record_starvation()
    st.record_starvation()
    assert st.starvations_slot == [2, 2, 0, 0]
    assert st.starvations_total == 4 == sum(st.starvations_slot)
    st4 = RunnerStats(n_slots=4)
    st4.record_starvation()
    st4.record_starvation(suppressed=True)
    assert st4.starvations_slot == [1, 1, 1, 1]
    assert st4.starvations_total == 4 and st4.starvations_suppressed == 1


# ----------------------------------------------------------------------------
# ChainedRunner against the segments and the JAX runner
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["RP2040", "RP2350"])
def test_chained_runner_matches_segments_and_jax(rng, name):
    """depth=3 chained segments (PDM and device wire words on): the state
    equals feeding the segments one at a time, the folds equal the JAX
    fold of those segments' outputs, and both equal the JAX runner's
    (RP2040 word for word; RP2350 float state within 1e-6)."""
    jcfg = rich_config(JPlatform[name])
    # 4 packets a segment: the leveller's 10 ms lookahead holds the
    # outputs silent for the first 2.5 segments
    depth, npkt, B = 3, 4, 8
    xb = np.stack([make_input(rng, npkt, 48, B) for _ in range(depth)])
    je = JEngine(jcfg, n_streams=B, unroll=2, emit="reduced", wire=True,
                 mxu=name == "RP2350")

    def port():
        e = Engine(_convert(jcfg), n_streams=B, emit="reduced", wire=True,
                   device=CPU)
        e.load_params_state(je.params, je.state)
        return e

    ref = port()
    outs = [ref.process(xb[k]) for k in range(depth)]
    eng = port()
    runner = ChainedRunner(eng, depth=depth)
    folds, peaks, clips = runner.feed(xb)
    assert runner.drain()[0] is folds
    assert runner.stats.segments == depth
    _states_equal(eng.state, ref.state)
    assert torch.equal(peaks, outs[-1]["peaks"])
    assert peaks[2:].ne(0).any(), "the outputs are silent"
    assert torch.equal(clips, ref.state.clip_flags)
    assert folds.dtype == torch.float32 and folds.shape == (depth,)
    np.testing.assert_array_equal(
        folds.numpy(), np.array([_jax_fold(o) for o in outs], np.float32))

    jr = JChainedRunner(je, depth=depth)
    jf, jp, jc = jr.feed(xb)
    jr.drain()
    mine, theirs = to_numpy(eng.state), je.state
    np.testing.assert_array_equal(clips.numpy(), np.asarray(jc))
    if name == "RP2040":
        np.testing.assert_array_equal(folds.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(peaks.numpy(), np.asarray(jp))
        for f, a, b in zip(mine._fields, mine, theirs):
            if a is None:
                assert b is None, f
            elif f == "lev_gain_db":
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)
            else:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    else:
        assert np.abs(peaks.numpy() - np.asarray(jp)).max() <= 1
        for f, a, b in zip(mine._fields, mine, theirs):
            if a is not None and np.asarray(a).dtype.kind == "f":
                assert _rel_rms(a, b) <= 1e-6, f


def test_commit_params_takes_new_coefficients(rng):
    """A master-volume commit reaches the served batches only through
    ``commit_params``: the float chain's block matrices and params are a
    snapshot of the runner."""
    dev = VirtualDSPi(Platform.RP2350)
    dev.set(R.SET_MASTER_VOLUME, 0, struct.pack("<f", 0.0))
    eng = Engine(dev.cfg, n_streams=4, pdm=False, emit="reduced", device=CPU)
    dev.dirty = False
    runner = ChainedRunner(eng, depth=2)
    xb = np.stack([make_input(rng, 3, 48, 4) for _ in range(2)])
    fresh = to_device(init_state(eng.static, 4), CPU)

    def batch():
        eng.state = fresh
        _, peaks, _ = runner.feed(xb)
        runner.drain()
        return int(peaks[2, 0])                 # an output channel's peak

    before = batch()
    assert before > 0
    dev.set(R.SET_MASTER_VOLUME, 0, struct.pack("<f", -40.0))
    assert dev.commit(eng)
    assert batch() == before                    # the snapshot still serves
    runner.commit_params()
    assert batch() < before * 0.05              # -40 dB


def test_update_group_waits_for_commit_params(rng):
    """A float HeteroServer's ``update_group`` builds new block matrices
    beside the old ones (an EQ change lives in them): the runner keeps
    serving its snapshot until ``commit_params``."""
    cfgs = [_convert(rich_config(JPlatform.RP2350, leveller=False,
                                 delays=False, pdm=False))
            for _ in range(2)]
    srv = HeteroServer(cfgs, np.arange(8) % 2, emit="reduced", pdm=False,
                       device=CPU)
    runner = ChainedRunner(srv, depth=1)
    xb = make_input(rng, 2, 48, 8)[None]
    fresh = srv.state

    def batch():
        srv.state = fresh
        _, peaks, _ = runner.feed(xb)
        runner.drain()
        return peaks[2, 0::2]                  # tenant 0's output peaks

    before = batch()
    assert before.min() > 0
    quiet = copy.deepcopy(cfgs[0])
    for ch in (0, 1):                           # a broad -30 dB master cut:
        band = quiet.eq[ch][0]                  # the block matrices change
        quiet.eq[ch][0] = type(band)(band.type, 1000.0, 0.1, -30.0)
    srv.update_group(0, quiet)
    assert torch.equal(batch(), before)        # the snapshot still serves
    runner.commit_params()
    assert (batch() < before * 0.75).all()     # tenant 0 cut


@pytest.mark.parametrize("change", ["rate", "bits"])
def test_structural_commit_rebuilds(rng, change):
    """A sample-rate or bit-depth commit replaces the static: commit_params
    drains, rebuilds and resets the deadline clock."""
    dev = VirtualDSPi(Platform.RP2350)
    dev.set(R.SET_MASTER_VOLUME, 0, struct.pack("<f", 0.0))
    eng = Engine(dev.cfg, n_streams=4, pdm=False, emit="reduced", device=CPU)
    dev.dirty = False
    runner = ChainedRunner(eng, depth=2, deadline_s=0.003)
    dev.attach_runner(runner)
    xb = np.stack([make_input(rng, 3, 48, 4) for _ in range(2)])
    runner.feed(xb)

    if change == "rate":
        dev.set_sample_rate(96000)
    else:
        dev.set_bit_depth(24)
    assert dev.commit(eng)
    runner.commit_params()
    assert runner._static is eng.static and not runner._inflight
    if change == "rate":
        assert eng.static.block_size == 96
        xb = np.stack([make_input(rng, 3, 96, 4) for _ in range(2)])
    else:
        assert eng.static.bit_depth == 24
        xb = np.clip(xb.astype(np.int64) * 256,
                     -(1 << 23), (1 << 23) - 1).astype(np.int32)
    time.sleep(0.01)                             # the rebuild stall
    folds, peaks, _ = runner.feed(xb)
    runner.drain()
    assert runner.stats.starvations_total == 0
    assert torch.isfinite(folds).all() and int(peaks.max()) > 0


def test_hetero_chained_runner_matches_jax(rng):
    """A Q28 HeteroServer under the ChainedRunner, with an update_group +
    commit_params between two batches: folds, peaks and every grouped
    state word equal to the JAX server's."""
    ja = rich_config(JPlatform.RP2040, pdm=False)
    ja.leveller.lookahead = False          # no 10 ms of silent outputs
    jb = copy.deepcopy(ja)
    jb.master_volume_db = -16.0
    B = 16
    ids = np.arange(B) % 2
    xbs = [np.stack([make_input(rng, 2, 48, B) for _ in range(2)])
           for _ in range(2)]
    jsrv = JHeteroServer([ja, jb], ids, emit="reduced", pdm=False, unroll=2,
                         mxu=False)
    srv = HeteroServer([_convert(ja), _convert(jb)], ids, emit="reduced",
                       pdm=False, device=CPU)
    jr, r = JChainedRunner(jsrv, depth=2), ChainedRunner(srv, depth=2)
    for i, xb in enumerate(xbs):
        if i == 1:
            jq, q = copy.deepcopy(ja), _convert(ja)
            jq.master_volume_db = q.master_volume_db = -30.0
            jsrv.update_group(0, jq)
            jr.commit_params()
            srv.update_group(0, q)
            r.commit_params()
        jf, jp, jc = jr.feed(xb)
        jr.drain()
        f, p, c = r.feed(xb)
        r.drain()
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        assert p[2:].ne(0).any(), "the outputs are silent"
    for fld, a, b in zip(srv.state._fields, to_numpy(srv.state),
                         jsrv.state):
        if a is None:
            continue
        if fld == "lev_gain_db":
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=fld)


# ----------------------------------------------------------------------------
# the stream-axis split over several devices
# ----------------------------------------------------------------------------


def _build(kind):
    """The engine of a split case; only the Q28 Engine runs the PDM sub
    (its plain version is slow on the CPU, once a device and sample)."""
    plat = Platform.RP2040 if kind.startswith("q28") else Platform.RP2350
    jplat = JPlatform[plat.name]
    if kind.endswith("hetero"):
        cfgs = [_convert(rich_config(jplat, leveller=False, pdm=False))
                for _ in range(2)]
        cfgs[1].master_volume_db = -16.0
        ids = np.arange(32) % 2
        return HeteroServer(cfgs, ids, emit="reduced", wire=True,
                            device=CPU), 32
    cfg = _convert(rich_config(jplat, pdm=kind == "q28"))
    cfg.leveller.lookahead = False          # no 10 ms of silent outputs
    return Engine(cfg, n_streams=16, emit="reduced", wire=True,
                  device=CPU), 16


def _commit(eng, kind):
    if kind.endswith("hetero"):
        cfg = copy.deepcopy(eng.base.grouped.cfgs[0]
                            if hasattr(eng, "base") else eng.grouped.cfgs[0])
        cfg.master_volume_db = -30.0
        eng.update_group(0, cfg)
    else:
        cfg = copy.deepcopy(eng.cfg)
        cfg.master_volume_db = -30.0
        eng.update_config(cfg)


@pytest.mark.parametrize("kind", ["q28", "float", "q28_hetero",
                                  "float_hetero"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_shard_engine_matches_one_device(rng, kind, n_dev):
    """An engine split over a mesh of n_dev devices (here the CPU, named
    n_dev times) serves two batches with a coefficient commit between
    them as the engine on one device: folds, peaks, clips and the
    gathered state equal, except the float chain's float state, held to
    1e-6 relative RMS (its leveller envelope's products round differently
    with the lane count even on one device, by ~1 ulp)."""
    one, B = _build(kind)
    mesh = make_mesh([torch.device(CPU)] * n_dev)
    split = shard_engine(_build(kind)[0], mesh)
    assert split.mesh is mesh and len(split.state) == n_dev
    runners = ChainedRunner(one, depth=2), ChainedRunner(split, depth=2,
                                                         mesh=mesh)
    for i in range(2):
        xb = np.stack([make_input(rng, 1, 48, B) for _ in range(2)])
        if i == 1:
            for eng, r in zip((one, split), runners):
                _commit(eng, kind)
                r.commit_params()
        (f1, p1, c1), (f2, p2, c2) = [r.feed(xb) for r in runners]
        for r in runners:
            r.drain()
        assert torch.equal(f1, f2) and torch.equal(p1, p2)
        assert torch.equal(c1, c2)
        assert p1[2:].ne(0).any(), "the outputs are silent"
    merged = split.state.merged()
    if kind.startswith("q28"):
        _states_equal(one.state, merged)
        return
    for f, a, b in zip(merged._fields, one.state, merged):
        assert (a is None) == (b is None), f
        if a is None:
            continue
        if a.is_floating_point():
            assert _rel_rms(b, a) <= 1e-6, f
        else:
            assert torch.equal(a, b), f


def test_shard_engine_refuses_indivisible_width():
    cfg = _convert(rich_config(JPlatform.RP2040, pdm=False))
    with pytest.raises(ValueError, match="not divisible by the 4-chip"):
        shard_engine(Engine(cfg, n_streams=6, pdm=False, device=CPU),
                     make_mesh([CPU] * 4))
    srv = HeteroServer([cfg, cfg], np.arange(10) % 2, pdm=False, device=CPU)
    with pytest.raises(ValueError, match="lane_multiple=2"):
        shard_engine(srv, make_mesh([CPU] * 2))
    srv = HeteroServer([cfg, cfg], np.arange(10) % 2, pdm=False,
                       lane_multiple=2, device=CPU)
    assert shard_engine(srv, make_mesh([CPU] * 2)).static is srv.static
    with pytest.raises(ValueError, match="shard the engine"):
        ChainedRunner(Engine(cfg, n_streams=4, pdm=False, device=CPU),
                      mesh=make_mesh([CPU]))


def test_make_mesh_without_a_card():
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_ack_fold_wraps_as_jax(rng):
    """Integer outputs sum with the JAX dtype's wrap: int32 as signed,
    uint32 words and folds as unsigned."""
    out = {"peaks": torch.full((3, 5), 2 ** 31 - 1, dtype=torch.int32),
           "pdm_sum": torch.full((5,), 2 ** 32 - 7, dtype=torch.int64),
           "s24_sum": torch.from_numpy(rng.integers(
               -2 ** 31, 2 ** 31, size=(4, 5)).astype(np.int32)),
           "wire_sum": torch.tensor([2 ** 32 - 1, 12345], dtype=torch.int64)}
    assert ack_fold(out).item() == _jax_fold(out)
    out["pdm"] = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, size=(6, 8, 5)).astype(np.int32))
    assert ack_fold(out).item() == _jax_fold(out)
