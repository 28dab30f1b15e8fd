"""Grouped and hetero serving of float (RP2350) configs: the port's
``GroupedEngine`` and ``HeteroServer`` against the JAX package's
``GroupedEngine(mxu=True, layout="vmap")`` (on the CPU) and against one
port ``Engine`` a config.

The port runs the K groups' streams as one flat lane axis: per-group block
matrices applied to each group's contiguous lanes, every elementwise stage
over all lanes with per-lane leaves.  The configs here differ in EQ,
master volume, an output's delay and the leveller's speed (so the
envelope weighs each group with its own alpha).  The JAX engine's params
and vmap-layout state carry in through ``GroupedEngine.load_numpy`` and
the port's back out through ``to_numpy``.

Held to: ``out``/``s24`` <= 1e-6 relative RMS, peaks within 1 LSB, PDM
words equal up to the first differing modulator input, clip flags equal;
the carried float state <= 1e-6 relative RMS (the leveller's envelope and
smoothed gain <= 3e-6, the guard of ``tests/test_torch_chain.py``); the
per-group ``wire_sum`` of reduced emit equal to each group's own engine's.
A segment dispatches at most 1.25x the torch ops of one Engine of as many
lanes, however many groups (no loop over groups; the PDM modulator, one
kernel call on the card, is a loop over samples in its plain version and
is left out of that count).
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dspi_tpu import EqBand, FilterType, Platform as JPlatform
from dspi_tpu.chain import GroupedEngine as JGrouped
from dspi_tpu.runtime.wire_out import WireEncoder
from dspi_tpu_torch.chain import Engine, GroupedEngine, HeteroServer

from test_torch_chain import _pcm_prefix_equal, _rel_rms
from test_torch_pack import _convert
from test_torch_q28 import _np
from util import make_input, rich_config

K, G, NPKT, BLOCK = 3, 2, 8, 48
IDS = np.array([2, 0, 1, 0, 2, 2, 1, 0, 1])      # scattered, unequal counts
SCHED = (44, 45, 44, 45, 44, 1)


def _cfgs(sample_rate=48000.0, platform=JPlatform.RP2350):
    cfgs = []
    for k in range(K):
        c = rich_config(platform, sample_rate=sample_rate)
        c.leveller.lookahead = False         # short segments stay audible
        c.leveller.speed = k % 3
        c.master_volume_db = -6.0 - 3 * k
        c.eq[0][0] = EqBand(FilterType.PEAKING, 100.0 + 60 * k, 1.2, 3.0)
        c.outputs[0].delay_ms = 2.0 + 0.5 * k
        c.sync_delays()
        cfgs.append(c)
    return cfgs


def _quiet(cfg):
    c = cfg.copy()
    c.master_volume_db = -30.0
    c.eq[1][0] = EqBand(FilterType.PEAKING, 300.0, 2.0, -4.0)
    return c


def _grouped_input(rng, schedule=None):
    """[K, NPKT, 2, BLOCK, G] (or [K, 2, sum(schedule), G])."""
    if schedule:
        return rng.integers(-16000, 16000,
                            size=(K, 2, sum(schedule), G)).astype(np.int32)
    return np.moveaxis(make_input(rng, NPKT, BLOCK, K * G).reshape(
        NPKT, 2, BLOCK, K, G), -2, 0).copy()


def _assert_float_outputs(to, jo, label):
    assert set(to) == set(jo), label
    for k in ("out", "s24"):
        assert to[k].shape == jo[k].shape, (label, k)
        assert _rel_rms(to[k], jo[k]) < 1e-6, (label, k)
    assert np.abs(to["peaks"].astype(np.int64) - jo["peaks"]).max() <= 1
    if "pdm" in to:
        assert _pcm_prefix_equal(to["pdm"].view(np.uint32),
                                 np.asarray(jo["pdm"]).view(np.uint32),
                                 to["out"][-1], jo["out"][-1]) > 0


def _flat_pdm(out):
    """A group's emit='full' outputs with 'out' as [nout, Ttot, G]."""
    o = dict(out)
    o["out"] = np.moveaxis(o["out"], 0, 1).reshape(
        o["out"].shape[1], -1, o["out"].shape[-1])
    return o


@functools.lru_cache(maxsize=None)
def _run_jax():
    """The JAX twin (vmap layout) and the port over two segments, with
    update_group(1) between them; the port starts from the JAX engine's
    params and state."""
    jcfgs = _cfgs()
    je = JGrouped(jcfgs, streams_per_group=G, block_size=BLOCK, unroll=4,
                  mxu=True, layout="vmap", emit="full")
    te = GroupedEngine([_convert(c) for c in jcfgs], streams_per_group=G,
                       block_size=BLOCK, emit="full", device="cpu")
    rng = np.random.default_rng(21)
    je.process(_grouped_input(rng))           # a state worth carrying
    te.load_numpy(je.params, je.state)
    outs = []
    for seg in range(2):
        if seg:
            je.update_group(1, _quiet(jcfgs[1]))
            te.update_group(1, _convert(_quiet(jcfgs[1])))
        x = _grouped_input(rng)
        outs.append(({k: np.asarray(v) for k, v in je.process(x).items()},
                     {k: _np(v) for k, v in te.process(x).items()}))
    return outs, je, te


def test_layout_and_carry():
    """Float configs take the vmap layout; the JAX engine's params and
    state carry in and back out in its layout, leaf for leaf."""
    _, je, te = _run_jax()
    assert te.layout == je.layout == "vmap"
    params, state = te.to_numpy()
    for f in params._fields:
        t, j = getattr(params, f), getattr(je.params, f)
        if t is None:
            assert j is None, f
            continue
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=f)
    fresh = GroupedEngine([_convert(c) for c in _cfgs()], streams_per_group=G,
                          block_size=BLOCK, emit="full", device="cpu")
    fresh.load_numpy(params, state)
    for f, a, b in zip(state._fields, te.state, fresh.state):
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_grouped_matches_jax_vmap():
    outs, _, _ = _run_jax()
    for seg, (jo, to) in enumerate(outs):
        for k in range(K):
            _assert_float_outputs(_flat_pdm({n: v[k] for n, v in to.items()}),
                                  _flat_pdm({n: v[k] for n, v in jo.items()}),
                                  f"segment {seg} group {k}")
    assert np.abs(outs[1][1]["out"][1]).max() < np.abs(
        outs[0][1]["out"][1]).max()                       # group 1 quiet


def test_grouped_state_matches_jax_vmap():
    _, je, te = _run_jax()
    _, state = te.to_numpy()
    for f in state._fields:
        t, j = getattr(state, f), getattr(je.state, f)
        if t is None:
            assert j is None, f
            continue
        j = np.asarray(j)
        assert t.shape == j.shape, f
        if t.dtype.kind == "f":
            bound = 3e-6 if f in ("lev_env", "lev_gain_db") else 1e-6
            assert _rel_rms(t, j) < bound, (f, _rel_rms(t, j))
        elif f in ("clip_flags", "wire_pos"):
            np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.mark.parametrize("schedule", [None, SCHED])
def test_groups_match_single_engines(schedule):
    """Each group's outputs against its own port Engine, across an
    update_group (tests/test_grouped.py::test_groups_match_single_engines
    and ::test_grouped_schedule)."""
    cfgs = [_convert(c) for c in _cfgs(44100.0 if schedule else 48000.0)]
    kw = dict(schedule=schedule) if schedule else dict(block_size=BLOCK)
    eng = GroupedEngine(cfgs, streams_per_group=G, emit="full", pdm=False,
                        device="cpu", **kw)
    singles = [Engine(c, n_streams=G, emit="full", pdm=False, device="cpu",
                      **kw) for c in cfgs]
    rng = np.random.default_rng(22)
    for seg in range(2):
        if seg:
            eng.update_group(1, _quiet(cfgs[1]))
            singles[1].update_config(_quiet(cfgs[1]))
        x = _grouped_input(rng, schedule)
        out = {k: _np(v) for k, v in eng.process(x).items()}
        for k in range(K):
            want = {n: _np(v) for n, v in singles[k].process(x[k]).items()}
            # update_config compiles the PDM stage in for an enabled sub
            # output (the JAX engine's rule); the grouped engine has none
            want.pop("pdm", None)
            got = {n: v[k] for n, v in out.items()}
            if not schedule:
                got, want = _flat_pdm(got), _flat_pdm(want)
            _assert_float_outputs(got, want, f"segment {seg} group {k}")


def test_update_group_touches_only_its_group():
    """update_group(1) rebuilds group 1's params and block matrices only:
    groups 0 and 2 give the very words an untouched engine gives."""
    cfgs = [_convert(c) for c in _cfgs()]
    engs = [GroupedEngine(cfgs, streams_per_group=G, block_size=BLOCK,
                          emit="full", pdm=False, device="cpu")
            for _ in range(2)]
    before = [b.clone() for b in engs[1].blocks.a[1]]
    engs[1].update_group(1, _quiet(cfgs[1]))      # its right master EQ
    after = engs[1].blocks.a[1]
    for b, a in zip(before, after):
        assert torch.equal(b[0], a[0]) and torch.equal(b[2], a[2])
        assert not torch.equal(b[1], a[1])
    x = _grouped_input(np.random.default_rng(23))
    base, got = (e.process(x)["out"] for e in engs)
    for k in (0, 2):
        assert torch.equal(got[k], base[k]), k
    assert got[1].abs().sum() < base[1].abs().sum()


def test_static_mismatch_rejected():
    cfgs = [_convert(c) for c in _cfgs()]
    bad = cfgs[1].copy()
    bad.crossfeed.enabled = False
    with pytest.raises(ValueError, match="static structure"):
        GroupedEngine([cfgs[0], bad], streams_per_group=G, device="cpu")
    eng = GroupedEngine(cfgs, streams_per_group=G, pdm=False, device="cpu")
    bad = cfgs[0].copy()
    bad.leveller.enabled = False
    with pytest.raises(ValueError, match="static structure"):
        eng.update_group(0, bad)
    # the flat per-lane layout of float configs needs the scan lowering
    # (tests/test_torch_scan_grouped.py holds its numbers)
    with pytest.raises(NotImplementedError, match="mxu=False"):
        GroupedEngine(cfgs, streams_per_group=G, layout="flat", device="cpu")
    flat = GroupedEngine(cfgs, streams_per_group=G, layout="flat", mxu=False,
                         pdm=False, device="cpu")
    assert flat.blocks is None and flat.params.eq_f32.dim() == 4


def test_hetero_server_matches_per_config_engines():
    """Scattered config ids through the server == one Engine per config
    over its own streams, outputs back in the caller's order; each stream's
    state follows its own data over two segments (tests/test_hetero.py::
    test_hetero_server_state_isolation)."""
    cfgs = [_convert(c) for c in _cfgs()]
    srv = HeteroServer(cfgs, IDS, block_size=BLOCK, emit="full", pdm=False,
                       device="cpu")
    assert srv.grouped.layout == "vmap"
    singles = [Engine(cfgs[k], n_streams=int((IDS == k).sum()),
                      block_size=BLOCK, emit="full", pdm=False, device="cpu")
               for k in range(K)]
    rng = np.random.default_rng(24)
    for seg in range(2):
        x = make_input(rng, NPKT, BLOCK, len(IDS))
        out = {k: _np(v) for k, v in srv.process(x).items()}
        for k in range(K):
            lanes = np.where(IDS == k)[0]
            want = {n: _np(v) for n, v in
                    singles[k].process(x[..., lanes]).items()}
            got = {n: v[..., lanes] for n, v in out.items()}
            _assert_float_outputs(_flat_pdm(got), _flat_pdm(want),
                                  f"segment {seg} config {k}")


def test_per_group_wire_sum():
    """wire=True, emit='reduced': wire_sum [K, npairs], each group's own
    fold of the words that emit='full' gives, which are the JAX package's
    host encoder on the group's own s24 (the float s24 is held to 1e-6, not
    word for word, so the words are compared on the engine's own samples);
    the server keeps the folds per bucket."""
    jcfgs = _cfgs()
    for c in jcfgs:
        c.hardware.output_types = [0, 1, 0, 0]
    cfgs = [_convert(c) for c in jcfgs]
    x = _grouped_input(np.random.default_rng(25))
    outs = {emit: GroupedEngine(cfgs, streams_per_group=G, block_size=BLOCK,
                                emit=emit, wire=True, pdm=False,
                                device="cpu").process(x)
            for emit in ("full", "reduced")}
    got = outs["reduced"]["wire_sum"]
    assert got.shape == (K, 4)
    for k in range(K):
        want = WireEncoder(jcfgs[k], BLOCK).encode(_np(outs["full"]["s24"][k]))
        for pair in range(4):
            words = _np(outs["full"][f"wire{pair}"][k]).view(np.uint32)
            np.testing.assert_array_equal(words, want[f"pair{pair}"])
            assert int(got[k, pair]) == int(words.sum(dtype=np.uint32))
    assert len(set(got[:, 0].tolist())) == K
    srv = HeteroServer(cfgs, IDS, block_size=BLOCK, emit="reduced",
                       wire=True, pdm=False, device="cpu")
    assert srv.process(make_input(np.random.default_rng(26), NPKT, BLOCK,
                                  len(IDS)))["wire_sum"].shape == (K, 4)


@pytest.mark.parametrize("platform", [JPlatform.RP2350, JPlatform.RP2040])
def test_hetero_wire_sum_leaves_out_padding(platform):
    """HeteroServer, wire=True, emit='reduced': each bucket's wire_sum
    [K, npairs] is the fold of its own real streams' words (emit='full',
    caller order), segment after segment; the bucket's padding lanes,
    copies of one of its streams, are left out."""
    ids = np.array([2, 0, 1, 0, 2, 2, 1, 0])        # bucket 1 is padded
    jcfgs = _cfgs(platform=platform)
    for c in jcfgs:
        c.hardware.output_types = [0, 1, 0, 0]
    cfgs = [_convert(c) for c in jcfgs]
    srv = {emit: HeteroServer(cfgs, ids, block_size=BLOCK, emit=emit,
                              wire=True, pdm=False, device="cpu")
           for emit in ("full", "reduced")}
    assert srv["reduced"].padding_waste > 0
    rng = np.random.default_rng(26)
    for seg in range(2):
        x = make_input(rng, NPKT, BLOCK, len(ids))
        full = srv["full"].process(x)
        got = _np(srv["reduced"].process(x)["wire_sum"])
        npairs = srv["full"].static.n_spdif
        assert got.shape == (K, npairs) and f"wire{npairs - 1}" in full
        for k in range(K):
            for pair in range(npairs):
                words = _np(full[f"wire{pair}"])[..., ids == k]
                assert int(got[k, pair]) == int(
                    words.view(np.uint32).sum(dtype=np.uint32)), (seg, k,
                                                                  pair)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(eng, x):
    eng.process(x)                               # warm: caches, layouts
    with _OpCount() as c:
        eng.process(x)
    return c.n


def test_one_launch_sequence_for_all_groups():
    """A grouped segment dispatches the same torch ops whatever K (no loop
    over groups) and at most 1.25x those of one Engine over as many
    lanes."""
    rng = np.random.default_rng(27)
    counts = {}
    npkt = 2
    for k in (2, 4):
        cfgs = [_convert(c) for c in (_cfgs() * 2)[:k]]
        eng = GroupedEngine(cfgs, streams_per_group=G, block_size=BLOCK,
                            emit="reduced", pdm=False, device="cpu")
        x = np.moveaxis(make_input(rng, npkt, BLOCK, k * G).reshape(
            npkt, 2, BLOCK, k, G), -2, 0).copy()
        counts[k] = _ops(eng, x)
    single = _ops(Engine(_convert(_cfgs()[0]), n_streams=4 * G,
                         block_size=BLOCK, emit="reduced", pdm=False,
                         device="cpu"),
                  make_input(rng, npkt, BLOCK, 4 * G))
    assert counts[2] == counts[4]
    assert counts[4] <= 1.25 * single, (counts, single)
