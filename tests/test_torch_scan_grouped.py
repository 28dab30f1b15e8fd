"""Per-stream float parameters on the scan lowering: the port's
``build_params_multi`` float trees, an ``Engine(mxu=False)`` loading
them, and ``GroupedEngine``/``HeteroServer`` on float scan statics in the
flat per-lane layout, against the JAX package's
``HeteroServer(..., mxu=False, layout="flat")`` (on the CPU), and a
``ChainedRunner`` and a split over devices (``shard_engine``) of a scan
server.

The configs (tests/test_torch_float_grouped.py's) differ in EQ, master
volume, an output's delay and the leveller's speed, so every scan-A leaf
but the loudness row is per lane, the delay ring is read through a
per-lane gather and the output EQ runs per lane too.  Held to: ``out``/
``s24`` <= 1e-6 relative RMS against the JAX server, peaks within 1 LSB;
the carried float state <= 1e-6 relative RMS (the leveller's envelope and
smoothed gain <= 3e-6, the guard of tests/test_torch_chain.py), clip
flags equal; a flat engine's segments equal to one Engine a config.
"""

import functools

import numpy as np
import pytest
import torch

from dspi_tpu.chain import pack as jpack
from dspi_tpu.chain.grouped import HeteroServer as JHeteroServer
from dspi_tpu.params.design import derive as jderive
from dspi_tpu_torch.chain import Engine, GroupedEngine, HeteroServer, pack
from dspi_tpu_torch.params.design import derive
from dspi_tpu_torch.runtime.executor import (ChainedRunner, make_mesh,
                                             shard_engine)

from test_torch_chain import _rel_rms
from test_torch_float_grouped import (BLOCK, IDS, K, NPKT,
                                      _assert_float_outputs, _cfgs, _quiet)
from test_torch_pack import _convert, _eq_tree
from test_torch_q28 import _np
from util import make_input

SCAN = dict(block_size=BLOCK, emit="full", pdm=False, mxu=False)


def test_build_params_multi_float_trees():
    """Per-stream float trees on a scan static, array for array the JAX
    package's (config-uniform leaves collapsed); a block-matmul static
    refuses them."""
    jcfgs = _cfgs()
    jd = [jderive(c) for c in jcfgs]
    jst = jpack.build_static(jd[0], block_size=BLOCK, mxu=False)
    ids = IDS
    want = jpack.build_params_multi(jd, jst, ids)
    td = [derive(_convert(c)) for c in jcfgs]
    st = pack.build_static(td[0], block_size=BLOCK, mxu=False)
    got = pack.build_params_multi(td, st, ids)
    _eq_tree(got, want)
    assert got.eq_f32.shape[-1] == len(ids) and got.lev.ndim == 2
    with pytest.raises(ValueError, match="scan path"):
        pack.build_params_multi(td, pack.build_static(td[0],
                                                      block_size=BLOCK))


def test_per_stream_tree_loads_on_a_scan_engine_only():
    """An Engine(mxu=False) loads a per-stream float tree, and each stream
    then runs as one Engine of its own config; a block-matmul engine
    refuses the tree."""
    cfgs = [_convert(c) for c in _cfgs()]
    d = [derive(c) for c in cfgs]
    eng = Engine(cfgs[0], n_streams=len(IDS), device="cpu", **SCAN)
    multi = pack.build_params_multi(d, eng.static, IDS)
    eng.load_params_state(multi, pack.init_state(eng.static, len(IDS)))
    assert eng.params.eq_f32.dim() == 4 and eng.blocks is None
    x = make_input(np.random.default_rng(3), NPKT, BLOCK, len(IDS))
    got = {k: _np(v) for k, v in eng.process(x).items()}
    for k in range(K):
        lanes = np.where(IDS == k)[0]
        single = Engine(cfgs[k], n_streams=len(lanes), device="cpu", **SCAN)
        want = {n: _np(v) for n, v in single.process(x[..., lanes]).items()}
        _assert_float_outputs({n: v[..., lanes] for n, v in got.items()},
                              want, f"config {k}")
    mxu_eng = Engine(cfgs[0], n_streams=len(IDS), pdm=False, device="cpu")
    with pytest.raises(ValueError, match="scan path"):
        mxu_eng.load_params_state(multi,
                                  pack.init_state(mxu_eng.static, len(IDS)))


@functools.lru_cache(maxsize=None)
def _run_jax():
    """The JAX flat scan server and the port's over two segments, with
    update_group(1) between them; the port starts from the JAX server's
    params and state (``load_numpy``)."""
    jcfgs = _cfgs()
    js = JHeteroServer(jcfgs, IDS, unroll=1, mxu=False, layout="flat", **{
        k: v for k, v in SCAN.items() if k != "mxu"})
    ts = HeteroServer([_convert(c) for c in jcfgs], IDS, device="cpu",
                      **SCAN)
    rng = np.random.default_rng(31)
    js.process(make_input(rng, NPKT, BLOCK, len(IDS)))   # a state to carry
    ts.grouped.load_numpy(js.grouped.params, js.grouped.state)
    outs = []
    for seg in range(2):
        if seg:
            js.update_group(1, _quiet(jcfgs[1]))
            ts.update_group(1, _convert(_quiet(jcfgs[1])))
        x = make_input(rng, NPKT, BLOCK, len(IDS))
        outs.append(({k: np.asarray(v) for k, v in js.process(x).items()},
                     {k: _np(v) for k, v in ts.process(x).items()}))
    return outs, js, ts


def test_hetero_flat_matches_jax():
    outs, js, ts = _run_jax()
    assert js.grouped.layout == ts.grouped.layout == "flat"
    assert ts.grouped.blocks is None
    assert ts.grouped.params.eq_f32.dim() == 4           # per lane
    for seg, (jo, to) in enumerate(outs):
        _assert_float_outputs(to, jo, f"segment {seg}")
    quiet = np.where(IDS == 1)[0]
    assert np.abs(outs[1][1]["out"][..., quiet]).max() < np.abs(
        outs[0][1]["out"][..., quiet]).max()


def test_hetero_flat_state_matches_jax():
    _, js, ts = _run_jax()
    params, state = ts.grouped.to_numpy()
    _eq_tree(params, js.grouped.params)
    for f in state._fields:
        t, j = getattr(state, f), getattr(js.grouped.state, f)
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


def test_grouped_flat_load_numpy_then_update_group():
    """A flat GroupedEngine on a scan static: ``load_numpy`` of the JAX
    server's flat trees (its group 1 quietened), then ``update_group`` of
    group 2 keeps the other groups as loaded; each group equals one scan
    Engine of its config from the same state."""
    _, js, _ = _run_jax()
    cfgs = [_convert(c) for c in _cfgs()]
    G = js.grouped.streams_per_group
    eng = GroupedEngine(cfgs, streams_per_group=G, device="cpu", **SCAN)
    assert eng.layout == "flat" and eng.blocks is None
    eng.load_numpy(js.grouped.params, js.grouped.state)
    eng.update_group(2, _quiet(cfgs[2]))
    singles = [Engine(c, n_streams=G, device="cpu", **SCAN)
               for c in (cfgs[0], _quiet(cfgs[1]), _quiet(cfgs[2]))]
    st = pack.to_numpy(eng.state)
    for k, s in enumerate(singles):
        s.load_params_state(
            pack.to_numpy(s.params),
            type(st)(*[None if v is None else v if f == "wire_pos"
                       else v[..., k * G:(k + 1) * G]
                       for f, v in zip(st._fields, st)]))
    rng = np.random.default_rng(7)
    x = np.stack([make_input(rng, NPKT, BLOCK, G) for _ in range(K)])
    out = {k: _np(v) for k, v in eng.process(x).items()}
    for k, s in enumerate(singles):
        want = {n: _np(v) for n, v in s.process(x[k]).items()}
        _assert_float_outputs({n: v[k] for n, v in out.items()}, want,
                              f"group {k}")


def test_flat_float_layout_needs_the_scan_lowering():
    cfgs = [_convert(c) for c in _cfgs()]
    with pytest.raises(NotImplementedError, match="mxu=False"):
        GroupedEngine(cfgs, streams_per_group=2, layout="flat",
                      device="cpu")
    assert GroupedEngine(cfgs, streams_per_group=2, mxu=False,
                         device="cpu").layout == "flat"


def test_chained_runner_over_a_scan_engine():
    """A ChainedRunner over a flat scan HeteroServer: its state equals
    feeding the segments one at a time, its peaks the last segment's."""
    cfgs = [_convert(c) for c in _cfgs()]
    rng = np.random.default_rng(12)
    depth = 2
    xb = np.stack([make_input(rng, NPKT, BLOCK, len(IDS))
                   for _ in range(depth)])
    kw = dict(SCAN, emit="reduced")
    ref = HeteroServer(cfgs, IDS, device="cpu", **kw)
    outs = [ref.process(xb[k]) for k in range(depth)]
    srv = HeteroServer(cfgs, IDS, device="cpu", **kw)
    runner = ChainedRunner(srv, depth=depth)
    folds, peaks, clips = runner.feed(xb)
    runner.drain()
    assert torch.equal(peaks, outs[-1]["peaks"])
    assert torch.equal(clips, ref.state.clip_flags)
    for f, a, b in zip(srv.state._fields, srv.state, ref.state):
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_shard_engine_splits_a_scan_server():
    """A flat scan HeteroServer split over a mesh of 2 devices (the CPU,
    named twice) serves as the server on one device, every output and
    state word equal: the scan lowering's arithmetic is elementwise over
    the lanes, so the split does not change how anything rounds."""
    cfgs = [_convert(c) for c in _cfgs()]
    kw = dict(SCAN, emit="reduced", lane_multiple=2)
    one = HeteroServer(cfgs, IDS, device="cpu", **kw)
    split = shard_engine(HeteroServer(cfgs, IDS, device="cpu", **kw),
                         make_mesh([torch.device("cpu")] * 2))
    rng = np.random.default_rng(13)
    for _ in range(2):
        x = make_input(rng, NPKT, BLOCK, len(IDS))
        a, b = one.process(x), split.process(x)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for f, u, v in zip(one.state._fields, one.state, split.state.merged()):
        assert (u is None) == (v is None), f
        if u is not None:
            assert torch.equal(u, v), f
