"""The port's GroupedEngine and HeteroServer on Q28 configs against their
JAX twins (on the CPU, where the JAX package runs its lax.scan path).

Both packages lower the groups flat: one K*G lane axis with per-lane
coefficients (``build_params_multi``).  The configs here differ in EQ,
master volume and an output's delay, so the EQ rows run per lane and the
delay ring is read through the per-lane gather (the JAX twins are built
with ``layout="flat"``; their ``auto`` would take per-lane delays to the
vmapped layout, which the port does not have).

Held to: every output word and every grouped-state word equal, segment
after segment and across ``update_group``, except ``lev_gain_db``, the JAX
engine's float smoothed gain, which XLA:CPU computes with a fused
multiply-add (``tests/test_torch_q28.py``; held to 1e-5 relative, as in
``tests/test_torch_multi.py``).
"""

import functools

import numpy as np
import pytest
import torch

from dspi_tpu import EqBand, FilterType, Platform as JPlatform
from dspi_tpu.chain import GroupedEngine as JGrouped
from dspi_tpu.chain.grouped import HeteroServer as JHetero
from dspi_tpu_torch.chain import GroupedEngine, HeteroServer
from dspi_tpu_torch.chain.pack import ChainParams

from test_torch_multi import assert_state_matches_jax
from test_torch_pack import _convert
from test_torch_q28 import _np
from util import make_input, rich_config

K, G, NPKT, BLOCK = 3, 2, 8, 48
IDS = np.array([2, 0, 1, 0, 2, 2, 1, 0, 1])      # scattered, unequal counts
SCHED = (44, 45, 44)


def _cfgs(platform=JPlatform.RP2040, lookahead=True):
    cfgs = []
    for k in range(K):
        c = rich_config(platform)
        c.leveller.lookahead = lookahead
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


def _inputs(seed, schedule, lanes, groups=None):
    """Two segments of input: [K, NPKT, 2, BLOCK, G] per segment for a
    grouped engine (``groups``), [NPKT, 2, BLOCK, B] for a server; the
    time-flat [.., 2, sum(SCHED), ..] forms with a schedule."""
    rng = np.random.default_rng(seed)
    segs = []
    for _ in range(2):
        if schedule:
            shape = (2, sum(SCHED), lanes)
            x = rng.integers(-16000, 16000, size=shape).astype(np.int32)
        else:
            x = make_input(rng, NPKT, BLOCK, lanes)
        if groups:
            x = np.moveaxis(x.reshape(x.shape[:-1] + (groups, G)), -2, 0)
        segs.append(np.ascontiguousarray(x))
    return segs


@functools.lru_cache(maxsize=None)
def _run(kind):
    """The JAX twin and the port over two segments, with update_group(1)
    between them; returns per-segment outputs and both final engines."""
    sched = SCHED if kind == "grouped_sched" else None
    # two scheduled segments are shorter than the 480-sample lookahead
    jcfgs = _cfgs(lookahead=not sched)
    cfgs = [_convert(c) for c in jcfgs]
    kw = dict(emit="full", schedule=sched)
    if kind == "hetero":
        je = JHetero(jcfgs, IDS, unroll=1, mxu=False, layout="flat", **kw)
        te = HeteroServer(cfgs, IDS, device="cpu", **kw)
        xs = _inputs(5, sched, len(IDS))
    else:
        je = JGrouped(jcfgs, streams_per_group=G, block_size=BLOCK, unroll=1,
                      mxu=False, layout="flat", **kw)
        te = GroupedEngine(cfgs, streams_per_group=G, block_size=BLOCK,
                           device="cpu", **kw)
        xs = _inputs(6, sched, K * G, groups=K)
    outs = []
    for seg, x in enumerate(xs):
        if seg:
            je.update_group(1, _quiet(jcfgs[1]))
            te.update_group(1, _quiet(cfgs[1]))
        outs.append(({k: _np(v) for k, v in je.process(x).items()},
                     {k: _np(v) for k, v in te.process(x).items()}))
    return outs, je, te


@pytest.mark.parametrize("kind", ["grouped", "hetero", "grouped_sched"])
def test_outputs_match_jax(kind):
    outs, _, _ = _run(kind)
    for seg, (jo, to) in enumerate(outs):
        assert set(jo) == set(to) == {"out", "s24", "peaks", "pdm"}
        for k in jo:
            got = to[k].view(np.uint32) if k == "pdm" else to[k]
            assert got.shape == jo[k].shape, (seg, k)
            np.testing.assert_array_equal(got, jo[k], err_msg=f"{seg} {k}")
    assert np.abs(outs[-1][1]["out"]).max() > 1 << 20


@pytest.mark.parametrize("kind", ["grouped", "hetero", "grouped_sched"])
def test_grouped_state_matches_jax(kind):
    _, je, te = _run(kind)
    assert_state_matches_jax(te.state, je.state)


def test_params_and_layout_match_jax():
    """The flat per-lane params (per-lane EQ, volumes and delays; uniform
    leaves collapsed) and the layout name, after update_group."""
    _, je, te = _run("grouped")
    assert te.layout == je.layout == "flat"
    assert te.params.eq_q28.dim() == 4 and te.params.delay_samples.dim() == 2
    for f, t in zip(te.params._fields, te.params):
        j = getattr(je.params, f)
        if t is None:
            assert j is None, f
            continue
        np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=f)


def test_update_group_touches_only_its_group():
    outs, _, _ = _run("grouped")
    fresh = GroupedEngine([_convert(c) for c in _cfgs()], streams_per_group=G,
                          block_size=BLOCK, emit="full", device="cpu")
    xs = _inputs(6, None, K * G, groups=K)
    fresh.process(xs[0])
    want = fresh.process(xs[1])["out"].numpy()
    got = outs[1][1]["out"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert np.abs(got[1]).sum() < np.abs(want[1]).sum()


@pytest.mark.parametrize("layout", ["flat", "vmap"])
def test_load_numpy_then_update_group_keeps_other_groups(layout):
    """load_numpy replaces every group's params (here the construction's
    quiet ones by another engine's); a later update_group rebuilds group 1
    only, so the other groups keep what was loaded: params and outputs
    equal those of the engine the params came from, after the same
    update."""
    cfgs = [_convert(c) for c in _cfgs()]
    kw = dict(streams_per_group=G, block_size=BLOCK, emit="full",
              layout=layout, pdm=False, device="cpu")
    src = GroupedEngine(cfgs, **kw)
    eng = GroupedEngine([_quiet(c) for c in cfgs], **kw)
    eng.load_numpy(*src.to_numpy())
    new = _quiet(cfgs[1])
    new.master_volume_db = -12.0
    for e in (src, eng):
        e.update_group(1, new)
    for f, a, b in zip(ChainParams._fields, eng.to_numpy()[0],
                       src.to_numpy()[0]):
        np.testing.assert_array_equal(a, b, err_msg=f)
    x = _inputs(12, None, K * G, groups=K)[0]
    a, b = eng.process(x), src.process(x)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("ids,width", [
    ([0] * 6 + [1, 2], 6), (np.arange(1500) % 3, 512),
    (np.arange(402) % 3, 134), (np.arange(12) % 3, 8)])
def test_hetero_bucket_widths_match_jax(ids, width):
    """The bucket width, its padding and the grouped state's lane count are
    the JAX server's (lane_multiple=8 in the last case)."""
    jcfgs = _cfgs()
    lm = 8 if len(ids) == 12 else 1
    js = JHetero(jcfgs, ids, lane_multiple=lm, pdm=False, unroll=1,
                 mxu=False, layout="flat")
    ts = HeteroServer([_convert(c) for c in jcfgs], ids, lane_multiple=lm,
                      pdm=False, device="cpu")
    assert ts.grouped.streams_per_group == js.grouped.streams_per_group \
        == width
    assert ts.padding_waste == js.padding_waste
    assert ts.state.lev_env.shape == np.shape(js.state.lev_env)
    np.testing.assert_array_equal(ts._perm.numpy(), np.asarray(js._perm))
    np.testing.assert_array_equal(ts._inv.numpy(), np.asarray(js._inv))


def test_segment_fns_equal_process():
    """segment_fn (grouped contract, and the server's caller order) and
    flat_segment_fn give what process gives."""
    cfgs = [_convert(c) for c in _cfgs()]
    eng = GroupedEngine(cfgs, streams_per_group=G, block_size=BLOCK,
                        emit="reduced", pdm=False, device="cpu")
    x = torch.from_numpy(_inputs(8, None, K * G, groups=K)[0])
    st0 = eng.state
    _, a = eng.segment_fn(eng.params, st0, x, None)
    _, b = eng.flat_segment_fn(eng.params, st0,
                               x.movedim(0, -2).reshape(NPKT, 2, BLOCK,
                                                        K * G), None)
    c = eng.process(x)
    for k in c:
        assert torch.equal(a[k], c[k])
        assert torch.equal(b[k].reshape(*b[k].shape[:-1], K, G)
                           .movedim(-2, 0), c[k])
    srv = HeteroServer(cfgs, IDS, emit="reduced", pdm=False, device="cpu")
    xs = torch.from_numpy(_inputs(9, None, len(IDS))[0])
    _, d = srv.segment_fn(srv.params, srv.state, xs, None)
    for k, v in srv.process(xs).items():
        assert torch.equal(d[k], v)


def test_refusals():
    cfgs = [_convert(c) for c in _cfgs()]
    bad = cfgs[1].copy()
    bad.crossfeed.enabled = False                  # structural difference
    with pytest.raises(ValueError, match="static structure"):
        GroupedEngine([cfgs[0], bad], streams_per_group=G, device="cpu")
    eng = GroupedEngine(cfgs, streams_per_group=G, device="cpu", pdm=False)
    bad = cfgs[0].copy()
    bad.leveller.enabled = False
    with pytest.raises(ValueError, match="static structure"):
        eng.update_group(0, bad)
    # once refused, now run: the vmap layout (its params and state
    # exchanged in the JAX package's vmapped layout) and float configs
    # (tests/test_torch_float_grouped.py holds their numbers)
    vm = GroupedEngine(cfgs, streams_per_group=G, layout="vmap", pdm=False,
                       device="cpu")
    assert vm.layout == "vmap"
    params, state = vm.to_numpy()
    assert params.master_vol.shape == (K,) and state.lev_env.shape == (K, 2,
                                                                         G)
    x = _inputs(10, None, K * G, groups=K)[0]
    flat = GroupedEngine(cfgs, streams_per_group=G, pdm=False, device="cpu")
    a, b = vm.process(x), flat.process(x)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    floats = [_convert(c) for c in _cfgs(JPlatform.RP2350)]
    fg = GroupedEngine(floats, streams_per_group=G, pdm=False, device="cpu")
    assert fg.layout == "vmap" and fg.blocks.a[0].Tx.shape[0] == K
    assert fg.process(x)["out"].shape == (K, NPKT, 9, BLOCK, G)
    srv = HeteroServer(floats, IDS, pdm=False, device="cpu")
    assert srv.process(_inputs(11, None, len(IDS))[0])["out"].shape == (
        NPKT, 9, BLOCK, len(IDS))
    # float configs take the flat layout on the scan lowering only
    with pytest.raises(NotImplementedError, match="mxu=False"):
        GroupedEngine(floats, streams_per_group=G, layout="flat",
                      device="cpu")
    fscan = HeteroServer(floats, IDS, mxu=False, pdm=False, device="cpu")
    assert fscan.grouped.layout == "flat" and fscan.grouped.blocks is None
    assert fscan.process(_inputs(12, None, len(IDS))[0])["out"].shape == (
        NPKT, 9, BLOCK, len(IDS))
    with pytest.raises(ValueError, match="unknown layout"):
        GroupedEngine(cfgs, streams_per_group=G, layout="scan", device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        HeteroServer(cfgs, [0, 3], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GroupedEngine(cfgs, streams_per_group=G)
