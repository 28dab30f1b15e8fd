"""The port's block-matmul passes (dspi_tpu_torch.chain.mxu) against the
JAX package's (dspi_tpu.chain.mxu) on the same inputs, params and carried
state: <= 1e-6 relative RMS on outputs and on every carried state array.

Both sides re-round the firmware's sequential math in their own order
(float32 matrix products, XLA's FMA contraction on one side), so the
budget is the chain's firmware-fidelity budget, not bit equality."""

import functools

import jax
import numpy as np
import pytest
import torch

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import mxu as jmxu
from dspi_tpu.chain import pack as jpack
from dspi_tpu.chain.pipeline import _chain_structure as j_structure
from dspi_tpu.params.design import derive as jderive
from dspi_tpu_torch.chain import mxu, pack
from dspi_tpu_torch.chain.layout import _chain_structure

from util import rich_config

B, NPKT = 4, 8
CONFIGS = {
    "full48": lambda: (bench.full_chain_config(JPlatform.RP2350), 48),
    "rich": lambda: (rich_config(JPlatform.RP2350), 48),
}


def _rel_rms(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (np.sqrt(np.mean((got - want) ** 2))
            / (np.sqrt(np.mean(want ** 2)) + 1e-30))


@functools.lru_cache(maxsize=None)
def _setup(name):
    cfg, block = CONFIGS[name]()
    jd = jderive(cfg)
    jst = jpack.build_static(jd, block_size=block, mxu=True)
    jp = jpack.build_params(jd, jst)
    rng = np.random.default_rng(17)
    js = jpack.init_state(jst, B)
    small = {f: (rng.standard_normal(np.shape(getattr(js, f))) * 0.01)
             .astype(np.float32)
             for f in ("loud_a", "loud_b", "eq_a", "eq_b", "eq_c", "eq_d",
                       "xf_lp", "xf_ap")}
    js = js._replace(lev_env=np.abs(rng.standard_normal((2, B)) * 0.01)
                     .astype(np.float32), **small)
    # the port's static: same structure (see test_torch_pack)
    st = _port_static(jst)
    p, s = pack.from_numpy(jp, js, "cpu")
    blocks = mxu.build_blocks(st, p, "cpu")
    ttot = NPKT * block
    bl = (rng.standard_normal((ttot, B)) * 0.3).astype(np.float32)
    br = (rng.standard_normal((ttot, B)) * 0.3).astype(np.float32)
    return jst, jp, js, st, p, s, blocks, bl, br


def _port_static(jst):
    import dataclasses
    kw = dataclasses.asdict(jst)
    kw.pop("unroll")
    kw.pop("outer_unroll")
    return pack.StaticChain(**kw)


def _clone(s):
    return type(s)(*[None if v is None else v.clone() for v in s])


def _check_state(ts, js, fields):
    for f in fields:
        got = getattr(ts, f).numpy()
        want = np.asarray(getattr(js, f))
        assert _rel_rms(got, want) < 1e-6, (f, _rel_rms(got, want))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_a(name):
    jst, jp, js, st, p, s, blocks, bl, br = _setup(name)
    mb = _chain_structure(st)[0]
    assert mb == j_structure(jst)[0]
    js2, jl, jr = jax.jit(functools.partial(
        jmxu.chain_a, jst, master_bands=mb, Npkt=NPKT))(jp, js, bl, br)
    ts2, tl, tr = mxu.chain_a(st, p, blocks, _clone(s), torch.from_numpy(bl),
                              torch.from_numpy(br), mb, NPKT)
    assert _rel_rms(tl, jl) < 1e-6 and _rel_rms(tr, jr) < 1e-6
    _check_state(ts2, js2, ("loud_a", "loud_b", "eq_a", "eq_b", "eq_c",
                            "eq_d"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_env_packet_ends(name):
    jst, jp, js, st, p, s, blocks, bl, br = _setup(name)
    jl, jr = jax.jit(functools.partial(jmxu.env_packet_ends, jst,
                                       Npkt=NPKT))(jp, js, bl, br)
    tl, tr = mxu.env_packet_ends(st, p, s, torch.from_numpy(bl),
                                 torch.from_numpy(br), NPKT)
    assert tl.shape == (NPKT, B)
    assert _rel_rms(tl, jl) < 1e-6 and _rel_rms(tr, jr) < 1e-6


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_b(name):
    jst, jp, js, st, p, s, blocks, bl, br = _setup(name)
    ob = _chain_structure(st)[1]
    assert ob == j_structure(jst)[1]
    js2, jbufs = jax.jit(functools.partial(
        jmxu.chain_b, jst, out_bands=ob, Npkt=NPKT))(jp, js, bl, br)
    ts2, tbufs = mxu.chain_b(st, p, blocks, _clone(s), torch.from_numpy(bl),
                             torch.from_numpy(br), ob, NPKT)
    assert len(tbufs) == len(jbufs)
    for o, (t, j) in enumerate(zip(tbufs, jbufs)):
        j = np.asarray(j)
        if not j.any():
            assert not t.numpy().any(), o
            continue
        assert _rel_rms(t, j) < 1e-6, (o, _rel_rms(t, j))
    _check_state(ts2, js2, ("xf_lp", "xf_ap", "eq_a", "eq_b", "eq_c",
                            "eq_d"))


def test_products_refuse_tf32():
    jst, jp, js, st, p, s, blocks, bl, br = _setup("rich")
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="float32"):
            mxu.env_packet_ends(st, p, s, torch.from_numpy(bl),
                                torch.from_numpy(br), NPKT)
    finally:
        mxu.require_fp32()
