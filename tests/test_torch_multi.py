"""Per-stream parameters on the port's Q28 chain against the JAX package.

  * ``pack.build_params_multi`` equals the JAX package's array for array,
    with and without stream ids, config-uniform leaves collapsed alike;
  * ``process_q28`` (through ``Engine.load_params_state``) on per-stream
    params equals the JAX package's ``_process_q28`` on the CPU (its
    ``lax.scan`` path) on every output and state field over two segments,
    for three families of configs that share their structure:
      - "eq": EQ, preamp, master volume, output gain, matrix and crossfeed
        differ, so the EQ rows and the crossfeed run per lane;
      - "loud_lev": the EQ is shared and only the host volume (loudness row
        and its bypass flags) and the leveller's speed (its RMS time) differ,
        so the master cascade must still run per lane although ``eq_q28``
        is config-uniform;
      - "delays": an output's delay differs, so the delay ring is read
        through the per-lane gather.

Held to: bit-exact, except ``lev_gain_db``, the JAX engine's float smoothed
gain, which XLA:CPU computes with a fused multiply-add
(``tests/test_torch_q28.py`` explains it).  There the port equals the
golden model (one ``GoldenDevice`` per stream, built from its own config)
word for word, and the JAX engine is held to 1e-5 relative: its readings
here are up to 24 float32 ulps off at values near 1e-4 dB, where an ulp is
small.
"""

import functools

import numpy as np
import pytest
import torch

from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.chain import pack as jpack
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu.params.design import derive as jderive
from dspi_tpu_torch.chain import Engine, pack
from dspi_tpu_torch.chain.pipeline import _master_lane
from dspi_tpu_torch.params.design import derive

from test_torch_pack import _convert, _eq_tree
from test_torch_q28 import _GOLDEN_FIELDS, _np
from util import make_input, rich_config

def assert_state_matches_jax(state, jstate):
    """Every field of the port's state equal to the JAX engine's, word for
    word; ``lev_gain_db`` to 1e-5 relative (the module docstring says
    why)."""
    for f, t in zip(state._fields, state):
        j = getattr(jstate, f)
        if t is None:
            assert j is None, f
            continue
        t, j = _np(t), np.asarray(j)
        if f == "pdm_rng":
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape, f
        if f == "lev_gain_db":
            np.testing.assert_allclose(t, j, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)


IDS = np.array([2, 0, 1, 1, 0, 2])
NPKT, BLOCK, NSEG = 8, 48, 2


def _family(name):
    """Three rich_config(RP2040) variants of one structure."""
    cfgs = []
    for k in range(3):
        c = rich_config(JPlatform.RP2040)
        if name == "eq":
            c.eq[0][0].freq = 100.0 + 40.0 * k
            c.eq[0][0].gain_db = 3.0 - k
            c.eq[2][1].q = 1.0 + 0.5 * k
            c.preamp_db = [1.5 - 0.5 * k, -2.0 + 0.5 * k]
            c.master_volume_db = -6.0 - 2.0 * k
            c.outputs[2].gain_db = -1.5 - k
            c.crosspoints[1][2].gain_db = -3.0 - k
            c.crossfeed.preset = k
        elif name == "loud_lev":
            c.host_volume_index = (50, 55, 60)[k]     # 60: loudness bypassed
            c.leveller.speed = k
        else:
            c.outputs[0].delay_ms = 1.0 + 0.5 * k
            c.sync_delays()
        cfgs.append(c)
    return cfgs


@pytest.mark.parametrize("ids", [None, IDS], ids=["one_per_config", "ids"])
@pytest.mark.parametrize("name", ["eq", "loud_lev", "delays"])
def test_build_params_multi_matches_jax(name, ids):
    jcfgs = _family(name)
    jd = [jderive(c) for c in jcfgs]
    d = [derive(_convert(c)) for c in jcfgs]
    jst = jpack.build_static(jd[0], block_size=BLOCK, mxu=False)
    st = pack.build_static(d[0], block_size=BLOCK)
    _eq_tree(pack.build_params_multi(d, st, ids),
             jpack.build_params_multi(jd, jst, ids))


def test_build_params_multi_refusals():
    jcfgs = _family("eq")
    d = [derive(_convert(c)) for c in jcfgs]
    st = pack.build_static(d[0], block_size=BLOCK)
    bad = _convert(jcfgs[1])
    bad.crossfeed.enabled = False                   # another structure
    with pytest.raises(ValueError, match="share static structure"):
        pack.build_params_multi([d[0], derive(bad)], st)
    fd = derive(_convert(rich_config(JPlatform.RP2350)))
    with pytest.raises(ValueError, match="scan path"):
        pack.build_params_multi([fd], pack.build_static(fd, block_size=BLOCK))


@functools.lru_cache(maxsize=None)
def _run(name):
    """The JAX engine and the port's, both on the JAX package's per-stream
    params and state, over NSEG segments (a preset-mute ramp in the
    second)."""
    jcfgs = _family(name)
    je = JEngine(jcfgs[0], n_streams=len(IDS), block_size=BLOCK, emit="full",
                 unroll=1)
    je.params = jpack.build_params_multi([jderive(c) for c in jcfgs],
                                         je.static, IDS)
    te = Engine(_convert(jcfgs[0]), n_streams=len(IDS), block_size=BLOCK,
                emit="full", device="cpu")
    te.load_params_state(je.params, je.state)
    golds = [GoldenDevice(jcfgs[k].copy()) for k in IDS]
    rng = np.random.default_rng(0x3117)
    outs = []
    for seg in range(NSEG):
        x = make_input(rng, NPKT, BLOCK, len(IDS))
        mute = (np.array([1, .7, .3, 0, 0, .25, 1, 1], np.float32) if seg
                else np.ones(NPKT, np.float32))
        outs.append(({k: _np(v) for k, v in je.process(x, mute).items()},
                     {k: _np(v) for k, v in te.process(x, mute).items()}))
        for k in range(NPKT):
            for s, g in enumerate(golds):
                g.process_packet(np.stack([x[k, 0, :, s], x[k, 1, :, s]], 1),
                                 bit_depth=16,
                                 preset_mute_gain=float(mute[k]))
    gold = {f: np.stack([np.asarray(getattr(g, a)) for g in golds], axis=-1)
            for f, a in _GOLDEN_FIELDS.items()}
    return outs, je.state, te, gold


@pytest.mark.parametrize("name", ["eq", "loud_lev", "delays"])
def test_per_stream_q28_matches_jax(name):
    outs, js, te, _ = _run(name)
    p = te.params
    per_lane = {"eq": p.eq_q28.dim() == 4 and p.xf.dim() == 2,
                "loud_lev": (p.eq_q28.dim() == 3 and p.loud_qbq.dim() == 3
                             and p.lev.dim() == 2),
                "delays": p.delay_samples.dim() == 2}
    assert per_lane[name]
    assert _master_lane(te.static, p) == (name != "delays")
    for seg, (jo, to) in enumerate(outs):
        assert set(jo) == set(to) == {"out", "s24", "peaks", "pdm"}
        for k in jo:
            got = to[k].view(np.uint32) if k == "pdm" else to[k]
            np.testing.assert_array_equal(got, jo[k], err_msg=f"{seg} {k}")
    assert np.abs(outs[-1][1]["out"]).max() > 1 << 20
    assert_state_matches_jax(te.state, js)


@pytest.mark.parametrize("name", ["eq", "loud_lev", "delays"])
def test_per_stream_q28_matches_golden(name):
    """Every stream against a golden device of its own config: filter,
    leveller (the float smoothed gain included) and clip state, word for
    word, after both segments."""
    _, _, te, gold = _run(name)
    for f, want in gold.items():
        np.testing.assert_array_equal(
            _np(getattr(te.state, f)), want.astype(
                _np(getattr(te.state, f)).dtype), err_msg=f)


def test_per_stream_streams_differ_as_their_configs():
    """Streams of one config, fed the same input, give the same words;
    streams of different configs do not."""
    jcfgs = _family("loud_lev")
    eng = Engine(_convert(jcfgs[0]), n_streams=len(IDS), block_size=BLOCK,
                 emit="full", pdm=False, device="cpu")
    eng.params = pack.to_device(pack.build_params_multi(
        [derive(_convert(c)) for c in jcfgs], eng.static, IDS), "cpu")
    x = make_input(np.random.default_rng(4), 12, BLOCK, 1)
    out = eng.process(np.repeat(x, len(IDS), axis=-1))["out"]
    for k in range(3):
        lanes = np.where(IDS == k)[0]
        assert torch.equal(out[..., lanes[0]], out[..., lanes[1]])
    assert out.abs().max() > 1 << 20
    assert not torch.equal(out[..., 1], out[..., 2])
