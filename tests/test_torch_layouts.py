"""Cascade layouts that no other test reaches, on each of the chain's three
lowerings (chain/layout.py lays out the cascades of all three): the
port's Engine, from the JAX engine's params and state, against the JAX
engine over two segments.

Configs, both ``rich_config``'s (the engines' PDM stage off):
  * ``bypassed``: every band of master R flat (a bypassed master channel:
    the master call's right cascade is the loudness shelves, zero pairs
    and the envelope alone), every band of output 2 flat (enabled and in
    the mix, in no output cascade), output 1 muted, a third band on output
    0 (so the sub's cascade is padded); outputs 3-7 disabled, as
    ``rich_config`` has them;
  * ``master_eq_off``: ``bypass_master_eq`` (no master band; on RP2040 no
    output band either, usb_audio.c:1200).

Held as each lowering's own twin tests hold it.  Q28: every output word
and every state leaf equal (tests/test_torch_multi.py).  Float, block and
scan lowerings: ``out`` and every float state leaf within 1e-6 relative
RMS, the leveller's envelope and smoothed gain within 3e-6 (the
end-of-run guard of tests/test_torch_chain.py), and every channel of a
state leaf that the JAX engine leaves at zero zero here too; peaks within
1 LSB, clip flags equal (tests/test_torch_chain.py,
tests/test_torch_scan.py).
"""

import functools

import numpy as np
import pytest

from dspi_tpu import EqBand, FilterType
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu_torch.chain import Engine

from test_torch_chain import _rel_rms
from test_torch_multi import assert_state_matches_jax
from test_torch_pack import _convert
from test_torch_q28 import _np
from util import make_input, rich_config

B, NPKT, NSEG = 2, 8, 2
LOWERINGS = {"block": (JPlatform.RP2350, True),
             "scan": (JPlatform.RP2350, False),
             "q28": (JPlatform.RP2040, True)}


def _flat_channel(cfg, ch):
    cfg.eq[ch] = [type(b)() for b in cfg.eq[ch]]


def _bypassed(platform):
    cfg = rich_config(platform)
    _flat_channel(cfg, 1)
    _flat_channel(cfg, 2 + 2)
    cfg.outputs[1].mute = True
    cfg.eq[2][3] = EqBand(FilterType.PEAKING, 3000.0, 1.0, -3.0)
    return cfg


def _master_eq_off(platform):
    cfg = rich_config(platform)
    cfg.bypass_master_eq = True
    return cfg


CONFIGS = {"bypassed": _bypassed, "master_eq_off": _master_eq_off}


@functools.lru_cache(maxsize=None)
def _run(lowering, config):
    """Both engines over NSEG segments: ([(jax outputs, port outputs)],
    the JAX engine, the port's)."""
    platform, mxu = LOWERINGS[lowering]
    jcfg = CONFIGS[config](platform)
    kw = dict(n_streams=B, emit="full", pdm=False)
    if platform == JPlatform.RP2350:
        kw["mxu"] = mxu
    je = JEngine(jcfg, unroll=1, **kw)
    te = Engine(_convert(jcfg), device="cpu", **kw)
    te.load_params_state(je.params, je.state)
    rng = np.random.default_rng(0x1A7)
    runs = []
    for _ in range(NSEG):
        x = make_input(rng, NPKT, 48, B)
        jo = {k: np.asarray(v) for k, v in je.process(x).items()}
        to = {k: _np(v) for k, v in te.process(x).items()}
        runs.append((jo, to))
    return runs, je, te


def test_the_layouts_are_the_ones_named():
    """Each config reaches the layout its name says, on the port's own
    static chain."""
    from dspi_tpu_torch.chain.layout import _chain_structure
    from dspi_tpu_torch.core import constants as C

    for platform in (JPlatform.RP2350, JPlatform.RP2040):
        st = Engine(_convert(_bypassed(platform)), 1, pdm=False,
                    device="cpu").static
        master, out = _chain_structure(st)
        assert st.channel_bypassed[1] and not st.channel_bypassed[0]
        assert {t[0] for t in master} == {0}
        assert st.channel_bypassed[C.CH_OUT_1 + 2] and st.output_enabled[2]
        assert st.output_mute[1]
        per_o = [sum(t[0] - C.CH_OUT_1 == o for t in out)
                 for o in range(st.n_outputs)]
        assert [o for o in range(st.n_outputs) if per_o[o]] == [
            0, st.n_outputs - 1] and per_o[0] > per_o[-1]
        st = Engine(_convert(_master_eq_off(platform)), 1, pdm=False,
                    device="cpu").static
        master, out = _chain_structure(st)
        assert master == [] and (out == []) == (platform == JPlatform.RP2040)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("lowering", list(LOWERINGS))
def test_layout_matches_jax_engine(lowering, config):
    runs, je, te = _run(lowering, config)
    if lowering == "q28":
        for jo, to in runs:
            assert set(jo) == set(to)
            for k in jo:
                np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        assert_state_matches_jax(te.state, je.state)
        return
    for seg, (jo, to) in enumerate(runs):
        assert set(jo) == set(to), seg
        assert _rel_rms(to["out"], jo["out"]) < 1e-6, seg
        assert np.abs(to["peaks"].astype(np.int64) - jo["peaks"]).max() <= 1
    np.testing.assert_array_equal(_np(te.state.clip_flags),
                                  np.asarray(je.state.clip_flags))
    for f in te.state._fields:
        t, j = getattr(te.state, f), getattr(je.state, f)
        if t is None or np.asarray(j).dtype.kind != "f":
            continue
        t, j = _np(t), np.asarray(j)
        assert t.shape == j.shape, f
        bound = 3e-6 if f in ("lev_env", "lev_gain_db") else 1e-6
        assert _rel_rms(t, j) < bound, (f, _rel_rms(t, j))
        if t.ndim > 1:
            zero = ~j.reshape(len(j), -1).any(axis=1)
            np.testing.assert_array_equal(t[zero], j[zero], err_msg=f)
