"""The Q28 slice: the port's RP2040 Engine against the JAX package's Engine
(on the CPU, where it takes the lax.scan path) run from the same params
and state, and against the firmware-semantics golden model.

Held to: bit-exact, every output word and every carried state word, on
16-bit and 24-bit input, through a preset-mute ramp and a coefficient-only
``update_config``.  One field is the exception against the JAX engine:
``lev_gain_db``, the leveller's float smoothed gain.  XLA:CPU contracts
the gain computer's ``(thresh + knee/2) - 10*log10(...)`` into a fused
multiply-add, so the JAX engine's smoothed gain sits a few float32 ulps
from the golden model's; the port rounds every operation on its own and
equals the golden model word for word (``test_leveller_gain_db_triangle``).
The Q28 gain it feeds is the same word on all three sides.
"""

import functools

import numpy as np
import pytest
import torch

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.core import constants as C

from test_torch_pack import _convert
from util import golden_run, make_input, rich_config

B, NPKT, BLOCK, NSEG = 3, 6, 48, 3
SEED = 0x4028
# a preset-load mute envelope over segment 1: down to silence and back
MUTE = np.array([1.0, 0.7, 0.3, 0.0, 0.25, 1.0], np.float32)
# |JAX - golden| of lev_gain_db in float32 ulps (measured: at most 3),
# allowed for the fused multiply-add of XLA:CPU (module docstring)
FMA_ULPS = 8


# port/JAX state field -> the golden model's attribute
_GOLDEN_FIELDS = dict(
    eq_a="eq_s1", eq_b="eq_s2", loud_a="loud_s1", loud_b="loud_s2",
    xf_lp="xf_lp", xf_ap="xf_ap", lev_env="lev_env",
    lev_gain_db="lev_gain_smooth_db", lev_gain="lev_gain_q28",
    lev_gain_prev="lev_gain_prev_q28", clip_flags="clip_flags")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def _update(cfg):
    """A coefficient-only change: master band 4 moves."""
    cfg.eq[0][4] = type(cfg.eq[0][4])(cfg.eq[0][4].type, 900.0, 1.1, 4.0)
    return cfg


@functools.lru_cache(maxsize=None)
def _run(bit_depth):
    """Both engines over NSEG segments of NPKT packets (the preset-mute
    ramp in segment 1, the update before the last segment), and the golden
    model on every stream over the segments before the update.  Returns
    the per-segment outputs, both final states, and the filter, leveller
    and clip state of all three sides at the golden model's last
    packet."""
    rng = np.random.default_rng(SEED + bit_depth)
    je = JEngine(bench.full_chain_config(JPlatform.RP2040), n_streams=B,
                 block_size=BLOCK, bit_depth=bit_depth, emit="full",
                 unroll=1)
    te = Engine(full_chain_config(Platform.RP2040), n_streams=B,
                block_size=BLOCK, bit_depth=bit_depth, emit="full",
                device="cpu")
    te.load_params_state(je.params, je.state)
    golds = [GoldenDevice(bench.full_chain_config(JPlatform.RP2040))
             for _ in range(B)]
    outs, at_gold = [], None
    for seg in range(NSEG):
        x = make_input(rng, NPKT, BLOCK, B, bit_depth=bit_depth)
        mute = MUTE if seg == 1 else np.ones(NPKT, np.float32)
        if seg == NSEG - 1:
            at_gold = {side: {f: _np(getattr(e.state, f)).copy()
                              for f in _GOLDEN_FIELDS}
                       for side, e in (("jax", je), ("port", te))}
            at_gold["golden"] = {
                f: np.stack([np.asarray(getattr(g, a)) for g in golds],
                            axis=-1).astype(at_gold["jax"][f].dtype)
                for f, a in _GOLDEN_FIELDS.items()}
            je.update_config(_update(bench.full_chain_config(
                JPlatform.RP2040)))
            te.update_config(_update(full_chain_config(Platform.RP2040)))
        else:
            for k in range(NPKT):
                for s, g in enumerate(golds):
                    frames = np.stack([x[k, 0, :, s], x[k, 1, :, s]], axis=1)
                    g.process_packet(frames, bit_depth=bit_depth,
                                     preset_mute_gain=float(mute[k]))
        jo = {k: _np(v) for k, v in je.process(x, mute).items()}
        to = {k: _np(v) for k, v in te.process(x, mute).items()}
        outs.append((jo, to))
    return outs, je.state, te.state, at_gold


@pytest.mark.parametrize("bit_depth", [16, 24])
@pytest.mark.parametrize("seg", range(NSEG))
def test_q28_engine_matches_jax_engine(bit_depth, seg):
    outs, _, _, _ = _run(bit_depth)
    jo, to = outs[seg]
    assert set(jo) == set(to) == {"out", "s24", "peaks", "pdm"}
    if seg > 0:                # the 480-sample lookahead fills in segment 0
        assert np.abs(to["out"]).max() > 1 << 20
    for k in jo:
        got = to[k].view(np.uint32) if k == "pdm" else to[k]
        assert got.dtype == jo[k].dtype, k
        np.testing.assert_array_equal(got, jo[k], err_msg=k)


@pytest.mark.parametrize("bit_depth", [16, 24])
def test_q28_carried_state_matches_jax_engine(bit_depth):
    _, js, ts, _ = _run(bit_depth)
    for f in ts._fields:
        t, j = getattr(ts, f), getattr(js, f)
        if t is None:
            assert j is None, f
            continue
        t, j = _np(t), np.asarray(j)
        if f == "pdm_rng":
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape, f
        if f == "lev_gain_db":
            assert _ulps(t, j).max() <= FMA_ULPS, (f, _ulps(t, j))
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.mark.parametrize("bit_depth", [16, 24])
def test_leveller_gain_db_triangle(bit_depth):
    """At the golden model's last packet (after the preset-mute ramp): the
    port equals the golden model word for word on every filter
    state, the whole leveller state and the clip flags; the JAX engine
    equals it on all but the float smoothed gain, which is within
    FMA_ULPS.  So the port is no farther from the golden model than the
    JAX engine is.  ``python tests/test_torch_q28.py`` prints the
    readings."""
    _, _, _, at = _run(bit_depth)
    for f, want in at["golden"].items():
        np.testing.assert_array_equal(at["port"][f], want, err_msg=f)
        if f != "lev_gain_db":
            np.testing.assert_array_equal(at["jax"][f], want, err_msg=f)
    assert _ulps(at["jax"]["lev_gain_db"],
                 at["golden"]["lev_gain_db"]).max() <= FMA_ULPS
    assert (at["golden"]["lev_gain"] != C.Q28_ONE).all()  # the leveller moved


def test_q28_matches_golden_rich_config():
    """tests/test_chain.py's test_q28_full_chain_bitexact, for the port:
    rich_config(RP2040), 2 streams, 16 packets, every output word and the
    leveller and clip state."""
    jcfg = rich_config(JPlatform.RP2040)
    te = Engine(_convert(jcfg), n_streams=2, block_size=BLOCK, emit="full",
                device="cpu")
    rng = np.random.default_rng(0xD5B1)
    x = make_input(rng, 16, BLOCK, 2)
    out = {k: _np(v) for k, v in te.process(x).items()}
    goldens = [GoldenDevice(jcfg.copy()) for _ in range(2)]
    gold = [golden_run(g, x[..., s:s + 1]) for s, g in enumerate(goldens)]

    def stack(key):                                    # -> [Npkt, ..., S]
        return np.stack([np.stack([np.asarray(p[key]) for p in gs])
                         for gs in gold], axis=-1)

    np.testing.assert_array_equal(out["out"], stack("buf_out"))
    want24 = stack("spdif")                        # [Npkt, npair, T, 2, S]
    np.testing.assert_array_equal(
        out["s24"], want24.transpose(0, 1, 3, 2, 4).reshape(out["s24"].shape))
    want_pdm = np.stack([np.array([w for p in gs for w in p["pdm_words"]],
                                  np.uint32).reshape(-1, 8) for gs in gold],
                        axis=-1)
    np.testing.assert_array_equal(out["pdm"].view(np.uint32), want_pdm)
    st = te.state
    np.testing.assert_array_equal(
        _np(st.lev_env), np.stack([g.lev_env for g in goldens], axis=-1))
    np.testing.assert_array_equal(
        _np(st.lev_gain_db),
        np.array([g.lev_gain_smooth_db for g in goldens], np.float32))
    assert _np(st.lev_gain).tolist() == [g.lev_gain_q28 for g in goldens]
    assert _np(st.clip_flags).tolist() == [g.clip_flags for g in goldens]


def test_update_config_leveller_reset_is_q28_unity():
    cfg = full_chain_config(Platform.RP2040)
    te = Engine(cfg, n_streams=2, block_size=BLOCK, pdm=False, device="cpu")
    te.process(make_input(np.random.default_rng(9), 2, BLOCK, 2))
    assert te.state.lev_env.abs().sum() > 0
    te.update_config(full_chain_config(Platform.RP2040), preset_load=True)
    for f in ("lev_gain", "lev_gain_prev"):
        v = getattr(te.state, f)
        assert v.dtype == torch.int32 and (v == C.Q28_ONE).all(), f
    assert (te.state.lev_env == 0).all() and (te.state.lev_gain_db == 0).all()


if __name__ == "__main__":
    for bd in (16, 24):
        _, js, ts, at = _run(bd)
        print(f"{bd}-bit lev_gain_db ulps: JAX vs golden "
              f"{_ulps(at['jax']['lev_gain_db'], at['golden']['lev_gain_db']).tolist()}"
              f", port vs golden "
              f"{_ulps(at['port']['lev_gain_db'], at['golden']['lev_gain_db']).tolist()}"
              f"; JAX vs port after {NSEG} segments "
              f"{_ulps(_np(ts.lev_gain_db), np.asarray(js.lev_gain_db)).tolist()}")
