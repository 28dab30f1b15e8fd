"""The port's wire stage (kernels/encoders.py and the pipeline's
``_wire_stage``) against the JAX package.

  * the encoders word for word against ``dspi_tpu/kernels/encoders.py``
    on random int32 samples, and the closed BMC form against the
    firmware's literal table (``tests/test_encoders.py``); the copied
    constants against the originals;
  * the device-wire cases of ``tests/test_wire_out.py`` on the port's
    ``Engine(wire=True)``: the float chain's words equal to the JAX
    package's host encoder (``runtime/wire_out.WireEncoder``) applied to
    the port's own s24 (the float s24 itself is held only to 1e-6 against
    the JAX engine, ``tests/test_torch_chain.py``), the Z preamble every
    192 frames across segments, the block position reset by a slot type
    switch through ``update_config``, reduced folds equal to the full
    words' fold;
  * the Q28 chain's words equal to the JAX engine's, and a Q28
    ``GroupedEngine(wire=True, emit="reduced")``'s per-group ``wire_sum``
    (and every other output) equal to the JAX GroupedEngine's.

Held to: every word equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.chain import GroupedEngine as JGrouped
from dspi_tpu.core import constants as JC
from dspi_tpu.kernels import encoders as jenc
from dspi_tpu.runtime.wire_out import WireEncoder
from dspi_tpu_torch.chain import Engine, GroupedEngine
from dspi_tpu_torch.core import constants as C
from dspi_tpu_torch.kernels import encoders as enc

from test_torch_pack import _convert
from test_torch_q28 import _np
from util import make_input, rich_config

Z, X = 0b00111001, 0b11001001


def _u32(v):
    return _np(v).view(np.uint32)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_bmc_closed_form_matches_jax_and_table():
    got = _u32(enc.bmc_encode_byte(torch.arange(256, dtype=torch.int32)))
    np.testing.assert_array_equal(got, enc.build_spdif_lookup_reference())
    np.testing.assert_array_equal(got, jenc.build_spdif_lookup_reference())
    np.testing.assert_array_equal(
        got, jenc.bmc_encode_byte(np.arange(256, dtype=np.uint32)))


def test_copied_constants_match_jax():
    for name in ("SPDIF_BLOCK_FRAMES", "SPDIF_PREAMBLE_X", "SPDIF_PREAMBLE_Y",
                 "SPDIF_PREAMBLE_Z", "SPDIF_CHANNEL_STATUS"):
        assert getattr(C, name) == getattr(JC, name), name
    for rate in (44100, 48000, 96000, 32000):
        np.testing.assert_array_equal(enc.channel_status_bits(rate),
                                      jenc.channel_status_bits(rate))
    # the byte tables of the wire stage, from the closed form
    table = enc.build_spdif_lookup_reference()
    tb = enc._tables_np().view(np.uint32)
    np.testing.assert_array_equal(tb[0], (table & 0xFFFF) << 8)
    np.testing.assert_array_equal(tb[1], (table << 24) & 0xFFFFFFFF)


def test_subframe_matches_jax():
    rng = np.random.default_rng(1)
    n = 4000
    l0 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    h0 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    want = jenc.spdif_update_subframe(l0, h0, s)
    got = enc.spdif_update_subframe(_i32(l0), _i32(h0), _i32(s))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_u32(g), w)


@pytest.mark.parametrize("start", [0, 77, 190])
@pytest.mark.parametrize("rate", [44100, 48000, 96000])
def test_encode_block_matches_jax(start, rate):
    """encode_spdif_block (the wire stage's table form) and the frame
    headers against the JAX package's, in NumPy and on jax.numpy arrays;
    encode_i2s too.  Samples over the whole int32 range: only bits 23-0
    may reach the words."""
    rng = np.random.default_rng(start + rate)
    sl = rng.integers(-2**31, 2**31, (300, 3), dtype=np.int64).astype(
        np.int32)
    sr = rng.integers(-2**23, 2**23, (300, 3)).astype(np.int32)
    got = _u32(enc.encode_spdif_block(_i32(sl), _i32(sr), start, rate))
    np.testing.assert_array_equal(
        got, jenc.encode_spdif_block(sl, sr, start_frame=start,
                                     sample_rate=rate))
    np.testing.assert_array_equal(got, np.asarray(jenc.encode_spdif_block(
        jnp.asarray(sl), jnp.asarray(sr), start_frame=start,
        sample_rate=rate)))
    pos = np.arange(start, start + 400)
    for g, w in zip(enc.spdif_frame_headers(torch.from_numpy(pos), rate),
                    jenc.spdif_frame_headers(pos, rate)):
        np.testing.assert_array_equal(_u32(g), w)
    np.testing.assert_array_equal(_u32(enc.encode_i2s(_i32(sl))),
                                  jenc.encode_i2s(sl))


def _wire_cfg(platform=JPlatform.RP2350):
    """Without the leveller, whose 480-sample lookahead would hold the
    first segments' outputs at zero."""
    return rich_config(platform, leveller=False, pdm=False)


def test_device_wire_matches_host_encoder():
    """Engine(wire=True) words == the JAX package's host WireEncoder on the
    same engine's s24, segment after segment, S/PDIF and I2S slots mixed
    (tests/test_wire_out.py::test_device_wire_matches_host_encoder)."""
    jcfg = _wire_cfg()
    jcfg.hardware.output_types = [0, 1, 0, 0]
    eng = Engine(_convert(jcfg), n_streams=2, pdm=False, wire=True,
                 device="cpu")
    assert eng.static.wire == (0, 1, 0, 0)
    host = WireEncoder(jcfg, 48)
    rng = np.random.default_rng(2)
    for _ in range(3):
        out = eng.process(make_input(rng, 4, 48, 2))
        want = host.encode(_np(out["s24"]))
        for pair in range(4):
            np.testing.assert_array_equal(_u32(out[f"wire{pair}"]),
                                          want[f"pair{pair}"],
                                          err_msg=f"pair{pair}")
    assert int(eng.state.wire_pos) == host.frame_pos == 576 % 192


def test_device_wire_z_preamble_continuity():
    """The Z preamble lands every 192 frames across segment boundaries
    (audio_spdif.c:384-401); X everywhere else on the left subframe."""
    eng = Engine(_convert(_wire_cfg()), n_streams=1, pdm=False, wire=True,
                 device="cpu")
    rng = np.random.default_rng(3)
    pre = np.concatenate([
        _u32(eng.process(make_input(rng, 3, 48, 1))["wire0"])[:, 0, 0] & 0xFF
        for _ in range(5)])                       # 5 x 144 = 720 frames
    np.testing.assert_array_equal(np.where(pre == Z)[0],
                                  np.arange(0, 720, 192))
    assert set(np.unique(pre[pre != Z])) == {X}


def test_device_wire_type_switch_resets_block_pos():
    """A mid-stream S/PDIF <-> I2S switch through update_config restarts
    the instances and resets the block position (main.c:230-423); the
    engine keeps its wire stage."""
    jcfg = _wire_cfg()
    eng = Engine(_convert(jcfg), n_streams=1, pdm=False, wire=True,
                 device="cpu")
    rng = np.random.default_rng(4)
    eng.process(make_input(rng, 3, 48, 1))
    assert int(eng.state.wire_pos) == 144
    eng.update_config(_convert(jcfg))             # no switch: position kept
    assert eng.static.wire == (0, 0, 0, 0)
    assert int(eng.state.wire_pos) == 144
    cfg2 = jcfg.copy()
    cfg2.hardware.output_types = [0, 1, 0, 0]
    eng.update_config(_convert(cfg2))
    assert eng.static.wire == (0, 1, 0, 0)
    assert int(eng.state.wire_pos) == 0
    out = eng.process(make_input(rng, 3, 48, 1))
    np.testing.assert_array_equal(
        np.where((_u32(out["wire0"])[:, 0, 0] & 0xFF) == Z)[0], [0])
    assert out["wire1"].shape == (144, 2, 1)      # I2S words now


@pytest.mark.parametrize("platform", [JPlatform.RP2350, JPlatform.RP2040])
def test_device_wire_reduced_mode_folds(platform):
    """emit='reduced' folds each pair's words (uint32 sum mod 2^32) and
    still advances the block position; the folds equal the full emit's
    words folded."""
    jcfg = _wire_cfg(platform)
    jcfg.hardware.output_types = [1, 0, 0, 0]
    x = make_input(np.random.default_rng(5), 3, 48, 2)
    outs = {emit: Engine(_convert(jcfg), n_streams=2, pdm=False, wire=True,
                         emit=emit, device="cpu") for emit in ("full",
                                                               "reduced")}
    outs = {emit: e.process(x) for emit, e in outs.items()}
    red = outs["reduced"]["wire_sum"]
    npairs = 4 if platform is JPlatform.RP2350 else 2
    assert red.shape == (npairs,)
    want = [int(_u32(outs["full"][f"wire{p}"]).sum(dtype=np.uint32))
            for p in range(npairs)]
    assert red.tolist() == want
    assert len(set(want)) > 1


@functools.lru_cache(maxsize=None)
def _q28_pair():
    jcfg = _wire_cfg(JPlatform.RP2040)
    jcfg.hardware.output_types = [0, 1]
    je = JEngine(jcfg, n_streams=3, emit="full", unroll=1, wire=True)
    te = Engine(_convert(jcfg), n_streams=3, emit="full", wire=True,
                device="cpu")
    te.load_params_state(je.params, je.state)
    rng = np.random.default_rng(6)
    outs = []
    for _ in range(3):
        x = make_input(rng, 3, 48, 3)
        outs.append(({k: np.asarray(v) for k, v in je.process(x).items()},
                     {k: _np(v) for k, v in te.process(x).items()}))
    return outs, je, te


def test_q28_wire_words_match_jax_engine():
    """The Q28 chain's wire words (S/PDIF and I2S slots) and every other
    output word equal to the JAX engine's over 3 segments (432 frames:
    the block start crosses a segment), and its wire position."""
    outs, je, te = _q28_pair()
    for seg, (jo, to) in enumerate(outs):
        assert set(jo) == set(to) >= {"wire0", "wire1"}
        for k in jo:
            got = to[k].view(np.uint32) if k in ("pdm", "wire0",
                                                 "wire1") else to[k]
            np.testing.assert_array_equal(got, jo[k], err_msg=f"{seg} {k}")
    assert outs[0][1]["wire1"].shape == (144, 2, 3)
    assert np.abs(outs[0][1]["s24"]).max() > 1 << 16
    assert int(te.state.wire_pos) == int(je.state.wire_pos) == 432 % 192


def test_q28_device_wire_matches_host_encoder():
    """The Q28 words are the host encoder's on the engine's s24
    (tests/test_wire_out.py::test_device_wire_q28_path)."""
    outs, _, _ = _q28_pair()
    jcfg = _wire_cfg(JPlatform.RP2040)
    jcfg.hardware.output_types = [0, 1]
    host = WireEncoder(jcfg, 48)
    for _, to in outs:
        want = host.encode(to["s24"])
        for pair in range(2):
            np.testing.assert_array_equal(to[f"wire{pair}"].view(np.uint32),
                                          want[f"pair{pair}"])


def test_q28_grouped_wire_sum_matches_jax():
    """A Q28 GroupedEngine with wire=True, emit='reduced': the port stays
    flat and folds each group's lane block; its per-group wire_sum [K,
    npairs] and every other output equal to the JAX GroupedEngine's (whose
    ``layout="auto"`` takes the vmapped layout for this), over 2 segments
    with an update_group between; the state carries out in the JAX
    layout."""
    K, G = 3, 2
    jcfgs = []
    for k in range(K):
        c = _wire_cfg(JPlatform.RP2040)
        c.master_volume_db = -6.0 - 4 * k
        jcfgs.append(c)
    je = JGrouped(jcfgs, streams_per_group=G, emit="reduced", wire=True,
                  unroll=1, mxu=False)
    te = GroupedEngine([_convert(c) for c in jcfgs], streams_per_group=G,
                       emit="reduced", wire=True, layout="vmap",
                       device="cpu")
    assert je.layout == te.layout == "vmap"
    rng = np.random.default_rng(7)
    for seg in range(2):
        if seg:
            quiet = jcfgs[1].copy()
            quiet.master_volume_db = -30.0
            je.update_group(1, quiet)
            te.update_group(1, _convert(quiet))
        x = np.moveaxis(make_input(rng, 3, 48, K * G).reshape(3, 2, 48, K, G),
                        -2, 0)
        jo = {k: np.asarray(v) for k, v in je.process(x).items()}
        to = {k: _np(v) for k, v in te.process(x).items()}
        assert set(jo) == set(to) == {"peaks", "s24_sum", "wire_sum"}
        assert to["wire_sum"].shape == (K, 2)
        for k in jo:
            np.testing.assert_array_equal(to[k], jo[k], err_msg=f"{seg} {k}")
        assert len(set(to["wire_sum"][:, 0].tolist())) == K
    params, state = te.to_numpy()
    for f in state._fields:
        t, j = getattr(state, f), getattr(je.state, f)
        if t is None:
            assert j is None, f
            continue
        j = np.asarray(j)
        assert t.shape == j.shape, f
        if f != "lev_gain_db":       # an XLA:CPU FMA (test_torch_multi.py)
            np.testing.assert_array_equal(t, j, err_msg=f)
    np.testing.assert_array_equal(params.master_vol,
                                  np.asarray(je.params.master_vol))
