"""The port's native binding: its oracles against the JAX package's, and
the port's engines against its firmware oracles.

* ``FirmwareFloat``/``FirmwareQ28`` and the scalar oracles of
  ``dspi_tpu_torch.native`` equal ``dspi_tpu.native``'s bit for bit on the
  same inputs (the port builds the same source with the same flags less
  the warnings, and loads the same coefficients through its own
  builders).
* The float ``Engine`` meets ``FirmwareFloat`` (``coeff_source="design"``)
  within 1e-6 relative RMS on the block-matmul lowering and 3e-6 on the
  scan lowering, on ``cfg5_full_96k`` with the JAX package's pinned input
  (tests/test_fw_oracle.py ``test_mxu_device_path_vs_firmware_oracle``).
* On the headline chain with quiet input, where the golden model itself
  sits ~3.5e-6 from ``FirmwareFloat``, the float ``Engine`` stays within
  1e-6 of the golden model and no farther from the oracle than it.
* The Q28 ``Engine`` equals ``FirmwareQ28`` word for word on the
  leveller-off configs; the leveller-on bounds are in
  ``test_torch_native_oracle_q28.py``.

The engines run without their PDM stage where only ``out`` is compared
(the sub output's samples are in ``out`` either way).  Skipped only where
``g++`` is absent."""

import shutil

import numpy as np
import pytest

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu import native as jnative
from dspi_tpu_torch import Platform, native
from dspi_tpu_torch.chain import Engine
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.golden.model import GoldenDevice

from test_fw_oracle import (cfg1_passthrough, cfg2_peq10, cfg3_matrix_delays,
                            cfg4_crossfeed_loudness, cfg5_full_96k,
                            q1_passthrough, q2_peq10, q3_matrix_delays,
                            q4_crossfeed_loudness, q5_full)
from test_torch_pack import _convert
from util import make_input, rich_config

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")

NPKT = 24
FLOAT_CFGS = {
    "cfg1_passthrough": cfg1_passthrough, "cfg2_peq10": cfg2_peq10,
    "cfg3_matrix_delays": cfg3_matrix_delays,
    "cfg4_crossfeed_loudness": cfg4_crossfeed_loudness,
    "cfg5_full_96k": cfg5_full_96k,
    "rich": lambda: rich_config(JPlatform.RP2350),
    "full": lambda: bench.full_chain_config(JPlatform.RP2350)}
Q28_CFGS = {
    "q1_passthrough": q1_passthrough, "q2_peq10": q2_peq10,
    "q3_matrix_delays": q3_matrix_delays,
    "q4_crossfeed_loudness": q4_crossfeed_loudness,
    "q5_full_48k": q5_full, "q5_full_96k": lambda: q5_full(rate=96000.0),
    "rich": lambda: rich_config(JPlatform.RP2040),
    "full": lambda: bench.full_chain_config(JPlatform.RP2040)}


def _block(cfg):
    return 96 if cfg.sample_rate == 96000.0 else 48


def _rel_rms(got, want):
    want = np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(want ** 2)) + 1e-30
    return np.sqrt(np.mean((np.asarray(got, np.float64) - want) ** 2)) / ref


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("source", ["design", "native"])
@pytest.mark.parametrize("name", sorted(FLOAT_CFGS))
def test_firmware_float_matches_jax(name, source, bits):
    jcfg = FLOAT_CFGS[name]()
    x = make_input(np.random.default_rng(len(name) + bits), 16,
                   _block(jcfg), 1, bit_depth=bits)[..., 0]
    fade = source == "design"
    want = jnative.FirmwareFloat(jcfg, coeff_source=source,
                                 pdm_fade=fade).process(x, bit_depth=bits)
    mine = native.FirmwareFloat(_convert(jcfg), coeff_source=source,
                                pdm_fade=fade)
    got = mine.process(x, bit_depth=bits)
    assert np.abs(want[0]).max() > 0
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # the oracle carries its state: a second call continues the stream
    again = jnative.FirmwareFloat(jcfg, coeff_source=source, pdm_fade=fade)
    again.process(x, bit_depth=bits)
    assert _same(mine.process(x, bit_depth=bits)[0],
                 again.process(x, bit_depth=bits)[0])


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("name", sorted(Q28_CFGS))
def test_firmware_q28_matches_jax(name, bits):
    jcfg = Q28_CFGS[name]()
    rng = np.random.default_rng(len(name) + bits)
    x = make_input(rng, 16, _block(jcfg), 1, bit_depth=bits)[..., 0]
    # a preset-mute staircase over the packets (the preset-save envelope)
    pm = (np.linspace(1.0, 0.0, 16).astype(np.float32) if bits == 24
          else None)
    want = jnative.FirmwareQ28(jcfg).process(x, bit_depth=bits,
                                             preset_mute=pm)
    got = native.FirmwareQ28(_convert(jcfg)).process(x, bit_depth=bits,
                                                     preset_mute=pm)
    assert np.abs(want[0]).max() > 0
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def _scalar_cases():
    rng = np.random.default_rng(0x5CA1)
    ints = rng.integers(-(1 << 31), 1 << 31, size=(64, 2), dtype=np.int64)
    coeffs = rng.integers(-(1 << 28), 1 << 28, size=(4, 5)).astype(np.int32)
    samples = rng.integers(-(1 << 27), 1 << 27, size=300).astype(np.int32)
    pdm_state = np.array([5, -9, 1, 2, 3, 4, 0, 123456789, 0], np.int32)
    return ints, coeffs, samples, pdm_state


@pytest.mark.parametrize("fn", ["q28_mul", "q15_mul", "q28_cascade_block",
                                "pdm_block", "fw_db_to_linear",
                                "fw_compute_alpha"])
def test_scalar_oracles_match_jax(fn):
    ints, coeffs, samples, pdm_state = _scalar_cases()
    if fn in ("q28_mul", "q15_mul"):
        for a, b in ints.astype(np.int32).tolist():
            assert getattr(native, fn)(a, b) == getattr(jnative, fn)(a, b)
    elif fn == "q28_cascade_block":
        runs = []
        for mod in (native, jnative):
            st = np.zeros((4, 2), np.int32)
            buf = samples.copy()
            mod.q28_cascade_block(coeffs, st, buf)
            mod.q28_cascade_block(coeffs, st, buf)     # state carried
            runs.append((st, buf))
        assert np.array_equal(runs[0][0], runs[1][0])
        assert np.array_equal(runs[0][1], runs[1][1])
        assert not np.array_equal(runs[0][1], samples)
    elif fn == "pdm_block":
        runs = []
        for mod in (native, jnative):
            st = pdm_state.copy()
            words = [mod.pdm_block(st, samples[:150]),
                     mod.pdm_block(st, samples[150:])]
            runs.append((st, np.concatenate(words)))
        assert np.array_equal(runs[0][0], runs[1][0])
        assert np.array_equal(runs[0][1], runs[1][1])
    elif fn == "fw_db_to_linear":
        for db in (-60.0, -6.0, 0.0, 2.5, 12.0):
            assert np.float32(native.fw_db_to_linear(db)) == \
                np.float32(jnative.fw_db_to_linear(db))
    else:
        for rate in (44100.0, 48000.0, 96000.0):
            for t in (0.02, 0.4, 2.0):
                assert np.float32(native.fw_compute_alpha(rate, t)) == \
                    np.float32(jnative.fw_compute_alpha(rate, t))


def test_oracles_refuse_the_other_platform():
    with pytest.raises(ValueError, match="oracle"):
        native.FirmwareQ28(_convert(cfg2_peq10()))
    with pytest.raises(ValueError, match="oracle"):
        native.FirmwareFloat(_convert(q2_peq10()))


@pytest.mark.parametrize("mxu,budget", [(True, 1e-6), (False, 3e-6)])
def test_float_engine_vs_firmware_oracle(mxu, budget):
    """The port's float chain on each lowering against the firmware-float
    oracle on the JAX package's pinned input (``default_rng(0xD5B1F)``,
    24 packets of 96 samples at 96 kHz)."""
    cfg = _convert(cfg5_full_96k())
    x = make_input(np.random.default_rng(0xD5B1F), NPKT, 96, 1, scale=0.5)
    want, _ = native.FirmwareFloat(cfg, coeff_source="design").process(
        x[..., 0], bit_depth=16)
    eng = Engine(cfg, n_streams=1, block_size=96, mxu=mxu, pdm=False,
                 device="cpu")
    got = eng.process(x)["out"].numpy()[..., 0]
    assert np.sqrt(np.mean(np.asarray(want, np.float64) ** 2)) > 1e-5
    rel = _rel_rms(got, want)
    print(f"\nport {'block-matmul' if mxu else 'scan'} vs firmware RMS = "
          f"{rel:.3e}")
    assert rel < budget, rel


@pytest.mark.parametrize("name", ["q1_passthrough", "q2_peq10",
                                  "q3_matrix_delays",
                                  "q4_crossfeed_loudness"])
def test_q28_engine_vs_firmware_oracle_exact(name):
    """Leveller off: the signal path is all integer (its one float op, the
    output gain x vol_mul, is one correctly rounded multiply on both
    sides), so the engine equals the libm firmware oracle word for word."""
    cfg = _convert(Q28_CFGS[name]())
    x = make_input(np.random.default_rng(0xD5B1 + len(name)), NPKT, 48, 1)
    want, _ = native.FirmwareQ28(cfg).process(x[..., 0])
    got = Engine(cfg, n_streams=1, pdm=False,
                 device="cpu").process(x)["out"].numpy()[..., 0]
    assert np.abs(want).max() > 0
    assert np.array_equal(got, want)


def test_float_engine_vs_firmware_quiet_headline():
    """The headline chain at 48 kHz on quiet input, where the leveller
    boosts every block: there the golden model itself sits ~3.5e-6 from
    the firmware oracle (the deterministic gain math against libm), so the
    engine is held within 1e-6 of the golden model and no more than 1e-6
    farther from the oracle than the golden model is."""
    cfg = full_chain_config(Platform.RP2350)
    x = make_input(np.random.default_rng(0xD5B1F), NPKT, 48, 1, scale=0.02)
    fw, _ = native.FirmwareFloat(cfg, coeff_source="design").process(
        x[..., 0])
    g = GoldenDevice(cfg)
    gold = np.stack([g.process_packet(np.ascontiguousarray(x[p, :, :, 0].T))
                     ["buf_out"] for p in range(NPKT)])
    got = Engine(cfg, n_streams=1, pdm=False,
                 device="cpu").process(x)["out"].numpy()[..., 0]
    assert float(g.lev_gain_smooth_db) > 0.3
    to_gold, to_fw, gold_fw = (_rel_rms(got, gold), _rel_rms(got, fw),
                               _rel_rms(gold, fw))
    print(f"\nquiet headline: engine vs golden {to_gold:.3e}, vs firmware "
          f"{to_fw:.3e}; golden vs firmware {gold_fw:.3e}")
    assert to_gold <= 1e-6, to_gold
    assert to_fw <= gold_fw + 1e-6, (to_fw, gold_fw)
