"""The port's Q28 engine against the firmware-Q28 oracle with the leveller
on: ``dspi_tpu_torch.native.FirmwareQ28`` computes the leveller's block
gain in float with libm and quantizes it to Q28 (leveller.c:305-335), the
engine with the deterministic ``fmath``, so a libm ulp can flip the
quantized gain's LSB and the recurrences carry it.  The engine stays
within tests/test_fw_oracle.py's LSB bounds for each case, on that file's
pinned inputs: q28 <= 512 and s24 <= 8 at 48 kHz, loud and quiet, q28 <=
1536 and s24 <= 24 at 96 kHz.  At 48 kHz the PDM words are held as there:
the modulator's input differs on under 2% of samples, and where it never
differs the words are equal.  The 96 kHz case runs the engine without its
PDM stage (the plain modulator's 2304 samples would take ~25 s on the
CPU); its sub output's samples are held with the others.  Skipped only
where ``g++`` is absent."""

import shutil

import numpy as np
import pytest

from dspi_tpu_torch import native
from dspi_tpu_torch.chain import Engine

from test_fw_oracle import q5_full
from test_torch_pack import _convert
from util import make_input

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")

NPKT = 24


@pytest.mark.parametrize("name,kwargs,scale,q28_bound,s24_bound", [
    ("q5_full_48k", {}, 0.5, 512, 8),
    ("q5_full_96k", {"rate": 96000.0}, 0.5, 1536, 24),
    # quiet input drives the upward compressor into its boost region every
    # block: libm log10f/powf run with non-unity results
    ("q5_full_48k_quiet", {}, 0.02, 512, 8),
])
def test_q28_engine_vs_firmware_oracle_leveller(name, kwargs, scale,
                                                q28_bound, s24_bound):
    cfg = _convert(q5_full(**kwargs))
    block = 96 if kwargs.get("rate") == 96000.0 else 48
    pdm = block == 48
    rng = np.random.default_rng(0xD5B10 + len(name) + int(scale * 100))
    x = make_input(rng, NPKT, block, 1, scale=scale)
    want, want_words = native.FirmwareQ28(cfg).process(x[..., 0])
    eng = Engine(cfg, n_streams=1, block_size=block, pdm=pdm, device="cpu")
    out = eng.process(x)
    got = out["out"].numpy()[..., 0]

    assert np.abs(want).max() > 0, "the signal never reached the outputs"
    s24_w = np.clip((want.astype(np.int64) + 32) >> 6, -0x800000, 0x7FFFFF)
    s24_g = np.clip((got.astype(np.int64) + 32) >> 6, -0x800000, 0x7FFFFF)
    m = {"q28_flip": float((got != want).mean()),
         "q28_max_lsb": int(np.abs(got.astype(np.int64) - want).max()),
         "s24_max_lsb": int(np.abs(s24_g - s24_w).max())}
    if pdm:
        words = out["pdm"].numpy().view(np.uint32)
        words = words.reshape(-1, 8, words.shape[-1])[..., 0]
        m["pdm_flip"] = float((words != want_words).mean())
        # the modulator's input, pcm = sub_q28 >> 14 (pdm_generator.c:357)
        sub = got.shape[1] - 1
        m["pdm_in_flip"] = float(
            ((got[:, sub].astype(np.int64) >> 14)
             != (want[:, sub].astype(np.int64) >> 14)).mean())
    print(f"\n{name}: {m}")
    assert m["q28_max_lsb"] <= q28_bound, m
    assert m["s24_max_lsb"] <= s24_bound, m
    if pdm:
        assert m["pdm_in_flip"] < 2e-2, m
        if m["pdm_in_flip"] == 0.0:
            assert m["pdm_flip"] == 0.0, m
    if scale < 0.1:
        # the bounds mean something only if the gain computer left unity
        assert float(eng.state.lev_gain_db[0]) > 0.3
