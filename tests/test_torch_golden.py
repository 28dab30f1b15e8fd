"""The port's golden model against the JAX package's, bit for bit.

Both ``GoldenDevice``s run the same packets from the same config (the
port's a field-for-field twin): every packet's output buffers, master
buffers, S/PDIF words, PDM words, peaks and clip flags, and the leveller
state after each packet, are equal bit for bit; so is every state word at
the end.  The cases cover both platforms, the rich and headline configs,
16- and 24-bit input, loud and quiet input (the quiet one drives the
leveller's boost and its limiter's divisions) and the 44.1 kHz packet
cadence."""

import numpy as np
import pytest

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.golden.model import GoldenDevice as JGolden
from dspi_tpu_torch.golden.model import GoldenDevice

from test_torch_pack import _convert
from util import rich_config

NPKT = 6
LEVELLER = {True: ("lev_env", "lev_gain_smooth_db", "lev_gain_linear",
                   "lev_gain_prev_linear", "lev_la_idx"),
            False: ("lev_env", "lev_gain_smooth_db", "lev_gain_q28",
                    "lev_gain_prev_q28", "lev_la_idx")}
STATE = ("eq_s1", "eq_s2", "lev_la_buf", "delay_lines", "delay_write_idx",
         "xf_lp", "xf_ap", "pdm_err", "pdm_err2", "pdm_ns", "pdm_rng",
         "pdm_fade_pos", "peaks", "clip_flags")


def _bits(v):
    """A value as comparable exact bits: float32 arrays and scalars by
    their words, integer lists and dicts as they are."""
    if isinstance(v, dict):
        return {k: _bits(x) for k, x in v.items()}
    a = np.asarray(v)
    if a.dtype.kind == "f":
        return a.astype(np.float32).view(np.int32).tolist()
    return a.tolist()


def _config(name, platform, rate):
    if name == "rich":
        return rich_config(platform, sample_rate=rate)
    return bench.full_chain_config(platform, sample_rate=rate)


def _packets(rng, sizes, bits, scale):
    lim = int((2 ** (bits - 1) - 1) * scale)
    return [rng.integers(-lim, lim, size=(n, 2)).astype(np.int32)
            for n in sizes]


CASES = [(name, plat, bits, scale, 48000.0)
         for name in ("rich", "full") for plat in ("rp2350", "rp2040")
         for bits in (16, 24) for scale in (0.5, 0.02)] + [
    (name, plat, 16, 0.3, 44100.0)
    for name in ("rich", "full") for plat in ("rp2350", "rp2040")]


@pytest.mark.parametrize("name,plat,bits,scale,rate", CASES)
def test_golden_matches_jax(name, plat, bits, scale, rate):
    jplat = JPlatform(plat)
    jcfg = _config(name, jplat, rate)
    mine, theirs = GoldenDevice(_convert(jcfg)), JGolden(jcfg)
    is_float = jplat is JPlatform.RP2350
    assert mine.is_float == is_float
    sizes = ((44,) * 3 + (45,)) if rate == 44100.0 else (48,) * NPKT
    rng = np.random.default_rng(0x601D + len(name) + bits)
    for i, pcm in enumerate(_packets(rng, sizes, bits, scale)):
        got = mine.process_packet(pcm, bit_depth=bits)
        want = theirs.process_packet(pcm, bit_depth=bits)
        assert set(got) == set(want)
        for k in want:
            assert _bits(got[k]) == _bits(want[k]), (i, k)
        for f in LEVELLER[is_float]:
            assert _bits(getattr(mine, f)) == _bits(getattr(theirs, f)), \
                (i, f)
    assert len(got["pdm_words"]) == 8 * sizes[-1]
    for f in STATE:
        assert _bits(getattr(mine, f)) == _bits(getattr(theirs, f)), f


def test_golden_leveller_boosts_on_quiet_input():
    """The quiet cases are only worth their name if the leveller's gain
    left unity (its limiter then divides every sample)."""
    cfg = _convert(rich_config(JPlatform.RP2350))
    g = GoldenDevice(cfg)
    for pcm in _packets(np.random.default_rng(1), (48,) * 12, 16, 0.02):
        g.process_packet(pcm)
    assert float(g.lev_gain_smooth_db) > 0.3


@pytest.mark.parametrize("plat", ["rp2350", "rp2040"])
def test_golden_pdm_enable_transitions(plat):
    """The PDM enable machine (fade-out, mid-fade re-enable, restart)
    through the control-plane call, on both models."""
    jcfg = rich_config(JPlatform(plat))
    mine, theirs = GoldenDevice(_convert(jcfg)), JGolden(jcfg)
    rng = np.random.default_rng(7)
    # off at 2 (fade-out), on at 4 (mid-fade), off at 8 (the fade-out ends
    # at packet 30), on at 32 (restart)
    for i, pcm in enumerate(_packets(rng, (48,) * 36, 16, 0.5)):
        if i in (2, 4, 8, 32):
            for g in (mine, theirs):
                g.pdm_set_enabled(i in (4, 32))
        assert mine.process_packet(pcm)["pdm_words"] == \
            theirs.process_packet(pcm)["pdm_words"], i
    for f in ("pdm_ena", "pdm_run", "pdm_fout_pos", "pdm_base"):
        assert getattr(mine, f) == getattr(theirs, f), f
