"""Device configurations the port is driven at.

``full_chain_config`` is the JAX package's benchmark headline (bench.py):
all 11 channels live at 48 kHz — 10-band PEQ on every channel, ISO 226
loudness, the volume leveller with 10 ms lookahead, BS2B crossfeed, the
2x9 matrix, per-output EQ + gains + time-alignment delays, s24 conversion
and the 256x-oversampled delta-sigma PDM sub.  ``hetero_variants`` is the
multi-tenant serving mix of the JAX package's stage benchmark
(bench_stages.py ``_hetero_variants``): K full-chain configs that share
their structure and differ in coefficients.  Kept here so that scripts
driving the port never import the JAX package.
"""

from __future__ import annotations

from .params.types import Crosspoint, DeviceConfig, EqBand, FilterType


def full_chain_config(platform, sample_rate=48000.0, pdm=True):
    """All 11 channels live: the headline configuration."""
    cfg = DeviceConfig(platform=platform, sample_rate=sample_rate)
    nout = cfg.num_outputs
    cfg.preamp_db = [1.0, 1.0]
    cfg.master_volume_db = -10.0
    cfg.host_volume_index = 57

    # 10 active bands on every channel, mixed types/regions
    types = [FilterType.HIGHPASS, FilterType.PEAKING, FilterType.PEAKING,
             FilterType.LOWSHELF, FilterType.PEAKING, FilterType.PEAKING,
             FilterType.PEAKING, FilterType.HIGHSHELF, FilterType.PEAKING,
             FilterType.PEAKING]
    freqs = [35, 80, 200, 350, 900, 2200, 4500, 8000, 11000, 15000]
    for ch in range(cfg.num_channels):
        for b in range(10):
            gain = 1.5 if (ch + b) % 2 else -2.0
            cfg.eq[ch][b] = EqBand(types[b], float(freqs[b]), 1.1, gain)

    for o in range(nout):
        cfg.outputs[o].enabled = True
        cfg.outputs[o].gain_db = -1.0
        cfg.outputs[o].delay_ms = 0.5 * o
        left = o % 2 == 0
        cfg.crosspoints[0][o] = Crosspoint(True, False, 0.0 if left else -6.0)
        cfg.crosspoints[1][o] = Crosspoint(True, o == 3, -6.0 if left else 0.0)
    if not pdm:
        cfg.outputs[nout - 1].enabled = False
    cfg.sync_delays()

    cfg.loudness.enabled = True
    cfg.crossfeed.enabled = True
    cfg.leveller.enabled = True
    cfg.leveller.lookahead = True
    return cfg


def hetero_variants(k, platform):
    """k full-chain configs sharing static structure (band kinds, enables,
    delays) with distinct coefficients: every channel's 10 EQ bands move
    in frequency (+2% a config) and gain (+-0.2 dB), and the master volume
    steps down 0.5 dB a config."""
    cfgs = []
    for i in range(k):
        cfg = full_chain_config(platform)
        for ch in range(cfg.num_channels):
            for b in range(10):
                e = cfg.eq[ch][b]
                e.freq = float(e.freq) * (1.0 + 0.02 * i)
                e.gain_db = float(e.gain_db) + (0.2 if i % 2 else -0.2)
        cfg.master_volume_db = -10.0 - 0.5 * i
        cfgs.append(cfg)
    return cfgs
