"""A deployment's configuration file, turned into a device configuration.

The files under ``benchmark/configs/`` write a DSPi device configuration
out as data.  ``build`` turns one into a ``DeviceConfig`` of whichever
``types`` module it is given: the reference's own copy
(``benchmark.reference.types``) or the program's, so that both sides start
from the same file and neither takes anything the other made.  A tenant
(``tenant``) is a rule applied to the file's values: every EQ band's
frequency scaled, its gain offset, and the master volume set.
"""

from __future__ import annotations

import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def load(name: str) -> dict:
    """The configuration file ``configs/<name>.json``."""
    return json.loads((CONFIGS / f"{name}.json").read_text())


def build(spec: dict, types, tenant: dict | None = None):
    """A ``types.DeviceConfig`` from a configuration file's ``device``
    entry; ``tenant`` = {"freq_scale", "gain_offset_db",
    "master_volume_db"} applies a tenant's preset rule on top."""
    C = types
    dev = spec["device"]
    platform = {p.value: p for p in C.Platform}[dev["platform"]]
    cfg = C.DeviceConfig(platform=platform,
                         sample_rate=float(dev["sample_rate"]))
    cfg.preamp_db = [float(v) for v in dev["preamp_db"]]
    cfg.master_volume_db = float(dev["master_volume_db"])
    cfg.host_volume_index = int(dev["host_volume_index"])
    fscale = 1.0 if tenant is None else float(tenant["freq_scale"])
    goff = 0.0 if tenant is None else float(tenant["gain_offset_db"])
    for ch, bands in enumerate(dev["eq"]):
        for b, band in enumerate(bands):
            cfg.eq[ch][b] = C.EqBand(C.FilterType[band["type"]],
                                     float(band["freq"]) * fscale,
                                     float(band["q"]),
                                     float(band["gain_db"]) + goff)
    for o, out in enumerate(dev["outputs"]):
        cfg.outputs[o].enabled = bool(out["enabled"])
        cfg.outputs[o].gain_db = float(out["gain_db"])
        cfg.outputs[o].delay_ms = float(out["delay_ms"])
    for i, row in enumerate(dev["crosspoints"]):
        for o, xp in enumerate(row):
            cfg.crosspoints[i][o] = C.Crosspoint(bool(xp["enabled"]),
                                                 bool(xp["phase_invert"]),
                                                 float(xp["gain_db"]))
    cfg.sync_delays()
    cfg.loudness.enabled = bool(dev["loudness"]["enabled"])
    cfg.crossfeed.enabled = bool(dev["crossfeed"]["enabled"])
    cfg.leveller.enabled = bool(dev["leveller"]["enabled"])
    cfg.leveller.lookahead = bool(dev["leveller"]["lookahead"])
    if tenant is not None:
        cfg.master_volume_db = float(tenant["master_volume_db"])
    return cfg
