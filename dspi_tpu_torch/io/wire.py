"""Binary wire codecs: preset slots, preset directory, bulk parameters.

A copy of the JAX package's ``io/wire.py`` for the PyTorch port.

Byte-compatible with the firmware's on-flash and USB wire formats so real
DSPi flash dumps and Console exports load unchanged:

  * PresetSlot v1-12 + PresetDirectory v1-2 ... flash_storage.c:76-190
  * LegacyFlashStorage ("DSP1") ............... flash_storage.c:192-219
  * WireBulkParams v6 (2896 bytes) ............ bulk_params.h:42-210
  * CRC32 poly 0xEDB88320 init 0xFFFFFFFF ..... flash_storage.c:282-291
    (identical to zlib's crc32)

All structures are packed little-endian.  Slot geometry depends on the
platform (NUM_CHANNELS etc.), exactly as the firmware's structs do.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..core import constants as C
from ..core.constants import FilterType, Platform
from ..params.types import (Crosspoint, DeviceConfig, EqBand, OutputChannel,
                            default_channel_names, default_output_pins)

F = np.float32

SECTOR_SIZE = 4096
PAGE_SIZE = 256
NUM_SECTORS = 12                      # dir + 10 slots + legacy


def crc32(data: bytes) -> int:
    """flash_storage.c:282-291 — identical to zlib crc32."""
    return zlib.crc32(data) & 0xFFFFFFFF


def db_to_linear_flash(db: float) -> float:
    """flash_storage.c:296-306: powf with hard clamps (preset apply path)."""
    db = float(F(db))
    if db <= -120.0:
        return 0.0
    if db >= 80.0:
        db = 80.0
    return float(np.power(F(10.0), F(db) / F(20.0)))


def db_to_linear_taylor(db: float) -> float:
    """bulk_params.c:49-56: the 4-term Taylor series retained by the bulk
    SET path — wrong beyond ~+/-10 dB, reproduced as a live quirk."""
    db = float(F(db))
    if db == 0.0:
        return 1.0
    db = min(max(db, -60.0), 20.0)
    x = F(db) * F(0.1151292546)
    lin = (F(1.0) + x + x * x * F(0.5) + x * x * x * F(0.1666667)
           + x * x * x * x * F(0.0416667))
    return float(max(lin, F(0.0)))


def _geom(platform: Platform):
    nch = C.NUM_CHANNELS[platform]
    nout = C.NUM_OUTPUT_CHANNELS[platform]
    npin = {Platform.RP2350: 5, Platform.RP2040: 3}[platform]
    nspdif = C.NUM_SPDIF_INSTANCES[platform]
    return nch, nout, npin, nspdif


# ----------------------------------------------------------------------------
# Preset slot codec
# ----------------------------------------------------------------------------

_EQ_FMT = "<BBBBfff"                  # EqParamPacket (config.h:445-453)
_XP_FMT = "<BBBBf"                    # FlashMatrixCrosspoint
_OUT_FMT = "<BBBBff"                  # FlashOutputChannel


def slot_data_size(platform: Platform) -> int:
    """sizeof(PresetSlot) - 12-byte header, current (v12) struct."""
    nch, nout, npin, _ = _geom(platform)
    return (nch * C.MAX_BANDS * 16            # filter_recipes
            + 4 + 1 + 3                       # preamp_db, bypass, padding
            + nch * 4                         # delays_ms
            + 12 + 3 + 1                      # channel_gain_db, mute, pad
            + 1 + 3 + 4 + 4                   # loudness
            + 4 + 4 + 4                       # crossfeed flags + fc + feed
            + 2 * nout * 8                    # crosspoints
            + nout * 12                       # outputs
            + npin + (8 - npin)               # pins + padding
            + nch * C.PRESET_NAME_LEN         # channel names
            + 4 + 4                           # output_types + i2s cfg bytes
            + 4 + 4 + 4 + 4                   # leveller
            + 2 * 4 + 4)                      # preamp per ch + master volume


def encode_slot(cfg: DeviceConfig, slot_index: int) -> bytes:
    """collect_live_state (flash_storage.c:464-562) -> v12 slot bytes."""
    p = cfg.platform
    nch, nout, npin, nspdif = _geom(p)
    buf = bytearray()

    for ch in range(nch):
        for b in range(C.MAX_BANDS):
            e = cfg.eq[ch][b]
            buf += struct.pack(_EQ_FMT, ch, b, int(e.type), 0,
                               float(F(e.freq)), float(F(e.q)),
                               float(F(e.gain_db)))
    buf += struct.pack("<fB3x", float(F(cfg.preamp_db[0])),
                       1 if cfg.bypass_master_eq else 0)
    delays = list(cfg.channel_delays_ms[:nch]) + [0.0] * max(0, nch - len(cfg.channel_delays_ms))
    # channel delay table mirrors outputs (apply_slot_to_live:660)
    for o in range(nout):
        delays[C.CH_OUT_1 + o] = cfg.outputs[o].delay_ms
    buf += struct.pack(f"<{nch}f", *[float(F(d)) for d in delays])
    buf += struct.pack("<3f3Bx", *[float(F(g)) for g in cfg.channel_gain_db],
                       *[1 if m else 0 for m in cfg.channel_mute])
    buf += struct.pack("<B3xff", 1 if cfg.loudness.enabled else 0,
                       float(F(cfg.loudness.ref_spl)),
                       float(F(cfg.loudness.intensity_pct)))
    xf = cfg.crossfeed
    buf += struct.pack("<BBBBff", 1 if xf.enabled else 0, xf.preset,
                       1 if xf.itd_enabled else 0, 0,
                       float(F(xf.custom_fc)), float(F(xf.custom_feed_db)))
    for i in range(2):
        for o in range(nout):
            x = cfg.crosspoints[i][o]
            buf += struct.pack(_XP_FMT, 1 if x.enabled else 0,
                               1 if x.phase_invert else 0, 0, 0,
                               float(F(x.gain_db)))
    for o in range(nout):
        oc = cfg.outputs[o]
        buf += struct.pack(_OUT_FMT, 1 if oc.enabled else 0,
                           1 if oc.mute else 0, 0, 0,
                           float(F(oc.gain_db)), float(F(oc.delay_ms)))
    pins = list(cfg.hardware.output_pins[:npin])
    buf += struct.pack(f"<{npin}B{8 - npin}x", *pins)
    for ch in range(nch):
        name = cfg.channel_names[ch].encode()[:C.PRESET_NAME_LEN - 1]
        buf += name + b"\x00" * (C.PRESET_NAME_LEN - len(name))
    types = list(cfg.hardware.output_types[:nspdif]) + [0] * (4 - nspdif)
    buf += struct.pack("<4B", *types)
    buf += struct.pack("<BBBB", cfg.hardware.i2s_bck_pin,
                       cfg.hardware.i2s_mck_pin,
                       1 if cfg.hardware.i2s_mck_enabled else 0,
                       1 if cfg.hardware.i2s_mck_multiplier == 256 else 0)
    lv = cfg.leveller
    buf += struct.pack("<BBBBfff", 1 if lv.enabled else 0, lv.speed,
                       1 if lv.lookahead else 0, 0, float(F(lv.amount)),
                       float(F(lv.max_gain_db)),
                       float(F(lv.gate_threshold_db)))
    buf += struct.pack("<2f", *[float(F(v)) for v in cfg.preamp_db[:2]])
    buf += struct.pack("<f", float(F(cfg.master_volume_db)))

    data = bytes(buf)
    assert len(data) == slot_data_size(p), (len(data), slot_data_size(p))
    header = struct.pack("<IHHI", C.PRESET_MAGIC_SLOT, C.PRESET_SLOT_VERSION,
                         slot_index, crc32(data))
    return header + data


@dataclass
class SlotFields:
    """Raw decoded slot contents (pre-application)."""

    version: int = 0
    slot_index: int = 0
    eq: list = None
    preamp_db_legacy: float = 0.0
    bypass: bool = False
    delays_ms: list = None
    channel_gain_db: list = None
    channel_mute: list = None
    loudness_enabled: bool = False
    loudness_ref_spl: float = 83.0
    loudness_intensity_pct: float = 100.0
    crossfeed_enabled: bool = False
    crossfeed_preset: int = 0
    crossfeed_itd: bool = True
    crossfeed_fc: float = 700.0
    crossfeed_feed: float = 4.5
    crosspoints: list = None
    outputs: list = None
    output_pins: list = None
    channel_names: list = None
    output_types: list = None
    i2s_bck_pin: int = 14
    i2s_mck_pin: int = 13
    i2s_mck_enabled: bool = False
    i2s_mck_multiplier_raw: int = 0
    leveller: dict = None
    preamp_db: list = None
    master_volume_db: float = None


def decode_slot(raw: bytes, platform: Platform, slot_index: int | None = None,
                check_crc: bool = True) -> SlotFields | None:
    """validate_slot + field extraction (flash_storage.c:750-759)."""
    p = platform
    nch, nout, npin, nspdif = _geom(p)
    size = 12 + slot_data_size(p)
    if len(raw) < size:
        return None
    magic, version, sidx, crc = struct.unpack_from("<IHHI", raw, 0)
    if magic != C.PRESET_MAGIC_SLOT:
        return None
    if slot_index is not None and sidx != slot_index:
        return None
    data = raw[12:size]
    if check_crc and crc32(data) != crc:
        return None

    s = SlotFields(version=version, slot_index=sidx)
    off = 0
    s.eq = []
    for ch in range(nch):
        row = []
        for b in range(C.MAX_BANDS):
            _, _, typ, _, freq, q, gdb = struct.unpack_from(_EQ_FMT, data, off)
            off += 16
            row.append(EqBand(FilterType(typ if typ <= 5 else 0), freq, q, gdb))
        s.eq.append(row)
    s.preamp_db_legacy, byp = struct.unpack_from("<fB3x", data, off)
    s.bypass = byp != 0
    off += 8
    s.delays_ms = list(struct.unpack_from(f"<{nch}f", data, off))
    off += nch * 4
    vals = struct.unpack_from("<3f3Bx", data, off)
    s.channel_gain_db = list(vals[:3])
    s.channel_mute = [v != 0 for v in vals[3:6]]
    off += 16
    le, ref, inten = struct.unpack_from("<B3xff", data, off)
    s.loudness_enabled = le != 0
    s.loudness_ref_spl, s.loudness_intensity_pct = ref, inten
    off += 12
    xe, xp_, xi, _, fc, feed = struct.unpack_from("<BBBBff", data, off)
    s.crossfeed_enabled, s.crossfeed_preset = xe != 0, xp_
    s.crossfeed_itd, s.crossfeed_fc, s.crossfeed_feed = xi != 0, fc, feed
    off += 12
    s.crosspoints = []
    for i in range(2):
        row = []
        for o in range(nout):
            en, ph, _, _, gdb = struct.unpack_from(_XP_FMT, data, off)
            off += 8
            row.append(Crosspoint(en != 0, ph != 0, gdb))
        s.crosspoints.append(row)
    s.outputs = []
    for o in range(nout):
        en, mu, _, _, gdb, dms = struct.unpack_from(_OUT_FMT, data, off)
        off += 12
        s.outputs.append(OutputChannel(en != 0, mu != 0, gdb, dms))
    s.output_pins = list(struct.unpack_from(f"<{npin}B", data, off))
    off += 8
    s.channel_names = []
    for ch in range(nch):
        nm = data[off:off + C.PRESET_NAME_LEN].split(b"\x00")[0]
        s.channel_names.append(nm.decode("ascii", "replace"))
        off += C.PRESET_NAME_LEN
    s.output_types = list(struct.unpack_from("<4B", data, off))
    off += 4
    (s.i2s_bck_pin, s.i2s_mck_pin, mcke,
     s.i2s_mck_multiplier_raw) = struct.unpack_from("<BBBB", data, off)
    s.i2s_mck_enabled = mcke != 0
    off += 4
    en, spd, la, _, amount, maxg, gate = struct.unpack_from("<BBBBfff", data, off)
    s.leveller = dict(enabled=en != 0, speed=spd, lookahead=la != 0,
                      amount=amount, max_gain_db=maxg, gate_threshold_db=gate)
    off += 16
    s.preamp_db = list(struct.unpack_from("<2f", data, off))
    off += 8
    (s.master_volume_db,) = struct.unpack_from("<f", data, off)
    off += 4
    assert off == len(data)
    return s


def apply_slot(cfg: DeviceConfig, s: SlotFields, include_pins: bool) -> None:
    """apply_slot_to_live (flash_storage.c:597-742), versioned defaults.

    Gain-linear values follow the preset path's db_to_linear (clamped powf).
    """
    v = s.version
    p = cfg.platform
    nch, nout, npin, nspdif = _geom(p)

    cfg.eq = [[EqBand(b.type, b.freq, b.q, b.gain_db) for b in row]
              for row in s.eq]
    if v >= 12:
        cfg.preamp_db = list(s.preamp_db)
    else:
        cfg.preamp_db = [s.preamp_db_legacy] * 2
    cfg.preamp_linear = [db_to_linear_flash(d) for d in cfg.preamp_db]
    cfg.bypass_master_eq = s.bypass
    cfg.channel_delays_ms = list(s.delays_ms)
    cfg.channel_gain_db = list(s.channel_gain_db)
    cfg.channel_mute = list(s.channel_mute)
    cfg.loudness.enabled = s.loudness_enabled
    cfg.loudness.ref_spl = s.loudness_ref_spl
    cfg.loudness.intensity_pct = s.loudness_intensity_pct
    cfg.crossfeed.enabled = s.crossfeed_enabled
    cfg.crossfeed.preset = s.crossfeed_preset
    cfg.crossfeed.itd_enabled = s.crossfeed_itd
    cfg.crossfeed.custom_fc = s.crossfeed_fc
    cfg.crossfeed.custom_feed_db = s.crossfeed_feed
    cfg.crosspoints = [
        [Crosspoint(x.enabled, x.phase_invert, x.gain_db,
                    db_to_linear_flash(x.gain_db)) for x in row]
        for row in s.crosspoints]
    cfg.outputs = [
        OutputChannel(o.enabled, o.mute, o.gain_db, o.delay_ms,
                      db_to_linear_flash(o.gain_db)) for o in s.outputs]
    for o in range(nout):
        cfg.channel_delays_ms[C.CH_OUT_1 + o] = cfg.outputs[o].delay_ms

    if include_pins:
        defaults = default_output_pins(p)
        pins = []
        for i in range(npin):
            pin = s.output_pins[i]
            valid = pin <= 29 and pin != 12 and not (23 <= pin <= 25)
            if p is Platform.RP2040 and pin > 28:
                valid = False
            pins.append(pin if valid else defaults[i])
        cfg.hardware.output_pins = pins

    if v >= 8:
        cfg.channel_names = list(s.channel_names)
    else:
        cfg.channel_names = default_channel_names(p)

    if v >= 9:
        cfg.hardware.output_types = list(s.output_types[:nspdif]) + [0] * (4 - nspdif)
        cfg.hardware.i2s_bck_pin = s.i2s_bck_pin
        cfg.hardware.i2s_mck_pin = s.i2s_mck_pin
        cfg.hardware.i2s_mck_enabled = s.i2s_mck_enabled
        if v >= 11:
            cfg.hardware.i2s_mck_multiplier = \
                256 if s.i2s_mck_multiplier_raw == 1 else 128
        else:
            cfg.hardware.i2s_mck_multiplier = \
                256 if s.i2s_mck_multiplier_raw == 0 else s.i2s_mck_multiplier_raw
    else:
        cfg.hardware.output_types = [0, 0, 0, 0]
        cfg.hardware.i2s_bck_pin = 14
        cfg.hardware.i2s_mck_pin = 13
        cfg.hardware.i2s_mck_enabled = False
        cfg.hardware.i2s_mck_multiplier = 128

    if v >= 10:
        cfg.leveller.enabled = s.leveller["enabled"]
        cfg.leveller.speed = s.leveller["speed"]
        cfg.leveller.lookahead = s.leveller["lookahead"]
        cfg.leveller.amount = s.leveller["amount"]
        cfg.leveller.max_gain_db = s.leveller["max_gain_db"]
        cfg.leveller.gate_threshold_db = s.leveller["gate_threshold_db"]
    else:
        cfg.leveller.enabled = C.LEVELLER_DEFAULTS["enabled"]
        cfg.leveller.amount = C.LEVELLER_DEFAULTS["amount"]
        cfg.leveller.speed = C.LEVELLER_DEFAULTS["speed"]
        cfg.leveller.max_gain_db = C.LEVELLER_DEFAULTS["max_gain_db"]
        cfg.leveller.lookahead = C.LEVELLER_DEFAULTS["lookahead"]
        cfg.leveller.gate_threshold_db = C.LEVELLER_DEFAULTS["gate_threshold_db"]


# ----------------------------------------------------------------------------
# Preset directory codec (v1 + v2)
# ----------------------------------------------------------------------------


@dataclass
class Directory:
    """PresetDirectory v2 (flash_storage.c:113-133)."""

    startup_mode: int = 0
    default_slot: int = 0
    last_active_slot: int = 0
    include_pins: int = 1
    slot_occupied: int = 0
    master_volume_mode: int = C.MASTER_VOLUME_MODE_INDEPENDENT
    master_volume_db: float = C.MASTER_VOL_DEFAULT_DB
    slot_names: list = field(
        default_factory=lambda: [""] * C.PRESET_SLOTS)


_DIR_BODY_V2 = "<BBBBHBxf"            # + names


def encode_directory(d: Directory) -> bytes:
    body = struct.pack(_DIR_BODY_V2, d.startup_mode, d.default_slot,
                       d.last_active_slot, d.include_pins, d.slot_occupied,
                       d.master_volume_mode, float(F(d.master_volume_db)))
    for n in d.slot_names:
        nm = n.encode()[:C.PRESET_NAME_LEN - 1]
        body += nm + b"\x00" * (C.PRESET_NAME_LEN - len(nm))
    header = struct.pack("<IHHI", C.PRESET_MAGIC_DIR, C.PRESET_DIR_VERSION, 0,
                         crc32(body))
    return header + body


def decode_directory(raw: bytes) -> Directory | None:
    """dir_load_cache (flash_storage.c:371-419) incl. v1->v2 migration."""
    if len(raw) < 12:
        return None
    magic, version, _, crc = struct.unpack_from("<IHHI", raw, 0)
    if magic != C.PRESET_MAGIC_DIR:
        return None
    if version == C.PRESET_DIR_VERSION:
        body_len = struct.calcsize(_DIR_BODY_V2) + C.PRESET_SLOTS * C.PRESET_NAME_LEN
        body = raw[12:12 + body_len]
        if crc32(body) != crc:
            return None
        vals = struct.unpack_from(_DIR_BODY_V2, body, 0)
        d = Directory(*vals)
        off = struct.calcsize(_DIR_BODY_V2)
        d.slot_names = []
        for _ in range(C.PRESET_SLOTS):
            d.slot_names.append(
                body[off:off + C.PRESET_NAME_LEN].split(b"\x00")[0]
                .decode("ascii", "replace"))
            off += C.PRESET_NAME_LEN
        return d
    if version == 1:
        # v1 body: BBBB H B x + names (flash_storage.c:96-110)
        body_len = 8 + C.PRESET_SLOTS * C.PRESET_NAME_LEN
        body = raw[12:12 + body_len]
        if crc32(body) != crc:
            return None
        (startup, default, last, pins, occupied, include_mv,
         _pad) = struct.unpack_from("<BBBBHBB", body, 0)
        d = Directory(startup, default, last, pins, occupied,
                      C.MASTER_VOLUME_MODE_WITH_PRESET if include_mv
                      else C.MASTER_VOLUME_MODE_INDEPENDENT,
                      C.MASTER_VOL_DEFAULT_DB)
        off = 8
        d.slot_names = []
        for _ in range(C.PRESET_SLOTS):
            d.slot_names.append(
                body[off:off + C.PRESET_NAME_LEN].split(b"\x00")[0]
                .decode("ascii", "replace"))
            off += C.PRESET_NAME_LEN
        return d
    return None


# ----------------------------------------------------------------------------
# Bulk params codec (WireBulkParams v6, 2896 bytes)
# ----------------------------------------------------------------------------

WIRE_MAX_CHANNELS = 11
WIRE_MAX_OUTPUTS = 9
WIRE_MAX_BANDS = 12
WIRE_MAX_PINS = 5
WIRE_SIZE = 2896
FW_VERSION = (1, 1)


def encode_bulk(cfg: DeviceConfig) -> bytes:
    """bulk_params_collect (bulk_params.c:63-180)."""
    p = cfg.platform
    nch, nout, npin, nspdif = _geom(p)
    buf = bytearray()
    buf += struct.pack("<BBBBBBHHHI", C.BULK_WIRE_VERSION,
                       C.PLATFORM_IDS[p], nch, nout, 2, C.MAX_BANDS,
                       WIRE_SIZE, FW_VERSION[0], FW_VERSION[1], 0)
    buf += struct.pack("<fBB2xff", float(F(cfg.preamp_db[0])),
                       1 if cfg.bypass_master_eq else 0,
                       1 if cfg.loudness.enabled else 0,
                       float(F(cfg.loudness.ref_spl)),
                       float(F(cfg.loudness.intensity_pct)))
    xf = cfg.crossfeed
    buf += struct.pack("<BBBBffI", 1 if xf.enabled else 0, xf.preset,
                       1 if xf.itd_enabled else 0, 0, float(F(xf.custom_fc)),
                       float(F(xf.custom_feed_db)), 0)
    buf += struct.pack("<3f3BB", *[float(F(g)) for g in cfg.channel_gain_db],
                       *[1 if m else 0 for m in cfg.channel_mute], 0)
    delays = [0.0] * WIRE_MAX_CHANNELS
    for i in range(nch):
        delays[i] = float(F(cfg.channel_delays_ms[i]))
    for o in range(nout):
        delays[C.CH_OUT_1 + o] = float(F(cfg.outputs[o].delay_ms))
    buf += struct.pack(f"<{WIRE_MAX_CHANNELS}f", *delays)
    for i in range(2):
        for o in range(WIRE_MAX_OUTPUTS):
            if o < nout:
                x = cfg.crosspoints[i][o]
                buf += struct.pack("<BB2xf", 1 if x.enabled else 0,
                                   1 if x.phase_invert else 0,
                                   float(F(x.gain_db)))
            else:
                buf += struct.pack("<BB2xf", 0, 0, 0.0)
    for o in range(WIRE_MAX_OUTPUTS):
        if o < nout:
            oc = cfg.outputs[o]
            buf += struct.pack("<BB2xff", 1 if oc.enabled else 0,
                               1 if oc.mute else 0, float(F(oc.gain_db)),
                               float(F(oc.delay_ms)))
        else:
            buf += struct.pack("<BB2xff", 0, 0, 0.0, 0.0)
    pins = list(cfg.hardware.output_pins[:npin]) + [0] * (WIRE_MAX_PINS - npin)
    buf += struct.pack(f"<B{WIRE_MAX_PINS}B2x", npin, *pins)
    for ch in range(WIRE_MAX_CHANNELS):
        for b in range(WIRE_MAX_BANDS):
            if ch < nch:
                e = cfg.eq[ch][b]
                buf += struct.pack("<B3xfff", int(e.type), float(F(e.freq)),
                                   float(F(e.q)), float(F(e.gain_db)))
            else:
                buf += struct.pack("<B3xfff", 0, 0.0, 0.0, 0.0)
    for ch in range(WIRE_MAX_CHANNELS):
        nm = (cfg.channel_names[ch] if ch < nch else "").encode()[:31]
        buf += nm + b"\x00" * (C.PRESET_NAME_LEN - len(nm))
    types = list(cfg.hardware.output_types[:nspdif]) + [0] * (4 - nspdif)
    buf += struct.pack("<4BBBBB8x", *types, cfg.hardware.i2s_bck_pin,
                       cfg.hardware.i2s_mck_pin,
                       1 if cfg.hardware.i2s_mck_enabled else 0,
                       cfg.hardware.i2s_mck_multiplier & 0xFF)
    lv = cfg.leveller
    buf += struct.pack("<BBBBfff", 1 if lv.enabled else 0, lv.speed,
                       1 if lv.lookahead else 0, 0, float(F(lv.amount)),
                       float(F(lv.max_gain_db)),
                       float(F(lv.gate_threshold_db)))
    buf += struct.pack("<2f8x", *[float(F(v)) for v in cfg.preamp_db[:2]])
    buf += struct.pack("<f12x", float(F(cfg.master_volume_db)))
    data = bytes(buf)
    assert len(data) == WIRE_SIZE, len(data)
    return data


def apply_bulk(cfg: DeviceConfig, raw: bytes, apply_pins: bool = False) -> int:
    """bulk_params_apply (bulk_params.c:182-260): applies a wire payload.

    Uses the Taylor db_to_linear for every gain (the live firmware quirk);
    master volume uses powf.  Returns 0 on success, nonzero error otherwise.
    """
    if len(raw) < 16:
        return 1
    (version, platform_id, nch_w, nout_w, _nin, max_bands,
     _plen, _fmaj, _fmin, _res) = struct.unpack_from("<BBBBBBHHHI", raw, 0)
    p = cfg.platform
    nch, nout, npin, nspdif = _geom(p)
    if platform_id != C.PLATFORM_IDS[p]:
        return 2
    if version < 2 or version > C.BULK_WIRE_VERSION:
        return 3

    off = 16
    preamp_db, bypass, loud_en = struct.unpack_from("<fBB", raw, off)[:3]
    ref, inten = struct.unpack_from("<ff", raw, off + 8)
    lin = db_to_linear_taylor(preamp_db)
    cfg.preamp_db = [preamp_db, preamp_db]
    cfg.preamp_linear = [lin, lin]
    cfg.bypass_master_eq = bypass != 0
    cfg.loudness.enabled = loud_en != 0
    cfg.loudness.ref_spl = ref
    cfg.loudness.intensity_pct = inten
    off += 16
    xe, xp_, xi, _, fc, feed, _ = struct.unpack_from("<BBBBffI", raw, off)
    cfg.crossfeed.enabled = xe != 0
    cfg.crossfeed.preset = xp_
    cfg.crossfeed.itd_enabled = xi != 0
    cfg.crossfeed.custom_fc = fc
    cfg.crossfeed.custom_feed_db = feed
    off += 16
    vals = struct.unpack_from("<3f3BB", raw, off)
    cfg.channel_gain_db = list(vals[:3])
    cfg.channel_mute = [v != 0 for v in vals[3:6]]
    off += 16
    delays = struct.unpack_from(f"<{WIRE_MAX_CHANNELS}f", raw, off)
    cfg.channel_delays_ms = list(delays[:nch])
    off += WIRE_MAX_CHANNELS * 4
    cfg.crosspoints = []
    for i in range(2):
        row = []
        for o in range(WIRE_MAX_OUTPUTS):
            en, ph, gdb = struct.unpack_from("<BB2xf", raw, off)
            off += 8
            if o < nout:
                row.append(Crosspoint(en != 0, ph != 0, gdb,
                                      db_to_linear_taylor(gdb)))
        cfg.crosspoints.append(row)
    cfg.outputs = []
    for o in range(WIRE_MAX_OUTPUTS):
        en, mu, gdb, dms = struct.unpack_from("<BB2xff", raw, off)
        off += 12
        if o < nout:
            cfg.outputs.append(OutputChannel(en != 0, mu != 0, gdb, dms,
                                             db_to_linear_taylor(gdb)))
    for o in range(nout):
        cfg.channel_delays_ms[C.CH_OUT_1 + o] = cfg.outputs[o].delay_ms
    npin_w = raw[off]
    pins = list(raw[off + 1:off + 1 + WIRE_MAX_PINS])
    if apply_pins:
        defaults = default_output_pins(p)
        newpins = []
        for i in range(npin):
            pin = pins[i] if i < npin_w else 0
            valid = pin <= 29 and pin != 12 and not (23 <= pin <= 25)
            if p is Platform.RP2040 and pin > 28:
                valid = False
            newpins.append(pin if valid else defaults[i])
        cfg.hardware.output_pins = newpins
    off += 8
    for ch in range(WIRE_MAX_CHANNELS):
        for b in range(WIRE_MAX_BANDS):
            typ, freq, q, gdb = struct.unpack_from("<B3xfff", raw, off)
            off += 16
            if ch < nch and b < max_bands:
                cfg.eq[ch][b] = EqBand(FilterType(typ if typ <= 5 else 0),
                                       freq, q, gdb)
    for ch in range(WIRE_MAX_CHANNELS):
        nm = raw[off:off + C.PRESET_NAME_LEN].split(b"\x00")[0]
        if ch < nch:
            cfg.channel_names[ch] = nm.decode("ascii", "replace")
        off += C.PRESET_NAME_LEN
    if version >= 3 and len(raw) >= off + 16:
        types = list(raw[off:off + 4])
        cfg.hardware.output_types = types[:nspdif] + [0] * (4 - nspdif)
        cfg.hardware.i2s_bck_pin = raw[off + 4]
        cfg.hardware.i2s_mck_pin = raw[off + 5]
        cfg.hardware.i2s_mck_enabled = raw[off + 6] != 0
        mult = raw[off + 7]
        cfg.hardware.i2s_mck_multiplier = 256 if mult == 0 else mult
    off += 16
    if version >= 4 and len(raw) >= off + 16:
        en, spd, la, _, amount, maxg, gate = struct.unpack_from(
            "<BBBBfff", raw, off)
        cfg.leveller.enabled = en != 0
        cfg.leveller.speed = spd
        cfg.leveller.lookahead = la != 0
        cfg.leveller.amount = amount
        cfg.leveller.max_gain_db = maxg
        cfg.leveller.gate_threshold_db = gate
    off += 16
    if version >= 6 and len(raw) >= off + 32:
        pa = struct.unpack_from("<2f", raw, off)
        cfg.preamp_db = list(pa)
        cfg.preamp_linear = [db_to_linear_taylor(v) for v in pa]
        (mv,) = struct.unpack_from("<f", raw, off + 16)
        if not np.isfinite(mv):
            mv = C.MASTER_VOL_MAX_DB
        cfg.master_volume_db = float(np.clip(mv, C.MASTER_VOL_MUTE_DB,
                                             C.MASTER_VOL_MAX_DB))
    return 0
