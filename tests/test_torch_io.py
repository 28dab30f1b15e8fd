"""The port's preset and bulk codecs (``dspi_tpu_torch.io``) against the
JAX package's: slot, directory and bulk bytes, the preset store's flash
image, CRC32, v1-directory and legacy-sector migration — byte for byte,
on both platforms; and the port's native CRC32."""

import dataclasses
import struct
import zlib

import pytest

from dspi_tpu import Platform as JPlatform
from dspi_tpu.core import constants as JC
from dspi_tpu.io import presets as jpresets, wire as jwire
from dspi_tpu_torch import DeviceConfig, Platform, native
from dspi_tpu_torch.core import constants as C
from dspi_tpu_torch.io import presets, wire

from test_torch_pack import _convert
from util import rich_config

NAMES = ["RP2350", "RP2040"]


def _cfgs(name, **kw):
    jcfg = rich_config(JPlatform[name], **kw)
    jcfg.channel_names[0] = "Front L"
    jcfg.master_volume_db = -12.0
    return _convert(jcfg), jcfg


def _same_cfg(mine, theirs):
    assert dataclasses.asdict(mine) == dataclasses.asdict(_convert(theirs))


def test_crc32_matches_jax_and_native():
    data = bytes(range(256)) + b"DSPi" * 100
    assert wire.crc32(data) == jwire.crc32(data) == zlib.crc32(data)
    assert native.crc32(data) == zlib.crc32(data)
    assert native.crc32(b"") == zlib.crc32(b"")


@pytest.mark.parametrize("name", NAMES)
def test_slot_bytes_match_jax(name):
    cfg, jcfg = _cfgs(name)
    for idx in (0, 3, 9):
        raw = wire.encode_slot(cfg, idx)
        assert raw == jwire.encode_slot(jcfg, idx)
        for pins in (False, True):
            mine = DeviceConfig(platform=Platform[name])
            theirs = type(jcfg)(platform=JPlatform[name])
            wire.apply_slot(mine, wire.decode_slot(raw, Platform[name], idx),
                            include_pins=pins)
            jwire.apply_slot(theirs,
                             jwire.decode_slot(raw, JPlatform[name], idx),
                             include_pins=pins)
            _same_cfg(mine, theirs)
    bad = bytearray(raw)
    bad[100] ^= 0xFF
    assert wire.decode_slot(bytes(bad), Platform[name], 9) is None
    assert wire.decode_slot(raw, Platform[name], 8) is None


def test_directory_bytes_and_v1_migration_match_jax():
    kw = dict(startup_mode=1, default_slot=2, last_active_slot=5,
              include_pins=0, slot_occupied=0b1010101,
              master_volume_mode=1, master_volume_db=-14.5)
    d, jd = wire.Directory(**kw), jwire.Directory(**kw)
    d.slot_names[5] = jd.slot_names[5] = "Movie night"
    raw = wire.encode_directory(d)
    assert raw == jwire.encode_directory(jd)
    assert dataclasses.asdict(wire.decode_directory(raw)) == \
        dataclasses.asdict(jwire.decode_directory(raw))

    # a v1 directory image (flash_storage.c:96-110)
    body = struct.pack("<BBBBHBB", 0, 1, 4, 1, 0x0012, 1, 0)
    body += b"".join((f"slot{i}".encode() + b"\x00" * 32)[:32]
                     for i in range(C.PRESET_SLOTS))
    v1 = struct.pack("<IHHI", C.PRESET_MAGIC_DIR, 1, 0,
                     wire.crc32(body)) + body
    mine, theirs = wire.decode_directory(v1), jwire.decode_directory(v1)
    assert mine is not None
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert wire.encode_directory(mine) == jwire.encode_directory(theirs)


@pytest.mark.parametrize("name", NAMES)
def test_bulk_bytes_match_jax(name):
    cfg, jcfg = _cfgs(name)
    raw = wire.encode_bulk(cfg)
    assert len(raw) == 2896
    assert raw == jwire.encode_bulk(jcfg)
    for other in NAMES:                         # a mismatch is refused alike
        mine = DeviceConfig(platform=Platform[other])
        theirs = type(jcfg)(platform=JPlatform[other])
        assert wire.apply_bulk(mine, raw) == jwire.apply_bulk(theirs, raw)
        _same_cfg(mine, theirs)


@pytest.mark.parametrize("name", NAMES)
def test_preset_store_image_matches_jax(name):
    """The same save/name/startup/load/delete sequence leaves both flash
    images byte-equal, and a fresh store over the image boots alike."""
    cfg, jcfg = _cfgs(name)
    store = presets.PresetStore(Platform[name])
    jstore = jpresets.PresetStore(JPlatform[name])
    live = DeviceConfig(platform=Platform[name])
    jlive = type(jcfg)(platform=JPlatform[name])
    ops = [("save", 4, cfg, jcfg), ("set_name", 4, "Reference", "Reference"),
           ("save", 2, cfg, jcfg), ("set_startup", 0, 2, 2),
           ("load", 4, live, jlive), ("load", 7, live, jlive),
           ("load", 4, live, jlive), ("delete", 4, live, jlive)]
    for op, slot, a, b in ops:
        assert getattr(store, op)(slot, a) == getattr(jstore, op)(slot, b)
        assert bytes(store.image) == bytes(jstore.image), op
        _same_cfg(live, jlive)
    assert store.get_active() == jstore.get_active()
    assert [store.get_name(s) for s in range(C.PRESET_SLOTS)] == \
        [jstore.get_name(s) for s in range(C.PRESET_SLOTS)]

    image = bytes(store.image)
    boot = DeviceConfig(platform=Platform[name])
    jboot = type(jcfg)(platform=JPlatform[name])
    presets.PresetStore(Platform[name], image=image).boot_load(boot)
    jpresets.PresetStore(JPlatform[name], image=image).boot_load(jboot)
    _same_cfg(boot, jboot)


@pytest.mark.parametrize("name", NAMES)
def test_legacy_migration_matches_jax(name):
    """A DSP1 legacy sector migrates into slot 0 at boot alike."""
    cfg, jcfg = _cfgs(name, leveller=False)
    full = wire.encode_slot(cfg, 0)
    nch, nout, npin, _ = wire._geom(Platform[name])
    legacy_len = (nch * C.MAX_BANDS * 16 + 8 + nch * 4 + 16 + 12 + 12
                  + 2 * nout * 8 + nout * 12 + 8)
    data = full[12:12 + legacy_len]
    legacy = struct.pack("<IHHI", JC.PRESET_MAGIC_LEGACY, 6, 0,
                         wire.crc32(data)) + data
    at = 11 * wire.SECTOR_SIZE

    store = presets.PresetStore(Platform[name])
    jstore = jpresets.PresetStore(JPlatform[name])
    store.image[at:at + len(legacy)] = legacy
    jstore.image[at:at + len(legacy)] = legacy
    mine = DeviceConfig(platform=Platform[name])
    theirs = type(jcfg)(platform=JPlatform[name])
    store.boot_load(mine)
    jstore.boot_load(theirs)
    assert store.dir.slot_occupied == 1 and store.get_name(0) == "Migrated"
    assert bytes(store.image) == bytes(jstore.image)
    _same_cfg(mine, theirs)
