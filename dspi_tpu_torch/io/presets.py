"""Preset store: the firmware's 10-slot flash preset system on a flash image.

A copy of the JAX package's ``io/presets.py`` for the PyTorch port.

Reproduces flash_storage.c's behavior over a 48 KB image (12 x 4 KB
sectors: directory, 10 slots, legacy) so that a dump of a real device's
flash tail loads unchanged, including:

  * CRC32-validated slots with versioned field application (v1-v12)
  * directory v1 -> v2 migration (flash_storage.c:390-415)
  * legacy "DSP1" single-sector migration into slot 0 (flash_storage.c:997-1045)
  * boot policy: specified slot vs last-active (preset_boot_load)
  * master-volume dual persistence modes (apply_master_volume_from_mode)
  * factory defaults (apply_factory_defaults, flash_storage.c:1144-1238)

Status codes match config.h:262-266.
"""

from __future__ import annotations

import numpy as np

from ..core import constants as C
from ..core.constants import Platform
from ..params.types import DeviceConfig
from . import wire

PRESET_OK = 0x00
PRESET_ERR_INVALID_SLOT = 0x01
PRESET_ERR_SLOT_EMPTY = 0x02
PRESET_ERR_CRC = 0x03
PRESET_ERR_FLASH_WRITE = 0x04

_ERASED = b"\xFF" * wire.SECTOR_SIZE


class PresetStore:
    """Flash-image-backed preset system for one virtual device."""

    def __init__(self, platform: Platform = Platform.RP2350,
                 image: bytes | None = None):
        self.platform = platform
        if image is not None:
            assert len(image) == wire.SECTOR_SIZE * wire.NUM_SECTORS
            self.image = bytearray(image)
        else:
            self.image = bytearray(_ERASED * wire.NUM_SECTORS)
        self.dir: wire.Directory | None = None
        self._dir_valid = False

    # -- sector helpers ------------------------------------------------------

    def _sector(self, n: int) -> bytes:
        return bytes(self.image[n * wire.SECTOR_SIZE:(n + 1) * wire.SECTOR_SIZE])

    def _write_sector(self, n: int, data: bytes) -> None:
        """flash_write_sector: erase + program, 0xFF tail padding
        (flash_storage.c:315-357)."""
        sector = bytearray(_ERASED)
        sector[:len(data)] = data
        self.image[n * wire.SECTOR_SIZE:(n + 1) * wire.SECTOR_SIZE] = sector

    def _erase_sector(self, n: int) -> None:
        self.image[n * wire.SECTOR_SIZE:(n + 1) * wire.SECTOR_SIZE] = _ERASED

    # -- directory -----------------------------------------------------------

    def _dir_load(self) -> bool:
        d = wire.decode_directory(self._sector(0))
        if d is None:
            self._dir_valid = False
            return False
        # v1 payloads are migrated by decode; persist as v2 like the firmware
        raw = self._sector(0)
        version = int.from_bytes(raw[4:6], "little")
        self.dir = d
        self._dir_valid = True
        if version == 1:
            self._dir_flush()
        return True

    def _dir_flush(self) -> None:
        self._write_sector(0, wire.encode_directory(self.dir))

    def _dir_ensure(self) -> None:
        """dir_ensure (flash_storage.c:441-460)."""
        if self._dir_valid:
            return
        if self._dir_load():
            return
        self.dir = wire.Directory()
        self.dir.slot_names[0] = "Default"
        self._dir_valid = True
        # firmware defers the flush to the first save

    # -- public API (mirrors preset_* in flash_storage.c) --------------------

    def save(self, slot: int, cfg: DeviceConfig) -> int:
        if slot >= C.PRESET_SLOTS:
            return PRESET_ERR_INVALID_SLOT
        self._dir_ensure()
        self._write_sector(1 + slot, wire.encode_slot(cfg, slot))
        self.dir.slot_occupied |= 1 << slot
        self.dir.last_active_slot = slot
        self._dir_flush()
        return PRESET_OK

    def load(self, slot: int, cfg: DeviceConfig) -> int:
        """preset_load (flash_storage.c:794-849): applies slot (or factory
        defaults for empty slots) into ``cfg`` in place."""
        if slot >= C.PRESET_SLOTS:
            return PRESET_ERR_INVALID_SLOT
        self._dir_ensure()
        if self.dir.slot_occupied & (1 << slot):
            s = wire.decode_slot(self._sector(1 + slot), self.platform, slot)
            if s is None:
                return PRESET_ERR_CRC
            wire.apply_slot(cfg, s, self.dir.include_pins != 0)
            self._apply_master_volume_from_mode(cfg, s)
        else:
            self.factory_defaults(cfg)
        self.dir.last_active_slot = slot
        self._dir_flush()
        return PRESET_OK

    def delete(self, slot: int, cfg: DeviceConfig) -> int:
        """preset_delete (flash_storage.c:852-907)."""
        if slot >= C.PRESET_SLOTS:
            return PRESET_ERR_INVALID_SLOT
        self._dir_ensure()
        self._erase_sector(1 + slot)
        self.dir.slot_occupied &= ~(1 << slot)
        self.dir.slot_names[slot] = ""
        self._dir_flush()
        if slot == self.dir.last_active_slot:
            self.factory_defaults(cfg)
        return PRESET_OK

    def get_name(self, slot: int) -> str:
        self._dir_ensure()
        return self.dir.slot_names[slot]

    def set_name(self, slot: int, name: str) -> int:
        if slot >= C.PRESET_SLOTS:
            return PRESET_ERR_INVALID_SLOT
        self._dir_ensure()
        self.dir.slot_names[slot] = name[:C.PRESET_NAME_LEN - 1]
        self._dir_flush()
        return PRESET_OK

    def set_startup(self, mode: int, default_slot: int) -> int:
        if mode > 1 or default_slot >= C.PRESET_SLOTS:
            return PRESET_ERR_INVALID_SLOT
        self._dir_ensure()
        self.dir.startup_mode = mode
        self.dir.default_slot = default_slot
        self._dir_flush()
        return PRESET_OK

    def set_include_pins(self, include: bool) -> None:
        self._dir_ensure()
        self.dir.include_pins = 1 if include else 0
        self._dir_flush()

    def set_master_volume_mode(self, mode: int) -> None:
        self._dir_ensure()
        self.dir.master_volume_mode = (
            mode if mode <= C.MASTER_VOLUME_MODE_WITH_PRESET
            else C.MASTER_VOLUME_MODE_INDEPENDENT)
        self._dir_flush()

    def save_master_volume(self, cfg: DeviceConfig) -> int:
        """REQ_SAVE_MASTER_VOLUME (flash_storage.c:960-966)."""
        self._dir_ensure()
        self.dir.master_volume_db = cfg.master_volume_db
        self._dir_flush()
        return PRESET_OK

    def get_saved_master_volume(self) -> float:
        self._dir_ensure()
        return self.dir.master_volume_db

    def get_active(self) -> int:
        self._dir_ensure()
        return self.dir.last_active_slot

    # -- boot ----------------------------------------------------------------

    def boot_load(self, cfg: DeviceConfig) -> None:
        """preset_boot_load (flash_storage.c:1047-1102)."""
        if self._dir_load():
            if self.dir.startup_mode == 1:      # LAST_ACTIVE
                target = self.dir.last_active_slot
            else:
                target = self.dir.default_slot
            if target >= C.PRESET_SLOTS:
                target = self.dir.default_slot
                if target >= C.PRESET_SLOTS:
                    target = 0
            if self.dir.slot_occupied & (1 << target):
                s = wire.decode_slot(self._sector(1 + target), self.platform,
                                     target)
                if s is not None:
                    wire.apply_slot(cfg, s, self.dir.include_pins != 0)
                    self._apply_master_volume_from_mode(cfg, s)
                else:
                    self.factory_defaults(cfg)
            else:
                self.factory_defaults(cfg)
            self.dir.last_active_slot = target
            return

        if self._migrate_legacy(cfg):
            return

        # first boot
        self._dir_ensure()
        self._dir_flush()
        self.factory_defaults(cfg)

    def _migrate_legacy(self, cfg: DeviceConfig) -> bool:
        """migrate_legacy (flash_storage.c:997-1045): DSP1 sector -> slot 0.

        The legacy data section matches the slot layout up to the pin
        padding, so the migration re-wraps it with a slot header and a CRC
        over the *current* slot extent (zero-padded tail)."""
        raw = self._sector(11)
        if int.from_bytes(raw[0:4], "little") != C.PRESET_MAGIC_LEGACY:
            return False
        version = int.from_bytes(raw[4:6], "little")
        crc = int.from_bytes(raw[8:12], "little")
        nch, nout, npin, _ = wire._geom(self.platform)
        legacy_data_len = (nch * C.MAX_BANDS * 16 + 8 + nch * 4 + 16 + 12
                          + 12 + 2 * nout * 8 + nout * 12 + 8)
        data = raw[12:12 + legacy_data_len]
        if wire.crc32(data) != crc:
            return False

        slot_data = bytearray(wire.slot_data_size(self.platform))
        slot_data[:legacy_data_len] = data
        header = np.array([0], np.uint32)  # placeholder
        import struct as _s
        hdr = _s.pack("<IHHI", C.PRESET_MAGIC_SLOT, version, 0,
                      wire.crc32(bytes(slot_data)))
        self._write_sector(1, hdr + bytes(slot_data))
        del header

        self.dir = wire.Directory()
        self.dir.slot_occupied = 0x0001
        self.dir.slot_names[0] = "Migrated"
        self._dir_valid = True
        self._dir_flush()

        s = wire.decode_slot(self._sector(1), self.platform, 0)
        if s is not None:
            wire.apply_slot(cfg, s, include_pins=False)
            self._apply_master_volume_from_mode(cfg, s)
        else:
            self.factory_defaults(cfg)
        return True

    # -- helpers -------------------------------------------------------------

    def _apply_master_volume_from_mode(self, cfg: DeviceConfig,
                                       slot: wire.SlotFields | None) -> None:
        """apply_master_volume_from_mode (flash_storage.c:578-594)."""
        if (self.dir.master_volume_mode == C.MASTER_VOLUME_MODE_WITH_PRESET
                and slot is not None and slot.version >= 12):
            db = slot.master_volume_db
        else:
            db = self.dir.master_volume_db
        if not np.isfinite(db):
            db = C.MASTER_VOL_MAX_DB
        cfg.master_volume_db = float(np.clip(db, C.MASTER_VOL_MUTE_DB,
                                             C.MASTER_VOL_MAX_DB))

    def factory_defaults(self, cfg: DeviceConfig) -> None:
        """apply_factory_defaults (flash_storage.c:1144-1238) in place."""
        fresh = DeviceConfig(platform=cfg.platform,
                             sample_rate=cfg.sample_rate)
        for attr in ("preamp_db", "preamp_linear", "bypass_master_eq", "eq",
                     "band_counts", "crosspoints", "outputs", "crossfeed",
                     "leveller", "loudness", "channel_names",
                     "channel_delays_ms", "channel_gain_db", "channel_mute",
                     "hardware"):
            setattr(cfg, attr, getattr(fresh, attr))
        self._dir_ensure()
        self._apply_master_volume_from_mode(cfg, None)
