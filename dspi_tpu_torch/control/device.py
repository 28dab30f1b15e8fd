"""VirtualDSPi: the vendor-protocol control plane over the batched engine.

A copy of the JAX package's ``control/device.py`` for the PyTorch port.

Emulates the firmware's EP0 vendor interface (usb_audio.c:1632-3143):
``set(request, wValue, payload)`` mirrors a control-OUT transfer,
``get(request, wValue)`` a control-IN transfer returning bytes.  A host
application written against the DSPi USB protocol can drive this object
unchanged (minus the USB plumbing).

State mutations land in a DeviceConfig; ``commit()`` repacks the config
into the engine — the analog of the firmware's deferred main-loop
updates (main.c:826-976).  Telemetry (peaks, clip flags, loads) is fed
back from engine outputs.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core import constants as C
from ..core.constants import FilterType, Platform
from ..io import presets, wire
from ..params.design import clamp_band, is_filter_flat
from ..params.types import DeviceConfig, EqBand
from . import requests as R
from .envelope import PresetMuteEnvelope

F = np.float32


def _host(v) -> np.ndarray:
    """A NumPy array of ``v``, which may be a tensor on the card."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _f(payload: bytes, off: int = 0) -> float:
    return struct.unpack_from("<f", payload, off)[0]


def _pf(value: float) -> bytes:
    return struct.pack("<f", float(F(value)))


class VirtualDSPi:
    """One virtual device: config + preset store + vendor dispatch."""

    def __init__(self, platform: Platform = Platform.RP2350,
                 store: presets.PresetStore | None = None,
                 serial: str = "DSPITPU000001"):
        self.platform = platform
        self.cfg = DeviceConfig(platform=platform)
        self.store = store if store is not None else presets.PresetStore(platform)
        self.serial = serial
        self.fw_version_bcd = (1 << 8) | (1 << 4) | 3   # config.h:276
        # telemetry mirrors (fed by the engine runner)
        self.peaks = [0] * self.cfg.num_channels
        self.clip_flags = 0
        self.cpu_loads = (0, 0)
        self.counters = dict.fromkeys(
            ["pdm_ring_overruns", "pdm_ring_underruns", "pdm_dma_overruns",
             "pdm_dma_underruns", "spdif_overruns", "spdif_underruns",
             "usb_audio_packets", "ring_overruns"], 0)
        # The preset-mute envelope is armed automatically by preset/flash
        # ops (usb_audio.c:456-498, flash_storage.c:272-276); the engine
        # runner feeds mute_env.packet_gains(...) into Engine.process.
        self.mute_env = PresetMuteEnvelope()
        self.runner = None            # optional StreamRunner (buffer stats)
        self.dirty = False
        self._preset_loaded = False
        # Control-plane framing errors (usb_device.c:46-52 analog):
        # truncated vendor payloads count as incomplete transfers.
        self.usb_errors = dict.fromkeys(
            ["total", "crc", "bitstuff", "rx_overflow", "rx_timeout",
             "data_seq"], 0)
        # REQ_ENTER_BOOTLOADER (usb_audio.c:2970-2978) reboots to the UF2
        # bootloader; the emulation raises this flag for the host harness.
        self.bootloader_requested = False
        self._stats_seq = 0
        # UAC streaming alt setting: alt1 = 16-bit, alt2 = 24-bit
        # (usb_descriptors.c:64-235); per-packet unpack format follows it
        # (usb_audio.c:591-686).  None until the host explicitly selects
        # an alt (alt0 idle at boot): commit() then keeps whatever
        # bit_depth the attached engine was built with, instead of
        # silently forcing a 16-bit unpack into a 24-bit engine on the
        # first unrelated config commit.
        self.bit_depth = None
        self.store.boot_load(self.cfg)

    def attach_runner(self, runner) -> None:
        """Connect a StreamRunner so buffer statistics and starvation
        counters report real runtime health instead of static values.

        Also wires the runner's disruption gate to this device's preset
        mute envelope: while a preset/flash operation holds the mute
        (``mute_env.loading`` — the ``preset_loading`` analog, set by
        every PRESET_*/SAVE/LOAD/FACTORY_RESET op and cleared when the
        hold expires, usb_audio.c:469-476), missed feed deadlines are
        suppressed from the starvation counters exactly as the firmware
        masks them (audio_spdif.c:375-378)."""
        self.runner = runner
        if hasattr(runner, "disruption_source"):
            runner.disruption_source = lambda: self.mute_env.loading

    def packet_gains(self, n_packets: int, block_size: int) -> np.ndarray:
        """Per-packet preset-mute gains for the next segment — pass as
        ``Engine.process(x, preset_mute=...)``."""
        return self.mute_env.packet_gains(n_packets, block_size,
                                          int(self.cfg.sample_rate))

    def commit(self, engine) -> bool:
        """Push accumulated config changes into an Engine — the analog of
        the firmware main loop applying deferred vendor updates
        (main.c:826-976).  Returns True if anything was applied."""
        if not self.dirty:
            return False
        old_static = getattr(engine, "static", None)
        engine.update_config(self.cfg, preset_load=self._preset_loaded,
                             bit_depth=self.bit_depth)
        if (self.runner is not None
                and getattr(engine, "static", None) is not old_static
                and hasattr(self.runner, "note_disruption")):
            # structural rebuild: the recompile stall is intentional —
            # reset the attached runner's feed-deadline clock (the analog
            # of audio_ring_last_push_us = 0 on lifecycle transitions)
            self.runner.note_disruption()
        self.dirty = False
        self._preset_loaded = False
        return True

    # ------------------------------------------------------------------
    # firmware-equivalent derived state
    # ------------------------------------------------------------------

    def derive_core1_mode(self) -> int:
        """derive_core1_mode (usb_audio.c:1620-1630)."""
        outs = self.cfg.outputs
        if outs[-1].enabled:
            return R.CORE1_MODE_PDM
        last = {Platform.RP2350: 7, Platform.RP2040: 3}[self.platform]
        for o in range(2, last + 1):
            if outs[o].enabled:
                return R.CORE1_MODE_EQ_WORKER
        return R.CORE1_MODE_IDLE

    def _core1_conflict(self, out: int, enable: bool) -> bool:
        """The PDM/EQ-worker mutual-exclusion interlock
        (usb_audio.c:1886-1920).  Returns True when the enable is refused."""
        if not enable:
            return False
        outs = self.cfg.outputs
        nout = len(outs)
        last = {Platform.RP2350: 7, Platform.RP2040: 3}[self.platform]
        if out == nout - 1:
            return any(outs[i].enabled for i in range(2, last + 1))
        if 2 <= out <= last:
            return bool(outs[nout - 1].enabled)
        return False

    # ------------------------------------------------------------------
    # SET (control-OUT) dispatch — vendor_cmd_packet (usb_audio.c:1632-2021)
    # ------------------------------------------------------------------

    # Minimum payload byte counts per SET request — a shorter payload is a
    # truncated control transfer; the firmware's SIE would count it
    # (usb_device.c:1070-1075) and the handler would ignore the write.
    _SET_MIN_LEN = None   # built lazily in _set_min_len()

    @classmethod
    def _set_min_len(cls) -> dict:
        if cls._SET_MIN_LEN is None:
            four = [R.SET_PREAMP, R.SET_PREAMP_CH, R.SET_MASTER_VOLUME,
                    R.SET_DELAY, R.SET_CHANNEL_GAIN, R.SET_LOUDNESS_REF,
                    R.SET_LOUDNESS_INTENSITY, R.SET_CROSSFEED_FREQ,
                    R.SET_CROSSFEED_FEED, R.SET_OUTPUT_GAIN,
                    R.SET_OUTPUT_DELAY, R.SET_LEVELLER_AMOUNT,
                    R.SET_LEVELLER_MAX_GAIN, R.SET_LEVELLER_GATE]
            one = [R.SET_MASTER_VOLUME_MODE, R.SET_BYPASS,
                   R.SET_CHANNEL_MUTE, R.SET_LOUDNESS, R.SET_CROSSFEED,
                   R.SET_CROSSFEED_PRESET, R.SET_CROSSFEED_ITD,
                   R.SET_OUTPUT_ENABLE, R.SET_OUTPUT_MUTE, R.SET_OUTPUT_PIN,
                   R.SET_OUTPUT_TYPE, R.SET_I2S_BCK_PIN, R.SET_MCK_ENABLE,
                   R.SET_MCK_PIN, R.SET_MCK_MULTIPLIER,
                   R.SET_LEVELLER_ENABLE, R.SET_LEVELLER_SPEED,
                   R.SET_LEVELLER_LOOKAHEAD, R.PRESET_SET_INCLUDE_PINS]
            cls._SET_MIN_LEN = {**{r: 4 for r in four},
                                **{r: 1 for r in one},
                                R.SET_EQ_PARAM: 16, R.SET_MATRIX_ROUTE: 8,
                                R.PRESET_SET_STARTUP: 2}
        return cls._SET_MIN_LEN

    def _count_usb_error(self, kind: str) -> None:
        self.usb_errors["total"] += 1
        self.usb_errors[kind] += 1

    def set(self, request: int, wvalue: int = 0, payload: bytes = b"") -> None:
        cfg = self.cfg
        ch = wvalue & 0xFF
        need = self._set_min_len().get(request)
        if need is not None and len(payload) < need:
            self._count_usb_error("rx_timeout")
            return
        self.dirty = True

        if request == R.SET_EQ_PARAM and len(payload) >= 16:
            pch, band, typ, _ = struct.unpack_from("<BBBB", payload, 0)
            freq, q, gain = struct.unpack_from("<fff", payload, 4)
            if pch < cfg.num_channels and band < cfg.band_counts[pch]:
                b = EqBand(FilterType(typ if typ <= 5 else 0), freq, q, gain)
                # dsp_compute_coefficients clamps the stored recipe in place
                if not is_filter_flat(b):
                    b = clamp_band(b, cfg.sample_rate)
                cfg.eq[pch][band] = b
        elif request == R.SET_PREAMP and len(payload) >= 4:
            db = _f(payload)
            if np.isfinite(db):
                cfg.preamp_db = [db, db]
                cfg.preamp_linear = None
        elif request == R.SET_PREAMP_CH and len(payload) >= 4:
            db = _f(payload)
            if ch < 2 and np.isfinite(db):
                cfg.preamp_db[ch] = db
                cfg.preamp_linear = None
        elif request == R.SET_MASTER_VOLUME and len(payload) >= 4:
            db = _f(payload)
            if np.isfinite(db):
                cfg.master_volume_db = float(np.clip(db, C.MASTER_VOL_MUTE_DB,
                                                     C.MASTER_VOL_MAX_DB))
        elif request == R.SET_MASTER_VOLUME_MODE and len(payload) >= 1:
            self.store.set_master_volume_mode(payload[0])
        elif request == R.SAVE_MASTER_VOLUME:
            self.store.save_master_volume(cfg)
        elif request == R.SET_DELAY and len(payload) >= 4:
            if ch < cfg.num_channels:
                cfg.channel_delays_ms[ch] = max(_f(payload), 0.0)
        elif request == R.SET_BYPASS and len(payload) >= 1:
            cfg.bypass_master_eq = payload[0] != 0
        elif request == R.SET_CHANNEL_GAIN and len(payload) >= 4:
            if ch < 3:
                cfg.channel_gain_db[ch] = _f(payload)
        elif request == R.SET_CHANNEL_MUTE and len(payload) >= 1:
            if ch < 3:
                cfg.channel_mute[ch] = payload[0] != 0
        elif request == R.SET_LOUDNESS and len(payload) >= 1:
            cfg.loudness.enabled = payload[0] != 0
        elif request == R.SET_LOUDNESS_REF and len(payload) >= 4:
            cfg.loudness.ref_spl = _f(payload)
        elif request == R.SET_LOUDNESS_INTENSITY and len(payload) >= 4:
            cfg.loudness.intensity_pct = _f(payload)
        elif request == R.SET_CROSSFEED and len(payload) >= 1:
            cfg.crossfeed.enabled = payload[0] != 0
        elif request == R.SET_CROSSFEED_PRESET and len(payload) >= 1:
            cfg.crossfeed.preset = min(payload[0], 3)
        elif request == R.SET_CROSSFEED_FREQ and len(payload) >= 4:
            cfg.crossfeed.custom_fc = _f(payload)
            cfg.crossfeed.preset = 3
        elif request == R.SET_CROSSFEED_FEED and len(payload) >= 4:
            cfg.crossfeed.custom_feed_db = _f(payload)
            cfg.crossfeed.preset = 3
        elif request == R.SET_CROSSFEED_ITD and len(payload) >= 1:
            cfg.crossfeed.itd_enabled = payload[0] != 0
        elif request == R.SET_MATRIX_ROUTE and len(payload) >= 8:
            inp, out, en, ph = struct.unpack_from("<BBBB", payload, 0)
            gdb = _f(payload, 4)
            if inp < 2 and out < cfg.num_outputs:
                xp = cfg.crosspoints[inp][out]
                xp.enabled = en != 0
                xp.phase_invert = ph != 0
                xp.gain_db = gdb
                xp.gain_linear = None          # recompute via powf
        elif request == R.SET_OUTPUT_ENABLE and len(payload) >= 1:
            if ch < cfg.num_outputs:
                want = payload[0] != 0
                if not self._core1_conflict(ch, want):
                    cfg.outputs[ch].enabled = want
        elif request == R.SET_OUTPUT_GAIN and len(payload) >= 4:
            if ch < cfg.num_outputs:
                cfg.outputs[ch].gain_db = _f(payload)
                cfg.outputs[ch].gain_linear = None
        elif request == R.SET_OUTPUT_MUTE and len(payload) >= 1:
            if ch < cfg.num_outputs:
                cfg.outputs[ch].mute = payload[0] != 0
        elif request == R.SET_OUTPUT_DELAY and len(payload) >= 4:
            if ch < cfg.num_outputs:
                ms = max(_f(payload), 0.0)
                cfg.outputs[ch].delay_ms = ms
                cfg.channel_delays_ms[C.CH_OUT_1 + ch] = ms
        elif request == R.SET_OUTPUT_PIN and len(payload) >= 1:
            npin = len(cfg.hardware.output_pins)
            pin = payload[0]
            if ch < npin and self._pin_valid(pin):
                cfg.hardware.output_pins[ch] = pin
        elif request == R.SET_OUTPUT_TYPE and len(payload) >= 1:
            nsp = C.NUM_SPDIF_INSTANCES[self.platform]
            if ch < nsp:
                cfg.hardware.output_types[ch] = 1 if payload[0] else 0
        elif request == R.SET_I2S_BCK_PIN and len(payload) >= 1:
            if self._pin_valid(payload[0]):
                cfg.hardware.i2s_bck_pin = payload[0]
        elif request == R.SET_MCK_ENABLE and len(payload) >= 1:
            cfg.hardware.i2s_mck_enabled = payload[0] != 0
            if cfg.hardware.i2s_mck_enabled:
                self._sanitize_mck_multiplier()   # usb_audio.c:3063-3066
        elif request == R.SET_MCK_PIN and len(payload) >= 1:
            if self._pin_valid(payload[0]):
                cfg.hardware.i2s_mck_pin = payload[0]
        elif request == R.SET_MCK_MULTIPLIER and len(payload) >= 1:
            mult = 256 if payload[0] == 1 else 128
            # 256x is refused at >=96 kHz (usb_audio.c:3115-3126)
            if not (mult == 256 and cfg.sample_rate >= 96000):
                cfg.hardware.i2s_mck_multiplier = mult
        elif request == R.SET_LEVELLER_ENABLE and len(payload) >= 1:
            cfg.leveller.enabled = payload[0] != 0
        elif request == R.SET_LEVELLER_AMOUNT and len(payload) >= 4:
            cfg.leveller.amount = float(np.clip(_f(payload), 0.0, 100.0))
        elif request == R.SET_LEVELLER_SPEED and len(payload) >= 1:
            cfg.leveller.speed = min(payload[0], 2)
        elif request == R.SET_LEVELLER_MAX_GAIN and len(payload) >= 4:
            cfg.leveller.max_gain_db = float(np.clip(_f(payload), 0.0, 35.0))
        elif request == R.SET_LEVELLER_LOOKAHEAD and len(payload) >= 1:
            cfg.leveller.lookahead = payload[0] != 0
        elif request == R.SET_LEVELLER_GATE and len(payload) >= 4:
            cfg.leveller.gate_threshold_db = float(np.clip(_f(payload),
                                                           -96.0, 0.0))
        elif request == R.SET_CHANNEL_NAME:
            if ch < cfg.num_channels:
                nm = payload.split(b"\x00")[0][:C.PRESET_NAME_LEN - 1]
                cfg.channel_names[ch] = nm.decode("ascii", "replace")
        elif request == R.PRESET_SAVE:
            self.mute_env.engage(int(cfg.sample_rate))
            self.store.save(ch, cfg)
        elif request == R.PRESET_LOAD:
            self.mute_env.engage(int(cfg.sample_rate))
            self.store.load(ch, cfg)
            self._preset_loaded = True
        elif request == R.PRESET_DELETE:
            self.mute_env.engage(int(cfg.sample_rate))
            self.store.delete(ch, cfg)
            self._preset_loaded = True
        elif request == R.PRESET_SET_NAME:
            nm = payload.split(b"\x00")[0].decode("ascii", "replace")
            self.store.set_name(ch, nm)
        elif request == R.PRESET_SET_STARTUP and len(payload) >= 2:
            self.store.set_startup(payload[0], payload[1])
        elif request == R.PRESET_SET_INCLUDE_PINS and len(payload) >= 1:
            self.store.set_include_pins(payload[0] != 0)
        elif request == R.SET_ALL_PARAMS:
            wire.apply_bulk(cfg, payload, apply_pins=False)
        elif request == R.SAVE_PARAMS:
            self.mute_env.engage(int(cfg.sample_rate))
            self.store.save(self.store.get_active(), cfg)
        elif request == R.LOAD_PARAMS:
            self.mute_env.engage(int(cfg.sample_rate))
            self.store.load(self.store.get_active(), cfg)
            self._preset_loaded = True
        elif request == R.FACTORY_RESET:
            self.mute_env.engage(int(cfg.sample_rate))
            self.store.factory_defaults(cfg)
            self._preset_loaded = True
        elif request == R.CLEAR_CLIPS:
            self.clip_flags = 0
            self.dirty = False
        elif request == R.RESET_BUFFER_STATS:
            # wValue bit 0 resets the fill watermarks (usb_audio.c:2906-2914)
            if wvalue & 0x01 and self.runner is not None:
                self.runner.stats.reset_watermarks()
            self.dirty = False
        elif request == R.RESET_USB_ERROR_STATS:
            for k in self.usb_errors:
                self.usb_errors[k] = 0
            if self.runner is not None:
                self.runner.stats.reset_usb_errors()
            self.dirty = False
        elif request == R.ENTER_BOOTLOADER:
            self.bootloader_requested = True
            self.dirty = False
        else:
            self.dirty = False

    def set_sample_rate(self, freq_hz: int) -> None:
        """UAC SET_CUR on the streaming endpoint's sampling-frequency
        control — the one control that reaches the device outside the
        vendor protocol (usb_audio.c:1491-1498) — followed by the main
        loop's perform_rate_change (main.c:132-171):

          * the 3-byte UAC frequency field is masked to 24 bits and any
            rate outside {44100, 48000, 96000} falls back to 44100;
          * every coefficient set recomputes at the new Fs (filters,
            loudness table, crossfeed, leveller alphas, delay samples) —
            Engine.update_config does all of that on commit();
          * packet geometry follows the rate (chain.packet_geometry), so
            the engine recompiles structurally and callers re-frame
            segments — the analog of the PIO divider/format update;
          * an enabled MCK generator at 256x is forced to 128x at 96 kHz
            (sanitize_mck_multiplier_for_rate, main.c:123-130) — note the
            firmware mutates the persistent multiplier itself.

        Filter/delay-line state persists across the change, as in the
        firmware (perform_rate_change resets sync + feedback, not DSP
        state)."""
        freq = int(freq_hz) & 0x00FFFFFF            # usb_audio.c:1493
        if freq not in (44100, 48000, 96000):
            freq = 44100                            # main.c:133
        if freq == int(self.cfg.sample_rate):
            return                                  # usb_audio.c:1494
        self.cfg.sample_rate = float(freq)
        if self.cfg.hardware.i2s_mck_enabled:
            self._sanitize_mck_multiplier()         # main.c:166-170
        self.dirty = True

    def set_bit_depth(self, bit_depth: int) -> None:
        """UAC SET_INTERFACE on the streaming interface — the host
        selecting alt1 (16-bit) / alt2 (24-bit) of AS interface 1
        (usb_descriptors.c:64-235).  The firmware switches the per-packet
        unpack format live off the current alt setting
        (usb_audio.c:591-686 float / :997-1006 Q28 ``(v<<8)>>2``); here
        the unpack is compiled into the chain, so the switch marks the
        device dirty and ``commit`` rebuilds the engine with the new
        ``bit_depth`` — geometry and all DSP state carry across, exactly
        like the sample-rate flow above.  Unknown alt widths are ignored
        (the firmware's SET_INTERFACE handler only knows alts 0-2)."""
        if bit_depth not in (16, 24) or bit_depth == self.bit_depth:
            return
        self.bit_depth = int(bit_depth)
        self.dirty = True

    def _sanitize_mck_multiplier(self) -> None:
        """sanitize_mck_multiplier_for_rate (main.c:123-130)."""
        if (self.cfg.sample_rate >= 96000
                and self.cfg.hardware.i2s_mck_multiplier == 256):
            self.cfg.hardware.i2s_mck_multiplier = 128

    def _pin_valid(self, pin: int) -> bool:
        """Pin validation (apply_slot_to_live, flash_storage.c:672-678)."""
        ok = pin <= 29 and pin != 12 and not (23 <= pin <= 25)
        if self.platform is Platform.RP2040 and pin > 28:
            ok = False
        return ok

    # ------------------------------------------------------------------
    # GET (control-IN) dispatch (usb_audio.c:2241-3143)
    # ------------------------------------------------------------------

    def get(self, request: int, wvalue: int = 0) -> bytes | None:
        cfg = self.cfg
        ch = wvalue & 0xFF
        nch = cfg.num_channels

        if request == R.GET_EQ_PARAM:
            pch, band = wvalue & 0xFF, (wvalue >> 8) & 0xFF
            if pch < nch and band < C.MAX_BANDS:
                b = cfg.eq[pch][band]
                return struct.pack("<BBBBfff", pch, band, int(b.type), 0,
                                   float(F(b.freq)), float(F(b.q)),
                                   float(F(b.gain_db)))
            return None
        if request == R.GET_PREAMP:
            return _pf(cfg.preamp_db[0])
        if request == R.GET_PREAMP_CH:
            return _pf(cfg.preamp_db[ch]) if ch < 2 else None
        if request == R.GET_MASTER_VOLUME:
            return _pf(cfg.master_volume_db)
        if request == R.GET_MASTER_VOLUME_MODE:
            self.store._dir_ensure()
            return bytes([self.store.dir.master_volume_mode])
        if request == R.GET_SAVED_MASTER_VOLUME:
            return _pf(self.store.get_saved_master_volume())
        if request == R.GET_DELAY:
            return _pf(cfg.channel_delays_ms[ch]) if ch < nch else None
        if request == R.GET_BYPASS:
            return bytes([1 if cfg.bypass_master_eq else 0])
        if request == R.GET_CHANNEL_GAIN:
            return _pf(cfg.channel_gain_db[ch]) if ch < 3 else None
        if request == R.GET_CHANNEL_MUTE:
            return bytes([1 if cfg.channel_mute[ch] else 0]) if ch < 3 else None
        if request == R.GET_LOUDNESS:
            return bytes([1 if cfg.loudness.enabled else 0])
        if request == R.GET_LOUDNESS_REF:
            return _pf(cfg.loudness.ref_spl)
        if request == R.GET_LOUDNESS_INTENSITY:
            return _pf(cfg.loudness.intensity_pct)
        if request == R.GET_CROSSFEED:
            return bytes([1 if cfg.crossfeed.enabled else 0])
        if request == R.GET_CROSSFEED_PRESET:
            return bytes([cfg.crossfeed.preset])
        if request == R.GET_CROSSFEED_FREQ:
            return _pf(cfg.crossfeed.custom_fc)
        if request == R.GET_CROSSFEED_FEED:
            return _pf(cfg.crossfeed.custom_feed_db)
        if request == R.GET_CROSSFEED_ITD:
            return bytes([1 if cfg.crossfeed.itd_enabled else 0])
        if request == R.GET_MATRIX_ROUTE:
            inp, out = wvalue & 0xFF, (wvalue >> 8) & 0xFF
            if inp < 2 and out < cfg.num_outputs:
                xp = cfg.crosspoints[inp][out]
                return struct.pack("<BBBBf", inp, out, 1 if xp.enabled else 0,
                                   1 if xp.phase_invert else 0,
                                   float(F(xp.gain_db)))
            return None
        if request == R.GET_OUTPUT_ENABLE:
            if ch < cfg.num_outputs:
                return bytes([1 if cfg.outputs[ch].enabled else 0])
            return None
        if request == R.GET_OUTPUT_GAIN:
            return _pf(cfg.outputs[ch].gain_db) if ch < cfg.num_outputs else None
        if request == R.GET_OUTPUT_MUTE:
            if ch < cfg.num_outputs:
                return bytes([1 if cfg.outputs[ch].mute else 0])
            return None
        if request == R.GET_OUTPUT_DELAY:
            return _pf(cfg.outputs[ch].delay_ms) if ch < cfg.num_outputs else None
        if request == R.GET_OUTPUT_PIN:
            pins = cfg.hardware.output_pins
            return bytes([pins[ch]]) if ch < len(pins) else None
        if request == R.GET_OUTPUT_TYPE:
            nsp = C.NUM_SPDIF_INSTANCES[self.platform]
            return bytes([cfg.hardware.output_types[ch]]) if ch < nsp else None
        if request == R.GET_I2S_BCK_PIN:
            return bytes([cfg.hardware.i2s_bck_pin])
        if request == R.GET_MCK_ENABLE:
            return bytes([1 if cfg.hardware.i2s_mck_enabled else 0])
        if request == R.GET_MCK_PIN:
            return bytes([cfg.hardware.i2s_mck_pin])
        if request == R.GET_MCK_MULTIPLIER:
            return bytes([1 if cfg.hardware.i2s_mck_multiplier == 256 else 0])
        if request == R.GET_CORE1_MODE:
            return bytes([self.derive_core1_mode()])
        if request == R.GET_CORE1_CONFLICT:
            out = ch
            en = (wvalue >> 8) & 0xFF
            return bytes([1 if self._core1_conflict(out, en != 0) else 0])
        if request == R.GET_LEVELLER_ENABLE:
            return bytes([1 if cfg.leveller.enabled else 0])
        if request == R.GET_LEVELLER_AMOUNT:
            return _pf(cfg.leveller.amount)
        if request == R.GET_LEVELLER_SPEED:
            return bytes([cfg.leveller.speed])
        if request == R.GET_LEVELLER_MAX_GAIN:
            return _pf(cfg.leveller.max_gain_db)
        if request == R.GET_LEVELLER_LOOKAHEAD:
            return bytes([1 if cfg.leveller.lookahead else 0])
        if request == R.GET_LEVELLER_GATE:
            return _pf(cfg.leveller.gate_threshold_db)
        if request == R.GET_CHANNEL_NAME:
            if ch < nch:
                nm = cfg.channel_names[ch].encode()[:C.PRESET_NAME_LEN - 1]
                return nm + b"\x00" * (C.PRESET_NAME_LEN - len(nm))
            return None
        if request == R.PRESET_GET_NAME:
            if ch < C.PRESET_SLOTS:
                nm = self.store.get_name(ch).encode()[:C.PRESET_NAME_LEN - 1]
                return nm + b"\x00" * (C.PRESET_NAME_LEN - len(nm))
            return None
        if request == R.PRESET_GET_DIR:
            self.store._dir_ensure()
            d = self.store.dir
            return struct.pack("<HBBBBB", d.slot_occupied, d.startup_mode,
                               d.default_slot, d.last_active_slot,
                               d.include_pins, d.master_volume_mode)
        if request == R.PRESET_GET_STARTUP:
            self.store._dir_ensure()
            return bytes([self.store.dir.startup_mode,
                          self.store.dir.default_slot])
        if request == R.PRESET_GET_INCLUDE_PINS:
            self.store._dir_ensure()
            return bytes([self.store.dir.include_pins])
        if request == R.PRESET_GET_ACTIVE:
            return bytes([self.store.get_active()])
        if request == R.GET_ALL_PARAMS:
            return wire.encode_bulk(cfg)
        if request == R.GET_SERIAL:
            s = self.serial.encode()[:16]
            return s + b"\x00" * (17 - len(s))
        if request == R.GET_PLATFORM:
            nsp = C.NUM_SPDIF_INSTANCES[self.platform]
            return struct.pack("<BHB", C.PLATFORM_IDS[self.platform],
                               self.fw_version_bcd, nsp * 2 + 1)
        if request == R.GET_STATUS:
            return self._get_status(wvalue)
        if request == R.GET_BUFFER_STATS:
            return self._buffer_stats()
        if request == R.GET_USB_ERROR_STATS:
            # UsbErrorStatsPacket (usb_audio.c:2916-2944): control-plane
            # framing errors plus the runner's data-plane counts
            e = dict(self.usb_errors)
            if self.runner is not None:
                for k, v in self.runner.stats.usb_errors.items():
                    e[k] += v
            return struct.pack("<6I", e["total"], e["crc"], e["bitstuff"],
                               e["rx_overflow"], e["rx_timeout"],
                               e["data_seq"])
        return None

    def _get_status(self, wvalue: int) -> bytes:
        """REQ_GET_STATUS selectors (usb_audio.c:2427-2471)."""
        nch = self.cfg.num_channels
        if wvalue == 9:
            out = b"".join(struct.pack("<H", p & 0xFFFF) for p in self.peaks)
            out += bytes([self.cpu_loads[0], self.cpu_loads[1]])
            out += struct.pack("<H", self.clip_flags & 0xFFFF)
            return out
        sel = {
            0: (self.peaks[0] & 0xFFFF) | ((self.peaks[1] & 0xFFFF) << 16),
            1: (self.peaks[2] & 0xFFFF) | ((self.peaks[3] & 0xFFFF) << 16),
            2: ((self.peaks[4] & 0xFFFF) | (self.cpu_loads[0] << 16)
                | (self.cpu_loads[1] << 24)),
            3: self.counters["pdm_ring_overruns"],
            4: self.counters["pdm_ring_underruns"],
            5: self.counters["pdm_dma_overruns"],
            6: self.counters["pdm_dma_underruns"],
            7: self.counters["spdif_overruns"],
            8: self.counters["spdif_underruns"],
            10: self.counters["usb_audio_packets"],
            11: 2, 12: 1,
            13: 307_200_000,            # emulated clk_sys (main.c:603-618)
            14: 1150,                   # core voltage mV
            15: int(self.cfg.sample_rate),
            16: 3500,                   # temperature c°C (emulated)
            # 17-21: S/PDIF DMA starvations, total + per instance
            # (usb_audio.c:2464-2468) — fed by real feed-deadline misses
            # when a StreamRunner is attached
            17: self._starvations(None),
            18: self._starvations(0),
            19: self._starvations(1),
            20: self._starvations(2),
            21: self._starvations(3),
            22: self.counters["ring_overruns"],
        }
        return struct.pack("<I", sel.get(wvalue, 0) & 0xFFFFFFFF)

    def _starvations(self, slot) -> int:
        if self.runner is None:
            return 0
        st = self.runner.stats
        if slot is None:
            return st.starvations_total
        return st.starvations_slot[slot] if slot < len(st.starvations_slot) \
            else 0

    def _buffer_stats(self) -> bytes:
        """BufferStatsPacket (config.h:492-519).  With a StreamRunner
        attached, flags bit 1 (audio streaming) is set and fill/watermarks
        derive from the runner's in-flight segment depth — the batched
        engine's analog of consumer-pool occupancy.  Without one the packet
        reports the explicit no-stream shape: streaming flag clear, all
        rows zero — never plausible-looking fake health."""
        nsp = C.NUM_SPDIF_INSTANCES[self.platform]
        self._stats_seq = (self._stats_seq + 1) & 0xFFFF
        flags = (1 if self.cfg.outputs[-1].enabled else 0) \
            | (0x02 if self.runner is not None else 0)
        out = struct.pack("<BBH", nsp, flags, self._stats_seq)
        if self.runner is not None:
            st = self.runner.stats
            total = max(st.max_inflight, 1)
            prepared = int(round(st.fill_pct * total / 100))
            free = total - prepared
            row = (min(free, 255), min(prepared, 255), 1,
                   min(st.fill_pct, 100), min(st.min_fill_pct, 100),
                   min(st.max_fill_pct, 100), 0, 0)
        else:
            row = (0, 0, 0, 0, 0, 0, 0, 0)
        for i in range(4):
            if i < nsp:
                out += struct.pack("<8B", *row)
            else:
                out += bytes(8)
        out += struct.pack("<8B", row[0], row[1], row[2], row[3],
                           row[4], row[5], 0, 0)
        return out

    # ------------------------------------------------------------------
    # telemetry feed from the engine
    # ------------------------------------------------------------------

    def update_telemetry(self, peaks, clip_flags, stream: int = 0) -> None:
        """Feed engine outputs back into the status surface (stream 0 by
        convention — the vendor protocol models one device)."""
        self.peaks = [int(p) for p in _host(peaks)[..., stream]]
        self.clip_flags |= int(_host(clip_flags)[..., stream])
