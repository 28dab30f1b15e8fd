"""User-facing configuration model of the DSP chain.

Mirrors the firmware's control-plane state one-to-one (config.h structs,
usb_audio.c globals) so that presets, bulk transfers and vendor requests
round-trip losslessly.  Everything here is plain Python; the device-side
coefficient arrays are derived in :mod:`dspi_tpu_torch.params.design`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .constants import (
    CENTER_VOLUME_INDEX,
    CH_OUT_1,
    CROSSFEED_PRESET_CUSTOM,
    DEFAULT_BAND_COUNT,
    LEVELLER_DEFAULTS,
    MASTER_VOL_DEFAULT_DB,
    MAX_BANDS,
    NUM_CHANNELS,
    NUM_INPUT_CHANNELS,
    NUM_OUTPUT_CHANNELS,
    FilterType,
    Platform,
)


@dataclass
class EqBand:
    """One PEQ band recipe (EqParamPacket, config.h:445-453)."""

    type: FilterType = FilterType.FLAT
    freq: float = 1000.0
    q: float = 0.707
    gain_db: float = 0.0


@dataclass
class Crosspoint:
    """Matrix mixer crosspoint (MatrixCrosspoint, config.h:383-389).

    ``gain_linear`` mirrors the firmware's precomputed multiplier.  When
    None it is derived as powf(10, db/20); preset/bulk application paths
    set it explicitly to reproduce their distinct db->linear conversions
    (flash_storage.c:296-306 vs bulk_params.c:49-56).
    """

    enabled: bool = False
    phase_invert: bool = False
    gain_db: float = 0.0
    gain_linear: float | None = None


@dataclass
class OutputChannel:
    """Per-output state (OutputChannel, config.h:392-400)."""

    enabled: bool = False
    mute: bool = False
    gain_db: float = 0.0
    delay_ms: float = 0.0
    gain_linear: float | None = None


@dataclass
class CrossfeedConfig:
    """BS2B crossfeed config (crossfeed.h:26-32; defaults usb_audio.c:187-193)."""

    enabled: bool = False
    itd_enabled: bool = True
    preset: int = 0                    # 0..2 presets, 3 = custom
    custom_fc: float = 700.0
    custom_feed_db: float = 4.5


@dataclass
class LevellerConfig:
    """Volume leveller config (leveller.h:59-66, defaults leveller.h:69-74)."""

    enabled: bool = LEVELLER_DEFAULTS["enabled"]
    amount: float = LEVELLER_DEFAULTS["amount"]
    speed: int = LEVELLER_DEFAULTS["speed"]
    max_gain_db: float = LEVELLER_DEFAULTS["max_gain_db"]
    lookahead: bool = LEVELLER_DEFAULTS["lookahead"]
    gate_threshold_db: float = LEVELLER_DEFAULTS["gate_threshold_db"]


@dataclass
class LoudnessConfig:
    """ISO 226 loudness compensation (defaults usb_audio.c:174-176)."""

    enabled: bool = False
    ref_spl: float = 83.0
    intensity_pct: float = 100.0


def _default_channel_eq(platform: Platform) -> list[list[EqBand]]:
    """Factory EQ state (dsp_init_default_filters, dsp_pipeline.c:177-214).

    80 Hz highpass on every S/PDIF output channel, 80 Hz lowpass on the PDM
    sub, everything else flat.
    """
    nch = NUM_CHANNELS[platform]
    eq = [[EqBand() for _ in range(MAX_BANDS)] for _ in range(nch)]
    sub_ch = nch - 1
    for ch in range(CH_OUT_1, sub_ch):
        eq[ch][0] = EqBand(FilterType.HIGHPASS, 80.0, 0.707, 0.0)
    eq[sub_ch][0] = EqBand(FilterType.LOWPASS, 80.0, 0.707, 0.0)
    return eq


def _default_crosspoints(platform: Platform) -> list[list[Crosspoint]]:
    """Stereo passthrough L->out0, R->out1 (matrix_init_defaults, usb_audio.c:3251)."""
    nout = NUM_OUTPUT_CHANNELS[platform]
    xp = [[Crosspoint() for _ in range(nout)] for _ in range(NUM_INPUT_CHANNELS)]
    xp[0][0] = Crosspoint(enabled=True, gain_db=0.0)
    xp[1][1] = Crosspoint(enabled=True, gain_db=0.0)
    return xp


def _default_outputs(platform: Platform) -> list[OutputChannel]:
    nout = NUM_OUTPUT_CHANNELS[platform]
    outs = [OutputChannel() for _ in range(nout)]
    outs[0].enabled = True
    outs[1].enabled = True
    return outs


def default_output_pins(platform: Platform) -> list[int]:
    """Factory pin map (apply_factory_defaults, flash_storage.c:1199-1209)."""
    if platform is Platform.RP2350:
        return [6, 7, 8, 9, 10]
    return [6, 7, 10]


@dataclass
class HardwareConfig:
    """Output-hardware control state (pins, S/PDIF vs I2S, MCK).

    On TPU this selects output *encoders* rather than silicon, but the full
    state is carried so presets and the bulk wire format round-trip exactly
    (flash_storage.c PresetSlot V6/V9/V11 fields)."""

    output_pins: list[int] = None          # per pin output (SPDIF..., PDM)
    output_types: list[int] = None         # per SPDIF slot: 0=S/PDIF 1=I2S
    i2s_bck_pin: int = 14
    i2s_mck_pin: int = 13
    i2s_mck_enabled: bool = False
    i2s_mck_multiplier: int = 128          # 128 or 256


@dataclass
class DeviceConfig:
    """Complete control-plane state of one virtual DSPi device."""

    platform: Platform = Platform.RP2350
    sample_rate: float = 48000.0

    # input conditioning (usb_audio.c:244-269)
    preamp_db: list[float] = field(default_factory=lambda: [0.0, 0.0])
    preamp_linear: list[float] = None               # override (see Crosspoint)
    master_volume_db: float = MASTER_VOL_DEFAULT_DB
    host_volume_index: int = CENTER_VOLUME_INDEX   # 0 silent .. 60 = 0 dB
    host_mute: bool = False
    bypass_master_eq: bool = False

    eq: list[list[EqBand]] = None                   # [channel][band]
    band_counts: list[int] = None
    crosspoints: list[list[Crosspoint]] = None      # [input][output]
    outputs: list[OutputChannel] = None
    crossfeed: CrossfeedConfig = field(default_factory=CrossfeedConfig)
    leveller: LevellerConfig = field(default_factory=LevellerConfig)
    loudness: LoudnessConfig = field(default_factory=LoudnessConfig)
    channel_names: list[str] = None

    # per-channel delay table (vendor REQ_SET_DELAY; entries CH_OUT_1+ mirror
    # outputs[].delay_ms per apply_slot_to_live flash_storage.c:660)
    channel_delays_ms: list[float] = None

    # persisted-but-never-applied legacy fields (SURVEY.md §9)
    channel_gain_db: list[float] = field(default_factory=lambda: [0.0] * 3)
    channel_mute: list[bool] = field(default_factory=lambda: [False] * 3)

    hardware: HardwareConfig = None

    def __post_init__(self):
        nch = NUM_CHANNELS[self.platform]
        if self.eq is None:
            self.eq = _default_channel_eq(self.platform)
        if self.band_counts is None:
            self.band_counts = [DEFAULT_BAND_COUNT] * nch
        if self.crosspoints is None:
            self.crosspoints = _default_crosspoints(self.platform)
        if self.outputs is None:
            self.outputs = _default_outputs(self.platform)
        if self.channel_names is None:
            self.channel_names = default_channel_names(self.platform)
        if self.channel_delays_ms is None:
            self.channel_delays_ms = [0.0] * nch
            self.sync_delays()
        if self.hardware is None:
            self.hardware = HardwareConfig()
        if self.hardware.output_pins is None:
            self.hardware.output_pins = default_output_pins(self.platform)
        if self.hardware.output_types is None:
            self.hardware.output_types = [0, 0, 0, 0]

    def sync_delays(self) -> None:
        """Mirror outputs[].delay_ms into the channel delay table — what
        REQ_SET_OUTPUT_DELAY does (usb_audio.c).  Note the reverse is NOT
        done: REQ_SET_DELAY writes only channel_delays_ms, a live firmware
        quirk the vendor layer preserves."""
        for o in range(len(self.outputs)):
            self.channel_delays_ms[CH_OUT_1 + o] = self.outputs[o].delay_ms

    # convenience -----------------------------------------------------------
    @property
    def num_channels(self) -> int:
        return NUM_CHANNELS[self.platform]

    @property
    def num_outputs(self) -> int:
        return NUM_OUTPUT_CHANNELS[self.platform]

    @property
    def sub_channel(self) -> int:
        return self.num_channels - 1

    def copy(self) -> "DeviceConfig":
        return dataclasses.replace(
            self,
            preamp_db=list(self.preamp_db),
            preamp_linear=(None if self.preamp_linear is None
                           else list(self.preamp_linear)),
            eq=[[dataclasses.replace(b) for b in ch] for ch in self.eq],
            band_counts=list(self.band_counts),
            crosspoints=[[dataclasses.replace(x) for x in row] for row in self.crosspoints],
            outputs=[dataclasses.replace(o) for o in self.outputs],
            crossfeed=dataclasses.replace(self.crossfeed),
            leveller=dataclasses.replace(self.leveller),
            loudness=dataclasses.replace(self.loudness),
            channel_names=list(self.channel_names),
            channel_delays_ms=list(self.channel_delays_ms),
            channel_gain_db=list(self.channel_gain_db),
            channel_mute=list(self.channel_mute),
            hardware=dataclasses.replace(
                self.hardware,
                output_pins=list(self.hardware.output_pins),
                output_types=list(self.hardware.output_types)),
        )


def default_channel_names(platform: Platform) -> list[str]:
    """Factory channel names (get_default_channel_name, usb_audio.c:216-235)."""
    if platform is Platform.RP2350:
        return [
            "USB L", "USB R",
            "SPDIF 1 L", "SPDIF 1 R", "SPDIF 2 L", "SPDIF 2 R",
            "SPDIF 3 L", "SPDIF 3 R", "SPDIF 4 L", "SPDIF 4 R",
            "PDM",
        ]
    return [
        "USB L", "USB R",
        "SPDIF 1 L", "SPDIF 1 R", "SPDIF 2 L", "SPDIF 2 R",
        "PDM",
    ]
