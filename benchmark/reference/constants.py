"""Firmware constants, a copy of the JAX package's table for the PyTorch port.

Every value here is cited against the reference firmware (WeebLabs/DSPi).
The port's modules read them from here and hard-code none of them again.

References:
  - firmware/DSPi/config.h          (platform geometry, Q formats, thresholds)
  - firmware/DSPi/leveller.h        (leveller limits / speed presets)
  - firmware/DSPi/crossfeed.h       (BS2B presets, ITD)
  - firmware/DSPi/loudness.c/.h     (ISO 226 constants, shelf geometry)
  - firmware/DSPi/pdm_generator.c   (delta-sigma tuning)
"""

from __future__ import annotations

import enum

# ----------------------------------------------------------------------------
# Fixed-point formats (config.h:56, config.h:53-54)
# ----------------------------------------------------------------------------
FILTER_SHIFT = 28                     # Q28 for the RP2040 math path
Q28_ONE = 1 << FILTER_SHIFT
Q15_ONE = 1 << 15

CLIP_THRESH_F = 1.001                 # float clip detect threshold (config.h:53)
CLIP_THRESH_Q28 = (1 << 28) + 268     # Q28 clip detect threshold (config.h:54)

# ----------------------------------------------------------------------------
# Channel geometry (config.h:307-341)
# ----------------------------------------------------------------------------


class Platform(enum.Enum):
    """The two firmware math paths the rebuild reproduces.

    RP2350 = single-precision float with hybrid SVF/biquad filters.
    RP2040 = Q28 fixed point with exact partial-product multiplies.
    """

    RP2350 = "rp2350"
    RP2040 = "rp2040"


# channels: [master L, master R, out_1 .. out_N, pdm]
NUM_CHANNELS = {Platform.RP2350: 11, Platform.RP2040: 7}
NUM_OUTPUT_CHANNELS = {Platform.RP2350: 9, Platform.RP2040: 5}
NUM_SPDIF_INSTANCES = {Platform.RP2350: 4, Platform.RP2040: 2}
NUM_INPUT_CHANNELS = 2
CH_MASTER_LEFT = 0
CH_MASTER_RIGHT = 1
CH_OUT_1 = 2
MAX_BANDS = 12
DEFAULT_BAND_COUNT = 10               # dsp_pipeline.c:36-44

# ----------------------------------------------------------------------------
# Delay lines (config.h:83-95)
# ----------------------------------------------------------------------------
MAX_DELAY_SAMPLES = {Platform.RP2350: 4096, Platform.RP2040: 2048}
SPDIF_BUFFER_SAMPLES = 384
PDM_BUFFER_SAMPLES = 256
SUB_ALIGN_SAMPLES = SPDIF_BUFFER_SAMPLES - PDM_BUFFER_SAMPLES  # 128

# ----------------------------------------------------------------------------
# Filter types (config.h:440-443)
# ----------------------------------------------------------------------------


class FilterType(enum.IntEnum):
    FLAT = 0
    PEAKING = 1
    LOWSHELF = 2
    HIGHSHELF = 3
    LOWPASS = 4
    HIGHPASS = 5


# SVF-below-this-fraction-of-Fs crossover on the float platform
# (dsp_pipeline.c:88: freq < sample_rate / 7.5)
SVF_CROSSOVER_DIVISOR = 7.5

# coefficient input clamps (dsp_pipeline.c:78-81)
EQ_Q_MIN, EQ_Q_MAX = 0.1, 20.0
EQ_FREQ_MIN = 10.0
EQ_FREQ_MAX_FRACTION = 0.45           # of sample rate

# ----------------------------------------------------------------------------
# Master volume (config.h:236-248)
# ----------------------------------------------------------------------------
MASTER_VOL_MUTE_DB = -128.0
MASTER_VOL_MIN_DB = -127.0
MASTER_VOL_MAX_DB = 0.0
MASTER_VOL_DEFAULT_DB = -20.0
MASTER_VOLUME_MODE_INDEPENDENT = 0
MASTER_VOLUME_MODE_WITH_PRESET = 1

# Host (UAC) volume table: index 0 = silent, 60 = 0 dB, Q15 units
# (usb_audio.c:410-420)
CENTER_VOLUME_INDEX = 60
DB_TO_VOL = (
    0x0000, 0x0025, 0x0029, 0x002E, 0x0034, 0x003A, 0x0041, 0x0049,
    0x0052, 0x005C, 0x0068, 0x0074, 0x0082, 0x0092, 0x00A4, 0x00B8,
    0x00CF, 0x00E8, 0x0104, 0x0124, 0x0148, 0x0170, 0x019D, 0x01CF,
    0x0207, 0x0247, 0x028E, 0x02DE, 0x0337, 0x039C, 0x040C, 0x048B,
    0x0519, 0x05B8, 0x066A, 0x0733, 0x0814, 0x0910, 0x0A2B, 0x0B68,
    0x0CCD, 0x0E5D, 0x101D, 0x1215, 0x1449, 0x16C3, 0x198A, 0x1CA8,
    0x2027, 0x2413, 0x287A, 0x2D6B, 0x32F5, 0x392D, 0x4027, 0x47FB,
    0x50C3, 0x5A9E, 0x65AD, 0x7215, 0x8000,
)

# ----------------------------------------------------------------------------
# Leveller (leveller.h:34-53, leveller.c:23-27)
# ----------------------------------------------------------------------------
LEVELLER_LOOKAHEAD_SAMPLES = 480
LEVELLER_SPEED_SLOW = 0
LEVELLER_SPEED_MEDIUM = 1
LEVELLER_SPEED_FAST = 2
LEVELLER_SPEED_PRESETS = (            # (attack_sec, release_sec, rms_window_sec)
    (0.100, 2.000, 0.400),
    (0.050, 1.000, 0.200),
    (0.020, 0.500, 0.100),
)
LEVELLER_AMOUNT_MIN, LEVELLER_AMOUNT_MAX = 0.0, 100.0
LEVELLER_MAX_GAIN_MIN, LEVELLER_MAX_GAIN_MAX = 0.0, 35.0
LEVELLER_GATE_MIN, LEVELLER_GATE_MAX = -96.0, 0.0
LEVELLER_THRESHOLD_DB = -20.0
LEVELLER_KNEE_WIDTH_DB = 6.0
LEVELLER_LIMITER_CEIL = 0.70795       # -3 dBFS (code wins over stale README)
LEVELLER_DEFAULTS = dict(
    enabled=False, amount=50.0, speed=LEVELLER_SPEED_SLOW,
    max_gain_db=15.0, lookahead=True, gate_threshold_db=-96.0,
)

# ----------------------------------------------------------------------------
# Crossfeed (crossfeed.h:7-23, crossfeed.c:25-29)
# ----------------------------------------------------------------------------
CROSSFEED_PRESETS = (                 # (cutoff_hz, feed_db)
    (700.0, 4.5),                     # default
    (700.0, 6.0),                     # Chu Moy
    (650.0, 9.5),                     # Jan Meier
)
CROSSFEED_PRESET_CUSTOM = 3
CROSSFEED_FREQ_MIN, CROSSFEED_FREQ_MAX = 500.0, 2000.0
CROSSFEED_FEED_MIN, CROSSFEED_FEED_MAX = 0.0, 15.0
CROSSFEED_ITD_SEC = 0.000220

# ----------------------------------------------------------------------------
# Loudness (loudness.h:6-7, loudness.c:18-28,180-182)
# ----------------------------------------------------------------------------
LOUDNESS_BIQUAD_COUNT = 2
LOUDNESS_VOL_STEPS = 61               # -60..0 dB (code wins over stale README)
LOUDNESS_SHELF_FREQS = (200.0, 6000.0)
LOUDNESS_SHELF_Q = 0.707
ISO226_50HZ = (44.0, 0.432, 80.4)     # (Tf, alpha_f, Lu)
ISO226_10KHZ = (13.9, 0.301, 17.8)
LOUDNESS_REF_MIN, LOUDNESS_REF_MAX = 40.0, 100.0

# ----------------------------------------------------------------------------
# PDM delta-sigma modulator (config.h:58-75, pdm_generator.c:62-108)
# ----------------------------------------------------------------------------
PDM_OVERSAMPLE = 256                  # bits per PCM sample
PDM_CHUNKS = PDM_OVERSAMPLE // 32     # 8 x 32-bit words per sample
PDM_CLIP_THRESH = 29500
PDM_DITHER_MASK = 0x1FF
PDM_LEAKAGE_SHIFT = 16
PDM_FADE_IN_SHIFT = 10
PDM_FADE_IN_SAMPLES = 1 << PDM_FADE_IN_SHIFT
PDM_RNG_SEED = 123456789              # xorshift32 seed (pdm_generator.c:62)
# The word-stream stand-in for "PDM hardware stopped": the firmware
# prefills the DMA ring with this 50%-duty idle pattern on every restart
# (pdm_generator.c:240-241) and the PIO stops shifting after a completed
# fade-out; samples processed while stopped emit this word.
PDM_SILENCE_WORD = 0xAAAAAAAA
# Noise shaper: Butterworth HP fc=8kHz @ 384kHz, Q14 (pdm_generator.c:77-81)
PDM_NS_B0 = 15778
PDM_NS_B1 = -31556
PDM_NS_B2 = 15778
PDM_NS_A1 = 31531                     # sign-folded: added in the filter update
PDM_NS_A2 = 15580
PDM_NS_ERR_DECAY_Q8 = 248             # err_acc *= 248/256 (pdm_generator.c:92)

# ----------------------------------------------------------------------------
# Packet / block geometry
# ----------------------------------------------------------------------------
AUDIO_BUFFER_SAMPLES = 192            # producer block (config.h:80)
SPDIF_BLOCK_FRAMES = 192              # IEC 60958 block (audio_spdif.h)
SAMPLE_RATES = (44100, 48000, 96000)

# Preset mute envelope (usb_audio.c:456)
PRESET_MUTE_TRANSITION_MS = 8

# ----------------------------------------------------------------------------
# Presets / persistence (config.h:253-266, flash_storage.c:66-71)
# ----------------------------------------------------------------------------
PRESET_SLOTS = 10
PRESET_NAME_LEN = 32
PRESET_MAGIC_LEGACY = 0x44535031      # "DSP1"
PRESET_MAGIC_DIR = 0x44535032         # "DSP2"
PRESET_MAGIC_SLOT = 0x44535033        # "DSP3"
PRESET_SLOT_VERSION = 12
PRESET_DIR_VERSION = 2
CRC32_POLY = 0xEDB88320
BULK_WIRE_VERSION = 6

PLATFORM_IDS = {Platform.RP2040: 0, Platform.RP2350: 1}

# IEC 60958 framing (audio_spdif.c:77-89)
SPDIF_PREAMBLE_X = 0b11001001
SPDIF_PREAMBLE_Y = 0b01101001
SPDIF_PREAMBLE_Z = 0b00111001
SPDIF_CHANNEL_STATUS = (0x04, 0x00, 0x00, 0x00, 0x0B)  # byte 3 set per rate
