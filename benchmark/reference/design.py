"""Coefficient design: DeviceConfig -> derived filter/gain coefficients.

This reproduces the firmware's coefficient math in single-precision float,
operation for operation, so that the Q28 quantized coefficients come out
bit-identical and the float coefficients ulp-identical (modulo libm):

  - RBJ biquads + Cytomic SVF ....... dsp_compute_coefficients (dsp_pipeline.c:61-175)
  - ISO 226 loudness shelves ........ loudness.c:37-217
  - BS2B crossfeed .................. crossfeed_compute_coefficients (crossfeed.c:35-127)
  - Leveller alphas / curve ......... leveller_compute_coefficients (leveller.c:37-89)
  - Gain staging .................... update_preamp / update_master_volume
                                      (usb_audio.c:244-269), matrix powf
                                      conversions (usb_audio.c vendor handlers)
  - Delay samples ................... dsp_update_delay_samples (dsp_pipeline.c:216-239)

All arithmetic is done with np.float32 scalars in firmware order.  The
functions return plain numpy structures; the JAX chain packs them onto the
device, the golden model consumes them directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from .constants import FilterType, Platform
from .types import CrossfeedConfig, DeviceConfig, EqBand, LevellerConfig

F = np.float32
_PI = F(3.1415926535)


def db_to_linear_f32(db: float) -> np.float32:
    """powf(10, db/20) in float32 — the firmware's standard conversion."""
    return np.power(F(10.0), F(db) / F(20.0))


def _f32_to_i32_trunc(x: np.float32) -> np.int32:
    """(int32_t)(float) cast for in-range coefficient quantization."""
    return np.int32(np.trunc(F(x)))


# ----------------------------------------------------------------------------
# EQ biquad / SVF design
# ----------------------------------------------------------------------------


@dataclass
class BiquadDesign:
    """Coefficients for one band — superset of both platforms' Biquad struct."""

    bypass: bool = True
    # float path (RP2350)
    use_svf: bool = False
    svf_type: FilterType = FilterType.FLAT
    sva1: np.float32 = F(0)
    sva2: np.float32 = F(0)
    sva3: np.float32 = F(0)
    svm0: np.float32 = F(0)
    svm1: np.float32 = F(0)
    svm2: np.float32 = F(0)
    b0: np.float32 = F(1)
    b1: np.float32 = F(0)
    b2: np.float32 = F(0)
    a1: np.float32 = F(0)
    a2: np.float32 = F(0)
    # Q28 path (RP2040)
    qb0: np.int32 = np.int32(C.Q28_ONE)
    qb1: np.int32 = np.int32(0)
    qb2: np.int32 = np.int32(0)
    qa1: np.int32 = np.int32(0)
    qa2: np.int32 = np.int32(0)


def is_filter_flat(band: EqBand) -> bool:
    """is_filter_flat (dsp_pipeline.c:6-17)."""
    if band.type == FilterType.FLAT:
        return True
    if band.freq <= 0.0:
        return True
    if band.type in (FilterType.PEAKING, FilterType.LOWSHELF, FilterType.HIGHSHELF):
        if abs(band.gain_db) < 0.01:
            return True
    return False


def clamp_band(band: EqBand, sample_rate: float) -> EqBand:
    """The in-place input validation of dsp_compute_coefficients
    (dsp_pipeline.c:78-81).  The firmware mutates the stored recipe, so the
    clamped values are what persists and round-trips over the wire."""
    q = min(max(band.q, C.EQ_Q_MIN), C.EQ_Q_MAX)
    freq = min(max(band.freq, C.EQ_FREQ_MIN), sample_rate * C.EQ_FREQ_MAX_FRACTION)
    return EqBand(band.type, freq, q, band.gain_db)


def compute_biquad(band: EqBand, sample_rate: float, platform: Platform) -> BiquadDesign:
    """dsp_compute_coefficients (dsp_pipeline.c:61-175) for one band."""
    out = BiquadDesign()
    if is_filter_flat(band) or sample_rate == 0:
        return out
    out.bypass = False

    band = clamp_band(band, sample_rate)
    fs = F(sample_rate)
    freq = F(band.freq)
    q = F(band.q)
    A = np.power(F(10.0), F(band.gain_db) / F(40.0))

    if platform is Platform.RP2350:
        out.use_svf = bool(band.freq < (sample_rate / C.SVF_CROSSOVER_DIVISOR))
        if out.use_svf:
            # Cytomic "SvfLinearTrapAllOutputs" (dsp_pipeline.c:94-137)
            g = np.tan(_PI * freq / fs)
            k = F(1.0) / q
            if band.type == FilterType.PEAKING:
                k = F(1.0) / (q * A)
            elif band.type == FilterType.LOWSHELF:
                g = g / np.sqrt(A)
            elif band.type == FilterType.HIGHSHELF:
                g = g * np.sqrt(A)

            sva1 = F(1.0) / (F(1.0) + g * (g + k))
            out.sva1 = sva1
            out.sva2 = g * sva1
            out.sva3 = g * out.sva2
            out.svf_type = band.type
            if band.type == FilterType.LOWPASS:
                out.svm0, out.svm1, out.svm2 = F(0.0), F(0.0), F(1.0)
            elif band.type == FilterType.HIGHPASS:
                out.svm0, out.svm1, out.svm2 = F(1.0), -k, F(-1.0)
            elif band.type == FilterType.PEAKING:
                out.svm0, out.svm1, out.svm2 = F(1.0), k * (A * A - F(1.0)), F(0.0)
            elif band.type == FilterType.LOWSHELF:
                out.svm0 = F(1.0)
                out.svm1 = k * (A - F(1.0))
                out.svm2 = A * A - F(1.0)
            elif band.type == FilterType.HIGHSHELF:
                out.svm0 = A * A
                out.svm1 = k * (F(1.0) - A) * A
                out.svm2 = F(1.0) - A * A
            out.b0 = F(1.0)
            return out

    # RBJ Audio-EQ-Cookbook biquad (dsp_pipeline.c:145-156)
    omega = F(2.0) * _PI * freq / fs
    sn = np.sin(omega)
    cs = np.cos(omega)
    alpha = sn / (F(2.0) * q)
    one = F(1.0)
    a0f, a1f, a2f = one, F(0.0), F(0.0)
    b0f, b1f, b2f = one, F(0.0), F(0.0)
    t = band.type
    if t == FilterType.LOWPASS:
        b0f = (one - cs) / F(2)
        b1f = one - cs
        b2f = (one - cs) / F(2)
        a0f = one + alpha
        a1f = F(-2) * cs
        a2f = one - alpha
    elif t == FilterType.HIGHPASS:
        b0f = (one + cs) / F(2)
        b1f = -(one + cs)
        b2f = (one + cs) / F(2)
        a0f = one + alpha
        a1f = F(-2) * cs
        a2f = one - alpha
    elif t == FilterType.PEAKING:
        b0f = one + alpha * A
        b1f = F(-2) * cs
        b2f = one - alpha * A
        a0f = one + alpha / A
        a1f = F(-2) * cs
        a2f = one - alpha / A
    elif t == FilterType.LOWSHELF:
        sqA = np.sqrt(A)
        b0f = A * ((A + one) - (A - one) * cs + F(2) * sqA * alpha)
        b1f = F(2) * A * ((A - one) - (A + one) * cs)
        b2f = A * ((A + one) - (A - one) * cs - F(2) * sqA * alpha)
        a0f = (A + one) + (A - one) * cs + F(2) * sqA * alpha
        a1f = F(-2) * ((A - one) + (A + one) * cs)
        a2f = (A + one) + (A - one) * cs - F(2) * sqA * alpha
    elif t == FilterType.HIGHSHELF:
        sqA = np.sqrt(A)
        b0f = A * ((A + one) + (A - one) * cs + F(2) * sqA * alpha)
        b1f = F(-2) * A * ((A - one) + (A + one) * cs)
        b2f = A * ((A + one) + (A - one) * cs - F(2) * sqA * alpha)
        a0f = (A + one) - (A - one) * cs + F(2) * sqA * alpha
        a1f = F(2) * ((A - one) - (A + one) * cs)
        a2f = (A + one) - (A - one) * cs - F(2) * sqA * alpha

    if platform is Platform.RP2350:
        inv_a0 = F(1.0) / a0f
        out.b0 = b0f * inv_a0
        out.b1 = b1f * inv_a0
        out.b2 = b2f * inv_a0
        out.a1 = a1f * inv_a0
        out.a2 = a2f * inv_a0
    else:
        # Q28 quantization (dsp_pipeline.c:166-174): note the DIVISION (not
        # multiply by reciprocal) before scaling, matching firmware exactly.
        scale = F(1 << C.FILTER_SHIFT)
        out.qb0 = _f32_to_i32_trunc((b0f / a0f) * scale)
        out.qb1 = _f32_to_i32_trunc((b1f / a0f) * scale)
        out.qb2 = _f32_to_i32_trunc((b2f / a0f) * scale)
        out.qa1 = _f32_to_i32_trunc((a1f / a0f) * scale)
        out.qa2 = _f32_to_i32_trunc((a2f / a0f) * scale)
    return out


def channel_biquads(
    bands: list[EqBand], count: int, sample_rate: float, platform: Platform
) -> tuple[list[BiquadDesign], bool]:
    """dsp_recalculate_all_filters inner loop (dsp_pipeline.c:241-253).

    Returns the per-band designs for the first ``count`` bands plus the
    channel_bypassed flag (all bands bypassed).
    """
    designs = [compute_biquad(b, sample_rate, platform) for b in bands[:count]]
    all_bypassed = all(d.bypass for d in designs)
    return designs, all_bypassed


# ----------------------------------------------------------------------------
# ISO 226 loudness table
# ----------------------------------------------------------------------------


def iso226_spl(tf: float, af: float, lu: float, phon: float) -> np.float32:
    """ISO 226:2003 SPL at one frequency (loudness.c:37-50), float32."""
    tf, af, lu, phon = F(tf), F(af), F(lu), F(phon)
    b = F(0.4) * np.power(F(10.0), (tf + lu) / F(10.0) - F(9.0))
    threshold = np.power(b, af)
    a = F(4.47e-3) * (np.power(F(10.0), F(0.025) * phon) - F(1.15)) + threshold
    a = max(a, F(1e-10))
    return (F(10.0) / af) * np.log10(a) - lu + F(94.0)


def loudness_compensation_db(
    tf: float, af: float, lu: float, ref_spl: float, effective_phon: float,
    intensity_pct: float,
) -> np.float32:
    """loudness_compensation_db (loudness.c:54-78)."""
    ref_spl, effective_phon = F(ref_spl), F(effective_phon)
    if effective_phon >= ref_spl:
        return F(0.0)
    spl_ref = iso226_spl(tf, af, lu, ref_spl)
    spl_eff = iso226_spl(tf, af, lu, effective_phon)
    flat_change = effective_phon - ref_spl
    freq_change = spl_eff - spl_ref
    compensation = freq_change - flat_change
    return compensation * (F(intensity_pct) / F(100.0))


@dataclass
class ShelfDesign:
    """One loudness shelf — SVF coeffs (float path) or Q28 biquad (Q28 path)."""

    bypass: bool = True
    sva1: np.float32 = F(0)
    sva2: np.float32 = F(0)
    sva3: np.float32 = F(0)
    svm0: np.float32 = F(0)
    svm1: np.float32 = F(0)
    svm2: np.float32 = F(0)
    qb0: np.int32 = np.int32(C.Q28_ONE)
    qb1: np.int32 = np.int32(0)
    qb2: np.int32 = np.int32(0)
    qa1: np.int32 = np.int32(0)
    qa2: np.int32 = np.int32(0)


def compute_shelf(
    freq: float, q: float, gain_db: float, is_high_shelf: bool,
    sample_rate: float, platform: Platform,
) -> ShelfDesign:
    """compute_shelf_coeffs (loudness.c:85-163)."""
    out = ShelfDesign()
    if abs(F(gain_db)) < F(0.01):
        return out
    out.bypass = False
    fs = F(sample_rate)
    A = np.power(F(10.0), F(gain_db) / F(40.0))

    if platform is Platform.RP2350:
        g = np.tan(_PI * F(freq) / fs)
        sqA = np.sqrt(A)
        g = g * sqA if is_high_shelf else g / sqA
        k = F(1.0) / F(q)
        out.sva1 = F(1.0) / (F(1.0) + g * (g + k))
        out.sva2 = g * out.sva1
        out.sva3 = g * out.sva2
        if is_high_shelf:
            out.svm0 = A * A
            out.svm1 = k * (F(1.0) - A) * A
            out.svm2 = F(1.0) - A * A
        else:
            out.svm0 = F(1.0)
            out.svm1 = k * (A - F(1.0))
            out.svm2 = A * A - F(1.0)
        return out

    omega = F(2.0) * _PI * F(freq) / fs
    sn, cs = np.sin(omega), np.cos(omega)
    alpha = sn / (F(2.0) * F(q))
    sqA = np.sqrt(A)
    one = F(1.0)
    if is_high_shelf:
        b0f = A * ((A + one) + (A - one) * cs + F(2) * sqA * alpha)
        b1f = F(-2) * A * ((A - one) + (A + one) * cs)
        b2f = A * ((A + one) + (A - one) * cs - F(2) * sqA * alpha)
        a0f = (A + one) - (A - one) * cs + F(2) * sqA * alpha
        a1f = F(2) * ((A - one) - (A + one) * cs)
        a2f = (A + one) - (A - one) * cs - F(2) * sqA * alpha
    else:
        b0f = A * ((A + one) - (A - one) * cs + F(2) * sqA * alpha)
        b1f = F(2) * A * ((A - one) - (A + one) * cs)
        b2f = A * ((A + one) - (A - one) * cs - F(2) * sqA * alpha)
        a0f = (A + one) + (A - one) * cs + F(2) * sqA * alpha
        a1f = F(-2) * ((A - one) + (A + one) * cs)
        a2f = (A + one) + (A - one) * cs - F(2) * sqA * alpha
    scale = F(1 << C.FILTER_SHIFT)
    out.qb0 = _f32_to_i32_trunc((b0f / a0f) * scale)
    out.qb1 = _f32_to_i32_trunc((b1f / a0f) * scale)
    out.qb2 = _f32_to_i32_trunc((b2f / a0f) * scale)
    out.qa1 = _f32_to_i32_trunc((a1f / a0f) * scale)
    out.qa2 = _f32_to_i32_trunc((a2f / a0f) * scale)
    return out


def loudness_table(
    ref_spl: float, intensity_pct: float, sample_rate: float, platform: Platform
) -> list[list[ShelfDesign]]:
    """loudness_recompute_table (loudness.c:169-217): 61 steps x 2 shelves."""
    if sample_rate < 1.0:
        sample_rate = 48000.0
    ref_spl = min(max(ref_spl, C.LOUDNESS_REF_MIN), C.LOUDNESS_REF_MAX)
    table = []
    for vol_idx in range(C.LOUDNESS_VOL_STEPS):
        vol_db = float(vol_idx - 60)
        effective = ref_spl + vol_db
        effective = min(max(effective, 20.0), ref_spl)
        low_gain = loudness_compensation_db(
            *C.ISO226_50HZ, ref_spl, effective, intensity_pct)
        high_gain = loudness_compensation_db(
            *C.ISO226_10KHZ, ref_spl, effective, intensity_pct)
        low = compute_shelf(C.LOUDNESS_SHELF_FREQS[0], C.LOUDNESS_SHELF_Q,
                            low_gain, False, sample_rate, platform)
        high = compute_shelf(C.LOUDNESS_SHELF_FREQS[1], C.LOUDNESS_SHELF_Q,
                             high_gain, True, sample_rate, platform)
        table.append([low, high])
    return table


# ----------------------------------------------------------------------------
# BS2B crossfeed
# ----------------------------------------------------------------------------


@dataclass
class CrossfeedDesign:
    enabled: bool = False
    lp_a0: np.float32 = F(0)
    lp_b1: np.float32 = F(0)
    ap_a: np.float32 = F(0)
    q_lp_a0: np.int32 = np.int32(0)
    q_lp_b1: np.int32 = np.int32(0)
    q_ap_a: np.int32 = np.int32(0)


def crossfeed_coefficients(
    cfg: CrossfeedConfig, sample_rate: float, platform: Platform
) -> CrossfeedDesign:
    """crossfeed_compute_coefficients (crossfeed.c:35-127)."""
    out = CrossfeedDesign()
    if not cfg.enabled or sample_rate < 1.0:
        return out
    out.enabled = True

    if cfg.preset < 3:
        fc, feed_db = C.CROSSFEED_PRESETS[cfg.preset]
    else:
        fc = min(max(cfg.custom_fc, C.CROSSFEED_FREQ_MIN), C.CROSSFEED_FREQ_MAX)
        feed_db = min(max(cfg.custom_feed_db, C.CROSSFEED_FEED_MIN), C.CROSSFEED_FEED_MAX)

    level_ratio = np.power(F(10.0), F(feed_db) / F(20.0))
    G = F(1.0) / (F(1.0) + level_ratio)
    x = np.exp(F(-2.0) * _PI * F(fc) / F(sample_rate))
    lp_a0 = G * (F(1.0) - x)
    lp_b1 = x

    if cfg.itd_enabled:
        lp_delay_sec = x / ((F(1.0) - x) * F(sample_rate))
        remaining = F(C.CROSSFEED_ITD_SEC) - lp_delay_sec
        if remaining > 0.0:
            d = remaining * F(sample_rate)
            ap_a = (F(1.0) - d) / (F(1.0) + d)
        else:
            ap_a = F(1.0)
    else:
        ap_a = F(1.0)

    if platform is Platform.RP2350:
        out.lp_a0, out.lp_b1, out.ap_a = lp_a0, lp_b1, ap_a
    else:
        scale = F(1 << 28)
        out.q_lp_a0 = _f32_to_i32_trunc(lp_a0 * scale)
        out.q_lp_b1 = _f32_to_i32_trunc(lp_b1 * scale)
        out.q_ap_a = _f32_to_i32_trunc(ap_a * scale)
    return out


# ----------------------------------------------------------------------------
# Leveller
# ----------------------------------------------------------------------------


@dataclass
class LevellerDesign:
    alpha_rms: np.float32 = F(0)
    alpha_attack: np.float32 = F(0)
    alpha_release: np.float32 = F(0)
    threshold_db: np.float32 = F(C.LEVELLER_THRESHOLD_DB)
    knee_width_db: np.float32 = F(C.LEVELLER_KNEE_WIDTH_DB)
    gate_threshold_db: np.float32 = F(-96.0)
    ratio: np.float32 = F(1.0)
    max_gain_db: np.float32 = F(15.0)
    makeup_db: np.float32 = F(0.0)


def _compute_alpha(sample_rate: float, time_sec: float) -> np.float32:
    """compute_alpha (leveller.c:37-40): exp(-ln10 / (Fs*T)) in float32."""
    if time_sec <= 0.0 or sample_rate <= 0.0:
        return F(0.0)
    return np.exp(-np.log(F(10.0)) / (F(sample_rate) * F(time_sec)))


def leveller_coefficients(cfg: LevellerConfig, sample_rate: float) -> LevellerDesign:
    """leveller_compute_coefficients (leveller.c:42-89)."""
    if sample_rate < 1.0:
        sample_rate = 48000.0
    spd = cfg.speed if cfg.speed < len(C.LEVELLER_SPEED_PRESETS) else C.LEVELLER_SPEED_MEDIUM
    attack_sec, release_sec, rms_sec = C.LEVELLER_SPEED_PRESETS[spd]
    out = LevellerDesign()
    out.alpha_rms = _compute_alpha(sample_rate, rms_sec)
    out.alpha_attack = _compute_alpha(sample_rate, attack_sec)
    out.alpha_release = _compute_alpha(sample_rate, release_sec)
    out.gate_threshold_db = F(min(max(cfg.gate_threshold_db, C.LEVELLER_GATE_MIN),
                                  C.LEVELLER_GATE_MAX))
    amount = min(max(cfg.amount, C.LEVELLER_AMOUNT_MIN), C.LEVELLER_AMOUNT_MAX)
    out.ratio = F(1.0) + (F(amount) / F(100.0)) * F(19.0)
    out.max_gain_db = F(min(max(cfg.max_gain_db, C.LEVELLER_MAX_GAIN_MIN),
                            C.LEVELLER_MAX_GAIN_MAX))
    out.makeup_db = F(0.0)
    return out


# ----------------------------------------------------------------------------
# Gain staging / volume / matrix / delays
# ----------------------------------------------------------------------------


@dataclass
class GainDesign:
    """All precomputed scalar gains for one device config."""

    preamp_linear: np.ndarray = None        # f32 [2]
    preamp_q28: np.ndarray = None           # i32 [2]
    master_volume_linear: np.float32 = F(0)
    master_volume_q15: np.int32 = np.int32(0)
    host_vol_mul: np.int32 = np.int32(0x8000)   # Q15 from DB_TO_VOL
    # matrix crosspoints, signed (phase fold), zero when disabled
    matrix_gain: np.ndarray = None          # f32 [2, nout]
    matrix_gain_q15: np.ndarray = None      # i32 [2, nout]
    # per-output
    output_enabled: np.ndarray = None       # bool [nout]
    output_mute: np.ndarray = None          # bool [nout]
    output_gain_linear: np.ndarray = None   # f32 [nout]
    delay_samples: np.ndarray = None        # i32 [nout]
    any_delay_active: bool = False


def gain_design(cfg: DeviceConfig) -> GainDesign:
    out = GainDesign()
    nout = cfg.num_outputs

    # update_preamp (usb_audio.c:244-250); preset/bulk apply paths pass
    # explicit linear overrides with their own db->linear conversions
    if cfg.preamp_linear is not None:
        lin = np.array(cfg.preamp_linear, dtype=np.float32)
    else:
        lin = np.array([db_to_linear_f32(db) for db in cfg.preamp_db],
                       dtype=np.float32)
    out.preamp_linear = lin
    out.preamp_q28 = np.array(
        [_f32_to_i32_trunc(v * F(1 << 28)) for v in lin], dtype=np.int32)

    # update_master_volume (usb_audio.c:255-269)
    db = min(max(cfg.master_volume_db, C.MASTER_VOL_MUTE_DB), C.MASTER_VOL_MAX_DB)
    if db <= C.MASTER_VOL_MUTE_DB:
        out.master_volume_linear = F(0.0)
        out.master_volume_q15 = np.int32(0)
    else:
        linv = db_to_linear_f32(db)
        out.master_volume_linear = linv
        out.master_volume_q15 = _f32_to_i32_trunc(linv * F(32768.0))

    # audio_set_volume (usb_audio.c:428-440)
    idx = min(max(cfg.host_volume_index, 0), C.CENTER_VOLUME_INDEX)
    out.host_vol_mul = np.int32(C.DB_TO_VOL[idx])

    # matrix crosspoints: signed linear gains, 0 when disabled
    # (usb_audio.c:760-764 float / :1082-1085 Q28)
    mg = np.zeros((2, nout), dtype=np.float32)
    mg_q15 = np.zeros((2, nout), dtype=np.int32)
    for i in range(2):
        for o in range(nout):
            xp = cfg.crosspoints[i][o]
            if xp.enabled:
                g = (F(xp.gain_linear) if xp.gain_linear is not None
                     else db_to_linear_f32(xp.gain_db))
                g = -g if xp.phase_invert else g
                mg[i, o] = g
                mg_q15[i, o] = _f32_to_i32_trunc(g * F(32768.0))
    out.matrix_gain = mg
    out.matrix_gain_q15 = mg_q15

    out.output_enabled = np.array([o.enabled for o in cfg.outputs], dtype=bool)
    out.output_mute = np.array([o.mute for o in cfg.outputs], dtype=bool)
    out.output_gain_linear = np.array(
        [F(o.gain_linear) if o.gain_linear is not None
         else db_to_linear_f32(o.gain_db) for o in cfg.outputs],
        dtype=np.float32)

    # dsp_update_delay_samples (dsp_pipeline.c:216-239) — the delay source
    # is the channel delay table, not the matrix outputs' field
    max_delay = C.MAX_DELAY_SAMPLES[cfg.platform]
    delays = np.zeros(nout, dtype=np.int32)
    fs = F(cfg.sample_rate)
    for o in range(nout):
        delay_ms = F(cfg.channel_delays_ms[C.CH_OUT_1 + o])
        if o == nout - 1:  # PDM sub path-latency compensation
            align_ms = F(C.SUB_ALIGN_SAMPLES) / fs * F(1000.0)
            delay_ms = delay_ms + align_ms
        samples = int(np.trunc(delay_ms * fs / F(1000.0)))
        samples = min(max(samples, 0), max_delay)
        delays[o] = samples
    out.delay_samples = delays
    out.any_delay_active = bool((delays > 0).any())
    return out


# ----------------------------------------------------------------------------
# Full derived-state bundle
# ----------------------------------------------------------------------------


@dataclass
class DerivedParams:
    """Everything the runtime needs, derived from a DeviceConfig."""

    config: DeviceConfig = None
    eq: list = None                    # [channel] -> list[BiquadDesign]
    channel_bypassed: list = None      # [channel] -> bool
    loudness: list = None              # [61][2] ShelfDesign (None if disabled)
    crossfeed: CrossfeedDesign = None
    leveller: LevellerDesign = None
    gains: GainDesign = None


def derive(cfg: DeviceConfig) -> DerivedParams:
    """Compute the full derived coefficient set for a device config.

    Mirrors the main-loop recompute sequence (main.c:649, 688-696):
    dsp_recalculate_all_filters + loudness_recompute_table +
    crossfeed/leveller coefficient updates.
    """
    d = DerivedParams()
    d.config = cfg
    d.eq = []
    d.channel_bypassed = []
    for ch in range(cfg.num_channels):
        designs, bypassed = channel_biquads(
            cfg.eq[ch], cfg.band_counts[ch], cfg.sample_rate, cfg.platform)
        d.eq.append(designs)
        d.channel_bypassed.append(bypassed)
    d.loudness = (loudness_table(cfg.loudness.ref_spl, cfg.loudness.intensity_pct,
                                 cfg.sample_rate, cfg.platform)
                  if cfg.loudness.enabled else None)
    d.crossfeed = crossfeed_coefficients(cfg.crossfeed, cfg.sample_rate, cfg.platform)
    d.leveller = leveller_coefficients(cfg.leveller, cfg.sample_rate)
    d.gains = gain_design(cfg)
    return d
