"""Golden model: a sample-sequential software twin of the DSPi firmware.

One ``GoldenDevice`` instance == one firmware device processing one stream,
with exactly the firmware's arithmetic:

  * float path  — RP2350 semantics, np.float32 scalar ops in firmware order
                  (process_audio_packet, usb_audio.c:560-966)
  * Q28 path    — RP2040 semantics, exact wrapping int32 via golden.qref
                  (process_audio_packet, usb_audio.c:968-1283 and
                  dsp_process_rp2040.S)

This module is the test oracle for the batched pipeline, the JAX
package's ``golden/model.py`` on the port's own params, constants and
``core/fmath.py``: the leveller's five deterministic transcendentals
(``det_div``, ``exp10_f32``, ``log10_f32``, ``pow_f32``, ``smooth_det``)
run on 0-d float32 CPU tensors, which give the bits of the JAX package's
NumPy branch.  It runs on the CPU by nature, one stream per instance, and
is written for clarity and exactness, not speed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from . import fmath
from .constants import FilterType, Platform
from .design import DerivedParams, derive
from .types import DeviceConfig
from . import qref

F = np.float32


def _fm(fn, *args):
    """``core.fmath`` function ``fn`` on float32 scalars: 0-d CPU float32
    tensors in, an np.float32 out."""
    return F(fn(*(torch.tensor(F(a)) for a in args)).item())


class GoldenDevice:
    def __init__(self, cfg: DeviceConfig, derived: DerivedParams | None = None,
                 pdm_fade: bool = True, pdm_seed: int = C.PDM_RNG_SEED):
        self.cfg = cfg
        self.d = derived if derived is not None else derive(cfg)
        self.is_float = cfg.platform is Platform.RP2350
        nch, nout = cfg.num_channels, cfg.num_outputs
        nb = C.MAX_BANDS

        if self.is_float:
            z = lambda *s: np.zeros(s, dtype=np.float32)  # noqa: E731
            self.eq_s1 = z(nch, nb)
            self.eq_s2 = z(nch, nb)
            self.eq_ic1 = z(nch, nb)
            self.eq_ic2 = z(nch, nb)
            self.loud_ic1 = z(2, 2)
            self.loud_ic2 = z(2, 2)
            self.xf_lp = z(2)
            self.xf_ap = z(2)
            self.lev_env = z(2)
            self.lev_gain_smooth_db = F(0.0)
            self.lev_gain_linear = F(1.0)
            self.lev_gain_prev_linear = F(1.0)
            self.lev_la_buf = z(2, C.LEVELLER_LOOKAHEAD_SAMPLES)
            self.lev_la_idx = 0
            self.delay_lines = z(nout, C.MAX_DELAY_SAMPLES[cfg.platform])
        else:
            self.eq_s1 = [[0] * nb for _ in range(nch)]
            self.eq_s2 = [[0] * nb for _ in range(nch)]
            self.loud_s1 = [[0, 0], [0, 0]]
            self.loud_s2 = [[0, 0], [0, 0]]
            self.xf_lp = [0, 0]
            self.xf_ap = [0, 0]
            self.lev_env = [0, 0]
            self.lev_gain_smooth_db = F(0.0)
            self.lev_gain_q28 = C.Q28_ONE
            self.lev_gain_prev_q28 = C.Q28_ONE
            self.lev_la_buf = [[0] * C.LEVELLER_LOOKAHEAD_SAMPLES for _ in range(2)]
            self.lev_la_idx = 0
            self.delay_lines = [
                [0] * C.MAX_DELAY_SAMPLES[cfg.platform] for _ in range(nout)]

        self.delay_write_idx = 0
        # PDM modulator state (pdm_processing_loop, pdm_generator.c:204-420)
        self.pdm_err = 0
        self.pdm_err2 = 0
        self.pdm_ns = dict(x1=0, x2=0, y1=0, y2=0, err_acc=0)
        self.pdm_rng = pdm_seed & 0xFFFFFFFF
        self.pdm_fade_pos = 0 if pdm_fade else C.PDM_FADE_IN_SAMPLES
        # enable/fade-out state machine (pdm_generator.c:217-252,323-338)
        self.pdm_ena = True           # pdm_enabled (control-plane flag)
        self.pdm_run = True           # hw_running
        self.pdm_fout_pos = 0         # fade_out_pos
        self.pdm_base = 0             # fade_base_pcm
        # sticky telemetry
        self.peaks = [0] * nch
        self.clip_flags = 0

    # ------------------------------------------------------------------
    # Float-path helpers
    # ------------------------------------------------------------------

    def _eq_block_f32(self, ch: int, buf: np.ndarray, count: int) -> None:
        """dsp_process_channel_block, float (dsp_pipeline.c:282-365)."""
        designs = self.d.eq[ch]
        for band, bq in enumerate(designs):
            if bq.bypass:
                continue
            if bq.use_svf:
                a1, a2, a3 = bq.sva1, bq.sva2, bq.sva3
                m0, m1, m2 = bq.svm0, bq.svm1, bq.svm2
                ic1 = self.eq_ic1[ch, band]
                ic2 = self.eq_ic2[ch, band]
                t = bq.svf_type
                for i in range(count):
                    xin = buf[i]
                    v3 = xin - ic2
                    v1 = a1 * ic1 + a2 * v3
                    v2 = ic2 + a2 * ic1 + a3 * v3
                    ic1 = F(2.0) * v1 - ic1
                    ic2 = F(2.0) * v2 - ic2
                    if t == FilterType.LOWPASS:
                        buf[i] = v2
                    elif t == FilterType.HIGHPASS:
                        buf[i] = xin + m1 * v1 - v2
                    elif t == FilterType.PEAKING:
                        buf[i] = xin + m1 * v1
                    else:  # shelves
                        buf[i] = m0 * xin + m1 * v1 + m2 * v2
                self.eq_ic1[ch, band] = ic1
                self.eq_ic2[ch, band] = ic2
            else:
                b0, b1, b2 = bq.b0, bq.b1, bq.b2
                a1, a2 = bq.a1, bq.a2
                s1 = self.eq_s1[ch, band]
                s2 = self.eq_s2[ch, band]
                for i in range(count):
                    xin = buf[i]
                    out = b0 * xin + s1
                    s1 = b1 * xin - a1 * out + s2
                    s2 = b2 * xin - a2 * out
                    buf[i] = out
                self.eq_s1[ch, band] = s1
                self.eq_s2[ch, band] = s2

    def _loudness_f32(self, bl: np.ndarray, br: np.ndarray, count: int) -> None:
        """Loudness SVF shelves, general mix form (usb_audio.c:689-718)."""
        coeffs = self.d.loudness[self.cfg.host_volume_index]
        for i in range(count):
            for chi, buf in ((0, bl), (1, br)):
                raw = buf[i]
                for j, lc in enumerate(coeffs):
                    if lc.bypass:
                        continue
                    v3 = raw - self.loud_ic2[chi, j]
                    v1 = lc.sva1 * self.loud_ic1[chi, j] + lc.sva2 * v3
                    v2 = (self.loud_ic2[chi, j] + lc.sva2 * self.loud_ic1[chi, j]
                          + lc.sva3 * v3)
                    self.loud_ic1[chi, j] = F(2.0) * v1 - self.loud_ic1[chi, j]
                    self.loud_ic2[chi, j] = F(2.0) * v2 - self.loud_ic2[chi, j]
                    raw = lc.svm0 * raw + lc.svm1 * v1 + lc.svm2 * v2
                buf[i] = raw

    def _leveller_f32(self, bl: np.ndarray, br: np.ndarray, count: int) -> None:
        """leveller_process_block, float (leveller.c:147-262)."""
        if count == 0:
            return
        co = self.d.leveller
        cfg = self.cfg.leveller
        env_l, env_r = self.lev_env[0], self.lev_env[1]
        a = co.alpha_rms
        one_minus = F(1.0) - a
        for i in range(count):
            sl, sr = bl[i], br[i]
            env_l = a * env_l + one_minus * (sl * sl)
            env_r = a * env_r + one_minus * (sr * sr)
        if env_l < F(1e-30):
            env_l = F(0.0)
        if env_r < F(1e-30):
            env_r = F(0.0)
        self.lev_env[0], self.lev_env[1] = env_l, env_r

        rms_sq = env_l if env_l > env_r else env_r
        rms_db = F(10.0) * _fm(fmath.log10_f32, rms_sq + F(1e-30))
        if rms_db < co.gate_threshold_db:
            gc_db = F(0.0)
        else:
            gc_db = _gain_computer(rms_db, co.threshold_db, co.ratio,
                                   co.knee_width_db)
            gc_db = gc_db + co.makeup_db
            if gc_db > co.max_gain_db:
                gc_db = co.max_gain_db

        alpha_sample = (co.alpha_attack if gc_db < self.lev_gain_smooth_db
                        else co.alpha_release)
        alpha = _fm(fmath.pow_f32, alpha_sample, F(count))
        self.lev_gain_smooth_db = _fm(
            fmath.smooth_det, alpha, self.lev_gain_smooth_db, gc_db)
        self.lev_gain_prev_linear = self.lev_gain_linear
        self.lev_gain_linear = _fm(
            fmath.exp10_f32, self.lev_gain_smooth_db * (F(1.0) / F(20.0)))

        gain_prev, gain_cur = self.lev_gain_prev_linear, self.lev_gain_linear
        if count == 1:
            gain, gain_step = gain_cur, F(0.0)
        else:
            gain_step = (gain_cur - gain_prev) * (F(1.0) / F(count - 1))
            gain = gain_prev
        ceil = F(C.LEVELLER_LIMITER_CEIL)
        use_la = cfg.lookahead
        la_idx = self.lev_la_idx
        for i in range(count):
            if use_la:
                out_l = self.lev_la_buf[0, la_idx]
                out_r = self.lev_la_buf[1, la_idx]
                self.lev_la_buf[0, la_idx] = bl[i]
                self.lev_la_buf[1, la_idx] = br[i]
                la_idx += 1
                if la_idx >= C.LEVELLER_LOOKAHEAD_SAMPLES:
                    la_idx = 0
            else:
                out_l, out_r = bl[i], br[i]
            peak = abs(out_l)
            pr = abs(out_r)
            if pr > peak:
                peak = pr
            g = gain
            if peak > F(0.0) and g > F(1.0):
                max_g = _fm(fmath.det_div, ceil, peak)
                if max_g < g:
                    g = max_g if max_g > F(1.0) else F(1.0)
            bl[i] = out_l * g
            br[i] = out_r * g
            gain = gain + gain_step
        self.lev_la_idx = la_idx

    def _crossfeed_f32(self, ml: np.float32, mr: np.float32):
        """crossfeed_process_stereo, float (crossfeed.c:131-156)."""
        st = self.d.crossfeed
        lp_out_l = st.lp_a0 * ml + st.lp_b1 * self.xf_lp[0]
        lp_out_r = st.lp_a0 * mr + st.lp_b1 * self.xf_lp[1]
        self.xf_lp[0], self.xf_lp[1] = lp_out_l, lp_out_r
        ap_out_l = st.ap_a * lp_out_l + self.xf_ap[0]
        self.xf_ap[0] = lp_out_l - st.ap_a * ap_out_l
        ap_out_r = st.ap_a * lp_out_r + self.xf_ap[1]
        self.xf_ap[1] = lp_out_r - st.ap_a * ap_out_r
        return (ml - lp_out_l) + ap_out_r, (mr - lp_out_r) + ap_out_l

    # ------------------------------------------------------------------
    # Q28-path helpers
    # ------------------------------------------------------------------

    def _eq_block_q28(self, ch: int, buf: list, count: int) -> None:
        """dsp_process_channel_block Q28 (dsp_process_rp2040.S:225-394)."""
        for band, bq in enumerate(self.d.eq[ch]):
            if bq.bypass:
                continue
            b0, b1, b2 = int(bq.qb0), int(bq.qb1), int(bq.qb2)
            a1, a2 = int(bq.qa1), int(bq.qa2)
            s1 = self.eq_s1[ch][band]
            s2 = self.eq_s2[ch][band]
            for i in range(count):
                x = buf[i]
                y = qref.w32(qref.q28_mul(b0, x) + s1)
                s1 = qref.w32(qref.w32(qref.q28_mul(b1, x) - qref.q28_mul(a1, y)) + s2)
                s2 = qref.w32(qref.q28_mul(b2, x) - qref.q28_mul(a2, y))
                buf[i] = y
            self.eq_s1[ch][band] = s1
            self.eq_s2[ch][band] = s2

    def _loudness_q28(self, bl: list, br: list, count: int) -> None:
        """Loudness TDF2 biquads, Q28 (usb_audio.c:1018-1047)."""
        coeffs = self.d.loudness[self.cfg.host_volume_index]
        for i in range(count):
            for chi, buf in ((0, bl), (1, br)):
                raw = buf[i]
                for j, lc in enumerate(coeffs):
                    if lc.bypass:
                        continue
                    s1 = self.loud_s1[chi][j]
                    s2 = self.loud_s2[chi][j]
                    res = qref.w32(qref.q28_mul(int(lc.qb0), raw) + s1)
                    self.loud_s1[chi][j] = qref.w32(
                        qref.w32(qref.q28_mul(int(lc.qb1), raw)
                                 - qref.q28_mul(int(lc.qa1), res)) + s2)
                    self.loud_s2[chi][j] = qref.w32(
                        qref.q28_mul(int(lc.qb2), raw)
                        - qref.q28_mul(int(lc.qa2), res))
                    raw = res
                buf[i] = raw

    def _leveller_q28(self, bl: list, br: list, count: int) -> None:
        """leveller_process_block, Q28 (leveller.c:274-389)."""
        if count == 0:
            return
        co = self.d.leveller
        cfg = self.cfg.leveller
        a_rms_q28 = qref.f32_to_i32(co.alpha_rms * F(1 << C.FILTER_SHIFT))
        one_minus = qref.w32(C.Q28_ONE - a_rms_q28)
        env_l, env_r = self.lev_env[0], self.lev_env[1]
        for i in range(count):
            sl, sr = bl[i], br[i]
            sq_l = qref.q28_mul(sl, sl)
            sq_r = qref.q28_mul(sr, sr)
            env_l = qref.w32(qref.q28_mul(a_rms_q28, env_l)
                             + qref.q28_mul(one_minus, sq_l))
            env_r = qref.w32(qref.q28_mul(a_rms_q28, env_r)
                             + qref.q28_mul(one_minus, sq_r))
        self.lev_env[0], self.lev_env[1] = env_l, env_r

        inv_q28 = F(1.0) / F(1 << C.FILTER_SHIFT)
        env_l_f = F(env_l) * inv_q28
        env_r_f = F(env_r) * inv_q28
        rms_sq = env_l_f if env_l_f > env_r_f else env_r_f
        rms_db = F(10.0) * _fm(fmath.log10_f32, rms_sq + F(1e-30))
        if rms_db < co.gate_threshold_db:
            gc_db = F(0.0)
        else:
            gc_db = _gain_computer(rms_db, co.threshold_db, co.ratio,
                                   co.knee_width_db)
            gc_db = gc_db + co.makeup_db
            if gc_db > co.max_gain_db:
                gc_db = co.max_gain_db
        alpha_sample = (co.alpha_attack if gc_db < self.lev_gain_smooth_db
                        else co.alpha_release)
        alpha = _fm(fmath.pow_f32, alpha_sample, F(count))
        self.lev_gain_smooth_db = _fm(
            fmath.smooth_det, alpha, self.lev_gain_smooth_db, gc_db)
        gain_linear = _fm(
            fmath.exp10_f32, self.lev_gain_smooth_db * (F(1.0) / F(20.0)))
        self.lev_gain_prev_q28 = self.lev_gain_q28
        self.lev_gain_q28 = qref.f32_to_i32(gain_linear * F(C.Q28_ONE))

        g_prev, g_cur = self.lev_gain_prev_q28, self.lev_gain_q28
        unity = C.Q28_ONE
        ceil = F(C.LEVELLER_LIMITER_CEIL)
        use_la = cfg.lookahead
        la_idx = self.lev_la_idx
        for i in range(count):
            if count == 1:
                gain = g_cur
            else:
                gain = qref.w32(g_prev + _div_trunc((g_cur - g_prev) * i, count - 1))
            if use_la:
                out_l = self.lev_la_buf[0][la_idx]
                out_r = self.lev_la_buf[1][la_idx]
                self.lev_la_buf[0][la_idx] = bl[i]
                self.lev_la_buf[1][la_idx] = br[i]
                la_idx += 1
                if la_idx >= C.LEVELLER_LOOKAHEAD_SAMPLES:
                    la_idx = 0
            else:
                out_l, out_r = bl[i], br[i]
            if gain > unity:
                peak = abs(F(out_l) * F(1.0) / F(1 << C.FILTER_SHIFT))
                pr = abs(F(out_r) * F(1.0) / F(1 << C.FILTER_SHIFT))
                if pr > peak:
                    peak = pr
                if peak > F(0.0):
                    max_g_f = _fm(fmath.det_div, ceil, peak)
                    max_g_q28 = qref.f32_to_i32(max_g_f * F(unity))
                    if max_g_q28 < gain:
                        gain = max_g_q28 if max_g_q28 > unity else unity
            bl[i] = qref.q28_mul(out_l, gain)
            br[i] = qref.q28_mul(out_r, gain)
        self.lev_la_idx = la_idx

    def _crossfeed_q28(self, ml: int, mr: int):
        """crossfeed_process_stereo, Q28 (crossfeed.c:160-180)."""
        st = self.d.crossfeed
        a0, b1, apa = int(st.q_lp_a0), int(st.q_lp_b1), int(st.q_ap_a)
        lp_l = qref.w32(qref.q28_mul(a0, ml) + qref.q28_mul(b1, self.xf_lp[0]))
        lp_r = qref.w32(qref.q28_mul(a0, mr) + qref.q28_mul(b1, self.xf_lp[1]))
        self.xf_lp[0], self.xf_lp[1] = lp_l, lp_r
        ap_l = qref.w32(qref.q28_mul(apa, lp_l) + self.xf_ap[0])
        self.xf_ap[0] = qref.w32(lp_l - qref.q28_mul(apa, ap_l))
        ap_r = qref.w32(qref.q28_mul(apa, lp_r) + self.xf_ap[1])
        self.xf_ap[1] = qref.w32(lp_r - qref.q28_mul(apa, ap_r))
        return qref.w32(qref.w32(ml - lp_l) + ap_r), qref.w32(qref.w32(mr - lp_r) + ap_l)

    # ------------------------------------------------------------------
    # PDM delta-sigma modulator
    # ------------------------------------------------------------------

    def pdm_set_enabled(self, enabled: bool) -> None:
        """Control-plane PDM enable transition — the loop reactions the
        firmware runs at the next core-1 iteration (pdm_generator.c):

          * disable while running  -> start the 1024-sample fade-out
            instead of an immediate stop (:225-229)
          * re-enable mid-fade     -> convert the out-ramp into an
            in-ramp from the current attenuation (:233-236)
          * re-enable after a completed stop -> full modulator restart:
            err/err2/noise-shaper/fades reset; the xorshift32 PRNG is a
            global in the firmware and persists (:240-255)
        """
        if enabled:
            if self.pdm_fout_pos > 0:
                self.pdm_fade_pos = C.PDM_FADE_IN_SAMPLES - self.pdm_fout_pos
                self.pdm_fout_pos = 0
            elif not self.pdm_run:
                self.pdm_err = 0
                self.pdm_err2 = 0
                self.pdm_ns = dict(x1=0, x2=0, y1=0, y2=0, err_acc=0)
                self.pdm_fade_pos = 0
                self.pdm_base = 0
                self.pdm_run = True
        else:
            if self.pdm_run and self.pdm_fout_pos == 0:
                self.pdm_fout_pos = C.PDM_FADE_IN_SAMPLES
        self.pdm_ena = bool(enabled)

    def _pdm_sample(self, sample: int) -> list[int]:
        """One PCM sample -> 8 PDM words (pdm_generator.c:349-397).

        While fading out the input is ignored (core 0 stopped pushing and
        the ring is drained, :324) and the target ramps the held
        fade_base_pcm to silence (:326); the iteration where fade_out_pos
        reaches 0 stops the hardware without modulating (:328-334).
        Samples processed while stopped emit PDM_SILENCE_WORD (the
        firmware's restart prefill pattern, :240-241) as the word-stream
        stand-in for "PIO not shifting"."""
        if self.pdm_fout_pos > 0:
            self.pdm_fout_pos -= 1
            if self.pdm_fout_pos == 0:
                self.pdm_run = False
                return [C.PDM_SILENCE_WORD] * C.PDM_CHUNKS
            target = qref.w32(qref.asr(
                qref.w32(self.pdm_base * self.pdm_fout_pos),
                C.PDM_FADE_IN_SHIFT) + 32768)
        elif not (self.pdm_ena and self.pdm_run):
            return [C.PDM_SILENCE_WORD] * C.PDM_CHUNKS
        else:
            pcm = qref.asr(sample, 14)
            if pcm > C.PDM_CLIP_THRESH:
                pcm = C.PDM_CLIP_THRESH
            if pcm < -C.PDM_CLIP_THRESH:
                pcm = -C.PDM_CLIP_THRESH
            if self.pdm_fade_pos < C.PDM_FADE_IN_SAMPLES:
                pcm = qref.asr(qref.w32(pcm * self.pdm_fade_pos),
                               C.PDM_FADE_IN_SHIFT)
                self.pdm_fade_pos += 1
            self.pdm_base = pcm
            target = qref.w32(pcm + 32768)

        err, err2 = self.pdm_err, self.pdm_err2
        ns = self.pdm_ns
        words = []
        for _ in range(C.PDM_CHUNKS):
            self.pdm_rng = qref.xorshift32(self.pdm_rng)
            raw = (self.pdm_rng & C.PDM_DITHER_MASK) - (C.PDM_DITHER_MASK >> 1)
            dither = _noise_shaped_dither(ns, raw, qref.asr(err2, 8))
            word = 0
            for k in range(32):
                cond = qref.w32(err2 + dither) >= 0
                fb = 65535 if cond else 0
                if cond:
                    word |= 1 << (31 - k)
                err = qref.w32(err + target - fb)
                err2 = qref.w32(err2 + err - fb)
            words.append(word)
        err = qref.w32(err - qref.asr(err, C.PDM_LEAKAGE_SHIFT))
        err2 = qref.w32(err2 - qref.asr(err2, C.PDM_LEAKAGE_SHIFT))
        self.pdm_err, self.pdm_err2 = err, err2
        return words

    # ------------------------------------------------------------------
    # The packet pipeline
    # ------------------------------------------------------------------

    def process_packet(self, pcm: np.ndarray, bit_depth: int = 16,
                       preset_mute_gain: float = 1.0) -> dict:
        """process_audio_packet (usb_audio.c:500-1317) for one packet.

        ``pcm``: int array [count, 2] of s16 (bit_depth=16) or s24 ints
        (bit_depth=24).  Returns a dict with the post-chain buffers, the
        s24 S/PDIF words, PDM words and telemetry.
        """
        if self.is_float:
            return self._process_f32(pcm, bit_depth, preset_mute_gain)
        return self._process_q28(pcm, bit_depth, preset_mute_gain)

    def _process_f32(self, pcm, bit_depth, preset_mute_gain) -> dict:
        cfg, d = self.cfg, self.d
        g = d.gains
        count = len(pcm)
        nout = cfg.num_outputs

        inv_32768 = F(1.0) / F(32768.0)
        vol_mul = F(0.0) if cfg.host_mute else F(g.host_vol_mul) * inv_32768
        vol_mul = vol_mul * F(preset_mute_gain)
        vol_mul_master = vol_mul * g.master_volume_linear

        # PASS 1: unpack + preamp
        buf_l = np.empty(count, np.float32)
        buf_r = np.empty(count, np.float32)
        if bit_depth == 24:
            inv = F(1.0) / F(8388608.0)
        else:
            inv = inv_32768
        gain_l = inv * g.preamp_linear[0]
        gain_r = inv * g.preamp_linear[1]
        for i in range(count):
            buf_l[i] = F(int(pcm[i, 0])) * gain_l
            buf_r[i] = F(int(pcm[i, 1])) * gain_r

        if cfg.loudness.enabled and d.loudness is not None:
            self._loudness_f32(buf_l, buf_r, count)

        # PASS 2: master EQ
        if not cfg.bypass_master_eq:
            if not d.channel_bypassed[C.CH_MASTER_LEFT]:
                self._eq_block_f32(C.CH_MASTER_LEFT, buf_l, count)
            if not d.channel_bypassed[C.CH_MASTER_RIGHT]:
                self._eq_block_f32(C.CH_MASTER_RIGHT, buf_r, count)

        # PASS 2.5: leveller
        if cfg.leveller.enabled:
            self._leveller_f32(buf_l, buf_r, count)

        # PASS 3: crossfeed + master peaks (peaks are pre-crossfeed)
        peak_ml = F(0.0)
        peak_mr = F(0.0)
        do_xf = d.crossfeed.enabled
        for i in range(count):
            ml, mr = buf_l[i], buf_r[i]
            if abs(ml) > peak_ml:
                peak_ml = abs(ml)
            if abs(mr) > peak_mr:
                peak_mr = abs(mr)
            if do_xf:
                ml, mr = self._crossfeed_f32(ml, mr)
                buf_l[i], buf_r[i] = ml, mr

        # PASS 4: matrix mixing, output-major
        buf_out = np.zeros((nout, count), np.float32)
        for out in range(nout):
            if not g.output_enabled[out]:
                continue
            gl = g.matrix_gain[0, out]
            gr = g.matrix_gain[1, out]
            if gl != 0.0 and gr != 0.0:
                for i in range(count):
                    buf_out[out, i] = buf_l[i] * gl + buf_r[i] * gr
            elif gl != 0.0:
                for i in range(count):
                    buf_out[out, i] = buf_l[i] * gl
            elif gr != 0.0:
                for i in range(count):
                    buf_out[out, i] = buf_r[i] * gr

        # PASS 5: per-output EQ + gain  (single-core ordering; the EQ-worker
        # split produces identical values — usb_audio.c:873-959)
        for out in range(nout):
            if not g.output_enabled[out]:
                continue
            if not g.output_mute[out]:
                eq_ch = C.CH_OUT_1 + out
                if not d.channel_bypassed[eq_ch]:
                    self._eq_block_f32(eq_ch, buf_out[out], count)
            gain = (F(0.0) if g.output_mute[out]
                    else g.output_gain_linear[out] * vol_mul_master)
            if gain == F(0.0):
                buf_out[out, :count] = F(0.0)
            elif gain != F(1.0):
                for i in range(count):
                    buf_out[out, i] = buf_out[out, i] * gain

        # Delay lines
        mask = C.MAX_DELAY_SAMPLES[cfg.platform] - 1
        if g.any_delay_active:
            for out in range(nout):
                dly = int(g.delay_samples[out])
                if dly <= 0:
                    continue
                widx = self.delay_write_idx
                for i in range(count):
                    self.delay_lines[out, widx] = buf_out[out, i]
                    buf_out[out, i] = self.delay_lines[out, (widx - dly) & mask]
                    widx = (widx + 1) & mask
            self.delay_write_idx = (self.delay_write_idx + count) & mask

        # Peaks + clip flags for outputs
        n_spdif_ch = C.NUM_SPDIF_INSTANCES[cfg.platform] * 2
        for out in range(n_spdif_ch):
            peak = F(0.0)
            for i in range(count):
                a = abs(buf_out[out, i])
                if a > peak:
                    peak = a
            self.peaks[C.CH_OUT_1 + out] = int(min(F(1.0), peak) * F(32767.0))
            if peak > F(C.CLIP_THRESH_F):
                self.clip_flags |= 1 << (C.CH_OUT_1 + out)

        # S/PDIF conversion
        npairs = C.NUM_SPDIF_INSTANCES[cfg.platform]
        spdif = np.zeros((npairs, count, 2), np.int32)
        for pair in range(npairs):
            lch, rch = pair * 2, pair * 2 + 1
            if not g.output_enabled[lch] and not g.output_enabled[rch]:
                continue
            for i in range(count):
                dl = max(F(-1.0), min(F(1.0), buf_out[lch, i]))
                dr = max(F(-1.0), min(F(1.0), buf_out[rch, i]))
                spdif[pair, i, 0] = qref.f32_to_i32(dl * F(8388607.0))
                spdif[pair, i, 1] = qref.f32_to_i32(dr * F(8388607.0))

        # PDM sub
        pdm_words = []
        sub = nout - 1
        if g.output_enabled[sub]:
            peak_sub = F(0.0)
            for i in range(count):
                a = abs(buf_out[sub, i])
                if a > peak_sub:
                    peak_sub = a
            self.peaks[cfg.sub_channel] = int(min(F(1.0), peak_sub) * F(32767.0))
            if peak_sub > F(C.CLIP_THRESH_F):
                self.clip_flags |= 1 << cfg.sub_channel
            pdm_scale = F(1 << 28)
            for i in range(count):
                q = qref.f32_to_i32(buf_out[sub, i] * pdm_scale)
                pdm_words.extend(self._pdm_sample(q))
        else:
            self.peaks[cfg.sub_channel] = 0

        self.peaks[0] = int(min(F(1.0), peak_ml) * F(32767.0))
        self.peaks[1] = int(min(F(1.0), peak_mr) * F(32767.0))
        if peak_ml > F(C.CLIP_THRESH_F):
            self.clip_flags |= 1
        if peak_mr > F(C.CLIP_THRESH_F):
            self.clip_flags |= 2

        return dict(master_l=buf_l, master_r=buf_r, buf_out=buf_out,
                    spdif=spdif, pdm_words=pdm_words,
                    peaks=list(self.peaks), clip_flags=self.clip_flags)

    def _process_q28(self, pcm, bit_depth, preset_mute_gain) -> dict:
        cfg, d = self.cfg, self.d
        g = d.gains
        count = len(pcm)
        nout = cfg.num_outputs

        vol_mul = 0 if cfg.host_mute else int(g.host_vol_mul)
        pm_q15 = qref.f32_to_i32(F(preset_mute_gain) * F(32768.0) + F(0.5))
        pm_q15 = min(max(pm_q15, 0), 32768)
        vol_mul = qref.q15_mul(vol_mul, pm_q15)
        vol_mul_master = qref.q15_mul(vol_mul, int(g.master_volume_q15))

        preamp_l = int(g.preamp_q28[0])
        preamp_r = int(g.preamp_q28[1])

        # PASS 1: unpack + preamp
        buf_l = [0] * count
        buf_r = [0] * count
        for i in range(count):
            if bit_depth == 24:
                raw_l = qref.asr(qref.w32(int(pcm[i, 0]) << 8), 2)
                raw_r = qref.asr(qref.w32(int(pcm[i, 1]) << 8), 2)
            else:
                raw_l = qref.w32(int(pcm[i, 0]) << 14)
                raw_r = qref.w32(int(pcm[i, 1]) << 14)
            buf_l[i] = qref.q28_mul(raw_l, preamp_l)
            buf_r[i] = qref.q28_mul(raw_r, preamp_r)

        if cfg.loudness.enabled and d.loudness is not None:
            self._loudness_q28(buf_l, buf_r, count)

        # PASS 2: master EQ
        if not cfg.bypass_master_eq:
            if not d.channel_bypassed[C.CH_MASTER_LEFT]:
                self._eq_block_q28(C.CH_MASTER_LEFT, buf_l, count)
            if not d.channel_bypassed[C.CH_MASTER_RIGHT]:
                self._eq_block_q28(C.CH_MASTER_RIGHT, buf_r, count)

        # PASS 2.5: leveller
        if cfg.leveller.enabled:
            self._leveller_q28(buf_l, buf_r, count)

        # PASS 3: crossfeed + peaks
        peak_ml = peak_mr = 0
        do_xf = d.crossfeed.enabled
        for i in range(count):
            ml, mr = buf_l[i], buf_r[i]
            if abs(ml) > peak_ml:
                peak_ml = abs(ml)
            if abs(mr) > peak_mr:
                peak_mr = abs(mr)
            if do_xf:
                ml, mr = self._crossfeed_q28(ml, mr)
                buf_l[i], buf_r[i] = ml, mr

        # PASS 4: matrix (Q15 gains quantized per block, usb_audio.c:1084-1085)
        buf_out = [[0] * count for _ in range(nout)]
        for out in range(nout):
            if not g.output_enabled[out]:
                continue
            gl = int(g.matrix_gain_q15[0, out])
            gr = int(g.matrix_gain_q15[1, out])
            if gl != 0 and gr != 0:
                for i in range(count):
                    buf_out[out][i] = qref.w32(qref.q15_mul(buf_l[i], gl)
                                               + qref.q15_mul(buf_r[i], gr))
            elif gl != 0:
                for i in range(count):
                    buf_out[out][i] = qref.q15_mul(buf_l[i], gl)
            elif gr != 0:
                for i in range(count):
                    buf_out[out][i] = qref.q15_mul(buf_r[i], gr)

        # PASS 5: per-output EQ + gain.  NOTE: on RP2040 bypass_master_eq
        # also gates the per-output EQ (usb_audio.c:1200), unlike the float
        # path — a live firmware quirk we reproduce.
        for out in range(nout):
            if not g.output_enabled[out]:
                continue
            if not g.output_mute[out]:
                eq_ch = C.CH_OUT_1 + out
                if not cfg.bypass_master_eq and not d.channel_bypassed[eq_ch]:
                    self._eq_block_q28(eq_ch, buf_out[out], count)
            gain = (0 if g.output_mute[out]
                    else qref.f32_to_i32(g.output_gain_linear[out]
                                         * F(vol_mul_master)))
            if gain == 0:
                for i in range(count):
                    buf_out[out][i] = 0
            else:
                for i in range(count):
                    buf_out[out][i] = qref.q15_mul(buf_out[out][i], gain)

        # Delay
        mask = C.MAX_DELAY_SAMPLES[cfg.platform] - 1
        if g.any_delay_active:
            for out in range(nout):
                dly = int(g.delay_samples[out])
                if dly <= 0:
                    continue
                widx = self.delay_write_idx
                for i in range(count):
                    self.delay_lines[out][widx] = buf_out[out][i]
                    buf_out[out][i] = self.delay_lines[out][(widx - dly) & mask]
                    widx = (widx + 1) & mask
            self.delay_write_idx = (self.delay_write_idx + count) & mask

        # Peaks + clips
        n_spdif_ch = C.NUM_SPDIF_INSTANCES[cfg.platform] * 2
        for out in range(n_spdif_ch):
            peak = 0
            for i in range(count):
                a = abs(buf_out[out][i])
                if a > peak:
                    peak = a
            self.peaks[C.CH_OUT_1 + out] = (peak >> 13) & 0xFFFF
            if peak > C.CLIP_THRESH_Q28:
                self.clip_flags |= 1 << (C.CH_OUT_1 + out)

        # S/PDIF conversion with round-half-up (usb_audio.c:1254-1255)
        npairs = C.NUM_SPDIF_INSTANCES[cfg.platform]
        spdif = np.zeros((npairs, count, 2), np.int32)
        for pair in range(npairs):
            lch, rch = pair * 2, pair * 2 + 1
            if not g.output_enabled[lch] and not g.output_enabled[rch]:
                continue
            for i in range(count):
                spdif[pair, i, 0] = qref.q28_to_s24(buf_out[lch][i])
                spdif[pair, i, 1] = qref.q28_to_s24(buf_out[rch][i])

        # PDM sub (Q28 samples pushed directly, usb_audio.c:1269-1271)
        pdm_words = []
        sub = nout - 1
        if g.output_enabled[sub]:
            peak_sub = 0
            for i in range(count):
                a = abs(buf_out[sub][i])
                if a > peak_sub:
                    peak_sub = a
            self.peaks[cfg.sub_channel] = (peak_sub >> 13) & 0xFFFF
            if peak_sub > C.CLIP_THRESH_Q28:
                self.clip_flags |= 1 << cfg.sub_channel
            for i in range(count):
                pdm_words.extend(self._pdm_sample(buf_out[sub][i]))
        else:
            self.peaks[cfg.sub_channel] = 0

        self.peaks[0] = (peak_ml >> 13) & 0xFFFF
        self.peaks[1] = (peak_mr >> 13) & 0xFFFF
        if peak_ml > C.CLIP_THRESH_Q28:
            self.clip_flags |= 1
        if peak_mr > C.CLIP_THRESH_Q28:
            self.clip_flags |= 2

        return dict(master_l=buf_l, master_r=buf_r, buf_out=buf_out,
                    spdif=spdif, pdm_words=pdm_words,
                    peaks=list(self.peaks), clip_flags=self.clip_flags)


# ----------------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------------


def _gain_computer(x_db, threshold, ratio, knee_width):
    """Upward-compression gain computer (leveller.c:124-139), float32.

    Division-free form shared with the device path: the slope and knee
    reciprocals are precomputed with IEEE numpy division (host), as the
    JAX package's device path needs (its backends' division is not
    correctly rounded).
    Differs from the firmware's in-loop divisions by <= 1 ulp."""
    half_knee = knee_width * F(0.5)
    slope = F(1.0) - F(1.0) / ratio
    inv_two_knee = F(1.0) / (F(2.0) * knee_width)
    if x_db > (threshold + half_knee):
        return F(0.0)
    if x_db >= (threshold - half_knee):
        d = threshold + half_knee - x_db
        return slope * d * d * inv_two_knee
    return (threshold - x_db) * slope


def _div_trunc(a: int, b: int) -> int:
    """C integer division: truncate toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _noise_shaped_dither(ns: dict, raw_dither: int, quant_error: int) -> int:
    """noise_shaped_dither (pdm_generator.c:89-108), exact int32."""
    ns["err_acc"] = qref.w32(qref.asr(qref.w32(ns["err_acc"] * 248), 8)
                             + qref.asr(quant_error, 6))
    inp = qref.w32(raw_dither - ns["err_acc"])
    total = qref.w32(
        C.PDM_NS_B0 * inp + C.PDM_NS_B1 * ns["x1"] + C.PDM_NS_B2 * ns["x2"]
        + C.PDM_NS_A1 * ns["y1"] - C.PDM_NS_A2 * ns["y2"])
    output = qref.asr(total, 14)
    ns["x2"] = ns["x1"]
    ns["x1"] = inp
    ns["y2"] = ns["y1"]
    ns["y1"] = output
    return output
