"""USB asynchronous feedback controller — pure-function port.

A copy of the JAX package's ``control/feedback.py`` for the PyTorch port.

The firmware's Q16.16 dual-loop clock servo (usb_feedback_controller.c):

  Loop A — rate estimator: 4-SOF-decimated DMA word deltas through a
           rounded IIR (alpha = 1/16).
  Loop B — fill servo: proportional correction on the slot-0 consumer
           buffer fill vs target 8/16, IIR-filtered, Kp 4096 (Q16.16),
           clamped to +/-0.5 sample/frame; 2-update holdoff after reset.
  Output — rate + servo clamped to nominal +/- 1.0 sample/frame;
           serialized to the endpoint as 10.14 via (q16 + 2) >> 2.

In the batched engine this is NOT on the audio path (the stream axis has
no host clock to chase); it is kept as an exact int32 model for
protocol-fidelity tests and for hosts that emulate a UAC1 endpoint in
front of the engine.
"""

from __future__ import annotations

from dataclasses import dataclass

FB_FILL_TARGET = 8
FB_FILL_KP_Q16 = 4096
FB_SERVO_CLAMP_Q16 = 32768
FB_OUTER_CLAMP_Q16 = 65536
FB_IIR_SHIFT = 4
FB_HOLDOFF_UPDATES = 2

_M32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    return ((x + 0x80000000) & _M32) - 0x80000000


def _round_div_pow2_s32(x: int, n: int) -> int:
    """round_div_pow2_s32 (usb_feedback_controller.h): round half away
    from zero."""
    bias = 1 << (n - 1)
    if x >= 0:
        return (x + bias) >> n
    return -(((-x) + bias) >> n)


@dataclass
class FeedbackController:
    rate_estimate_q16: int = 0
    nominal_rate_q16: int = 0
    fill_error_filtered: int = 0
    feedback_out_q16: int = 0
    holdoff_remaining: int = 0
    rate_valid: bool = False
    stream_active: bool = False
    need_baseline: bool = False
    sof_count: int = 0
    last_total_words: int = 0

    def reset(self, nominal_rate_q16: int) -> None:
        self.nominal_rate_q16 = nominal_rate_q16 & _M32
        self.rate_estimate_q16 = nominal_rate_q16 & _M32
        self.rate_valid = True
        self.fill_error_filtered = 0
        self.holdoff_remaining = FB_HOLDOFF_UPDATES
        self.feedback_out_q16 = nominal_rate_q16 & _M32
        self.stream_active = True
        self.need_baseline = True
        self.sof_count = 0

    def stream_stop(self) -> None:
        self.stream_active = False
        self.rate_valid = False
        self.fill_error_filtered = 0
        self.holdoff_remaining = 0
        self.sof_count = 0
        self.feedback_out_q16 = self.nominal_rate_q16

    def sof_update(self, current_total_words: int, rate_shift: int,
                   consumer_fill: int) -> None:
        if not self.stream_active or not self.rate_valid:
            return
        self.sof_count = (self.sof_count + 1) & _M32
        if (self.sof_count & 0x3) != 0:
            return
        if self.need_baseline:
            self.last_total_words = current_total_words & _M32
            self.need_baseline = False
            return

        delta_words = (current_total_words - self.last_total_words) & _M32
        self.last_total_words = current_total_words & _M32
        if delta_words == 0:
            return

        rate_raw_q16 = (delta_words << rate_shift) & _M32
        rate_error = _i32(rate_raw_q16 - self.rate_estimate_q16)
        self.rate_estimate_q16 = (
            self.rate_estimate_q16
            + (_round_div_pow2_s32(rate_error, FB_IIR_SHIFT) & _M32)) & _M32

        servo_q16 = 0
        if self.holdoff_remaining > 0:
            self.holdoff_remaining -= 1
        else:
            fill_error_q16 = _i32((consumer_fill - FB_FILL_TARGET) << 16)
            fe_delta = _i32(fill_error_q16 - self.fill_error_filtered)
            self.fill_error_filtered = _i32(
                self.fill_error_filtered
                + _round_div_pow2_s32(fe_delta, FB_IIR_SHIFT))
            servo_raw = _i32(-((FB_FILL_KP_Q16 * self.fill_error_filtered) >> 16))
            servo_raw = min(max(servo_raw, -FB_SERVO_CLAMP_Q16),
                            FB_SERVO_CLAMP_Q16)
            servo_q16 = servo_raw

        fb_out = _i32(self.rate_estimate_q16) + servo_q16
        nom = _i32(self.nominal_rate_q16)
        fb_out = min(max(fb_out, nom - FB_OUTER_CLAMP_Q16),
                     nom + FB_OUTER_CLAMP_Q16)
        self.feedback_out_q16 = fb_out & _M32

    def get_10_14(self) -> int:
        if self.feedback_out_q16 == 0:
            return 0
        return ((self.feedback_out_q16 + 2) >> 2) & _M32


def nominal_feedback_q16(sample_rate_hz: int) -> int:
    """Nominal samples/frame in Q16.16 (e.g. 48 kHz -> 48.0)."""
    return (sample_rate_hz << 16) // 1000
