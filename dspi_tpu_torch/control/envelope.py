"""Preset mute envelope: the 8 ms anti-pop fade around flash operations.

A copy of the JAX package's ``control/envelope.py`` for the PyTorch port.

Port of update_preset_mute_envelope (usb_audio.c:456-498): an 8 ms linear
ramp toward mute while a preset/flash operation is pending, advanced once
per packet and rate-aware.  The control layer uses this to produce the
per-packet ``preset_mute`` gain array consumed by the pipeline, so preset
switches fade exactly as on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.constants import PRESET_MUTE_TRANSITION_MS

F = np.float32


def _transition_samples(sample_rate_hz: int) -> int:
    samples = (sample_rate_hz * PRESET_MUTE_TRANSITION_MS + 999) // 1000
    return max(samples, 1)


@dataclass
class PresetMuteEnvelope:
    """State of the fade (preset_mute_smooth_gain + counter)."""

    gain: float = 1.0
    mute_counter: int = 0
    loading: bool = False

    def engage(self, sample_rate_hz: int, hold_ms: float = 10.0) -> None:
        """flash_mute_hold_samples (flash_storage.c:272-276): arm the mute
        for ~10 ms (min 512 samples)."""
        samples = (int(sample_rate_hz) * int(hold_ms) + 999) // 1000
        self.mute_counter = max(samples, 512)
        self.loading = True

    def step(self, sample_count: int, sample_rate_hz: int) -> float:
        """One packet's envelope update; returns the gain for this packet."""
        mute_active = self.loading
        if mute_active:
            if self.mute_counter > sample_count:
                self.mute_counter -= sample_count
            else:
                self.mute_counter = 0
                self.loading = False

        target = F(0.0) if mute_active else F(1.0)
        if sample_count == 0:
            self.gain = float(target)
            return self.gain

        step = F(sample_count) / F(_transition_samples(sample_rate_hz))
        step = min(step, F(1.0))
        g = F(self.gain)
        if g < target:
            g = g + step
            if g > target:
                g = target
        elif g > target:
            g = g - step
            if g < target:
                g = target
        self.gain = float(g)
        return self.gain

    def packet_gains(self, n_packets: int, sample_count: int,
                     sample_rate_hz: int) -> np.ndarray:
        """Gains for a whole segment — feed to Engine.process(preset_mute=...)."""
        return np.array([self.step(sample_count, sample_rate_hz)
                         for _ in range(n_packets)], np.float32)
