"""The port's host wire encoder and telemetry (``dspi_tpu_torch.runtime``)
against the JAX package's: S/PDIF and I2S words across segments with the
IEC 60958 block position carried, a mid-stream slot-type switch, the load
meter, and the telemetry feed taking tensors."""

import struct

import numpy as np
import pytest
import torch

from dspi_tpu import DeviceConfig as JDeviceConfig, Platform as JPlatform
from dspi_tpu.runtime.telemetry import LoadMeter as JLoadMeter
from dspi_tpu.runtime.wire_out import WireEncoder as JWireEncoder
from dspi_tpu_torch import DeviceConfig, Platform
from dspi_tpu_torch.control import requests as R
from dspi_tpu_torch.control.device import VirtualDSPi
from dspi_tpu_torch.core import constants as C
from dspi_tpu_torch.kernels import encoders
from dspi_tpu_torch.runtime.telemetry import EngineTelemetry, LoadMeter
from dspi_tpu_torch.runtime.wire_out import WireEncoder


def _s24(rng, shape):
    s = rng.integers(-(2**23), 2**23, size=shape).astype(np.int32)
    s.flat[0], s.flat[1] = -(2**23), 2**23 - 1        # full scale
    return s


def _same(mine: dict, theirs: dict):
    assert set(mine) == set(theirs)
    for k in theirs:
        got = mine[k].numpy().view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(theirs[k]), err_msg=k)


@pytest.mark.parametrize("name,types", [
    ("RP2350", [0, 0, 0, 0]), ("RP2350", [0, 1, 0, 1]),
    ("RP2040", [0, 0, 0, 0]), ("RP2040", [1, 0, 0, 0])])
def test_words_match_jax_across_segments(rng, name, types):
    """Three segments of 3 packets (144 frames each): every word equal,
    the block position carried (the Z preamble lands every 192 frames),
    the words on the s24 tensor's device."""
    cfg, jcfg = DeviceConfig(platform=Platform[name]), \
        JDeviceConfig(platform=JPlatform[name])
    cfg.hardware.output_types = list(types)
    jcfg.hardware.output_types = list(types)
    w, jw = WireEncoder(cfg, 48), JWireEncoder(jcfg, 48)
    ns2 = 2 * C.NUM_SPDIF_INSTANCES[Platform[name]]
    for seg in range(3):
        s24 = _s24(rng, (3, ns2, 48, 5))
        mine = w.encode(torch.from_numpy(s24))
        _same(mine, jw.encode(s24))
        assert w.frame_pos == jw.frame_pos == (144 * (seg + 1)) % 192
        assert all(v.device == torch.device("cpu") and v.dtype == torch.int32
                   for v in mine.values())
    assert w.encode(s24)["pair0"].shape[0] == 144    # arrays are taken too


def test_mid_stream_type_switch_resets_position(rng):
    """SET_OUTPUT_TYPE applied mid-run: the pair switches format and the
    block position restarts at 0 (process_type_switches), as the JAX
    encoder does; a no-op apply keeps the position."""
    dev = VirtualDSPi(Platform.RP2350)
    w = WireEncoder(dev.cfg, 48)
    jw = JWireEncoder(JDeviceConfig(platform=JPlatform.RP2350), 48)
    s24 = _s24(rng, (2, 8, 48, 1))                  # 96 frames
    _same(w.encode(torch.from_numpy(s24)), jw.encode(s24))
    assert w.frame_pos == 96

    dev.set(R.SET_OUTPUT_TYPE, 1, b"\x01")
    assert w.apply_types(dev.cfg.hardware.output_types)
    assert jw.apply_types(list(dev.cfg.hardware.output_types))
    assert w.frame_pos == 0
    out = w.encode(torch.from_numpy(s24))
    _same(out, jw.encode(s24))
    assert out["pair1"].shape == (96, 2, 1)
    np.testing.assert_array_equal(
        out["pair1"][:, 0, 0].numpy(),
        encoders.encode_i2s(torch.from_numpy(s24[:, 2].reshape(-1)))
        .numpy())
    assert out["pair0"][0, 0, 0].item() & 0xFF == 0b00111001   # Z preamble

    pos = w.frame_pos
    assert not w.apply_types(dev.cfg.hardware.output_types)
    assert w.frame_pos == pos


def test_load_meter_matches_jax():
    m, jm = LoadMeter(), JLoadMeter()
    for frac in [0.5] * 30 + [1.7, -0.2] + [0.25] * 30 + [0.0] * 60:
        assert m.update(frac) == jm.update(frac)
        assert m.load_q8 == jm.load_q8


def test_engine_telemetry_feeds_device_from_tensors():
    """feed_device takes the engine's output tensors: peaks land in the
    status surface GET_STATUS 9 reads."""
    t = EngineTelemetry()
    t.segment_begin()
    assert t.segment_end(4, 48, 16) > 0
    dev = VirtualDSPi(Platform.RP2350)
    t.feed_device(dev, {"peaks": torch.arange(22, dtype=torch.int32)
                        .reshape(11, 2)}, stream=1)
    assert dev.peaks == list(range(1, 22, 2))
    assert dev.counters["usb_audio_packets"] == 4
    peaks = struct.unpack("<11H", dev.get(R.GET_STATUS, 9)[:22])
    assert peaks == tuple(range(1, 22, 2))
