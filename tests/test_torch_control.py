"""The port's vendor control plane (``dspi_tpu_torch.control``) against the
JAX package's, and the engine-driving control cases against the port's
Engine and runners.

Drift: one scripted vendor-request sequence (EQ, volumes, matrix,
outputs, dynamics, names, presets, bulk, sample rate, bit depth, MCK,
bootloader, truncated transfers) goes through both ``VirtualDSPi``s;
after every step each GET response is byte-equal and the configs are
equal field for field.  Engine cases: the twins of
``tests/test_control.py`` (:168, :201, :297, :363, :399, :456) and
``tests/test_runtime.py::test_vendor_commit_drives_engine``."""

import dataclasses
import math
import struct
import time

import numpy as np
import pytest

from dspi_tpu import Platform as JPlatform
from dspi_tpu.control import requests as JR
from dspi_tpu.control.device import VirtualDSPi as JVirtualDSPi
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine
from dspi_tpu_torch.control import requests as R
from dspi_tpu_torch.control.device import VirtualDSPi
from dspi_tpu_torch.control.envelope import PresetMuteEnvelope
from dspi_tpu_torch.runtime.executor import StreamRunner

from test_torch_pack import _convert
from util import golden_run, make_input

CPU = "cpu"


def _to_jax(v):
    """A port config object -> the JAX package's twin, field for field
    (``_convert``'s inverse), for the golden model."""
    from dspi_tpu.core import constants
    from dspi_tpu.params import types
    if isinstance(v, list):
        return [_to_jax(x) for x in v]
    if dataclasses.is_dataclass(v):
        cls = getattr(types, type(v).__name__)
        out = cls.__new__(cls)
        for f in dataclasses.fields(v):
            object.__setattr__(out, f.name, _to_jax(getattr(v, f.name)))
        return out
    if type(v).__module__ == "dspi_tpu_torch.core.constants":
        return getattr(constants, type(v).__name__)(v.value)
    return v


def _f(x):
    return struct.pack("<f", x)


def _script(nout):
    """(kind, request, wValue, payload) steps; kind "set" is a vendor
    control-OUT, "rate"/"bits" the UAC sample-rate / alt-setting
    controls, "bulk" a GET_ALL_PARAMS -> SET_ALL_PARAMS round trip."""
    eq = "<BBBBfff"
    return [
        ("set", R.SET_EQ_PARAM, 0, struct.pack(eq, 2, 0, 1, 0, 5.0, 50.0,
                                               4.0)),       # clamped
        ("set", R.SET_EQ_PARAM, 0, struct.pack(eq, 0, 3, 2, 0, 1000.0, 1.0,
                                               -3.0)),
        ("set", R.SET_EQ_PARAM, 0, struct.pack(eq, 1, 9, 4, 0, 9000.0, 0.7,
                                               2.5)),
        ("set", R.SET_EQ_PARAM, 0, b"short"),              # truncated
        ("set", R.SET_PREAMP_CH, 1, _f(-3.5)),
        ("set", R.SET_PREAMP, 0, _f(2.0)),
        ("set", R.SET_MASTER_VOLUME, 0, _f(-300.0)),
        ("set", R.SET_MASTER_VOLUME, 0, _f(math.nan)),
        ("set", R.SET_MASTER_VOLUME, 0, b"\x01\x02"),       # truncated
        ("set", R.SET_MASTER_VOLUME, 0, _f(-12.0)),
        ("set", R.SET_OUTPUT_ENABLE, 2, b"\x01"),
        ("set", R.SET_OUTPUT_ENABLE, nout - 1, b"\x01"),    # interlock
        ("set", R.SET_OUTPUT_ENABLE, 2, b"\x00"),
        ("set", R.SET_OUTPUT_ENABLE, nout - 1, b"\x01"),
        ("set", R.SET_MATRIX_ROUTE, 0, struct.pack("<BBBBf", 1, 4, 1, 1,
                                                   -6.0)),
        ("set", R.SET_OUTPUT_GAIN, 3, _f(-4.5)),
        ("set", R.SET_OUTPUT_DELAY, 3, _f(12.5)),
        ("set", R.SET_DELAY, 5, _f(1.0)),
        ("set", R.SET_OUTPUT_MUTE, 1, b"\x01"),
        ("set", R.SET_OUTPUT_PIN, 0, bytes([24])),          # invalid pin
        ("set", R.SET_OUTPUT_PIN, 0, bytes([16])),
        ("set", R.SET_OUTPUT_TYPE, 1, b"\x01"),
        ("set", R.SET_CHANNEL_GAIN, 1, _f(-2.0)),
        ("set", R.SET_CHANNEL_MUTE, 2, b"\x01"),
        ("set", R.SET_BYPASS, 0, b"\x00"),
        ("set", R.SET_LOUDNESS, 0, b"\x01"),
        ("set", R.SET_LOUDNESS_REF, 0, _f(80.0)),
        ("set", R.SET_LOUDNESS_INTENSITY, 0, _f(70.0)),
        ("set", R.SET_CROSSFEED, 0, b"\x01"),
        ("set", R.SET_CROSSFEED_PRESET, 0, b"\x02"),
        ("set", R.SET_CROSSFEED_FREQ, 0, _f(650.0)),
        ("set", R.SET_CROSSFEED_FEED, 0, _f(6.0)),
        ("set", R.SET_CROSSFEED_ITD, 0, b"\x01"),
        ("set", R.SET_LEVELLER_ENABLE, 0, b"\x01"),
        ("set", R.SET_LEVELLER_AMOUNT, 0, _f(250.0)),       # clamps
        ("set", R.SET_LEVELLER_SPEED, 0, b"\x02"),
        ("set", R.SET_LEVELLER_MAX_GAIN, 0, _f(99.0)),      # clamps
        ("set", R.SET_LEVELLER_LOOKAHEAD, 0, b"\x01"),
        ("set", R.SET_LEVELLER_GATE, 0, _f(-60.0)),
        ("set", R.SET_CHANNEL_NAME, 4, b"Surround L\x00"),
        ("set", R.PRESET_SAVE, 3, b""),
        ("set", R.PRESET_SET_NAME, 3, b"Late night\x00"),
        ("set", R.SET_OUTPUT_GAIN, 0, _f(-7.0)),
        ("set", R.PRESET_SAVE, 5, b""),
        ("set", R.PRESET_SET_STARTUP, 0, b"\x00\x05"),
        ("set", R.PRESET_SET_INCLUDE_PINS, 0, b"\x01"),
        ("set", R.SET_MASTER_VOLUME_MODE, 0, b"\x01"),
        ("set", R.SAVE_MASTER_VOLUME, 0, b""),
        ("set", R.PRESET_LOAD, 3, b""),
        ("set", R.PRESET_DELETE, 5, b""),
        ("bulk", None, 0, b""),
        ("set", R.SET_I2S_BCK_PIN, 0, bytes([18])),
        ("set", R.SET_MCK_MULTIPLIER, 0, b"\x01"),
        ("set", R.SET_MCK_ENABLE, 0, b"\x01"),
        ("set", R.SET_MCK_PIN, 0, bytes([21])),
        ("rate", None, 96000, b""),                          # MCK 256->128
        ("set", R.SET_MCK_MULTIPLIER, 0, b"\x01"),           # refused
        ("rate", None, 44100, b""),
        ("rate", None, 192000, b""),                         # -> 44100
        ("bits", None, 24, b""),
        ("set", R.CLEAR_CLIPS, 0, b""),
        ("set", R.RESET_BUFFER_STATS, 1, b""),
        ("set", R.RESET_USB_ERROR_STATS, 0, b""),
        ("set", R.SAVE_PARAMS, 0, b""),
        ("set", R.FACTORY_RESET, 0, b""),
        ("set", R.LOAD_PARAMS, 0, b""),
        ("set", R.ENTER_BOOTLOADER, 0, b""),
    ]


_GETS = sorted({v for k, v in vars(R).items()
                if k.startswith(("GET_", "PRESET_GET_"))})
_WVALUES = list(range(12)) + [18, 19, 20, 21] + [
    (band << 8) | ch for ch in (0, 2, 10) for band in (1, 3, 9)]


def _responses(dev):
    return [(g, w, dev.get(g, w)) for g in _GETS for w in _WVALUES]


def _same_device(mine, theirs, step):
    assert dataclasses.asdict(mine.cfg) == \
        dataclasses.asdict(_convert(theirs.cfg)), step
    for f in ("dirty", "bit_depth", "bootloader_requested", "clip_flags",
              "usb_errors"):
        assert getattr(mine, f) == getattr(theirs, f), (step, f)
    for (g, w, a), (_, _, b) in zip(_responses(mine), _responses(theirs)):
        assert a == b, (step, hex(g), w)


def test_request_codes_match_jax():
    mine = {k: v for k, v in vars(R).items() if k.isupper()}
    theirs = {k: v for k, v in vars(JR).items() if k.isupper()}
    assert mine == theirs


@pytest.mark.parametrize("name", ["RP2350", "RP2040"])
def test_vendor_script_matches_jax(name):
    """Every step of the script leaves both devices byte-equal on every
    GET and field-equal in their configs."""
    mine = VirtualDSPi(Platform[name])
    theirs = JVirtualDSPi(JPlatform[name])
    _same_device(mine, theirs, "boot")
    for i, (kind, req, wv, payload) in enumerate(
            _script(mine.cfg.num_outputs)):
        for dev in (mine, theirs):
            if kind == "set":
                dev.set(req, wv, payload)
            elif kind == "rate":
                dev.set_sample_rate(wv)
            elif kind == "bits":
                dev.set_bit_depth(wv)
            else:
                dev.set(R.SET_ALL_PARAMS, 0, dev.get(R.GET_ALL_PARAMS))
        step = f"step {i}: {kind} {req if req is None else hex(req)} {wv}"
        _same_device(mine, theirs, step)
        if kind in ("set", "bulk") and i % 7 == 0:
            # the mute envelope's staircase moves the same way too
            np.testing.assert_array_equal(mine.packet_gains(4, 48),
                                          theirs.packet_gains(4, 48))


# ----------------------------------------------------------------------------
# engine-driving cases, on the port's Engine (CPU)
# ----------------------------------------------------------------------------


@pytest.fixture
def dev():
    return VirtualDSPi(Platform.RP2350)


def test_preset_mute_envelope_through_engine(dev):
    """PRESET_SAVE -> Engine.process fades the outputs with the exact
    staircase the envelope computes."""
    dev.set(R.SET_OUTPUT_ENABLE, 0, b"\x01")
    dev.set(R.PRESET_SAVE, 0)                    # arms the fade
    eng = Engine(dev.cfg, n_streams=1, pdm=False, device=CPU)
    npkt, block = 12, 48
    gains = dev.packet_gains(npkt, block)

    x = np.full((npkt, 2, block, 1), 12000, np.int32)
    got = eng.process(x, preset_mute=gains)["out"].numpy()[:, 0, :, 0]
    eng2 = Engine(dev.cfg, n_streams=1, pdm=False, device=CPU)
    ref = eng2.process(x)["out"].numpy()[:, 0, :, 0]
    for k in range(npkt):
        np.testing.assert_allclose(got[k], ref[k] * gains[k],
                                   rtol=2e-6, atol=1e-7)
    k0 = int(np.argmin(gains))
    assert gains[k0] == 0.0
    assert np.abs(got[k0]).max() == 0.0

    env = PresetMuteEnvelope()
    env.engage(48000)
    want = np.array([env.step(block, 48000) for _ in range(npkt)], np.float32)
    np.testing.assert_array_equal(gains, want)


def test_runner_stats_feed_status_surface(dev):
    """Buffer stats and starvation selectors 17-21 move with real runner
    events."""
    eng = Engine(dev.cfg, n_streams=4, pdm=False, emit="reduced", device=CPU)
    runner = StreamRunner(eng, max_inflight=2, deadline_s=0.003)
    dev.attach_runner(runner)

    x = np.zeros((3, 2, 48, 4), np.int32)
    runner.feed(x)
    time.sleep(0.02)                              # miss the deadline hard
    runner.feed(x)
    runner.drain()

    total = struct.unpack("<I", dev.get(R.GET_STATUS, 17))[0]
    slot0 = struct.unpack("<I", dev.get(R.GET_STATUS, 18))[0]
    assert total >= 1 and slot0 >= 1
    assert total == sum(
        struct.unpack("<I", dev.get(R.GET_STATUS, 18 + i))[0]
        for i in range(4))

    stats = dev.get(R.GET_BUFFER_STATS)
    nsp, flags, _ = struct.unpack_from("<BBH", stats, 0)
    free, prepared, playing, fill, lo, hi = struct.unpack_from("<6B", stats, 4)
    assert nsp >= 1 and flags & 0x02
    assert hi >= fill >= lo
    assert runner.stats.max_fill_pct == hi

    # a de-framed segment counts a data_seq USB error
    with pytest.raises(ValueError):
        runner.feed(np.zeros((2, 3, 48, 4), np.int32))
    total, _, _, _, _, seq = struct.unpack(
        "<6I", dev.get(R.GET_USB_ERROR_STATS))
    assert (total, seq) == (1, 1)


def test_starvation_suppressed_during_preset_ops(dev):
    """A preset op mid-serve masks starvation counting for its mute-hold
    window while silence is still substituted; a genuine late feed
    outside the window counts."""
    eng = Engine(dev.cfg, n_streams=4, pdm=False, emit="reduced", device=CPU)
    runner = StreamRunner(eng, max_inflight=8, deadline_s=0.003)
    dev.attach_runner(runner)
    x = np.zeros((3, 2, 48, 4), np.int32)
    runner.feed(x)

    dev.set(R.PRESET_SAVE, 0)
    assert dev.mute_env.loading
    time.sleep(0.02)
    runner.feed(x)                                # late — but intentional
    assert runner.stats.starvations_total == 0
    assert runner.stats.starvations_slot == [0, 0, 0, 0]
    assert runner.stats.starvations_suppressed == 1
    assert runner.stats.silence_segments == 1

    while dev.mute_env.loading:
        dev.packet_gains(4, 48)
    time.sleep(0.02)
    runner.feed(x)                                # genuine late feed
    assert runner.stats.starvations_total == runner.stats.n_slots
    assert runner.stats.starvations_suppressed == 1
    runner.drain()


def test_structural_commit_resets_deadline_clock(dev):
    eng = Engine(dev.cfg, n_streams=4, pdm=False, emit="reduced", device=CPU)
    runner = StreamRunner(eng, max_inflight=8, deadline_s=0.003)
    dev.attach_runner(runner)
    x = np.zeros((3, 2, 48, 4), np.int32)
    runner.feed(x)

    dev.set(R.SET_EQ_PARAM, 0,
            struct.pack("<BBBBfff", 0, 0, 1, 0, 1000.0, 1.0, 3.0))
    old_static = eng.static
    assert dev.commit(eng)
    assert eng.static is not old_static
    time.sleep(0.02)                              # the rebuild stall
    runner.feed(x)
    assert runner.stats.starvations_total == 0
    runner.drain()


def test_silence_substitution_on_starvation(dev):
    """A missed feed deadline substitutes a zeroed segment shaped like a
    real one into the output stream."""
    eng = Engine(dev.cfg, n_streams=4, pdm=False, device=CPU)
    runner = StreamRunner(eng, max_inflight=8, deadline_s=0.003)
    x = np.full((3, 2, 48, 4), 12000, np.int32)

    runner.feed(x)
    time.sleep(0.02)
    runner.feed(x)
    outs = [o for o, _ in runner._inflight]
    runner.drain()

    assert runner.stats.silence_segments == 1
    assert runner.stats.starvations_total >= 1
    assert len(outs) == 3                         # real, silence, real
    sil, real = outs[1], outs[0]
    assert all(v.abs().max() == 0 for v in sil.values())
    assert {k: (v.shape, v.dtype) for k, v in sil.items()} == \
        {k: (v.shape, v.dtype) for k, v in real.items()}
    assert real["out"].abs().max() > 0


def test_sample_rate_change_flow(dev):
    """Filters recompute at the new rate, packet geometry follows it, DSP
    state persists across the change."""
    dev.set(R.SET_EQ_PARAM, 0,
            struct.pack("<BBBBfff", 0, 0, 1, 0, 1000.0, 1.0, 3.0))
    eng = Engine(dev.cfg, n_streams=2, pdm=False, device=CPU)
    dev.commit(eng)
    eng.process(np.full((4, 2, 48, 2), 9000, np.int32))
    state_before = eng.state.eq_c.clone()
    assert state_before.abs().max() > 0

    dev.set_sample_rate(96000)
    assert dev.dirty and dev.commit(eng)
    assert eng.static.block_size == 96 and not eng.static.schedule
    fresh = Engine(dev.cfg, n_streams=2, pdm=False, device=CPU)
    assert (eng.params.eq_f32 == fresh.params.eq_f32).all()
    assert (eng.state.eq_c == state_before).all()
    eng.process(np.full((2, 2, 96, 2), 9000, np.int32))

    dev.set_sample_rate(44100)
    dev.commit(eng)
    assert eng.static.schedule == ((44,) * 9 + (45,))
    eng.process(np.full((2, 441, 2), 9000, np.int32))

    dev.set_sample_rate(192000)
    assert not dev.dirty and dev.cfg.sample_rate == 44100.0


def test_bit_depth_switch_flow():
    """The UAC alt-setting switch (16 -> 24-bit) rebuilds the engine with
    the 24-bit unpack; state carries over, every output word equal to the
    golden model fed the same packets across the switch."""
    dev = VirtualDSPi(Platform.RP2040)
    dev.set(R.SET_EQ_PARAM, 0,
            struct.pack("<BBBBfff", 0, 0, 1, 0, 1000.0, 1.0, 3.0))
    eng = Engine(dev.cfg, n_streams=2, pdm=False, device=CPU)
    dev.commit(eng)
    assert eng.static.bit_depth == 16

    lrng = np.random.default_rng(0xBD)
    goldens = [GoldenDevice(_to_jax(dev.cfg.copy())) for _ in range(2)]

    def run_both(x, depth):
        out = eng.process(x)["out"].numpy()
        want = np.stack(
            [np.stack([np.asarray(goldens[s].process_packet(
                np.stack([x[k, 0, :, s], x[k, 1, :, s]], axis=1),
                bit_depth=depth)["buf_out"]) for k in range(x.shape[0])])
             for s in range(2)], axis=-1)
        np.testing.assert_array_equal(out, want)

    run_both(lrng.integers(-30000, 30000, size=(3, 2, 48, 2)).astype(
        np.int32), 16)
    dev.set_bit_depth(24)
    assert dev.dirty and dev.bit_depth == 24
    state_before = eng.state.eq_a.clone()
    assert state_before.abs().max() > 0
    assert dev.commit(eng)
    assert eng.static.bit_depth == 24
    assert (eng.state.eq_a == state_before).all()
    run_both(lrng.integers(-(1 << 23), 1 << 23, size=(3, 2, 48, 2)).astype(
        np.int32), 24)


def test_vendor_commit_drives_engine():
    """A vendor commit drives the port's Q28 engine to the golden model's
    output for the same config."""
    rng = np.random.default_rng(0xC0)
    dev = VirtualDSPi(Platform.RP2040)
    eng = Engine(dev.cfg, n_streams=2, pdm=False, device=CPU)
    dev.set(R.SET_PREAMP, 0, struct.pack("<f", -6.0))
    assert dev.commit(eng)
    assert not dev.commit(eng)          # idempotent until the next change

    x = make_input(rng, 3, 48, 2)
    out = eng.process(x)["out"].numpy()
    goldens = [golden_run(GoldenDevice(_to_jax(dev.cfg.copy())),
                          x[..., s:s + 1]) for s in range(2)]
    want = np.stack(
        [np.stack([np.asarray(p["buf_out"]) for p in gs]) for gs in goldens],
        axis=-1)
    np.testing.assert_array_equal(out, want)


def test_update_telemetry_takes_tensors(dev):
    """The status surface reads peaks and clip flags given as tensors."""
    import torch

    dev.update_telemetry(torch.arange(22, dtype=torch.int32).reshape(11, 2),
                         torch.tensor([0b10, 0b101], dtype=torch.int32),
                         stream=1)
    assert dev.peaks == list(range(1, 22, 2))
    assert dev.clip_flags == 0b101
    peaks = struct.unpack("<11H", dev.get(R.GET_STATUS, 9)[:22])
    assert peaks == tuple(range(1, 22, 2))
