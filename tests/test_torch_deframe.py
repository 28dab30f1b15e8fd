"""The port's on-device deframe (``dspi_tpu_torch.kernels.deframe``)
against the JAX package's and against the port's native host deframer
(``dspi_tpu_torch.native``), and a ChainedRunner fed payload words
against one fed planes (the twin of ``tests/test_deframe.py``)."""

import numpy as np
import pytest
import torch

from dspi_tpu.kernels import deframe as jdeframe
from dspi_tpu_torch import Platform, native
from dspi_tpu_torch.chain import Engine
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.kernels import deframe
from dspi_tpu_torch.runtime.executor import ChainedRunner


def _payloads(rng, B, frames, bit_depth):
    """Random payload rows and the planes they frame, int32
    [frames // 48, 2, 48, B]; the first frames carry full scale and the
    top byte's high bit."""
    if bit_depth == 16:
        vals = rng.integers(-32768, 32768, size=(B, frames, 2))
        edge = [-32768, 32767, -1, -256, 0x7F00, -0x8000 + 1]
    else:
        vals = rng.integers(-(2 ** 23), 2 ** 23, size=(B, frames, 2))
        edge = [-(2 ** 23), 2 ** 23 - 1, -1, -(2 ** 16), 0x7F0000,
                0x800000 - 0x10000]
    vals[0, :3] = np.reshape(edge, (3, 2))
    vals[-1, -3:] = np.reshape(edge[::-1], (3, 2))
    vals = vals.astype(np.int32)
    if bit_depth == 16:
        payloads = vals.astype(np.int16).view(np.uint8).reshape(B, -1)
    else:
        u = vals & 0xFFFFFF
        payloads = np.stack([u & 0xFF, (u >> 8) & 0xFF, u >> 16],
                            axis=-1).astype(np.uint8).reshape(B, -1)
    want = np.moveaxis(vals.reshape(B, frames // 48, 48, 2), (0, 3), (3, 1))
    return np.ascontiguousarray(payloads), want


def _fed(payloads, bit_depth):
    return payloads.view(np.int32) if bit_depth == 16 else payloads


@pytest.mark.parametrize("bit_depth", [16, 24])
def test_deframe_matches_jax(rng, bit_depth):
    B, npkt, block = 37, 4, 48
    payloads, want = _payloads(rng, B, npkt * block, bit_depth)
    got = deframe.make_pre(npkt, block, bit_depth)(_fed(payloads, bit_depth))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    theirs = np.asarray(jdeframe.make_pre(npkt, block, bit_depth)(
        _fed(payloads, bit_depth)))
    np.testing.assert_array_equal(got.numpy(), theirs)
    assert deframe.make_pre(npkt, block, bit_depth).npkt == npkt


@pytest.mark.parametrize("bit_depth", [16, 24])
def test_deframe_matches_native(rng, bit_depth):
    B, npkt, block = 70, 3, 48
    payloads, want = _payloads(rng, B, npkt * block, bit_depth)
    host = native.deframe_batch(payloads, npkt, block, bit_depth=bit_depth,
                                n_threads=2)
    np.testing.assert_array_equal(host, want)
    dev = deframe.make_pre(npkt, block, bit_depth)(
        torch.from_numpy(_fed(payloads, bit_depth)))
    np.testing.assert_array_equal(dev.numpy(), host)
    with pytest.raises(ValueError, match="payload rows"):
        native.deframe_batch(payloads[:, :-1], npkt, block,
                             bit_depth=bit_depth)


def test_native_unpack_pack_transpose(rng):
    """The rest of the bound host data plane against NumPy."""
    vals = rng.integers(-(2 ** 23), 2 ** 23, size=(50, 2)).astype(np.int32)
    raw = native.pack_s24(vals[:, 0], vals[:, 1])
    assert len(raw) == 300
    left, right = native.unpack_s24(raw)
    np.testing.assert_array_equal(left, vals[:, 0])
    np.testing.assert_array_equal(right, vals[:, 1])

    s16 = vals.astype(np.int16)
    left, right = native.unpack_s16(s16.tobytes())
    np.testing.assert_array_equal(left, s16[:, 0])
    np.testing.assert_array_equal(right, s16[:, 1])

    with pytest.raises(ValueError, match="50 left samples, 49 right"):
        native.pack_s24(vals[:, 0], vals[:-1, 1])

    planar = rng.integers(-1000, 1000, size=(7, 33)).astype(np.int32)
    np.testing.assert_array_equal(native.to_time_major(planar), planar.T)


@pytest.mark.parametrize("bit_depth", [16, 24])
def test_chained_runner_pre_deframe(rng, bit_depth):
    """A ChainedRunner fed raw payloads (``pre=make_pre``) returns the
    folds, peaks and clips of one fed the planes, and leaves the same
    state."""
    # 6 packets a segment: the leveller's 10 ms lookahead holds the
    # outputs silent for the first 10 of the 12
    B, npkt, block, depth = 16, 6, 48, 2
    cfg = full_chain_config(Platform.RP2350)
    payloads, planes = zip(*[_payloads(rng, B, npkt * block, bit_depth)
                             for _ in range(depth)])
    xb_fed = np.stack([_fed(p, bit_depth) for p in payloads])
    xb_planes = np.stack(planes)

    def run(pre, xb):
        eng = Engine(cfg, n_streams=B, block_size=block, emit="reduced",
                     pdm=True, pdm_fade=False, bit_depth=bit_depth,
                     device="cpu")
        r = ChainedRunner(eng, depth=depth, pre=pre)
        out = r.feed(xb)
        r.drain()
        return out, eng.state

    (framed, st_f) = run(deframe.make_pre(npkt, block, bit_depth), xb_fed)
    (plain, st_p) = run(None, xb_planes)
    for a, b in zip(framed, plain):
        assert torch.equal(a, b)
    assert framed[1][2:].ne(0).any(), "the outputs are silent"
    for f, a, b in zip(st_f._fields, st_f, st_p):
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
