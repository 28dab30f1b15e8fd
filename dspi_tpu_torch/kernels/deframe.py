"""On-device USB payload deframing: raw byte streams -> engine input.

The JAX package's ``kernels/deframe.py``.  The firmware unpacks USB
payload bytes on the device (usb_audio.c:591-686 float / :997-1006 Q28
byte assembly); the batched analog uploads the RAW bytes and unpacks them
on the card with elementwise ops and one permute, instead of deframing on
the host.  That halves (s16) or two-thirds (s24) the host->card transfer
relative to shipping unpacked int32 planes.

The host-side twin (native/dspi_host.cpp ``dspi_deframe_*_batch`` through
``dspi_tpu_torch.native.deframe_batch``) produces identical planes; tests
pin the two against each other.  Serving feeds bytes and deframes each
segment through ``ChainedRunner(pre=make_pre(...))``.

s16 payloads travel as int32 views of the byte stream (one int32 per
frame: low half = L, high half = R, both little-endian — a zero-copy
``payload.view(np.int32)`` on the host); s24 payloads travel as uint8.
Sign extension uses masks, never a shift into the sign bit.
"""

from __future__ import annotations

import numpy as np
import torch

_I32 = torch.int32


def _tensor(payload):
    """A tensor of ``payload`` where it lies (a NumPy array on the CPU)."""
    if isinstance(payload, np.ndarray) and not payload.flags.writeable:
        payload = payload.copy()        # torch refuses read-only buffers
    return torch.as_tensor(payload)


def _frames_to_planes(l, r, npkt: int, block: int):
    """l, r: int32 [B, frames] -> int32 [npkt, 2, block, B], contiguous."""
    lr = torch.stack([l, r]).reshape(2, l.shape[0], npkt, block)
    return lr.permute(2, 0, 3, 1).contiguous()


def deframe_s16(payload, npkt: int, block: int):
    """int32 [B, npkt*block] (byte-stream view; frame i in word i) ->
    int32 [npkt, 2, block, B] on the payload's device.

    Little-endian s16 LRLR: word = (r << 16) | (l & 0xFFFF), so l is the
    sign-extended low half and r the arithmetic high shift — the exact
    inverse of the interleave in usb_audio.c:591-594."""
    v = _tensor(payload).to(_I32)
    l = ((v & 0xFFFF) ^ 0x8000) - 0x8000
    r = v >> 16
    return _frames_to_planes(l, r, npkt, block)


def deframe_s24(payload, npkt: int, block: int):
    """uint8 [B, npkt*block*6] (packed s24 LRLR) -> int32
    [npkt, 2, block, B] on the payload's device, sign-extended
    (usb_audio.c:997-1006 byte assembly, before the Q28 shift)."""
    p = _tensor(payload)
    p = p.reshape(p.shape[0], npkt * block, 6).to(_I32)

    def s24(b0, b1, b2):
        return ((b0 | (b1 << 8) | (b2 << 16)) ^ 0x800000) - 0x800000

    return _frames_to_planes(s24(p[..., 0], p[..., 1], p[..., 2]),
                             s24(p[..., 3], p[..., 4], p[..., 5]),
                             npkt, block)


def make_pre(npkt: int, block: int, bit_depth: int = 16):
    """A ``ChainedRunner(pre=...)`` hook deframing one fed segment.
    Carries ``npkt`` so the runner can default the preset-mute staircase
    without seeing framed input shapes."""
    if bit_depth == 24:
        def fn(payload):
            return deframe_s24(payload, npkt, block)
    else:
        def fn(payload):
            return deframe_s16(payload, npkt, block)
    fn.npkt = npkt
    return fn
