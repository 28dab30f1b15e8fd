"""Output encoders: IEC 60958 (S/PDIF) subframe encoding and I2S packing.

A copy of the JAX package's ``kernels/encoders.py`` on torch tensors.  The
firmware offloads serialization to PIO state machines fed by DMA:

  * S/PDIF: BMC (biphase-mark) encoding via a 256-entry lookup table plus
    preamble/channel-status/parity stamping
    (audio_spdif.c:140-153, sample_encoding.h:27-49, audio_spdif.c:77-114).
  * I2S: 24-in-32 left-justified, sample << 8 (audio_i2s_multi.c:223-226).

Words are int32 tensors holding the uint32 bit patterns, as the PDM words
are: torch's uint32 support is thin.  Right shifts of int32 are arithmetic
in torch, so every right shift of a word is masked; left shifts wrap.
Output layout matches the PIO wire format exactly: each subframe is two
32-bit words (l, h) shifted out LSB-first.

``bmc_encode_byte`` and ``spdif_update_subframe`` are the closed forms
(a Morton bit spread for the table).  The wire stage runs
``spdif_planes``, which makes the same words in a few passes over the
samples: the byte-wise parts of a subframe come from five 256-entry
tables built from ``bmc_encode_byte`` (one gather a byte and word), and
the frame headers, which depend on the frame alone, are [T, 1] rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C

_I32 = torch.int32


def bmc_encode_byte(b: torch.Tensor) -> torch.Tensor:
    """BMC-encode one byte: the closed form of the spdif_lookup table
    (audio_spdif.c:140-153).

    Returns int32: bits [15:0] = biphase cell pattern, bit 16 = parity.
    Only the low 8 bits of ``b`` (any integer tensor) are used."""
    b = b.to(_I32) & 0xFF
    # Morton spread: bit j -> bit 2j
    m = (b | (b << 4)) & 0x0F0F
    m = (m | (m << 2)) & 0x3333
    m = (m | (m << 1)) & 0x5555
    v = 0x5555 | (m << 1)
    # parity of the byte
    p = b ^ (b >> 4)
    p = p ^ (p >> 2)
    p = p ^ (p >> 1)
    return v | ((p & 1) << 16)


def spdif_update_subframe(l, h, sample):
    """Encode a 24-bit sample into an (l, h) subframe word pair —
    spdif_update_subframe (sample_encoding.h:27-49), closed form.

    ``l``/``h`` (int32 bit patterns) carry the preamble (l[7:0]) and the
    channel-status / user / validity bits (h[31:24]); those are preserved
    exactly as the firmware does.  ``sample`` is int32; bits [23:0] are
    encoded."""
    s = sample.to(_I32)
    s0 = bmc_encode_byte(s)
    s1 = bmc_encode_byte(s >> 8)
    s2 = bmc_encode_byte(s >> 16)

    l = (l & 0xFF) | ((s0 & 0xFFFF) << 8) | (s1 << 24)
    ph = (h >> 24) & 0xFF                          # logical >> 24
    hh = ((s1 & 0xFFFF) >> 8) | ((s2 & 0xFFFF) << 8)
    p = (s0 >> 16) ^ (s1 >> 16) ^ (s2 >> 16)
    # parity of the aux/status bits already present in the subframe header:
    # ((ph & 0x2a) * 0x2a) >> 6 & 1  (sample_encoding.h:46)
    p = p ^ ((((ph & 0x2A) * 0x2A) >> 6) & 1)
    h = hh | ((ph & 0x7F) << 24) | ((p & 1) << 31)
    return l, h


def channel_status_bits(sample_rate: int = 48000) -> np.ndarray:
    """IEC 60958-3 consumer channel status bits for one 192-frame block
    (audio_spdif.c:77-94); byte 3 carries the rate code."""
    rate_byte = {44100: 0x00, 48000: 0x02, 96000: 0x0A}.get(int(sample_rate),
                                                           0x02)
    status = list(C.SPDIF_CHANNEL_STATUS)
    status[3] = rate_byte
    bits = np.zeros(192, np.uint32)
    for i in range(40):
        bits[i] = (status[i // 8] >> (i % 8)) & 1
    return bits


def spdif_frame_headers(block_pos: torch.Tensor, sample_rate: int = 48000):
    """Pristine (l, h) header words for frames at the given block positions
    (init_spdif_buffer, audio_spdif.c:101-114).

    block_pos: int tensor of frame indices (taken modulo 192).
    Returns (l_L, h_L, l_R, h_R) int32 tensors of its shape."""
    pos = (block_pos % C.SPDIF_BLOCK_FRAMES).to(torch.int64)
    bits = torch.from_numpy(channel_status_bits(sample_rate).astype(
        np.int32)).to(pos.device)
    c_bit = bits[pos]
    l_L = torch.where(pos == 0, C.SPDIF_PREAMBLE_Z,
                      C.SPDIF_PREAMBLE_X).to(_I32)
    h = 0x55000000 | (c_bit << 29)
    l_R = torch.full_like(l_L, C.SPDIF_PREAMBLE_Y)
    return l_L, h, l_R, h


@functools.lru_cache(maxsize=None)
def _tables_np() -> np.ndarray:
    """The byte tables of ``spdif_planes``, int32 [5, 256]: the l-word
    parts of the low and middle byte, the h-word parts of the middle and
    high byte and the low byte's, each with the byte's parity in bit 31."""
    t = bmc_encode_byte(torch.arange(256, dtype=_I32))
    pat, par = t & 0xFFFF, (t >> 16) & 1
    return torch.stack([pat << 8,                        # l, byte 0
                        t << 24,                         # l, byte 1
                        (pat >> 8) | (par << 31),        # h, byte 1
                        (pat << 8) | (par << 31),        # h, byte 2
                        par << 31]).numpy()              # h, byte 0


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_tables_np()).to(device)


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx.reshape(-1)).view(idx.shape)


def spdif_planes(s24: torch.Tensor, start_frame, sample_rate: int = 48000):
    """S/PDIF subframe words of a channel pair, as two planes.

    s24: int32 [2, T, ...] (left, right); ``start_frame``: the block
    position of the first frame (int or a scalar tensor, read on the
    device).  Returns (l, h), int32 [2, T, ...]: the (l, h) words of each
    channel's subframe, the words ``spdif_update_subframe`` gives on the
    headers of ``spdif_frame_headers``."""
    T = s24.shape[1]
    extra = (1,) * (s24.dim() - 2)
    pos = torch.arange(T, device=s24.device) + start_frame
    l_L, h_hdr, l_R, _ = spdif_frame_headers(pos, sample_rate)
    ph = (h_hdr >> 24) & 0xFF
    # the header's share of the h word: status bits, and their parity in
    # bit 31 (sample_encoding.h:46)
    h_hdr = ((ph & 0x7F) << 24) | (((((ph & 0x2A) * 0x2A) >> 6) & 1) << 31)
    l_hdr = torch.stack([l_L, l_R]).view(2, T, *extra)
    tb = _tables(s24.device)
    # one byte plane at a time, the words built in place, so that at most
    # four [2, T, ...] planes besides the input are live at once.  The byte parts of h
    # occupy disjoint bits (0-7, 8-23); bit 31 sums the four parities
    b = s24 & 0xFF
    l = _lookup(tb[0], b)
    h = _lookup(tb[4], b)
    b = (s24 >> 8).bitwise_and_(0xFF)
    l |= _lookup(tb[1], b)
    l |= l_hdr
    h ^= _lookup(tb[2], b)
    b = (s24 >> 16).bitwise_and_(0xFF)
    h ^= _lookup(tb[3], b)
    del b
    h ^= h_hdr.view(T, *extra)
    return l, h


def encode_spdif_block(s24_l, s24_r, start_frame=0,
                       sample_rate: int = 48000):
    """Encode stereo s24 samples into S/PDIF wire words.

    s24_l/s24_r: int32 [T, ...] (trailing batch axes fine).  Returns int32
    [T, 4, ...]: per frame the L-subframe (l, h) then the R-subframe (l,
    h), exactly the DMA word stream the PIO consumes."""
    l, h = spdif_planes(torch.stack([s24_l, s24_r]), start_frame,
                        sample_rate)
    return torch.stack([l[0], h[0], l[1], h[1]], dim=1)


def encode_i2s(s24):
    """I2S 24-in-32 left-justified encode: sample << 8
    (audio_i2s_multi.c:223-226)."""
    return s24.to(_I32) << 8


# ----------------------------------------------------------------------------
# Literal table builder — used only by tests to validate the closed form
# ----------------------------------------------------------------------------


def build_spdif_lookup_reference() -> np.ndarray:
    """The firmware's table build loop (audio_spdif.c:140-153), literal."""
    table = np.zeros(256, np.uint32)
    for i in range(256):
        v = 0x5555
        p = 0
        for j in range(8):
            if i & (1 << j):
                p ^= 1
                v |= 2 << (j * 2)
        table[i] = v | (p << 16)
    return table
