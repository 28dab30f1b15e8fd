"""Wire-format output stage: S/PDIF (IEC 60958) and I2S word streams.

The JAX package's ``runtime/wire_out.py`` over the port's torch encoders.
Turns the pipeline's s24 outputs into exactly the DMA word streams the
firmware's PIO state machines shift out, honoring each slot's configured
output type (S/PDIF vs I2S, REQ_SET_OUTPUT_TYPE) and tracking the 192-frame
IEC 60958 block position across segments (audio_spdif.c:384-401).  The
words are made where the s24 tensor lies, as int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..kernels import encoders


class WireEncoder:
    """Stateful per-engine wire encoder (block-position tracking)."""

    def __init__(self, cfg, block_size: int):
        self.platform = cfg.platform
        self.sample_rate = int(cfg.sample_rate)
        self.output_types = list(cfg.hardware.output_types)
        self.block_size = block_size
        self.frame_pos = 0            # position within the 192-frame block

    def apply_types(self, output_types) -> bool:
        """Mid-stream S/PDIF<->I2S switch (process_type_switches,
        main.c:230-423): when any slot's type changes the firmware tears
        the instances down and restarts them cycle-synchronized, which
        resets the IEC 60958 block position.  Returns True on a switch."""
        new = list(output_types)
        if new == self.output_types:
            return False
        self.output_types = new
        self.frame_pos = 0
        return True

    def encode(self, s24):
        """s24: int32 [n_packets, 2*n_spdif, T, B] from the pipeline (a
        tensor, or an array taken to the CPU).

        Returns a dict with per-pair word streams, int32 bit patterns on
        the s24 tensor's device:
          * S/PDIF pairs: [Ttot, 4, B]  (subframe l/h pairs)
          * I2S pairs:    [Ttot, 2, B]  (L, R words)
        keyed as 'pair0'..'pairN'.  Advances the IEC block position.
        """
        if not isinstance(s24, torch.Tensor):
            s24 = torch.from_numpy(np.ascontiguousarray(s24, np.int32))
        npkt, ns2, T, B = s24.shape
        ttot = npkt * T
        flat = s24.movedim(1, 0).reshape(ns2, ttot, B)
        out = {}
        for pair in range(C.NUM_SPDIF_INSTANCES[self.platform]):
            sl, sr = flat[pair * 2], flat[pair * 2 + 1]
            if self.output_types[pair] == 1:     # I2S
                words = torch.stack([encoders.encode_i2s(sl),
                                     encoders.encode_i2s(sr)], dim=1)
            else:                                # S/PDIF
                words = encoders.encode_spdif_block(
                    sl, sr, start_frame=self.frame_pos,
                    sample_rate=self.sample_rate)
            out[f"pair{pair}"] = words
        self.frame_pos = (self.frame_pos + ttot) % C.SPDIF_BLOCK_FRAMES
        return out
