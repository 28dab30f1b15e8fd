"""Offline rendering: ``Engine.segment_fn`` over chained segments.

One ``Engine`` of the cell's configuration over all its streams
(``emit="reduced"``, the PDM sub on without its fade-in, no wire words),
driven as the port's own benchmark drives it: segments chained with the
state carried through the whole run, one readback of the folded acks
every ``readback_every`` segments.
"""

from __future__ import annotations

import torch

from ..reference import config as ref_config
from . import SegmentCell, sample_lanes


def build(ctx):
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.params import types as program_types

    t = ctx.traffic
    B, npkt, block = int(t["streams"]), int(t["packets"]), int(t["block"])
    eng = Engine(ref_config.build(ctx.spec, program_types), n_streams=B,
                 block_size=block, emit="reduced", pdm=True, pdm_fade=False,
                 device=ctx.device)
    seg, params = eng.segment_fn, eng.params
    pm = torch.ones(npkt, dtype=torch.float32, device=ctx.device)

    def run_segment(x):
        eng.state, out = seg(params, eng.state, x, pm)
        return out

    lanes = sample_lanes(ctx, B)
    shape = {"samples": npkt * block, "lanes": B, "packets": npkt,
             "streams": B}
    return SegmentCell(ctx, run_segment, lambda: eng.state,
                       lambda st: setattr(eng, "state", st), lanes, lanes,
                       None, B, block, npkt, shape)
