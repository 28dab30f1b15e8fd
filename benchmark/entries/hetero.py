"""Multi-tenant serving: ``HeteroServer.process`` over chained segments.

The configuration's tenant presets (``traffic["tenants"]``, each a rule on
the configuration file's values) are scattered over the streams by ids
drawn from the seed; the server buckets each tenant's streams into its
own padded lane group and scatters the outputs back.  The check takes the
sampled streams' state from the bucket layout that the benchmark works
out again from the ids (each tenant's streams in order, buckets as wide as
the server makes them).
"""

from __future__ import annotations

import numpy as np

from ..reference import config as ref_config
from . import SegmentCell, sample_lanes


def bucket_lanes(ids: np.ndarray, K: int, width: int) -> np.ndarray:
    """Each stream's lane in the bucket layout: tenant k's streams, in
    stream order, at k * width onwards."""
    lane = np.zeros(len(ids), np.int64)
    for k in range(K):
        idx = np.where(ids == k)[0]
        lane[idx] = k * width + np.arange(len(idx))
    return lane


def build(ctx):
    from dspi_tpu_torch.chain import HeteroServer
    from dspi_tpu_torch.params import types as program_types

    t = ctx.traffic
    B, npkt, block = int(t["streams"]), int(t["packets"]), int(t["block"])
    tenants = t["tenants"]
    K = len(tenants)
    ids = ctx.rng(2).integers(0, K, size=B)
    cfgs = [ref_config.build(ctx.spec, program_types, tn) for tn in tenants]
    server = HeteroServer(cfgs, ids, block_size=block, emit="reduced",
                          pdm=True, pdm_fade=False, device=ctx.device)
    width = server.grouped.state.lev_gain.shape[-1] // K
    lanes = sample_lanes(ctx, B)
    state_lanes = bucket_lanes(ids, K, width)[lanes]
    shape = {"samples": npkt * block, "lanes": K * width, "packets": npkt,
             "streams": B, "tenants": K}
    cell = SegmentCell(ctx, server.process, lambda: server.state,
                       lambda st: setattr(server, "state", st),
                       state_lanes, lanes, [tenants[ids[s]] for s in lanes],
                       B, block, npkt, shape)
    cell.counters = lambda: {"lanes": K * width, "streams": B,
                             "padding_waste": server.padding_waste}
    return cell
