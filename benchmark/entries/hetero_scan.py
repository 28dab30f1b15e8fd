"""Multi-tenant serving on the float chain's scan lowering:
``HeteroServer(..., mxu=False)`` over chained segments.

``hetero``'s cell (tenant presets scattered over the streams by ids drawn
from the seed, each tenant's streams bucketed into its own padded lane
group), on a configuration whose ``lowering`` is ``"scan"``: the server's
grouped engine runs the flat per-lane layout, its float cascades and
crossfeed as per-lane kernel calls.  ``counters()`` adds to ``hetero``'s
the window's launches of those kernels, as the program counts them
(``dspi_tpu_torch.kernels.LAUNCHES``; only a card launches them).

``bf16_coefficients`` is the cell's control: the server's per-lane float
coefficients rounded to bfloat16 and back before the window, the step
below float32 on this path (``harness.run_cell(..., fault=...)``).
"""

from __future__ import annotations

from ..reference import config as ref_config
from . import SegmentCell, sample_lanes
from .hetero import bucket_lanes

KERNELS = ("eq_f32_lane", "xf_f32")
COEFFICIENTS = ("eq_f32", "xf", "loud_sva")


def build(ctx):
    from dspi_tpu_torch.chain import HeteroServer
    from dspi_tpu_torch.kernels import LAUNCHES
    from dspi_tpu_torch.params import types as program_types

    dev = ctx.spec["device"]
    if ctx.spec.get("lowering") != "scan" or dev["platform"] != "rp2350":
        raise ValueError("hetero_scan drives an rp2350 configuration whose "
                         "lowering is \"scan\"")
    t = ctx.traffic
    B, npkt, block = int(t["streams"]), int(t["packets"]), int(t["block"])
    tenants = t["tenants"]
    K = len(tenants)
    ids = ctx.rng(2).integers(0, K, size=B)
    cfgs = [ref_config.build(ctx.spec, program_types, tn) for tn in tenants]
    server = HeteroServer(cfgs, ids, block_size=block, emit="reduced",
                          pdm=True, pdm_fade=False, mxu=False,
                          device=ctx.device)
    if server.grouped.layout != "flat":
        raise ValueError(f"the scan server runs the "
                         f"{server.grouped.layout!r} layout, not \"flat\"")
    width = server.grouped.state.lev_gain.shape[-1] // K
    lanes = sample_lanes(ctx, B)
    state_lanes = bucket_lanes(ids, K, width)[lanes]
    shape = {"samples": npkt * block, "lanes": K * width, "packets": npkt,
             "streams": B, "tenants": K}
    cell = SegmentCell(ctx, server.process, lambda: server.state,
                       lambda st: setattr(server, "state", st),
                       state_lanes, lanes, [tenants[ids[s]] for s in lanes],
                       B, block, npkt, shape)
    cell.server = server
    at_warm = {}
    warm = cell.warm

    def warm_then_mark():
        warm()
        at_warm.update({k: LAUNCHES[k] for k in KERNELS})

    cell.warm = warm_then_mark
    cell.counters = lambda: {
        "lanes": K * width, "streams": B,
        "padding_waste": server.padding_waste,
        **{f"{k}_launches": LAUNCHES[k] - at_warm[k] for k in KERNELS}}
    return cell


def bf16_coefficients(cell) -> None:
    """The control: the server's float cascade, loudness and crossfeed
    coefficients (``COEFFICIENTS``) rounded to bfloat16 and back."""
    import torch

    p = cell.server.params
    cell.server.params = p._replace(**{
        f: getattr(p, f).to(torch.bfloat16).to(torch.float32)
        for f in COEFFICIENTS if getattr(p, f) is not None})
