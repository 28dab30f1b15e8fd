"""Offline rendering on a packet schedule: ``Engine.segment_fn`` over
chained segments of the 44.1 kHz 44/45 cadence.

``render``'s cell on a configuration whose rate gives a schedule:
the engine is built with ``packet_geometry(rate, packets)``'s block size
and schedule (130 packets: 13 groups of nine 44-sample packets and one of
45, 5,733 samples a segment), takes x time-flat, [2, Ttot, B], and its
preset-mute gains one a real packet.  The reference is handed each
stream's packets at their own lengths, one [2, n] array a packet, so the
golden model meets the same packet grid as the firmware: the leveller
computes one gain a packet (``leveller.c:147-262``).

``counters()`` gives the block lowering's carry steps since ``warm()``
(``dspi_tpu_torch.chain.mxu.COUNTS``), where the program keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import config as ref_config
from . import SegmentCell, sample_lanes


class SchedCell(SegmentCell):
    """A ``SegmentCell`` whose segment is one time-flat block of the
    schedule's ``Ttot`` samples: the base cell draws its input as one
    packet of ``Ttot`` samples, [1, 2, Ttot, B], whose packet is the x a
    scheduled chain takes; the reference's tasks split it at the packet
    ends again."""

    def __init__(self, ctx, eng, schedule, lanes, shape):
        seg = eng.segment_fn
        params = eng.params
        B, ttot = eng.n_streams, int(sum(schedule))
        pm = torch.ones(len(schedule), dtype=torch.float32,
                        device=ctx.device)

        def run_segment(x):
            eng.state, out = seg(params, eng.state, x, pm)
            return out

        super().__init__(ctx, run_segment, lambda: eng.state,
                         lambda st: setattr(eng, "state", st), lanes, lanes,
                         None, B, ttot, 1, shape)
        self.x, self.x_lanes = self.x[0], self.x_lanes[0]
        self.block, self.npkt = eng.static.block_size, len(schedule)
        self.schedule = tuple(schedule)

    @staticmethod
    def _carry_steps():
        """The program's carry-step count, None where it keeps none."""
        from dspi_tpu_torch.chain import mxu

        counts = getattr(mxu, "COUNTS", None)
        return None if counts is None else counts["carry_steps"]

    def warm(self):
        super().warm()
        self._steps_at_warm = self._carry_steps()

    def counters(self) -> dict:
        now = self._carry_steps()
        return {} if now is None else {
            "carry_steps": now - self._steps_at_warm}

    def _packets(self, x) -> np.ndarray:
        """One stream's segment [2, Ttot] as the reference's packets: an
        object array of [2, n] arrays, n the schedule's lengths."""
        parts = np.split(x, np.cumsum(self.schedule)[:-1], axis=1)
        pk = np.empty(len(parts), dtype=object)
        for i, part in enumerate(parts):
            pk[i] = part
        return pk

    def _task(self, lane_k: int, segs, state) -> dict:
        return {"spec": self.ctx.spec, "block": self.block,
                "xs": [self._packets(self.x_lanes[..., lane_k] ^ i)
                       for i in segs],
                "state": state, "tenant": None}


def build(ctx):
    from dspi_tpu_torch.chain import Engine, packet_geometry
    from dspi_tpu_torch.params import types as program_types

    t = ctx.traffic
    B, npkt = int(t["streams"]), int(t["packets"])
    block, schedule = packet_geometry(ctx.spec["device"]["sample_rate"],
                                      npkt)
    if schedule is None:
        raise ValueError("render_sched drives a rate with a packet "
                         "schedule (44.1 kHz)")
    eng = Engine(ref_config.build(ctx.spec, program_types), n_streams=B,
                 block_size=block, emit="reduced", pdm=True, pdm_fade=False,
                 schedule=schedule, device=ctx.device)
    lanes = sample_lanes(ctx, B)
    shape = {"samples": int(sum(schedule)), "lanes": B,
             "packets": len(schedule), "streams": B}
    return SchedCell(ctx, eng, schedule, lanes, shape)
