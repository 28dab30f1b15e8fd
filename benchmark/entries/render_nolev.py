"""Offline rendering of a chain with the leveller switched off: ``render``'s
cell, whose reference tasks get the lookahead ring the program does not
carry.

With the leveller off the program keeps no lookahead ring (its state leaf
``lev_la`` is None), while the reference sets every leaf of its golden
instance from the program's state (``reference.lanes.state_to_golden``).
The golden instance never reads the ring with the leveller off, so each
task that starts from the program's state is given the ring the
configuration starts with, zeros.  Nothing of the measured window
changes: the tasks are made after it, and the comparison reads only the
leaves the program carries.
"""

from __future__ import annotations

import numpy as np

from ..reference import constants as C
from . import render


def build(ctx):
    if ctx.spec["device"]["leveller"]["enabled"]:
        raise ValueError("render_nolev drives a chain with the leveller off")
    cell = render.build(ctx)
    task = cell._task
    ring = np.zeros((2, C.LEVELLER_LOOKAHEAD_SAMPLES), np.float32)

    def with_ring(lane_k, segs, state):
        if state is not None and "lev_la" not in state:
            state = {**state, "lev_la": ring}
        return task(lane_k, segs, state)

    cell._task = with_ring
    return cell
