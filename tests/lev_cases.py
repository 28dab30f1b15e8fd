"""Inputs of the leveller's packet recurrence (``kernels.lev_cuda``) for
the CPU and the card tests: seeded gain-computer targets, alpha tables and
start gains, with edge values among them.  Imports neither JAX nor the JAX
package, so the card tests can use it on a host that has only PyTorch."""

from __future__ import annotations

import numpy as np

from dspi_tpu_torch.chain import packet_geometry

MIN_NORMAL = np.float32(1.1754944e-38)
# targets beside the gain computer's own range: zeros of both signs,
# denormals (flushed on entry by mul_det), the smallest normals, huge
# values and one far below the gate
EDGE_GC = np.array([0.0, -0.0, 1e-40, -1e-40, MIN_NORMAL, -MIN_NORMAL,
                    3.0e38, -3.0e38, 1e30, -65.0], np.float32)


def counts(npkt: int, rate: float) -> np.ndarray:
    """Each packet's length: 48 at 48 kHz, the 44/45 cadence at 44.1
    (cut to ``npkt``)."""
    sched = packet_geometry(rate, npkt)[1]
    return np.full(npkt, 48) if sched is None else np.asarray(sched[:npkt])


def case(npkt: int, B: int, lane: bool, rate: float, seed: int):
    """(gc [npkt, B], pow_att, pow_rel [npkt, 1] or with ``lane`` [npkt, B],
    gdb0 [B]), float32 numpy.  Targets in the gain computer's range, a
    quarter of them the gate's zeros, 5% edge values; 5% of the alphas are
    exactly 0, 1 or 0.5.  Fixed lanes (B >= 5): 0 all zeros from 0; 1 the
    target equal to the start gain; 2 denormal targets; 3 huge targets
    from a huge start; 4 a first packet whose two products cancel to a
    denormal sum (alpha 0.5 in row 0 of every table)."""
    rng = np.random.default_rng(seed)
    gc = rng.uniform(-24.0, 12.0, (npkt, B)).astype(np.float32)
    gc[rng.random((npkt, B)) < 0.25] = 0.0
    m = rng.random((npkt, B)) < 0.05
    gc[m] = rng.choice(EDGE_GC, int(m.sum()))
    gdb0 = rng.uniform(-20.0, 10.0, B).astype(np.float32)
    n = counts(npkt, rate).astype(np.float64)[:, None]
    cols = B if lane else 1
    tables = []
    for lo, hi in ((0.95, 0.9999), (0.99, 0.99999)):
        a = rng.uniform(lo, hi, cols)[None, :]
        t = (a ** n).astype(np.float32)
        m = rng.random(t.shape) < 0.05
        t[m] = rng.choice(np.array([0.0, 1.0, 0.5], np.float32),
                          int(m.sum()))
        t[0] = 0.5
        tables.append(t)
    if B >= 5:
        gc[:, 0], gdb0[0] = 0.0, 0.0
        gc[:, 1] = gdb0[1]
        gc[:, 2] = np.where(np.arange(npkt) % 2, 1e-40, -1e-40)
        gdb0[2] = 1e-40
        gc[:, 3] = np.where(np.arange(npkt) % 3, 3.0e38, -3.0e38)
        gdb0[3] = 3.3e38
        gdb0[4], gc[0, 4] = 2.4e-38, -2.38e-38
    return gc, tables[0], tables[1], gdb0


def denormal_first(gdbs: np.ndarray) -> bool:
    """Whether lane 4's first smoothed gain is the denormal sum that
    ``case`` sets up there."""
    v = np.float32(gdbs[0, 4])
    return bool(0 < abs(v) < MIN_NORMAL)
