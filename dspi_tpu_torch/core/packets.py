"""Packet-schedule helpers: a segment of ``Npkt`` packets whose lengths
``sched`` (int NumPy [Npkt]) may differ, as at 44.1 kHz.  Used by the
chain's lowerings (chain/layout.py, chain/mxu.py) and by the kernels'
plain versions (kernels/lev_cuda.py), so it imports neither."""

from __future__ import annotations

import numpy as np
import torch


def _ramp_indices(sched):
    """(t_within_packet, packet) index pair for every flat sample."""
    tt = np.concatenate([np.arange(t, dtype=np.int64) for t in sched])
    kk = np.repeat(np.arange(len(sched), dtype=np.int64), sched)
    return tt, kk


def _pattern_len(sched: np.ndarray):
    """Smallest p with sched = tile(sched[:p]): 1 for uniform packets, 10
    for the 44.1 kHz cadence, None when there is no period."""
    n = len(sched)
    for p in range(1, n // 2 + 1):
        if n % p == 0 and bool((sched == np.tile(sched[:p], n // p)).all()):
            return p
    return None


def _pkts_to_flat(arr, sched, Ttot):
    """[Npkt, Tmax, ...] -> [Ttot, ...], dropping each packet's padded tail
    rows: a reshape for uniform packets, else one static index gather."""
    if _pattern_len(sched) == 1:
        return arr.reshape((Ttot,) + arr.shape[2:])
    tt, kk = _ramp_indices(sched)
    idx = torch.from_numpy(kk * arr.shape[1] + tt).to(arr.device)
    return arr.reshape((-1,) + arr.shape[2:]).index_select(0, idx)
