"""The Q28 EQ cascades of the RP2040 chain: the plain PyTorch version.

G independent cascades run over one segment, each in the firmware's
truncating ``fast_mul_q28`` arithmetic (dsp_process_rp2040.S:225-394,
usb_audio.c:1022-1100).  Each cascade has

  * an optional 2-filter loudness prefix with run-time bypass flags (a
    bypassed filter freezes its output and its state);
  * ``nb`` TDF2 bands;
  * an optional leveller RMS envelope (leveller.c:150-156, Q28 form),
    read out at the last sample of every packet.

Layout, as the JAX package's front door ``kernels/eq_pallas.py``
``q28_cascades`` has it: x int32 [G, T, B]; s0 int32 [G, S, B] with S =
2*(n_loud+nb) + has_env, rows in the order loudness (s1, s2) pairs, band
(s1, s2) pairs, envelope.  Coefficients come in one of two forms:

  * per cascade: cf int32 [G, n_loud+nb, 5] rows (b0, b1, b2, a1, a2) and
    scal int32 [G, 4] = (bypass0, bypass1, a_rms, one_minus);
  * per lane (``lane_cf``, the per-stream serving layout): cf int32
    [G, n_loud+nb, 5, B] and scal int32 [G, 4, B], every stream its own
    coefficients, bypass flags and envelope alphas.

Packets are ``tc`` samples each, or, with ``sched`` (a tuple of packet
lengths summing to T, e.g. the 44.1 kHz 44/45 cadence), of variable
length; the envelope is read at each packet's last sample,
``cumsum(sched) - 1``, as ``eq_pallas.py:352-354`` gathers it.  Returns
(y [G, T, B], env_ends [G, Npkt, B] | None, s_final [G, S, B]).

``q28_cascades_plain`` is a Python loop over samples in which one step is
one torch op per band row for all G cascades and B streams at once; the
CUDA kernel (``csrc/eq_q28.cu``) is held to it word for word.

Its band steps, ``band_step_q28`` and ``tdf2_q28_bypassable``
(dsp_process_rp2040.S:263-365), are twins of the JAX package's
``_band_step_q28`` and ``_tdf2_q28_bypassable`` (chain/pipeline.py).  Their
operands broadcast, so one call steps any number of cascades and streams
at once: the plain cascade passes coefficient columns of shape [G, 1] (or
[G, B] per lane) and states of shape [G, B].
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.qmath import q28_mul

_I32 = torch.int32


def band_step_q28(cf, s, xin):
    """One band, one sample: cf = (b0, b1, b2, a1, a2), s = (s1, s2).
    Returns (out, (s1', s2'))."""
    b0, b1, b2, a1, a2 = cf
    s1, s2 = s
    out = q28_mul(b0, xin) + s1
    s1n = (q28_mul(b1, xin) - q28_mul(a1, out)) + s2
    s2n = q28_mul(b2, xin) - q28_mul(a2, out)
    return out, (s1n, s2n)


def tdf2_q28_bypassable(cf, s, xin, bypass):
    """Loudness biquad with a run-time bypass (usb_audio.c:1022-1031): a
    bypassed filter freezes both its output and its state."""
    out, (s1n, s2n) = band_step_q28(cf, s, xin)
    return (torch.where(bypass, xin, out),
            (torch.where(bypass, s[0], s1n), torch.where(bypass, s[1], s2n)))


def packet_ends(T, tc, sched):
    """Last sample index of every packet: ``cumsum(sched) - 1``, or every
    ``tc``-th sample for uniform packets."""
    if sched:
        return tuple(int(e) for e in np.cumsum(sched) - 1)
    return tuple(range(tc - 1, T, tc))


def check_cascade_args(x, cf, s0, scal, *, nb, has_loud, has_env, tc,
                       sched):
    """Raise on anything the cascades do not take; return (G, T, B, S,
    ends), ``ends`` the packet-end indices of the envelope (None without
    one)."""
    for name, v in (("x", x), ("cf", cf), ("s0", s0), ("scal", scal)):
        if v.dtype != _I32:
            raise TypeError(f"q28_cascades wants int32 {name}, got {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
    if not 0 <= nb <= C.MAX_BANDS:
        raise ValueError(f"nb={nb} outside 0..{C.MAX_BANDS}")
    if x.dim() != 3:
        raise ValueError(f"x must be [G, T, B], got {tuple(x.shape)}")
    G, T, B = x.shape
    nr = (2 if has_loud else 0) + nb
    S = 2 * nr + (1 if has_env else 0)
    lane = cf.dim() == 4
    want = {"cf": (G, nr, 5, B) if lane else (G, nr, 5), "s0": (G, S, B),
            "scal": (G, 4, B) if lane else (G, 4)}
    for name, v in (("cf", cf), ("s0", s0), ("scal", scal)):
        if tuple(v.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(v.shape)}")
    if sched:
        if min(sched) < 1 or sum(sched) != T:
            raise ValueError(f"the schedule's packets must be >= 1 sample "
                             f"and sum to T={T}, got {tuple(sched)}")
    elif has_env and (tc < 1 or T % tc):
        raise ValueError(f"the envelope needs whole packets: T={T}, tc={tc}")
    return G, T, B, S, packet_ends(T, tc, sched) if has_env else None


def q28_cascades_plain(x, cf, s0, scal, *, nb, has_loud=False,
                       has_env=False, tc=48, sched=None):
    """Plain version of the cascade kernel (signature and layout above)."""
    G, T, B, S, ends = check_cascade_args(
        x, cf, s0, scal, nb=nb, has_loud=has_loud, has_env=has_env, tc=tc,
        sched=sched)
    n_loud = 2 if has_loud else 0
    # per-cascade columns [G, 1] broadcast over the streams; per-lane
    # columns are [G, B]
    col = (lambda v: v) if cf.dim() == 4 else (lambda v: v[:, None])
    cols = [tuple(col(cf[:, j, k]) for k in range(5))
            for j in range(n_loud + nb)]
    byp = [col(scal[:, j]) != 0 for j in range(n_loud)]
    a_rms, one_minus = col(scal[:, 2]), col(scal[:, 3])
    st = list(s0.unbind(1))                                  # S x [G, B]
    y = torch.empty_like(x)
    env = (torch.empty((G, len(ends), B), dtype=_I32, device=x.device)
           if has_env else None)
    pkt_of_end = {e: i for i, e in enumerate(ends or ())}
    for t in range(T):
        cur = x[:, t]
        for j in range(n_loud + nb):
            s = (st[2 * j], st[2 * j + 1])
            if j < n_loud:
                cur, s = tdf2_q28_bypassable(cols[j], s, cur, byp[j])
            else:
                cur, s = band_step_q28(cols[j], s, cur)
            st[2 * j], st[2 * j + 1] = s
        if has_env:
            st[-1] = (q28_mul(a_rms, st[-1])
                      + q28_mul(one_minus, q28_mul(cur, cur)))
            if t in pkt_of_end:
                env[:, pkt_of_end[t]] = st[-1]
        y[:, t] = cur
    return y, env, (torch.stack(st, dim=1) if S else s0.clone())
