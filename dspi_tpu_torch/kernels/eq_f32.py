"""The float EQ cascades of the RP2350 chain: the plain PyTorch version.

G independent cascades run over one segment, each in the firmware's
float32 arithmetic (dsp_pipeline.c:282-365, usb_audio.c:690-702,
leveller.c:150-156).  Each cascade has

  * an optional 2-filter loudness prefix, general SVFs with run-time
    bypass flags (a bypassed filter freezes its output and its state);
  * ``nb`` bands, each of its own kind (``kinds``): a TDF2 biquad or an
    SVF with the low-pass, high-pass, peaking or shelf output mix; a
    ``SKIP`` band passes its input through and keeps its state (it pads
    a cascade to the call's ``nb``);
  * an optional leveller RMS envelope ``a*env + (1-a)*x*x``, flushed to
    0 below 1e-30 on each packet's last sample only and read out there.

This is what the JAX package's float scan lowering runs as ``lax.scan``
(dspi_tpu/chain/pipeline.py:418-485 scan A: loudness, master EQ and the
envelope; :626-639 scan B: the per-output EQ).  The layout mirrors the Q28
cascades of ``kernels/eq.py``: x float32 [G, T, B]; s0 float32 [G, S, B]
with S = 2*(n_loud+nb) + has_env, rows in the order loudness (ic1, ic2)
pairs, band state pairs ((s1, s2) for TDF2, (ic1, ic2) for an SVF),
envelope; ``kinds`` a tuple of G tuples of ``nb`` band kinds (static).
Coefficients come in one of two forms:

  * per cascade: cf float32 [G, n_loud+nb, 11] rows (sva1, sva2, sva3,
    svm0, svm1, svm2, b0, b1, b2, a1, a2; a loudness row uses the first
    six) and scal float32 [G, 4] = (bypass0, bypass1, a_rms, 1 - a_rms),
    a bypass flag set where it is not 0;
  * per lane (the per-stream serving layout): cf [G, n_loud+nb, 11, B]
    and scal [G, 4, B].

Packets are ``tc`` samples each, or, with ``sched`` (a tuple of packet
lengths summing to T, e.g. the 44.1 kHz 44/45 cadence), of variable
length.  Returns (y [G, T, B], env_ends [G, Npkt, B] | None, s_final
[G, S, B]).

``f32_cascades_plain`` is a Python loop over samples in which every
multiply and add is its own torch op over all G cascades and B streams,
so that each rounds as the firmware's does; where the cascades' kinds
differ at a band, each kind's step runs over all of them and a select
keeps each cascade's own.  The CUDA kernel (``csrc/eq_f32.cu``) is held to
it bit for bit.  Its band steps, ``band_step_f32`` and ``svf_general_f32``,
are the twins of the JAX package's ``_band_step_f32`` and
``_svf_general_f32`` (chain/pipeline.py:91-146); the block-matmul
lowering (chain/mxu.py) builds its matrices from them too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from .eq import packet_ends

_F32 = torch.float32
_TINY = float(np.float32(1e-30))

# band kind tags, as chain/pack.py's
SKIP, TDF2, SVF_LP, SVF_HP, SVF_PEAK, SVF_SHELF = range(6)


def band_step_f32(kind: int, cf, s, xin):
    """One band, one sample (dsp_pipeline.c:298-364).

    cf: the [11] coefficient row (anything indexable: its columns may be
    tensors that broadcast); s: the (a, b) state pair; returns (out, s')."""
    if kind == TDF2:
        b0, b1, b2, a1, a2 = cf[6], cf[7], cf[8], cf[9], cf[10]
        s1, s2 = s
        out = b0 * xin + s1
        s1n = b1 * xin - a1 * out + s2
        s2n = b2 * xin - a2 * out
        return out, (s1n, s2n)
    a1, a2, a3 = cf[0], cf[1], cf[2]
    m0, m1, m2 = cf[3], cf[4], cf[5]
    ic1, ic2 = s
    v3 = xin - ic2
    v1 = a1 * ic1 + a2 * v3
    v2 = ic2 + a2 * ic1 + a3 * v3
    ic1n = 2.0 * v1 - ic1
    ic2n = 2.0 * v2 - ic2
    if kind == SVF_LP:
        out = v2
    elif kind == SVF_HP:
        out = xin + m1 * v1 - v2
    elif kind == SVF_PEAK:
        out = xin + m1 * v1
    else:
        out = m0 * xin + m1 * v1 + m2 * v2
    return out, (ic1n, ic2n)


def svf_general_f32(cf_row, s, xin, bypass):
    """Loudness shelf: general SVF mix with run-time bypass
    (usb_audio.c:697-702).  When bypassed, both state and output freeze."""
    sva1, sva2, sva3, svm0, svm1, svm2 = (cf_row[0], cf_row[1], cf_row[2],
                                          cf_row[3], cf_row[4], cf_row[5])
    ic1, ic2 = s
    v3 = xin - ic2
    v1 = sva1 * ic1 + sva2 * v3
    v2 = ic2 + sva2 * ic1 + sva3 * v3
    ic1n = 2.0 * v1 - ic1
    ic2n = 2.0 * v2 - ic2
    out = svm0 * xin + svm1 * v1 + svm2 * v2
    return (torch.where(bypass, xin, out),
            (torch.where(bypass, ic1, ic1n), torch.where(bypass, ic2, ic2n)))


def check_f32_args(x, cf, s0, scal, *, kinds, has_loud, has_env, tc,
                   sched):
    """Raise on anything the float cascades do not take; return (G, T, B,
    S, nb, ends), ``ends`` the packet-end indices of the envelope (None
    without one)."""
    for name, v in (("x", x), ("cf", cf), ("s0", s0), ("scal", scal)):
        if v.dtype != _F32:
            raise TypeError(f"f32_cascades wants float32 {name}, got "
                            f"{v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [G, T, B], got {tuple(x.shape)}")
    G, T, B = x.shape
    kinds = tuple(tuple(k) for k in kinds)
    if len(kinds) != G or len({len(k) for k in kinds}) > 1:
        raise ValueError(f"kinds must be G={G} rows of one length, got "
                         f"{kinds}")
    nb = len(kinds[0]) if kinds else 0
    if not 0 <= nb <= C.MAX_BANDS:
        raise ValueError(f"nb={nb} outside 0..{C.MAX_BANDS}")
    if any(k not in range(6) for row in kinds for k in row):
        raise ValueError(f"unknown band kind in {kinds}")
    nr = (2 if has_loud else 0) + nb
    S = 2 * nr + (1 if has_env else 0)
    lane = cf.dim() == 4
    want = {"cf": (G, nr, 11, B) if lane else (G, nr, 11), "s0": (G, S, B),
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
    return G, T, B, S, nb, packet_ends(T, tc, sched) if has_env else None


def f32_cascades_plain(x, cf, s0, scal, *, kinds, has_loud=False,
                       has_env=False, tc=48, sched=None):
    """Plain version of the float cascade kernel (signature and layout
    above)."""
    G, T, B, S, nb, ends = check_f32_args(
        x, cf, s0, scal, kinds=kinds, has_loud=has_loud, has_env=has_env,
        tc=tc, sched=sched)
    n_loud = 2 if has_loud else 0
    # per-cascade columns [G, 1] broadcast over the streams; per-lane
    # columns are [G, B]
    col = (lambda v: v) if cf.dim() == 4 else (lambda v: v[:, None])
    cols = [tuple(col(cf[:, j, k]) for k in range(11))
            for j in range(n_loud + nb)]
    byp = [col(scal[:, j]) != 0 for j in range(n_loud)]
    a_rms, one_minus = col(scal[:, 2]), col(scal[:, 3])
    # each band's kinds over the cascades; where they differ, a [G, 1]
    # mask a kind selects each cascade's own step
    plans = []
    for j in range(nb):
        ks = [row[j] for row in kinds]
        live = sorted(set(ks) - {SKIP})
        masks = None if len(set(ks)) == 1 else {
            k: torch.tensor([v == k for v in ks], device=x.device)[:, None]
            for k in live}
        plans.append((live, masks))
    st = list(s0.unbind(1))                                  # S x [G, B]
    y = torch.empty_like(x)
    env = (torch.empty((G, len(ends), B), dtype=_F32, device=x.device)
           if has_env else None)
    pkt_of_end = {e: i for i, e in enumerate(ends or ())}
    for t in range(T):
        cur = x[:, t]
        for j in range(n_loud):
            cur, (st[2 * j], st[2 * j + 1]) = svf_general_f32(
                cols[j], (st[2 * j], st[2 * j + 1]), cur, byp[j])
        for j, (live, masks) in enumerate(plans):
            r = n_loud + j
            s = (st[2 * r], st[2 * r + 1])
            new_cur, new_s = cur, s
            for kind in live:
                out, sn = band_step_f32(kind, cols[r], s, cur)
                if masks is None:
                    new_cur, new_s = out, sn
                else:
                    m = masks[kind]
                    new_cur = torch.where(m, out, new_cur)
                    new_s = tuple(torch.where(m, u, v)
                                  for u, v in zip(sn, new_s))
            cur = new_cur
            st[2 * r], st[2 * r + 1] = new_s
        if has_env:
            e = a_rms * st[-1] + one_minus * (cur * cur)
            if t in pkt_of_end:
                e = torch.where(e < _TINY, torch.zeros_like(e), e)
                env[:, pkt_of_end[t]] = e
            st[-1] = e
        y[:, t] = cur
    return y, env, (torch.stack(st, dim=1) if S else s0.clone())
