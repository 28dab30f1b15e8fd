"""The batched pipeline: PASS 1-5 of process_audio_packet in PyTorch.

One call processes a *segment* of ``n_packets`` emulated USB packets of
``block_size`` samples for ``B`` independent streams at once:

    x: int32 [n_packets, 2, block_size, B]  ->  outputs [..., B]

A chain with a packet schedule (``static.schedule``, the 44.1 kHz 44/45
cadence) takes the time-flat x int32 [2, sum(schedule), B] instead.

``process_float`` is the RP2350 float chain, the JAX package's
``_process_float`` (chain/pipeline.py) on either of its lowerings.  On the
block-matmul lowering (``static.mxu``) the LTI passes (loudness + master
EQ, crossfeed + matrix + per-output EQ) run as per-packet block matrices
(chain/mxu.py), the leveller envelope as a weighted block reduction; the
matrix products re-round what the firmware computes sequentially, so it
is held to <= 1e-6 relative RMS against the firmware-semantics golden
model, and it takes per-group block matrices over K contiguous lane
groups for grouped serving.  On the scan lowering (``mxu=False``) the
per-sample recurrences run as they are written: loudness, master EQ and
the envelope as one float cascade kernel call (kernels/eq_f32_cuda.py),
the crossfeed as its own kernel (kernels/xf_f32_cuda.py), the matrix mix
as tensor ops, the per-output EQ as a second cascade call; every float
operation rounds on its own, and any leaf of the params may carry a
trailing [B] stream axis (per-stream parameters).  The rest runs as
whole-segment tensor ops on both.  Both take packet schedules.

``process_q28`` is the RP2040 Q28 chain, the JAX package's
``_process_q28``, bit-exact: both EQ scans run as the Q28 cascade kernel
(kernels/eq_cuda.py), the crossfeed as its own kernel (kernels/xf_cuda.py),
and the rest as whole-segment integer tensor ops.  It takes per-stream
parameters (``pack.build_params_multi``: any leaf may carry a trailing
[B] stream axis) and packet schedules.

In both, the leveller's packet-rate gain smoothing is a Python loop over
packets, the PDM modulator is the CUDA kernel (kernels/pdm_cuda.py) and,
with ``static.wire``, the s24 samples become the S/PDIF or I2S wire words
(kernels/encoders.py) on the device.

  PASS 1  unpack + preamp + loudness            usb_audio.c:590-718 / 996-1047
  PASS 2  master EQ block                       dsp_pipeline.c:282-365 / .S
  PASS 2.5 leveller                             leveller.c:147-262 / 274-389
  PASS 3  crossfeed + master peaks              usb_audio.c:737-749 / 1064-1073
  PASS 4  matrix mix                            usb_audio.c:751-779 / 1075-1100
  PASS 5  per-output EQ/gain/delay/convert      usb_audio.c:873-959 / 1191-1275
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core import fmath
from ..core.qmath import f32_to_i32, q15_mul, q28_mul, q28_to_s24, wrap32
from ..kernels import encoders
from ..kernels.eq_cuda import q28_cascades
from ..kernels.eq_f32_cuda import f32_cascades
from ..kernels.pdm_cuda import pdm_segment
from ..kernels.xf_cuda import xf_q28
from ..kernels.xf_f32_cuda import xf_f32
from ..runtime.telemetry import span
from .pack import SKIP, TDF2, StaticChain

_F32 = torch.float32
_I32 = torch.int32
_INV20 = float(np.float32(1.0) / np.float32(20.0))


# ----------------------------------------------------------------------------
# structure and layout helpers
# ----------------------------------------------------------------------------


def _active_bands(static: StaticChain, channels):
    """(ch, band, kind) for every non-skipped band of the given channels."""
    out = []
    for ch in channels:
        for band, kind in enumerate(static.band_kinds[ch]):
            if kind != SKIP:
                out.append((ch, band, kind))
    return out


def _chain_structure(static: StaticChain):
    """Which master bands and which output bands are live.  On RP2040,
    bypass_master_eq gates the per-output EQ too (usb_audio.c:1200)."""
    nout = static.n_outputs
    master_bands = _active_bands(
        static, [ch for ch in (0, 1)
                 if not static.bypass_master_eq
                 and not static.channel_bypassed[ch]])
    if not static.is_float and static.bypass_master_eq:
        return master_bands, []
    out_channels = [
        C.CH_OUT_1 + o for o in range(nout)
        if static.output_enabled[o] and not static.output_mute[o]
        and not static.channel_bypassed[C.CH_OUT_1 + o]]
    return master_bands, _active_bands(static, out_channels)


def _gather_states(state, bands):
    """(a, b) state pair per band: SVF bands keep eq_c/eq_d, TDF2 eq_a/eq_b."""
    init = []
    for ch, band, kind in bands:
        if kind != TDF2:
            init.append((state.eq_c[ch, band], state.eq_d[ch, band]))
        else:
            init.append((state.eq_a[ch, band], state.eq_b[ch, band]))
    return tuple(init)


def _scatter_states(state, bands, finals):
    """Write final band states back, one indexed write per state array.
    The arrays are this segment's own copies (``process_float`` and
    ``process_q28`` clone them), so the writes are in place."""
    groups = {}
    for (ch, band, kind), (sa, sb) in zip(bands, finals):
        fa, fb = ("eq_a", "eq_b") if kind == TDF2 else ("eq_c", "eq_d")
        for f, row in ((fa, sa), (fb, sb)):
            cs, bs, vs = groups.setdefault(f, ([], [], []))
            cs.append(ch)
            bs.append(band)
            vs.append(row)
    for f, (cs, bs, vs) in groups.items():
        getattr(state, f)[cs, bs] = torch.stack(vs)
    return state


def _delay_apply(ring_k, buf, dly, T, D):
    """One output's delayed read over a whole segment (usb_audio.c:897-911).

    Rings are time-ordered (oldest first): the delayed stream is a window
    of concat(ring, buf) starting at D - dly.  ``dly`` stays a device
    tensor (an index_select, not a host read), so the host never waits on
    the card here.  A per-stream delay ([B]) reads through one gather over
    [D+T, B], its index built once.  Returns (delayed [T, B], ring' [D, B])."""
    comb = torch.cat([ring_k, buf], dim=0)                # [D+T, B]
    t = torch.arange(T, device=buf.device)
    start = D - dly.to(torch.int64)
    if start.dim() == 0:
        delayed = comb.index_select(0, start + t)
    else:
        delayed = torch.gather(comb, 0, start[None, :] + t[:, None])
    ring_new = buf[T - D:] if T >= D else comb[T:]
    return delayed, ring_new


def _segment_layout(static: StaticChain, x):
    """Resolve the packet schedule.  Uniform chains take x as [Npkt, 2, T,
    B]; scheduled chains (``static.schedule``, e.g. the 44.1 kHz 44/45
    cadence) the time-flat [2, Ttot, B].  Returns (x2 [2, Ttot, B], sched
    int64 NumPy [Npkt] of packet lengths, Npkt, Ttot)."""
    if static.schedule:
        sched = np.asarray(static.schedule, np.int64)
        Ttot = int(sched.sum())
        if x.dim() != 3 or x.shape[:2] != (2, Ttot):
            raise ValueError(f"a scheduled chain takes x [2, {Ttot}, B], "
                             f"got {tuple(x.shape)}")
        return x, sched, len(sched), Ttot
    Npkt, _, T, B = x.shape
    sched = np.full(Npkt, T, np.int64)
    return x.transpose(0, 1).reshape(2, Npkt * T, B), sched, Npkt, Npkt * T


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


def _per_packet(vals, sched, Ttot):
    """Broadcast a per-packet [Npkt, 1|B] array to [Ttot, 1|B] along the
    schedule."""
    reps = torch.from_numpy(sched).to(vals.device)
    return torch.repeat_interleave(vals, reps, dim=0, output_size=Ttot)


def _unflatten(arrs, Npkt, T):
    """[K, Ttot, B] -> [Npkt, K, T, B] (emit='full' layout)."""
    k, _, b = arrs.shape
    return arrs.reshape(k, Npkt, T, b).movedim(1, 0)


def _fold(v, groups=None, lanes=None):
    """The uint32 sum mod 2^32 of int32 bit patterns ``v`` [..., B], held
    in int64: one scalar, or one a group of B / ``groups`` lanes ([K]);
    ``lanes`` (int64 [B] of 0/1, or None) leaves the lanes at 0 out."""
    if not groups and lanes is None:
        return v.sum(dtype=torch.int64) & 0xFFFFFFFF
    per = v.reshape(-1, v.shape[-1]).sum(dim=0, dtype=torch.int64)
    if lanes is not None:
        per = per * lanes
    if groups:
        return per.reshape(groups, -1).sum(dim=1) & 0xFFFFFFFF
    return per.sum() & 0xFFFFFFFF


def _wire_stage(static: StaticChain, st, s24, Ttot, outputs, groups=None,
                lanes=None):
    """Device-side wire words (``static.wire`` non-empty): the DMA word
    streams the firmware's PIO state machines shift out, per configured
    slot type — S/PDIF IEC 60958 subframe pairs (audio_spdif.c:276-288,
    sample_encoding.cpp:24-68) or I2S 24-in-32 words
    (audio_i2s_multi.c:223-226) — with the 192-frame block position
    carried in ``ChainState.wire_pos`` so the Z preamble lands every 192
    frames across segments.  The JAX package's ``_wire_stage``.

    ``s24``: one int32 [Ttot, B] tensor a channel; each pair is stacked
    to [2, Ttot, B] here, so the encoder runs once for both channels, and
    its entries in the list are set to None.  emit='full' gives
    'wire{pair}' words ([Ttot, 4, B] S/PDIF, [Ttot, 2, B] I2S, int32 bit
    patterns); emit='reduced' one uint32 fold a pair, 'wire_sum' [npairs]
    in int64 ([npairs, K] with ``groups``: each group's lanes folded on
    their own; ``lanes`` leaves the lanes it holds at 0 out), each word
    plane folded as it is made."""
    pos0 = st.wire_pos
    folds = []
    for pair, typ in enumerate(static.wire):
        lr = torch.stack([s24[2 * pair], s24[2 * pair + 1]])
        # the channels are not read again: free them for the pair's words
        s24[2 * pair] = s24[2 * pair + 1] = None
        if typ == 1:
            planes = (encoders.encode_i2s(lr),)
        else:
            planes = encoders.spdif_planes(lr, pos0, static.wire_rate)
        if static.emit == "full":
            if typ == 1:
                outputs[f"wire{pair}"] = planes[0].movedim(0, 1).contiguous()
            else:
                l, h = planes
                outputs[f"wire{pair}"] = torch.stack([l[0], h[0], l[1],
                                                      h[1]], dim=1)
        else:
            f = _fold(planes[0], groups, lanes)
            for v in planes[1:]:
                f = (f + _fold(v, groups, lanes)) & 0xFFFFFFFF
            folds.append(f)
        del planes
    if folds:
        outputs["wire_sum"] = torch.stack(folds)
    return st._replace(wire_pos=(pos0 + Ttot) % C.SPDIF_BLOCK_FRAMES)


# ----------------------------------------------------------------------------
# the segment processor
# ----------------------------------------------------------------------------


def _s24_channels(static: StaticChain, bufs, convert, Ttot, B, dev):
    """S/PDIF conversion (usb_audio.c:934-940 / 1244-1257), one int32
    [Ttot, B] tensor a channel of the S/PDIF pairs; ``convert`` maps a
    channel's output buffer to s24."""
    s24 = []
    for pair in range(static.n_spdif):
        lch, rch = pair * 2, pair * 2 + 1
        on = static.output_enabled[lch] or static.output_enabled[rch]
        for chn in (lch, rch):
            s24.append(convert(bufs[chn]) if on else torch.zeros(
                (Ttot, B), dtype=_I32, device=dev))
    return s24


def _emit_s24(static: StaticChain, outputs, bufs, s24, sched, Npkt):
    """The s24 outputs: emit='full' 'out' and 's24' ([Npkt, K, T, B], or
    time-flat [K, Ttot, B] with a schedule); emit='reduced' the per-channel
    int32 sums (wrapping, as the JAX package's) [ns2, B]."""
    if static.emit == "full":
        out, words = torch.stack(bufs), torch.stack(s24)
        if not static.schedule:
            out, words = (_unflatten(v, Npkt, int(sched[0]))
                          for v in (out, words))
        outputs["out"], outputs["s24"] = out, words
    else:
        outputs["s24_sum"] = torch.stack([v.sum(dim=0) for v in s24]).to(_I32)


def _s24_wire_pdm(static: StaticChain, st, outputs, bufs, convert, sub,
                  sched, Npkt, Ttot, groups, lanes):
    """The chain's tail: S/PDIF conversion of the output buffers ``bufs``
    (``convert`` a channel) and the s24 outputs, the wire stage, then the
    PDM modulator on the sub output ``sub`` (Q28 int32 [Ttot, B]).  The
    s24 words are freed before the PDM stage, whose words set the
    segment's peak memory."""
    B, dev = bufs[0].shape[-1], bufs[0].device
    s24 = _s24_channels(static, bufs, convert, Ttot, B, dev)
    _emit_s24(static, outputs, bufs, s24, sched, Npkt)
    if static.wire:
        st = _wire_stage(static, st, s24, Ttot, outputs, groups, lanes)
    del s24
    if static.pdm_on:
        st, words = pdm_segment(st, sub)
        if static.emit == "full":
            outputs["pdm"] = words                  # [Ttot, 8, B] uint32 bits
        else:
            outputs["pdm_sum"] = words.sum(dim=(0, 1),
                                           dtype=torch.int64) & 0xFFFFFFFF
    return st


def _f32_lane(static: StaticChain, p) -> bool:
    """Whether scan A runs per lane: any leaf it reads carries a stream
    axis (the master EQ rows, the loudness rows or bypass flags, the
    leveller's RMS alpha), as ``_master_lane`` decides on the Q28 chain."""
    return (p.eq_f32.dim() == 4
            or (static.loudness_on and (p.loud_sva.dim() == 3
                                        or p.loud_bypass.dim() == 2))
            or (static.leveller_on and p.lev.dim() == 2))


def _f32_cascade(p, st, bands, nb, lane, B, dev, prefix=(), sprefix=()):
    """One float cascade of ``bands``, padded to ``nb`` bands with SKIP
    rows (a pass-through) and zero states, after the ``prefix`` rows
    ([11] or [11, B]) and their ``sprefix`` state rows: (cf [nr, 11] or
    [nr, 11, B] with ``lane``, its state rows, its kinds)."""
    pad = nb - len(bands)
    rows = list(prefix) + [p.eq_f32[c, band] for c, band, _k in bands]
    rows += [torch.zeros(11, dtype=_F32, device=dev)] * pad
    srows = list(sprefix) + [v for pair in _gather_states(st, bands)
                             for v in pair]
    srows += [torch.zeros((B,), dtype=_F32, device=dev)] * (2 * pad)
    if lane:
        rows = [r.unsqueeze(-1).expand(11, B) if r.dim() == 1 else r
                for r in rows]
    cf = (torch.stack(rows) if rows else
          torch.zeros((0, 11, B) if lane else (0, 11), dtype=_F32,
                      device=dev))
    return cf, srows, tuple(k for _c, _b, k in bands) + (SKIP,) * pad


def _f32_master(static: StaticChain, p, st, bl, br, master_bands, sched):
    """Scan A as one float cascade call over G=2 (master L, R): the
    loudness prefix, the master bands (SKIP rows pad the shorter channel)
    and the leveller envelope (kernels/eq_f32_cuda.py).  ``st`` holds this
    segment's own eq_* copies, written in place.  Returns (st', bl', br',
    env_ends [2, Npkt, B] | None)."""
    dev = bl.device
    B = bl.shape[-1]
    has_loud, has_env = static.loudness_on, static.leveller_on
    lane = _f32_lane(static, p)
    n_loud = 2 if has_loud else 0
    mb = [[t for t in master_bands if t[0] == ch] for ch in range(2)]
    nb = max(len(mb[0]), len(mb[1]))
    loud = ()
    if has_loud:               # [2, 6(, B)] rows padded to the 11 columns
        pad = torch.zeros((2, 5) + tuple(p.loud_sva.shape[2:]), dtype=_F32,
                          device=dev)
        loud = tuple(torch.cat([p.loud_sva, pad], dim=1))
    cf_ch, s_ch, kinds = [], [], []
    for ch in range(2):
        sprefix = ((st.loud_a[ch, 0], st.loud_b[ch, 0], st.loud_a[ch, 1],
                    st.loud_b[ch, 1]) if has_loud else ())
        cf, srows, kd = _f32_cascade(p, st, mb[ch], nb, lane, B, dev, loud,
                                     sprefix)
        if has_env:
            srows.append(st.lev_env[ch])
        cf_ch.append(cf)
        s_ch.append(torch.stack(srows))
        kinds.append(kd)
    zero = torch.zeros((), dtype=_F32, device=dev)
    vals = ([p.loud_bypass[0].to(_F32), p.loud_bypass[1].to(_F32)]
            if has_loud else [zero, zero])
    vals += [p.lev[0], 1.0 - p.lev[0]] if has_env else [zero, zero]
    # the same scalars for L and R: [4], or [4, B] per lane
    scal = torch.stack([v.expand(B) if lane else v for v in vals])
    y, env, sF = f32_cascades(
        torch.stack([bl, br]), torch.stack(cf_ch), torch.stack(s_ch),
        scal.expand(2, *scal.shape).contiguous(), kinds=kinds,
        has_loud=has_loud, has_env=has_env, tc=int(sched[0]),
        sched=static.schedule or None)
    if has_loud:
        st = st._replace(loud_a=sF[:, [0, 2]], loud_b=sF[:, [1, 3]])
    finals = []
    for t in master_bands:
        r = 2 * n_loud + 2 * mb[t[0]].index(t)
        finals.append((sF[t[0], r], sF[t[0], r + 1]))
    st = _scatter_states(st, master_bands, finals)
    return st, y[0], y[1], env


def _f32_outputs(static: StaticChain, p, st, bl, br, out_bands, sched):
    """PASS 3-5 of the scan lowering: the crossfeed kernel, the matrix mix
    as torch ops (the JAX package's four cases, usb_audio.c:751-779), then
    scan B as one float cascade call over the live outputs.  Returns (st',
    bufs, one [Ttot, B] tensor an output)."""
    if static.crossfeed_on:
        bl, br, s4 = xf_f32(bl.contiguous(), br.contiguous(), p.xf,
                            torch.cat([st.xf_lp, st.xf_ap]))
        st = st._replace(xf_lp=s4[:2], xf_ap=s4[2:])
    bufs = []
    for o in range(static.n_outputs):
        if not static.output_enabled[o]:
            bufs.append(torch.zeros_like(bl))
            continue
        gl, gr = p.matrix_gain[0, o], p.matrix_gain[1, o]
        pl, pr = bl * gl, br * gr
        bufs.append(torch.where(
            (gl != 0.0) & (gr != 0.0), pl + pr,
            torch.where(gl != 0.0, pl,
                        torch.where(gr != 0.0, pr, torch.zeros_like(pr)))))
        del pl, pr
    if not out_bands:
        return st, bufs
    live = sorted({ch - C.CH_OUT_1 for ch, _b, _k in out_bands})
    per_o = {o: [t for t in out_bands if t[0] - C.CH_OUT_1 == o]
             for o in live}
    nb = max(len(v) for v in per_o.values())
    lane = p.eq_f32.dim() == 4
    B, dev = bl.shape[-1], bl.device
    cf_g, s_g, kinds = [], [], []
    for o in live:
        cf, srows, kd = _f32_cascade(p, st, per_o[o], nb, lane, B, dev)
        cf_g.append(cf)
        s_g.append(torch.stack(srows))
        kinds.append(kd)
    x = torch.stack([bufs[o] for o in live])
    for o in live:                 # the stack holds them: free the planes
        bufs[o] = None
    y, _, sF = f32_cascades(
        x, torch.stack(cf_g), torch.stack(s_g),
        torch.zeros((len(live), 4, B) if lane else (len(live), 4),
                    dtype=_F32, device=dev), kinds=kinds, tc=int(sched[0]),
        sched=static.schedule or None)
    del x
    finals = []
    for t in out_bands:
        gi = live.index(t[0] - C.CH_OUT_1)
        r = 2 * per_o[live[gi]].index(t)
        finals.append((sF[gi, r], sF[gi, r + 1]))
    st = _scatter_states(st, out_bands, finals)
    for gi, o in enumerate(live):
        bufs[o] = y[gi]
    return st, bufs


def process_float(static: StaticChain, p, state, x, preset_mute=None, *,
                  blocks=None, groups=None, wire_lanes=None):
    """One segment of the RP2350 float chain.

    ``p``/``state``: the port's ChainParams/ChainState of tensors on the
    device of ``x`` (int32 [n_packets, 2, block_size, B], or [2,
    sum(schedule), B] with a schedule).  ``preset_mute`` float32
    [n_packets] (default ones).  ``blocks``: on the block-matmul lowering
    (``static.mxu``), the block matrices ``mxu.build_blocks(static, p,
    device)`` of these params, built once per parameter set by the
    caller; None on the scan lowering, where any leaf of ``p`` may carry a
    trailing [B] stream axis (per-stream parameters) and the recurrences
    run as the float cascade and crossfeed kernels (their plain versions
    on CPU tensors).  With ``groups`` = K (grouped serving), the lanes are
    K contiguous groups, ``blocks`` holds each group's matrices
    (``mxu.stack_groups``) and the leaves of ``p`` that differ across
    groups carry a trailing lane axis; reduced wire folds are then per
    group.  ``wire_lanes`` (int64 [B] of 0/1): only the lanes at 1
    enter the reduced wire folds (a hetero server's bucket padding is
    left out).

    Returns (state', outputs) as the JAX package's ``_process_float``: the
    input state is not modified.  With a schedule, emit='full' outputs are
    time-flat ([K, Ttot, B])."""
    with span("dspi.segment"):
        from . import mxu

        if static.mxu and blocks is None:
            raise ValueError("the block-matmul lowering needs its block "
                             "matrices (blocks=mxu.build_blocks(...))")
        x2, sched, Npkt, Ttot = _segment_layout(static, x)
        B = x2.shape[-1]
        dev = x.device
        nout = static.n_outputs
        ns2 = static.n_spdif * 2
        master_bands, out_bands = _chain_structure(static)
        if preset_mute is None:
            preset_mute = torch.ones((Npkt,), dtype=_F32, device=dev)
        st = state._replace(eq_a=state.eq_a.clone(), eq_b=state.eq_b.clone(),
                            eq_c=state.eq_c.clone(), eq_d=state.eq_d.clone())

        with span("dspi.unpack"):
            # per-packet volume staging (usb_audio.c:569-574), [Npkt, 1|B]
            vol_mul_master = (p.vol_mul * preset_mute[:, None]) * p.master_vol

            # ---- PASS 1: unpack + preamp (usb_audio.c:678-686) ----
            bl = x2[0].to(_F32) * p.unpack_gain[0]
            br = x2[1].to(_F32) * p.unpack_gain[1]
            del x2

        with span("dspi.master"):
            # ---- loudness + master EQ (+ the leveller envelope at packet
            # ends): block matmuls, or scan A as the float cascade kernel
            if static.mxu:
                if static.loudness_on or master_bands:
                    st, bl, br = mxu.chain_a(static, p, blocks, st, bl, br,
                                             master_bands, Npkt, groups)
                if static.leveller_on:
                    env_l, env_r = mxu.env_packet_ends(static, p, st, bl,
                                                       br, Npkt)
            elif static.loudness_on or master_bands or static.leveller_on:
                st, bl, br, env = _f32_master(static, p, st, bl, br,
                                              master_bands, sched)
                if static.leveller_on:
                    env_l, env_r = env[0], env[1]

        # ---- PASS 2.5 leveller block phase (leveller.c:147-262) ----
        if static.leveller_on:
            with span("dspi.leveller"):
                st = st._replace(lev_env=torch.stack([env_l[-1], env_r[-1]]))
                a_att, a_rel = p.lev[1], p.lev[2]
                thresh, knee, gate = p.lev[3], p.lev[4], p.lev[5]
                max_gain, makeup = p.lev[7], p.lev[8]
                slope, inv_two_knee = p.lev[9], p.lev[10]

                # gain computer, vectorized over packets
                rms_sq = torch.maximum(env_l, env_r)
                rms_db = 10.0 * fmath.log10_f32(rms_sq + 1e-30)
                half = knee * 0.5
                d = thresh + half - rms_db
                zero = torch.zeros_like(rms_db)
                gc = torch.where(
                    rms_db > thresh + half, zero,
                    torch.where(rms_db >= thresh - half,
                                slope * d * d * inv_two_knee,
                                (thresh - rms_db) * slope))
                gc = torch.minimum(gc + makeup, max_gain)
                gc = torch.where(rms_db < gate, zero, gc)           # [Npkt, B]

                # block-rate attack/release smoothing: a recurrence over
                # packets, with the alpha^count correction
                # (leveller.c:223-227) hoisted; the count is each packet's
                # length ([Npkt, 1|B])
                counts = torch.from_numpy(
                    sched.astype(np.float32))[:, None].to(dev)
                pow_att = fmath.pow_f32(a_att, counts)
                pow_rel = fmath.pow_f32(a_rel, counts)
                gdb = st.lev_gain_db
                gdbs = []
                for k in range(Npkt):
                    alpha = torch.where(gc[k] < gdb, pow_att[k], pow_rel[k])
                    gdb = fmath.smooth_det(alpha, gdb, gc[k])
                    gdbs.append(gdb)
                # [Npkt, B]
                g_cur_p = fmath.exp10_f32(torch.stack(gdbs) * _INV20)
                g_prev_p = torch.cat([st.lev_gain[None], g_cur_p[:-1]])
                st = st._replace(lev_gain_db=gdb, lev_gain=g_cur_p[-1],
                                 lev_gain_prev=g_prev_p[-1])

                # gain ramp with the firmware's sequential accumulation, all
                # packets at once over the longest packet, then each packet's
                # first n rows; a one-sample packet jumps to g_cur
                # (leveller.c:216-221)
                Tmax = int(sched.max())
                if Tmax == 1:
                    gains = g_cur_p
                else:
                    inv = np.zeros(Npkt, np.float32)
                    nz = sched > 1
                    inv[nz] = np.float32(1.0) / (sched[nz] - 1).astype(
                        np.float32)
                    step = (g_cur_p - g_prev_p) * torch.from_numpy(
                        inv)[:, None].to(dev)
                    g = g_prev_p
                    if not nz.all():
                        one = torch.from_numpy(~nz)[:, None].to(dev)
                        g = torch.where(one, g_cur_p, g_prev_p)
                        step = torch.where(one, torch.zeros_like(step), step)
                    gains = torch.empty((Npkt, Tmax, B), dtype=_F32,
                                        device=dev)
                    for i in range(Tmax):
                        gains[:, i] = g
                        g = g + step
                    gains = _pkts_to_flat(gains, sched, Ttot)

                if static.leveller_lookahead:
                    # time-ordered lookahead ring: the delayed stream is a
                    # window of concat(ring, segment)
                    comb_l = torch.cat([st.lev_la[0], bl], dim=0)
                    comb_r = torch.cat([st.lev_la[1], br], dim=0)
                    out_l, out_r = comb_l[:Ttot], comb_r[:Ttot]
                    st = st._replace(lev_la=torch.stack([comb_l[Ttot:],
                                                         comb_r[Ttot:]]))
                else:
                    out_l, out_r = bl, br

                peak = torch.maximum(out_l.abs(), out_r.abs())
                max_g = fmath.det_div(
                    float(np.float32(C.LEVELLER_LIMITER_CEIL)), peak)
                one = torch.ones_like(max_g)
                cap = torch.where(max_g > 1.0, max_g, one)
                g_eff = torch.where(
                    (peak > 0.0) & (gains > 1.0) & (max_g < gains), cap,
                    gains)
                del peak, max_g, cap, gains
                bl = out_l * g_eff
                br = out_r * g_eff
                del out_l, out_r, g_eff

        with span("dspi.outputs"):
            # ---- PASS 3: master peaks (pre-crossfeed) ----
            peak_ml = bl.abs().amax(dim=0)
            peak_mr = br.abs().amax(dim=0)

            # ---- PASS 3-5: crossfeed + matrix + per-output EQ: block
            # matmuls, or the crossfeed kernel, the matrix and scan B as the
            # cascade kernel ----
            if static.mxu:
                st, bufs = mxu.chain_b(static, p, blocks, st, bl, br,
                                       out_bands, Npkt, groups)
            else:
                st, bufs = _f32_outputs(static, p, st, bl, br, out_bands,
                                        sched)
            del bl, br

        with span("dspi.tail"):
            # output gains (usb_audio.c:885-894), per packet through the
            # preset-mute envelope
            for o in range(nout):
                if not static.output_enabled[o]:
                    continue
                if static.output_mute[o]:
                    bufs[o] = torch.zeros_like(bufs[o])
                    continue
                gain = p.out_gain[o] * vol_mul_master       # [Npkt, 1|B]
                if static.schedule:           # [Ttot, 1|B] along the packets
                    gain = _per_packet(gain, sched, Ttot)
                    y = bufs[o]
                else:                         # [Npkt, 1, 1|B]
                    gain = gain[:, None, :]
                    y = bufs[o].reshape(Npkt, -1, B)
                bufs[o] = torch.where(gain == 0.0, torch.zeros_like(y),
                                      y * gain).reshape(Ttot, B)

            # delay lines (usb_audio.c:897-911)
            if static.delayed_outputs:
                D = static.delay_ring
                rows = []
                for k, o in enumerate(static.delayed_outputs):
                    bufs[o], ring_k = _delay_apply(st.delay[k], bufs[o],
                                                   p.delay_samples[k], Ttot, D)
                    rows.append(ring_k)
                st = st._replace(delay=torch.stack(rows))

            # peaks / clip flags (sticky over the segment == sticky per packet)
            peaks = [peak_ml, peak_mr]
            for o in range(ns2):
                peaks.append(bufs[o].abs().amax(dim=0))
            if static.output_enabled[nout - 1]:
                peaks.append(bufs[nout - 1].abs().amax(dim=0))
            else:
                peaks.append(torch.zeros_like(peak_ml))
            peaks = torch.stack(peaks)                       # [nch', B]
            clip = st.clip_flags
            for chi in range(peaks.shape[0]):
                ch_bit = chi if chi < 2 + ns2 else static.n_channels - 1
                clip = clip | ((peaks[chi] > C.CLIP_THRESH_F).to(torch.int32)
                               << ch_bit)
            st = st._replace(clip_flags=clip)

        with span("dspi.wire"):
            outputs = {}
            # peak u16 conversion (usb_audio.c:841,921):
            # trunc(min(1,peak)*32767)
            outputs["peaks"] = (torch.clamp(peaks, max=1.0)
                                * 32767.0).trunc().to(torch.int32)
            sub = (f32_to_i32(bufs[nout - 1] * float(1 << 28)) if static.pdm_on
                   else None)
            # S/PDIF conversion (usb_audio.c:934-940)
            st = _s24_wire_pdm(
                static, st, outputs, bufs,
                lambda v: f32_to_i32(v.clamp(-1.0, 1.0) * 8388607.0), sub,
                sched, Npkt, Ttot, groups, wire_lanes)
        return st, outputs


# ----------------------------------------------------------------------------
# the Q28 segment processor (RP2040)
# ----------------------------------------------------------------------------

_IDENT_Q28 = (C.Q28_ONE, 0, 0, 0, 0)        # an exact pass-through band row
_INV_Q28 = 2.0 ** -28
_TINY = float(np.float32(1e-30))


def _lane_rows(rows, B):
    """Coefficient rows [n, 5], or [n, 5, B] per lane, all in the per-lane
    form: a config-uniform row (the identity, a collapsed leaf of
    ``build_params_multi``) broadcasts over the lanes."""
    return [r.unsqueeze(-1).expand(*r.shape, B) if r.dim() == 2 else r
            for r in rows]


def _band_rows(p, st, bands, nb, lane):
    """Coefficient rows and (s1, s2) state rows of one cascade's ``bands``,
    padded to ``nb`` bands with exact pass-through rows and zero states;
    with ``lane``, every row in the per-lane [n, 5, B] form."""
    B = st.eq_a.shape[-1]
    dev = st.eq_a.device
    pad = nb - len(bands)
    rows = [p.eq_q28[c, band][None] for c, band, _k in bands]
    rows += [torch.tensor([_IDENT_Q28], dtype=_I32, device=dev)] * pad
    srows = [v for c, band, _k in bands
             for v in (st.eq_a[c, band], st.eq_b[c, band])]
    srows += [torch.zeros((B,), dtype=_I32, device=dev)] * (2 * pad)
    return (_lane_rows(rows, B) if lane else rows), srows


def _cascade_cf(rows, lane, B, dev):
    """One cascade's rows -> cf [nr, 5] (or [nr, 5, B] with ``lane``)."""
    if rows:
        return torch.cat(rows)
    return torch.zeros((0, 5, B) if lane else (0, 5), dtype=_I32, device=dev)


def _master_lane(static: StaticChain, p) -> bool:
    """Whether scan A runs the per-lane (lane_cf) cascade: any leaf it
    reads carries a stream axis.  The JAX package decides from ``eq_q28``
    alone; configs that share their EQ still differ per lane in the
    loudness row and its bypass flags (another host volume) or in the
    leveller's RMS alpha (another RMS time)."""
    return (p.eq_q28.dim() == 4
            or (static.loudness_on and (p.loud_qbq.dim() == 3
                                        or p.loud_bypass.dim() == 2))
            or (static.leveller_on and p.lev.dim() == 2))


def _q28_master(static: StaticChain, p, st, bl, br, master_bands,
                a_rms_q28, one_minus, sched):
    """Scan A as one cascade call over G=2 (master L, R): the loudness
    prefix, the master bands (identity rows pad the shorter channel) and
    the leveller envelope, as the JAX package's ``_q28_kernel_master``
    builds it.  ``st`` holds this segment's own eq_a/eq_b copies, written
    in place.  Returns (st', bl', br', env_ends [2, Npkt, B] | None)."""
    dev = bl.device
    B = bl.shape[-1]
    has_loud, has_env = static.loudness_on, static.leveller_on
    lane = _master_lane(static, p)
    n_loud = 2 if has_loud else 0
    mb = [[t for t in master_bands if t[0] == ch] for ch in range(2)]
    nb = max(len(mb[0]), len(mb[1]))
    cf_ch, s_ch = [], []
    for ch in range(2):
        rows, srows = _band_rows(p, st, mb[ch], nb, lane)
        if has_loud:
            rows = (_lane_rows([p.loud_qbq], B) if lane
                    else [p.loud_qbq]) + rows
            srows = [st.loud_a[ch, 0], st.loud_b[ch, 0],
                     st.loud_a[ch, 1], st.loud_b[ch, 1]] + srows
        if has_env:
            srows.append(st.lev_env[ch])
        cf_ch.append(_cascade_cf(rows, lane, B, dev))
        s_ch.append(torch.stack(srows))
    zero = torch.zeros((), dtype=_I32, device=dev)
    vals = ([p.loud_bypass[0], p.loud_bypass[1]] if has_loud
            else [zero, zero])
    vals += [a_rms_q28, one_minus] if has_env else [zero, zero]
    # the same scalars for L and R: [4], or [4, B] per lane
    scal = torch.stack([v.to(_I32).expand(B) if lane else v.to(_I32)
                        for v in vals])
    y, env, sF = q28_cascades(
        torch.stack([bl, br]), torch.stack(cf_ch), torch.stack(s_ch),
        scal.expand(2, *scal.shape).contiguous(), nb=nb, has_loud=has_loud,
        has_env=has_env, tc=int(sched[0]),
        sched=static.schedule or None)
    if has_loud:
        st = st._replace(loud_a=sF[:, [0, 2]], loud_b=sF[:, [1, 3]])
    finals = []
    for t in master_bands:
        r = 2 * n_loud + 2 * mb[t[0]].index(t)
        finals.append((sF[t[0], r], sF[t[0], r + 1]))
    st = _scatter_states(st, master_bands, finals)
    return st, y[0], y[1], env


def _q28_outeq(static: StaticChain, p, st, bufs, out_bands, sched):
    """Scan B as one cascade call over the live outputs, as the JAX
    package's ``_q28_kernel_outeq`` builds it; per-lane when the EQ
    coefficients are."""
    live = sorted({ch - C.CH_OUT_1 for ch, _b, _k in out_bands})
    per_o = {o: [t for t in out_bands if t[0] - C.CH_OUT_1 == o]
             for o in live}
    nb = max(len(v) for v in per_o.values())
    lane = p.eq_q28.dim() == 4
    B = bufs[live[0]].shape[-1]
    cf_g, s_g = [], []
    for o in live:
        rows, srows = _band_rows(p, st, per_o[o], nb, lane)
        cf_g.append(torch.cat(rows))
        s_g.append(torch.stack(srows))
    scal = torch.zeros((len(live), 4, B) if lane else (len(live), 4),
                       dtype=_I32, device=bufs[live[0]].device)
    y, _, sF = q28_cascades(
        torch.stack([bufs[o] for o in live]), torch.stack(cf_g),
        torch.stack(s_g), scal, nb=nb, tc=int(sched[0]),
        sched=static.schedule or None)
    finals = []
    for t in out_bands:
        gi = live.index(t[0] - C.CH_OUT_1)
        r = 2 * per_o[live[gi]].index(t)
        finals.append((sF[gi, r], sF[gi, r + 1]))
    st = _scatter_states(st, out_bands, finals)
    for gi, o in enumerate(live):
        bufs[o] = y[gi]
    return st, bufs


def process_q28(static: StaticChain, p, state, x, preset_mute=None, *,
                groups=None, wire_lanes=None):
    """One segment of the RP2040 Q28 chain: the JAX package's
    ``_process_q28``, word for word.

    ``p``/``state``: the port's ChainParams/ChainState of tensors on the
    device of ``x`` (int32 [n_packets, 2, block_size, B], or [2,
    sum(schedule), B] with a schedule; s16 or s24 values per
    ``static.bit_depth``).  Any leaf of ``p`` may carry a trailing [B]
    stream axis (per-stream parameters).  ``preset_mute`` float32
    [n_packets] (default ones).  Both EQ scans go through the cascade
    kernel (``kernels.eq_cuda.q28_cascades``), the crossfeed through its
    own (``kernels.xf_cuda.xf_q28``) and the sub output through the PDM
    kernel; on CPU tensors each runs its plain version.  The one float
    region, the leveller's gain computer, is single IEEE operations and
    the integer ``fmath`` polynomials, so the card and the CPU give the
    same bits.

    With ``groups`` = K (grouped serving), reduced wire folds are per
    group of B / K contiguous lanes; ``wire_lanes`` as ``process_float``'s.

    Returns (state', outputs); the input state is not modified.  With a
    schedule, emit='full' outputs are time-flat ([K, Ttot, B])."""
    with span("dspi.segment"):
        x2, sched, Npkt, Ttot = _segment_layout(static, x)
        B = x2.shape[-1]
        nout = static.n_outputs
        ns2 = static.n_spdif * 2
        dev = x.device
        master_bands, out_bands = _chain_structure(static)
        if preset_mute is None:
            preset_mute = torch.ones((Npkt,), dtype=_F32, device=dev)
        st = state._replace(eq_a=state.eq_a.clone(), eq_b=state.eq_b.clone())

        with span("dspi.unpack"):
            # per-packet volume staging (usb_audio.c:975-980), Q15 [Npkt, 1|B]
            pm_q15 = f32_to_i32(preset_mute * 32768.0 + 0.5).clamp(0, 32768)
            vol_mul_master = q15_mul(q15_mul(p.vol_mul, pm_q15[:, None]),
                                     p.master_vol)

            # ---- PASS 1: unpack + preamp (usb_audio.c:996-1015) ----
            raw = (x2 << 8) >> 2 if static.bit_depth == 24 else x2 << 14
            del x2
            bl = q28_mul(raw[0], p.unpack_gain[0])
            br = q28_mul(raw[1], p.unpack_gain[1])
            del raw

        with span("dspi.master"):
            # ---- scan A: loudness + master EQ + leveller envelope ----
            a_rms_q28 = one_minus = None
            if static.leveller_on:
                a_rms_q28 = f32_to_i32(p.lev[0] * float(1 << 28))
                one_minus = C.Q28_ONE - a_rms_q28
            if static.loudness_on or master_bands or static.leveller_on:
                st, bl, br, env = _q28_master(static, p, st, bl, br,
                                              master_bands, a_rms_q28,
                                              one_minus, sched)

        # ---- PASS 2.5 leveller block phase (leveller.c:274-389) ----
        if static.leveller_on:
            with span("dspi.leveller"):
                st = st._replace(lev_env=env[:, -1].clone())
                env_f = env.to(_F32) * _INV_Q28              # [2, Npkt, B]
                a_att, a_rel = p.lev[1], p.lev[2]
                thresh, knee, gate = p.lev[3], p.lev[4], p.lev[5]
                max_gain, makeup = p.lev[7], p.lev[8]
                slope, inv_two_knee = p.lev[9], p.lev[10]
                rms_sq = torch.maximum(env_f[0], env_f[1])
                rms_db = 10.0 * fmath.log10_f32(rms_sq + _TINY)
                half = knee * 0.5
                d = thresh + half - rms_db
                zero = torch.zeros_like(rms_db)
                gc = torch.where(
                    rms_db > thresh + half, zero,
                    torch.where(rms_db >= thresh - half,
                                slope * d * d * inv_two_knee,
                                (thresh - rms_db) * slope))
                gc = torch.minimum(gc + makeup, max_gain)
                gc = torch.where(rms_db < gate, zero, gc)           # [Npkt, B]

                # block-rate attack/release smoothing with alpha^count per
                # packet ([Npkt, 1|B]): the loop runs smooth_det only; the
                # Q28 gains of all packets follow in one pass
                counts = torch.from_numpy(
                    sched.astype(np.float32))[:, None].to(dev)
                pow_att = fmath.pow_f32(a_att, counts)
                pow_rel = fmath.pow_f32(a_rel, counts)
                gdb = st.lev_gain_db
                gdbs = []
                for k in range(Npkt):
                    alpha = torch.where(gc[k] < gdb, pow_att[k], pow_rel[k])
                    gdb = fmath.smooth_det(alpha, gdb, gc[k])
                    gdbs.append(gdb)
                g_cur_p = f32_to_i32(                       # [Npkt, B]
                    fmath.exp10_f32(torch.stack(gdbs) * _INV20)
                    * float(C.Q28_ONE))
                g_prev_p = torch.cat([st.lev_gain[None], g_cur_p[:-1]])
                st = st._replace(lev_gain_db=gdb, lev_gain=g_cur_p[-1],
                                 lev_gain_prev=g_prev_p[-1])

                # interpolated gain
                # g_prev + (int64(g_cur - g_prev) * i) / (n - 1) with C's
                # truncating division (leveller.c:352), n the packet's
                # length; closed form over all packets and samples, then
                # each packet's first n rows; a one-sample packet jumps to
                # g_cur
                Tmax = int(sched.max())
                if Tmax == 1:
                    gains = g_cur_p
                else:
                    diff = g_cur_p - g_prev_p          # int32 wrap, as C
                    sign = 1 - 2 * (diff < 0).to(torch.int64)[:, None, :]
                    # |diff| in int64, so that diff = -2^31 gives 2^31
                    q = diff.to(torch.int64).abs()[:, None, :] * torch.arange(
                        Tmax, dtype=torch.int64, device=dev)[None, :, None]
                    div = torch.from_numpy(
                        np.maximum(sched - 1, 1))[:, None, None]
                    q = q.floor_divide_(div.to(dev)).mul_(sign).add_(
                        g_prev_p[:, None, :])
                    gains = wrap32(q)
                    del diff, sign, q
                    if (sched == 1).any():
                        one = torch.from_numpy(
                            sched == 1)[:, None, None].to(dev)
                        gains = torch.where(one, g_cur_p[:, None, :], gains)
                    gains = _pkts_to_flat(gains, sched, Ttot)

                if static.leveller_lookahead:
                    # time-ordered lookahead ring: the delayed stream is a
                    # window of concat(ring, segment)
                    comb_l = torch.cat([st.lev_la[0], bl], dim=0)
                    comb_r = torch.cat([st.lev_la[1], br], dim=0)
                    out_l, out_r = comb_l[:Ttot], comb_r[:Ttot]
                    st = st._replace(lev_la=torch.stack([comb_l[Ttot:],
                                                         comb_r[Ttot:]]))
                else:
                    out_l, out_r = bl, br
                del bl, br

                # limiter (leveller.c:369-379): float peak, Q28 gain cap
                peak = torch.maximum((out_l.to(_F32) * _INV_Q28).abs(),
                                     (out_r.to(_F32) * _INV_Q28).abs())
                max_g = f32_to_i32(fmath.det_div(
                    float(np.float32(C.LEVELLER_LIMITER_CEIL)), peak)
                    * float(C.Q28_ONE))
                g_eff = torch.where(
                    (gains > C.Q28_ONE) & (peak > 0.0) & (max_g < gains),
                    max_g.clamp(min=C.Q28_ONE), gains)
                del peak, max_g, gains
                bl = q28_mul(out_l, g_eff)
                br = q28_mul(out_r, g_eff)
                del out_l, out_r, g_eff

        with span("dspi.outputs"):
            # ---- PASS 3: master peaks, then the crossfeed kernel ----
            peak_ml = bl.abs().amax(dim=0)
            peak_mr = br.abs().amax(dim=0)
            if static.crossfeed_on:
                bl, br, s4 = xf_q28(bl.contiguous(), br.contiguous(), p.xf,
                                    torch.cat([st.xf_lp, st.xf_ap]))
                st = st._replace(xf_lp=s4[:2], xf_ap=s4[2:])

            # ---- PASS 4: matrix (usb_audio.c:1075-1100).
            # q15_mul(x, 0) == 0, so the firmware's branches on zero gains
            # all come to this sum ----
            bufs = []
            for o in range(nout):
                if not static.output_enabled[o]:
                    bufs.append(torch.zeros_like(bl))
                    continue
                bufs.append(q15_mul(bl, p.matrix_gain[0, o])
                            + q15_mul(br, p.matrix_gain[1, o]))
            del bl, br

            # ---- PASS 5: per-output EQ ----
            if out_bands:
                st, bufs = _q28_outeq(static, p, st, bufs, out_bands, sched)

        with span("dspi.tail"):
            # output gains (usb_audio.c:1203-1212): float multiply, then
            # Q15 apply per packet (a zero gain needs no branch:
            # q15_mul(x, 0) == 0)
            for o in range(nout):
                if not static.output_enabled[o]:
                    continue
                if static.output_mute[o]:
                    bufs[o] = torch.zeros_like(bufs[o])
                    continue
                gain = f32_to_i32(p.out_gain[o] * vol_mul_master.to(_F32))
                if static.schedule:           # [Ttot, 1|B] along the packets
                    bufs[o] = q15_mul(bufs[o], _per_packet(gain, sched, Ttot))
                else:                         # [Npkt, 1, 1|B]
                    bufs[o] = q15_mul(bufs[o].reshape(Npkt, -1, B),
                                      gain[:, None, :]).reshape(Ttot, B)

            # delay lines (usb_audio.c:1213-1227)
            if static.delayed_outputs:
                D = static.delay_ring
                rows = []
                for k, o in enumerate(static.delayed_outputs):
                    bufs[o], ring_k = _delay_apply(st.delay[k], bufs[o],
                                                   p.delay_samples[k], Ttot, D)
                    rows.append(ring_k)
                st = st._replace(delay=torch.stack(rows))

            # peaks / clip flags (Q28: u16 = peak >> 13, usb_audio.c:1239)
            peaks = [peak_ml, peak_mr]
            for o in range(ns2):
                peaks.append(bufs[o].abs().amax(dim=0))
            if static.output_enabled[nout - 1]:
                peaks.append(bufs[nout - 1].abs().amax(dim=0))
            else:
                peaks.append(torch.zeros_like(peak_ml))
            peaks = torch.stack(peaks)
            clip = st.clip_flags
            for chi in range(peaks.shape[0]):
                ch_bit = chi if chi < 2 + ns2 else static.n_channels - 1
                clip = clip | ((peaks[chi] > C.CLIP_THRESH_Q28).to(_I32)
                               << ch_bit)
            st = st._replace(clip_flags=clip)

        with span("dspi.wire"):
            outputs = {"peaks": (peaks >> 13) & 0xFFFF}
            # S/PDIF conversion (usb_audio.c:1244-1257)
            st = _s24_wire_pdm(static, st, outputs, bufs, q28_to_s24,
                               bufs[nout - 1], sched, Npkt, Ttot, groups,
                               wire_lanes)
        return st, outputs
