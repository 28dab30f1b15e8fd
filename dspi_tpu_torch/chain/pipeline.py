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
the crossfeed as its own kernel (kernels/xf_cuda.py), the matrix mix
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

In both, the leveller's block phase is two kernel calls
(kernels/lev_cuda.py: each packet's gain, then the ramp, lookahead,
limiter and gain over every sample), the PDM modulator is the CUDA kernel
(kernels/pdm_cuda.py), the output gains, delay lines, peaks, s24 words
and the sub's PDM input are one kernel call (kernels/tail_cuda.py) and,
with ``static.wire``, the s24 samples become the S/PDIF or I2S wire words
(kernels/encoders.py) on the device.  Which bands run in which cascade,
and in what order a cascade's states sit, is chain/layout.py's, shared
with the block lowering; each chain's cascade calls here add only what is
its number format's: coefficient rows, scalars and the kernel call.

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
from ..core.qmath import f32_to_i32, q15_mul, q28_mul
from ..kernels import encoders
from ..kernels.eq_cuda import q28_cascades
from ..kernels.eq_f32_cuda import f32_cascades
from ..kernels.lev_cuda import lev_apply, lev_gain
from ..kernels.pdm_cuda import pdm_segment
from ..kernels.q15_cuda import q15_mix
from ..kernels.tail_cuda import segment_tail
from ..kernels.xf_cuda import xf_f32, xf_q28
from ..runtime.telemetry import span, upload
from . import layout, mxu
from .layout import _chain_structure
from .pack import SKIP, StaticChain

_F32 = torch.float32
_I32 = torch.int32


# ----------------------------------------------------------------------------
# segment helpers, both chains
# ----------------------------------------------------------------------------


def _packet_ends(static: StaticChain, sched, dev):
    """A scheduled chain's packet ends, int32 [Npkt] on ``dev`` (the
    leveller's and the tail's kernels take them); None for uniform
    packets."""
    if not static.schedule:
        return None
    with span("dspi.sched"):
        return upload(np.cumsum(sched).astype(np.int32), dev)


def _leveller(static: StaticChain, p, st, bl, br, env_l, env_r, Ttot, ends):
    """PASS 2.5, the leveller's block phase, both chains: from each
    packet's end envelope (``env_l``, ``env_r`` [Npkt, B], float32 or Q28
    int32) the gain of every packet (``lev_gain``), then the gain ramp, the
    lookahead through the time-ordered ring ``lev_la``, the limiter and the
    gained master (``lev_apply``).  Returns (st', bl', br')."""
    st = st._replace(lev_env=torch.stack([env_l[-1], env_r[-1]]))
    g_cur, gdb, g, g_prev = lev_gain(env_l.contiguous(), env_r.contiguous(),
                                     p.lev, st.lev_gain_db, st.lev_gain,
                                     Ttot, ends)
    ring = st.lev_la if static.leveller_lookahead else None
    bl, br, ring = lev_apply(bl.contiguous(), br.contiguous(), g_cur,
                             st.lev_gain, ring, ends)
    st = st._replace(lev_gain_db=gdb, lev_gain=g, lev_gain_prev=g_prev)
    if ring is not None:
        st = st._replace(lev_la=ring)
    return st, bl, br


def _tail(static: StaticChain, p, st, bufs, gains, ends, peak_ml, peak_mr,
          thresh):
    """PASS 5 after the output EQ, both chains, as one ``segment_tail``
    call over the output planes ``bufs``: the gains of each packet
    (``gains`` [nout, Npkt, 1|B]: float32, or Q15 int32), the delay lines,
    the peaks, the s24 words and sums and the sub's PDM input; then the
    segment's peaks, [nch', B] (the master pair, pre-crossfeed, the S/PDIF
    outputs and the sub), and the sticky clip flags of those over
    ``thresh`` (sticky over the segment == sticky per packet).  Returns
    (st', the tail's dict, peaks)."""
    delayed = static.delayed_outputs
    tail = segment_tail(
        [b.contiguous() for b in bufs], gains.contiguous(), ends,
        p.delay_samples.contiguous() if delayed else None,
        st.delay if delayed else None, enabled=static.output_enabled,
        muted=static.output_mute, delayed=delayed,
        spdif=2 * static.n_spdif, sub=static.pdm_on,
        words=bool(static.wire), full=static.emit == "full")
    if delayed:
        st = st._replace(delay=tail["ring"])
    peaks = torch.cat([torch.stack([peak_ml, peak_mr]), tail["peaks"]])
    clip = st.clip_flags
    for chi in range(peaks.shape[0]):
        ch_bit = chi if chi < 2 + 2 * static.n_spdif else static.n_channels - 1
        clip = clip | ((peaks[chi] > thresh).to(_I32) << ch_bit)
    return st._replace(clip_flags=clip), tail, peaks


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

    ``s24``: int32 [ns2, Ttot, B], the S/PDIF channels' words; the
    encoder runs once a pair, on its [2, Ttot, B] rows.  emit='full' gives
    'wire{pair}' words ([Ttot, 4, B] S/PDIF, [Ttot, 2, B] I2S, int32 bit
    patterns); emit='reduced' one uint32 fold a pair, 'wire_sum' [npairs]
    in int64 ([npairs, K] with ``groups``: each group's lanes folded on
    their own; ``lanes`` leaves the lanes it holds at 0 out), each word
    plane folded as it is made."""
    pos0 = st.wire_pos
    folds = []
    for pair, typ in enumerate(static.wire):
        lr = s24[2 * pair:2 * pair + 2]
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


def _s24_wire_pdm(static: StaticChain, st, outputs, tail, sched, Npkt,
                  Ttot, groups, lanes):
    """The chain's outputs from the tail's dict (``_tail``): emit='full'
    'out' and 's24' ([Npkt, K, T, B], or time-flat [K, Ttot, B] with a
    schedule), emit='reduced' the per-channel s24 sums [ns2, B]; the wire
    stage, then the PDM modulator on the sub (Q28 int32 [Ttot, B]).  The
    s24 words are taken out of ``tail`` and freed before the PDM stage,
    whose words set the segment's peak memory."""
    s24 = tail.pop("s24")
    if static.emit == "full":
        out, words = tail.pop("out"), s24
        if not static.schedule:
            out, words = (_unflatten(v, Npkt, int(sched[0]))
                          for v in (out, words))
        outputs["out"], outputs["s24"] = out, words
    else:
        outputs["s24_sum"] = tail["s24_sum"]
    if static.wire:
        st = _wire_stage(static, st, s24, Ttot, outputs, groups, lanes)
    del s24
    if static.pdm_on:
        st, words = pdm_segment(st, tail.pop("sub"))
        if static.emit == "full":
            outputs["pdm"] = words                  # [Ttot, 8, B] uint32 bits
        else:
            outputs["pdm_sum"] = words.sum(dim=(0, 1),
                                           dtype=torch.int64) & 0xFFFFFFFF
    return st


def _master_lane(static: StaticChain, p) -> bool:
    """Whether scan A runs per lane (the cascade kernels' per-lane
    coefficients): any leaf it reads carries a stream axis.  Those are the
    master EQ rows (``eq_f32`` or ``eq_q28``), the loudness rows
    (``loud_sva`` or ``loud_qbq``) or bypass flags, and the leveller's RMS
    alpha.  The JAX package decides the Q28 chain's from ``eq_q28`` alone;
    configs that share their EQ still differ per lane in the loudness row
    and its bypass flags (another host volume) or in the leveller's RMS
    alpha (another RMS time)."""
    eq, loud = ((p.eq_f32, p.loud_sva) if static.is_float
                else (p.eq_q28, p.loud_qbq))
    return (eq.dim() == 4
            or (static.loudness_on and (loud.dim() == 3
                                        or p.loud_bypass.dim() == 2))
            or (static.leveller_on and p.lev.dim() == 2))


def _f32_rows(p, bands, nb, lane, B, dev, prefix):
    """One float cascade's coefficient rows: the ``prefix`` rows ([11] or
    [11, B]), its ``bands``' and SKIP rows (a pass-through) up to ``nb``
    bands.  Returns (cf [nr, 11], or [nr, 11, B] with ``lane``; its
    kinds)."""
    pad = nb - len(bands)
    rows = list(prefix) + [p.eq_f32[c, band] for c, band, _k in bands]
    rows += [torch.zeros(11, dtype=_F32, device=dev)] * pad
    if lane:
        rows = [r.unsqueeze(-1).expand(11, B) if r.dim() == 1 else r
                for r in rows]
    cf = (torch.stack(rows) if rows else
          torch.zeros((0, 11, B) if lane else (0, 11), dtype=_F32,
                      device=dev))
    return cf, tuple(k for _c, _b, k in bands) + (SKIP,) * pad


def _f32_master(static: StaticChain, p, st, bl, br, master_bands, sched):
    """Scan A as one float cascade call over G=2 (master L, R): the
    loudness prefix, the master bands (SKIP rows pad the shorter channel)
    and the leveller envelope (kernels/eq_f32_cuda.py).  ``st`` holds this
    segment's own eq_* copies, written in place.  Returns (st', bl', br',
    env_ends [2, Npkt, B] | None)."""
    dev = bl.device
    B = bl.shape[-1]
    has_loud, has_env = static.loudness_on, static.leveller_on
    lane = _master_lane(static, p)
    lay = layout.master_cascades(static, master_bands)
    loud = ()
    if has_loud:               # [2, 6(, B)] rows padded to the 11 columns
        pad = torch.zeros((2, 5) + tuple(p.loud_sva.shape[2:]), dtype=_F32,
                          device=dev)
        loud = tuple(torch.cat([p.loud_sva, pad], dim=1))
    cf, kinds = zip(*(_f32_rows(p, bands, lay.nb, lane, B, dev, loud)
                      for bands in lay.bands))
    zero = torch.zeros((), dtype=_F32, device=dev)
    vals = ([p.loud_bypass[0].to(_F32), p.loud_bypass[1].to(_F32)]
            if has_loud else [zero, zero])
    vals += [p.lev[0], 1.0 - p.lev[0]] if has_env else [zero, zero]
    # the same scalars for L and R: [4], or [4, B] per lane
    scal = torch.stack([v.expand(B) if lane else v for v in vals])
    y, env, sF = f32_cascades(
        torch.stack([bl, br]), torch.stack(cf), layout.states(lay, st),
        scal.expand(2, *scal.shape).contiguous(), kinds=kinds,
        has_loud=has_loud, has_env=has_env, tc=int(sched[0]),
        sched=static.schedule or None)
    return layout.scatter(lay, st, sF), y[0], y[1], env


def _f32_outputs(static: StaticChain, p, st, bl, br, out_bands, sched):
    """PASS 3-5 of the scan lowering: the crossfeed kernel, the matrix mix
    as torch ops (the JAX package's four cases, usb_audio.c:751-779), then
    scan B as one float cascade call over the live outputs.  Returns (st',
    bufs, one [Ttot, B] tensor an output)."""
    if static.crossfeed_on:
        with span("dspi.xf"):
            bl, br, s4 = xf_f32(bl.contiguous(), br.contiguous(), p.xf,
                                torch.cat([st.xf_lp, st.xf_ap]))
            st = st._replace(xf_lp=s4[:2], xf_ap=s4[2:])
    bufs = []
    with span("dspi.mix"):
        for o in range(static.n_outputs):
            if not static.output_enabled[o]:
                bufs.append(torch.zeros_like(bl))
                continue
            gl, gr = p.matrix_gain[0, o], p.matrix_gain[1, o]
            pl, pr = bl * gl, br * gr
            bufs.append(torch.where(
                (gl != 0.0) & (gr != 0.0), pl + pr,
                torch.where(gl != 0.0, pl,
                            torch.where(gr != 0.0, pr,
                                        torch.zeros_like(pr)))))
            del pl, pr
    if not out_bands:
        return st, bufs
    with span("dspi.out_eq"), span("dspi.f32_cascade"):
        st = _f32_outeq(static, p, st, bufs, out_bands, sched)
    return st, bufs


def _f32_outeq(static: StaticChain, p, st, bufs, out_bands, sched):
    """Scan B as one float cascade call over the live outputs' planes of
    ``bufs``, replaced in place by their outputs.  Returns st'."""
    lay = layout.output_cascades(out_bands)
    lane = p.eq_f32.dim() == 4
    B, dev = bufs[lay.keys[0]].shape[-1], bufs[lay.keys[0]].device
    cf, kinds = zip(*(_f32_rows(p, bands, lay.nb, lane, B, dev, ())
                      for bands in lay.bands))
    x = torch.stack([bufs[o] for o in lay.keys])
    for o in lay.keys:             # the stack holds them: free the planes
        bufs[o] = None
    y, _, sF = f32_cascades(
        x, torch.stack(cf), layout.states(lay, st),
        torch.zeros((len(lay.keys), 4, B) if lane else (len(lay.keys), 4),
                    dtype=_F32, device=dev), kinds=kinds, tc=int(sched[0]),
        sched=static.schedule or None)
    del x
    st = layout.scatter(lay, st, sF)
    for k, o in enumerate(lay.keys):
        bufs[o] = y[k]
    return st


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
    with span("dspi.segment", x.device):
        if static.mxu and blocks is None:
            raise ValueError("the block-matmul lowering needs its block "
                             "matrices (blocks=mxu.build_blocks(...))")
        x2, sched, Npkt, Ttot = _segment_layout(static, x)
        dev = x.device
        nout = static.n_outputs
        master_bands, out_bands = _chain_structure(static)
        if preset_mute is None:
            preset_mute = torch.ones((Npkt,), dtype=_F32, device=dev)
        st = state._replace(eq_a=state.eq_a.clone(), eq_b=state.eq_b.clone(),
                            eq_c=state.eq_c.clone(), eq_d=state.eq_d.clone())
        # the leveller's and the tail's packet ends (a schedule's)
        ends = _packet_ends(static, sched, dev)

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
                with span("dspi.f32_cascade"):
                    st, bl, br, env = _f32_master(static, p, st, bl, br,
                                                  master_bands, sched)
                if static.leveller_on:
                    env_l, env_r = env[0], env[1]

        # ---- PASS 2.5 leveller block phase (leveller.c:147-262) ----
        if static.leveller_on:
            with span("dspi.leveller"):
                st, bl, br = _leveller(static, p, st, bl, br, env_l, env_r,
                                       Ttot, ends)
                del env_l, env_r

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
            # output gains (usb_audio.c:885-894): every output's gain of
            # each packet through the preset-mute envelope, one product,
            # [nout, Npkt, 1|B]; the tail kernel applies them
            gains = p.out_gain.reshape(nout, 1, -1) * vol_mul_master
            st, tail, peaks = _tail(static, p, st, bufs, gains, ends,
                                    peak_ml, peak_mr, C.CLIP_THRESH_F)
            # dead from here: freed before the PDM stage
            del bufs, gains

        with span("dspi.wire"):
            outputs = {}
            # peak u16 conversion (usb_audio.c:841,921):
            # trunc(min(1,peak)*32767)
            outputs["peaks"] = (torch.clamp(peaks, max=1.0)
                                * 32767.0).trunc().to(torch.int32)
            # S/PDIF words (usb_audio.c:934-940) and the sub: the tail's
            st = _s24_wire_pdm(static, st, outputs, tail, sched, Npkt, Ttot,
                               groups, wire_lanes)
        return st, outputs


# ----------------------------------------------------------------------------
# the Q28 segment processor (RP2040)
# ----------------------------------------------------------------------------

_IDENT_Q28 = (C.Q28_ONE, 0, 0, 0, 0)        # an exact pass-through band row


def _q28_rows(p, bands, nb, lane, B, dev, prefix):
    """One Q28 cascade's coefficient rows: the ``prefix`` rows ([n, 5] or
    [n, 5, B]), its ``bands``' and exact pass-through rows up to ``nb``
    bands.  Returns cf [nr, 5], or [nr, 5, B] with ``lane``, where a
    config-uniform row (the identity, a collapsed leaf of
    ``build_params_multi``) broadcasts over the lanes."""
    rows = list(prefix) + [p.eq_q28[c, band][None] for c, band, _k in bands]
    rows += [upload([_IDENT_Q28], dev, _I32)] * (nb - len(bands))
    if lane:
        rows = [r.unsqueeze(-1).expand(*r.shape, B) if r.dim() == 2 else r
                for r in rows]
    if rows:
        return torch.cat(rows)
    return torch.zeros((0, 5, B) if lane else (0, 5), dtype=_I32, device=dev)


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
    lay = layout.master_cascades(static, master_bands)
    loud = [p.loud_qbq] if has_loud else []
    cf = [_q28_rows(p, bands, lay.nb, lane, B, dev, loud)
          for bands in lay.bands]
    zero = torch.zeros((), dtype=_I32, device=dev)
    vals = ([p.loud_bypass[0], p.loud_bypass[1]] if has_loud
            else [zero, zero])
    vals += [a_rms_q28, one_minus] if has_env else [zero, zero]
    # the same scalars for L and R: [4], or [4, B] per lane
    scal = torch.stack([v.to(_I32).expand(B) if lane else v.to(_I32)
                        for v in vals])
    y, env, sF = q28_cascades(
        torch.stack([bl, br]), torch.stack(cf), layout.states(lay, st),
        scal.expand(2, *scal.shape).contiguous(), nb=lay.nb,
        has_loud=has_loud, has_env=has_env, tc=int(sched[0]),
        sched=static.schedule or None)
    return layout.scatter(lay, st, sF), y[0], y[1], env


def _q28_outeq(static: StaticChain, p, st, bufs, out_bands, sched):
    """Scan B as one cascade call over the live outputs, as the JAX
    package's ``_q28_kernel_outeq`` builds it; per-lane when the EQ
    coefficients are."""
    lay = layout.output_cascades(out_bands)
    lane = p.eq_q28.dim() == 4
    B, dev = bufs[lay.keys[0]].shape[-1], bufs[lay.keys[0]].device
    cf = [_q28_rows(p, bands, lay.nb, lane, B, dev, ())
          for bands in lay.bands]
    scal = torch.zeros((len(lay.keys), 4, B) if lane else (len(lay.keys), 4),
                       dtype=_I32, device=dev)
    y, _, sF = q28_cascades(
        torch.stack([bufs[o] for o in lay.keys]), torch.stack(cf),
        layout.states(lay, st), scal, nb=lay.nb, tc=int(sched[0]),
        sched=static.schedule or None)
    st = layout.scatter(lay, st, sF)
    for k, o in enumerate(lay.keys):
        bufs[o] = y[k]
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
    with span("dspi.segment", x.device):
        x2, sched, Npkt, Ttot = _segment_layout(static, x)
        nout = static.n_outputs
        dev = x.device
        master_bands, out_bands = _chain_structure(static)
        if preset_mute is None:
            preset_mute = torch.ones((Npkt,), dtype=_F32, device=dev)
        st = state._replace(eq_a=state.eq_a.clone(), eq_b=state.eq_b.clone())
        # the leveller's and the output gains' packet ends (a schedule's)
        ends = _packet_ends(static, sched, dev)

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
                st, bl, br = _leveller(static, p, st, bl, br, env[0], env[1],
                                       Ttot, ends)
                # dead from here: freed before the wire stage, where the
                # segment's memory peaks
                del env

        with span("dspi.outputs"):
            # ---- PASS 3: master peaks, then the crossfeed kernel ----
            peak_ml = bl.abs().amax(dim=0)
            peak_mr = br.abs().amax(dim=0)
            if static.crossfeed_on:
                with span("dspi.xf"):
                    bl, br, s4 = xf_q28(bl.contiguous(), br.contiguous(),
                                        p.xf, torch.cat([st.xf_lp, st.xf_ap]))
                    st = st._replace(xf_lp=s4[:2], xf_ap=s4[2:])

            # ---- PASS 4: matrix (usb_audio.c:1075-1100), every enabled
            # output in one Q15 kernel launch.  q15_mul(x, 0) == 0, so the
            # firmware's branches on zero gains all come to this sum ----
            with span("dspi.mix"):
                bufs = q15_mix(bl.contiguous(), br.contiguous(),
                               p.matrix_gain.contiguous(),
                               static.output_enabled)
            del bl, br

            # ---- PASS 5: per-output EQ ----
            if out_bands:
                with span("dspi.out_eq"):
                    st, bufs = _q28_outeq(static, p, st, bufs, out_bands,
                                          sched)

        with span("dspi.tail"):
            # output gains (usb_audio.c:1203-1212): the float multiply,
            # every output's at once ([nout, Npkt, 1|B]); the tail kernel
            # applies them as Q15 products (a zero gain needs no branch:
            # q15_mul(x, 0) == 0)
            gains = f32_to_i32(p.out_gain.reshape(nout, 1, -1)
                               * vol_mul_master.to(_F32))
            st, tail, peaks = _tail(static, p, st, bufs, gains, ends,
                                    peak_ml, peak_mr, C.CLIP_THRESH_Q28)
            # dead from here: freed before the PDM stage
            del bufs, gains, ends

        with span("dspi.wire"):
            # peak u16 conversion (usb_audio.c:1239): peak >> 13
            outputs = {"peaks": (peaks >> 13) & 0xFFFF}
            # S/PDIF words (usb_audio.c:1244-1257) and the sub: the tail's
            st = _s24_wire_pdm(static, st, outputs, tail, sched, Npkt, Ttot,
                               groups, wire_lanes)
        return st, outputs
