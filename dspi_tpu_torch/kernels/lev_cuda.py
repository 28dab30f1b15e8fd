"""The leveller's block phase (PASS 2.5, leveller.c:147-262 / 274-389):
its plain PyTorch versions and its two kernels' wrappers, both chains.

``lev_gain`` runs once a packet: the gain computer over each packet's end
envelope, the attack/release smoothing of the gain in dB with the alpha
tables raised to the packet's length (``lev_smooth_plain``, both products
through ``fmath.smooth_det``; the JAX package's ``lev_step`` scan), and
the linear gain ``exp10(gdb / 20)``, in Q28 on the RP2040 chain.
``lev_apply`` runs once a sample: the gain ramp between packets, the
lookahead ring, the limiter's cap and the gained output.  On a CUDA tensor
each launches its kernel in ``csrc/lev.cu`` once or raises; on a CPU
tensor it runs its plain version, whole-segment tensor ops with the
integer ``fmath`` polynomials, which the kernels equal bit for bit.

The planes' dtype picks the chain: float32 samples and gains, or the Q28
chain's int32 (envelopes read as ``* 2^-28``).  ``lev``, the 11 parameter
rows of ``pack.build_params``, is [11] or per lane [11, B].  Packets are
uniform (``Ttot / Npkt`` samples each) or given by ``ends``, int32 [Npkt]
on the tensors' device, each packet's end (the schedule's cumsum), as
``q15_cuda.q15_gain`` takes them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import constants as C
from ..core import fmath
from ..core.packets import _pkts_to_flat
from ..core.qmath import f32_to_i32, q28_mul, wrap32
from . import LAUNCHES, build

_F32 = torch.float32
_I32 = torch.int32
_INV20 = float(np.float32(1.0) / np.float32(20.0))
_TINY = float(np.float32(1e-30))
_INV_Q28 = 2.0 ** -28
_CEIL = float(np.float32(C.LEVELLER_LIMITER_CEIL))
_MAX_PACKETS = 65535            # lev_apply's grid rows


def _check_smooth(gc, pow_att, pow_rel, gdb0):
    for name, v in (("gc", gc), ("pow_att", pow_att), ("pow_rel", pow_rel),
                    ("gdb0", gdb0)):
        if v.dtype != _F32:
            raise TypeError(f"lev_smooth wants float32 {name}, got {v.dtype}")
        if v.device != gc.device:
            raise ValueError(f"{name} on {v.device}, gc on {gc.device}")
    if gc.dim() != 2 or gc.shape[0] < 1 \
            or pow_att.shape not in ((gc.shape[0], 1), tuple(gc.shape)) \
            or pow_rel.shape != pow_att.shape \
            or gdb0.shape != (gc.shape[1],):
        raise ValueError(
            f"lev_smooth wants gc [Npkt >= 1, B], pow_att and pow_rel both "
            f"[Npkt, 1] or [Npkt, B], gdb0 [B]; got {tuple(gc.shape)}, "
            f"{tuple(pow_att.shape)}, {tuple(pow_rel.shape)}, "
            f"{tuple(gdb0.shape)}")


def lev_smooth_plain(gc, pow_att, pow_rel, gdb0):
    """The smoothing recurrence: gc float32 [Npkt, B] (targets, dB);
    pow_att, pow_rel float32 [Npkt, 1] or [Npkt, B] (alpha^count of each
    packet); gdb0 float32 [B] -> gdbs float32 [Npkt, B], the smoothed gain
    after each packet."""
    _check_smooth(gc, pow_att, pow_rel, gdb0)
    gdb = gdb0
    gdbs = []
    for k in range(gc.shape[0]):
        alpha = torch.where(gc[k] < gdb, pow_att[k], pow_rel[k])
        gdb = fmath.smooth_det(alpha, gdb, gc[k])
        gdbs.append(gdb)
    return torch.stack(gdbs)


def _check_same(name, ref, tensors):
    for label, v in tensors:
        if v.device != ref.device:
            raise ValueError(f"{name}: {label} on {v.device}, the planes on "
                             f"{ref.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} wants contiguous tensors ({label})")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no leveller kernel for device {ref.device}")


def _packets(name, npkt, Ttot, ends, dev):
    """Each packet's length for uniform packets (an int), or None for
    packets given by ``ends``; raises on packets that do not tile Ttot
    samples (ends are read on the CPU only: on the card ``lev_apply``
    clamps each packet's rows to the planes, and ``lev_gain`` reads ends
    only for the packet's length, so both stay in bounds whatever the
    ends hold)."""
    if not 1 <= npkt <= _MAX_PACKETS or not 1 <= Ttot < 2**31:
        raise ValueError(f"{name}: {npkt} packets of {Ttot} samples")
    if ends is None:
        if Ttot % npkt:
            raise ValueError(f"{name}: {Ttot} samples are not {npkt} "
                             f"uniform packets: pass their ends")
        return Ttot // npkt
    if ends.dtype != _I32 or ends.device != dev \
            or tuple(ends.shape) != (npkt,) or not ends.is_contiguous():
        raise ValueError(f"{name} wants ends int32 [{npkt}] on {dev}, got "
                         f"{ends.dtype} {list(ends.shape)} on {ends.device}")
    if dev.type == "cpu":
        steps = torch.diff(ends, prepend=ends.new_zeros(1))
        if int(ends[-1]) != Ttot or bool((steps < 1).any()):
            raise ValueError(f"{name}: packet ends {ends.tolist()} do not "
                             f"tile {Ttot} samples")
    return None


def _check_gain(env_l, env_r, lev, gdb0, g0, Ttot, ends):
    dt = env_l.dtype
    if dt not in (_F32, _I32) or env_r.dtype != dt or g0.dtype != dt \
            or lev.dtype != _F32 or gdb0.dtype != _F32:
        raise TypeError(f"lev_gain wants float32 or int32 envelopes and g0 "
                        f"of theirs, float32 lev and gdb0; got {dt}, "
                        f"{env_r.dtype}, {g0.dtype}, {lev.dtype}, "
                        f"{gdb0.dtype}")
    shape = tuple(env_l.shape)
    if len(shape) != 2 or 0 in shape or tuple(env_r.shape) != shape \
            or tuple(lev.shape) not in ((11,), (11, shape[1])) \
            or tuple(gdb0.shape) != shape[1:] \
            or tuple(g0.shape) != shape[1:] or shape[1] >= 2**31:
        raise ValueError(
            f"lev_gain wants envelopes [Npkt >= 1, B >= 1], lev [11] or "
            f"[11, B], gdb0 and g0 [B]; got {list(shape)}, "
            f"{list(env_r.shape)}, {list(lev.shape)}, {list(gdb0.shape)}, "
            f"{list(g0.shape)}")
    _check_same("lev_gain", env_l, (("env_l", env_l), ("env_r", env_r),
                                    ("lev", lev), ("gdb0", gdb0),
                                    ("g0", g0)))
    return _packets("lev_gain", shape[0], Ttot, ends, env_l.device)


def _check_apply(bl, br, g_cur, g0, ring, ends):
    dt = bl.dtype
    if dt not in (_F32, _I32) or any(v.dtype != dt for v in (br, g_cur, g0)) \
            or (ring is not None and ring.dtype != dt):
        raise TypeError(f"lev_apply wants planes, gains and ring all float32 "
                        f"or all int32; got {dt}, {br.dtype}, {g_cur.dtype}, "
                        f"{g0.dtype}, {None if ring is None else ring.dtype}")
    shape = tuple(bl.shape)
    if len(shape) != 2 or 0 in shape or tuple(br.shape) != shape \
            or g_cur.dim() != 2 or tuple(g_cur.shape[1:]) != shape[1:] \
            or tuple(g0.shape) != shape[1:] or shape[1] >= 2**31 \
            or (ring is not None and (ring.dim() != 3 or ring.shape[0] != 2
                                      or ring.shape[2] != shape[1])):
        raise ValueError(
            f"lev_apply wants planes [Ttot >= 1, B >= 1], g_cur [Npkt, B], "
            f"g0 [B], ring [2, L, B] or None; got {list(shape)}, "
            f"{list(br.shape)}, {list(g_cur.shape)}, {list(g0.shape)}, "
            f"{None if ring is None else list(ring.shape)}")
    _check_same("lev_apply", bl, [("br", br), ("g_cur", g_cur), ("g0", g0),
                                  ("bl", bl)]
                + ([] if ring is None else [("ring", ring)]))
    return _packets("lev_apply", g_cur.shape[0], shape[0], ends, bl.device)


def _lengths(npkt, tc, ends) -> np.ndarray:
    """Each packet's length, int64 NumPy [Npkt]."""
    if ends is None:
        return np.full(npkt, tc, np.int64)
    return np.diff(ends.cpu().numpy().astype(np.int64), prepend=0)


def lev_gain_plain(env_l, env_r, lev, gdb0, g0, Ttot, ends=None):
    """The packet-rate half of the phase.  env_l, env_r [Npkt, B]: each
    packet's end envelope, float32 or the Q28 chain's int32; lev float32
    [11] or [11, B]; gdb0 float32 [B] and g0 [B] (envelope dtype): the
    smoothed gain (dB) and the linear gain before the segment; packets of
    ``Ttot`` samples in all, uniform or ending at ``ends``.  Returns
    (g_cur [Npkt, B], the linear gain of each packet in the envelopes'
    dtype; the state's lev_gain_db, lev_gain and lev_gain_prev [B])."""
    tc = _check_gain(env_l, env_r, lev, gdb0, g0, Ttot, ends)
    q28 = env_l.dtype == _I32
    if q28:
        env_l, env_r = (v.to(_F32) * _INV_Q28 for v in (env_l, env_r))
    a_att, a_rel = lev[1], lev[2]
    thresh, knee, gate = lev[3], lev[4], lev[5]
    max_gain, makeup = lev[7], lev[8]
    slope, inv_two_knee = lev[9], lev[10]
    rms_db = 10.0 * fmath.log10_f32(torch.maximum(env_l, env_r) + _TINY)
    half = knee * 0.5
    d = thresh + half - rms_db
    zero = torch.zeros_like(rms_db)
    gc = torch.where(
        rms_db > thresh + half, zero,
        torch.where(rms_db >= thresh - half,
                    slope * d * d * inv_two_knee,
                    (thresh - rms_db) * slope))
    gc = torch.minimum(gc + makeup, max_gain)
    gc = torch.where(rms_db < gate, zero, gc)                   # [Npkt, B]
    # the alpha^count correction (leveller.c:223-227), hoisted
    counts = torch.from_numpy(
        _lengths(gc.shape[0], tc, ends).astype(np.float32))[:, None].to(
        gc.device)
    gdbs = lev_smooth_plain(gc, fmath.pow_f32(a_att, counts),
                            fmath.pow_f32(a_rel, counts), gdb0)
    g = fmath.exp10_f32(gdbs * _INV20)
    if q28:
        g = f32_to_i32(g * float(C.Q28_ONE))
    return g, gdbs[-1], g[-1], g[-2] if len(g) > 1 else g0


def _ramp_f32(g_prev, g_cur, sched):
    """The firmware's sequential accumulation g += (g_cur - g_prev) /
    (n - 1), all packets at once over the longest, [Npkt, Tmax, B]; a
    one-sample packet jumps to g_cur (leveller.c:216-221)."""
    Tmax = int(sched.max())
    if Tmax == 1:
        return g_cur[:, None]
    inv = np.zeros(len(sched), np.float32)
    nz = sched > 1
    inv[nz] = np.float32(1.0) / (sched[nz] - 1).astype(np.float32)
    step = (g_cur - g_prev) * torch.from_numpy(inv)[:, None].to(g_cur.device)
    g = g_prev
    if not nz.all():
        one = torch.from_numpy(~nz)[:, None].to(g_cur.device)
        g = torch.where(one, g_cur, g_prev)
        step = torch.where(one, torch.zeros_like(step), step)
    gains = torch.empty((len(sched), Tmax, g_cur.shape[1]), dtype=_F32,
                        device=g_cur.device)
    for i in range(Tmax):
        gains[:, i] = g
        g = g + step
    return gains


def _ramp_q28(g_prev, g_cur, sched):
    """g_prev + int64(g_cur - g_prev) * i / (n - 1) with C's truncating
    division (leveller.c:352), closed form over all packets at once,
    [Npkt, Tmax, B]; a one-sample packet jumps to g_cur."""
    Tmax = int(sched.max())
    if Tmax == 1:
        return g_cur[:, None]
    dev = g_cur.device
    diff = g_cur - g_prev                      # int32 wrap, as C
    sign = 1 - 2 * (diff < 0).to(torch.int64)[:, None, :]
    # |diff| in int64, so that diff = -2^31 gives 2^31
    q = diff.to(torch.int64).abs()[:, None, :] * torch.arange(
        Tmax, dtype=torch.int64, device=dev)[None, :, None]
    div = torch.from_numpy(np.maximum(sched - 1, 1))[:, None, None]
    q = q.floor_divide_(div.to(dev)).mul_(sign).add_(g_prev[:, None, :])
    gains = wrap32(q)
    if (sched == 1).any():
        one = torch.from_numpy(sched == 1)[:, None, None].to(dev)
        gains = torch.where(one, g_cur[:, None, :], gains)
    return gains


def lev_apply_plain(bl, br, g_cur, g0, ring=None, ends=None):
    """The sample-rate half of the phase.  bl, br [Ttot, B], float32 or
    int32 (Q28): the master L/R; g_cur [Npkt, B] and g0 [B]: each packet's
    gain and the one before the segment; ring [2, L, B], the time-ordered
    lookahead ring, or None without lookahead.  Returns (out_l, out_r, the
    gained delayed planes; ring', the last L samples of concat(ring, x),
    or None)."""
    tc = _check_apply(bl, br, g_cur, g0, ring, ends)
    Ttot = bl.shape[0]
    q28 = bl.dtype == _I32
    sched = _lengths(g_cur.shape[0], tc, ends)
    g_prev = torch.cat([g0[None], g_cur[:-1]])
    gains = _pkts_to_flat(
        (_ramp_q28 if q28 else _ramp_f32)(g_prev, g_cur, sched), sched, Ttot)
    out_l, out_r = bl, br
    if ring is not None:
        comb_l = torch.cat([ring[0], bl], dim=0)
        comb_r = torch.cat([ring[1], br], dim=0)
        ring = torch.stack([comb_l[Ttot:], comb_r[Ttot:]])
        out_l, out_r = comb_l[:Ttot], comb_r[:Ttot]
    if q28:
        # limiter (leveller.c:369-379): float peak, Q28 gain cap
        peak = torch.maximum((out_l.to(_F32) * _INV_Q28).abs(),
                             (out_r.to(_F32) * _INV_Q28).abs())
        max_g = f32_to_i32(fmath.det_div(_CEIL, peak) * float(C.Q28_ONE))
        g_eff = torch.where(
            (gains > C.Q28_ONE) & (peak > 0.0) & (max_g < gains),
            max_g.clamp(min=C.Q28_ONE), gains)
        return q28_mul(out_l, g_eff), q28_mul(out_r, g_eff), ring
    # limiter (leveller.c:240-255)
    peak = torch.maximum(out_l.abs(), out_r.abs())
    max_g = fmath.det_div(_CEIL, peak)
    cap = torch.where(max_g > 1.0, max_g, torch.ones_like(max_g))
    g_eff = torch.where((peak > 0.0) & (gains > 1.0) & (max_g < gains), cap,
                        gains)
    return out_l * g_eff, out_r * g_eff, ring


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_lev_gain`` and ``dspi_lev_apply`` with their C
    signatures set."""
    gain, apply = lib.dspi_lev_gain, lib.dspi_lev_apply
    if gain.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        gain.argtypes = [p, p, p, i, p, p, p, i, i, i, i, p, p, p, p, p]
        gain.restype = i
        apply.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i, p, p, p]
        apply.restype = i
    return gain, apply


def _ptr(v):
    return None if v is None else v.data_ptr()


def _stream(v):
    return torch.cuda.current_stream(v.device).cuda_stream


def launch_gain(fn, env_l, env_r, lev, gdb0, g0, ends, tc):
    """One launch of ``fn``, a bound ``dspi_lev_gain``, on checked CUDA
    tensors: lev_gain's four outputs."""
    npkt, B = env_l.shape
    g_cur = torch.empty_like(env_l)
    gdb, g, g_prev = torch.empty_like(gdb0), torch.empty_like(g0), \
        torch.empty_like(g0)
    with torch.cuda.device(env_l.device):
        rc = fn(env_l.data_ptr(), env_r.data_ptr(), lev.data_ptr(),
                int(lev.dim() == 2), gdb0.data_ptr(), g0.data_ptr(),
                _ptr(ends), tc or 0, npkt, B, int(env_l.dtype == _I32),
                g_cur.data_ptr(), gdb.data_ptr(), g.data_ptr(),
                g_prev.data_ptr(), _stream(env_l))
    if rc != 0:
        raise RuntimeError(f"leveller gain kernel launch failed: CUDA error "
                           f"{rc}")
    return g_cur, gdb, g, g_prev


def launch_apply(fn, bl, br, g_cur, g0, ring, ends, tc):
    """One launch of ``fn``, a bound ``dspi_lev_apply``, on checked CUDA
    tensors: lev_apply's three outputs."""
    Ttot, B = bl.shape
    out_l, out_r = torch.empty_like(bl), torch.empty_like(br)
    ring_out = None if ring is None else torch.empty_like(ring)
    with torch.cuda.device(bl.device):
        rc = fn(bl.data_ptr(), br.data_ptr(), g_cur.data_ptr(),
                g0.data_ptr(), _ptr(ring), _ptr(ring_out),
                0 if ring is None else ring.shape[1], _ptr(ends), tc or 0,
                g_cur.shape[0], Ttot, B, int(bl.dtype == _I32),
                out_l.data_ptr(), out_r.data_ptr(), _stream(bl))
    if rc != 0:
        raise RuntimeError(f"leveller apply kernel launch failed: CUDA error "
                           f"{rc}")
    return out_l, out_r, ring_out


def lev_gain(env_l, env_r, lev, gdb0, g0, Ttot, ends=None):
    """The packet-rate half of the phase (signature of
    ``lev_gain_plain``)."""
    if env_l.device.type == "cpu":
        return lev_gain_plain(env_l, env_r, lev, gdb0, g0, Ttot, ends)
    tc = _check_gain(env_l, env_r, lev, gdb0, g0, Ttot, ends)
    out = launch_gain(bind(build.load("lev"))[0], env_l, env_r, lev, gdb0,
                      g0, ends, tc)
    LAUNCHES["lev_gain"] += 1
    return out


def lev_apply(bl, br, g_cur, g0, ring=None, ends=None):
    """The sample-rate half of the phase (signature of
    ``lev_apply_plain``)."""
    if bl.device.type == "cpu":
        return lev_apply_plain(bl, br, g_cur, g0, ring, ends)
    tc = _check_apply(bl, br, g_cur, g0, ring, ends)
    out = launch_apply(bind(build.load("lev"))[1], bl, br, g_cur, g0, ring,
                       ends, tc)
    LAUNCHES["lev_apply"] += 1
    return out
