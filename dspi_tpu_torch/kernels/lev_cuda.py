"""The leveller's packet recurrence: its plain PyTorch version and its
kernel's wrapper.

Once a packet the leveller smooths its gain (dB) toward the gain
computer's target with the attack or the release coefficient raised to
the packet's length (leveller.c:182-185, 223-227), the JAX package's
``lev_step`` scan (chain/pipeline.py:518-527 float, :992-999 Q28), with
both products through ``fmath.smooth_det``.  Both chains call
``lev_smooth``: it launches ``csrc/lev.cu`` on a CUDA tensor or raises; on
a CPU tensor it runs ``lev_smooth_plain``, a Python loop over packets
vectorized over streams.  The alpha tables are the same for every stream
([Npkt, 1], uniform parameters) or per stream ([Npkt, B]).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import fmath
from . import LAUNCHES, build

_F32 = torch.float32


def _check(gc, pow_att, pow_rel, gdb0):
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
    """gc float32 [Npkt, B] (targets, dB); pow_att, pow_rel float32
    [Npkt, 1] or [Npkt, B] (alpha^count of each packet); gdb0 float32 [B]
    -> gdbs float32 [Npkt, B], the smoothed gain after each packet."""
    _check(gc, pow_att, pow_rel, gdb0)
    gdb = gdb0
    gdbs = []
    for k in range(gc.shape[0]):
        alpha = torch.where(gc[k] < gdb, pow_att[k], pow_rel[k])
        gdb = fmath.smooth_det(alpha, gdb, gc[k])
        gdbs.append(gdb)
    return torch.stack(gdbs)


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_lev_smooth`` with its C signature set."""
    fn = lib.dspi_lev_smooth
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, gc, pow_att, pow_rel, gdb0):
    """One launch of ``fn``, a bound ``dspi_lev_smooth``, on checked,
    contiguous, non-empty CUDA tensors: gdbs."""
    npkt, B = gc.shape
    gdbs = torch.empty_like(gc)
    stream = torch.cuda.current_stream(gc.device).cuda_stream
    with torch.cuda.device(gc.device):
        rc = fn(gc.data_ptr(), pow_att.data_ptr(), pow_rel.data_ptr(),
                gdb0.data_ptr(), gdbs.data_ptr(), npkt, B,
                int(pow_att.shape[1] != 1), stream)
    if rc != 0:
        raise RuntimeError(f"leveller smoothing kernel launch failed: CUDA "
                           f"error {rc}")
    return gdbs


def lev_smooth(gc, pow_att, pow_rel, gdb0):
    """The smoothed gain over a segment's packets (signature of
    ``lev_smooth_plain``)."""
    _check(gc, pow_att, pow_rel, gdb0)
    if gc.device.type == "cpu":
        return lev_smooth_plain(gc, pow_att, pow_rel, gdb0)
    if gc.device.type != "cuda":
        raise ValueError(f"no leveller smoothing kernel for device "
                         f"{gc.device}")
    if not all(v.is_contiguous() for v in (gc, pow_att, pow_rel, gdb0)):
        raise ValueError("lev_smooth wants contiguous tensors")
    npkt, B = gc.shape
    if npkt >= 2**31 or B >= 2**31:
        raise ValueError(f"segment too large: {npkt} x {B}")
    if B == 0:
        return torch.empty_like(gc)
    out = launch(bind(build.load("lev")), gc, pow_att, pow_rel, gdb0)
    LAUNCHES["lev_smooth"] += 1
    return out
