"""The float EQ cascade kernel's wrapper: the front door ``f32_cascades``.

On a CUDA tensor it launches ``csrc/eq_f32.cu`` (built with nvcc at first
use) or raises; on a CPU tensor it runs the plain version,
``kernels.eq_f32.f32_cascades_plain``.  There is no other path.  Layout and
signature, the per-lane form and packet schedules are in
``kernels/eq_f32.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build
from .eq import packet_ends
from .eq_f32 import check_f32_args, f32_cascades_plain

_I32 = torch.int32


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_eq_f32`` with its C signature set."""
    fn = lib.dspi_eq_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, x, cf, s0, scal, *, kinds, has_loud=False, has_env=False,
           tc=48, sched=None):
    """One launch of ``fn``, a bound ``dspi_eq_f32``, on checked,
    contiguous, non-empty CUDA tensors: (y, env_ends | None, s_final)."""
    G, T, B = x.shape
    nb = len(kinds[0])
    ends = packet_ends(T, tc, sched) if has_env else ()
    y = torch.empty_like(x)
    env = (torch.empty((G, len(ends), B), dtype=x.dtype, device=x.device)
           if has_env else None)
    s_out = torch.empty_like(s0)
    kinds_t = (torch.tensor(kinds, dtype=_I32, device=x.device)
               if nb else None)
    # a schedule's packet ends go to the kernel; uniform packets need none
    ends_t = (torch.tensor(ends, dtype=_I32, device=x.device)
              if has_env and sched else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), cf.data_ptr(), s0.data_ptr(), scal.data_ptr(),
                None if kinds_t is None else kinds_t.data_ptr(),
                None if ends_t is None else ends_t.data_ptr(), y.data_ptr(),
                None if env is None else env.data_ptr(), s_out.data_ptr(), G,
                T, B, nb, int(has_loud), int(has_env), int(cf.dim() == 4),
                len(ends), tc, stream)
    if rc != 0:
        raise RuntimeError(f"float cascade kernel launch failed: CUDA error "
                           f"{rc}")
    return y, env, s_out


def f32_cascades(x, cf, s0, scal, *, kinds, has_loud=False, has_env=False,
                 tc=48, sched=None):
    """G float cascades over a segment -> (y, env_ends | None, s_final).
    ``LAUNCHES`` counts every launch under ``eq_f32``, and also under
    ``eq_f32_lane`` and ``eq_f32_sched`` for per-lane coefficients and
    schedules."""
    kinds = tuple(tuple(int(k) for k in row) for row in kinds)
    G, T, B, S, nb, ends = check_f32_args(
        x, cf, s0, scal, kinds=kinds, has_loud=has_loud, has_env=has_env,
        tc=tc, sched=sched)
    kw = dict(kinds=kinds, has_loud=has_loud, has_env=has_env, tc=tc,
              sched=sched)
    if x.device.type == "cpu":
        return f32_cascades_plain(x, cf, s0, scal, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no float cascade kernel for device {x.device}")
    if not all(v.is_contiguous() for v in (x, cf, s0, scal)):
        raise ValueError("f32_cascades wants contiguous tensors")
    if max(G * T, B) >= 2**31:
        raise ValueError(f"segment too large: {G} x {T} x {B}")
    if G == 0 or T == 0 or B == 0:
        env = (torch.empty((G, len(ends), B), dtype=x.dtype, device=x.device)
               if has_env else None)
        return torch.empty_like(x), env, s0.clone()
    out = launch(bind(build.load("eq_f32")), x, cf, s0, scal, **kw)
    LAUNCHES["eq_f32"] += 1
    if cf.dim() == 4:
        LAUNCHES["eq_f32_lane"] += 1
    if sched:
        LAUNCHES["eq_f32_sched"] += 1
    return out
