"""The Q28 EQ cascade kernel's wrapper: the front door ``q28_cascades``.

On a CUDA tensor it launches ``csrc/eq_q28.cu`` (built with nvcc at first
use) or raises; on a CPU tensor it runs the plain version,
``kernels.eq.q28_cascades_plain``.  There is no other path.  Layout and
signature, the per-lane (``lane_cf``) form and packet schedules are in
``kernels/eq.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime.telemetry import span, upload
from . import LAUNCHES, build
from .eq import check_cascade_args, packet_ends, q28_cascades_plain

_I32 = torch.int32


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_eq_q28`` with its C signature set."""
    fn = lib.dspi_eq_q28
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, x, cf, s0, scal, *, nb, has_loud=False, has_env=False,
           tc=48, sched=None):
    """One launch of ``fn``, a bound ``dspi_eq_q28`` (this repo's, or
    another revision's for a comparison), on checked, contiguous, non-empty
    CUDA tensors: (y, env_ends | None, s_final)."""
    G, T, B = x.shape
    ends = packet_ends(T, tc, sched) if has_env else ()
    y = torch.empty_like(x)
    env = (torch.empty((G, len(ends), B), dtype=_I32, device=x.device)
           if has_env else None)
    s_out = torch.empty_like(s0)
    # a schedule's packet ends go to the kernel; uniform packets need none
    ends_t = None
    if has_env and sched:
        with span("dspi.sched"):
            ends_t = upload(ends, x.device, _I32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), cf.data_ptr(), s0.data_ptr(), scal.data_ptr(),
                None if ends_t is None else ends_t.data_ptr(), y.data_ptr(),
                None if env is None else env.data_ptr(), s_out.data_ptr(), G,
                T, B, nb, int(has_loud), int(has_env), int(cf.dim() == 4),
                len(ends), tc, stream)
    if rc != 0:
        raise RuntimeError(f"cascade kernel launch failed: CUDA error {rc}")
    return y, env, s_out


def q28_cascades(x, cf, s0, scal, *, nb, has_loud=False, has_env=False,
                 tc=48, sched=None):
    """G Q28 cascades over a segment -> (y, env_ends | None, s_final).
    ``LAUNCHES`` counts every launch under ``eq_q28``, and also under
    ``eq_q28_lane_cf`` and ``eq_q28_sched`` for those modes."""
    G, T, B, S, ends = check_cascade_args(
        x, cf, s0, scal, nb=nb, has_loud=has_loud, has_env=has_env, tc=tc,
        sched=sched)
    if x.device.type == "cpu":
        return q28_cascades_plain(x, cf, s0, scal, nb=nb, has_loud=has_loud,
                                  has_env=has_env, tc=tc, sched=sched)
    if x.device.type != "cuda":
        raise ValueError(f"no cascade kernel for device {x.device}")
    if not all(v.is_contiguous() for v in (x, cf, s0, scal)):
        raise ValueError("q28_cascades wants contiguous tensors")
    if max(G * T, B) >= 2**31:
        raise ValueError(f"segment too large: {G} x {T} x {B}")
    if G == 0 or T == 0 or B == 0:
        env = (torch.empty((G, len(ends), B), dtype=_I32, device=x.device)
               if has_env else None)
        return torch.empty_like(x), env, s0.clone()
    out = launch(bind(build.load("eq_q28")), x, cf, s0, scal, nb=nb,
                 has_loud=has_loud, has_env=has_env, tc=tc, sched=sched)
    LAUNCHES["eq_q28"] += 1
    if cf.dim() == 4:
        LAUNCHES["eq_q28_lane_cf"] += 1
    if sched:
        LAUNCHES["eq_q28_sched"] += 1
    return out
