"""The float EQ cascade kernel's wrapper: the front door ``f32_cascades``.

On a CUDA tensor it launches ``csrc/eq_f32.cu`` or raises; on a CPU tensor
it runs the plain version, ``kernels.eq_f32.f32_cascades_plain``.  There is
no other path.  Layout and signature, the per-lane form and packet
schedules are in ``kernels/eq_f32.py``.

The kernel is compiled for one band-kinds signature at a time
(``signature``: a cascade's band kinds, loudness, envelope and per-lane
flags packed into one 64-bit code), each into its own library, built with
nvcc at the signature's first use.  A call launches once a distinct
signature of its cascades (``split``); each launch is given its cascades'
indices and reads and writes them in place.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..core import constants as C
from . import LAUNCHES, build
from .eq import packet_ends
from .eq_f32 import check_f32_args, f32_cascades_plain

_I32 = torch.int32
_KIND_BITS, _KINDS_AT = 3, 8


def signature(kinds, has_loud: bool, has_env: bool, lane: bool) -> int:
    """The packed signature of one cascade of band ``kinds``: bits 0-3 the
    band count, 4 loudness, 5 envelope, 6 per-lane coefficients, and
    8 + 3j the kind of band j (``csrc/eq_f32.cu`` reads the same)."""
    kinds = tuple(int(k) for k in kinds)
    if len(kinds) > C.MAX_BANDS or any(k not in range(6) for k in kinds):
        raise ValueError(f"no signature for band kinds {kinds}")
    sig = len(kinds) | has_loud << 4 | has_env << 5 | lane << 6
    for j, k in enumerate(kinds):
        sig |= k << (_KINDS_AT + _KIND_BITS * j)
    return sig


def unpack_signature(sig: int) -> tuple:
    """(kinds, has_loud, has_env, lane) of a packed signature."""
    kinds = tuple(sig >> (_KINDS_AT + _KIND_BITS * j) & 7
                  for j in range(sig & 0xF))
    return kinds, bool(sig >> 4 & 1), bool(sig >> 5 & 1), bool(sig >> 6 & 1)


def split(kinds, has_loud: bool, has_env: bool, lane: bool) -> list:
    """A call's launches: (signature, the indices of its cascades) for each
    distinct signature, in the order of first appearance."""
    groups: dict = {}
    for g, row in enumerate(kinds):
        groups.setdefault(signature(row, has_loud, has_env, lane),
                          []).append(g)
    return [(sig, tuple(idx)) for sig, idx in groups.items()]


def defines(sig: int) -> tuple:
    """The nvcc defines of ``sig``'s library."""
    return (f"-DEQF_SIG={sig:#x}ull",)


# the libraries this process has loaded, by (source directory, signature)
_LOADED: dict = {}


def libraries(sigs, src_dir=build.SRC_DIR) -> dict:
    """{signature: its loaded library} for ``sigs``, every missing library
    built at once (one nvcc each, in parallel)."""
    sigs, src_dir = tuple(dict.fromkeys(sigs)), Path(src_dir)
    new = [s for s in sigs if (src_dir, s) not in _LOADED]
    missing = [("eq_f32", src_dir, defines(s)) for s in new
               if not build.lib_path("eq_f32", src_dir, defines(s)).exists()]
    if missing:
        build.build_all((), (), missing)
    for s in new:
        _LOADED[src_dir, s] = build.load("eq_f32", src_dir, defines(s))
    return {s: _LOADED[src_dir, s] for s in sigs}


def loaded(src_dir=build.SRC_DIR) -> tuple:
    """The signatures whose libraries this process has loaded from
    ``src_dir``, in load order."""
    return tuple(s for d, s in _LOADED if d == Path(src_dir))


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_eq_f32`` with its C signature set."""
    fn = lib.dspi_eq_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_uint64] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def occupancy(lib: ctypes.CDLL) -> dict:
    """{"threads": a block, "registers": a thread, "blocks_per_sm":
    resident} of ``lib``'s instance."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.dspi_eq_f32_occupancy(*map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"float cascade occupancy query: CUDA error {rc}")
    return dict(zip(("threads", "registers", "blocks_per_sm"),
                    (v.value for v in vals)))


@functools.lru_cache(maxsize=32)
def _ends_on(T: int, tc: int, sched, device) -> torch.Tensor:
    """The packet ends as the kernel reads them, then a sentinel T, on
    ``device`` (kept: the paths call with the same geometry every
    segment)."""
    return torch.tensor(packet_ends(T, tc, sched) + (T,), dtype=_I32,
                        device=device)


def launch(libs: dict, plan, x, cf, s0, scal, *, has_env=False, tc=48,
           sched=None):
    """The launches of one call on checked, contiguous, non-empty CUDA
    tensors, one for each (signature, cascades) of ``plan`` (``split``),
    through ``libs[signature]`` (``libraries``): (y, env_ends | None,
    s_final)."""
    G, T, B = x.shape
    ends = packet_ends(T, tc, sched) if has_env else ()
    y = torch.empty_like(x)
    env = (torch.empty((G, len(ends), B), dtype=x.dtype, device=x.device)
           if has_env else None)
    s_out = torch.empty_like(s0)
    ends_t = _ends_on(T, tc, sched, x.device) if has_env else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for sig, idx in plan:
        groups = (None if len(idx) == G else
                  torch.tensor(idx, dtype=_I32, device=x.device))
        with torch.cuda.device(x.device):
            rc = bind(libs[sig])(
                sig, x.data_ptr(), cf.data_ptr(), s0.data_ptr(),
                scal.data_ptr(), None if groups is None else groups.data_ptr(),
                None if ends_t is None else ends_t.data_ptr(), y.data_ptr(),
                None if env is None else env.data_ptr(), s_out.data_ptr(),
                len(idx), T, B, len(ends), stream)
        if rc != 0:
            raise RuntimeError(f"float cascade kernel launch failed: CUDA "
                               f"error {rc}")
    return y, env, s_out


def f32_cascades(x, cf, s0, scal, *, kinds, has_loud=False, has_env=False,
                 tc=48, sched=None):
    """G float cascades over a segment -> (y, env_ends | None, s_final).
    One launch a distinct signature of the cascades; ``LAUNCHES`` counts
    each under ``eq_f32``, and also under ``eq_f32_lane`` and
    ``eq_f32_sched`` for per-lane coefficients and schedules."""
    kinds = tuple(tuple(int(k) for k in row) for row in kinds)
    sched = tuple(int(n) for n in sched) if sched else None
    G, T, B, S, nb, ends = check_f32_args(
        x, cf, s0, scal, kinds=kinds, has_loud=has_loud, has_env=has_env,
        tc=tc, sched=sched)
    if x.device.type == "cpu":
        return f32_cascades_plain(x, cf, s0, scal, kinds=kinds,
                                  has_loud=has_loud, has_env=has_env, tc=tc,
                                  sched=sched)
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
    lane = cf.dim() == 4
    plan = split(kinds, has_loud, has_env, lane)
    out = launch(libraries(sig for sig, _ in plan), plan, x, cf, s0, scal,
                 has_env=has_env, tc=tc, sched=sched)
    LAUNCHES["eq_f32"] += len(plan)
    if lane:
        LAUNCHES["eq_f32_lane"] += len(plan)
    if sched:
        LAUNCHES["eq_f32_sched"] += len(plan)
    return out
