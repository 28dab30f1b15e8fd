"""The float block lowering's packet carries (chain/mxu.py): their plain
PyTorch versions and their kernel's wrappers.

``carry`` is ``mxu._apply_blocked``'s loop over packets.  With the input
responses hoisted (y = Tx x, vx = V x over the whole segment), step k
adds the state's response to the packet's outputs and advances the
state:

    y[k] += U_j @ s_k,    s_{k+1} = vx[k] + W_j @ s_k,    j = k % P.

y [N, *A, Ry, G] (updated in place), vx [N, *A, S, G], s0 [*A, S, G];
U [*A, Ry, S] and W [*A, S, S] for one matrix every packet (P = 1), or
[P, *A, Ry, S] and [P, *A, S, S] with a step axis: a periodic schedule's
pattern positions, or one matrix a packet (P = N).  The batch axes A
index the matrices and the data alike: the group's (grouped serving,
``mxu._to_groups``: group k's lanes are the k-th G of the flat lane
axis) and the batched outputs'.  Returns sF, the state after the last
step.

``env_carry`` is ``mxu.env_packet_ends``' recurrence over the packet
ends, both channels: e = aT[k] * e + c[k], flushed to 0 below 1e-30
(leveller.c:150-156); aT [Npkt] or per lane [Npkt, B] (an expanded view
is taken as it is), cl, cr [Npkt, B], el0, er0 [B].  Returns (env_l,
env_r) [Npkt, B].

On a CUDA tensor each launches its kernel in ``csrc/carry.cu`` once
(float32, the state's size S even in [2, 28]) or raises; on a CPU tensor
it runs its plain version, the loop the block lowering ran before the
kernel.  ``carry``'s plain version also takes float64 on the CPU (the
exact-map twin's, tests/fuzz_twin.py).  The kernel sums each dot product
in the state index's order, which cuBLAS's products matched bit for bit
at the float cells' shapes on an H100; no order is promised, so the card
tests hold it within 1e-6.  ``env_carry``'s kernel equals its plain
version bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build

_F32 = torch.float32
MAX_STATE = 28          # 4 loudness rows + 2 x MAX_BANDS band states


def _check_carry(y, vx, s0, U, W):
    """(N, P, A, Ry, S, G) of a checked ``carry`` call."""
    dt = y.dtype
    allowed = (_F32,) if y.device.type == "cuda" else (_F32, torch.float64)
    if dt not in allowed or any(v.dtype != dt for v in (vx, s0, U, W)):
        raise TypeError(f"carry wants y, vx, s0, U and W all of one dtype "
                        f"in {allowed} on {y.device}; got {dt}, {vx.dtype}, "
                        f"{s0.dtype}, {U.dtype}, {W.dtype}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no carry kernel for device {y.device}")
    for name, v in (("vx", vx), ("s0", s0), ("U", U), ("W", W)):
        if v.device != y.device:
            raise ValueError(f"carry: {name} on {v.device}, y on {y.device}")
    for name, v in (("y", y), ("vx", vx), ("s0", s0), ("U", U), ("W", W)):
        if not v.is_contiguous():
            raise ValueError(f"carry wants contiguous tensors ({name})")
    S = vx.shape[-2] if vx.dim() >= 3 else 0
    if y.dim() < 3 or 0 in y.shape:
        raise ValueError(f"carry wants y [N >= 1, *A, Ry >= 1, G >= 1], got "
                         f"{list(y.shape)}")
    N, A, (Ry, G) = y.shape[0], tuple(y.shape[1:-2]), tuple(y.shape[-2:])
    P = U.shape[0] if U.dim() == y.dim() else 1
    lead = (P,) if U.dim() == y.dim() else ()
    if tuple(vx.shape) != (N, *A, S, G) or tuple(s0.shape) != (*A, S, G) \
            or tuple(U.shape) != (*lead, *A, Ry, S) \
            or tuple(W.shape) != (*lead, *A, S, S) or P < 1 or N % P:
        raise ValueError(
            f"carry wants y [N, *A, Ry, G], vx [N, *A, S, G], s0 [*A, S, G], "
            f"U [(P,) *A, Ry, S] and W [(P,) *A, S, S] with N a multiple of "
            f"P; got {list(y.shape)}, {list(vx.shape)}, {list(s0.shape)}, "
            f"{list(U.shape)}, {list(W.shape)}")
    if S % 2 or not 2 <= S <= MAX_STATE:
        raise ValueError(f"carry wants an even state size in [2, "
                         f"{MAX_STATE}], got {S}")
    nA = 1
    for n in A:
        nA *= n
    if G >= 2**31 or N >= 2**31 or nA > 65535:
        raise ValueError(f"carry: {N} steps, {nA} batch rows, {G} lanes "
                         f"(at most 2^31 - 1, 65535, 2^31 - 1)")
    return N, P, nA, Ry, S, G


def carry_plain(y, vx, s0, U, W):
    """The matrix carry (signature of ``carry``), as a loop of PyTorch
    products over the steps."""
    _check_carry(y, vx, s0, U, W)
    step = U.dim() == y.dim()
    s = s0
    for k in range(y.shape[0]):
        Uk, Wk = (U[k % U.shape[0]], W[k % W.shape[0]]) if step else (U, W)
        y[k] += torch.matmul(Uk, s)
        s = vx[k] + torch.matmul(Wk, s)
    return s


def _check_env(aT, cl, cr, el0, er0):
    if any(v.dtype != _F32 for v in (aT, cl, cr, el0, er0)):
        raise TypeError(f"env_carry wants float32 tensors; got {aT.dtype}, "
                        f"{cl.dtype}, {cr.dtype}, {el0.dtype}, {er0.dtype}")
    if cl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no carry kernel for device {cl.device}")
    for name, v in (("aT", aT), ("cr", cr), ("el0", el0), ("er0", er0)):
        if v.device != cl.device:
            raise ValueError(f"env_carry: {name} on {v.device}, cl on "
                             f"{cl.device}")
    for name, v in (("cl", cl), ("cr", cr), ("el0", el0), ("er0", er0)):
        if not v.is_contiguous():
            raise ValueError(f"env_carry wants contiguous tensors ({name})")
    shape = tuple(cl.shape)
    if len(shape) != 2 or 0 in shape or tuple(cr.shape) != shape \
            or tuple(aT.shape) not in (shape[:1], shape) \
            or tuple(el0.shape) != shape[1:] \
            or tuple(er0.shape) != shape[1:] or shape[1] >= 2**31 \
            or shape[0] >= 2**31:
        raise ValueError(
            f"env_carry wants cl, cr [Npkt >= 1, B >= 1], aT [Npkt] or "
            f"[Npkt, B], el0, er0 [B]; got {list(cl.shape)}, "
            f"{list(cr.shape)}, {list(aT.shape)}, {list(el0.shape)}, "
            f"{list(er0.shape)}")


def env_carry_plain(aT, cl, cr, el0, er0):
    """The envelope carry (signature of ``env_carry``), as a loop of
    PyTorch element-wise ops over the packets."""
    _check_env(aT, cl, cr, el0, er0)
    el, er = el0, er0
    out_l, out_r = [], []
    for k in range(cl.shape[0]):
        el = aT[k] * el + cl[k]
        er = aT[k] * er + cr[k]
        el = torch.where(el < 1e-30, torch.zeros_like(el), el)
        er = torch.where(er < 1e-30, torch.zeros_like(er), er)
        out_l.append(el)
        out_r.append(er)
    return torch.stack(out_l), torch.stack(out_r)


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_carry`` and ``dspi_env_carry`` with their C
    signatures set."""
    mat, env = lib.dspi_carry, lib.dspi_env_carry
    if mat.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        mat.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p]
        mat.restype = i
        env.argtypes = [p, q, q, p, p, p, p, i, i, p, p, p]
        env.restype = i
    return mat, env


def _stream(v):
    return torch.cuda.current_stream(v.device).cuda_stream


def launch_carry(fn, y, vx, s0, U, W, dims):
    """One launch of ``fn``, a bound ``dspi_carry``, on checked CUDA
    tensors of ``_check_carry``'s ``dims``: y updated in place; sF."""
    N, P, nA, Ry, S, G = dims
    sF = torch.empty_like(s0)
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), vx.data_ptr(), s0.data_ptr(), U.data_ptr(),
                W.data_ptr(), N, P, nA, Ry, S, G, sF.data_ptr(), _stream(y))
    if rc != 0:
        raise RuntimeError(f"carry kernel launch failed: CUDA error {rc}")
    return sF


def launch_env(fn, aT, cl, cr, el0, er0):
    """One launch of ``fn``, a bound ``dspi_env_carry``, on checked CUDA
    tensors: (env_l, env_r)."""
    npkt, B = cl.shape
    out_l, out_r = torch.empty_like(cl), torch.empty_like(cr)
    sk = aT.stride(0)
    sb = aT.stride(1) if aT.dim() == 2 else 0
    with torch.cuda.device(cl.device):
        rc = fn(aT.data_ptr(), sk, sb, cl.data_ptr(), cr.data_ptr(),
                el0.data_ptr(), er0.data_ptr(), npkt, B, out_l.data_ptr(),
                out_r.data_ptr(), _stream(cl))
    if rc != 0:
        raise RuntimeError(f"envelope carry kernel launch failed: CUDA "
                           f"error {rc}")
    return out_l, out_r


def carry(y, vx, s0, U, W):
    """The matrix carry: y [N, *A, Ry, G] updated in place, returns sF
    [*A, S, G] (module docstring)."""
    if y.device.type == "cpu":
        return carry_plain(y, vx, s0, U, W)
    dims = _check_carry(y, vx, s0, U, W)
    out = launch_carry(bind(build.load("carry"))[0], y, vx, s0, U, W, dims)
    LAUNCHES["carry"] += 1
    return out


def env_carry(aT, cl, cr, el0, er0):
    """The envelope carry: (env_l, env_r) [Npkt, B] (module docstring)."""
    if cl.device.type == "cpu":
        return env_carry_plain(aT, cl, cr, el0, er0)
    _check_env(aT, cl, cr, el0, er0)
    out = launch_env(bind(build.load("carry"))[1], aT, cl, cr, el0, er0)
    LAUNCHES["env_carry"] += 1
    return out
