"""The float crossfeed: its plain PyTorch version and its kernel's wrapper.

The stereo one-pole low-pass + allpass recurrence of the crossfeed
(usb_audio.c:737-749), the JAX package's ``xf_body`` scan
(chain/pipeline.py:594-611), in float32 with every multiply and add
rounded on its own.  ``xf_f32`` launches ``csrc/xf_f32.cu`` on a CUDA
tensor or raises; on a CPU tensor it runs ``xf_f32_plain``, a Python loop
over samples vectorized over streams.  The coefficients are the same for
every stream ([3]) or per stream ([3, B], per-stream parameters).
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build

_F32 = torch.float32


def _check(l, r, coef, s4):
    for name, v in (("l", l), ("r", r), ("coef", coef), ("state", s4)):
        if v.dtype != _F32:
            raise TypeError(f"xf_f32 wants float32 {name}, got {v.dtype}")
        if v.device != l.device:
            raise ValueError(f"{name} on {v.device}, l on {l.device}")
    if l.dim() != 2 or r.shape != l.shape \
            or coef.shape not in ((3,), (3, l.shape[1])) \
            or s4.shape != (4, l.shape[1]):
        raise ValueError(
            f"xf_f32 wants l, r [T, B], coef [3] or [3, B], state [4, B]; got "
            f"{tuple(l.shape)}, {tuple(r.shape)}, {tuple(coef.shape)}, "
            f"{tuple(s4.shape)}")


def xf_f32_plain(l, r, coef, s4):
    """l, r float32 [T, B]; coef float32 [3] or [3, B] = (lp_a0, lp_b1,
    ap_a); s4 float32 [4, B] = (lp L, lp R, ap L, ap R) -> (out_l, out_r,
    s4')."""
    _check(l, r, coef, s4)
    lp_a0, lp_b1, ap_a = coef.unbind(0)
    lpL, lpR, apL, apR = s4.unbind(0)
    out_l, out_r = torch.empty_like(l), torch.empty_like(r)
    for t in range(l.shape[0]):
        ml, mr = l[t], r[t]
        lp_l = lp_a0 * ml + lp_b1 * lpL
        lp_r = lp_a0 * mr + lp_b1 * lpR
        ap_l = ap_a * lp_l + apL
        apL = lp_l - ap_a * ap_l
        ap_r = ap_a * lp_r + apR
        apR = lp_r - ap_a * ap_r
        lpL, lpR = lp_l, lp_r
        out_l[t] = (ml - lp_l) + ap_r
        out_r[t] = (mr - lp_r) + ap_l
    return out_l, out_r, torch.stack([lpL, lpR, apL, apR])


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_xf_f32`` with its C signature set."""
    fn = lib.dspi_xf_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, l, r, coef, s4):
    """One launch of ``fn``, a bound ``dspi_xf_f32``, on checked,
    contiguous, non-empty CUDA tensors: (out_l, out_r, s4')."""
    T, B = l.shape
    out_l, out_r = torch.empty_like(l), torch.empty_like(r)
    s_out = torch.empty_like(s4)
    stream = torch.cuda.current_stream(l.device).cuda_stream
    with torch.cuda.device(l.device):
        rc = fn(l.data_ptr(), r.data_ptr(), coef.data_ptr(), s4.data_ptr(),
                out_l.data_ptr(), out_r.data_ptr(), s_out.data_ptr(), T, B,
                int(coef.dim() == 2), stream)
    if rc != 0:
        raise RuntimeError(f"float crossfeed kernel launch failed: CUDA "
                           f"error {rc}")
    return out_l, out_r, s_out


def xf_f32(l, r, coef, s4):
    """The crossfeed over a segment (signature of ``xf_f32_plain``)."""
    _check(l, r, coef, s4)
    if l.device.type == "cpu":
        return xf_f32_plain(l, r, coef, s4)
    if l.device.type != "cuda":
        raise ValueError(f"no float crossfeed kernel for device {l.device}")
    if not all(v.is_contiguous() for v in (l, r, coef, s4)):
        raise ValueError("xf_f32 wants contiguous tensors")
    T, B = l.shape
    if T >= 2**31 or B >= 2**31:
        raise ValueError(f"segment too large: {T} x {B}")
    if T == 0 or B == 0:
        return torch.empty_like(l), torch.empty_like(r), s4.clone()
    out = launch(bind(build.load("xf_f32")), l, r, coef, s4)
    LAUNCHES["xf_f32"] += 1
    return out
