"""The crossfeed in both number formats: its plain PyTorch versions and its
kernels' wrapper.

The stereo one-pole low-pass + allpass recurrence of the crossfeed
(usb_audio.c:737-749 float, :1064-1073 Q28), the JAX package's ``xf_body``
scan (chain/pipeline.py), in Q28 or in float32 with every multiply and add
rounded on its own.  ``xf_q28`` launches ``csrc/xf_q28.cu`` and ``xf_f32``
``csrc/xf_f32.cu`` on CUDA tensors, or raise; on CPU tensors they run
``xf_q28_plain`` and ``xf_f32_plain``, a Python loop over samples
vectorized over streams.  The coefficients are the same for every stream
([3]) or per stream ([3, B], per-stream parameters).  Both kernels export
one C signature, so one ``bind`` and one ``launch`` serve them.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from . import LAUNCHES, build
from ..core.qmath import q28_mul

# by kernel (its library's name): the samples' dtype and the product
_KINDS = {"xf_q28": (torch.int32, q28_mul),
          "xf_f32": (torch.float32, operator.mul)}


def _check(name, l, r, coef, s4):
    dtype = _KINDS[name][0]
    for arg, v in (("l", l), ("r", r), ("coef", coef), ("state", s4)):
        if v.dtype != dtype:
            raise TypeError(f"{name} wants {str(dtype)[6:]} {arg}, got "
                            f"{v.dtype}")
        if v.device != l.device:
            raise ValueError(f"{arg} on {v.device}, l on {l.device}")
    if l.dim() != 2 or r.shape != l.shape \
            or coef.shape not in ((3,), (3, l.shape[1])) \
            or s4.shape != (4, l.shape[1]):
        raise ValueError(
            f"{name} wants l, r [T, B], coef [3] or [3, B], state [4, B]; got "
            f"{tuple(l.shape)}, {tuple(r.shape)}, {tuple(coef.shape)}, "
            f"{tuple(s4.shape)}")


def _plain(name, l, r, coef, s4):
    _check(name, l, r, coef, s4)
    mul = _KINDS[name][1]
    lp_a0, lp_b1, ap_a = coef.unbind(0)
    lpL, lpR, apL, apR = s4.unbind(0)
    out_l, out_r = torch.empty_like(l), torch.empty_like(r)
    for t in range(l.shape[0]):
        ml, mr = l[t], r[t]
        lp_l = mul(lp_a0, ml) + mul(lp_b1, lpL)
        lp_r = mul(lp_a0, mr) + mul(lp_b1, lpR)
        ap_l = mul(ap_a, lp_l) + apL
        apL = lp_l - mul(ap_a, ap_l)
        ap_r = mul(ap_a, lp_r) + apR
        apR = lp_r - mul(ap_a, ap_r)
        lpL, lpR = lp_l, lp_r
        out_l[t] = (ml - lp_l) + ap_r
        out_r[t] = (mr - lp_r) + ap_l
    return out_l, out_r, torch.stack([lpL, lpR, apL, apR])


def xf_q28_plain(l, r, coef, s4):
    """l, r int32 [T, B] Q28; coef int32 [3] or [3, B] = (lp_a0, lp_b1,
    ap_a); s4 int32 [4, B] = (lp L, lp R, ap L, ap R) -> (out_l, out_r,
    s4')."""
    return _plain("xf_q28", l, r, coef, s4)


def xf_f32_plain(l, r, coef, s4):
    """``xf_q28_plain`` on float32 samples, coefficients and states."""
    return _plain("xf_f32", l, r, coef, s4)


def bind(lib: ctypes.CDLL):
    """``lib``'s crossfeed entry point, ``dspi_xf_q28`` or ``dspi_xf_f32``
    (whichever it exports), with its C signature set."""
    fn = next(getattr(lib, f"dspi_{name}") for name in _KINDS
              if hasattr(lib, f"dspi_{name}"))
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, l, r, coef, s4):
    """One launch of ``fn``, a bound crossfeed entry point (this repo's, or
    another revision's for a comparison), on checked, contiguous,
    non-empty CUDA tensors: (out_l, out_r, s4')."""
    T, B = l.shape
    out_l, out_r = torch.empty_like(l), torch.empty_like(r)
    s_out = torch.empty_like(s4)
    stream = torch.cuda.current_stream(l.device).cuda_stream
    with torch.cuda.device(l.device):
        rc = fn(l.data_ptr(), r.data_ptr(), coef.data_ptr(), s4.data_ptr(),
                out_l.data_ptr(), out_r.data_ptr(), s_out.data_ptr(), T, B,
                int(coef.dim() == 2), stream)
    if rc != 0:
        raise RuntimeError(f"crossfeed kernel launch failed: CUDA error {rc}")
    return out_l, out_r, s_out


def _crossfeed(name, l, r, coef, s4):
    _check(name, l, r, coef, s4)
    if l.device.type == "cpu":
        return _plain(name, l, r, coef, s4)
    if l.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {l.device}")
    if not all(v.is_contiguous() for v in (l, r, coef, s4)):
        raise ValueError(f"{name} wants contiguous tensors")
    T, B = l.shape
    if T >= 2**31 or B >= 2**31:
        raise ValueError(f"segment too large: {T} x {B}")
    if T == 0 or B == 0:
        return torch.empty_like(l), torch.empty_like(r), s4.clone()
    out = launch(bind(build.load(name)), l, r, coef, s4)
    LAUNCHES[name] += 1
    return out


def xf_q28(l, r, coef, s4):
    """The Q28 crossfeed over a segment (signature of ``xf_q28_plain``)."""
    return _crossfeed("xf_q28", l, r, coef, s4)


def xf_f32(l, r, coef, s4):
    """The float crossfeed over a segment (signature of ``xf_f32_plain``)."""
    return _crossfeed("xf_f32", l, r, coef, s4)
