"""The PDM modulator kernel's wrapper, its state layout and the front door.

``pdm_words`` runs the modulator over one segment on the kernel's 16-row
int32 state layout.  On a CUDA tensor it launches ``csrc/pdm.cu`` (built
with nvcc at first use) or raises; on a CPU tensor it runs the plain
version, ``kernels.pdm.pdm_words_plain``.  There is no other path.

``pdm_segment`` is what the chain calls: the segment-start mode reactions,
then pack, modulate, unpack.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build
from .pdm import mode_prologue, pdm_words_plain

_I32 = torch.int32


def bind(lib: ctypes.CDLL):
    """``lib``'s ``dspi_pdm_segment`` with its C signature set."""
    fn = lib.dspi_pdm_segment
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, x: torch.Tensor, s16: torch.Tensor):
    """One launch of ``fn``, a bound ``dspi_pdm_segment`` (this repo's, or
    another revision's for a comparison), on checked, contiguous, non-empty
    CUDA tensors: (words, s16')."""
    T, B = x.shape
    words = torch.empty((T, 8, B), dtype=_I32, device=x.device)
    s_out = torch.empty_like(s16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), s16.data_ptr(), words.data_ptr(),
                s_out.data_ptr(), T, B, stream)
    if rc != 0:
        raise RuntimeError(f"PDM kernel launch failed: CUDA error {rc}")
    return words, s_out


def _check(x: torch.Tensor, s16: torch.Tensor):
    if x.dtype != _I32 or s16.dtype != _I32:
        raise TypeError(f"pdm_words wants int32 tensors, got {x.dtype}, "
                        f"{s16.dtype}")
    if x.dim() != 2 or s16.shape != (16, x.shape[1]):
        raise ValueError(f"pdm_words wants x [T, B] and state [16, B], got "
                         f"{tuple(x.shape)} and {tuple(s16.shape)}")
    if x.device != s16.device:
        raise ValueError(f"x on {x.device}, state on {s16.device}")


def pdm_words(x: torch.Tensor, s16: torch.Tensor):
    """x int32 [T, B] Q28, s16 int32 [16, B] -> (words int32 [T, 8, B]
    holding uint32 bit patterns, s16')."""
    _check(x, s16)
    if x.device.type == "cpu":
        return pdm_words_plain(x, s16)
    if x.device.type != "cuda":
        raise ValueError(f"no PDM kernel for device {x.device}")
    if not (x.is_contiguous() and s16.is_contiguous()):
        raise ValueError("pdm_words wants contiguous tensors")
    T, B = x.shape
    if T >= 2**31 or B >= 2**31:
        raise ValueError(f"segment too large: {T} x {B}")
    if T == 0 or B == 0:
        return (torch.empty((T, 8, B), dtype=_I32, device=x.device),
                s16.clone())
    words, s_out = launch(bind(build.load("pdm")), x, s16)
    LAUNCHES["pdm"] += 1
    return words, s_out


def pack_pdm_state(state) -> torch.Tensor:
    """ChainState pdm fields -> int32 [16, B] kernel layout.  States
    without the enable machine pack the always-enabled identity
    (ena=1, run=1, fout=0, base=0)."""
    b = state.pdm_err.shape[0]
    dev = state.pdm_err.device
    ones = torch.ones((b,), dtype=_I32, device=dev)
    zero = torch.zeros((b,), dtype=_I32, device=dev)
    dyn = state.pdm_ena is not None
    rows = [state.pdm_err, state.pdm_err2, *state.pdm_ns, state.pdm_rng,
            state.pdm_fade,
            state.pdm_ena if dyn else ones,
            state.pdm_run if dyn else ones,
            state.pdm_fout if dyn else zero,
            state.pdm_base if dyn else zero,
            zero, zero, zero]
    return torch.stack(rows).contiguous()


def unpack_pdm_state(state, s16: torch.Tensor):
    upd = dict(pdm_err=s16[0], pdm_err2=s16[1], pdm_ns=s16[2:7],
               pdm_rng=s16[7], pdm_fade=s16[8])
    if state.pdm_ena is not None:
        upd.update(pdm_ena=s16[9], pdm_run=s16[10], pdm_fout=s16[11],
                   pdm_base=s16[12])
    return state._replace(**upd)


def pdm_segment(state, x: torch.Tensor):
    """Run the modulator over a segment.  ``state``: a ChainState (only
    its pdm_* fields are read and replaced; ``pdm_rng`` is int32 bits);
    ``x``: int32 [T, B] Q28.  Returns (state', words int32 [T, 8, B])."""
    if state.pdm_ena is not None:
        state = mode_prologue(state)
    words, s16 = pdm_words(x.contiguous(), pack_pdm_state(state))
    return unpack_pdm_state(state, s16), words
