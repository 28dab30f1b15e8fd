"""PDM delta-sigma modulator: the plain PyTorch version and the mode machine.

Reproduces pdm_processing_loop (pdm_generator.c:349-397) bit-exactly, as
the JAX package's ``kernels/pdm.py`` does:

  per PCM sample:
    pcm    = sample >> 14, hard-limited to +/-29500
    fade   = 1024-sample linear fade-in after (re)start
    target = pcm + 32768
    8 chunks x 32 bits:
      dither = noise-shaped TPDF (xorshift32 + Q14 high-pass with an
               error-feedback accumulator, pdm_generator.c:89-108)
      bit_k: fb = (err2 + dither) >= 0 ? 65535 : 0
             err  += target - fb;   err2 += err - fb
    leaky integrators: err -= err>>16; err2 -= err2>>16

plus the enable/fade-out machine (pdm_generator.c:217-255, 320-364):
``mode_prologue`` runs the segment-start reactions, ``_mode_targets`` the
per-sample ones in closed form, and inactive samples freeze the modulator
and emit the stopped-hardware silence word.

``pdm_words_plain`` is the reference the CUDA kernel
(``kernels/csrc/pdm.cu``) is held to: a Python loop over samples,
vectorized over streams, in the reference bit-step form (the kernel uses
the sign-mask form, so the two check each other).  It takes and returns
the kernel's 16-row int32 state layout (``pdm_cuda.pack_pdm_state``).

torch has no uint32 arithmetic: the xorshift state is carried as int32
bits, and its logical right shift is an arithmetic shift plus a mask.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C

_I32 = torch.int32
# the silence word is above 2^31: carried as its int32 bit pattern
SILENCE = int(np.uint32(C.PDM_SILENCE_WORD).view(np.int32))


def mode_prologue(state):
    """Segment-start enable/fade-out reactions (pdm_generator.c:225-255):

      * disable while running -> start the 1024-sample fade-out
      * re-enable mid-fade    -> the out-ramp becomes an in-ramp
      * re-enable after stop  -> modulator restart: err/err2/noise shaper/
        fades/base reset; the xorshift32 PRNG persists
    """
    ena = state.pdm_ena != 0
    run = state.pdm_run != 0
    fout = state.pdm_fout
    fout = torch.where(~ena & run & (fout == 0),
                       torch.full_like(fout, C.PDM_FADE_IN_SAMPLES), fout)
    cancel = ena & (fout > 0)
    fade = torch.where(cancel, C.PDM_FADE_IN_SAMPLES - fout, state.pdm_fade)
    fout = torch.where(cancel, torch.zeros_like(fout), fout)
    restart = ena & ~run
    z = torch.zeros_like(fout)
    return state._replace(
        pdm_err=torch.where(restart, z, state.pdm_err),
        pdm_err2=torch.where(restart, z, state.pdm_err2),
        pdm_ns=torch.where(restart[None, :], z[None, :], state.pdm_ns),
        pdm_fade=torch.where(restart, z, fade),
        pdm_base=torch.where(restart, z, state.pdm_base),
        pdm_fout=torch.where(restart, z, fout),
        pdm_run=(run | ena).to(_I32))


def _mode_targets(x, fade, ena, run, fout, base):
    """Per-sample targets and active mask over a segment, closed form
    (``mode_prologue`` must already have run).

    Enabled streams take the fade-in ramp; a fading-out stream's sample t
    modulates ``(base * m) >> 10 + 32768`` with m = fout-1-t while m >= 1,
    the m == 0 slot stops the hardware without modulating, and stopped
    samples are inactive.  Returns (target [T, B], active bool [T, B],
    (fade', base', fout', run'))."""
    T = x.shape[0]
    ena_b = ena != 0
    t = torch.arange(T, dtype=_I32, device=x.device)[:, None]
    pcm = (x >> 14).clamp(-C.PDM_CLIP_THRESH, C.PDM_CLIP_THRESH)
    fade_t = torch.clamp(fade[None, :] + t, max=C.PDM_FADE_IN_SAMPLES)
    pcm = torch.where(fade_t < C.PDM_FADE_IN_SAMPLES,
                      (pcm * fade_t) >> C.PDM_FADE_IN_SHIFT, pcm)
    m = fout[None, :] - 1 - t
    tgt_out = ((base[None, :] * m.clamp(min=0)) >> C.PDM_FADE_IN_SHIFT) \
        + 32768
    target = torch.where(ena_b[None, :], pcm + 32768, tgt_out)
    active = ena_b[None, :] | ((run != 0)[None, :] & (m >= 1))
    fade2 = torch.where(ena_b, torch.clamp(fade + T,
                                           max=C.PDM_FADE_IN_SAMPLES), fade)
    base2 = torch.where(ena_b, pcm[-1], base)
    fout2 = torch.where(ena_b, torch.zeros_like(fout),
                        torch.clamp(fout - T, min=0))
    run2 = torch.where(ena_b, torch.ones_like(run),
                       ((run != 0) & (fout > T)).to(_I32))
    return target, active, (fade2, base2, fout2, run2)


def _sample(err, err2, ns, rng, target):
    """One PCM sample -> 8 words, reference op shape (pdm_generator.c:
    367-380).  ns = (x1, x2, y1, y2, acc).  Returns the new carry and the
    words [8, B]."""
    x1, x2, y1, y2, acc = ns
    words = []
    for _ in range(C.PDM_CHUNKS):
        rng = rng ^ (rng << 13)
        rng = rng ^ ((rng >> 17) & 0x7FFF)          # logical >> 17
        rng = rng ^ (rng << 5)
        raw = (rng & C.PDM_DITHER_MASK) - (C.PDM_DITHER_MASK >> 1)
        acc = ((acc * 248) >> 8) + ((err2 >> 8) >> 6)
        inp = raw - acc
        dither = (C.PDM_NS_B0 * inp + C.PDM_NS_B1 * x1 + C.PDM_NS_B2 * x2
                  + C.PDM_NS_A1 * y1 - C.PDM_NS_A2 * y2) >> 14
        x2, x1, y2, y1 = x1, inp, y1, dither
        word = torch.zeros_like(err)
        for _k in range(32):
            bit = ((err2 + dither) >= 0).to(_I32)
            fb = bit * 65535
            word = (word << 1) | bit
            err = err + (target - fb)
            err2 = err2 + (err - fb)
        words.append(word)
    err = err - (err >> C.PDM_LEAKAGE_SHIFT)
    err2 = err2 - (err2 >> C.PDM_LEAKAGE_SHIFT)
    return (err, err2, (x1, x2, y1, y2, acc), rng), torch.stack(words)


def pdm_words_plain(x: torch.Tensor, s16: torch.Tensor):
    """Plain version of the modulator kernel.

    x: int32 [T, B] Q28 samples; s16: int32 [16, B] kernel state (rows
    0 err, 1 err2, 2-6 noise shaper x1 x2 y1 y2 acc, 7 rng bits, 8 fade,
    9 ena, 10 run, 11 fout, 12 base, 13-15 padding).  Returns (words int32
    [T, 8, B] holding the uint32 bit patterns, s16')."""
    T = x.shape[0]
    err, err2, x1, x2, y1, y2, acc, rng = (s16[i] for i in range(8))
    fade, ena, run, fout, base = (s16[i] for i in range(8, 13))
    target, active, (fade, base, fout, run) = _mode_targets(
        x, fade, ena, run, fout, base)
    silence = torch.full((C.PDM_CHUNKS, 1), SILENCE, dtype=_I32,
                         device=x.device)
    words = torch.empty((T, C.PDM_CHUNKS) + x.shape[1:], dtype=_I32,
                        device=x.device)
    carry = (err, err2, (x1, x2, y1, y2, acc), rng)
    for t in range(T):
        act = active[t]
        new, w = _sample(*carry, target[t])
        words[t] = torch.where(act[None, :], w, silence)
        carry = (torch.where(act, new[0], carry[0]),
                 torch.where(act, new[1], carry[1]),
                 tuple(torch.where(act, n, o)
                       for n, o in zip(new[2], carry[2])),
                 torch.where(act, new[3], carry[3]))
    err, err2, ns, rng = carry
    s_out = torch.cat([torch.stack([err, err2, *ns, rng, fade, ena, run,
                                    fout, base]), s16[13:]], dim=0)
    return words, s_out
