"""The port's PDM modulator against the JAX package's.

The plain PyTorch version (``kernels.pdm.pdm_words_plain``, what the
wrapper runs on CPU tensors) is held bit-exact — words and every state row
— to ``dspi_tpu.kernels.pdm.pdm_segment(impl="fori")``, always-enabled and
through the enable/fade-out machine.  The CUDA kernel is held to the
plain version on the card in tests/test_torch_cuda.py."""

import functools

import jax
import numpy as np
import pytest
import torch

from dspi_tpu.chain.pack import ChainState as JState
from dspi_tpu.kernels.pdm import pdm_segment as jax_pdm_segment
from dspi_tpu_torch.chain.pack import ChainState, to_device, to_numpy
from dspi_tpu_torch.core import constants as C
from dspi_tpu_torch.kernels import LAUNCHES
from dspi_tpu_torch.kernels import pdm_cuda

PDM_FIELDS = ("pdm_err", "pdm_err2", "pdm_ns", "pdm_rng", "pdm_fade",
              "pdm_ena", "pdm_run", "pdm_fout", "pdm_base")


@functools.lru_cache(maxsize=None)
def _jax_fn():
    return jax.jit(functools.partial(jax_pdm_segment, impl="fori"))


def _jstate(b, machine=True, **rows):
    st = dict(pdm_err=np.zeros(b, np.int32), pdm_err2=np.zeros(b, np.int32),
              pdm_ns=np.zeros((5, b), np.int32),
              pdm_rng=np.full(b, 123456789, np.uint32),
              pdm_fade=np.zeros(b, np.int32))
    if machine:
        st.update(pdm_ena=np.ones(b, np.int32), pdm_run=np.ones(b, np.int32),
                  pdm_fout=np.zeros(b, np.int32),
                  pdm_base=np.zeros(b, np.int32))
    st.update(rows)
    return JState(**{f: st.get(f) for f in JState._fields})


def _tstate(js):
    return to_device(ChainState(*[getattr(js, f)
                                  for f in ChainState._fields]), "cpu")


def _run_both(js, xs, enables=None):
    """Run both packages over segments, with pdm_ena set per segment and
    lane between segments as the control plane does.  Returns (JAX words,
    port words, JAX state, port state as NumPy)."""
    ts = _tstate(js)
    jw, tw = [], []
    for i, x in enumerate(xs):
        if enables is not None:
            ena = np.asarray(enables[i], np.int32)
            js = js._replace(pdm_ena=ena)
            ts = ts._replace(pdm_ena=torch.from_numpy(ena.copy()))
        js, w = _jax_fn()(js, x)
        jw.append(np.asarray(w))
        ts, w = pdm_cuda.pdm_segment(ts, torch.from_numpy(x))
        tw.append(w.numpy().view(np.uint32))
    return (np.concatenate(jw), np.concatenate(tw), js, to_numpy(ts))


def _assert_same(jw, tw, js, ts, machine=True):
    np.testing.assert_array_equal(tw, jw)
    for f in PDM_FIELDS if machine else PDM_FIELDS[:5]:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("machine", [True, False])
def test_always_enabled_fade_in(machine):
    rng = np.random.default_rng(21)
    T, B = 96, 4
    x = rng.integers(-(1 << 27), 1 << 27, size=(T, B)).astype(np.int32)
    x[:, 3] = np.int32(2**31 - 1)                 # clip edge
    js = _jstate(B, machine=machine)
    out = _run_both(js, [x])
    _assert_same(*out, machine=machine)
    assert (out[3].pdm_fade == T).all()


def test_mode_machine_lanes():
    """One segment with every machine mode live in a different lane
    (the lanes of tests/test_pdm_impls.py)."""
    rng = np.random.default_rng(5)
    T, B = 96, 8
    x = rng.integers(-(1 << 27), 1 << 27, size=(T, B)).astype(np.int32)
    js = _jstate(
        B,
        # 0 fading in, 1 steady, 2 freshly disabled, 3 short fade-out
        # (completes in-segment), 4 long fade-out, 5 stopped, 6 restart
        # after stop, 7 re-enable mid-fade
        pdm_ena=np.array([1, 1, 0, 0, 0, 0, 1, 1], np.int32),
        pdm_run=np.array([1, 1, 1, 1, 1, 0, 0, 1], np.int32),
        pdm_fout=np.array([0, 0, 0, 40, 700, 0, 0, 300], np.int32),
        pdm_base=np.array([0, 0, 1500, 3000, -2500, 0, 0, 777], np.int32),
        pdm_fade=np.array([500, 1024, 1024, 1024, 1024, 1024, 7, 123],
                          np.int32),
        pdm_err=rng.integers(-9000, 9000, B).astype(np.int32),
        pdm_err2=rng.integers(-9000, 9000, B).astype(np.int32),
        pdm_rng=rng.integers(1, 2**32, B, dtype=np.uint64).astype(np.uint32))
    jw, tw, js2, ts2 = _run_both(js, [x])
    _assert_same(jw, tw, js2, ts2)
    silence = np.uint32(C.PDM_SILENCE_WORD)
    assert (tw[40:, :, 3] == silence).all()          # stopped mid-segment
    assert (tw[:, :, 5] == silence).all()            # stopped all along
    assert ts2.pdm_run[3] == 0 and ts2.pdm_fout[3] == 0


def test_disable_stop_restart_and_midfade_reenable():
    """Segments with the enable flag flipped between them: lane 0 runs,
    is disabled (fade-out starts), stays disabled, is re-enabled mid-fade
    (out-ramp turns into an in-ramp); lane 1 starts 40 samples from the
    end of a fade-out, stops, stays stopped, and restarts (reset, fresh
    fade-in, PRNG kept)."""
    rng = np.random.default_rng(9)
    T, B = 48, 2
    xs = [rng.integers(-(1 << 27), 1 << 27, size=(T, B)).astype(np.int32)
          for _ in range(4)]
    js = _jstate(B, pdm_fade=np.full(B, 1024, np.int32),
                 pdm_ena=np.array([1, 0], np.int32),
                 pdm_fout=np.array([0, 40], np.int32),
                 pdm_base=np.array([0, 2500], np.int32),
                 pdm_err=np.array([311, -4000], np.int32))
    enables = [[1, 0], [0, 0], [0, 0], [1, 1]]
    jw, tw, js2, ts2 = _run_both(js, xs, enables)
    _assert_same(jw, tw, js2, ts2)
    silence = np.uint32(C.PDM_SILENCE_WORD)
    assert (tw[:39, :, 1] != silence).any()
    assert (tw[39:3 * T, :, 1] == silence).all()
    assert (tw[3 * T:, :, 1] != silence).any()
    assert ts2.pdm_fade.tolist() == [1024 - (1024 - 2 * T) + T, T]


def test_wrapper_checks_inputs():
    x = torch.zeros((4, 3), dtype=torch.int32)
    s = torch.zeros((16, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        pdm_cuda.pdm_words(x.to(torch.int64), s)
    with pytest.raises(ValueError):
        pdm_cuda.pdm_words(x, s[:, :2])
    with pytest.raises(ValueError):
        pdm_cuda.pdm_words(x, s[:15])
    before = dict(LAUNCHES)
    w, s2 = pdm_cuda.pdm_words(x, s)              # CPU: the plain version
    assert w.shape == (4, 8, 3) and s2.shape == (16, 3)
    assert dict(LAUNCHES) == before               # no kernel launch counted


# --- the CUDA kernel's arithmetic, transcribed -----------------------------
#
# kernels/csrc/pdm.cu computes the bit step and the chunk boundary in
# another form than the plain version: e2d' = (e2d + g) + m * -131070 and
# g' = (g + t65) + m * -65535 with the sign mask m = e2d >> 31, and the
# noise shaper's output as q0 - B0 * (err2 >> 14), q0 computed a chunk
# ahead.  The kernel cannot run here, so these tests transcribe its
# arithmetic statement for statement on NumPy uint32 (wrapping) and hold it
# word for word against kernels.pdm._sample and pdm_words_plain, at the
# wrap extremes too.  Nothing ties the transcription to the .cu source:
# a change to the kernel's arithmetic is made here as well (pdm.cu says
# so), and the card tests and chip_smoke.py hold the kernel itself.

_U = np.uint32


def _sar(v, n):
    """Arithmetic >> of uint32 bits."""
    return (v.view(np.int32) >> np.int32(n)).view(np.uint32)


def _u(v):
    return np.asarray(v, np.int64).astype(np.uint32)


def _shaper_input(rng, acc, x1, x2, y1, y2):
    """pdm.cu's shaper_input: a chunk's xorshift, dither draw and the
    noise shaper's terms that do not depend on err2."""
    rng = rng ^ (rng << _U(13))
    rng = rng ^ (rng >> _U(17))
    rng = rng ^ (rng << _U(5))
    raw = (rng & _U(0x1FF)) - _U(255)
    a = _sar(acc * _U(248), 8)
    rest = (_U(C.PDM_NS_B1 % 2**32) * x1 + _U(C.PDM_NS_B2) * x2
            + _U(C.PDM_NS_A1) * y1 - _U(C.PDM_NS_A2) * y2)
    return {"rng": rng, "raw": raw, "a": a,
            "q0": _U(C.PDM_NS_B0) * (raw - a) + rest}


def _kernel_sample(err, err2, ns, rng, target):
    """pdm.cu's active-sample body: uint32 arrays in, the same out, and the
    8 words."""
    x1, x2, y1, y2, acc = ns
    t65 = target - _U(65535)
    g = err - _U(65535) + t65
    words = []
    # chunk 0's shaper input, then each next chunk's a chunk ahead
    n = _shaper_input(rng, acc, x1, x2, y1, y2)
    for c in range(C.PDM_CHUNKS):
        q = _sar(err2, 14)
        dither = _sar(q * _U(-C.PDM_NS_B0 % 2**32) + n["q0"], 14)
        rng = n["rng"]
        acc = n["a"] + q
        x2, x1, y2, y1 = x1, n["raw"] - acc, y1, dither
        if c + 1 < C.PDM_CHUNKS:
            n = _shaper_input(rng, acc, x1, x2, y1, y2)
        e2d = err2 + dither
        u = np.ones_like(e2d)
        for _k in range(32):
            m = _sar(e2d, 31)
            s = e2d + g
            gt = g + t65
            e2d = m * _U(0xFFFE0002) + s
            g = m * _U(0xFFFF0001) + gt
            u = u * _U(2) + m
        words.append(u - _U(1))
        err2 = e2d - dither
    err = g - t65 + _U(65535)
    err = err - _sar(err, 16)
    err2 = err2 - _sar(err2, 16)
    return (err, err2, (x1, x2, y1, y2, acc), rng), np.stack(words)


def _kernel_words(x, s16):
    """pdm.cu's whole loop (machine, silence, kernel-form sample) over a
    segment: int32 x [T, B], s16 [16, B] -> (words, s16') as int32."""
    x = x.astype(np.int32)
    err, err2, x1, x2, y1, y2, acc, rng = (_u(s16[i]) for i in range(8))
    fade, ena, run, fout, base = (s16[i].astype(np.int64)
                                  for i in range(8, 13))
    enab = ena != 0
    words = np.empty((x.shape[0], C.PDM_CHUNKS, x.shape[1]), np.uint32)
    for t in range(x.shape[0]):
        fading_out = ~enab & (fout > 0)
        fout = np.where(fading_out, fout - 1, fout)
        run = np.where(fading_out & (fout == 0), 0, run)
        act = enab | (fading_out & (fout >= 1))
        pcm = np.clip(x[t].astype(np.int64) >> 14, -C.PDM_CLIP_THRESH,
                      C.PDM_CLIP_THRESH)
        fading = fade < C.PDM_FADE_IN_SAMPLES
        pcm = np.where(fading, (pcm * fade) >> C.PDM_FADE_IN_SHIFT, pcm)
        fade = np.where(enab & fading, fade + 1, fade)
        base = np.where(enab, pcm, base)
        target = np.where(enab, pcm + 32768,
                          ((base * fout) >> C.PDM_FADE_IN_SHIFT) + 32768)
        old = (err, err2, x1, x2, y1, y2, acc, rng)
        (n_err, n_err2, n_ns, n_rng), w = _kernel_sample(
            err, err2, (x1, x2, y1, y2, acc), rng, _u(target))
        words[t] = np.where(act, w, _U(C.PDM_SILENCE_WORD))
        err, err2, x1, x2, y1, y2, acc, rng = (
            np.where(act, n, o)
            for n, o in zip((n_err, n_err2, *n_ns, n_rng), old))
    rows = [err, err2, x1, x2, y1, y2, acc, rng] + [
        _u(v) for v in (fade, ena, run, fout, base)]
    out = np.concatenate([np.stack(rows).view(np.int32), s16[13:]])
    return words.view(np.int32), out


def _extreme_state(rng, b, kind):
    """err, err2, noise shaper and rng rows: ``kind`` "typical" (the
    modulator's working range), "wrap" (err and err2 within 2^17 of
    +-2^31, where the bit step's sums wrap) or "full" (any int32)."""
    if kind == "typical":
        e = rng.integers(-9000, 9000, size=(2, b))
        ns = rng.integers(-3000, 3000, size=(5, b))
    elif kind == "wrap":
        side = rng.choice([-1, 1], size=(2, b))
        e = np.where(side > 0, 2**31 - 1 - rng.integers(0, 1 << 17, (2, b)),
                     -2**31 + rng.integers(0, 1 << 17, (2, b)))
        ns = rng.integers(-2**31, 2**31, size=(5, b))
    else:
        e = rng.integers(-2**31, 2**31, size=(2, b))
        ns = rng.integers(-2**31, 2**31, size=(5, b))
    r = rng.integers(1, 2**32, size=b, dtype=np.uint64)
    return e.astype(np.int32), ns.astype(np.int32), r.astype(np.uint32)


@pytest.mark.parametrize("kind", ["typical", "wrap", "full"])
@pytest.mark.parametrize("target", ["low_clip", "high_clip", "mixed"])
def test_kernel_form_sample_equals_reference(kind, target):
    """One sample of the kernel's bit step and chunk boundary, word for
    word and state row for state row, against the reference op shape
    (kernels.pdm._sample); t65 at both clip ends (pcm = -+29500) and
    anywhere between."""
    from dspi_tpu_torch.kernels.pdm import _sample

    b = 256
    rng = np.random.default_rng(
        ["typical", "wrap", "full"].index(kind) * 3
        + ["low_clip", "high_clip", "mixed"].index(target))
    e, ns, r = _extreme_state(rng, b, kind)
    pcm = {"low_clip": np.full(b, -C.PDM_CLIP_THRESH),
           "high_clip": np.full(b, C.PDM_CLIP_THRESH),
           "mixed": rng.integers(-C.PDM_CLIP_THRESH, C.PDM_CLIP_THRESH + 1,
                                 size=b)}[target]
    tgt = (pcm + 32768).astype(np.int32)
    for _ in range(3):                              # chained samples
        want, w_want = _sample(*(torch.from_numpy(v) for v in e),
                               tuple(torch.from_numpy(v) for v in ns),
                               torch.from_numpy(r.view(np.int32)),
                               torch.from_numpy(tgt))
        got, w_got = _kernel_sample(_u(e[0]), _u(e[1]),
                                    tuple(_u(v) for v in ns), r.copy(),
                                    _u(tgt))
        np.testing.assert_array_equal(w_got.view(np.int32), w_want.numpy())
        np.testing.assert_array_equal(got[0].view(np.int32), want[0].numpy())
        np.testing.assert_array_equal(got[1].view(np.int32), want[1].numpy())
        for g_, w_ in zip(got[2], want[2]):
            np.testing.assert_array_equal(g_.view(np.int32), w_.numpy())
        np.testing.assert_array_equal(got[3].view(np.int32), want[3].numpy())
        e = np.stack([got[0], got[1]]).view(np.int32)
        ns = np.stack(got[2]).view(np.int32)
        r = got[3]


@pytest.mark.parametrize("kind", ["typical", "wrap", "full"])
def test_kernel_form_segment_equals_plain(kind):
    """The kernel's whole loop (enable/fade-out machine, silence, kernel
    form) over a segment, words and all 16 state rows, against
    pdm_words_plain, with every machine mode live in some lane."""
    from dspi_tpu_torch.kernels.pdm import pdm_words_plain

    T, B = 24, 96
    rng = np.random.default_rng({"typical": 1, "wrap": 2, "full": 3}[kind])
    e, ns, r = _extreme_state(rng, B, kind)
    x = rng.integers(-2**31, 2**31, size=(T, B)).astype(np.int32)
    x[:, :4] = [2**31 - 1, -2**31, 29500 << 14, -(29500 << 14)]  # clip ends
    s = np.zeros((16, B), np.int32)
    s[0:2], s[2:7], s[7] = e, ns, r.view(np.int32)
    s[8] = rng.integers(0, 1025, size=B)
    s[9] = rng.integers(0, 2, size=B)
    s[10] = np.where(s[9] == 1, 1, rng.integers(0, 2, size=B))
    s[11] = np.where((s[9] == 0) & (s[10] == 1),
                     rng.integers(1, 2 * T, size=B), 0)
    s[12] = rng.integers(-29500, 29501, size=B)
    s[13:] = rng.integers(-5, 5, size=(3, B))
    want_w, want_s = pdm_words_plain(torch.from_numpy(x),
                                     torch.from_numpy(s))
    got_w, got_s = _kernel_words(x, s)
    np.testing.assert_array_equal(got_w, want_w.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())
