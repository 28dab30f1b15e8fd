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
