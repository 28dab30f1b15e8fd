"""The port's graft entry points, ``dspi_tpu_torch.graft_entry``, against
the JAX package's ``__graft_entry__``.

``entry()``'s step on its own example arguments, and on the JAX entry's
params, state and input carried across with ``pack.from_numpy``, gives the
JAX step's outputs and state: the s24 sums within 1e-6 relative and the
float state within 1e-6 relative RMS; the peaks, the PDM sums and every
PDM and clip word equal.  ``dryrun_multichip`` runs its seven sections
over a mesh of two CPU devices."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
from dspi_tpu_torch.chain import pack
from dspi_tpu_torch import graft_entry


def _rel_rms(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (np.sqrt(np.mean((got - want) ** 2))
            / (np.sqrt(np.mean(want ** 2)) + 1e-30))


@pytest.fixture(scope="module")
def steps():
    jfn, jargs = jgraft.entry()
    jstate, jout = jax.jit(jfn)(*jargs)
    fn, args = graft_entry.entry(device="cpu")
    return (jfn, jargs, jstate, jout), (fn, args)


def _held(state, out, jstate, jout):
    out = {k: v.numpy() for k, v in out.items()}
    jout = {k: np.asarray(v) for k, v in jout.items()}
    assert set(out) == set(jout) == {"peaks", "s24_sum", "pdm_sum"}
    assert np.array_equal(out["peaks"], jout["peaks"])
    assert np.array_equal(out["pdm_sum"].astype(np.int64) & 0xFFFFFFFF,
                          jout["pdm_sum"].astype(np.int64))
    s24, js24 = out["s24_sum"].astype(np.int64), jout["s24_sum"]
    assert np.abs(s24 - js24).max() <= 1e-6 * np.abs(js24).max()
    # the step's 2 packets sit in the leveller's 480-sample lookahead, so
    # its outputs are silent; the filter and leveller state carry them
    assert np.any(np.asarray(jstate.eq_a) != 0)
    assert np.any(np.asarray(jstate.lev_env) != 0)
    for f, v, jv in zip(state._fields, pack.to_numpy(state), jstate):
        if v is None:
            assert jv is None, f
        elif v.dtype.kind == "f":
            assert _rel_rms(v, jv) <= 1e-6, f
        elif f in ("clip_flags", "wire_pos") or f.startswith("pdm"):
            assert np.array_equal(v, np.asarray(jv)), f


def test_entry_example_args_match_jax(steps):
    (_, jargs, jstate, jout), (fn, args) = steps
    params, state, x, pm = args
    assert np.array_equal(x.numpy(), np.asarray(jargs[2]))
    assert pm.shape == np.asarray(jargs[3]).shape
    assert x.shape == (2, 2, 48, 128)
    st, out = fn(*args)
    _held(st, out, jstate, jout)


def test_entry_on_carried_params_matches_jax(steps):
    (_, jargs, jstate, jout), (fn, args) = steps
    jp, js, jx, jpm = jargs
    params, state = pack.from_numpy(jp, js, "cpu")
    for a, b in zip(pack.to_numpy(params), pack.to_numpy(args[0])):
        assert (a is None and b is None) or np.array_equal(a, b)
    st, out = fn(params, state, torch.as_tensor(np.array(jx)),
                 torch.as_tensor(np.array(jpm)))
    _held(st, out, jstate, jout)


def test_dryrun_multichip_on_two_cpu_devices(capsys):
    graft_entry.dryrun_multichip(2, [torch.device("cpu")] * 2)
    ticks = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[dryrun]")]
    assert len(ticks) == 7, ticks


def test_dryrun_needs_the_cards_it_names():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has the cards")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        graft_entry.dryrun_multichip(2)
