"""The leveller's packet recurrence, ``kernels.lev_cuda.lev_smooth``: its
plain version against a loop of the JAX package's ``fmath.smooth_det``
(the recurrence its ``lev_step`` scans), bit for bit on seeded and edge
inputs; both chains through the one wrapper, once a segment; and one
segment of each chain against the JAX engine."""

import numpy as np
import pytest
import torch

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.core import fmath as jf
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, packet_geometry, pipeline
from dspi_tpu_torch.configs import full_chain_config, hetero_variants
from dspi_tpu_torch.kernels import LAUNCHES, lev_cuda

from lev_cases import case, denormal_first
from util import make_input


def _jax_loop(gc, pow_att, pow_rel, gdb0):
    """The JAX package's recurrence on its NumPy branch, packet by
    packet: alpha by the target's side of the gain, then smooth_det."""
    gdb = gdb0
    out = []
    for k in range(gc.shape[0]):
        alpha = np.where(gc[k] < gdb, pow_att[k], pow_rel[k])
        gdb = jf.smooth_det(alpha, gdb, gc[k])
        out.append(gdb)
    return np.stack(out)


@pytest.mark.parametrize("npkt,rate,lane,B", [
    (128, 48000.0, False, 64), (128, 48000.0, True, 64),
    (130, 44100.0, False, 64), (130, 44100.0, True, 37),
    (1, 48000.0, False, 5), (3, 44100.0, True, 1)])
def test_plain_equals_jax_smooth_det(npkt, rate, lane, B):
    gc, pa, pr, g0 = case(npkt, B, lane, rate, seed=npkt * 7 + B)
    got = lev_cuda.lev_smooth(*(torch.from_numpy(v) for v in
                                (gc, pa, pr, g0))).numpy()
    want = _jax_loop(gc, pa, pr, g0)
    assert got.dtype == np.float32 and got.shape == (npkt, B)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if B >= 5:
        assert denormal_first(got)


@pytest.mark.parametrize("bad", ["dtype", "shape_alpha", "mixed_alpha",
                                 "gdb0", "empty"])
def test_wrapper_refuses(bad):
    gc, pa, pr, g0 = (torch.from_numpy(v) for v in
                      case(4, 6, False, 48000.0, seed=3))
    if bad == "dtype":
        gc = gc.double()
    elif bad == "shape_alpha":
        pa = pr = torch.zeros(4, 3)
    elif bad == "mixed_alpha":
        pr = torch.zeros(4, 6)
    elif bad == "gdb0":
        g0 = g0[:5]
    else:
        gc, pa, pr = gc[:0], pa[:0], pr[:0]
    with pytest.raises((TypeError, ValueError)):
        lev_cuda.lev_smooth(gc, pa, pr, g0)


def _engine(path):
    """(engine, segment input) of a small CPU path."""
    B, npkt = 8, 3
    if path == "float_mxu":
        eng = Engine(full_chain_config(Platform.RP2350), n_streams=B,
                     emit="reduced", device="cpu")
    elif path == "float_scan":
        eng = Engine(full_chain_config(Platform.RP2350), n_streams=B,
                     emit="reduced", mxu=False, device="cpu")
    elif path in ("q28", "q28_lev_off"):
        cfg = full_chain_config(Platform.RP2040)
        cfg.leveller.enabled = path == "q28"
        eng = Engine(cfg, n_streams=B, emit="reduced", device="cpu")
    elif path == "q28_hetero":
        from dspi_tpu_torch.chain.grouped import HeteroServer

        ids = np.arange(B) % 3
        srv = HeteroServer(hetero_variants(3, Platform.RP2040), ids,
                           device="cpu")
        x = np.random.default_rng(5).integers(
            -16000, 16000, (npkt, 2, 48, B)).astype(np.int32)
        return srv, torch.from_numpy(x)
    else:                                           # 44.1 kHz
        sched = packet_geometry(44100.0, npkt)[1]
        eng = Engine(full_chain_config(Platform.RP2040, 44100.0),
                     n_streams=B, emit="reduced", schedule=sched,
                     device="cpu")
        x = np.random.default_rng(5).integers(
            -16000, 16000, (2, int(sum(sched)), B)).astype(np.int32)
        return eng, torch.from_numpy(x)
    x = np.random.default_rng(5).integers(
        -16000, 16000, (npkt, 2, 48, B)).astype(np.int32)
    return eng, torch.from_numpy(x)


@pytest.mark.parametrize("path,calls", [
    ("float_mxu", 1), ("float_scan", 1), ("q28", 1), ("q28_hetero", 1),
    ("q28_44k1", 1), ("q28_lev_off", 0)])
def test_each_chain_calls_the_wrapper_once_a_segment(monkeypatch, path,
                                                     calls):
    """Both chains, both float lowerings, the grouped server and 44.1 kHz
    reach the recurrence through ``lev_smooth`` alone, once a segment (a
    chain with the leveller off never), and on the CPU it launches
    nothing."""
    seen = []

    def counted(*a):
        seen.append(tuple(a[0].shape))
        return lev_cuda.lev_smooth(*a)

    monkeypatch.setattr(pipeline, "lev_smooth", counted)
    eng, x = _engine(path)
    before = dict(LAUNCHES)
    for _ in range(2):
        eng.process(x)
    assert len(seen) == 2 * calls
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("chain", ["float", "q28"])
def test_segment_equals_jax_engine(chain):
    """One segment of 12 packets (past the 10 ms lookahead) on the port
    and the JAX engine from the same params and state: the Q28 chain's
    output words and Q28 gains equal, the float chain's outputs and
    smoothed gain within 1e-6 relative RMS (test_torch_chain.py's
    holds)."""
    B, npkt = 3, 12
    rng = np.random.default_rng(0x1E7)
    if chain == "float":
        je = JEngine(bench.full_chain_config(JPlatform.RP2350), n_streams=B,
                     emit="full", mxu=True)
        te = Engine(full_chain_config(Platform.RP2350), n_streams=B,
                    emit="full", device="cpu")
    else:
        je = JEngine(bench.full_chain_config(JPlatform.RP2040), n_streams=B,
                     emit="full", unroll=1)
        te = Engine(full_chain_config(Platform.RP2040), n_streams=B,
                    emit="full", device="cpu")
    te.load_params_state(je.params, je.state)
    x = make_input(rng, npkt, 48, B)
    jo = {k: np.asarray(v) for k, v in je.process(x).items()}
    to = {k: v.numpy() for k, v in te.process(x).items()}
    assert set(jo) == set(to)
    if chain == "q28":
        for k in ("out", "s24", "peaks"):
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        np.testing.assert_array_equal(te.state.lev_gain.numpy(),
                                      np.asarray(je.state.lev_gain))
    else:
        for k in ("out", "s24"):
            err = np.sqrt(np.mean((to[k].astype(np.float64) - jo[k]) ** 2)
                          / np.mean(jo[k].astype(np.float64) ** 2))
            assert err < 1e-6, (k, err)
        g_t = te.state.lev_gain_db.numpy().astype(np.float64)
        g_j = np.asarray(je.state.lev_gain_db, np.float64)
        assert np.sqrt(np.mean((g_t - g_j) ** 2)
                       / (np.mean(g_j ** 2) + 1e-30)) < 1e-6
    assert np.abs(to["out"]).max() > 0
