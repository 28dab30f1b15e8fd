"""The block lowering's packet carries (``kernels.carry_cuda``) on the CPU:
the plain matrix carry against a float64 form of the same recurrence in
every layout ``mxu._apply_blocked`` hands it (one matrix, a periodic
schedule's pattern positions, one matrix a packet, grouped serving, the
batched outputs with padded state slots), the plain envelope carry bit
for bit against the loop it replaced in ``mxu.env_packet_ends``, the
wrappers' refusals, and the step counters of a segment on the CPU.  The
kernels themselves are held to the plain versions on the card
(test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, mxu, packet_geometry
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.kernels import LAUNCHES, carry_cuda
from dspi_tpu_torch.kernels.carry_cuda import (carry, carry_plain, env_carry,
                                               env_carry_plain)

F32 = torch.float32


def carry_case(seed, N, A, Ry, S, G, P=None, pad=0):
    """Random carry arguments: y [N, *A, Ry, G], vx [N, *A, S, G], s0
    [*A, S, G]; U, W with a step axis of P matrices (None: one matrix).
    W's spectral norm is 0.9, as a stable filter's state map; the last
    ``pad`` state slots pass through (identity rows of W, zero columns of
    U, zero rows of vx), as the batched outputs' padding does."""
    rng = np.random.default_rng(seed)
    lead = () if P is None else (P,)
    W = rng.standard_normal((*lead, *A, S, S))
    W *= 0.9 / np.linalg.norm(W, ord=2, axis=(-2, -1))[..., None, None]
    U = rng.standard_normal((*lead, *A, Ry, S)) / np.sqrt(S)
    vx = rng.standard_normal((N, *A, S, G))
    if pad:
        W[..., S - pad:, :] = 0.0
        W[..., :, S - pad:] = 0.0
        idx = np.arange(S - pad, S)
        W[..., idx, idx] = 1.0
        U[..., S - pad:] = 0.0
        vx[..., S - pad:, :] = 0.0
    y = rng.standard_normal((N, *A, Ry, G))
    s0 = rng.standard_normal((*A, S, G))
    return [torch.from_numpy(np.ascontiguousarray(v)).to(F32)
            for v in (y, vx, s0, U, W)]


def carry64(y, vx, s0, U, W):
    """The recurrence in float64 NumPy, batch axes flattened:
    y[k] += U_j s_k, s_{k+1} = vx[k] + W_j s_k, j = k % P."""
    N, A = y.shape[0], tuple(y.shape[1:-2])
    nA = int(np.prod(A))
    step = U.dim() == y.dim()
    P = U.shape[0] if step else 1
    Ry, S, G = y.shape[-2], vx.shape[-2], y.shape[-1]
    y = y.double().numpy().reshape(N, nA, Ry, G).copy()
    vx = vx.double().numpy().reshape(N, nA, S, G)
    s = s0.double().numpy().reshape(nA, S, G)
    U = U.double().numpy().reshape(P, nA, Ry, S)
    W = W.double().numpy().reshape(P, nA, S, S)
    for k in range(N):
        j = k % P
        y[k] += np.einsum("ars,asg->arg", U[j], s)
        s = vx[k] + np.einsum("aos,asg->aog", W[j], s)
    return y.reshape(N, *A, Ry, G), s.reshape(*A, S, G)


def rel_rms(got, want):
    got = np.asarray(got, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


# (N, A, Ry, S, G, P, pad): chain A's one matrix (S 24, loudness + 10
# bands; S 28, the most), the crossfeed's S 4 over 2T rows, a periodic
# schedule of p = 10, one matrix a packet, grouped serving with K = 2 and
# 4 groups (with and without the outputs' axis), the batched outputs with
# padded slots
LAYOUTS = {
    "uniform_s24": (12, (), 9, 24, 33, None, 0),
    "uniform_s28": (12, (), 9, 28, 33, None, 0),
    "crossfeed_s4": (16, (), 18, 4, 65, None, 0),
    "periodic_p10": (20, (), 7, 24, 17, 10, 0),
    "aperiodic": (9, (), 7, 20, 17, 9, 0),
    "grouped_k2": (8, (2,), 9, 24, 16, None, 0),
    "grouped_k4_outputs": (8, (4, 3), 5, 8, 8, None, 2),
    "grouped_k2_periodic": (20, (2,), 7, 4, 8, 10, 0),
    "outputs_padded": (10, (5,), 9, 20, 31, None, 6),
    "outputs_aperiodic": (6, (3,), 5, 12, 9, 6, 4),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_carry_equals_float64(name):
    """``carry_plain`` (and ``carry`` on CPU tensors) against the float64
    recurrence: y and sF within 5e-7 relative RMS, float32's rounding over
    the steps (the plain version reads 2.9e-8 to 8.8e-8 here); y is
    updated in place; a padded slot keeps its state exactly."""
    N, A, Ry, S, G, P, pad = LAYOUTS[name]
    args = carry_case(sum(map(ord, name)), N, A, Ry, S, G, P, pad)
    want_y, want_s = carry64(*args)
    for fn in (carry_plain, carry):
        y = args[0].clone()
        sF = fn(y, *args[1:])
        assert sF.dtype == F32 and tuple(sF.shape) == (*A, S, G)
        assert rel_rms(y, want_y) < 5e-7, name
        assert rel_rms(sF, want_s) < 5e-7, name
        if pad:
            assert torch.equal(sF[..., S - pad:, :], args[2][..., S - pad:, :])


def test_plain_carry_takes_float64():
    """The exact-map twin (tests/fuzz_twin.py) carries in float64 on the
    CPU: the plain version takes it, and equals the float64 recurrence."""
    args = [v.double() for v in carry_case(5, 10, (3,), 7, 24, 9, 5)]
    want_y, want_s = carry64(*args)
    y = args[0].clone()
    sF = carry(y, *args[1:])
    assert sF.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sF.numpy(), want_s, rtol=1e-12, atol=1e-12)


def env_loop(aT, cl, cr, el, er):
    """``mxu.env_packet_ends``' loop over the packets as it stood before
    ``env_carry``."""
    out_l, out_r = [], []
    for k in range(cl.shape[0]):
        el = aT[k] * el + cl[k]
        er = aT[k] * er + cr[k]
        el = torch.where(el < 1e-30, torch.zeros_like(el), el)
        er = torch.where(er < 1e-30, torch.zeros_like(er), er)
        out_l.append(el)
        out_r.append(er)
    return torch.stack(out_l), torch.stack(out_r)


def env_case(seed, npkt, B, alpha):
    """Envelope carry arguments whose values straddle the flush: weighted
    sums and start envelopes at 0, +-denormal, 1e-30 and its float32
    neighbours, ~1e-31 and ~1e-29, alphas in (0, 1]; aT [Npkt]
    ("packet"), per lane [Npkt, B] ("lane"), or expanded views of one
    alpha ("uniform": [Npkt] from a scalar; "uniform_lane": [Npkt, B] from
    [B]), as ``env_packet_ends`` passes them."""
    rng = np.random.default_rng(seed)
    t = np.float32(1e-30)
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, t, np.nextafter(t, 0),
                      np.nextafter(t, 1), 1e-31, 1e-29, 3e-30, 0.5, 1.0],
                     np.float32)
    c = (rng.choice(edges, size=(2, npkt, B)) * rng.choice(
        [0.0, 1.0, 0.3], size=(2, npkt, B))).astype(np.float32)
    c[:, 0, :len(edges)] = edges[:B]
    e0 = rng.choice(edges, size=(2, B)).astype(np.float32)
    e0[:, :len(edges)] = edges[:B]
    a = rng.uniform(0.0, 1.0, size=(npkt, B)).astype(np.float32)
    a[:, 0] = 1.0
    cl, cr, el0, er0 = (torch.from_numpy(np.ascontiguousarray(v))
                        for v in (c[0], c[1], e0[0], e0[1]))
    if alpha == "packet":
        aT = torch.from_numpy(np.ascontiguousarray(a[:, 1]))
    elif alpha == "lane":
        aT = torch.from_numpy(a)
    elif alpha == "uniform":
        aT = torch.tensor(0.75, dtype=F32).expand(npkt)
    else:
        aT = torch.from_numpy(a[0]).expand(npkt, B)
    return aT, cl, cr, el0, er0


@pytest.mark.parametrize("alpha", ["packet", "lane", "uniform",
                                   "uniform_lane"])
def test_plain_env_carry_equals_loop(alpha):
    """``env_carry_plain`` and ``env_carry`` (CPU) equal the loop they
    replace bit for bit, the flush below 1e-30 included (a third of the
    lanes start or land on a value at the threshold or beside it)."""
    args = env_case(17, 24, 37, alpha)
    want = env_loop(*args)
    assert float((want[0] == 0).float().mean()) > 0.05     # the flush fires
    for fn in (env_carry_plain, env_carry):
        got = fn(*args)
        for g, w in zip(got, want):
            assert g.dtype == F32 and g.shape == w.shape
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _carry_args(bad):
    y, vx, s0, U, W = carry_case(3, 4, (2,), 5, 6, 8)
    if bad == "dtype":
        y, vx, s0, U, W = (v.to(torch.int32) for v in (y, vx, s0, U, W))
    elif bad == "mixed_dtype":
        U = U.double()
    elif bad == "device":
        W = W.to("meta")
    elif bad == "meta":
        y, vx, s0, U, W = (v.to("meta") for v in (y, vx, s0, U, W))
    elif bad == "contiguous":
        y = y.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "vx_shape":
        vx = vx[:, :, :4]
    elif bad == "s0_shape":
        s0 = s0[:1]
    elif bad == "U_shape":
        U = U[..., :4, :]
    elif bad == "W_shape":
        W = W[..., :5]
    elif bad == "steps":                 # 3 matrices for 4 steps
        U, W = U.expand(3, *U.shape).clone(), W.expand(3, *W.shape).clone()
    elif bad in ("odd_s", "large_s"):
        S = 5 if bad == "odd_s" else 30
        y, vx, s0, U, W = carry_case(3, 4, (2,), 5, S, 8)
    elif bad == "empty":
        y, vx = y[:0], vx[:0]
    return y, vx, s0, U, W


@pytest.mark.parametrize("bad", [
    "dtype", "mixed_dtype", "device", "meta", "contiguous", "vx_shape",
    "s0_shape", "U_shape", "W_shape", "steps", "odd_s", "large_s", "empty"])
def test_carry_refuses(bad):
    """``carry`` raises on tensors of another dtype or of mixed dtypes, on
    another device or one with no kernel, a non-contiguous tensor, shapes
    that do not agree, a step axis that does not divide the steps, a state
    size that is odd or above 28, and no steps; the same case unbroken
    runs."""
    with pytest.raises((TypeError, ValueError)):
        carry(*_carry_args(bad))
    carry(*_carry_args(None))


def _env_args(bad):
    aT, cl, cr, el0, er0 = env_case(9, 6, 13, "lane")
    if bad == "dtype":
        cl = cl.double()
    elif bad == "alpha_dtype":
        aT = aT.to(torch.float16)
    elif bad == "device":
        er0 = er0.to("meta")
    elif bad == "contiguous":
        cl = cl.t().contiguous().t()
    elif bad == "alpha_shape":
        aT = aT[:, :5]
    elif bad == "c_shape":
        cr = cr[:5]
    elif bad == "e0_shape":
        el0 = el0[:5]
    elif bad == "empty":
        aT, cl, cr = aT[:0], cl[:0], cr[:0]
    return aT, cl, cr, el0, er0


@pytest.mark.parametrize("bad", ["dtype", "alpha_dtype", "device",
                                 "contiguous", "alpha_shape", "c_shape",
                                 "e0_shape", "empty"])
def test_env_carry_refuses(bad):
    """``env_carry`` raises on a float64 sum or a float16 alpha, a tensor
    on another device, a non-contiguous sum, an alpha, sum or start of
    another shape, and no packets; the same case unbroken runs."""
    with pytest.raises((TypeError, ValueError)):
        env_carry(*_env_args(bad))
    env_carry(*_env_args(None))


def test_kernel_flush_constant_is_float32_1e30():
    """``csrc/carry.cu``'s flush threshold, a hexadecimal float, is
    float32(1e-30), the value the plain loop's comparison takes; its
    instances cover the state sizes the wrapper takes, up to 28."""
    src = (Path(carry_cuda.__file__).parent / "csrc" / "carry.cu").read_text()
    (hexf,) = re.findall(r"kTiny = (0x[0-9a-fp.+-]+)f;", src)
    assert float.fromhex(hexf) == float(np.float32(1e-30))
    assert max(map(int, re.findall(r"DSPI_CARRY_CASE\((\d+)\)", src))) \
        == carry_cuda.MAX_STATE


@pytest.mark.parametrize("rate,n_packets", [(48000.0, 4), (44100.0, 10)])
def test_cpu_segment_counts_plain_steps(rate, n_packets):
    """On CPU tensors a segment runs the plain loops: ``carry_steps``
    grows by the layout's steps (4 LTI carries and the envelope's), and
    ``carry_kernel_steps`` and the two kernels' launch counts stay."""
    block, sched = packet_geometry(rate, n_packets)
    key = (tuple(sched or ()), block, len(sched or ()) or n_packets)
    steps = (4 * len(mxu._layout(*key, True).sched)
             + len(mxu._layout(*key, False).sched))
    eng = Engine(full_chain_config(Platform.RP2350, rate), 2,
                 block_size=block, schedule=sched, pdm=False,
                 emit="reduced", device="cpu")
    x = (np.zeros((2, sum(sched), 2), np.int32) if sched
         else np.zeros((n_packets, 2, block, 2), np.int32))
    before = (mxu.COUNTS["carry_steps"], mxu.COUNTS["carry_kernel_steps"],
              LAUNCHES["carry"], LAUNCHES["env_carry"])
    eng.process(x)
    after = (mxu.COUNTS["carry_steps"], mxu.COUNTS["carry_kernel_steps"],
             LAUNCHES["carry"], LAUNCHES["env_carry"])
    assert after == (before[0] + steps, *before[1:])
