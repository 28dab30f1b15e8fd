"""The port's integer and deterministic-float math (dspi_tpu_torch.core)
against the JAX package's NumPy branch: bit-exact on random and edge
inputs."""

import numpy as np
import pytest
import torch

from dspi_tpu.core import fmath as jf
from dspi_tpu.core import qmath as jq
from dspi_tpu_torch.core import fmath as tf
from dspi_tpu_torch.core import qmath as tq

I32_EDGES = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**28, -2**28, 0xFFFF,
                      0x10000, -0x10000, 0x7FFF8000, 12345678, -87654321],
                     np.int32)


def _ints(seed, n=4096):
    rng = np.random.default_rng(seed)
    r = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    return np.concatenate([r, I32_EDGES])


def _pairs(seed):
    a = _ints(seed)
    b = _ints(seed + 1)
    ea, eb = np.meshgrid(I32_EDGES, I32_EDGES)
    return (np.concatenate([a, ea.ravel()]),
            np.concatenate([b, eb.ravel()]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("fn", ["q28_mul", "q15_mul"])
@pytest.mark.parametrize("seed", [1, 2])
def test_fixed_point_products(fn, seed):
    a, b = _pairs(seed)
    with np.errstate(over="ignore"):
        want = getattr(jq, fn)(a, b)
    _same(getattr(tq, fn)(_t(a), _t(b)), want)


def test_q28_to_s24():
    a = _ints(3)
    _same(tq.q28_to_s24(_t(a)), jq.q28_to_s24(a))


def _floats(seed, n=4096, positive=False, lo=-37, hi=37):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(lo, hi, n)).astype(
        np.float32)
    edges = np.array([1.0, 2.0, 0.5, 1.4142135, 1.4142137,
                      np.float32(1.4142135624), np.nextafter(
                          np.float32(1.4142135624), np.float32(0)),
                      1e-30, 1.1754944e-38, 3.4028235e38, 1e-6, 0.70795,
                      np.nextafter(np.float32(1), np.float32(2)),
                      np.nextafter(np.float32(1), np.float32(0))],
                     np.float32)
    x = np.concatenate([x, edges, -edges])
    if positive:
        x = np.abs(x)
        x = x[x >= np.float32(1.1754944e-38)]
    return x


def test_f32_to_i32():
    x = np.concatenate([_floats(4, lo=-3, hi=12),
                        np.array([np.nan, np.inf, -np.inf, 2147483648.0,
                                  -2147483648.0, 2147483520.0, -0.0, 0.5,
                                  -0.5, 1e-45], np.float32)])
    _same(tq.f32_to_i32(_t(x)), jq.f32_to_i32(x))


@pytest.mark.parametrize("fn", ["log2_f32", "log10_f32", "det_recip"])
def test_positive_domain(fn):
    x = _floats(5, positive=True)
    x = np.concatenate([x, 1.0 / x[(x > 1e-37) & (x < 1e37)]])
    _same(getattr(tf, fn)(_t(x)), getattr(jf, fn)(x))


def test_det_recip_signed_and_zero():
    """Negative inputs, and zero / denormal inputs (outside the contract,
    but the limiter feeds them and masks the result): same bits."""
    x = np.concatenate([_floats(6), np.array([0.0, -0.0, 1e-45, -1e-40],
                                             np.float32)])
    _same(tf.det_recip(_t(x)), jf.det_recip(x))
    _same(tf.det_div(np.float32(0.70795), _t(x)),
          jf.det_div(np.float32(0.70795), x))


@pytest.mark.parametrize("fn", ["exp2_f32", "exp10_f32"])
def test_exp(fn):
    rng = np.random.default_rng(7)
    scale = 120.0 if fn == "exp2_f32" else 36.0
    x = (rng.uniform(-1, 1, 4096) * scale).astype(np.float32)
    x = np.concatenate([x, np.array([0.0, -0.0, 1.0, -1.0, 0.5, 1e-7,
                                     -1e-7, 0.99999994], np.float32)])
    _same(getattr(tf, fn)(_t(x)), getattr(jf, fn)(x))


def test_pow():
    rng = np.random.default_rng(8)
    a = np.concatenate([rng.uniform(0, 1, 2048),
                        rng.uniform(0.99, 1.0, 2048),
                        [0.0, 1.0, 0.5, 0.9998801]]).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 200, 4096),
                        [48.0, 96.0, 1.0, 0.0]]).astype(np.float32)
    _same(tf.pow_f32(_t(a), _t(b)), jf.pow_f32(a, b))
    # the leveller's call shape: a scalar base, a count column
    a0 = np.float32(0.99935)
    col = np.array([[48.0], [96.0]], np.float32)
    _same(tf.pow_f32(_t(np.array(a0)), _t(col)), jf.pow_f32(a0, col))


@pytest.mark.parametrize("seed", [9, 10])
def test_mul_det(seed):
    a = np.concatenate([_floats(seed), np.array(
        [0.0, -0.0, 1e-40, -1e-40, 3.4e38, 1e-20, 1.5], np.float32)])
    b = np.concatenate([_floats(seed + 100), np.array(
        [5.0, 1e-40, 2.0, -3.0, 10.0, 1e-20, 1.0000001], np.float32)])
    _same(tf.mul_det(_t(a), _t(b)), jf.mul_det(a, b))


def test_smooth_det():
    rng = np.random.default_rng(11)
    alpha = rng.uniform(0.9, 1.0, 4096).astype(np.float32)
    prev = (rng.standard_normal(4096) * 20).astype(np.float32)
    target = (rng.standard_normal(4096) * 20).astype(np.float32)
    target[:64] = 0.0
    _same(tf.smooth_det(_t(alpha), _t(prev), _t(target)),
          jf.smooth_det(alpha, prev, target))


XORSHIFT_SEEDS = [123456789, 0x80000000, 1, 42, 0xFFFFFFFF, 0xDEADBEEF,
                  0x7FFFFFFF]


def test_xorshift32():
    """The PDM dither PRNG on int32 tensors, word for word over 16 steps
    against the JAX package's on uint32 NumPy and on jnp and the port's
    Python-int reference (golden/qref.py), the sign bit included."""
    import jax.numpy as jnp

    from dspi_tpu_torch.golden import qref

    seeds = np.array(XORSHIFT_SEEDS, np.uint32)
    s_t = _t(seeds.view(np.int32))
    s_np, s_j = seeds, jnp.asarray(seeds)
    ref = [int(v) for v in seeds]
    for _ in range(16):
        s_t = tq.xorshift32(s_t)
        s_np = jq.xorshift32(s_np)
        s_j = jq.xorshift32(s_j)
        ref = [qref.xorshift32(r) for r in ref]
        assert s_t.dtype == torch.int32
        _same(s_t, s_np.view(np.int32))
        _same(s_t, np.asarray(s_j).view(np.int32))
        assert s_t.numpy().view(np.uint32).tolist() == ref
