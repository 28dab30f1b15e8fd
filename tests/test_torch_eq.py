"""The port's Q28 cascade and crossfeed pieces against the JAX package.

Held to: bit-exact, word for word.  Everything here is integer arithmetic
(``fast_mul_q28`` partial products with int32 wrap-around), so any
difference is a fault, not rounding.

  * ``kernels.eq`` band steps vs ``dspi_tpu.chain.pipeline``'s;
  * ``kernels.eq.q28_cascades_plain`` vs a ``lax.scan`` over the JAX band
    steps (``tests/test_eq_pallas.py``'s reference), and, with
    ``DSPI_TEST_SLOW`` set, vs the Pallas kernel in interpret mode; in the
    per-lane (``lane_cf``) and packet-schedule modes too, against the same
    reference written out per lane, with the envelope read at
    ``cumsum(sched) - 1``;
  * ``kernels.xf_cuda.xf_q28_plain`` vs a ``lax.scan`` of the JAX chain's
    crossfeed step, with [3] and per-lane [3, B] coefficients;
  * the front doors on CPU tensors run the plain versions and count no
    launch; arguments they do not take raise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dspi_tpu.chain.pipeline import _band_step_q28, _tdf2_q28_bypassable
from dspi_tpu.core.qmath import q28_mul as jq28_mul
from dspi_tpu_torch.core.qmath import q28_mul
from dspi_tpu_torch.kernels import LAUNCHES
from dspi_tpu_torch.kernels.eq import (band_step_q28, q28_cascades_plain,
                                       tdf2_q28_bypassable)
from dspi_tpu_torch.kernels.eq_cuda import q28_cascades
from dspi_tpu_torch.kernels.xf_cuda import xf_q28, xf_q28_plain

from test_eq_pallas import _ref as scan_ref

TC = 48
# (has_loud, has_env, nb, G, B): test_eq_pallas.py's four flag cases, then
# the headline master shape (loudness + 10 bands + envelope) at a ragged B
CASES = [(False, False, 3, 2, 3), (True, False, 2, 2, 3), (True, True, 4, 2, 3),
         (False, True, 0, 2, 3), (True, True, 10, 3, 5)]


def _i32(rng, lo, hi, shape):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _cascade_inputs(seed, has_loud, has_env, nb, G, B, npkt=2):
    """Inputs as tests/test_eq_pallas.py makes them, with bypass flags and
    envelope alphas that differ between cascades."""
    rng = np.random.default_rng(seed)
    n_loud = 2 if has_loud else 0
    S = 2 * (n_loud + nb) + (1 if has_env else 0)
    x = _i32(rng, -(1 << 27), 1 << 27, (G, TC * npkt, B))
    cf = _i32(rng, -(1 << 27), 1 << 27, (G, n_loud + nb, 5)) >> 2
    s0 = _i32(rng, -(1 << 20), 1 << 20, (G, S, B))
    a_rms = 260000000 - 9999999 * np.arange(G)
    flags = [(0, 1), (1, 0), (1, 1), (0, 0)]
    scal = np.array([[*flags[g], a_rms[g], (1 << 28) - a_rms[g]]
                     for g in range(G)], np.int32)
    return x, cf, s0, scal


def _assert_same(got, want):
    y, env, sF = got
    np.testing.assert_array_equal(y.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(sF.numpy(), np.asarray(want[2]))
    if want[1] is None:
        assert env is None
    else:
        np.testing.assert_array_equal(env.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("bypass", [False, True])
def test_band_steps_match_jax(bypass):
    """Full-range int32 words, so every product and sum wraps somewhere."""
    rng = np.random.default_rng(5 + bypass)
    cf = _i32(rng, -2**31, 2**31, (5, 4096))
    s = _i32(rng, -2**31, 2**31, (2, 4096))
    xin = _i32(rng, -2**31, 2**31, (4096,))
    t = lambda a: torch.from_numpy(a)                         # noqa: E731
    want = _band_step_q28(jnp.asarray(cf), (jnp.asarray(s[0]),
                                            jnp.asarray(s[1])),
                          jnp.asarray(xin))
    got = band_step_q28(tuple(t(cf)), (t(s[0]), t(s[1])), t(xin))
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = _tdf2_q28_bypassable(jnp.asarray(cf), (jnp.asarray(s[0]),
                                                  jnp.asarray(s[1])),
                                jnp.asarray(xin), bypass)
    got = tdf2_q28_bypassable(tuple(t(cf)), (t(s[0]), t(s[1])), t(xin),
                              torch.tensor(bypass))
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("has_loud,has_env,nb,G,B", CASES)
def test_plain_cascade_matches_scan(has_loud, has_env, nb, G, B):
    x, cf, s0, scal = _cascade_inputs(11 + nb, has_loud, has_env, nb, G, B)
    want = scan_ref(jnp.asarray(x), jnp.asarray(cf), jnp.asarray(s0),
                    jnp.asarray(scal), nb, has_loud, has_env, TC)
    got = q28_cascades_plain(*map(torch.from_numpy, (x, cf, s0, scal)), nb=nb,
                             has_loud=has_loud, has_env=has_env, tc=TC)
    _assert_same(got, want)


def test_plain_cascade_matches_pallas_interpret():
    if not os.environ.get("DSPI_TEST_SLOW"):
        pytest.skip("pallas interpret mode is slow on CPU; set "
                    "DSPI_TEST_SLOW=1 to run")
    from dspi_tpu.kernels.eq_pallas import q28_cascades as pallas_cascades

    has_loud, has_env, nb, G, B = True, True, 4, 2, 256
    x, cf, s0, scal = _cascade_inputs(3, has_loud, has_env, nb, G, B)
    want = pallas_cascades(jnp.asarray(x), jnp.asarray(cf), jnp.asarray(s0),
                           jnp.asarray(scal), nb=nb, has_loud=has_loud,
                           has_env=has_env, tc=TC, bt=128, interpret=True)
    got = q28_cascades_plain(*map(torch.from_numpy, (x, cf, s0, scal)), nb=nb,
                             has_loud=has_loud, has_env=has_env, tc=TC)
    _assert_same(got, want)


def _xf_scan_ref(l, r, coef, s4):
    """The JAX chain's crossfeed step (chain/pipeline.py ``xf_body``) under
    lax.scan."""
    lp_a0, lp_b1, ap_a = coef[0], coef[1], coef[2]

    def body(c, xt):
        lpL, lpR, apL, apR = c
        ml, mr = xt
        lp_l = jq28_mul(lp_a0, ml) + jq28_mul(lp_b1, lpL)
        lp_r = jq28_mul(lp_a0, mr) + jq28_mul(lp_b1, lpR)
        ap_l = jq28_mul(ap_a, lp_l) + apL
        apL_n = lp_l - jq28_mul(ap_a, ap_l)
        ap_r = jq28_mul(ap_a, lp_r) + apR
        apR_n = lp_r - jq28_mul(ap_a, ap_r)
        return ((lp_l, lp_r, apL_n, apR_n),
                ((ml - lp_l) + ap_r, (mr - lp_r) + ap_l))

    cF, (ol, orr) = lax.scan(body, tuple(s4), (l, r))
    return ol, orr, jnp.stack(cF)


@pytest.mark.parametrize("full_range", [False, True])
def test_xf_plain_matches_jax_scan(full_range):
    rng = np.random.default_rng(21 + full_range)
    T, B = 96, 3
    lim = 2**31 if full_range else 1 << 28
    l, r = _i32(rng, -lim, lim, (T, B)), _i32(rng, -lim, lim, (T, B))
    # BS2B-like coefficients, or any words at all
    coef = (_i32(rng, -lim, lim, (3,)) if full_range else
            np.array([19000000, 249000000, -180000000], np.int32))
    s4 = _i32(rng, -(1 << 24), 1 << 24, (4, B))
    want = _xf_scan_ref(*map(jnp.asarray, (l, r, coef, s4)))
    got = xf_q28_plain(*map(torch.from_numpy, (l, r, coef, s4)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_front_doors_run_the_plain_versions_on_cpu():
    x, cf, s0, scal = map(torch.from_numpy,
                          _cascade_inputs(2, True, True, 3, 2, 3))
    kw = dict(nb=3, has_loud=True, has_env=True, tc=TC)
    before = dict(LAUNCHES)
    a = q28_cascades(x, cf, s0, scal, **kw)
    b = q28_cascades_plain(x, cf, s0, scal, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    l, r = x[0], x[1]
    coef = torch.tensor([19000000, 249000000, -180000000], dtype=torch.int32)
    s4 = torch.zeros((4, 3), dtype=torch.int32)
    for u, v in zip(xf_q28(l, r, coef, s4), xf_q28_plain(l, r, coef, s4)):
        assert torch.equal(u, v)
    assert dict(LAUNCHES) == before


def test_cascade_refusals():
    x, cf, s0, scal = map(torch.from_numpy,
                          _cascade_inputs(2, False, True, 2, 2, 3))
    kw = dict(nb=2, has_env=True, tc=TC)
    with pytest.raises(ValueError, match="sum to T=96"):
        q28_cascades(x, cf, s0, scal, sched=(44, 45), **kw)
    with pytest.raises(ValueError, match="sum to T=96"):
        q28_cascades(x, cf, s0, scal, sched=(96, 0), **kw)
    lane_cf = cf[..., None].expand(2, 2, 5, 3).contiguous()
    with pytest.raises(ValueError, match="scal must be"):
        q28_cascades(x, lane_cf, s0, scal, **kw)
    with pytest.raises(ValueError, match="whole packets"):
        q28_cascades(x[:, :50], cf, s0, scal, **kw)
    with pytest.raises(ValueError, match="s0 must be"):
        q28_cascades(x, cf, s0[:, :4], scal, **kw)
    with pytest.raises(TypeError):
        q28_cascades(x.long(), cf, s0, scal, **kw)


# (cf per lane, schedule): the kernel's other modes.  SCHED is periodic (the
# 44/45 cadence), SCHED1 is not and has a one-sample packet.
SCHED, SCHED1 = (44, 45, 44, 45), (44, 1, 45, 7)
MODES = [(True, None), (False, SCHED), (False, SCHED1), (True, SCHED1)]
MODE_IDS = ["lane_cf", "sched", "sched_1", "lane_cf+sched"]


def _general_ref(x, cf, s0, scal, nb, has_loud, has_env, ends):
    """tests/test_eq_pallas.py's lax.scan reference with per-lane
    coefficients and scalars (cf [G, nr, 5, B], scal [G, 4, B]; per-cascade
    ones broadcast the same way) and the envelope read at ``ends``."""
    G = x.shape[0]
    n_loud = 2 if has_loud else 0
    ys, env_ends, sF = [], [], []
    for g in range(G):
        def step(carry, xt, g=g):
            st = list(carry)
            cur = xt
            r = 0
            for j in range(n_loud):
                cur, (st[r], st[r + 1]) = _tdf2_q28_bypassable(
                    cf[g, j], (st[r], st[r + 1]), cur, scal[g, j] != 0)
                r += 2
            for b in range(nb):
                cur, (st[r], st[r + 1]) = _band_step_q28(
                    cf[g, n_loud + b], (st[r], st[r + 1]), cur)
                r += 2
            if has_env:
                st[r] = (jq28_mul(scal[g, 2], st[r])
                         + jq28_mul(scal[g, 3], jq28_mul(cur, cur)))
            return tuple(st), ((cur, st[r]) if has_env else cur)
        carryF, out = lax.scan(step, tuple(s0[g]), x[g])
        y_g, env_g = out if has_env else (out, None)
        ys.append(y_g)
        if has_env:
            env_ends.append(env_g[np.asarray(ends)])
        sF.append(jnp.stack(carryF))
    return (jnp.stack(ys), jnp.stack(env_ends) if has_env else None,
            jnp.stack(sF))


def _mode_inputs(seed, has_loud, has_env, nb, G, B, lane, sched):
    """_cascade_inputs over sum(sched) samples; with ``lane``, coefficients,
    bypass flags (mixed within a cascade) and envelope alphas that differ
    lane by lane."""
    rng = np.random.default_rng(seed)
    T = sum(sched) if sched else 2 * TC
    n_loud = 2 if has_loud else 0
    nr = n_loud + nb
    x = _i32(rng, -(1 << 27), 1 << 27, (G, T, B))
    s0 = _i32(rng, -(1 << 20), 1 << 20, (G, 2 * nr + has_env, B))
    if not lane:
        _, cf, _, scal = _cascade_inputs(seed, has_loud, has_env, nb, G, B)
        return x, cf, s0, scal
    cf = _i32(rng, -(1 << 27), 1 << 27, (G, nr, 5, B)) >> 2
    a_rms = _i32(rng, 200000000, 268000000, (G, B))
    scal = np.stack([_i32(rng, 0, 2, (G, B)), _i32(rng, 0, 2, (G, B)),
                     a_rms, (1 << 28) - a_rms], axis=1)
    return x, cf, s0, scal


@pytest.mark.parametrize("lane,sched", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("has_loud,has_env,nb", [
    (True, True, 4), (False, True, 0), (True, False, 2)])
def test_plain_cascade_modes_match_scan(has_loud, has_env, nb, lane, sched):
    G, B = 2, 5
    x, cf, s0, scal = _mode_inputs(31 + nb, has_loud, has_env, nb, G, B,
                                   lane, sched)
    ends = np.cumsum(sched or (TC,) * 2) - 1
    want = _general_ref(*map(jnp.asarray, (x, cf, s0, scal)), nb, has_loud,
                        has_env, ends)
    got = q28_cascades_plain(*map(torch.from_numpy, (x, cf, s0, scal)), nb=nb,
                             has_loud=has_loud, has_env=has_env, tc=TC,
                             sched=sched)
    if has_env:
        assert got[1].shape == (G, len(ends), B)
    _assert_same(got, want)


def test_plain_cascade_modes_match_pallas_interpret():
    """The Pallas kernel's lane_cf mode with a schedule (its dense envelope,
    time padding and packet-end gather), in interpret mode."""
    if not os.environ.get("DSPI_TEST_SLOW"):
        pytest.skip("pallas interpret mode is slow on CPU; set "
                    "DSPI_TEST_SLOW=1 to run")
    from dspi_tpu.kernels.eq_pallas import q28_cascades as pallas_cascades

    has_loud, has_env, nb, G, B = True, True, 3, 2, 256
    x, cf, s0, scal = _mode_inputs(9, has_loud, has_env, nb, G, B, True,
                                   SCHED1)
    want = pallas_cascades(*map(jnp.asarray, (x, cf, s0, scal)), nb=nb,
                           has_loud=has_loud, has_env=has_env, tc=TC,
                           sched=SCHED1, bt=128, interpret=True)
    got = q28_cascades_plain(*map(torch.from_numpy, (x, cf, s0, scal)), nb=nb,
                             has_loud=has_loud, has_env=has_env, tc=TC,
                             sched=SCHED1)
    _assert_same(got, want)


def test_xf_plain_per_lane_matches_jax_scan():
    """[3, B] coefficients (per-stream parameters) against the JAX chain's
    crossfeed step fed the same per-lane vectors."""
    rng = np.random.default_rng(23)
    T, B = 96, 4
    l, r = (_i32(rng, -2**31, 2**31, (T, B)) for _ in range(2))
    coef = _i32(rng, -2**31, 2**31, (3, B))
    s4 = _i32(rng, -(1 << 24), 1 << 24, (4, B))
    want = _xf_scan_ref(*map(jnp.asarray, (l, r, coef, s4)))
    got = xf_q28_plain(*map(torch.from_numpy, (l, r, coef, s4)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a per-lane column of one value is the [3] form's word for word
    same = xf_q28_plain(*map(torch.from_numpy, (
        l, r, np.repeat(coef[:, :1], B, 1), s4)))
    for u, v in zip(same, xf_q28_plain(*map(torch.from_numpy, (
            l, r, coef[:, 0].copy(), s4)))):
        assert torch.equal(u, v)


@pytest.mark.parametrize("sched", [None, SCHED1], ids=["uniform", "sched_1"])
@pytest.mark.parametrize("has_loud,has_env,nb", [
    (True, True, 4), (False, False, 3), (True, False, 2), (False, True, 0)])
def test_bucket_uniform_lane_cf_equals_scalar_per_bucket(has_loud, has_env,
                                                         nb, sched):
    """Per-lane columns that are constant over each of K buckets (the
    HeteroServer's flat layout) give, bucket by bucket, the per-cascade
    call on that bucket's [G, rows, 5] row and [G, 4] scalars: y, envelope
    and state word for word."""
    G, K, W = 2, 3, 4
    x, cf, s0, scal = _mode_inputs(47 + nb, has_loud, has_env, nb, G, K * W,
                                   True, sched)
    cf = np.repeat(cf[..., ::W], W, axis=-1)
    scal = np.repeat(scal[..., ::W], W, axis=-1)
    kw = dict(nb=nb, has_loud=has_loud, has_env=has_env, tc=TC, sched=sched)
    lane = q28_cascades_plain(*map(torch.from_numpy, (x, cf, s0, scal)), **kw)
    for k in range(K):
        cut = slice(k * W, (k + 1) * W)
        got = q28_cascades_plain(
            *map(torch.from_numpy, (np.ascontiguousarray(x[..., cut]),
                                    np.ascontiguousarray(cf[..., k * W]),
                                    np.ascontiguousarray(s0[..., cut]),
                                    np.ascontiguousarray(scal[..., k * W]))),
            **kw)
        for u, v in zip(lane, got):
            if v is None:
                assert u is None
            else:
                assert torch.equal(u[..., cut], v)


def _lane_pipeline(x, cf, s0, scal, nb, has_loud, has_env, ends):
    """csrc/eq_q28.cu's lane_kernel transcribed, all streams at once: a
    bypassed loudness row is an identity band with zero state whose s_in
    words are copied to s_out; the bands are skewed across samples, so in
    step i band j runs sample i - j on band j - 1's output of step i - 1
    and the envelope sample i - rows on the last band's; the steps before
    every stage has a sample (fill) and after the first stages have run out
    (drain) keep the state of a stage without a sample; an envelope is
    stored after the step in which the envelope stage passed its packet's
    end."""
    G, T, B = x.shape
    nr = (2 if has_loud else 0) + nb
    lag_y = max(nr - 1, 0)
    depth = nr if has_env else lag_y
    one, zero = (torch.full((G, B), v, dtype=torch.int32) for v in (1 << 28,
                                                                   0))
    ident = [torch.full((G, B), False) | (
        (scal[:, r] != 0) if has_loud and r < 2 else False)
        for r in range(nr)]
    c = [[torch.where(ident[r], one if k == 0 else zero, cf[:, r, k])
          for k in range(5)] for r in range(nr)]
    st = [[torch.where(ident[r], 0, s0[:, 2 * r + i]) for i in (0, 1)]
          for r in range(nr)]
    v = [zero] * nr
    e = s0[:, -1] if has_env else None
    y = torch.empty_like(x)
    env = torch.empty((G, len(ends), B), dtype=torch.int32) if has_env \
        else None
    p = 0
    store_at = ends[0] + nr if has_env else None
    for i in range(T + depth):
        xin = x[:, i] if i < T else zero
        if has_env:
            ne = (q28_mul(scal[:, 2], e)
                  + q28_mul(scal[:, 3], q28_mul(*(2 * [v[-1] if nr else xin]))))
            e = ne if 0 <= i - nr < T else e
        for j in reversed(range(nr)):
            out, (n1, n2) = band_step_q28(c[j], st[j], xin if j == 0 else
                                          v[j - 1])
            v[j] = out
            if 0 <= i - j < T:
                st[j] = [n1, n2]
        if 0 <= i - lag_y < T:
            y[:, i - lag_y] = v[-1] if nr else xin
        if has_env and i == store_at:
            env[:, p] = e
            p += 1
            store_at = ends[p] + nr if p < len(ends) else None
    s_out = s0.clone()
    for r in range(nr):
        for i in (0, 1):
            s_out[:, 2 * r + i] = torch.where(ident[r], s0[:, 2 * r + i],
                                              st[r][i])
    if has_env:
        s_out[:, -1] = e
    return y, env, s_out


@pytest.mark.parametrize("has_loud,has_env,nb,sched", [
    (True, True, 10, None), (False, False, 10, None), (True, True, 12, SCHED1),
    (True, False, 1, None), (True, True, 0, (1,)), (False, True, 3, (1, 1, 5)),
    (False, False, 0, (3,)), (True, True, 10, (1, 2)), (False, True, 0, None)])
def test_lane_pipeline_transcription_equals_plain(has_loud, has_env, nb,
                                                  sched):
    """The per-lane kernel's skewed schedule, transcribed (_lane_pipeline),
    against the plain version word for word: per-lane bypass flags, T
    shorter than the pipeline's depth (T=1, T=3 with 12 rows), 1-sample
    packets, packets that end in the fill or the drain, no bands."""
    G, B = 2, 6
    x, cf, s0, scal = _mode_inputs(61 + nb, has_loud, has_env, nb, G, B,
                                   True, sched)
    T = x.shape[1]
    ends = tuple(np.cumsum(sched or (TC,) * (T // TC)) - 1)
    args = tuple(map(torch.from_numpy, (x, cf, s0, scal)))
    want = q28_cascades_plain(*args, nb=nb, has_loud=has_loud,
                              has_env=has_env, tc=TC, sched=sched)
    got = _lane_pipeline(*args, nb, has_loud, has_env, ends)
    for u, v in zip(got, want):
        if v is None:
            assert u is None
        else:
            assert torch.equal(u, v)
