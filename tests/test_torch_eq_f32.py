"""The float scan lowering's recurrences, plain versions: the port's float
cascades (``kernels/eq_f32.py``) and float crossfeed
(``kernels/xf_cuda.py:xf_f32_plain``) against the JAX package's own
step code (``chain/pipeline.py`` ``_band_step_f32``, ``_svf_general_f32``
and the envelope and crossfeed math of its scan A and ``xf_body``), run
eagerly op by op on the CPU, so that no operation contracts into a fused
multiply-add: held bit for bit.

Cases: every band kind alone and mixed across cascades (SKIP rows among
them); loudness bypass flags in every pair, per cascade and lane by lane;
the envelope at packet ends for uniform packets, the 44/45 cadence and a
schedule with a 1-sample packet, its 1e-30 flush firing; per-cascade and
per-lane coefficients.  The kernels themselves are held to these plain
versions on the card (``tests/test_torch_cuda.py``).  Last, the float
cascade wrapper's band-kinds signatures: packed and unpacked, and a call
split into one launch a signature, which run group by group through the
plain version and scattered back equals one plain call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dspi_tpu.chain import pack as jpack
from dspi_tpu.chain import pipeline as jp
from dspi_tpu_torch.kernels import eq_f32
from dspi_tpu_torch.kernels.eq_f32 import band_step_f32, svf_general_f32
from dspi_tpu_torch.kernels.eq_f32_cuda import f32_cascades
from dspi_tpu_torch.kernels.xf_cuda import xf_f32, xf_f32_plain

from test_torch_cuda import f32_args, f32_rows

KINDS = (jpack.TDF2, jpack.SVF_LP, jpack.SVF_HP, jpack.SVF_PEAK,
         jpack.SVF_SHELF)


def test_kind_tags_are_the_packs():
    assert (eq_f32.SKIP, eq_f32.TDF2, eq_f32.SVF_LP, eq_f32.SVF_HP,
            eq_f32.SVF_PEAK, eq_f32.SVF_SHELF) == (
        jpack.SKIP, jpack.TDF2, jpack.SVF_LP, jpack.SVF_HP, jpack.SVF_PEAK,
        jpack.SVF_SHELF)


@pytest.mark.parametrize("kind", KINDS)
def test_band_step_equals_jax(kind):
    """One step of each band kind over 64 streams, three chained samples,
    per-lane coefficient columns: bit for bit."""
    rng = np.random.default_rng(kind)
    cf = np.moveaxis(f32_rows(rng, (64,)), -1, 0)           # [11, B]
    s = rng.uniform(-0.5, 0.5, (2, 64)).astype(np.float32)
    js, ts = (jnp.asarray(s[0]), jnp.asarray(s[1])), tuple(
        torch.from_numpy(s[i]) for i in range(2))
    for _ in range(3):
        x = rng.uniform(-1, 1, 64).astype(np.float32)
        jo, js = jp._band_step_f32(kind, jnp.asarray(cf), js, jnp.asarray(x))
        to, ts = band_step_f32(kind, torch.from_numpy(cf), ts,
                               torch.from_numpy(x))
        for j, t in zip((jo, *js), (to, *ts)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("bypass", [False, True])
def test_loudness_step_equals_jax(bypass):
    rng = np.random.default_rng(5 + bypass)
    cf = f32_rows(rng, ())[:6]
    s = rng.uniform(-0.5, 0.5, (2, 16)).astype(np.float32)
    x = rng.uniform(-1, 1, 16).astype(np.float32)
    jo, js = jp._svf_general_f32(jnp.asarray(cf), tuple(map(jnp.asarray, s)),
                                 jnp.asarray(x), jnp.asarray(bypass))
    to, ts = svf_general_f32(torch.from_numpy(cf),
                             tuple(map(torch.from_numpy, s)),
                             torch.from_numpy(x), torch.tensor(bypass))
    for j, t in zip((jo, *js), (to, *ts)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    if bypass:
        np.testing.assert_array_equal(to.numpy(), x)


def _jax_cascades(x, cf, s0, scal, kinds, has_loud, has_env, ends):
    """The JAX package's scan A / scan B body, one cascade at a time, as
    its ``lax.scan`` runs it (``_svf_general_f32`` loudness rows with
    their bypass, ``_band_step_f32`` bands, SKIP bands left out, the
    envelope ``a*env + (1-a)*x*x`` flushed below 1e-30 on packet-end
    samples), eagerly: (y, env_ends, s_final) as NumPy arrays."""
    G, T, B = x.shape
    n_loud = 2 if has_loud else 0
    y = np.empty_like(x)
    env = np.empty((G, len(ends), B), np.float32)
    s_fin = np.empty_like(s0)
    for g in range(G):
        rows = [tuple(jnp.asarray(cf[g, r, k]) for k in range(11))
                for r in range(cf.shape[1])]
        s = [jnp.asarray(v) for v in s0[g]]
        byp = [jnp.asarray(scal[g, j] != 0) for j in range(n_loud)]
        a = jnp.asarray(scal[g, 2])
        for t in range(T):
            cur = jnp.asarray(x[g, t])
            for j in range(n_loud):
                cur, (s[2 * j], s[2 * j + 1]) = jp._svf_general_f32(
                    rows[j], (s[2 * j], s[2 * j + 1]), cur, byp[j])
            for j, kind in enumerate(kinds[g]):
                r = n_loud + j
                if kind != jpack.SKIP:
                    cur, (s[2 * r], s[2 * r + 1]) = jp._band_step_f32(
                        kind, rows[r], (s[2 * r], s[2 * r + 1]), cur)
            if has_env:
                e = a * s[-1] + (1.0 - a) * (cur * cur)
                if t in ends:
                    e = jnp.where(e < 1e-30, 0.0, e)
                    env[g, ends.index(t)] = np.asarray(e)
                s[-1] = e
            y[g, t] = np.asarray(cur)
        s_fin[g] = np.stack([np.broadcast_to(np.asarray(v), (B,))
                             for v in s]) if s else s_fin[g]
    return y, env, s_fin


# packets of TC samples where there is no schedule (the kernel takes any
# length; short ones keep the eager JAX reference quick)
TC = 16
CASES = {   # (has_loud, has_env, nb, G, mixed kinds, lane, sched)
    "master": (True, True, 10, 2, False, False, None),
    "master_lane": (True, True, 10, 2, False, True, None),
    "master_44k1": (True, True, 10, 2, False, False, (44, 45)),
    "mixed_lane_sched1": (True, True, 7, 3, True, True, (9, 1, 8)),
    "outputs_mixed": (False, False, 6, 3, True, False, None),
    "outputs_mixed_lane": (False, False, 6, 3, True, True, None),
    "env_only": (False, True, 0, 2, True, True, (44, 45, 44)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cascades_equal_jax_scan(name):
    """The plain cascades against the JAX scan's step code, bit for bit:
    outputs, envelopes at the packet ends and final states."""
    has_loud, has_env, nb, G, mixed, lane, sched = CASES[name]
    B = 8
    T = sum(sched) if sched else 2 * TC
    rng = np.random.default_rng(sum(map(ord, name)))
    args, kinds = f32_args(rng, G, T, B, nb, has_loud, has_env, lane, mixed)
    kw = dict(kinds=kinds, has_loud=has_loud, has_env=has_env, tc=TC,
              sched=sched)
    got = f32_cascades(*args, **kw)           # the CPU: the plain version
    ends = (list(np.cumsum(sched) - 1) if sched
            else list(range(TC - 1, T, TC)))
    want = _jax_cascades(*[a.numpy() for a in args], kinds, has_loud,
                         has_env, ends)
    np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg="y")
    np.testing.assert_array_equal(got[2].numpy(), want[2], err_msg="state")
    if has_env:
        np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg="env")
        # the flush fired on cascade 0's silent lanes (f32_args)
        assert (got[1][0, :, :4] == 0).all() and (got[1][1:] > 0).all()
    else:
        assert got[1] is None
    if has_loud:
        byp = args[3][:, :2].numpy()
        assert byp.min() == 0 and byp.max() == 1         # both kinds


def test_cascade_arguments_checked():
    rng = np.random.default_rng(1)
    (x, cf, s0, scal), kinds = f32_args(rng, 2, 96, 4, 3, True, True, False)
    kw = dict(kinds=kinds, has_loud=True, has_env=True, tc=48)
    with pytest.raises(TypeError, match="float32"):
        f32_cascades(x.double(), cf, s0, scal, **kw)
    with pytest.raises(ValueError, match="cf must be"):
        f32_cascades(x, cf[:, 1:], s0, scal, **kw)
    with pytest.raises(ValueError, match="kinds must be"):
        f32_cascades(x, cf, s0, scal, **{**kw, "kinds": kinds[:1]})
    with pytest.raises(ValueError, match="unknown band kind"):
        f32_cascades(x, cf, s0, scal,
                     **{**kw, "kinds": ((1, 9, 1), (1, 1, 1))})
    with pytest.raises(ValueError, match="whole packets"):
        f32_cascades(x, cf, s0, scal, **{**kw, "tc": 50})
    with pytest.raises(ValueError, match="sum to T"):
        f32_cascades(x, cf, s0, scal, **{**kw, "sched": (44, 45)})


def _jax_xf(l, r, coef, s4):
    """The JAX package's ``xf_body`` (chain/pipeline.py:597-609), eagerly."""
    lp_a0, lp_b1, ap_a = (jnp.asarray(c) for c in coef)
    lpL, lpR, apL, apR = (jnp.asarray(v) for v in s4)
    out_l, out_r = np.empty_like(l), np.empty_like(r)
    for t in range(l.shape[0]):
        ml, mr = jnp.asarray(l[t]), jnp.asarray(r[t])
        lp_l = lp_a0 * ml + lp_b1 * lpL
        lp_r = lp_a0 * mr + lp_b1 * lpR
        ap_l = ap_a * lp_l + apL
        apL_n = lp_l - ap_a * ap_l
        ap_r = ap_a * lp_r + apR
        apR_n = lp_r - ap_a * ap_r
        lpL, lpR, apL, apR = lp_l, lp_r, apL_n, apR_n
        out_l[t] = np.asarray((ml - lp_l) + ap_r)
        out_r[t] = np.asarray((mr - lp_r) + ap_l)
    return out_l, out_r, np.stack([np.asarray(v)
                                   for v in (lpL, lpR, apL, apR)])


@pytest.mark.parametrize("lane", [False, True])
def test_crossfeed_equals_jax_xf_body(lane):
    """The plain float crossfeed against ``xf_body``'s math, bit for bit,
    with [3] and per-lane [3, B] coefficients."""
    rng = np.random.default_rng(11 + lane)
    T, B = 60, 8
    l, r = (rng.uniform(-1, 1, (T, B)).astype(np.float32) for _ in range(2))
    shape = (B,) if lane else ()
    coef = np.stack([rng.uniform(0.01, 0.3, shape),
                     rng.uniform(0.6, 0.99, shape),
                     rng.uniform(-0.9, -0.1, shape)]).astype(np.float32)
    s4 = rng.uniform(-0.5, 0.5, (4, B)).astype(np.float32)
    got = xf_f32(*(torch.from_numpy(v) for v in (l, r, coef, s4)))
    want = _jax_xf(l, r, coef, s4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="xf_f32 wants"):
        xf_f32_plain(*(torch.from_numpy(v) for v in (l, r, coef[:2], s4)))


# (G, nb, has_loud, has_env, lane, sched, kinds): calls whose cascades
# carry several band-kinds signatures, as the wrapper splits them into one
# launch a signature
SPLITS = {
    "mixed": (4, 5, True, True, False, None,
              ((1, 4, 4, 5, 2), (3, 3, 1, 1, 1), (1, 4, 4, 5, 2),
               (5, 2, 3, 4, 1))),
    "skip_padding": (3, 4, False, True, False, None,
                     ((1, 1, 0, 0), (4, 5, 3, 1), (1, 1, 0, 0))),
    "nb0": (2, 0, True, True, False, None, ((), ())),
    "lane_sched": (3, 6, True, True, True, (9, 1, 8),
                   ((3, 4, 4, 5, 1, 0), (2, 2, 2, 2, 2, 2),
                    (3, 4, 4, 5, 1, 0))),
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_groups_scattered_back_equal_one_call(name):
    """The wrapper's split of a call into one launch a signature: each
    group run through the plain version on its own cascades and scattered
    back into place equals one plain call over all of them, bit for bit,
    and every cascade of a group has the group's signature."""
    from dspi_tpu_torch.kernels import eq_f32_cuda

    G, nb, has_loud, has_env, lane, sched, kinds = SPLITS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    T = sum(sched) if sched else 2 * TC
    args, _ = f32_args(rng, G, T, 8, nb, has_loud, has_env, lane)
    kw = dict(has_loud=has_loud, has_env=has_env, tc=TC, sched=sched)
    want = eq_f32.f32_cascades_plain(*args, kinds=kinds, **kw)
    plan = eq_f32_cuda.split(kinds, has_loud, has_env, lane)
    assert len(plan) == len(set(kinds))
    assert sorted(g for _, idx in plan for g in idx) == list(range(G))
    got = [torch.full_like(v, float("nan")) if v is not None else None
           for v in want]
    for sig, idx in plan:
        for g in idx:
            assert eq_f32_cuda.unpack_signature(sig) == (
                kinds[g], has_loud, has_env, lane)
        sel = torch.tensor(idx)
        part = eq_f32.f32_cascades_plain(
            *(v[sel] for v in args), kinds=[kinds[g] for g in idx], **kw)
        for out, p in zip(got, part):
            if out is not None:
                out[sel] = p
    for label, g, w in zip(("y", "env", "state"), got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                          err_msg=label)


@pytest.mark.parametrize("nb", range(13))
def test_signature_round_trips(nb):
    """Every kind at every band of an ``nb``-band cascade, under every
    flag, packs into a code that unpacks to the same; different kinds or
    flags give different codes."""
    from dspi_tpu_torch.kernels import eq_f32_cuda

    seen = set()
    for shift in range(6):
        kinds = tuple((shift + j) % 6 for j in range(nb))
        for flags in np.ndindex(2, 2, 2):
            flags = tuple(bool(f) for f in flags)
            sig = eq_f32_cuda.signature(kinds, *flags)
            assert 0 <= sig < 2**64
            assert eq_f32_cuda.unpack_signature(sig) == (kinds, *flags)
            seen.add(sig)
    assert len(seen) == (6 if nb else 1) * 8
    with pytest.raises(ValueError, match="no signature"):
        eq_f32_cuda.signature((6,) * max(nb, 1), False, False, False)
    if nb == 12:
        with pytest.raises(ValueError, match="no signature"):
            eq_f32_cuda.signature((1,) * 13, False, False, False)
