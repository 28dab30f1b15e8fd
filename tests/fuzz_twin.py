"""The random-config fuzz twin of the port: ``tests/test_fuzz.py``'s
seeded random configs through the port's engines, the JAX package's
engines (from the same params and state) and the golden model.  Shared by
``tests/test_torch_fuzz_*.py``; every run is cached per seed, so a file
builds each seed's engines once.

Each seed's config and input come from one ``default_rng(seed)``, in
``tests/test_fuzz.py``'s order: ``random_config``, then the input (a
random aperiodic schedule's packet sizes before it).  24 packets of 48
samples: with the leveller's lookahead on, the golden model emits zeros
for the first 10-13 packets, so shorter runs compare silence.

F1, the block-matmul lowering's budget on random configs.  On the shipped
configs the lowering holds <= 1e-6 relative RMS against the golden model;
on random ones it does not, for one of two reasons, which ``F1_CLASS``
records a seed:

  (a) the block path's own rounding: its matrices are built and applied
      in float32.  The exact map of the firmware's coefficients (the same
      step functions on float64 state, applied in float64, ``exact_map``)
      meets 1e-6 there;
  (b) the firmware's own float32 recursion: even the exact map sits over
      1e-6 from the golden model, which rounds sample by sample.  Only a
      lowering that repeats that recursion meets 1e-6: the scan
      (``mxu=False``), which equals the golden model bit for bit.

Distances are relative RMS over every output of stream 0 against the
golden model (the F1 measurements' convention).  ``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/fuzz_twin.py [torch threads]`` prints each
seed's distances and the float64 build's reading (``_report``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import pytest
import torch

from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu_torch.chain import Engine, mxu

from test_fuzz import random_config
from test_torch_chain import _rel_rms
from test_torch_pack import _convert
from test_torch_q28 import _np
from util import make_input

B, NPKT, BLOCK = 2, 24, 48
SCHED_SEGMENTS = 3              # 3 x 9 random packets of 24-63 samples

# F1's class by seed: None where the block lowering meets 1e-6; and the
# stream-0 distances to the golden model measured on the CPU (24 packets):
# (the port's block path, the exact map)
F1_CLASS = {303: None, 1: "a", 2: "a", 4: "a", 6: "a", 21: "a", 202: "a",
            404: "a", 3: "b", 5: "b", 12: "b", 35: "b", 36: "b", 101: "b",
            505: "b"}
F1_MEASURED = {
    303: (8.84e-7, 5.86e-7), 1: (1.28e-6, 7.32e-7), 2: (1.11e-6, 7.46e-7),
    4: (1.08e-6, 8.10e-7), 6: (1.20e-6, 8.15e-7), 21: (1.24e-6, 7.74e-7),
    202: (2.01e-6, 9.95e-7), 404: (1.17e-6, 9.01e-7), 3: (2.77e-6, 1.37e-6),
    5: (2.30e-6, 1.98e-6), 12: (3.41e-6, 2.11e-6), 35: (6.76e-6, 5.01e-6),
    36: (2.46e-5, 1.86e-5), 101: (5.55e-5, 3.94e-5), 505: (3.51e-6, 2.70e-6)}
BUDGET = 1e-6
# the port's distance over the exact map's: measured 1.166 (seed 5) to
# 2.02 (seed 202)
EXACT_NEARER = 1.1
# the port's distance over the JAX block engine's: measured at most 1.452
# (seed 12)
JAX_RATIO = 1.5


def block_param(seed):
    """A seed of the block lowering's budget case: a strict xfail naming
    F1, its class and the measured distance, where the lowering breaks
    the budget."""
    cls = F1_CLASS[seed]
    if cls is None:
        return seed
    why = {"a": "the block path's float32 build and apply",
           "b": "the firmware's own float32 recursion: the exact map is "
                f"{F1_MEASURED[seed][1]:.2e} from the golden model"}[cls]
    return pytest.param(seed, marks=pytest.mark.xfail(
        strict=True, reason=f"F1 class ({cls}), {why}; the block path "
                            f"measured {F1_MEASURED[seed][0]:.2e} > 1e-6"))


# ----------------------------------------------------------------------------
# the golden model's outputs in the engine's layout
# ----------------------------------------------------------------------------


def golden_planes(per_stream, sched=None) -> dict:
    """[stream][packet] golden results -> the engine's emit='full'
    outputs out, s24 and pdm (uint32), time-flat with a schedule ([nout,
    Ttot, B]) or else [Npkt, nout, T, B]; and each packet's peaks,
    packet_peaks [Npkt, nch, B]."""
    def planes(key, axis):
        if sched:               # each stream's packets joined in time
            return np.stack([np.concatenate([np.asarray(p[key])
                                             for p in per], axis=axis)
                             for per in per_stream], axis=-1)
        return np.stack([np.stack([np.asarray(p[key]) for p in per])
                         for per in per_stream], axis=-1)

    sp = planes("spdif", 1)      # [(Npkt,) npair, T, 2, B]
    s24 = np.moveaxis(sp, -2, -3)
    s24 = s24.reshape(*s24.shape[:-4], -1, *s24.shape[-2:])
    pdm = np.stack([np.array([w for p in per for w in p["pdm_words"]],
                             np.uint32).reshape(-1, 8)
                    for per in per_stream], axis=-1)
    return {"out": planes("buf_out", -1), "s24": s24, "pdm": pdm,
            "packet_peaks": np.stack([np.array([p["peaks"] for p in per])
                                      for per in per_stream], axis=-1)}


def feed_golden(golds, x, sched=None) -> dict:
    """Feed each stream's golden device one segment: x [Npkt, 2, T, B], or
    [2, sum(sched), B] with a schedule."""
    per = []
    for s, g in enumerate(golds):
        if sched:
            offs = np.cumsum((0,) + tuple(sched))
            frames = [x[:, a:b, s].T for a, b in zip(offs[:-1], offs[1:])]
        else:
            frames = [x[k, :, :, s].T for k in range(x.shape[0])]
        per.append([g.process_packet(np.ascontiguousarray(f), bit_depth=16)
                    for f in frames])
    return golden_planes(per, sched)


# ----------------------------------------------------------------------------
# the Q28 chain: every word
# ----------------------------------------------------------------------------


class Q28Run(NamedTuple):
    segs: list          # per segment: (port, JAX, golden) output dicts
    clips: tuple        # clip flags: (port, JAX, golden)


@functools.lru_cache(maxsize=None)
def q28_run(seed: int, scheduled: bool) -> Q28Run:
    """A seed's RP2040 config through the port's Engine, the JAX engine
    and the golden model on both streams: 24 packets of 48 in one
    segment, or (``scheduled``) SCHED_SEGMENTS segments of a random
    aperiodic 9-packet schedule."""
    rng = np.random.default_rng(seed)
    cfg = random_config(rng, JPlatform.RP2040)
    kw, sched = {}, None
    if scheduled:
        sched = tuple(int(v) for v in rng.integers(24, 64, size=9))
        kw = dict(schedule=sched)
    je = JEngine(cfg, n_streams=B, emit="full", unroll=1, **kw)
    te = Engine(_convert(cfg), n_streams=B, emit="full", device="cpu", **kw)
    te.load_params_state(je.params, je.state)
    golds = [GoldenDevice(cfg.copy()) for _ in range(B)]
    segs = []
    for _ in range(SCHED_SEGMENTS if scheduled else 1):
        if scheduled:
            x = rng.integers(-16000, 16000,
                             size=(2, sum(sched), B)).astype(np.int32)
        else:
            x = make_input(rng, NPKT, BLOCK, B)
        to = {k: _np(v) for k, v in te.process(x).items()}
        if "pdm" in to:
            to["pdm"] = to["pdm"].view(np.uint32)
        jo = {k: np.asarray(v) for k, v in je.process(x).items()}
        segs.append((to, jo, feed_golden(golds, x, sched)))
    clips = (_np(te.state.clip_flags), np.asarray(je.state.clip_flags),
             np.array([g.clip_flags for g in golds]))
    return Q28Run(segs, clips)


def _q28_peaks_match(got, packet_peaks, clips) -> None:
    """A segment's Q28 peaks against the golden model's per packet.  Both
    are (max |x| >> 13) & 0xFFFF, the segment's over its packets'.  Where
    a channel never clipped (its sticky clip flag clear: every |x| <=
    2^28 + 268), no packet's value wrapped, so the segment's is the
    largest packet's; where it clipped, the segment's is still the value
    of its loudest packet, one of the packets'."""
    for ch in range(got.shape[0]):
        for s in range(got.shape[1]):
            pk = packet_peaks[:, ch, s]
            if clips[s] >> ch & 1:
                assert got[ch, s] in pk, (ch, s, got[ch, s], pk)
            else:
                assert got[ch, s] == pk.max(), (ch, s, got[ch, s], pk)


def check_q28(seed: int, scheduled: bool, against: str) -> None:
    """Every output word (out, s24, PDM, peaks) and the clip flags of the
    port equal to the JAX engine's, or to the golden model's (the peaks
    as ``_q28_peaks_match`` reads them from its packets')."""
    run = q28_run(seed, scheduled)
    side = {"golden": 2, "jax": 1}[against]
    for seg, (to, jo, go) in enumerate(run.segs):
        assert set(to) == set(jo) >= {"out", "s24", "peaks"}, sorted(to)
        want = jo if against == "jax" else go
        for k in to:
            if k == "peaks" and against == "golden":
                _q28_peaks_match(to[k], go["packet_peaks"], run.clips[2])
                continue
            assert to[k].shape == want[k].shape, (seg, k)
            np.testing.assert_array_equal(to[k], want[k],
                                          err_msg=f"segment {seg}: {k}")
    np.testing.assert_array_equal(run.clips[0], run.clips[side])
    # past the lookahead the golden model's S/PDIF words are not silence
    assert np.abs(run.segs[-1][2]["s24"]).max() > 0


# ----------------------------------------------------------------------------
# the float chain: the scan, the block lowering and its exact map
# ----------------------------------------------------------------------------


def _linearize64(step, T: int, n_in: int, S: int):
    """``mxu._linearize`` on float64 basis columns: the firmware's float32
    coefficients, float64 state and arithmetic."""
    Cc = n_in * T + S
    X = torch.zeros((T, n_in, Cc), dtype=torch.float64)
    for t in range(T):
        for i in range(n_in):
            X[t, i, i * T + t] = 1.0
    s = torch.zeros((S, Cc), dtype=torch.float64)
    for k in range(S):
        s[k, n_in * T + k] = 1.0
    ys = []
    for t in range(T):
        s, y = step(s, X[t, 0] if n_in == 1 else X[t])
        ys.append(y)
    return torch.stack(ys), s


_APPLY = mxu._apply_blocked


def _apply_blocked64(M, lay, x_pkts, s0, groups=None):
    """``mxu._apply_blocked`` in float64, its state carried in float64
    across the segment's packets; rounded once to float32 at the end."""
    s, y = _APPLY(M, lay, x_pkts.double(), s0.double(), groups)
    return s.float(), y.float()


@contextlib.contextmanager
def exact_map():
    """The block lowering with its matrices built and applied in float64
    (``_linearize64``, ``_apply_blocked64``): the exact LTI map of the
    firmware's own coefficients, rounded to float32 where each pass ends."""
    saved = mxu._linearize, mxu._apply_blocked
    mxu._linearize, mxu._apply_blocked = _linearize64, _apply_blocked64
    try:
        yield
    finally:
        mxu._linearize, mxu._apply_blocked = saved


_SPLIT = mxu._split


@contextlib.contextmanager
def float64_build():
    """F1 class (a)'s measured option: the block matrices built as the
    exact map builds them, rounded once to float32 and applied as the
    port applies them."""
    saved = mxu._linearize, mxu._split
    mxu._linearize = _linearize64
    mxu._split = lambda M, Ry, S, device: _SPLIT(M.float(), Ry, S, device)
    try:
        yield
    finally:
        mxu._linearize, mxu._split = saved


class FloatRun(NamedTuple):
    gold: np.ndarray    # golden 'out' [Npkt, nout, T, B]
    scan: np.ndarray    # the port's scan lowering
    block: np.ndarray   # the port's block lowering
    exact: np.ndarray   # the exact map
    jax: np.ndarray     # the JAX block engine


def _float_case(seed: int):
    """A seed's RP2350 config, input and JAX block engine (PDM off: its
    words are the Q28 chain's to hold), not yet run."""
    rng = np.random.default_rng(seed)
    cfg = random_config(rng, JPlatform.RP2350)
    x = make_input(rng, NPKT, BLOCK, B)
    return cfg, x, JEngine(cfg, n_streams=B, emit="full", pdm=False,
                           mxu=True, unroll=1)


def _port_out(cfg, je, x, mxu_on: bool) -> np.ndarray:
    """The port's 'out' on one lowering, from the JAX engine's params and
    state."""
    te = Engine(_convert(cfg), n_streams=B, emit="full", pdm=False,
                mxu=mxu_on, device="cpu")
    te.load_params_state(je.params, je.state)
    return _np(te.process(x)["out"])


@functools.lru_cache(maxsize=None)
def float_run(seed: int) -> FloatRun:
    """A seed's config through the port's scan and block lowerings and
    the exact map, each from the JAX block engine's params and state,
    then the JAX engine itself, and the golden model on both streams."""
    cfg, x, je = _float_case(seed)
    scan, block = _port_out(cfg, je, x, False), _port_out(cfg, je, x, True)
    with exact_map():
        exact = _port_out(cfg, je, x, True)
    gold = feed_golden([GoldenDevice(cfg.copy()) for _ in range(B)],
                       x)["out"]
    return FloatRun(gold, scan, block, exact,
                    np.asarray(je.process(x)["out"]))


def distance(out, gold) -> float:
    """Relative RMS over every output of stream 0."""
    return _rel_rms(out[..., 0], gold[..., 0])


def check_scan_equals_golden(seed: int) -> None:
    """The scan lowering repeats the firmware's recursion: every output
    sample of both streams equals the golden model's bit for bit."""
    r = float_run(seed)
    assert r.scan.shape == r.gold.shape
    np.testing.assert_array_equal(r.scan, r.gold)


def check_block_budget(seed: int) -> None:
    r = float_run(seed)
    assert distance(r.block, r.gold) <= BUDGET, distance(r.block, r.gold)


def check_exact_nearer(seed: int) -> None:
    """F1's cause: the exact map of the same coefficients sits nearer to
    the golden model than the float32 block path, by EXACT_NEARER."""
    r = float_run(seed)
    d_block, d_exact = distance(r.block, r.gold), distance(r.exact, r.gold)
    assert d_exact * EXACT_NEARER <= d_block, (d_exact, d_block)


def check_exact_class(seed: int) -> None:
    """F1's split: on class (b) seeds the exact map itself is over the
    budget (measured at least 1.37e-6, seed 3); elsewhere within it
    (measured at most 9.95e-7, seed 202)."""
    r = float_run(seed)
    d_exact = distance(r.exact, r.gold)
    if F1_CLASS[seed] == "b":
        assert d_exact > BUDGET, d_exact
    else:
        assert d_exact <= BUDGET, d_exact


def check_jax_ratio(seed: int) -> None:
    """The port's block path is no more than JAX_RATIO times as far from
    the golden model as the JAX package's block engine."""
    r = float_run(seed)
    d_block, d_jax = distance(r.block, r.gold), distance(r.jax, r.gold)
    assert d_block <= JAX_RATIO * d_jax, (d_block, d_jax)


FLOAT_CHECKS = {"scan_equals_golden": check_scan_equals_golden,
                "exact_map_nearer": check_exact_nearer,
                "exact_map_class": check_exact_class,
                "within_jax_engine": check_jax_ratio}


def _report(threads=None) -> None:
    """Each F1 seed's stream-0 distances to the golden model (ROADMAP.md
    section 3's table): the block path, the exact map, the float64 build,
    the JAX block engine and the scan; then the float64 build's carried
    ``eq_d`` against the JAX engine on tests/test_torch_chain.py's case,
    whose bound is 1e-6."""
    import test_torch_chain as tc

    if threads:
        torch.set_num_threads(int(threads))
    for seed, cls in F1_CLASS.items():
        r = float_run(seed)
        cfg, x, je = _float_case(seed)
        with float64_build():
            b64 = _port_out(cfg, je, x, True)
        print(f"seed {seed} ({cls or 'meets'}): " + ", ".join(
            f"{k} {distance(v, r.gold):.3e}" for k, v in (
                ("block", r.block), ("exact map", r.exact),
                ("float64 build", b64), ("JAX block", r.jax),
                ("scan", r.scan))), flush=True)
    with float64_build():
        je, te = tc._run(tc.SEED)[:2]
    print(f"float64 build: carried eq_d "
          f"{_rel_rms(_np(te.state.eq_d), np.asarray(je.state.eq_d)):.3e} "
          f"from the JAX engine (bound 1e-6)")


if __name__ == "__main__":
    import sys

    _report(*sys.argv[1:])
