"""The comparison that decides ``correct``.

A check is a few sampled streams over one or more segments of the timed
path: what the program reported for them (its reduced outputs and its
state at those lanes) beside what the reference (``reference.lanes``)
computed for the same streams from the same inputs.  The numbers:

Q28 chains (exact integer arithmetic, limit 0):

* ``mismatch``: the output words (s24 sums, PDM word sums, peaks) and
  state words (every leaf) that differ.

Float chains (the program's block lowering rounds in another order than
the firmware's sequential float32; see ``PERF.md`` for the readings the
limits were set from):

* ``state_gap``: the worst signal-carrying state leaf (filter states,
  leveller envelope, gains and lookahead ring, crossfeed, delay rings):
  the RMS of the difference over the sampled lanes, over the larger of
  that leaf's RMS and the median leaf's in the reference.
* ``s24_gap``: the worst |difference| of a channel's s24 sum over the sum
  of its absolute s24 words, over segments, lanes and channels.
* ``exact_mismatch``: the words that no rounding can move and that differ:
  the PDM modulator's PRNG, fade, enable, run and fade-out counters, and
  the clip flags.

The float chain's PDM words are not compared: one differing modulator
input changes every word after it.  The Q28 cells judge the same kernel
word for word.
"""

from __future__ import annotations

import numpy as np

FLOAT_LEAVES = ("loud_a", "loud_b", "eq_a", "eq_b", "eq_c", "eq_d", "lev_env",
                "lev_gain_db", "lev_gain", "lev_gain_prev", "lev_la", "xf_lp",
                "xf_ap", "delay")
EXACT_LEAVES = ("pdm_rng", "pdm_fade", "pdm_ena", "pdm_run", "pdm_fout",
                "clip_flags")
OUT_KEYS = ("s24_sum", "pdm_sum", "peaks")


def _lanes_last(ref_list, pick):
    """Stack one leaf of each lane's reference result on a trailing lane
    axis, as the program's leaves are."""
    return np.stack([np.asarray(pick(r)) for r in ref_list], axis=-1)


def _wrap32(v) -> np.ndarray:
    v = np.asarray(v, np.int64) & 0xFFFFFFFF
    return np.where(v >= 2**31, v - 2**32, v)


def q28_numbers(checks) -> dict:
    bad = 0
    for ck in checks:
        ref, prog = ck["ref"], ck["prog"]
        for j, pout in enumerate(prog["outs"]):
            for k in OUT_KEYS:
                want = _lanes_last(ref, lambda r: r["outs"][j][k])
                got = np.asarray(pout[k])
                bad += int(np.count_nonzero(
                    _wrap32(got) != _wrap32(want)))
        for leaf, pv in prog["state"].items():
            want = _lanes_last(ref, lambda r: r["state"][leaf])
            got = np.asarray(pv)
            if leaf == "lev_gain_db":
                bad += int(np.count_nonzero(got.view(np.int32)
                                            != want.astype(np.float32)
                                            .view(np.int32)))
            else:
                bad += int(np.count_nonzero(_wrap32(got) != _wrap32(want)))
    return {"mismatch": float(bad)}


def float_numbers(checks, detail: dict | None = None) -> dict:
    """``detail`` collects each leaf's worst gap, for the run's log."""
    state_gap, s24_gap, exact = 0.0, 0.0, 0
    for ck in checks:
        ref, prog = ck["ref"], ck["prog"]
        for j, pout in enumerate(prog["outs"]):
            want = _lanes_last(ref, lambda r: r["outs"][j]["s24_sum"])
            scale = _lanes_last(ref, lambda r: r["outs"][j]["s24_abs"])
            diff = np.abs(_wrap32(np.asarray(pout["s24_sum"], np.int64)
                                  - want))
            s24_gap = max(s24_gap, float((diff / np.maximum(scale, 1)).max()))
        rms, gaps = {}, {}
        for leaf in FLOAT_LEAVES:
            if leaf not in prog["state"]:
                continue
            want = _lanes_last(ref, lambda r: r["state"][leaf]).astype(
                np.float64)
            got = np.asarray(prog["state"][leaf], np.float64)
            rms[leaf] = float(np.sqrt(np.mean(want ** 2)))
            g = float(np.sqrt(np.mean((got - want) ** 2)))
            gaps[leaf] = g if np.isfinite(g) else float("inf")
        med = float(np.median(list(rms.values())))
        for leaf, g in gaps.items():
            rel = g / max(rms[leaf], med, 1e-30)
            state_gap = max(state_gap, rel)
            if detail is not None:
                detail[leaf] = max(detail.get(leaf, 0.0), rel)
        for leaf in EXACT_LEAVES:
            want = _lanes_last(ref, lambda r: r["state"][leaf])
            got = np.asarray(prog["state"][leaf])
            exact += int(np.count_nonzero(_wrap32(got) != _wrap32(want)))
    return {"state_gap": state_gap, "s24_gap": s24_gap,
            "exact_mismatch": float(exact)}


def numbers(is_float: bool, checks, detail: dict | None = None) -> dict:
    return (float_numbers(checks, detail) if is_float
            else q28_numbers(checks))


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number at or under its limit, {name: {value, limit}})."""
    missing = sorted(set(nums) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    table = {k: {"value": v, "limit": float(limits[k])}
             for k, v in nums.items()}
    return all(v <= float(limits[k]) for k, v in nums.items()), table
