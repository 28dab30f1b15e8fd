"""The reference over a few streams: the golden model, one instance a lane.

``run_lane`` drives one ``GoldenDevice`` (this package's frozen copy of the
firmware twin) through chained segments of one stream and returns, for
each segment, what the program's ``emit="reduced"`` segment reports for
that stream (the s24 sums of the S/PDIF channels, the peaks, the PDM word
sum) and, after the last, the stream's state in the program's layout, so
the two can be compared leaf by leaf.  ``state_to_golden`` goes the other
way: it sets a golden instance from one lane of the program's state, for a
check that follows the program from its own state (see ``PERF.md``).

Everything here is NumPy and CPU PyTorch on the reference's own modules;
nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np

from . import config as _config
from . import constants as C
from . import types as T
from .design import derive
from .model import GoldenDevice

M32 = 0xFFFFFFFF


def device_for(spec: dict, tenant: dict | None = None) -> GoldenDevice:
    cfg = _config.build(spec, T, tenant)
    return GoldenDevice(cfg, derive(cfg), pdm_fade=False)


def ring_geometry(dev: GoldenDevice, block: int):
    """(delayed outputs, ring length) of the program's time-ordered delay
    rings for this configuration: every output whose delay is above 0, a
    power of two that holds the longest delay and one block more."""
    plat_mask = C.MAX_DELAY_SAMPLES[dev.cfg.platform] - 1
    delayed, longest = [], 0
    for o in range(dev.cfg.num_outputs):
        eff = int(dev.d.gains.delay_samples[o]) & plat_mask
        if eff > 0:
            delayed.append(o)
            longest = max(longest, eff)
    ring = 1
    while ring < longest + block + 1:
        ring *= 2
    return delayed, (ring if delayed else 0)


def _i32(v) -> np.ndarray:
    return np.asarray(v, np.int64).astype(np.uint32).view(np.int32)


def golden_state(dev: GoldenDevice, block: int) -> dict:
    """The golden instance's state in the program's layout (one lane)."""
    fl = dev.is_float
    f = np.float32 if fl else np.int32
    la = np.asarray(dev.lev_la_buf, f)
    n = la.shape[1]
    la = la[:, (dev.lev_la_idx + np.arange(n)) % n]
    delayed, ring = ring_geometry(dev, block)
    mask = C.MAX_DELAY_SAMPLES[dev.cfg.platform] - 1
    w = dev.delay_write_idx
    lines = np.asarray(dev.delay_lines, f)
    idx = (w - ring + np.arange(ring)) & mask
    ns = dev.pdm_ns
    st = {
        "loud_a": np.asarray(dev.loud_ic1 if fl else dev.loud_s1, f),
        "loud_b": np.asarray(dev.loud_ic2 if fl else dev.loud_s2, f),
        "eq_a": np.asarray(dev.eq_s1, f), "eq_b": np.asarray(dev.eq_s2, f),
        "lev_env": np.asarray(dev.lev_env, f),
        "lev_gain_db": np.float32(dev.lev_gain_smooth_db),
        "lev_gain": (np.float32(dev.lev_gain_linear) if fl
                     else np.int32(dev.lev_gain_q28)),
        "lev_gain_prev": (np.float32(dev.lev_gain_prev_linear) if fl
                          else np.int32(dev.lev_gain_prev_q28)),
        "lev_la": la,
        "xf_lp": np.asarray(dev.xf_lp, f), "xf_ap": np.asarray(dev.xf_ap, f),
        "delay": np.stack([lines[o][idx] for o in delayed]) if ring else None,
        "pdm_err": _i32(dev.pdm_err), "pdm_err2": _i32(dev.pdm_err2),
        "pdm_ns": _i32([ns["x1"], ns["x2"], ns["y1"], ns["y2"],
                        ns["err_acc"]]),
        "pdm_rng": _i32(dev.pdm_rng), "pdm_fade": _i32(dev.pdm_fade_pos),
        "pdm_ena": _i32(int(dev.pdm_ena)), "pdm_run": _i32(int(dev.pdm_run)),
        "pdm_fout": _i32(dev.pdm_fout_pos), "pdm_base": _i32(dev.pdm_base),
        "clip_flags": _i32(dev.clip_flags),
    }
    if fl:
        st["eq_c"] = np.asarray(dev.eq_ic1, f)
        st["eq_d"] = np.asarray(dev.eq_ic2, f)
    return st


def state_to_golden(dev: GoldenDevice, st: dict, block: int) -> None:
    """Set the golden instance from one lane of the program's state (NumPy
    leaves without the lane axis), the inverse of ``golden_state``: the
    rings start at index 0, so they are stored oldest first."""
    fl = dev.is_float

    def grid(v):
        return (np.array(v, np.float32) if fl
                else [[int(e) for e in row] for row in np.asarray(v)])

    def vec(v):
        return (np.array(v, np.float32) if fl
                else [int(e) for e in np.asarray(v)])

    if fl:
        dev.loud_ic1, dev.loud_ic2 = grid(st["loud_a"]), grid(st["loud_b"])
        dev.eq_ic1, dev.eq_ic2 = grid(st["eq_c"]), grid(st["eq_d"])
        dev.lev_gain_linear = np.float32(st["lev_gain"])
        dev.lev_gain_prev_linear = np.float32(st["lev_gain_prev"])
    else:
        dev.loud_s1, dev.loud_s2 = grid(st["loud_a"]), grid(st["loud_b"])
        dev.lev_gain_q28 = int(st["lev_gain"])
        dev.lev_gain_prev_q28 = int(st["lev_gain_prev"])
    dev.eq_s1, dev.eq_s2 = grid(st["eq_a"]), grid(st["eq_b"])
    dev.lev_env = vec(st["lev_env"])
    dev.lev_gain_smooth_db = np.float32(st["lev_gain_db"])
    dev.lev_la_buf = grid(st["lev_la"])
    dev.lev_la_idx = 0
    dev.xf_lp, dev.xf_ap = vec(st["xf_lp"]), vec(st["xf_ap"])
    delayed, ring = ring_geometry(dev, block)
    if ring:
        size = C.MAX_DELAY_SAMPLES[dev.cfg.platform]
        lines = np.zeros((dev.cfg.num_outputs, size),
                         np.float32 if fl else np.int64)
        for k, o in enumerate(delayed):
            lines[o, size - ring:] = np.asarray(st["delay"][k])
        dev.delay_lines = lines if fl else [[int(e) for e in row]
                                            for row in lines]
        dev.delay_write_idx = 0
    u = lambda k: int(np.asarray(st[k]).astype(np.int64))  # noqa: E731
    dev.pdm_err, dev.pdm_err2 = u("pdm_err"), u("pdm_err2")
    ns = [int(e) for e in np.asarray(st["pdm_ns"], np.int64)]
    dev.pdm_ns = dict(x1=ns[0], x2=ns[1], y1=ns[2], y2=ns[3], err_acc=ns[4])
    dev.pdm_rng = u("pdm_rng") & M32
    dev.pdm_fade_pos = u("pdm_fade")
    dev.pdm_ena, dev.pdm_run = bool(u("pdm_ena")), bool(u("pdm_run"))
    dev.pdm_fout_pos, dev.pdm_base = u("pdm_fout"), u("pdm_base")
    dev.clip_flags = u("clip_flags")


def run_segment(dev: GoldenDevice, x: np.ndarray) -> dict:
    """One segment of one stream: x int [n_packets, 2, block] -> what the
    program's reduced segment reports for the stream, plus the sum of the
    absolute s24 words a channel (the scale of the s24 comparison)."""
    npairs = C.NUM_SPDIF_INSTANCES[dev.cfg.platform]
    s24 = np.zeros(2 * npairs, np.int64)
    s24_abs = np.zeros(2 * npairs, np.int64)
    pdm = 0
    peaks = None
    for p in range(x.shape[0]):
        o = dev.process_packet(np.asarray(x[p]).T)
        sp = np.asarray(o["spdif"], np.int64)              # [npairs, T, 2]
        s24 += sp.sum(axis=1).reshape(-1)
        s24_abs += np.abs(sp).sum(axis=1).reshape(-1)
        pdm += sum(o["pdm_words"])
        pk = np.asarray(o["peaks"], np.int64)
        peaks = pk if peaks is None else np.maximum(peaks, pk)
    return {"s24_sum": _i32(s24 & M32), "s24_abs": s24_abs,
            "pdm_sum": np.int64(pdm & M32), "peaks": _i32(peaks)}


def run_lane(task: dict) -> dict:
    """A check of one stream: the golden instance for the stream's
    configuration (``spec``, ``tenant``), started from the configuration's
    initial state or from the program's (``state``), through the segments
    ``xs`` (int [n_segments, n_packets, 2, block]).  Returns
    {"outs": [per segment], "state": the end state}; ``quantize`` (bits)
    runs the control: the Q28 coefficients with their lowest bits
    cleared."""
    dev = device_for(task["spec"], task.get("tenant"))
    block = int(task["block"])
    if task.get("quantize"):
        _quantize(dev, int(task["quantize"]))
    if task.get("state") is not None:
        state_to_golden(dev, task["state"], block)
    outs = [run_segment(dev, xs) for xs in task["xs"]]
    return {"outs": outs, "state": golden_state(dev, block)}


def _quantize(dev: GoldenDevice, bits: int) -> None:
    """The control's lower precision: every Q28 biquad coefficient of the
    EQ cascades with its ``bits`` lowest bits cleared (Q28 -> Q(28-bits))."""
    keep = ~((1 << bits) - 1)
    for bands in dev.d.eq:
        for bq in bands:
            for k in ("qb0", "qb1", "qb2", "qa1", "qa2"):
                setattr(bq, k, int(getattr(bq, k)) & keep)
