"""Inputs of the leveller's packet recurrence (``kernels.lev_cuda``) for
the CPU and the card tests: seeded gain-computer targets, alpha tables and
start gains, with edge values among them.  Imports neither JAX nor the JAX
package, so the card tests can use it on a host that has only PyTorch."""

from __future__ import annotations

import numpy as np

from dspi_tpu_torch.chain import packet_geometry

MIN_NORMAL = np.float32(1.1754944e-38)
# targets beside the gain computer's own range: zeros of both signs,
# denormals (flushed on entry by mul_det), the smallest normals, huge
# values and one far below the gate
EDGE_GC = np.array([0.0, -0.0, 1e-40, -1e-40, MIN_NORMAL, -MIN_NORMAL,
                    3.0e38, -3.0e38, 1e30, -65.0], np.float32)


def counts(npkt: int, rate: float) -> np.ndarray:
    """Each packet's length: 48 at 48 kHz, the 44/45 cadence at 44.1
    (cut to ``npkt``)."""
    sched = packet_geometry(rate, npkt)[1]
    return np.full(npkt, 48) if sched is None else np.asarray(sched[:npkt])


def case(npkt: int, B: int, lane: bool, rate: float, seed: int):
    """(gc [npkt, B], pow_att, pow_rel [npkt, 1] or with ``lane`` [npkt, B],
    gdb0 [B]), float32 numpy.  Targets in the gain computer's range, a
    quarter of them the gate's zeros, 5% edge values; 5% of the alphas are
    exactly 0, 1 or 0.5.  Fixed lanes (B >= 5): 0 all zeros from 0; 1 the
    target equal to the start gain; 2 denormal targets; 3 huge targets
    from a huge start; 4 a first packet whose two products cancel to a
    denormal sum (alpha 0.5 in row 0 of every table)."""
    rng = np.random.default_rng(seed)
    gc = rng.uniform(-24.0, 12.0, (npkt, B)).astype(np.float32)
    gc[rng.random((npkt, B)) < 0.25] = 0.0
    m = rng.random((npkt, B)) < 0.05
    gc[m] = rng.choice(EDGE_GC, int(m.sum()))
    gdb0 = rng.uniform(-20.0, 10.0, B).astype(np.float32)
    n = counts(npkt, rate).astype(np.float64)[:, None]
    cols = B if lane else 1
    tables = []
    for lo, hi in ((0.95, 0.9999), (0.99, 0.99999)):
        a = rng.uniform(lo, hi, cols)[None, :]
        t = (a ** n).astype(np.float32)
        m = rng.random(t.shape) < 0.05
        t[m] = rng.choice(np.array([0.0, 1.0, 0.5], np.float32),
                          int(m.sum()))
        t[0] = 0.5
        tables.append(t)
    if B >= 5:
        gc[:, 0], gdb0[0] = 0.0, 0.0
        gc[:, 1] = gdb0[1]
        gc[:, 2] = np.where(np.arange(npkt) % 2, 1e-40, -1e-40)
        gdb0[2] = 1e-40
        gc[:, 3] = np.where(np.arange(npkt) % 3, 3.0e38, -3.0e38)
        gdb0[3] = 3.3e38
        gdb0[4], gc[0, 4] = 2.4e-38, -2.38e-38
    return gc, tables[0], tables[1], gdb0


def denormal_first(gdbs: np.ndarray, lane: int = 4) -> bool:
    """Whether ``lane``'s first smoothed gain is the denormal sum that
    ``case`` (lane 4) or ``gain_edges`` (lane 0) sets up there."""
    v = np.float32(gdbs[0, lane])
    return bool(0 < abs(v) < MIN_NORMAL)


CEIL = np.float32(0.70795)          # LEVELLER_LIMITER_CEIL
RING = 480                          # LEVELLER_LOOKAHEAD_SAMPLES


def schedule(npkt: int, kind: str) -> np.ndarray:
    """Packet lengths: "uniform" 48 each, "ones" 1 each, "44k1" the 44/45
    cadence, "one" that cadence with every seventh packet (and the
    second) one sample long."""
    if kind == "uniform":
        return np.full(npkt, 48, np.int64)
    if kind == "ones":
        return np.ones(npkt, np.int64)
    sched = counts(npkt, 44100.0).astype(np.int64)
    if kind == "one":
        sched[1::7] = 1
    return sched


def _lev_rows(rng, B: int, lane: bool) -> np.ndarray:
    """The leveller's 11 parameter rows (pack.build_params' order), [11] or
    per lane [11, B]: thresholds, knees, gates, ratios, max gains and
    makeups spread over their ranges, the derived slope and 1/(2 knee) in
    float32 as pack computes them."""
    n = B if lane else 1
    f = np.float32
    ratio = rng.uniform(1.5, 20.0, n).astype(f)
    knee = rng.uniform(1.0, 12.0, n).astype(f)
    rows = np.stack([
        rng.uniform(0.999, 0.99995, n), rng.uniform(0.999, 0.9999, n),
        rng.uniform(0.99990, 0.999999, n), rng.uniform(-30.0, -10.0, n),
        knee, rng.uniform(-96.0, -50.0, n), ratio,
        rng.uniform(0.0, 35.0, n), rng.uniform(0.0, 9.0, n),
        f(1.0) - f(1.0) / ratio, f(1.0) / (f(2.0) * knee)]).astype(f)
    return rows if lane else rows[:, 0]


def phase_case(q28: bool, npkt: int, B: int, kind: str, lane: bool,
               seed: int) -> dict:
    """Inputs of the leveller's block phase (``lev_gain``, ``lev_apply``),
    numpy: env_l, env_r [npkt, B] (float32, or Q28 int32 with ``q28``),
    lev float32 [11] or [11, B], gdb0 float32 [B], g0 [B], bl, br [Ttot,
    B], ring [2, 480, B], sched int64 [npkt].  Envelopes span the gate,
    the knee and the threshold, with zeros and denormals (float) or the
    smallest words (Q28) among them; start gains up to +20 dB (lane 0 at
    +18), so the ramp runs above unity; samples up to twice the limiter's ceiling, with
    some exactly at it, zeros and denormals."""
    rng = np.random.default_rng(seed)
    sched = schedule(npkt, kind)
    ttot = int(sched.sum())
    db = rng.uniform(-110.0, 6.0, (2, npkt, B))
    knee = rng.random(db.shape) < 0.2
    db[knee] = rng.uniform(-36.0, -4.0, int(knee.sum()))
    env = (10.0 ** (db / 10.0)).astype(np.float32)
    edge = rng.random(env.shape)
    env[edge < 0.04] = 0.0
    env[(edge >= 0.04) & (edge < 0.06)] = np.float32(1e-40)
    if q28:
        env = np.clip(np.round(env.astype(np.float64) * 2.0 ** 28), 0,
                      2**31 - 1).astype(np.int32)
        env[(edge >= 0.06) & (edge < 0.08)] = 1
    gdb0 = rng.uniform(-6.0, 20.0, B).astype(np.float32)
    gdb0[0] = 18.0                  # lane 0 starts well above unity
    g0 = (10.0 ** (rng.uniform(-6.0, 20.0, B) / 20.0)).astype(np.float32)
    x = rng.uniform(-2.0, 2.0, (3, max(ttot, RING), B)).astype(np.float32)
    pick = rng.random(x.shape)
    x[pick < 0.05] = CEIL
    x[(pick >= 0.05) & (pick < 0.1)] = -CEIL
    x[(pick >= 0.1) & (pick < 0.13)] = 0.0
    x[(pick >= 0.13) & (pick < 0.15)] = np.float32(1e-40)
    if q28:
        g0 = np.clip(np.round(g0.astype(np.float64) * 2.0 ** 28), 0,
                     2**31 - 1).astype(np.int32)
        x = np.round(x.astype(np.float64) * 2.0 ** 28).astype(np.int32)
    return {"env_l": env[0], "env_r": env[1], "lev": _lev_rows(rng, B, lane),
            "gdb0": gdb0, "g0": g0, "bl": x[0, :ttot], "br": x[1, :ttot],
            "ring": np.stack([x[2, :RING], x[2, :RING][::-1]]).copy(),
            "sched": sched}


# start gains (dB) beside the recurrence's range: zeros, denormals, the
# smallest normal, huge values of both signs and the first summand of
# the cancelling lane
EDGE_GDB0 = np.array([0.0, 1e-40, -1e-40, MIN_NORMAL, 3.3e38, -3.3e38,
                      2.4e-38], np.float32)
# attack and release alphas that make alpha^n exact: 0, 1 and (on
# one-sample packets) 0.5
EDGE_ALPHAS = ((0.0, 0.0), (1.0, 1.0), (0.5, 0.5), (0.5, 1.0), (1.0, 0.0))


def gain_edges(q28: bool, npkt: int, kind: str, seed: int) -> dict:
    """Inputs of ``lev_gain`` (``phase_case``'s keys but the planes and the
    ring) that put ``case``'s edges through the gain computer: one lane a
    combination of target (``EDGE_GC``), alpha pair (``EDGE_ALPHAS``) and
    start gain (``EDGE_GDB0``), 351 lanes, per-lane parameters.  With a
    ratio of 1 the slope is 0, so an ungated packet's target is
    min(makeup, max_gain) = the lane's edge target and a gated one's 0;
    the envelopes gate about a third of the packets.  Lane 0 cancels: from
    2.4e-38 towards -2.38e-38 with alpha 0.5, its first sum is denormal
    when the first packet is one sample long ("ones")."""
    rng = np.random.default_rng(seed)
    combos = [(t, a, g) for t in EDGE_GC for a in EDGE_ALPHAS
              for g in EDGE_GDB0]
    combos.insert(0, (np.float32(-2.38e-38), (0.5, 0.5),
                      np.float32(2.4e-38)))
    B = len(combos)
    f = np.float32
    target = np.array([c[0] for c in combos], f)
    alphas = np.array([c[1] for c in combos], f)
    knee = np.full(B, 6.0, f)
    ratio = np.ones(B, f)
    lev = np.stack([
        np.full(B, 0.9995, f), alphas[:, 0], alphas[:, 1],
        np.full(B, -20.0, f), knee, np.full(B, -70.0, f), ratio,
        target, np.full(B, 3.4e38, f), f(1.0) - f(1.0) / ratio,
        f(1.0) / (f(2.0) * knee)]).astype(f)
    db = rng.uniform(-110.0, 6.0, (2, npkt, B))
    env = (10.0 ** (db / 10.0)).astype(np.float32)
    env[rng.random(env.shape) < 0.05] = 0.0
    env[:, 0, 0] = 1.0                      # lane 0's first packet: 0 dB
    if q28:
        env = np.clip(np.round(env.astype(np.float64) * 2.0 ** 28), 0,
                      2**31 - 1).astype(np.int32)
    g0 = (10.0 ** (rng.uniform(-6.0, 20.0, B) / 20.0)).astype(np.float32)
    if q28:
        g0 = np.clip(np.round(g0.astype(np.float64) * 2.0 ** 28), 0,
                     2**31 - 1).astype(np.int32)
    return {"env_l": env[0], "env_r": env[1], "lev": lev,
            "gdb0": np.array([c[2] for c in combos], f), "g0": g0,
            "sched": schedule(npkt, kind)}


def exp2_domain(c: dict) -> np.ndarray:
    """bool [B]: the lanes of ``gain_edges``' inputs whose smoothed gain
    stays where ``fmath.exp2_f32`` is defined (|gdb / 20 * log2(10)| <
    126): a target and a start gain within 700 dB, since each packet's
    gain lies between the last one and the target.  Beyond it the
    linear gain rests on the platform's float -> int conversion of an
    out-of-range value (x86 gives INT_MIN, the card saturates), on the
    reference as on the kernel."""
    lim = np.float32(700.0)
    return (np.abs(c["lev"][7]) <= lim) & (np.abs(c["gdb0"]) <= lim)
