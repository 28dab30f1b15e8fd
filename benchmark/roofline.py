"""The frozen yardstick: operation and byte counts of the port's kernels and
the least time one NVIDIA H100 SXM could take for them.

A kernel's bound is the longest of: the multiplies of two run-time values
its function needs over 64 a clock, the ALU-only instructions of its
sample loop over 64, all its per-thread arithmetic instructions there over
128 (4 schedulers, one 32-thread instruction each), float32 operations
over 128 (CUDA C Programming Guide, throughput table, compute capability
9.0), each in SM clocks of all 132 SMs at the card's 1980 MHz maximum SM
clock; or its bytes, each read once and written once, at 3.35 TB/s (the
H100 SXM data sheet), whichever is longer.  The clock and the SM count
are constants, so that a bound measures the same work whatever
implements it and whatever clock a card runs at.

The instruction counts a stream-sample are pinned: a redesign of a kernel
is measured against the work of the design it replaced.

* ``PDM_OPS``, ``XF_OPS``: the SASS of commit f15a17e's ``pdm.cu`` and
  ``xf_q28.cu`` sample loops (``chip_smoke.py``'s pins, nvcc for sm_90a).
* ``EQ_LANE_OPS``: commit 84fe37b's ``eq_q28.cu`` per-lane instances,
  keyed by (bands, loudness, envelope) (``chip_smoke.py``'s pins).
* ``EQ_SCALAR_OPS``: the scalar-mode instances of ``eq_q28.cu`` as built
  at commit cb1d0d9 (the two the main path launches), read from that
  build's SASS with ``kernels.build.per_sample`` (one ``ldg`` a sample)
  on an H100; ``chip_smoke.py`` read these from the build being
  measured.
* ``MUL_PER_BAND``, ``MUL_PER_ENV``, ``MUL_XF``, ``MUL_PDM``: multiplies a
  sample from the functions: ``fast_mul_q28`` is three 16 x 16 partial
  products, five a band and three the envelope; the crossfeed eight; the
  PDM modulator's multiplies on its enabled path are by constants.
"""

from __future__ import annotations

SM_CLOCK_HZ = 1.98e9               # H100 SXM maximum SM clock
SMS = 132
HBM_BYTES_PER_S = 3.35e12
PIPE_OPS_PER_SM_CLOCK = 64
ISSUE_PER_SM_CLOCK = 128
FP32_PER_SM_CLOCK = 128

MUL_PER_BAND, MUL_PER_ENV, MUL_XF, MUL_PDM = 15, 9, 24, 0
PDM_OPS = {"alu_only": 851.0, "arith": 1744.0}
XF_OPS = {"alu_only": 25.5, "arith": 74.5}
EQ_LANE_OPS = {(10, True, True): {"alu_only": 109.0, "arith": 361.0},
               (10, False, False): {"alu_only": 74.0, "arith": 270.0}}
EQ_SCALAR_OPS = {(10, True, True): {"alu_only": 103.0, "arith": 360.0},
                 (10, False, False): {"alu_only": 74.0, "arith": 271.0}}

_RATES = {"mul": PIPE_OPS_PER_SM_CLOCK, "alu_only": PIPE_OPS_PER_SM_CLOCK,
          "arith": ISSUE_PER_SM_CLOCK, "fp32": FP32_PER_SM_CLOCK}


def sm_clocks_per_s() -> float:
    return SMS * SM_CLOCK_HZ


def work(per_sample: dict, mul: int, n: int) -> dict:
    """Operation counts over ``n`` sample-threads."""
    return {"mul": mul * n, **{k: v * n for k, v in per_sample.items()}}


def bound_s(ops: dict, nbytes: float) -> float:
    """The least time for ``ops`` (by kind, see ``_RATES``) and ``nbytes``:
    the longest operation term or the bytes' time, in seconds."""
    t_ops = max(v / _RATES[k] for k, v in ops.items()) / sm_clocks_per_s()
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def pdm_s(T: int, B: int) -> float:
    """One PDM call over T samples of B streams: the input and the words
    once, the state in and out."""
    return bound_s(work(PDM_OPS, MUL_PDM, T * B),
                   4 * T * B + 32 * T * B + 2 * 64 * B)


def cascade_s(G: int, nb: int, loud: bool, env: bool, T: int, B: int,
              npkt: int, lane: bool) -> float:
    """One Q28 cascade call: G cascades of ``nb`` bands (plus the two
    loudness rows, plus the leveller envelope) over T samples of B lanes;
    ``lane``: per-lane coefficients (the ``lane_cf`` mode).  Bytes: the
    input and output once, the envelope's packet ends, the state in and
    out, the coefficients and scalars (per lane in ``lane_cf``)."""
    rows = nb + (2 if loud else 0)
    ops = (EQ_LANE_OPS if lane else EQ_SCALAR_OPS)[(nb, loud, env)]
    mul = MUL_PER_BAND * rows + (MUL_PER_ENV if env else 0)
    per = B if lane else 1
    nbytes = 4 * (2 * G * T * B + (G * npkt * B if env else 0)
                  + 2 * G * rows * 2 * B + G * rows * 5 * per + G * 4 * per)
    return bound_s(work(ops, mul, G * T * B), nbytes)


def xf_s(T: int, B: int, n_coef: int = 3) -> float:
    """One Q28 crossfeed call over T samples of B streams."""
    return bound_s(work(XF_OPS, MUL_XF, T * B),
                   4 * (4 * T * B + 8 * B + n_coef))
