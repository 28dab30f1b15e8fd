"""The frozen yardstick of the float chain's scan-lowering kernels:
``eq_f32.cu`` (the float cascades) and ``xf_f32.cu`` (the float
crossfeed), on ``roofline.py``'s constants (132 SMs at the 1980 MHz
maximum SM clock, 3.35 TB/s), never a clock read at run time.

Both kernels are bound by float32 issue or bytes: 128 float multiplies,
adds and subtracts a clock on each SM.  Their operation counts a
stream-sample are ``chip_smoke.py``'s pins, read from the functions
(``kernels/eq_f32.py``, ``kernels/xf_f32_cuda.py``), every multiply, add
and subtract counted once, since none may fuse:

* ``F32_BAND_OPS`` by band kind: SKIP 0, TDF2 9 (5 multiplies, 4 adds),
  an SVF's state 12 plus its output mix (low-pass 0, high-pass 3,
  peaking 2, shelf 5);
* ``F32_LOUD_OPS``: a loudness filter, a shelf's 17;
* ``F32_ENV_OPS``: the leveller envelope, 4 (3 multiplies, 1 add);
* ``XF_F32_OPS``: the crossfeed, 18.

Bytes: each input and output once, the envelope's packet ends, the state
in and out, the coefficients and scalars (per lane with per-lane
coefficients), as ``chip_smoke.py``'s ``_eqf_work`` counts them.

``band_kinds`` reads a configuration file's cascades as the port's static
chain lays them out (``chain/pack.py``, ``chain/pipeline.py``
``_chain_structure``) through the reference's own design, so the bounds
need nothing of the program.
"""

from __future__ import annotations

from .reference import config as ref_config
from .reference import constants as RC
from .reference import design, types
from .roofline import bound_s

F32_BAND_OPS = {0: 0, 1: 9, 2: 12, 3: 15, 4: 14, 5: 17}
F32_LOUD_OPS, F32_ENV_OPS, XF_F32_OPS = 17, 4, 18
# band kind tags (chain/pack.py): TDF2 and the SVF kinds (SKIP 0 costs
# nothing and is left out)
TDF2 = 1
_SVF_KIND = {types.FilterType.LOWPASS: 2, types.FilterType.HIGHPASS: 3,
             types.FilterType.PEAKING: 4, types.FilterType.LOWSHELF: 5,
             types.FilterType.HIGHSHELF: 5, types.FilterType.FLAT: 5}


def eq_f32_s(kinds, loud: bool, env: bool, T: int, B: int, npkt: int,
             lane: bool) -> float:
    """One float cascade call: a cascade for each row of ``kinds`` (its
    live bands' kinds; the call pads every cascade with SKIP rows to the
    longest), with the two loudness rows (``loud``) and the leveller
    envelope (``env``), over T samples of B lanes; ``lane``: per-lane
    coefficients and scalars."""
    G = len(kinds)
    nb = max(len(row) for row in kinds)
    per = sum((2 * F32_LOUD_OPS if loud else 0)
              + sum(F32_BAND_OPS[k] for k in row)
              + (F32_ENV_OPS if env else 0) for row in kinds)
    rows = nb + (2 if loud else 0)
    srows = 2 * rows + (1 if env else 0)
    coef = B if lane else 1
    nbytes = 4 * (2 * G * T * B + (G * npkt * B if env else 0)
                  + 2 * G * srows * B + G * rows * 11 * coef + G * 4 * coef)
    return bound_s({"fp32": per * T * B}, nbytes)


def xf_f32_s(T: int, B: int, n_coef: int = 3) -> float:
    """One float crossfeed call over T samples of B lanes: both channels
    in and out, the state in and out, the ``n_coef`` coefficients."""
    return bound_s({"fp32": XF_F32_OPS * T * B},
                   4 * (4 * T * B + 8 * B + n_coef))


def band_kinds(spec: dict) -> tuple:
    """(master, outputs): the live bands' kinds of each cascade of the
    scan lowering's two calls for the configuration file ``spec``: the
    master L and R channels, and each enabled output with a live band;
    SKIP bands and bypassed channels' bands left out."""
    cfg = ref_config.build(spec, types)
    d = design.derive(cfg)

    def live(ch):
        if d.channel_bypassed[ch]:
            return ()
        return tuple(TDF2 if not b.use_svf else _SVF_KIND[b.svf_type]
                     for b in d.eq[ch] if not b.bypass)

    outs = [live(RC.CH_OUT_1 + o) for o in range(cfg.num_outputs)
            if cfg.outputs[o].enabled]
    return [live(0), live(1)], [k for k in outs if k]


def segment_bounds(spec: dict, T: int, B: int, npkt: int,
                   lane: bool) -> dict:
    """{"eq_f32": both cascade calls, "xf_f32": the crossfeed call} of one
    segment of the configuration ``spec``, in seconds.  The crossfeed's
    coefficients are the same for every lane (a tenant rule leaves them
    as they are), so the call reads three."""
    dev = spec["device"]
    master, outs = band_kinds(spec)
    loud, env = dev["loudness"]["enabled"], dev["leveller"]["enabled"]
    eq = 0.0
    if loud or env or any(master):
        eq += eq_f32_s(master, loud, env, T, B, npkt, lane)
    if outs:
        eq += eq_f32_s(outs, False, False, T, B, npkt, lane)
    xf = xf_f32_s(T, B) if dev["crossfeed"]["enabled"] else 0.0
    return {"eq_f32": eq, "xf_f32": xf}
