"""Packing: DerivedParams -> (StaticChain, ChainParams, ChainState).

A copy of the JAX package's ``chain/pack.py`` builders for the PyTorch
port.  The pipeline splits the firmware's state into three tiers:

  * ``StaticChain``   — structure that is baked into the compiled program
                        (which bands exist, SVF vs TDF2 per band, which
                        outputs are enabled, block geometry).  Mirrors the
                        firmware's branch structure in process_audio_packet.
  * ``ChainParams``   — device arrays of coefficients/gains that can change
                        without recompiling (filter coefficients, volumes,
                        delay amounts, loudness table row).
  * ``ChainState``    — per-stream runtime state with trailing [B] stream
                        axis (filter memories, envelopes, delay rings, the
                        delta-sigma modulator state).

Data layout is time-major [T, B]: the stream axis is the fast axis, so one
recurrence step is one wide op (or one thread per stream) across streams.

The builders return NumPy trees, exactly as the JAX package's do, so the
two packages can be held array for array.  ``to_device`` turns them into
torch tensors; ``from_numpy`` does the same for trees that came from the
JAX package (its ``build_params``/``init_state``, or ``np.asarray`` of an
engine's), and ``to_numpy`` is the inverse.  ``pdm_rng`` is uint32 in the
NumPy trees and carried as int32 bits in torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Any

import numpy as np
import torch

from ..core import constants as C
from ..core.constants import FilterType, Platform
from ..params.design import DerivedParams

F = np.float32


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# band kind tags (static)
SKIP = 0
TDF2 = 1
SVF_LP = 2
SVF_HP = 3
SVF_PEAK = 4
SVF_SHELF = 5

_SVF_KIND = {
    FilterType.LOWPASS: SVF_LP,
    FilterType.HIGHPASS: SVF_HP,
    FilterType.PEAKING: SVF_PEAK,
    FilterType.LOWSHELF: SVF_SHELF,
    FilterType.HIGHSHELF: SVF_SHELF,
    FilterType.FLAT: SVF_SHELF,
}


@dataclass(frozen=True)
class StaticChain:
    platform: str                      # "rp2350" | "rp2040"
    block_size: int                    # samples per emulated USB packet
    n_channels: int
    n_outputs: int
    n_spdif: int
    bit_depth: int                     # 16 | 24
    band_kinds: tuple                  # [ch][band] -> kind tag
    channel_bypassed: tuple
    bypass_master_eq: bool
    loudness_on: bool
    leveller_on: bool
    leveller_lookahead: bool
    crossfeed_on: bool
    output_enabled: tuple
    output_mute: tuple
    delayed_outputs: tuple             # indices of outputs with delay > 0
    delay_ring: int                    # ring length (0 = no delays)
    pdm_on: bool                       # modulate the sub output
    emit: str = "full"                 # "full" | "reduced"
    # Variable-packet schedule (44.1 kHz delivers 44/45-sample packets at
    # 1 kHz, current_architecture.md:1092).  A non-empty tuple gives the
    # per-packet sample counts compiled into the program; all packet
    # boundaries become static indices, so leveller block semantics stay
    # bit-exact with zero masking.  Input is then [2, sum(schedule), B].
    schedule: tuple = ()
    # Lower the float chain's LTI passes (loudness+EQ, crossfeed+matrix+
    # out-EQ) to block-state-space matmuls (chain/mxu.py).  Float path
    # only, homogeneous (non-per-stream) params; held to the <=1e-6 RMS
    # firmware-fidelity budget instead of golden bit-exactness.  The port
    # runs only this lowering.
    mxu: bool = True
    # Device-side wire-word output (audio_spdif.c:276-288,
    # sample_encoding.cpp:24-68): when non-empty, a per-S/PDIF-slot tuple
    # of output types (0 = S/PDIF subframe words, 1 = I2S words) compiled
    # into the program; the pipeline then emits the exact DMA word
    # streams on-device, with the IEC 60958 192-frame block position
    # carried in ChainState.wire_pos across segments.
    wire: tuple = ()
    wire_rate: int = 48000

    @property
    def is_float(self) -> bool:
        return self.platform == "rp2350"


class ChainParams(NamedTuple):
    """Dynamic coefficient arrays.  f32 fields are None on the Q28 path and
    vice versa."""

    # PASS 1
    unpack_gain: Any          # f32 [2] (inv_scale*preamp) | i32 [2] preamp Q28
    loud_sva: Any             # f32 [2 filt, 6] (sva1..svm2) | None
    loud_qbq: Any             # i32 [2 filt, 5] (b0,b1,b2,a1,a2) | None
    loud_bypass: Any          # bool [2]
    # PASS 2 EQ coefficients [nch, MAX_BANDS]
    eq_f32: Any               # f32 [nch, NB, 11] (sva1..svm2, b0,b1,b2,a1,a2)
    eq_q28: Any               # i32 [nch, NB, 5]
    # PASS 2.5 leveller scalars
    lev: Any                  # f32 [11]: a_rms, a_att, a_rel, thresh, knee,
    #                          gate, ratio, max_gain, makeup, slope, 1/(2*knee)
    # PASS 3 crossfeed
    xf: Any                   # f32 [3] lp_a0, lp_b1, ap_a | i32 [3]
    # PASS 4/5 gains
    vol_mul: Any              # f32 scalar host volume (0 if muted) | i32 Q15
    master_vol: Any           # f32 scalar linear | i32 Q15
    matrix_gain: Any          # f32 [2, nout] | i32 [2, nout] Q15 signed
    out_gain: Any             # f32 [nout] gain_linear (both platforms)
    delay_samples: Any        # i32 [n_delayed]


class ChainState(NamedTuple):
    loud_a: Any               # [2ch, 2filt, B] ic1 | s1
    loud_b: Any               # [2ch, 2filt, B] ic2 | s2
    eq_a: Any                 # [nch, NB, B] s1 | s1;  float path: TDF2 s1
    eq_b: Any                 # [nch, NB, B] s2
    eq_c: Any                 # [nch, NB, B] SVF ic1 (float only)
    eq_d: Any                 # [nch, NB, B] SVF ic2 (float only)
    lev_env: Any              # [2, B]
    lev_gain_db: Any          # [B] smoothed gain dB (f32 both paths)
    lev_gain: Any             # [B] linear gain (f32) | Q28 (i32)
    lev_gain_prev: Any        # [B]
    lev_la: Any               # [2, 480, B] lookahead ring (time-ordered,
    #                           oldest first — enables static-slice shifts)
    xf_lp: Any                # [2, B]
    xf_ap: Any                # [2, B]
    delay: Any                # [n_delayed, D, B] (time-ordered)
    pdm_err: Any              # [B] i32
    pdm_err2: Any             # [B] i32
    pdm_ns: Any               # [5, B] i32: x1, x2, y1, y2, err_acc
    pdm_rng: Any              # [B] u32
    pdm_fade: Any             # [B] i32 fade_in_pos
    # enable/fade-out state machine (pdm_generator.c:217-252,323-338):
    # the control plane flips pdm_ena; kernels run the firmware's loop
    # reactions (fade-out start, mid-fade cancel, restart reset).
    pdm_ena: Any              # [B] i32 pdm_enabled
    pdm_run: Any              # [B] i32 hw_running
    pdm_fout: Any             # [B] i32 fade_out_pos
    pdm_base: Any             # [B] i32 fade_base_pcm
    clip_flags: Any           # [B] i32 sticky bitmask
    wire_pos: Any             # scalar i32: IEC 60958 frame position (0-191)


def build_static(d: DerivedParams, block_size: int, bit_depth: int = 16,
                 emit: str = "full", pdm: bool = True,
                 schedule=None, mxu: bool = True,
                 wire: bool = False, pdm_keep: bool = False) -> StaticChain:
    """``pdm_keep``: keep the PDM stage compiled even though the sub
    output is disabled — a RUNTIME disable must keep the modulator alive
    for the 1024-sample fade-out and a possible mid-fade re-enable
    (pdm_generator.c:217-252); Engine.update_config passes the old
    static's pdm_on so a disable transition never drops the stage
    mid-fade.  Fresh builds with the sub output off omit it as before."""
    cfg = d.config
    if schedule:
        block_size = max(schedule)
    nout = cfg.num_outputs
    is_float = cfg.platform is Platform.RP2350

    band_kinds = []
    for ch in range(cfg.num_channels):
        kinds = []
        for bq in d.eq[ch]:
            if bq.bypass:
                kinds.append(SKIP)
            elif is_float and bq.use_svf:
                kinds.append(_SVF_KIND[bq.svf_type])
            else:
                kinds.append(TDF2)
        band_kinds.append(tuple(kinds))

    g = d.gains
    plat_mask = C.MAX_DELAY_SAMPLES[cfg.platform] - 1
    # The firmware runs the delay for every output with delay>0, enabled or
    # not (usb_audio.c:898-911) — disabled outputs shift zeros through their
    # ring.  Reproduce that membership here.
    delayed = []
    max_eff = 0
    for o in range(nout):
        eff = int(g.delay_samples[o]) & plat_mask
        if eff > 0:
            delayed.append(o)
            max_eff = max(max_eff, eff)
    ring = _next_pow2(max_eff + block_size + 1) if delayed else 0

    return StaticChain(
        platform=cfg.platform.value,
        block_size=block_size,
        n_channels=cfg.num_channels,
        n_outputs=nout,
        n_spdif=C.NUM_SPDIF_INSTANCES[cfg.platform],
        bit_depth=bit_depth,
        band_kinds=tuple(band_kinds),
        channel_bypassed=tuple(bool(b) for b in d.channel_bypassed),
        bypass_master_eq=bool(cfg.bypass_master_eq),
        loudness_on=bool(cfg.loudness.enabled and d.loudness is not None),
        leveller_on=bool(cfg.leveller.enabled),
        leveller_lookahead=bool(cfg.leveller.lookahead),
        crossfeed_on=bool(d.crossfeed.enabled),
        output_enabled=tuple(bool(x) for x in g.output_enabled),
        output_mute=tuple(bool(x) for x in g.output_mute),
        delayed_outputs=tuple(delayed),
        delay_ring=ring,
        pdm_on=bool(pdm and (g.output_enabled[nout - 1] or pdm_keep)),
        emit=emit,
        schedule=tuple(int(t) for t in schedule) if schedule else (),
        mxu=bool(mxu and cfg.platform is Platform.RP2350),
        wire=(tuple(int(t) for t in cfg.hardware.output_types[
            :C.NUM_SPDIF_INSTANCES[cfg.platform]]) if wire else ()),
        wire_rate=int(cfg.sample_rate),
    )


def build_params(d: DerivedParams, static: StaticChain) -> ChainParams:
    cfg = d.config
    g = d.gains
    nch, nout = cfg.num_channels, cfg.num_outputs
    nb = C.MAX_BANDS
    is_float = static.is_float
    plat_mask = C.MAX_DELAY_SAMPLES[cfg.platform] - 1

    # PASS 1 unpack gain: firmware folds the int->unit scale into the preamp
    # (usb_audio.c:602-603 / 680-681) before the per-sample multiply.
    if is_float:
        inv = F(1.0) / (F(8388608.0) if static.bit_depth == 24 else F(32768.0))
        unpack_gain = np.array([inv * g.preamp_linear[0],
                                inv * g.preamp_linear[1]], np.float32)
    else:
        unpack_gain = g.preamp_q28.copy()

    # loudness row for the current host volume index
    loud_sva = loud_qbq = None
    loud_bypass = np.zeros(2, bool)
    if static.loudness_on:
        row = d.loudness[min(max(cfg.host_volume_index, 0), C.CENTER_VOLUME_INDEX)]
        loud_bypass = np.array([s.bypass for s in row], bool)
        if is_float:
            loud_sva = np.array(
                [[s.sva1, s.sva2, s.sva3, s.svm0, s.svm1, s.svm2] for s in row],
                np.float32)
        else:
            loud_qbq = np.array(
                [[s.qb0, s.qb1, s.qb2, s.qa1, s.qa2] for s in row], np.int32)

    # EQ coefficient grids
    eq_f32 = eq_q28 = None
    if is_float:
        eq_f32 = np.zeros((nch, nb, 11), np.float32)
        for ch in range(nch):
            for b, bq in enumerate(d.eq[ch]):
                eq_f32[ch, b] = [bq.sva1, bq.sva2, bq.sva3, bq.svm0, bq.svm1,
                                 bq.svm2, bq.b0, bq.b1, bq.b2, bq.a1, bq.a2]
    else:
        eq_q28 = np.zeros((nch, nb, 5), np.int32)
        for ch in range(nch):
            for b, bq in enumerate(d.eq[ch]):
                eq_q28[ch, b] = [bq.qb0, bq.qb1, bq.qb2, bq.qa1, bq.qa2]

    lv = d.leveller
    # precompute the gain computer's divisions host-side (IEEE numpy) so the
    # device path is division-free and bit-identical to the golden model
    slope = F(1.0) - F(1.0) / F(lv.ratio)
    inv_two_knee = F(1.0) / (F(2.0) * F(lv.knee_width_db))
    lev = np.array([lv.alpha_rms, lv.alpha_attack, lv.alpha_release,
                    lv.threshold_db, lv.knee_width_db, lv.gate_threshold_db,
                    lv.ratio, lv.max_gain_db, lv.makeup_db,
                    slope, inv_two_knee], np.float32)

    xf_d = d.crossfeed
    if is_float:
        xf = np.array([xf_d.lp_a0, xf_d.lp_b1, xf_d.ap_a], np.float32)
    else:
        xf = np.array([xf_d.q_lp_a0, xf_d.q_lp_b1, xf_d.q_ap_a], np.int32)

    # host volume with mute folded in (usb_audio.c:569/:975)
    if is_float:
        vol_mul = (F(0.0) if cfg.host_mute
                   else F(int(g.host_vol_mul)) * (F(1.0) / F(32768.0)))
        master_vol = g.master_volume_linear
        matrix_gain = g.matrix_gain.copy()
    else:
        vol_mul = np.int32(0 if cfg.host_mute else int(g.host_vol_mul))
        master_vol = g.master_volume_q15
        matrix_gain = g.matrix_gain_q15.copy()

    delay_samples = np.array(
        [int(g.delay_samples[o]) & plat_mask for o in static.delayed_outputs],
        np.int32)
    if static.delay_ring:
        # the ring must hold the deepest delay plus one block of writes
        assert int(delay_samples.max(initial=0)) + static.block_size \
            <= static.delay_ring

    return ChainParams(
        unpack_gain=unpack_gain,
        loud_sva=loud_sva, loud_qbq=loud_qbq, loud_bypass=loud_bypass,
        eq_f32=eq_f32, eq_q28=eq_q28,
        lev=lev, xf=xf,
        vol_mul=np.asarray(vol_mul),
        master_vol=np.asarray(master_vol),
        matrix_gain=matrix_gain,
        out_gain=g.output_gain_linear.copy(),
        delay_samples=delay_samples,
    )


def init_state(static: StaticChain, n_streams: int,
               pdm_seed=C.PDM_RNG_SEED, pdm_fade: bool = True) -> ChainState:
    B = n_streams
    nch, nb = static.n_channels, C.MAX_BANDS
    is_float = static.is_float
    fdt = np.float32 if is_float else np.int32

    def zf(*s):
        return np.zeros(s, fdt)

    def zi(*s):
        return np.zeros(s, np.int32)

    rng = np.full(B, pdm_seed, np.uint32) if np.isscalar(pdm_seed) \
        else np.asarray(pdm_seed, np.uint32)

    return ChainState(
        loud_a=zf(2, 2, B), loud_b=zf(2, 2, B),
        eq_a=zf(nch, nb, B), eq_b=zf(nch, nb, B),
        eq_c=zf(nch, nb, B) if is_float else None,
        eq_d=zf(nch, nb, B) if is_float else None,
        lev_env=zf(2, B),
        lev_gain_db=np.zeros(B, np.float32),
        lev_gain=(np.ones(B, np.float32) if is_float
                  else np.full(B, C.Q28_ONE, np.int32)),
        lev_gain_prev=(np.ones(B, np.float32) if is_float
                       else np.full(B, C.Q28_ONE, np.int32)),
        lev_la=zf(2, C.LEVELLER_LOOKAHEAD_SAMPLES, B) if static.leveller_on else None,
        xf_lp=zf(2, B), xf_ap=zf(2, B),
        delay=zf(len(static.delayed_outputs), static.delay_ring, B)
        if static.delay_ring else None,
        pdm_err=zi(B), pdm_err2=zi(B),
        pdm_ns=zi(5, B),
        pdm_rng=rng,
        pdm_fade=(zi(B) if pdm_fade
                  else np.full(B, C.PDM_FADE_IN_SAMPLES, np.int32)),
        pdm_ena=np.ones(B, np.int32), pdm_run=np.ones(B, np.int32),
        pdm_fout=zi(B), pdm_base=zi(B),
        clip_flags=zi(B),
        wire_pos=np.int32(0),
    )


def build_params_multi(deriveds: list, static: StaticChain,
                       stream_config_ids=None) -> ChainParams:
    """Per-stream heterogeneous parameters.

    Stacks the params of several configs on a trailing stream axis so every
    stream in the batch can run its own coefficients/gains/delays — beyond
    the single-config firmware, but a natural fit for batched serving.
    All configs must share the same static structure (band kinds, enables);
    ``build_static`` of each must equal ``static``.

    ``stream_config_ids``: optional int array [B] mapping each stream to a
    config index (default: one stream per config, B == len(deriveds)).
    """
    if static.mxu:
        raise ValueError(
            "per-stream parameters require the scan path: the MXU block "
            "matrices are built from homogeneous coefficients (build the "
            "static with mxu=False, or use GroupedEngine for K-config "
            "heterogeneous serving)")
    for d in deriveds:
        s = build_static(d, block_size=static.block_size,
                         bit_depth=static.bit_depth, emit=static.emit,
                         pdm=static.pdm_on, schedule=static.schedule,
                         mxu=static.mxu, wire=bool(static.wire))
        if s != static:
            raise ValueError(
                "heterogeneous configs must share static structure; "
                f"mismatch for config with bands {s.band_kinds}")
    return lane_params([build_params(d, static) for d in deriveds],
                       stream_config_ids)


def lane_params(per: list, stream_config_ids=None) -> ChainParams:
    """Stack the NumPy param trees ``per`` (one a config) on a trailing
    stream axis, as ``build_params_multi`` does: lane b takes config
    ``stream_config_ids[b]`` (default: one lane a config)."""
    ids = (None if stream_config_ids is None
           else np.asarray(stream_config_ids, np.int64))

    def stack(*xs):
        if xs[0] is None:
            return None
        arrs = [np.asarray(x) for x in xs]
        # Collapse config-uniform leaves back to the homogeneous form: a
        # coefficient identical across every config (delays, loudness
        # tables, crossfeed poles in a typical multi-tenant mix) keeps its
        # broadcast form in the pipeline, notably the delay lines, whose
        # per-stream form is a gather over [D+T, B] per output.
        if all(np.array_equal(arrs[0], a) for a in arrs[1:]):
            return arrs[0]
        stacked = np.stack(arrs, axis=-1)
        return stacked if ids is None else stacked[..., ids]

    return ChainParams(*[stack(*vals) for vals in zip(*per)])


# ----------------------------------------------------------------------------
# NumPy trees <-> torch tensors
# ----------------------------------------------------------------------------


def _tensor(v, device):
    if v is None:
        return None
    a = np.asarray(v)
    if a.dtype == np.uint32:                  # pdm_rng: int32 bits in torch
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a.copy()).to(device)      # copy: C order, ndim kept


def resolve_device(device) -> torch.device:
    """An engine's device: ``None`` means the card, and a CUDA device that
    is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the card unless the caller "
            "passes device='cpu'")
    return dev


def to_device(tree, device):
    """A ChainParams/ChainState of NumPy arrays -> the same tree of torch
    tensors on ``device`` (None fields stay None)."""
    return type(tree)(*[_tensor(v, device) for v in tree])


# the rank of each ChainParams leaf that ``build_params`` gives; a
# per-stream leaf (``build_params_multi``) has one more, the stream axis
_NDIM = dict(unpack_gain=1, loud_sva=2, loud_qbq=2, loud_bypass=1,
             eq_f32=3, eq_q28=3, lev=1, xf=1, vol_mul=0, master_vol=0,
             matrix_gain=2, out_gain=1, delay_samples=1)


def from_numpy(params, state, device, static=None):
    """JAX-package (or port) ChainParams/ChainState holding NumPy arrays
    -> the port's trees of torch tensors on ``device``.  Fields are read
    by name, so any NamedTuple with the port's field names will do.  The
    params may be per-stream trees, as the JAX package's
    ``build_params_multi`` or a flat ``GroupedEngine`` holds them, except
    on a float ``static`` of the block-matmul lowering, whose block
    matrices are built from homogeneous coefficients (ValueError there:
    per-stream float trees need ``mxu=False``; grouped float serving on
    that lowering takes per-group trees, ``GroupedEngine.load_numpy``)."""
    if static is not None and static.is_float and static.mxu and any(
            getattr(params, f) is not None
            and np.ndim(getattr(params, f)) > n for f, n in _NDIM.items()):
        raise ValueError(
            "per-stream parameters on the float chain require the scan "
            "path: the block matrices are built from homogeneous "
            "coefficients (build the engine with mxu=False)")
    p = ChainParams(*[getattr(params, f) for f in ChainParams._fields])
    s = ChainState(*[getattr(state, f) for f in ChainState._fields])
    return to_device(p, device), to_device(s, device)


def to_numpy(tree):
    """Inverse of ``to_device``: torch tensors -> NumPy arrays, with
    ``pdm_rng`` back to uint32."""
    out = {}
    for f, v in zip(tree._fields, tree):
        if v is None:
            out[f] = None
            continue
        a = v.detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f == "pdm_rng" else a
    return type(tree)(**out)
