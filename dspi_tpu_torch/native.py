"""ctypes binding of native/dspi_host.cpp: the host data plane and the
firmware oracles.

The JAX package's ``native.py`` on the port's own params:

  * the host data plane the framed serving path uses: packet (de)framing
    (``unpack_s16``, ``unpack_s24``, ``pack_s24``, ``deframe_batch``,
    ``to_time_major``) and ``crc32``;
  * the scalar oracles ``q28_mul``, ``q15_mul``, ``q28_cascade_block`` and
    ``pdm_block``;
  * the firmware oracles ``FirmwareFloat`` (the RP2350 float chain with
    the firmware's libm transcendentals and hardware division) and
    ``FirmwareQ28`` (the RP2040 chain with its exact integer signal path
    and libm leveller gain), which take the port's ``DeviceConfig`` and
    the port's ``chain.pack`` builders, and the libm derivations
    ``fw_db_to_linear`` and ``fw_compute_alpha``.

The library is built on first use with g++ from the repo's
``native/dspi_host.cpp`` into ``dspi_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded; ``native/`` itself is only
read.  Where the library cannot be built, every entry point raises: the
framed serving path has no fallback, and an oracle that was asked for is
never quietly skipped.  The flags differ from ``native/Makefile``'s only
in its warnings, so both builds give the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dspi_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-fvisibility=hidden", "-fwrapv", "-pthread",
             "-shared")

_lib = None


def lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdspi_host-{digest[:16]}.so"


def _load():
    """The bound library, built first if it is missing; raises
    RuntimeError with the compiler's output when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.exists():
        raise RuntimeError(f"native source {SOURCE} is missing")
    out = lib_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            done = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++: {e}") from e
        if done.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, out)            # atomic: a concurrent build is safe
    lib = ctypes.CDLL(str(out))

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64, cint, cf, vp = (ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                         ctypes.c_void_p)
    lib.dspi_crc32.restype = ctypes.c_uint32
    lib.dspi_crc32.argtypes = [u8p, ctypes.c_uint64]
    lib.dspi_unpack_s16.argtypes = [u8p, i64, i32p, i32p]
    lib.dspi_unpack_s24.argtypes = [u8p, i64, i32p, i32p]
    lib.dspi_pack_s24.argtypes = [i32p, i32p, i64, u8p]
    lib.dspi_to_time_major.argtypes = [i32p, i64, i64, i32p]
    for fn in (lib.dspi_deframe_s16_batch, lib.dspi_deframe_s24_batch):
        fn.argtypes = [u8p, i64, i64, i64, i32p, ctypes.c_int32]

    # the scalar oracles
    for fn in (lib.dspi_q28_mul, lib.dspi_q15_mul):
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.dspi_q28_cascade_block.argtypes = [i32p, i32p, ctypes.c_int32, i32p,
                                           i64]
    lib.dspi_pdm_block.argtypes = [i32p, i32p, i64, u32p]

    # the firmware-float oracle
    lib.dspi_fw_new.restype = vp
    lib.dspi_fw_new.argtypes = [cf, cint, cint, cint, cint]
    lib.dspi_fw_free.argtypes = [vp]
    lib.dspi_fw_set_eq.argtypes = [vp, i32p, f32p, cint]
    lib.dspi_fw_set_loudness.argtypes = [vp, cint, f32p, i32p]
    lib.dspi_fw_set_gains.argtypes = [vp, f32p, cf, cint, cint, f32p, u8p,
                                      u8p, f32p, u8p, u8p, i32p]
    lib.dspi_fw_set_gains_raw.argtypes = [vp, f32p, cf, cint, cint, f32p,
                                          f32p, u8p, u8p, i32p]
    lib.dspi_fw_set_leveller.argtypes = [vp, cint, cf, cint, cf, cf, cint]
    lib.dspi_fw_set_leveller_raw.argtypes = [vp, cint, cint] + [cf] * 9
    lib.dspi_fw_set_crossfeed.argtypes = [vp, cint, cint, cf, cf, cint]
    lib.dspi_fw_set_crossfeed_raw.argtypes = [vp, cint, cf, cf, cf]
    lib.dspi_fw_enable_pdm.argtypes = [vp, cint, cint]
    lib.dspi_fw_process.argtypes = [vp, i32p, cint, cint, cint, f32p, u32p]
    for fn in (lib.dspi_fw_db_to_linear, lib.dspi_fw_compute_alpha):
        fn.restype = cf
    lib.dspi_fw_db_to_linear.argtypes = [cf]
    lib.dspi_fw_compute_alpha.argtypes = [cf, cf]

    # the firmware-Q28 oracle
    lib.dspi_fwq_new.restype = vp
    lib.dspi_fwq_new.argtypes = [cf, cint, cint, cint, cint]
    lib.dspi_fwq_free.argtypes = [vp]
    lib.dspi_fwq_set_eq.argtypes = [vp, i32p, i32p, cint, u8p]
    lib.dspi_fwq_set_loudness.argtypes = [vp, cint, i32p, i32p]
    lib.dspi_fwq_set_gains.argtypes = [vp, i32p, cint, cint, cint, i32p,
                                       f32p, u8p, u8p, i32p]
    lib.dspi_fwq_set_leveller_raw.argtypes = [vp, cint, cint] + [cf] * 9
    lib.dspi_fwq_set_crossfeed.argtypes = [vp, cint, ctypes.c_int32,
                                           ctypes.c_int32, ctypes.c_int32]
    lib.dspi_fwq_enable_pdm.argtypes = [vp, cint, cint]
    lib.dspi_fwq_process.argtypes = [vp, i32p, cint, cint, cint, f32p, i32p,
                                     u32p]
    _lib = lib
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _bytes(data) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))


def unpack_s16(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved s16 LRLR bytes -> (left, right) int32 arrays."""
    lib = _load()
    buf = _bytes(data)
    frames = len(buf) // 4
    out_l = np.empty(frames, np.int32)
    out_r = np.empty(frames, np.int32)
    lib.dspi_unpack_s16(_u8p(buf), frames, _i32p(out_l), _i32p(out_r))
    return out_l, out_r


def unpack_s24(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Packed s24 LRLR bytes (6 B/frame) -> (left, right) int32 arrays."""
    lib = _load()
    buf = _bytes(data)
    frames = len(buf) // 6
    out_l = np.empty(frames, np.int32)
    out_r = np.empty(frames, np.int32)
    lib.dspi_unpack_s24(_u8p(buf), frames, _i32p(out_l), _i32p(out_r))
    return out_l, out_r


def pack_s24(left: np.ndarray, right: np.ndarray) -> bytes:
    lib = _load()
    left = np.ascontiguousarray(left, np.int32).ravel()
    right = np.ascontiguousarray(right, np.int32).ravel()
    if len(left) != len(right):
        raise ValueError(f"{len(left)} left samples, {len(right)} right")
    out = np.empty(len(left) * 6, np.uint8)
    lib.dspi_pack_s24(_i32p(left), _i32p(right), len(left), _u8p(out))
    return out.tobytes()


def deframe_batch(payloads: np.ndarray, npkt: int, block: int,
                  bit_depth: int = 16, n_threads: int = 0) -> np.ndarray:
    """Batched USB-byte deframe straight into the engine's input layout.

    ``payloads``: uint8 [B, npkt*block*bpf] — each row one stream's raw
    USB payload byte stream (bpf = 4 for interleaved s16 LRLR, 6 for
    packed s24 LRLR; unpack semantics usb_audio.c:591-594 / 997-1006).
    Returns int32 [npkt, 2, block, B] — deframe, channel split,
    packetization and the lane transpose in one multithreaded native pass.

    ``n_threads`` 0 = DSPI_NATIVE_THREADS env or all cores."""
    lib = _load()
    bpf = 6 if bit_depth == 24 else 4
    payloads = np.ascontiguousarray(payloads, np.uint8)
    b, nbytes = payloads.shape
    if nbytes != npkt * block * bpf:
        raise ValueError(f"payload rows carry {nbytes} bytes; "
                         f"npkt*block*bpf = {npkt * block * bpf}")
    if not n_threads:
        n_threads = int(os.environ.get("DSPI_NATIVE_THREADS", 0)) \
            or (os.cpu_count() or 1)
    out = np.empty((npkt, 2, block, b), np.int32)
    fn = (lib.dspi_deframe_s24_batch if bit_depth == 24
          else lib.dspi_deframe_s16_batch)
    fn(_u8p(payloads), b, npkt, block, _i32p(out), n_threads)
    return out


def to_time_major(planar: np.ndarray) -> np.ndarray:
    """[B, T] int32 -> [T, B] int32 via the native transpose."""
    lib = _load()
    planar = np.ascontiguousarray(planar, np.int32)
    b, t = planar.shape
    out = np.empty((t, b), np.int32)
    lib.dspi_to_time_major(_i32p(planar), b, t, _i32p(out))
    return out


def crc32(data: bytes) -> int:
    buf = _bytes(data)
    return int(_load().dspi_crc32(_u8p(buf), len(buf)))


# ---------------------------------------------------------------------------
# the scalar oracles
# ---------------------------------------------------------------------------


def q28_mul(a: int, b: int) -> int:
    """fast_mul_q28 (dsp_pipeline.c:47-59)."""
    return int(_load().dspi_q28_mul(a, b))


def q15_mul(a: int, b: int) -> int:
    """fast_mul_q15 (config.h:556-567)."""
    return int(_load().dspi_q15_mul(a, b))


def q28_cascade_block(coeffs: np.ndarray, state: np.ndarray,
                      samples: np.ndarray) -> None:
    """In-place Q28 TDF2 cascade.  coeffs int32 [bands, 5]; state int32
    [bands, 2] and samples int32 [count], both updated in place."""
    lib = _load()
    coeffs = np.ascontiguousarray(coeffs, np.int32)
    for name, a in (("state", state), ("samples", samples)):
        if a.dtype != np.int32 or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be a C-contiguous int32 array")
    lib.dspi_q28_cascade_block(_i32p(coeffs), _i32p(state), coeffs.shape[0],
                               _i32p(samples), len(samples))


def pdm_block(state: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Delta-sigma modulate a block.  state: int32 [9] [err, err2, x1, x2,
    y1, y2, err_acc, rng, fade], updated in place; x: int32 [count] Q28.
    Returns uint32 [count * 8] PDM words."""
    lib = _load()
    if state.dtype != np.int32 or state.shape != (9,):
        raise ValueError("state must be an int32 array of 9 words")
    x = np.ascontiguousarray(x, np.int32)
    out = np.empty(len(x) * 8, np.uint32)
    lib.dspi_pdm_block(_i32p(state), _i32p(x), len(x), _u32p(out))
    return out


def fw_db_to_linear(db: float) -> float:
    """The firmware's libm dB -> linear derivation."""
    return _load().dspi_fw_db_to_linear(np.float32(db))


def fw_compute_alpha(rate: float, t: float) -> float:
    """The firmware's libm one-pole coefficient for time constant ``t``."""
    return _load().dspi_fw_compute_alpha(np.float32(rate), np.float32(t))


# ---------------------------------------------------------------------------
# the firmware oracles
# ---------------------------------------------------------------------------


def _chain(cfg, is_float: bool):
    """The derived params, static and params of ``cfg`` (the block size
    does not matter to the oracles)."""
    from .chain.pack import build_params, build_static
    from .params.design import derive

    d = derive(cfg)
    static = build_static(d, block_size=48)
    if static.is_float != is_float:
        raise ValueError(f"{cfg.platform} config for the "
                         f"{'float' if is_float else 'Q28'} oracle")
    return d, static, build_params(d, static)


def _kinds(static, nb: int) -> np.ndarray:
    kinds = np.zeros((static.n_channels, nb), np.int32)
    for ch in range(static.n_channels):
        kinds[ch, :len(static.band_kinds[ch])] = static.band_kinds[ch]
    return kinds


def _u8(v) -> np.ndarray:
    return np.ascontiguousarray(v, np.uint8)


def _leveller_raw(fn, handle, cfg, lv) -> None:
    fn(handle, int(cfg.leveller.enabled), int(cfg.leveller.lookahead),
       float(lv.alpha_rms), float(lv.alpha_attack), float(lv.alpha_release),
       float(lv.threshold_db), float(lv.knee_width_db),
       float(lv.gate_threshold_db), float(lv.ratio), float(lv.max_gain_db),
       float(lv.makeup_db))


class FirmwareFloat:
    """The RP2350 float chain with the firmware's own math classes (libm
    transcendentals, hardware division): the measured side of the <= 1e-6
    RMS fidelity budget.  ``coeff_source='design'`` (default) loads the
    coefficient values the golden model uses, so a comparison isolates
    the runtime signal path; ``coeff_source='native'`` derives the
    leveller, crossfeed and gain coefficients with libm (the firmware's
    derivation path), to measure coefficient fidelity."""

    def __init__(self, cfg, pdm: bool = True, pdm_fade: bool = True,
                 coeff_source: str = "design"):
        if coeff_source not in ("design", "native"):
            raise ValueError(f"coeff_source {coeff_source!r}")
        lib = self._lib = _load()
        d, static, params = _chain(cfg, is_float=True)
        nch, nb = static.n_channels, params.eq_f32.shape[1]
        nout = self.nout = static.n_outputs
        self._p = lib.dspi_fw_new(float(cfg.sample_rate), nout,
                                  static.n_spdif, nch, nb)
        coef = np.ascontiguousarray(params.eq_f32, np.float32)
        lib.dspi_fw_set_eq(self._p, _i32p(_kinds(static, nb)), _f32p(coef),
                           int(static.bypass_master_eq))
        if static.loudness_on:
            lc = np.ascontiguousarray(params.loud_sva, np.float32)
            lb = np.ascontiguousarray(params.loud_bypass, np.int32)
            lib.dspi_fw_set_loudness(self._p, 1, _f32p(lc), _i32p(lb))

        g = d.gains
        out_en, out_mute = _u8(g.output_enabled), _u8(g.output_mute)
        dly = np.ascontiguousarray(g.delay_samples, np.int32)
        if coeff_source == "design":
            pre = np.ascontiguousarray(g.preamp_linear, np.float32)
            mat = np.ascontiguousarray(g.matrix_gain, np.float32)
            og = np.ascontiguousarray(g.output_gain_linear, np.float32)
            lib.dspi_fw_set_gains_raw(
                self._p, _f32p(pre), float(g.master_volume_linear),
                int(g.host_vol_mul), int(bool(cfg.host_mute)), _f32p(mat),
                _f32p(og), _u8p(out_en), _u8p(out_mute), _i32p(dly))
            _leveller_raw(lib.dspi_fw_set_leveller_raw, self._p, cfg,
                          d.leveller)
            xf = d.crossfeed
            lib.dspi_fw_set_crossfeed_raw(
                self._p, int(xf.enabled), float(xf.lp_a0), float(xf.lp_b1),
                float(xf.ap_a))
        else:
            xps = [[cfg.crosspoints[i][o] for o in range(nout)]
                   for i in range(2)]
            pre_db = np.array(cfg.preamp_db, np.float32)
            mat_db = np.array([[xp.gain_db for xp in row] for row in xps],
                              np.float32)
            mat_en = _u8([[xp.enabled for xp in row] for row in xps])
            mat_inv = _u8([[xp.phase_invert for xp in row] for row in xps])
            og_db = np.array([o.gain_db for o in cfg.outputs], np.float32)
            lib.dspi_fw_set_gains(
                self._p, _f32p(pre_db), float(cfg.master_volume_db),
                int(g.host_vol_mul), int(bool(cfg.host_mute)),
                _f32p(mat_db), _u8p(mat_en), _u8p(mat_inv), _f32p(og_db),
                _u8p(out_en), _u8p(out_mute), _i32p(dly))
            lv = cfg.leveller
            lib.dspi_fw_set_leveller(
                self._p, int(lv.enabled), float(lv.amount), int(lv.speed),
                float(lv.gate_threshold_db), float(lv.max_gain_db),
                int(lv.lookahead))
            xf = cfg.crossfeed
            lib.dspi_fw_set_crossfeed(
                self._p, int(xf.enabled), int(xf.preset),
                float(xf.custom_fc), float(xf.custom_feed_db),
                int(xf.itd_enabled))

        self.pdm_on = bool(pdm and g.output_enabled[nout - 1])
        lib.dspi_fw_enable_pdm(self._p, int(self.pdm_on), int(pdm_fade))

    def process(self, x: np.ndarray, bit_depth: int = 16):
        """x: int32 [npkt, 2, T], one stream.  Returns (out float32 [npkt,
        nout, T], PDM words uint32 [npkt * T, 8] or None)."""
        npkt, _, T = x.shape
        x = np.ascontiguousarray(x, np.int32)
        out = np.empty((npkt, self.nout, T), np.float32)
        words = np.empty((npkt * T, 8), np.uint32) if self.pdm_on else None
        self._lib.dspi_fw_process(
            self._p, _i32p(x), npkt, T, int(bit_depth == 24), _f32p(out),
            None if words is None else _u32p(words))
        return out, words

    def __del__(self):
        if getattr(self, "_p", None):
            self._lib.dspi_fw_free(self._p)


class FirmwareQ28:
    """The whole RP2040 Q28 chain with the firmware's exact arithmetic: the
    integer Q28/Q15 signal path, and libm log10f/powf and hardware float
    division in the leveller's gain computer and limiter
    (leveller.c:264-389).  Unlike the golden model it does not share the
    repo's deterministic ``fmath``, so a libm ulp that flips the quantized
    Q28 gain's LSB shows as a word difference.  The coefficients are the
    quantized integers ``ChainParams`` carries, so a comparison isolates
    the runtime signal path."""

    def __init__(self, cfg, pdm: bool = True, pdm_fade: bool = True):
        from .core import constants as C

        lib = self._lib = _load()
        d, static, params = _chain(cfg, is_float=False)
        nch, nb = static.n_channels, params.eq_q28.shape[1]
        nout = self.nout = static.n_outputs
        self._p = lib.dspi_fwq_new(float(cfg.sample_rate), nout,
                                   static.n_spdif, nch, nb)
        coef = np.ascontiguousarray(params.eq_q28, np.int32)
        chb = _u8(static.channel_bypassed)
        lib.dspi_fwq_set_eq(self._p, _i32p(_kinds(static, nb)), _i32p(coef),
                            int(static.bypass_master_eq), _u8p(chb))
        if static.loudness_on:
            lc = np.ascontiguousarray(params.loud_qbq, np.int32)
            lb = np.ascontiguousarray(params.loud_bypass, np.int32)
            lib.dspi_fwq_set_loudness(self._p, 1, _i32p(lc), _i32p(lb))

        g = d.gains
        pre = np.ascontiguousarray(params.unpack_gain, np.int32)
        mat = np.ascontiguousarray(params.matrix_gain, np.int32)
        og = np.ascontiguousarray(params.out_gain, np.float32)
        out_en, out_mute = _u8(g.output_enabled), _u8(g.output_mute)
        mask = C.MAX_DELAY_SAMPLES[cfg.platform] - 1
        dly = np.array([int(s) & mask for s in g.delay_samples], np.int32)
        lib.dspi_fwq_set_gains(
            self._p, _i32p(pre), int(g.master_volume_q15),
            int(g.host_vol_mul), int(bool(cfg.host_mute)), _i32p(mat),
            _f32p(og), _u8p(out_en), _u8p(out_mute), _i32p(dly))
        _leveller_raw(lib.dspi_fwq_set_leveller_raw, self._p, cfg,
                      d.leveller)
        if d.crossfeed.enabled:
            xf = np.asarray(params.xf, np.int32)
            lib.dspi_fwq_set_crossfeed(self._p, 1, int(xf[0]), int(xf[1]),
                                       int(xf[2]))

        self.pdm_on = bool(pdm and g.output_enabled[nout - 1])
        lib.dspi_fwq_enable_pdm(self._p, int(self.pdm_on), int(pdm_fade))

    def process(self, x: np.ndarray, bit_depth: int = 16,
                preset_mute: np.ndarray | None = None):
        """x: int32 [npkt, 2, T], one stream; ``preset_mute`` float32
        [npkt] or None.  Returns (out int32 Q28 [npkt, nout, T], PDM words
        uint32 [npkt * T, 8] or None)."""
        npkt, _, T = x.shape
        x = np.ascontiguousarray(x, np.int32)
        out = np.empty((npkt, self.nout, T), np.int32)
        words = np.empty((npkt * T, 8), np.uint32) if self.pdm_on else None
        pm = (None if preset_mute is None
              else np.ascontiguousarray(preset_mute, np.float32))
        self._lib.dspi_fwq_process(
            self._p, _i32p(x), npkt, T, int(bit_depth == 24),
            None if pm is None else _f32p(pm), _i32p(out),
            None if words is None else _u32p(words))
        return out, words

    def __del__(self):
        if getattr(self, "_p", None):
            self._lib.dspi_fwq_free(self._p)
