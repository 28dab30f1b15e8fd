"""The batched chain in PyTorch: pack + pipeline + the ``Engine``.

``Engine`` runs B parallel streams of one device config on one card.  It
mirrors the JAX package's ``Engine`` (chain/__init__.py) for the RP2350
float chain on both of its lowerings (the block-matmul one, ``mxu=True``,
the port's default, and the scan one, ``mxu=False``) and for the RP2040
Q28 chain, at 44.1 (the 44/45 packet schedule), 48 and 96 kHz, with the
device-side wire words (``wire=True``) on both chains and per-stream
parameters on the Q28 chain and the float scan lowering.
``GroupedEngine`` and ``HeteroServer`` (chain/grouped.py) serve several
configs of either chain at once.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import constants as C
from ..params.design import derive
from ..params.types import DeviceConfig
from .grouped import GroupedEngine, HeteroServer
from .mxu import build_blocks
from .pack import (ChainParams, ChainState, StaticChain, build_params,
                   build_params_multi, build_static, from_numpy,
                   init_state, resolve_device, to_device, to_numpy)
from .pipeline import process_float, process_q28

__all__ = ["Engine", "GroupedEngine", "HeteroServer", "StaticChain",
           "ChainParams", "ChainState", "build_static", "build_params",
           "build_params_multi", "init_state", "packet_geometry",
           "process_float", "process_q28", "from_numpy", "to_numpy",
           "to_device"]


def packet_geometry(sample_rate, n_packets: int = 10):
    """USB packet geometry for a sample rate: one isochronous packet per
    millisecond (current_architecture.md:1092), 48/96 samples at 48/96
    kHz, and the 44/45 cadence at 44.1 kHz (nine 44s then a 45: 441
    samples per 10 ms).  Returns ``(block_size, schedule)``: uniform rates
    get ``schedule=None``; 44.1 kHz gets the cadence tiled to
    ``n_packets`` rounded up to whole 10 ms groups."""
    rate = int(sample_rate)
    if rate == 44100:
        groups = max(1, -(-int(n_packets) // 10))
        return 45, ((44,) * 9 + (45,)) * groups
    if rate not in (48000, 96000):
        raise ValueError(f"unsupported sample rate {sample_rate}")
    return rate // 1000, None


class Engine:
    """Stateful wrapper: one device config, B parallel streams, one device.

    >>> eng = Engine(DeviceConfig(), n_streams=1024)
    >>> out = eng.process(x)        # x: int32 [n_packets, 2, block, B]
    """

    def __init__(self, cfg: DeviceConfig, n_streams: int, block_size: int = 48,
                 bit_depth: int = 16, emit: str = "full", pdm: bool = True,
                 pdm_fade: bool = True, pdm_seed=C.PDM_RNG_SEED,
                 schedule=None, mxu: bool = True, wire: bool = False,
                 device=None):
        """``device``: where the chain runs; None means "cuda", and raises
        when no CUDA device is present.  ``schedule``: per-packet sample
        counts (44.1 kHz delivers 44/45-sample packets); ``process`` then
        takes x as [2, sum(schedule), B] and emit='full' outputs are
        time-flat.  ``wire``: emit the wire-format word streams on the
        device — S/PDIF subframe words or I2S words per the config's
        output slot types, 'wire{pair}' (emit='full') or 'wire_sum'
        (emit='reduced').  ``mxu``: the float chain's LTI passes as
        block matmuls (True), or its per-sample recurrences as the float
        cascade and crossfeed kernels (False, the scan lowering, which
        also takes per-stream parameters); the Q28 chain has only the
        latter."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_streams = n_streams
        self._rate = float(cfg.sample_rate)
        self._pdm_out_on = bool(pdm and cfg.outputs[-1].enabled)
        self.derived = derive(cfg)
        self.static = build_static(self.derived, block_size=block_size,
                                   bit_depth=bit_depth, emit=emit, pdm=pdm,
                                   schedule=schedule, mxu=mxu, wire=wire)
        self.params = to_device(build_params(self.derived, self.static),
                                self.device)
        self.blocks = self._blocks()
        self.state = to_device(
            init_state(self.static, n_streams, pdm_seed=pdm_seed,
                       pdm_fade=pdm_fade), self.device)

    # -- running ----------------------------------------------------------
    def process(self, x, preset_mute=None):
        """x: int32 [n_packets, 2, block_size, B], or [2, sum(schedule), B]
        with a schedule (tensor or array) -> output dict of tensors on the
        engine's device."""
        x = torch.as_tensor(x, device=self.device)
        if preset_mute is not None:
            preset_mute = torch.as_tensor(preset_mute, dtype=torch.float32,
                                          device=self.device)
        self.state, out = self.segment_fn(self.params, self.state, x,
                                          preset_mute)
        return out

    @property
    def segment_fn(self):
        """``(params, state, x, preset_mute) -> (state', out)`` for the
        CURRENT static and, on the block-matmul lowering, block matrices
        (which belong to ``self.params``)."""
        if not self.static.is_float:
            return functools.partial(process_q28, self.static)
        return functools.partial(process_float, self.static,
                                 blocks=self.blocks)

    def _blocks(self):
        """The block matrices for the current params: None on the scan
        lowering (the Q28 chain has only that one)."""
        if not self.static.mxu:
            return None
        return build_blocks(self.static, self.params, self.device)

    def load_params_state(self, params, state) -> None:
        """Take params and state as NumPy trees (what the JAX package's
        ``build_params``/``init_state`` return, or ``np.asarray`` of its
        engine's), so both packages can run from the same numbers.  On the
        Q28 chain and the float scan lowering the params may be per-stream
        (``build_params_multi``)."""
        self.params, self.state = from_numpy(params, state, self.device,
                                             self.static)
        self.blocks = self._blocks()

    # -- control ----------------------------------------------------------
    def update_config(self, cfg: DeviceConfig, preset_load: bool = False,
                      bit_depth: int | None = None):
        """Apply a new config with the firmware's state-reset semantics
        (main.c:826-976), as the JAX package's ``Engine.update_config``:

          * per-band SVF<->biquad path flips zero that band's state
          * any crossfeed change clears its filter state
          * leveller enable / lookahead toggles reset the leveller
          * preset load zeroes the delay lines and resets the leveller
          * a rate change among 44.1, 48 and 96 kHz recomputes every
            coefficient and re-packetizes (``packet_geometry``: the 44/45
            schedule at 44.1 kHz, as many packets as before); callers
            re-frame their segments; filter state persists
          * ``bit_depth`` (16|24, None = keep) changes only the unpack
          * an S/PDIF <-> I2S output slot switch resets the wire block
            position
          * a sub-output enable flip sets ``pdm_ena``: the modulator fades
            out, stops, restarts (pdm_generator.c:217-252); the stage is
            kept across a runtime disable so the fade-out runs
        """
        old_cfg, old_d, old_static = self.cfg, self.derived, self.static
        block_size, schedule = old_static.block_size, old_static.schedule
        if float(cfg.sample_rate) != self._rate:
            block_size, schedule = packet_geometry(
                cfg.sample_rate,
                len(old_static.schedule) if old_static.schedule else 10)
        new_d = derive(cfg)
        new_static = build_static(
            new_d, block_size=block_size,
            bit_depth=(old_static.bit_depth if bit_depth is None
                       else int(bit_depth)), emit=old_static.emit,
            pdm=old_static.pdm_on or cfg.outputs[-1].enabled,
            schedule=schedule, mxu=old_static.mxu,
            wire=bool(old_static.wire), pdm_keep=old_static.pdm_on)
        self.cfg, self.derived = cfg, new_d
        self._rate = float(cfg.sample_rate)
        if new_static != old_static:
            self.static = new_static
            self.state = self._migrate_state(self.state, new_static)
        self.params = to_device(build_params(self.derived, self.static),
                                self.device)
        self.blocks = self._blocks()

        st = self.state
        # SVF<->biquad path flips (the Q28 chain has no SVF path)
        flips = [] if not self.static.is_float else [
            (ch, b) for ch in range(cfg.num_channels)
            for b in range(min(len(old_d.eq[ch]), len(self.derived.eq[ch])))
            if old_d.eq[ch][b].use_svf != self.derived.eq[ch][b].use_svf
            and not self.derived.eq[ch][b].bypass]
        if flips:
            arrs = {f: getattr(st, f).clone()
                    for f in ("eq_a", "eq_b", "eq_c", "eq_d")}
            for ch, b in flips:
                for arr in arrs.values():
                    arr[ch, b] = 0
            st = st._replace(**arrs)
        if dataclasses.asdict(old_cfg.crossfeed) != \
                dataclasses.asdict(cfg.crossfeed):
            st = st._replace(xf_lp=torch.zeros_like(st.xf_lp),
                             xf_ap=torch.zeros_like(st.xf_ap))
        lev_reset = (preset_load
                     or (cfg.leveller.enabled and not old_cfg.leveller.enabled)
                     or cfg.leveller.lookahead != old_cfg.leveller.lookahead)
        if lev_reset:
            st = self._reset_leveller(st)
        if preset_load and st.delay is not None:
            st = st._replace(delay=torch.zeros_like(st.delay))
        # an S/PDIF <-> I2S slot type switch tears down and restarts the
        # instances, resetting the IEC 60958 block position
        # (process_type_switches, main.c:230-423)
        if old_static.wire and self.static.wire != old_static.wire:
            st = st._replace(wire_pos=torch.zeros_like(st.wire_pos))
        new_pdm_out = bool(cfg.outputs[-1].enabled)
        if (self.static.pdm_on and st.pdm_ena is not None
                and new_pdm_out != self._pdm_out_on):
            st = st._replace(pdm_ena=torch.full_like(st.pdm_ena,
                                                     int(new_pdm_out)))
        self._pdm_out_on = new_pdm_out
        self.state = st

    def _reset_leveller(self, st):
        """leveller_reset_state (leveller.c:95-105): unity gain is 1.0 on
        the float chain and Q28_ONE on the Q28 chain."""
        one = torch.full_like(st.lev_gain,
                              1.0 if self.static.is_float else C.Q28_ONE)
        return st._replace(
            lev_env=torch.zeros_like(st.lev_env),
            lev_gain_db=torch.zeros_like(st.lev_gain_db),
            lev_gain=one, lev_gain_prev=one.clone(),
            lev_la=None if st.lev_la is None else torch.zeros_like(st.lev_la))

    def _migrate_state(self, st: ChainState, new) -> ChainState:
        """Carry state across a structural change; buffers whose shape
        changed (delay rings, lookahead) start fresh."""
        fresh = to_device(init_state(new, self.n_streams), self.device)
        updates = {}
        for f in st._fields:
            ov, nv = getattr(st, f), getattr(fresh, f)
            if ov is None or nv is None or ov.shape != nv.shape:
                updates[f] = nv
            else:
                updates[f] = ov
        return ChainState(**updates)

    # -- checkpoint / resume of runtime state ------------------------------
    def save_state(self, path: str) -> None:
        """Snapshot all per-stream runtime state to an .npz file (the JAX
        package's layout: ``pdm_rng`` as uint32)."""
        arrays = {f: v for f, v in zip(ChainState._fields,
                                       to_numpy(self.state)) if v is not None}
        np.savez_compressed(path, **arrays)

    def load_state(self, path: str) -> None:
        with np.load(path) as data:
            # checkpoints from before the rings were time-ordered stored a
            # circular ring and its index; only index 0 loads as is
            for legacy in ("delay_idx", "lev_la_idx"):
                if legacy in data.files and int(data[legacy]) != 0:
                    raise ValueError(
                        f"checkpoint {path} holds a circular ring at offset "
                        f"{int(data[legacy])} ({legacy}); re-save it")
            cur = to_numpy(self.state)
            updates = {}
            for f in ChainState._fields:
                have = getattr(cur, f)
                if f in data.files:
                    loaded = data[f]
                    if have is not None and have.shape != loaded.shape:
                        raise ValueError(
                            f"state field {f}: shape {loaded.shape} != "
                            f"{have.shape}")
                    updates[f] = loaded
                else:
                    updates[f] = have
        self.state = to_device(ChainState(**updates), self.device)
