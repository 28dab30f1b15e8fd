"""Grouped heterogeneous serving of Q28 configs: K configs x G streams in
one segment call.

The JAX package's ``chain/grouped.py`` for RP2040 (Q28) configs.  The port
lowers every grouped engine flat: the K groups' streams form one K*G-wide
lane axis (group blocks contiguous), the coefficients become per-lane
leaves (``build_params_multi``), and one ``process_q28`` call runs all
lanes, its two cascade calls in the kernel's per-lane (``lane_cf``) mode.
The JAX package's flat and vmapped Q28 lowerings are the same program
(tests/test_grouped.py holds them word-equal), and on the TPU both reach
``lane_cf``.  Per-stream delays, which the JAX package's ``layout="auto"``
sends to its vmapped layout, stay flat here and read the delay ring
through a per-lane gather.

All configs must share static structure (band kinds, enables, dynamics
toggles: everything ``build_static`` compiles in); coefficient-level
differences (frequencies, gains, volumes, delays, routing weights) are
free.

Refused, naming ROADMAP.md item 11b: float (RP2350) configs and
``layout="vmap"``, whose grouped serving needs per-group block matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C
from ..params.design import derive
from .pack import (build_params_multi, build_static, init_state,
                   resolve_device, to_device)
from .pipeline import process_q28, refuse

_NOT_PORTED = ("grouped and hetero serving of float (RP2350) configs and "
               "layout='vmap' (per-group block matrices) are not ported yet: "
               "ROADMAP.md section 1, item 11b")


class GroupedEngine:
    """K device configs, one flat lane axis, K x streams_per_group streams.

    >>> eng = GroupedEngine([cfg_a, cfg_b], streams_per_group=4096)
    >>> out = eng.process(x)   # x: int32 [K, n_packets, 2, block, G]
    """

    def __init__(self, cfgs, streams_per_group: int, block_size: int = 48,
                 bit_depth: int = 16, emit: str = "full", pdm: bool = True,
                 pdm_fade: bool = True, pdm_seed=C.PDM_RNG_SEED,
                 schedule=None, wire: bool = False, layout: str = "auto",
                 device=None):
        """``layout``: "auto" or "flat" (the same here); "vmap" is
        refused.  ``device``: None means "cuda", and raises when no CUDA
        device is present."""
        if layout == "vmap":
            raise NotImplementedError(_NOT_PORTED)
        if layout not in ("auto", "flat"):
            raise ValueError(f"unknown layout {layout!r}")
        self.device = resolve_device(device)
        self.cfgs = list(cfgs)
        self.n_groups = len(self.cfgs)
        self.streams_per_group = streams_per_group
        self.deriveds = [derive(c) for c in self.cfgs]
        statics = [build_static(d, block_size=block_size,
                                bit_depth=bit_depth, emit=emit, pdm=pdm,
                                schedule=schedule, wire=wire)
                   for d in self.deriveds]
        if any(s != statics[0] for s in statics):
            raise ValueError(
                "grouped configs must share static structure (band kinds, "
                "enables, dynamics toggles); use one Engine per structure "
                "or build_params_multi for per-stream coefficients")
        self.static = statics[0]
        if self.static.is_float:
            raise NotImplementedError(_NOT_PORTED)
        refuse(self.static)
        self.layout = "flat"
        self.params = self._flat_params()
        # uniform per-stream fills, so init_state(K*G) is leaf for leaf the
        # lane-axis concatenation of K per-group init_state(G)s
        self.state = to_device(
            init_state(self.static, self.n_groups * streams_per_group,
                       pdm_seed=pdm_seed, pdm_fade=pdm_fade), self.device)

    def _flat_params(self):
        ids = np.repeat(np.arange(self.n_groups), self.streams_per_group)
        return to_device(build_params_multi(self.deriveds, self.static, ids),
                         self.device)

    def update_group(self, k: int, cfg) -> None:
        """Swap group ``k``'s coefficients (the new config must keep the
        shared static structure).  Leaves that stay config-uniform keep
        their collapsed homogeneous shape."""
        d = derive(cfg)
        s = build_static(d, block_size=self.static.block_size,
                         bit_depth=self.static.bit_depth,
                         emit=self.static.emit, pdm=self.static.pdm_on,
                         schedule=self.static.schedule,
                         wire=bool(self.static.wire))
        if s != self.static:
            raise ValueError("new config changes the static structure")
        self.cfgs[k] = cfg
        self.deriveds[k] = d
        self.params = self._flat_params()

    def process(self, x, preset_mute=None):
        """x: int32 [K, n_packets, 2, block, G] (scheduled chains:
        [K, 2, sum(schedule), G]) -> output dict with a leading group
        axis on every entry."""
        x = torch.as_tensor(x, device=self.device)
        if preset_mute is not None:
            preset_mute = torch.as_tensor(preset_mute, dtype=torch.float32,
                                          device=self.device)
        self.state, out = self.segment_fn(self.params, self.state, x,
                                          preset_mute)
        return out

    @property
    def segment_fn(self):
        """``(params, state, x, preset_mute) -> (state', out)`` with x and
        the outputs carrying the leading group axis: one input transpose
        into the flat lane layout, and the outputs reshaped back."""
        raw, K, G = self.flat_segment_fn, self.n_groups, self.streams_per_group

        def fn(params, state, x, pm):
            xf = x.movedim(0, -2).reshape(*x.shape[1:-1], K * G)
            state, out = raw(params, state, xf, pm)
            return state, {k: v.reshape(*v.shape[:-1], K, G).movedim(-2, 0)
                           for k, v in out.items()}

        return fn

    @property
    def flat_segment_fn(self):
        """The flat segment processor: x [..., K*G] with group lane-blocks
        contiguous, flat outputs (the engine's native layout)."""
        return functools.partial(process_q28, self.static)


class HeteroServer:
    """Arbitrary per-stream heterogeneous serving on a GroupedEngine.

    K distinct configs scattered across B streams in any order: a stable
    permutation gathers each config's streams into its own contiguous
    group, the GroupedEngine processes the groups as one flat lane axis,
    and the inverse permutation scatters the outputs back to the caller's
    stream order.  A stream's config is fixed at build time, so the
    per-stream STATE lives permanently in grouped layout; only inputs and
    outputs permute.  Unequal bucket sizes are padded to the largest
    (padding slots recompute some stream; their outputs are dropped).

    ``update_group(k, cfg)`` swaps one config's coefficients live;
    re-assigning streams to other configs is a rebuild.
    """

    def __init__(self, cfgs, stream_config_ids, lane_multiple: int = 1,
                 **kw):
        """``lane_multiple``: force the bucket width to a multiple of this
        (the JAX package passes its mesh's device count; the port's mesh
        is ROADMAP.md item 12).  ``kw`` goes to ``GroupedEngine``."""
        ids = np.asarray(stream_config_ids, np.int64)
        K = len(cfgs)
        if ids.min() < 0 or ids.max() >= K:
            raise ValueError("stream_config_ids out of range")
        self.n_streams = len(ids)
        counts = np.bincount(ids, minlength=K)
        G = int(counts.max())
        # the bucket width the JAX package picks (it lane-aligns buckets of
        # more than 128 streams to a multiple of 128 while that costs at
        # most 25% more lanes), so that padding_waste and the grouped
        # state's shape are the same in both packages and state trees move
        # between them
        if G > 128:
            g_aligned = -(-G // 128) * 128
            if g_aligned <= G * 1.25:
                G = g_aligned
        if lane_multiple > 1:
            G = -(-G // lane_multiple) * lane_multiple
        perm = np.zeros((K, G), np.int64)
        valid = np.zeros((K, G), bool)
        for k in range(K):
            idx = np.where(ids == k)[0]
            perm[k, :len(idx)] = idx
            perm[k, len(idx):] = idx[0] if len(idx) else 0
            valid[k, :len(idx)] = True
        inv = np.zeros(self.n_streams, np.int64)
        flat, vmask = perm.reshape(-1), valid.reshape(-1)
        inv[flat[vmask]] = np.where(vmask)[0]
        self.grouped = GroupedEngine(cfgs, streams_per_group=G, **kw)
        dev = self.grouped.device
        self._perm = torch.from_numpy(perm.reshape(-1)).to(dev)
        self._inv = torch.from_numpy(inv).to(dev)
        self.padding_waste = float(K * G) / max(self.n_streams, 1) - 1.0

    @property
    def static(self):
        return self.grouped.static

    # params/state live on the wrapped GroupedEngine; proxied so a runner
    # drives a HeteroServer exactly like an Engine
    @property
    def params(self):
        return self.grouped.params

    @params.setter
    def params(self, v):
        self.grouped.params = v

    @property
    def state(self):
        return self.grouped.state

    @state.setter
    def state(self, v):
        self.grouped.state = v

    @property
    def segment_fn(self):
        """``(params, state, x, preset_mute) -> (state', out)`` with x and
        the outputs in the CALLER's stream order and the state grouped:
        one gather of the input into bucket order, one of each output
        back."""
        raw, perm, inv = self.grouped.flat_segment_fn, self._perm, self._inv

        def fn(params, state, x, pm):
            state, out = raw(params, state, x.index_select(-1, perm), pm)
            return state, {k: v.index_select(-1, inv) for k, v in out.items()}

        return fn

    def update_group(self, k: int, cfg) -> None:
        self.grouped.update_group(k, cfg)

    def process(self, x, preset_mute=None):
        """x: int32 [n_packets, 2, block, B] (scheduled chains: [2,
        sum(schedule), B]) in the CALLER's stream order -> output dict,
        trailing axes back in the caller's order."""
        dev = self.grouped.device
        x = torch.as_tensor(x, device=dev)
        if preset_mute is not None:
            preset_mute = torch.as_tensor(preset_mute, dtype=torch.float32,
                                          device=dev)
        self.state, out = self.segment_fn(self.params, self.state, x,
                                          preset_mute)
        return out
