"""Grouped heterogeneous serving: K configs x G streams in one segment
call.

The JAX package's ``chain/grouped.py``.  All configs must share static
structure (band kinds, enables, dynamics toggles: everything
``build_static`` compiles in); coefficient-level differences (frequencies,
gains, volumes, delays, routing weights) are free.

The port runs every grouped engine on one flat lane axis: the K groups'
streams form K*G lanes (group blocks contiguous), the leaves that differ
across groups become per-lane leaves (``pack.lane_params``), and one
segment call runs all lanes, with one PDM launch a segment.  The JAX
package's two layouts differ in how its state and params are laid out,
and ``layout`` names the one an engine exchanges with it
(``load_numpy``/``to_numpy``):

  * ``"flat"`` (the default for Q28 configs and for float configs on the
    scan lowering, ``mxu=False``): per-lane params and [.., K*G] state,
    the JAX package's flat layout.  The cascade calls run in their
    kernels' per-lane modes (the Q28 kernel's ``lane_cf``, the float
    kernel's per-lane coefficients), and so does the crossfeed.
    Per-stream delays, which the JAX package's ``layout="auto"`` sends to
    its vmapped layout, stay flat here and read the delay ring through a
    per-lane gather; so do wire words in reduced emit, folded group by
    group.
  * ``"vmap"`` (the default for float configs on the block-matmul
    lowering, whose block matrices are per group): [K, ...] params and
    [K, ..., G] state, the JAX package's vmapped layout.  On that lowering
    every block product applies group k's matrices to group k's lanes
    (``mxu.stack_groups``); every elementwise stage runs over all lanes
    with per-lane leaves.  The flat layout of float configs needs the scan
    lowering.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C
from ..params.design import derive
from ..runtime.telemetry import span
from . import mxu
from .pack import (ChainParams, ChainState, _NDIM, build_params,
                   build_static, from_numpy, init_state, lane_params,
                   resolve_device, to_device, to_numpy)
from .pipeline import process_float, process_q28


def _regroup(key, v, K, G):
    """A flat output [..., K*G] -> [K, ..., G]; 'wire_sum' [npairs, K]
    (reduced wire folds, per group) -> [K, npairs]."""
    if key == "wire_sum":
        return v.movedim(-1, 0)
    return v.reshape(*v.shape[:-1], K, G).movedim(-2, 0)


class GroupedEngine:
    """K device configs, one flat lane axis, K x streams_per_group streams.

    >>> eng = GroupedEngine([cfg_a, cfg_b], streams_per_group=4096)
    >>> out = eng.process(x)   # x: int32 [K, n_packets, 2, block, G]
    """

    def __init__(self, cfgs, streams_per_group: int, block_size: int = 48,
                 bit_depth: int = 16, emit: str = "full", pdm: bool = True,
                 pdm_fade: bool = True, pdm_seed=C.PDM_RNG_SEED,
                 schedule=None, mxu: bool = True, wire: bool = False,
                 layout: str = "auto", device=None):
        """``mxu``: the float chain's lowering, as ``Engine``'s.
        ``layout``: "auto", "flat" or "vmap" (module docstring); "auto" is
        "vmap" for float configs on the block-matmul lowering and "flat"
        otherwise.  ``device``: None means "cuda", and raises when no CUDA
        device is present."""
        if layout not in ("auto", "flat", "vmap"):
            raise ValueError(f"unknown layout {layout!r}")
        self.device = resolve_device(device)
        self.cfgs = list(cfgs)
        self.n_groups = len(self.cfgs)
        self.streams_per_group = streams_per_group
        deriveds = [derive(c) for c in self.cfgs]
        statics = [build_static(d, block_size=block_size,
                                bit_depth=bit_depth, emit=emit, pdm=pdm,
                                schedule=schedule, mxu=mxu, wire=wire)
                   for d in deriveds]
        if any(s != statics[0] for s in statics):
            raise ValueError(
                "grouped configs must share static structure (band kinds, "
                "enables, dynamics toggles); use one Engine per structure "
                "or build_params_multi for per-stream coefficients")
        self.static = statics[0]
        if layout == "auto":
            layout = "vmap" if self.static.mxu else "flat"
        if self.static.mxu and layout == "flat":
            raise NotImplementedError(
                "the flat per-lane layout of float configs needs the scan "
                "lowering: build with mxu=False")
        self.layout = layout
        self.blocks = None
        self._group_params = [build_params(d, self.static)
                              for d in deriveds]
        self._set_params()
        # uniform per-stream fills, so init_state(K*G) is leaf for leaf the
        # lane-axis concatenation of K per-group init_state(G)s
        self.state = to_device(
            init_state(self.static, self.n_groups * streams_per_group,
                       pdm_seed=pdm_seed, pdm_fade=pdm_fade), self.device)

    def _set_params(self, k=None) -> None:
        """The lane params from the per-group NumPy trees, and on the
        block-matmul lowering the grouped block matrices: all groups', or
        group ``k``'s only."""
        ids = np.repeat(np.arange(self.n_groups), self.streams_per_group)
        self.params = to_device(lane_params(self._group_params, ids),
                                self.device)
        if not self.static.mxu:
            return
        if k is None:
            per = [mxu.build_blocks(self.static, gp, self.device)
                   for gp in self._group_params]
            self._mix = [b.mix for b in per]
            self.blocks = mxu.stack_groups(self.static, per)
        else:
            new = mxu.build_blocks(self.static, self._group_params[k],
                                   self.device)
            self._mix[k] = new.mix
            self.blocks = mxu.set_group(self.static, self.blocks, k, new,
                                        self._mix)

    def update_group(self, k: int, cfg) -> None:
        """Swap group ``k``'s coefficients (the new config must keep the
        shared static structure): its params, and on the block-matmul
        lowering its block matrices only.  Leaves that stay config-uniform keep their
        collapsed homogeneous shape."""
        d = derive(cfg)
        s = build_static(d, block_size=self.static.block_size,
                         bit_depth=self.static.bit_depth,
                         emit=self.static.emit, pdm=self.static.pdm_on,
                         schedule=self.static.schedule,
                         mxu=self.static.mxu, wire=bool(self.static.wire))
        if s != self.static:
            raise ValueError("new config changes the static structure")
        self.cfgs[k] = cfg
        self._group_params[k] = build_params(d, self.static)
        self._set_params(k)

    # -- the JAX package's layouts ------------------------------------------
    def load_numpy(self, params, state) -> None:
        """Take the params and state of the JAX package's GroupedEngine of
        this ``layout`` (NumPy trees, ``np.asarray`` of its leaves):
        "vmap" [K, ...] params and [K, ..., G] state (on the block-matmul
        lowering group k's block matrices are built from its params),
        "flat" per-lane params and [..., K*G] state."""
        K = self.n_groups
        fields = {}
        for f in ChainState._fields:
            v = getattr(state, f)
            if v is None or self.layout == "flat":
                fields[f] = v
            elif f == "wire_pos":
                pos = np.asarray(v)
                if (pos != pos.flat[0]).any():
                    raise ValueError(f"the groups' wire positions differ: "
                                     f"{pos.tolist()}")
                fields[f] = pos.flat[0]
            else:
                v = np.moveaxis(np.asarray(v), 0, -2)
                fields[f] = v.reshape(*v.shape[:-2], -1)
        if self.layout == "flat":
            self.params, self.state = from_numpy(params, ChainState(**fields),
                                                 self.device, self.static)
            self._group_params = self._split_lanes(params)
            return
        group_params = []
        for k in range(K):
            tree = ChainParams(*[None if getattr(params, f) is None
                                 else np.asarray(getattr(params, f))[k]
                                 for f in ChainParams._fields])
            if any(getattr(tree, f) is not None
                   and np.ndim(getattr(tree, f)) != n
                   for f, n in _NDIM.items()):
                raise ValueError("vmap-layout params: every group's tree "
                                 "must be homogeneous ([K, ...] leaves)")
            group_params.append(tree)
        self._group_params = group_params
        self._set_params()
        self.state = to_device(ChainState(**fields), self.device)

    def _split_lanes(self, params):
        """Per-group NumPy trees of a flat per-lane tree (each lane-axis
        leaf read at its group's first lane), so that a later
        ``update_group`` rebuilds the other groups from what was loaded."""
        G = self.streams_per_group
        trees = []
        for k in range(self.n_groups):
            leaves = []
            for f in ChainParams._fields:
                v = getattr(params, f)
                if v is not None:
                    v = np.asarray(v)
                    if v.ndim > _NDIM[f]:
                        block = v[..., k * G:(k + 1) * G]
                        if (block != block[..., :1]).any():
                            raise ValueError(
                                f"flat-layout params: group {k}'s lanes "
                                f"differ in {f}")
                        v = block[..., 0]
                leaves.append(v)
            trees.append(ChainParams(*leaves))
        return trees

    def to_numpy(self):
        """(params, state) as NumPy trees in the JAX package's layout of
        this ``layout`` (``load_numpy``'s inverse)."""
        st = to_numpy(self.state)
        if self.layout == "flat":
            return to_numpy(self.params), st
        K = self.n_groups
        params = ChainParams(*[
            None if getattr(self._group_params[0], f) is None
            else np.stack([np.asarray(getattr(gp, f))
                           for gp in self._group_params])
            for f in ChainParams._fields])
        fields = {}
        for f, v in zip(st._fields, st):
            if v is None:
                fields[f] = None
            elif f == "wire_pos":
                fields[f] = np.full(K, v, v.dtype)
            else:
                fields[f] = np.moveaxis(v.reshape(*v.shape[:-1], K, -1),
                                        -2, 0)
        return params, ChainState(**fields)

    # -- running ----------------------------------------------------------
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
            return state, {k: _regroup(k, v, K, G) for k, v in out.items()}

        return fn

    @property
    def flat_segment_fn(self):
        """The flat segment processor for the CURRENT params: x [..., K*G]
        with group lane-blocks contiguous, flat outputs (the engine's
        native layout; reduced wire folds [npairs, K])."""
        if self.static.is_float:
            return functools.partial(process_float, self.static,
                                     blocks=self.blocks,
                                     groups=self.n_groups)
        return functools.partial(process_q28, self.static,
                                 groups=self.n_groups)


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
        (a mesh's size, so that ``runtime.executor.shard_engine`` can
        split every bucket evenly).  ``kw`` goes to ``GroupedEngine``."""
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
        self._valid = torch.from_numpy(vmask.astype(np.int64)).to(dev)
        self.padding_waste = float(K * G) / max(self.n_streams, 1) - 1.0

    @property
    def static(self):
        return self.grouped.static

    @property
    def device(self):
        return self.grouped.device

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
        valid = self._valid

        def fn(params, state, x, pm):
            with span("dspi.bucket_in"):
                x = x.index_select(-1, perm)
            state, out = raw(params, state, x, pm, wire_lanes=valid)
            # reduced wire folds stay per bucket, [K, npairs], each of its
            # real streams' words only (padding lanes are left out)
            with span("dspi.bucket_out"):
                return state, {k: v.movedim(-1, 0) if k == "wire_sum"
                               else v.index_select(-1, inv)
                               for k, v in out.items()}

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
