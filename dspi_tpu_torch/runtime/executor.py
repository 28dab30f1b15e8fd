"""Multi-stream execution: stream-axis sharding, the segment pump and the
chained serving loop.

The JAX package's ``runtime/executor.py`` in PyTorch.  The stream axis is
embarrassingly parallel: every per-sample recurrence is independent
across streams, so spreading streams over several cards needs no
communication beyond feed and drain.  This module provides:

  * ``make_mesh``       — the list of devices the stream axis is split over
  * ``shard_engine``    — an engine whose lanes are split over a mesh
                          (``ShardedEngine``: one slice of the lanes, with
                          its own params and state, on each device)
  * ``StreamRunner``    — asynchronous segment pump (the card's stream
                          ordering overlaps host work with device work)
  * ``ChainedRunner``   — ``depth`` segments a batch, one host readback
  * ``RunnerStats``     — the firmware's buffer and starvation counters

The firmware analog of this layer is the core-1 work dispatch + DMA feed
machinery (usb_audio.c:782-871, pdm_generator.c:427-667).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..chain.pack import _NDIM, ChainState
from .telemetry import span

# outputs that hold uint32 words or uint32 folds (int32 bit patterns or
# int64 folds in the port; uint32 in the JAX package)
_UNSIGNED = ("pdm", "pdm_sum", "wire_sum")
# the output that carries no lane axis: uint32 folds, summed over shards
_FOLDS = ("wire_sum",)
_M32 = 0xFFFFFFFF


# ----------------------------------------------------------------------------
# the stream-axis mesh
# ----------------------------------------------------------------------------


class Mesh:
    """The devices a stream axis is split over, in stream order."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices``; None means every visible CUDA device, and
    raises when there is none."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device: make_mesh() spans the visible cards; pass "
                "a device list (e.g. [torch.device('cpu')]) to run without")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices)


def _to(tree, dev):
    """A tensor, or a (named) tuple of them, moved to ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple):
        vals = [_to(v, dev) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


class ShardedState(tuple):
    """Per-shard ChainStates of a ShardedEngine, shard d on device d."""

    def __new__(cls, states, owner):
        self = super().__new__(cls, states)
        self._owner = owner
        return self

    @property
    def clip_flags(self):
        return self._owner._merge([s.clip_flags for s in self])

    def merged(self) -> ChainState:
        """One ChainState on the mesh's first device, lanes in the
        engine's own order."""
        fields = {}
        for f in ChainState._fields:
            vals = [getattr(s, f) for s in self]
            if vals[0] is None or f == "wire_pos":
                fields[f] = _to(vals[0], self._owner.device)
            else:
                fields[f] = self._owner._merge(vals)
        return ChainState(**fields)


class ShardedEngine:
    """An Engine, GroupedEngine or HeteroServer with its lanes split over a
    mesh (``shard_engine``).

    The engine's flat lane axis (a GroupedEngine's or HeteroServer's K
    groups of G lanes; an Engine's B streams as one group) is cut into
    ``mesh.size`` slices of every group: device d holds lanes
    [d*w, (d+1)*w) of each group (w = G / mesh.size), with its own copy of
    the params (per-lane leaves cut the same way) and, on the float chain,
    of the block matrices.  A segment moves each slice of the input to its
    device, runs every slice there (the launches of the devices overlap),
    and brings the outputs back to the mesh's first device in the
    engine's stream order; uint32 folds are summed mod 2^32.  A
    HeteroServer's bucketing gather and scatter run on the first device.

    It has the engine's surface: ``process``, ``segment_fn``, ``params``,
    ``state`` (a ShardedState), ``static``, ``update_config`` and
    ``update_group`` (which gather the state, apply the change to the
    wrapped engine and split it again); other attributes are the wrapped
    engine's."""

    def __init__(self, engine, mesh: Mesh):
        self.base = engine
        self.mesh = mesh
        self.device = mesh.devices[0]
        self._hetero = getattr(engine, "grouped", None) is not None
        self._flat = engine.grouped if self._hetero else engine
        grouped = hasattr(self._flat, "streams_per_group")
        self._grouped = grouped
        self._K = self._flat.n_groups if grouped else 1
        self._G = (self._flat.streams_per_group if grouped
                   else self._flat.n_streams)
        self._w = self._G // mesh.size
        self._lanes = [{} for _ in mesh.devices]       # flat-fn keywords
        if self._hetero:
            self._perm = engine._perm.to(self.device)
            self._inv = engine._inv.to(self.device)
            self._lanes = [{"wire_lanes": self._split(engine._valid, d)}
                           for d in range(mesh.size)]
        self._reshard(state=True)

    def __getattr__(self, name):
        if name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)

    # -- lanes --------------------------------------------------------------
    def _split(self, v, d: int):
        """Shard d's lanes of a flat [..., K*G] tensor, as a new tensor."""
        K, n, w = self._K, self.mesh.size, self._w
        part = v.reshape(*v.shape[:-1], K, n, w)[..., d, :]
        return part.reshape(*v.shape[:-1], K * w).to(
            self.mesh.devices[d]).contiguous()

    def _merge(self, parts):
        """Per-shard [..., K*w] tensors -> [..., K*G] on the first device."""
        K, w = self._K, self._w
        parts = [p.to(self.device).reshape(*p.shape[:-1], K, 1, w)
                 for p in parts]
        v = torch.cat(parts, dim=-2)
        return v.reshape(*v.shape[:-3], K * self._G)

    def _reshard(self, state: bool) -> None:
        """Cut the wrapped engine's params (and its state, with ``state``)
        into the shards."""
        flat = self._flat
        old = getattr(self, "_shards", None)
        shards = []
        for d, dev in enumerate(self.mesh.devices):
            sh = copy.copy(flat)
            sh.device = dev
            if self._grouped:
                sh.streams_per_group = self._w
            else:
                sh.n_streams = self._w
            sh.params = type(flat.params)(*[
                None if v is None
                else self._split(v, d) if v.dim() > _NDIM[f]
                else v.to(dev)
                for f, v in zip(flat.params._fields, flat.params)])
            sh.blocks = _to(flat.blocks, dev)
            if state:
                sh.state = ChainState(*[
                    None if v is None
                    else v.to(dev) if f == "wire_pos" or v.dim() == 0
                    else self._split(v, d)
                    for f, v in zip(ChainState._fields, flat.state)])
            else:
                sh.state = old[d].state
            shards.append(sh)
        self._shards = shards
        self.state = ShardedState([sh.state for sh in shards], self)

    def _gather_state(self) -> None:
        """Write the shards' state back into the wrapped engine."""
        st = self.state.merged()
        self._flat.state = _to(st, self._flat.device)

    # -- the engine surface -------------------------------------------------
    @property
    def static(self):
        return self.base.static

    @property
    def params(self):
        return tuple(sh.params for sh in self._shards)

    @property
    def segment_fn(self):
        """``(params, state, x, preset_mute) -> (state', out)`` over the
        shards, with the CURRENT shards' block matrices: ``params`` one
        tree a shard, ``state`` a ShardedState, x and the outputs as the
        wrapped engine's."""
        fns = [sh.flat_segment_fn if self._grouped else sh.segment_fn
               for sh in self._shards]
        K, G = self._K, self._G

        def fn(params, state, x, pm):
            x = torch.as_tensor(x).to(self.device)
            if self._hetero:
                x = x.index_select(-1, self._perm)
            elif self._grouped:
                x = x.movedim(0, -2).reshape(*x.shape[1:-1], K * G)
            outs, states = [], []
            for d, (f, p, st) in enumerate(zip(fns, params, state)):
                dev = self.mesh.devices[d]
                st, o = f(p, st, self._split(x, d),
                          None if pm is None else pm.to(dev),
                          **self._lanes[d])
                states.append(st)
                outs.append(o)
            out = {}
            for k in outs[0]:
                if k in _FOLDS:
                    v = sum(o[k].to(self.device) for o in outs) & _M32
                    if self._hetero or self._grouped:   # [.., K] -> [K, ..]
                        v = v.movedim(-1, 0)
                else:
                    v = self._merge([o[k] for o in outs])
                    if self._hetero:
                        v = v.index_select(-1, self._inv)
                    elif self._grouped:
                        v = v.reshape(*v.shape[:-1], K, G).movedim(-2, 0)
                out[k] = v
            return ShardedState(states, self), out

        return fn

    def process(self, x, preset_mute=None):
        if preset_mute is not None:
            preset_mute = torch.as_tensor(preset_mute, dtype=torch.float32)
        self.state, out = self.segment_fn(self.params, self.state, x,
                                          preset_mute)
        return out

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, v):
        self._state = v
        for sh, st in zip(self._shards, v):
            sh.state = st

    def update_config(self, cfg, preset_load: bool = False,
                      bit_depth: int | None = None):
        """The wrapped engine's ``update_config`` on the gathered state,
        then split again."""
        self._gather_state()
        self.base.update_config(cfg, preset_load=preset_load,
                                bit_depth=bit_depth)
        self._reshard(state=True)

    def update_group(self, k: int, cfg) -> None:
        """Swap group ``k``'s coefficients on every shard (new tensors:
        a runner keeps its snapshot until ``commit_params``)."""
        self.base.update_group(k, cfg)
        self._reshard(state=False)


def shard_engine(engine, mesh: Mesh | None = None) -> ShardedEngine:
    """Split an engine's lanes over a mesh; returns the ShardedEngine,
    which takes the engine's place (its state lives in the shards from
    here on).

    Serves ``Engine`` (lanes = its ``n_streams``) and
    ``GroupedEngine``/``HeteroServer`` (each group's ``streams_per_group``
    lanes are split).  The lane width must be divisible by the mesh size
    or this raises: HeteroServer's 128-lane bucket alignment usually
    provides that, but it skips alignment when padding would exceed 25% —
    build the server with ``lane_multiple=mesh.size`` to make it
    unconditional."""
    if mesh is None:
        mesh = make_mesh()
    grouped = getattr(engine, "grouped", None)          # HeteroServer
    width = getattr(grouped or engine, "streams_per_group",
                    getattr(engine, "n_streams", None))
    if width is not None and width % mesh.size != 0:
        raise ValueError(
            f"lane width {width} is not divisible by the {mesh.size}-chip "
            f"mesh; rebuild with lane_multiple={mesh.size} "
            "(HeteroServer) or pad n_streams to a mesh multiple")
    return ShardedEngine(engine, mesh)


def shard_input(x, mesh: Mesh):
    """Place an input batch where a ShardedEngine over ``mesh`` reads it:
    the mesh's first device (each segment splits it over the stream axis
    in the engine's lane order, which for a HeteroServer is known only
    after its bucketing gather)."""
    return torch.as_tensor(x).to(mesh.devices[0])


def _check_mesh(engine, mesh) -> None:
    if mesh is not None and getattr(engine, "mesh", None) is not mesh:
        raise ValueError("shard the engine over the mesh first "
                         "(engine = shard_engine(engine, mesh))")


# ----------------------------------------------------------------------------
# statistics
# ----------------------------------------------------------------------------


class RunnerStats:
    """Observable runtime health — the batched analog of the firmware's
    buffer statistics and starvation counters (config.h:492-519,
    audio_spdif.c:361-379).  Fill level is the in-flight segment depth
    against ``max_inflight``; a *starvation* is a missed feed deadline: the
    host failed to enqueue the next segment within one segment's worth of
    audio time, which on the device would have forced silence-buffer
    substitution on every active output slot."""

    USB_ERROR_KINDS = ("crc", "bitstuff", "rx_overflow", "rx_timeout",
                       "data_seq")

    def __init__(self, n_slots: int = 4, max_inflight: int = 2):
        self.n_slots = n_slots
        self.max_inflight = max_inflight
        self.segments = 0
        self.silence_segments = 0
        self.starvations_total = 0
        self.starvations_slot = [0, 0, 0, 0]
        self.starvations_suppressed = 0
        self.fill_pct = 0
        self.min_fill_pct = 100
        self.max_fill_pct = 0
        # Host data-plane framing errors, shaped like the firmware's PHY
        # counters (usb_device.c:46-52) so GET_USB_ERROR_STATS reads real
        # events: de-framed segments land in data_seq, truncated transfers
        # in rx_timeout, oversize in rx_overflow.
        self.usb_errors = dict.fromkeys(("total",) + self.USB_ERROR_KINDS, 0)

    def record_fill(self, depth: int):
        self.fill_pct = min(100, int(100 * depth / max(self.max_inflight, 1)))
        self.min_fill_pct = min(self.min_fill_pct, self.fill_pct)
        self.max_fill_pct = max(self.max_fill_pct, self.fill_pct)

    def record_starvation(self, suppressed: bool = False):
        """One missed feed deadline starves every active slot at once, so
        each slot's counter AND the global total advance per slot — the
        firmware increments spdif_dma_starvations alongside each
        per-instance counter inside every instance's DMA handler
        (audio_spdif.c:368-372), so its total is likewise the sum over
        instances, n_slots per simultaneous event.

        ``suppressed``: the miss happened during an intentional disruption
        (a preset/flash operation) — the firmware masks the counters for
        that window (audio_spdif.c:375-378 gates on ``preset_loading``,
        set around every flash op: flash_storage.c:348,776,875,
        main.c:456; the gap-detected underruns are gated the same way,
        usb_audio.c:1358).  Suppressed events are still observable in
        ``starvations_suppressed`` (one per event, not per slot) so the
        disruption isn't silently invisible — but GET_STATUS totals
        match firmware behavior."""
        if suppressed:
            self.starvations_suppressed += 1
            return
        for i in range(min(self.n_slots, 4)):
            self.starvations_slot[i] += 1
            self.starvations_total += 1

    def record_usb_error(self, kind: str):
        assert kind in self.USB_ERROR_KINDS
        self.usb_errors["total"] += 1
        self.usb_errors[kind] += 1

    def reset_watermarks(self):
        """REQ_RESET_BUFFER_STATS wValue&1 (usb_audio.c:2208-2217)."""
        self.min_fill_pct = 100
        self.max_fill_pct = 0

    def reset_usb_errors(self):
        """REQ_RESET_USB_ERROR_STATS (usb_audio.c:2946-2960)."""
        for k in self.usb_errors:
            self.usb_errors[k] = 0


def _done_event(dev: torch.device):
    """An event recorded on ``dev``'s current stream after the work just
    enqueued (None on the CPU, where the work is already done)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _wait(ev) -> None:
    if ev is not None:
        ev.synchronize()


# ----------------------------------------------------------------------------
# the segment pump
# ----------------------------------------------------------------------------


class StreamRunner:
    """Asynchronous segment pump over an Engine.

    ``feed`` enqueues a segment's work on the card and returns without
    waiting for it, so host-side packetization of segment N+1 overlaps
    device compute of segment N — the analog of the firmware's SPSC-ring
    producer/consumer decoupling (usb_audio_ring.h:31-131), with the
    card's stream ordering standing in for the memory barriers.  Each
    in-flight segment carries an event recorded after its work; popping
    one waits on that event alone.

    ``deadline_s`` (optional) turns on real-time accounting: when the gap
    between consecutive feeds exceeds it, the device side would have
    starved — every active output slot's starvation counter increments
    AND a silence segment is substituted into the output stream
    (audio_spdif.c:361-379: the DMA plays the instance silence buffer,
    not the late data), so a consumer draining the runner actually
    receives the zeros the firmware would have played.  ``stats`` feeds
    the vendor buffer statistics through ``VirtualDSPi.attach_runner``.
    """

    def __init__(self, engine, mesh: Mesh | None = None, max_inflight: int = 2,
                 deadline_s: float | None = None, n_slots: int | None = None):
        _check_mesh(engine, mesh)
        self.engine = engine
        self.mesh = mesh
        self.max_inflight = max_inflight
        self.deadline_s = deadline_s
        if n_slots is None:
            st = getattr(engine, "static", None)
            n_slots = st.n_spdif if st is not None else 4
        self.stats = RunnerStats(n_slots=n_slots, max_inflight=max_inflight)
        self._inflight: list = []          # (output dict, event or None)
        self._t_last_feed: float | None = None
        self._silence_template = None
        self._template_static = getattr(engine, "static", None)
        # ``preset_loading`` analog: a callable returning True while an
        # intentional disruption (preset/flash op) is in flight —
        # VirtualDSPi.attach_runner wires it to its mute envelope.
        # Starvations in that window are suppressed, not counted
        # (audio_spdif.c:375-378).
        self.disruption_source = None

    def note_disruption(self):
        """Reset the feed-deadline clock across an intentional stall (a
        structural commit's drain+rebuild, a preset load) — the analog of
        the firmware zeroing its gap-detection timestamp on stream
        lifecycle transitions (usb_audio.c as_set_alternate:
        ``audio_ring_last_push_us = 0``)."""
        self._t_last_feed = None

    def _disrupted(self) -> bool:
        return bool(self.disruption_source and self.disruption_source())

    def _silence_out(self):
        """A zeroed output segment shaped like the last real one — the
        analog of the firmware's per-instance silence buffer.  A
        structural engine commit (new static) re-shapes the outputs, so
        the template resets with it."""
        cur = getattr(self.engine, "static", None)
        if cur is not self._template_static:
            self._silence_template = None
            self._template_static = cur
        if self._silence_template is None:
            return None
        return {k: torch.zeros(shape, dtype=dt, device=dev)
                for k, (shape, dt, dev) in self._silence_template.items()}

    def _expected_shape(self, x) -> bool:
        st = getattr(self.engine, "static", None)
        if st is None:
            return True
        if st.schedule:                      # [2, sum(schedule), B]
            return (x.ndim == 3 and x.shape[0] == 2
                    and x.shape[1] == sum(st.schedule))
        return (x.ndim == 4 and x.shape[1] == 2       # [npkt, 2, T, B]
                and x.shape[2] == st.block_size)

    def feed(self, x, preset_mute=None):
        """Enqueue one segment; returns an output dict of tensors (the
        oldest in flight once more than ``max_inflight`` are, waited for;
        else this segment's, still running)."""
        now = time.perf_counter()
        if (self.deadline_s is not None and self._t_last_feed is not None
                and now - self._t_last_feed > self.deadline_s):
            # silence is substituted regardless — the DMA plays the
            # silence buffer whether or not a preset op is in flight;
            # only the COUNTERS are gated on preset_loading
            # (audio_spdif.c:361-378)
            self.stats.record_starvation(suppressed=self._disrupted())
            sil = self._silence_out()
            if sil is not None:
                self._inflight.append((sil, None))
                self.stats.silence_segments += 1
        self._t_last_feed = now

        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if not self._expected_shape(x):
            # de-framed segment: the firmware's USB SIE would flag this
            # as a sequence/framing error and drop the packet
            self.stats.record_usb_error("data_seq")
            raise ValueError(
                f"segment shape {tuple(x.shape)} does not frame as "
                "[n_packets, 2, block, B]")
        out = self.engine.process(x, preset_mute)
        if self._silence_template is None:
            self._silence_template = {k: (v.shape, v.dtype, v.device)
                                      for k, v in out.items()}
        self._inflight.append((out, _done_event(self.engine.device)))
        self.stats.segments += 1
        self.stats.record_fill(len(self._inflight))
        if len(self._inflight) > self.max_inflight:
            done, ev = self._inflight.pop(0)
            _wait(ev)
            return done
        return out

    def drain(self):
        """Wait for all enqueued segments; returns the last output."""
        last = None
        for out, ev in self._inflight:
            _wait(ev)
            last = out
        self._inflight.clear()
        self.stats.record_fill(0)
        return last


# ----------------------------------------------------------------------------
# the chained serving loop
# ----------------------------------------------------------------------------


def ack_fold(out: dict) -> torch.Tensor:
    """One segment's scalar ack, the JAX package's value word for word on
    integer outputs: each output summed in its JAX dtype (int32 wrapping
    as signed, uint32 words and folds as unsigned), cast to float32, and
    the casts added in float32 in sorted key order (the order of
    ``jax.tree.leaves`` over a dict).  A float32 tensor on the outputs'
    device; float outputs sum in float32, in torch's order."""
    total = None
    with span("dspi.ack_fold"):
        for k in sorted(out):
            v = out[k]
            if v.is_floating_point():
                f = v.sum(dtype=torch.float32)
            else:
                s = v.sum(dtype=torch.int64)
                if k in _UNSIGNED or k.startswith("wire"):
                    s = s & _M32
                else:
                    s = ((s + 0x80000000) & _M32) - 0x80000000
                f = s.to(torch.float64).to(torch.float32)   # one rounding
            total = f if total is None else total + f
    return total


class ChainedRunner:
    """Production-shaped serving loop: ``depth`` segments a batch, state
    threaded through them on the card, one host readback a batch.

    ``StreamRunner.feed`` hands back one segment's outputs a call; this
    runner keeps the whole batch on the card: each segment's outputs fold
    into a scalar ack (``ack_fold``), the state runs on, and the host
    reads one value a batch (the last fold), which forces the batch.
    Telemetry (peaks, clip flags) rides out with the last segment.

    Control-plane commits apply at batch boundaries: the params (and, on
    the float chain, the block matrices) are snapshotted when the runner
    is built and at ``commit_params``, so ``VirtualDSPi.commit(engine)``
    alone keeps serving the old coefficients until ``commit_params`` —
    the analog of the firmware's deferred main-loop updates landing
    between USB packets.

    Real-time accounting matches StreamRunner: a feed gap exceeding the
    batch's audio duration counts starvations on every active slot.

    Serves any engine exposing the ``segment_fn`` contract: ``Engine``
    (xb [depth, npkt, 2, T, B]), ``GroupedEngine`` (leading K group axis),
    ``HeteroServer`` (caller stream order; ``update_group`` +
    ``commit_params`` swaps one tenant's coefficients live) and a
    ``ShardedEngine`` of any of them.
    """

    def __init__(self, engine, depth: int = 8, deadline_s: float | None = None,
                 n_slots: int | None = None, mesh: Mesh | None = None,
                 pre=None):
        """``mesh``: the mesh the engine was sharded over
        (``engine = shard_engine(engine, mesh)`` first); every segment
        then runs each device's lanes on that device.

        ``pre``: optional per-segment input transform applied before each
        segment — e.g. ``kernels.deframe.make_pre`` to feed raw USB
        payload words and unpack them on the card (the firmware unpacks
        on the device too, usb_audio.c:591-686).  With ``pre`` set,
        ``feed`` takes xb of shape [depth, *pre_input]."""
        _check_mesh(engine, mesh)
        self.engine = engine
        self.depth = depth
        self.deadline_s = deadline_s
        self.mesh = mesh
        self.pre = pre
        if n_slots is None:
            n_slots = engine.static.n_spdif
        self.stats = RunnerStats(n_slots=n_slots, max_inflight=2)
        self._inflight: list = []          # ((folds, peaks, clips), event)
        self._t_last_feed: float | None = None
        self.disruption_source = None     # see StreamRunner.disruption_source
        self._build()

    note_disruption = StreamRunner.note_disruption
    _disrupted = StreamRunner._disrupted

    def _build(self):
        """Take the engine's CURRENT static structure (and params)."""
        self._static = self.engine.static
        self._put_params()

    def _put_params(self):
        """Snapshot the engine's params and its segment processor, which
        holds the float chain's block matrices."""
        self._params_dev = self.engine.params
        self._segment = self.engine.segment_fn

    def commit_params(self):
        """Sync with the engine after a control-plane commit
        (VirtualDSPi.commit).  Coefficient-only commits take the new
        params; a STRUCTURAL commit (band enables, output enables, a
        sample-rate or bit-depth change) replaced ``engine.static``, so
        in-flight batches are drained first (their results belong to the
        old structure) and the runner rebuilds — the analog of the
        firmware's pipeline reset around structural updates
        (prepare/complete_pipeline_reset, main.c:230-528)."""
        if self.engine.static is not self._static:
            self.drain()
            self._build()
            # the drain+rebuild stall is intentional — don't let the next
            # feed's gap read as a starvation (the firmware's pipeline
            # reset runs under preset_loading, main.c:456)
            self.note_disruption()
        else:
            self._put_params()

    def _run(self, xb, pm):
        st = self.engine.state
        folds = []
        for i in range(self.depth):
            x = xb[i]
            if self.pre is not None:
                x = self.pre(x)
            st, out = self._segment(self._params_dev, st, x, pm[i])
            folds.append(ack_fold(out))
        return st, torch.stack(folds), out["peaks"], st.clip_flags

    def feed(self, xb, preset_mute=None):
        """xb: int32 [depth, n_packets, 2, T, B] (one batch of chained
        segments; with ``pre``, [depth, *pre_input]).  preset_mute:
        optional [depth, n_packets] staircase.  Returns (folds [depth],
        peaks, clips) as tensors on the engine's device: the previous
        batch's, waited for, once one is in flight; else this batch's."""
        now = time.perf_counter()
        if (self.deadline_s is not None and self._t_last_feed is not None
                and now - self._t_last_feed > self.deadline_s):
            self.stats.record_starvation(suppressed=self._disrupted())
        self._t_last_feed = now

        dev = self.engine.device
        if preset_mute is None:
            # [depth, npkt, 2, T, B] homogeneous / [depth, K, npkt, 2, T, G]
            # grouped: npkt sits at -4 either way; scheduled chains carry
            # it in the static; a ``pre`` hook must carry its own as an
            # ``npkt`` attribute (kernels.deframe.make_pre does) — the
            # fed payload shape no longer frames packets, so guessing
            # from it would build a wrong-shaped mute staircase.
            if self.engine.static.schedule:
                npkt = len(self.engine.static.schedule)
            elif self.pre is not None:
                npkt = getattr(self.pre, "npkt", None)
                if npkt is None:
                    raise ValueError(
                        "a custom pre hook must expose .npkt (packets "
                        "per segment) or preset_mute must be passed "
                        "explicitly — the payload shape cannot frame it")
            else:
                npkt = xb.shape[-4]
            preset_mute = torch.ones((self.depth, npkt), dtype=torch.float32,
                                     device=dev)
        else:
            preset_mute = torch.as_tensor(preset_mute, dtype=torch.float32,
                                          device=dev)
        if not isinstance(xb, torch.Tensor):
            xb = torch.from_numpy(np.ascontiguousarray(xb))
        xb = xb.to(dev)
        self.engine.state, folds, peaks, clips = self._run(xb, preset_mute)
        out = (folds, peaks, clips)
        self._inflight.append((out, _done_event(dev)))
        self.stats.segments += self.depth
        self.stats.record_fill(len(self._inflight))
        if len(self._inflight) > 1:
            done, ev = self._inflight.pop(0)
            _wait(ev)
            float(done[0][-1].item())          # the one readback a batch
            return done
        return out

    def drain(self):
        last = None
        for out, ev in self._inflight:
            _wait(ev)
            float(out[0][-1].item())
            last = out
        self._inflight.clear()
        self.stats.record_fill(0)
        return last
