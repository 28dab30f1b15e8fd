"""How the benchmark drives the program, one module an entry point.

Each module has ``build(ctx) -> cell``.  A cell has ``warm()`` (set-up's
last step: one segment or batch of the cell's own shapes), ``step(n)`` (n
segments or one batch, ending with the host's readback, returning the
latencies the step completed), ``counters()``, ``collect()`` (after the
window: the program's part of each check and the reference's tasks),
``shape``, ``audio_s_per_segment``, ``step_segments`` and
``trace_segments``.  ``SegmentCell`` is the chained-segments cell that the
render and multi-tenant entries share.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch
from torch.profiler import record_function

from ..compare import OUT_KEYS


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return f"card: {out or torch.cuda.get_device_name(0)}"


def seeded_input(ctx, shape) -> torch.Tensor:
    """The traffic's s16 samples, drawn on the device from the seed in one
    call: int32, uniform over [-amplitude, amplitude)."""
    g = torch.Generator(device=ctx.device)
    g.manual_seed(ctx.seed & (2**63 - 1))
    a = int(ctx.traffic["amplitude"])
    return torch.randint(-a, a, shape, generator=g, device=ctx.device,
                         dtype=torch.int32)


def sample_lanes(ctx, n_streams: int) -> np.ndarray:
    """The streams the check compares, drawn from the seed."""
    k = min(int(ctx.work["check"]["lanes"]), n_streams)
    return np.sort(ctx.rng(1).choice(n_streams, size=k, replace=False))


def _lane_state(state, idx: torch.Tensor) -> dict:
    """Every per-lane state leaf at the lanes ``idx`` (device tensors)."""
    return {f: v.index_select(-1, idx) for f, v in zip(state._fields, state)
            if v is not None and v.dim() > 0}


def _host(tree: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in tree.items()}


class SegmentCell:
    """Chained segments of one segment processor, state carried through
    the whole run: segment i takes ``x ^ i`` (one elementwise op, so each
    sees a fresh input), every segment's ``ack_fold`` adds into one device
    scalar, and a step of n segments ends with its one readback, which
    fails on NaN.

    For the check it keeps, at the sampled lanes only (a few small
    gathers a segment): the outputs of segment 0 and the state after it
    (the start, from the configuration's initial state), and the state
    before and the outputs of the latest segment (followed from the
    program's own state)."""

    def __init__(self, ctx, run_segment, get_state, set_state, state_lanes,
                 lanes, tenants, n_streams: int, block: int, npkt: int,
                 shape: dict):
        from dspi_tpu_torch.runtime.executor import ack_fold

        self._ack_fold = ack_fold
        self.ctx = ctx
        self._run_segment = run_segment
        self._get_state = get_state
        self._set_state = set_state
        self.lanes = lanes
        self.tenants = tenants
        self.block, self.npkt = block, npkt
        self.x = seeded_input(ctx, (npkt, 2, block, n_streams))
        self.x_lanes = self.x[..., torch.as_tensor(lanes, device=ctx.device)
                              ].cpu().numpy()
        self._lanes_t = torch.as_tensor(lanes, device=ctx.device)
        self._state_t = torch.as_tensor(state_lanes, device=ctx.device)
        self.step_segments = int(ctx.traffic["readback_every"])
        self.trace_segments = int(ctx.traffic["trace_segments"])
        self.audio_s_per_segment = (n_streams * npkt * block
                                    / float(ctx.spec["device"]["sample_rate"]))
        self.shape = shape
        self.i = 0
        self._first_outs = None
        self._first_state = None
        self._last = None

    def _segment(self):
        i = self.i
        with record_function("bench.lane_snapshot"):
            before = _lane_state(self._get_state(), self._state_t)
        with record_function("bench.segment_fn"):
            out = self._run_segment(self.x ^ i)
            fold = self._ack_fold(out)
        with record_function("bench.lane_snapshot"):
            outs = {k: out[k].index_select(-1, self._lanes_t)
                    for k in OUT_KEYS}
        if i == 0:
            self._first_outs = outs
        if i == 1:
            self._first_state = before
        self._last = (i, before, outs)
        self.i += 1
        return fold

    def warm(self):
        self.step(1)

    def step(self, n: int) -> list:
        acc = None
        for _ in range(n):
            f = self._segment()
            acc = f if acc is None else acc + f
        with record_function("bench.ack_readback"):
            v = float(acc)
        if v != v:
            raise RuntimeError(f"segment {self.i - 1}'s ack fold is NaN")
        return []

    def counters(self) -> dict:
        return {}

    def _task(self, lane_k: int, segs, state) -> dict:
        xs = np.stack([self.x_lanes[..., lane_k] ^ i for i in segs])
        return {"spec": self.ctx.spec, "block": self.block, "xs": xs,
                "state": state,
                "tenant": None if self.tenants is None
                else self.tenants[lane_k]}

    def collect(self):
        end = _host(_lane_state(self._get_state(), self._state_t))
        first_state = (end if self._first_state is None
                       else _host(self._first_state))
        i_last, before, last_outs = self._last
        before = _host(before)
        L = len(self.lanes)
        tasks = [self._task(k, [0], None) for k in range(L)]
        tasks += [self._task(k, [i_last],
                             {f: v[..., k] for f, v in before.items()})
                  for k in range(L)]
        checks = [
            {"prog": {"outs": [_host(self._first_outs)],
                      "state": first_state}, "tasks": list(range(L))},
            {"prog": {"outs": [_host(last_outs)], "state": end},
             "tasks": list(range(L, 2 * L))}]
        return checks, tasks
