"""Benchmark: aggregate real-time factor of the full DSPi chain on one card.

The twin of the JAX package's ``bench.py`` on the PyTorch port.  Headline
metric: audio-seconds processed a wall second on one card for the full
11-channel chain at 48 kHz (``configs.full_chain_config``: 10-band PEQ on
every channel, ISO 226 loudness, the leveller with 10 ms lookahead, BS2B
crossfeed, the 2x9 matrix, per-output EQ + gains + delays, s24 conversion
and the 256x delta-sigma PDM sub), on the port's default lowering (block
matmuls for the float chain).  The firmware runs it at RTF 1.0.

Run:  python -m dspi_tpu_torch.bench [--cpu]

Prints the card's name and power limit, then as its last line ONE JSON
object with the keys of the JAX package's benchmark (``metric``,
``value``, ``unit``, ``vs_baseline``).  Without ``--cpu`` everything runs
on the card and raises without one.

Env knobs (the JAX package's): DSPI_BENCH_STREAMS (16384),
DSPI_BENCH_PACKETS (128), DSPI_BENCH_ITERS (8), DSPI_BENCH_DEPTH (8),
DSPI_BENCH_PLATFORM (rp2350) and DSPI_BENCH_FULL, which adds the config
sweep (passthrough, 10-band PEQ, the 96 kHz chain at half the packets,
the Q28 chain) and writes it to ``chiprun_out/bench_details.json`` under
the checkout.  DSPI_BENCH_UNROLL has no counterpart: it sets the unroll
of an XLA scan, and the port has no XLA scan.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .chain import Engine
from .configs import full_chain_config
from .core.constants import Platform
from .runtime.executor import ack_fold

DETAILS = Path(__file__).resolve().parent.parent / "chiprun_out" / \
    "bench_details.json"


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them (or the
    CPU's name for a CPU run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "device: cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return f"card: {out or torch.cuda.get_device_name(device)}"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_input(n_streams: int, n_packets: int, block: int, schedule,
                device) -> torch.Tensor:
    """The benchmark's input, the JAX package's numbers
    (``default_rng(7)``): int32 [n_packets, 2, block, B], or [2,
    sum(schedule), B] with a schedule."""
    rng = np.random.default_rng(7)
    shape = ((2, sum(schedule), n_streams) if schedule
             else (n_packets, 2, block, n_streams))
    x = rng.integers(-16000, 16000, size=shape).astype(np.int32)
    return torch.from_numpy(x).to(device)


def chained_segments(seg, params, state, x, pm, depth: int, pre=None,
                     vary=None, keep: list | None = None):
    """``depth`` chained segments of the segment processor ``seg`` from
    ``state`` (which is not modified): segment i takes ``vary(x, i)``,
    by default ``x ^ i`` (one elementwise op, so every segment sees a
    fresh input), through ``pre`` where given, and the state it leaves
    carries into the next.  Returns (the last state, one device scalar:
    the sum of every segment's ``ack_fold``), so one readback of the
    scalar forces every segment.  ``keep`` collects each segment's
    outputs."""
    acc = None
    for i in range(depth):
        xi = x ^ i if vary is None else vary(x, i)
        state, out = seg(params, state, xi if pre is None else pre(xi), pm)
        f = ack_fold(out)
        acc = f if acc is None else acc + f
        if keep is not None:
            keep.append(out)
    return state, acc


def bench_engine(cfg, n_streams, n_packets, iters, pdm=True, block=None,
                 depth=None, schedule=None, wire=False, device=None):
    """Chained throughput and one segment's latency, as the JAX package's
    ``bench_engine`` measures them.

    Honesty rules: ``depth`` chained segments carry state, each on a
    different input (``x ^ i``), and every segment's outputs fold into one
    device scalar whose single readback forces all of them; RTF is
    ``depth * audio_s / wall``, best of ``iters`` (at least 2).  The
    engine's state is snapshotted after the warm-up and restored before
    each timed run, outside the timed window, so every timed run starts
    from the same state and must give the same fold: a run that differs
    fails the benchmark (the port's ``Engine`` carries its state, where the
    JAX package's benchmark reruns one functional state).  The secondary
    figure is one fully synchronous segment's latency.

    Returns (rtf, latency_s)."""
    depth = depth or int(os.environ.get("DSPI_BENCH_DEPTH", 8))
    block = block or (96 if cfg.sample_rate == 96000 else 48)
    eng = Engine(cfg, n_streams=n_streams, block_size=block, emit="reduced",
                 pdm=pdm, pdm_fade=False, schedule=schedule, wire=wire,
                 device=device)
    dev = eng.device
    if schedule:
        n_packets = len(schedule)
        n_samples = sum(schedule)
    else:
        n_samples = n_packets * block
    x = bench_input(n_streams, n_packets, block, schedule, dev)
    pm = torch.ones(n_packets, dtype=torch.float32, device=dev)

    def chained():
        eng.state, acc = chained_segments(eng.segment_fn, eng.params,
                                          eng.state, x, pm, depth)
        return float(acc)

    chained()                                           # build + warm
    snap = eng.state           # the segment processor never modifies it
    audio_sec = n_streams * n_samples / cfg.sample_rate
    best, first = float("inf"), None
    for _ in range(max(iters, 2)):
        eng.state = snap
        sync(dev)
        t0 = time.perf_counter()
        got = chained()
        best = min(best, (time.perf_counter() - t0) / depth)
        if got != got:
            raise RuntimeError("the benchmark's fold is NaN")
        first = got if first is None else first
        if got != first:
            raise RuntimeError(
                f"a timed run folded to {got!r}, the first to {first!r}: "
                "the chain is not deterministic from the same state")

    # one segment, fully synchronous (secondary metric)
    float(ack_fold(eng.process(x)))
    sync(dev)
    t0 = time.perf_counter()
    float(ack_fold(eng.process(x)))
    latency = time.perf_counter() - t0
    return audio_sec / best, latency


def merge_details(path: Path, entries: dict) -> None:
    """Merge ``entries`` into the JSON record at ``path`` atomically; a
    corrupt record aborts rather than being reset."""
    try:
        merged = json.loads(path.read_text())
    except FileNotFoundError:
        merged = {}
    except ValueError as e:
        raise RuntimeError(f"{path} is not valid JSON ({e}); remove it "
                           "before merging new entries") from e
    merged.update(entries)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(merged, indent=2))
    os.replace(tmp, path)


def sweep(platform, B: int, NPKT: int, ITERS: int, device) -> dict:
    """The DSPI_BENCH_FULL config sweep (the JAX package's, bench.py)."""
    from .core.constants import FilterType
    from .params.types import DeviceConfig, EqBand

    details = {}
    c1 = DeviceConfig(platform=platform)          # passthrough + defaults
    c1.eq = None
    c1.__post_init__()
    details["cfg1_passthrough"] = {"rtf": bench_engine(
        c1, B, NPKT, ITERS, pdm=False, device=device)[0]}

    c2 = DeviceConfig(platform=platform)
    for ch in (0, 1):
        for b in range(10):
            c2.eq[ch][b] = EqBand(FilterType.PEAKING, 100.0 * (b + 1), 1.5,
                                  2.0)
    rtf2 = bench_engine(c2, B, NPKT, ITERS, pdm=False, device=device)[0]
    details["cfg2_peq10"] = {"rtf": rtf2,
                             "peq_bands_per_sec": rtf2 * 2 * 10 * 48000}

    # block=96 doubles the segment length; half the packets keep the
    # footprint of the 48 kHz configs
    c5 = full_chain_config(platform, sample_rate=96000.0)
    details["cfg5_full_96k"] = {"rtf": bench_engine(
        c5, B, max(NPKT // 2, 1), ITERS, device=device)[0]}

    cq = full_chain_config(Platform.RP2040)
    details["full_chain_48k_q28"] = {"rtf": bench_engine(
        cq, B, NPKT, ITERS, device=device)[0]}
    return details


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    platform = {"rp2350": Platform.RP2350, "rp2040": Platform.RP2040}[
        os.environ.get("DSPI_BENCH_PLATFORM", "rp2350")]
    B = int(os.environ.get("DSPI_BENCH_STREAMS", 16384))
    NPKT = int(os.environ.get("DSPI_BENCH_PACKETS", 128))
    ITERS = int(os.environ.get("DSPI_BENCH_ITERS", 8))

    cfg = full_chain_config(platform)
    rtf, dt = bench_engine(cfg, B, NPKT, ITERS, device=device)
    dev = torch.device(device or "cuda")
    details = {"full_chain_48k": {
        "rtf": rtf, "streams": B, "packets": NPKT, "seg_wall_s": dt,
        "platform": platform.value, "device": card_line(dev)}}
    if os.environ.get("DSPI_BENCH_FULL"):
        details.update(sweep(platform, B, NPKT, ITERS, device))
        merge_details(DETAILS, details)
        print(json.dumps(details), flush=True)

    print(f"one segment, synchronous: {1e3 * dt:.3f} ms", flush=True)
    print(card_line(dev), flush=True)
    print(json.dumps({
        "metric": "full 11-channel chain RTF @48kHz (audio-sec/sec/card)",
        "value": round(rtf, 1),
        "unit": "x realtime",
        "vs_baseline": round(rtf, 1),       # the firmware's RTF is 1.0
    }), flush=True)
    return details


if __name__ == "__main__":
    main()
