"""Per-stage benchmarks on one card: where does the time go?

The twin of the JAX package's ``bench_stages.py`` on the PyTorch port.

Usage:  python -m dspi_tpu_torch.bench_stages [stage ...] [--cpu]
Stages: pdm pdm_sweep chain wire wire_q28 nopdm passthrough peq full96 q28
        grouped hetero grouped_q28 hetero_q28 deframe deframe24 sched441
        sched441_q28 (default: pdm chain nopdm passthrough peq)
Env:    DSPI_BENCH_STREAMS (8192), DSPI_BENCH_PACKETS (64),
        DSPI_BENCH_ITERS (6), DSPI_BENCH_DEPTH (8), DSPI_BENCH_COMMIT

Every timed call ends in a read of a scalar that depends on each
segment's outputs (``timeit``; the chain stages through
``bench.bench_engine``).  ``pdm_sweep`` sweeps the lane count only: the
JAX package's ``unroll`` and ``impl`` are choices of its Pallas kernel
with no counterpart here.  ``grouped``/``grouped_q28`` feed the engine's
native flat lane layout (every group's lanes contiguous), the layout of
both of the port's grouped layouts.  ``full96`` prints the card's peak
memory: the port applies the 96 kHz blocks without the JAX package's
x-chunking.  Results go to stdout as one JSON object and, under
DSPI_BENCH_COMMIT, into ``chiprun_out/bench_details.json`` under the
checkout.  Without ``--cpu`` everything runs on the card and raises
without one.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .bench import (DETAILS, bench_engine, card_line, chained_segments,
                    merge_details, sync)
from .configs import full_chain_config, hetero_variants
from .core.constants import FilterType, Platform

RATE = 48000.0
STAGES = ("pdm", "pdm_sweep", "chain", "wire", "wire_q28", "nopdm",
          "passthrough", "peq", "full96", "q28", "grouped", "hetero",
          "grouped_q28", "hetero_q28", "deframe", "deframe24", "sched441",
          "sched441_q28")
_M32 = 0xFFFFFFFF


# the 44.1 kHz packet cadence, nine 44s then a 45 (441 samples every 10
# ms), 13 times: 130 packets, 5733 samples
SCHED441 = ((44,) * 9 + (45,)) * 13


class Settings(NamedTuple):
    """A run's sizes.  ``sweep_widths``: pdm_sweep's lane counts;
    ``pdm_chain``: the PDM stages' chained segments a call;
    ``schedule``: the 44.1 kHz stages' packet sizes."""

    B: int = 8192
    NPKT: int = 64
    ITERS: int = 6
    DEPTH: int = 8
    device: object = None
    sweep_widths: tuple = (8192, 16384, 32768, 65536)
    pdm_chain: int = 8
    schedule: tuple = SCHED441


def settings_from_env(device=None) -> Settings:
    e = os.environ
    return Settings(B=int(e.get("DSPI_BENCH_STREAMS", 8192)),
                    NPKT=int(e.get("DSPI_BENCH_PACKETS", 64)),
                    ITERS=int(e.get("DSPI_BENCH_ITERS", 6)),
                    DEPTH=int(e.get("DSPI_BENCH_DEPTH", 8)), device=device)


def timeit(fn, S: Settings) -> float:
    """Pipelined: enqueue ``S.DEPTH`` calls of ``fn`` (each returns a
    device scalar), read every scalar at the end; best wall a call over
    ``S.ITERS`` rounds, after two warm-up calls."""
    float(fn())
    float(fn())
    best = float("inf")
    for _ in range(S.ITERS):
        t0 = time.perf_counter()
        scalars = [fn() for _ in range(S.DEPTH)]
        for s in scalars:
            float(s)
        best = min(best, (time.perf_counter() - t0) / S.DEPTH)
    return best


def _device(S: Settings) -> torch.device:
    from .chain.pack import resolve_device

    return resolve_device(S.device)


def bench_pdm(S: Settings, b=None, t=None):
    """The PDM kernel alone (``kernels.pdm_cuda.pdm_segment``): Q28 [T, B]
    -> words.  ``chain_k`` segments run chained a call (state carried,
    input ``x ^ i``), the words of each summed mod 2^32 and xor-folded
    into one scalar with the final state, so one read forces all of
    them.  ``chain_k`` is ``S.pdm_chain``.  Returns (rtf, wall a call)."""
    from .chain.pack import ChainState
    from .kernels.pdm_cuda import pdm_segment

    b = b or S.B
    t = t or S.NPKT * 48
    chain_k = S.pdm_chain
    dev = _device(S)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-(1 << 27), 1 << 27, size=(t, b))
                         .astype(np.int32)).to(dev)

    def zi(*s):
        return torch.zeros(s, dtype=torch.int32, device=dev)

    st = dict(pdm_err=zi(b), pdm_err2=zi(b), pdm_ns=zi(5, b),
              pdm_rng=torch.full((b,), 123456789, dtype=torch.int32,
                                 device=dev),
              pdm_fade=torch.full((b,), 1024, dtype=torch.int32, device=dev))
    state0 = ChainState(**st, **{f: None for f in ChainState._fields
                                 if f not in st})

    def run():
        s, acc = state0, None
        for i in range(chain_k):
            s, words = pdm_segment(s, x ^ i)
            w = words.sum(dtype=torch.int64) & _M32
            acc = w if acc is None else acc ^ w
        acc = acc ^ (s.pdm_rng[0].to(torch.int64) & _M32) \
            ^ (s.pdm_err[0].to(torch.int64) & _M32)
        return acc.to(torch.float32)

    best = timeit(run, S)
    return chain_k * b * t / RATE / best, best


def bench_grouped(S: Settings, k=8, g=None, npkt=None, platform=None):
    """Homogeneous-structure grouped serving: K configs x G streams on one
    flat lane axis (the reference for the hetero ratio).  Returns (rtf,
    wall a call of ``S.DEPTH`` chained segments)."""
    from .chain.grouped import GroupedEngine

    g = g or S.B // k
    npkt = npkt or S.NPKT
    eng = GroupedEngine(hetero_variants(k, platform or Platform.RP2350),
                        streams_per_group=g, emit="reduced", pdm=True,
                        pdm_fade=False, device=S.device)
    rng = np.random.default_rng(5)
    x = rng.integers(-16000, 16000,
                     size=(k, npkt, 2, 48, g)).astype(np.int32)
    # the engine's native input: one [.., K*G] lane axis, group blocks
    # contiguous (serving callers hold flat buffers)
    x = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, 0, -2).reshape(npkt, 2, 48, k * g))).to(eng.device)
    pm = torch.ones(npkt, dtype=torch.float32, device=eng.device)
    seg, params, state = eng.flat_segment_fn, eng.params, eng.state

    best = timeit(lambda: chained_segments(
        seg, params, state, x, pm, S.DEPTH)[1], S)
    return S.DEPTH * k * g * npkt * 48 / RATE / best, best


def bench_hetero(S: Settings, k=8, b=None, npkt=None, platform=None):
    """An arbitrary per-stream config mix: k configs scattered over b
    streams, bucketed by ``HeteroServer`` (input and outputs in the
    caller's stream order).  Returns (rtf, wall, padding_waste)."""
    from .chain.grouped import HeteroServer

    b = b or S.B
    npkt = npkt or S.NPKT
    rng = np.random.default_rng(5)
    ids = rng.integers(0, k, size=b)
    srv = HeteroServer(hetero_variants(k, platform or Platform.RP2350), ids,
                       emit="reduced", pdm=True, pdm_fade=False,
                       device=S.device)
    x = torch.from_numpy(rng.integers(
        -16000, 16000, size=(npkt, 2, 48, b)).astype(np.int32)).to(srv.device)
    pm = torch.ones(npkt, dtype=torch.float32, device=srv.device)
    seg, params, state = srv.segment_fn, srv.params, srv.state

    best = timeit(lambda: chained_segments(
        seg, params, state, x, pm, S.DEPTH)[1], S)
    return S.DEPTH * b * npkt * 48 / RATE / best, best, srv.padding_waste


def bench_deframe(S: Settings, bit_depth=16, b=None, npkt=None) -> dict:
    """The marginal cost on the card of the USB deframe: the raw payload
    lies on the card and the same chained program runs twice, once
    deframing each segment's payload (``kernels/deframe.py``, the runner's
    ``pre`` hook) and once on planes deframed beforehand, so the upload
    cancels out and the difference is the unpack's own cost (firmware:
    usb_audio.c:591-686 float, :997-1006 Q28 byte assembly)."""
    from .chain import Engine
    from .kernels.deframe import deframe_s16, deframe_s24

    b = b or S.B
    npkt = npkt or S.NPKT
    eng = Engine(full_chain_config(Platform.RP2350), n_streams=b,
                 emit="reduced", pdm=True, pdm_fade=False,
                 bit_depth=bit_depth, device=S.device)
    dev = eng.device
    pm = torch.ones(npkt, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(11)
    frames = npkt * 48
    if bit_depth == 24:
        payload = torch.from_numpy(rng.integers(
            0, 256, size=(b, frames * 6)).astype(np.uint8)).to(dev)

        def pre(p):
            return deframe_s24(p, npkt, 48)

        def vary(p, i):
            return p ^ (i % 251)
    else:
        payload = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=(b, frames),
            dtype=np.int64).astype(np.int32)).to(dev)

        def pre(p):
            return deframe_s16(p, npkt, 48)

        vary = None
    x0 = pre(payload)
    seg, params, state = eng.segment_fn, eng.params, eng.state

    w_framed = timeit(lambda: chained_segments(
        seg, params, state, payload, pm, S.DEPTH, pre=pre, vary=vary)[1], S)
    w_planes = timeit(lambda: chained_segments(
        seg, params, state, x0, pm, S.DEPTH)[1], S)
    delta = w_framed - w_planes
    return {
        "bit_depth": bit_depth,
        "wall_deframe_chain": w_framed,
        "wall_chain_alone": w_planes,
        "deframe_ms_per_segment": delta * 1e3 / S.DEPTH,
        "deframe_pct_of_chain": 100.0 * delta / w_planes,
        "deframe_ps_per_sample": delta / S.DEPTH / (frames * b) * 1e12,
    }


def bench_sched441(S: Settings, b=None, platform=None) -> float:
    """The full chain at 44.1 kHz on the firmware's packet cadence
    (``S.schedule``, by default ``SCHED441``)."""
    cfg = full_chain_config(platform or Platform.RP2350, sample_rate=44100.0)
    rtf, _ = bench_engine(cfg, b or S.B, None, S.ITERS, depth=S.DEPTH,
                          schedule=S.schedule, device=S.device)
    return rtf


def _engine_stage(S: Settings, cfg, **kw) -> dict:
    rtf, dt = bench_engine(cfg, S.B, S.NPKT, S.ITERS, depth=S.DEPTH,
                           device=S.device, **kw)
    return {"rtf": rtf, "wall": dt}


def run_stage(s: str, S: Settings) -> dict:
    """One stage: its entries of the output record (the JAX package's keys),
    each printed as it is measured."""
    from .params.types import DeviceConfig, EqBand

    P = Platform
    if s == "pdm":
        rtf, dt = bench_pdm(S)
        return {"pdm_alone": {"rtf": rtf, "wall": dt}}
    if s == "pdm_sweep":
        out = {}
        for b in S.sweep_widths:
            rtf, dt = bench_pdm(S, b=b)
            out[f"pdm_B{b}"] = {"rtf": rtf, "wall": dt}
            print(f"pdm B={b}: {rtf:.0f}x", flush=True)
        return out
    if s == "chain":
        return {"full_chain": _engine_stage(S, full_chain_config(P.RP2350))}
    if s == "wire":
        # the full chain with the device wire words (S/PDIF subframes of
        # all four pairs)
        return {"full_chain_wire": _engine_stage(
            S, full_chain_config(P.RP2350), wire=True)}
    if s == "wire_q28":
        return {"full_chain_wire_q28": _engine_stage(
            S, full_chain_config(P.RP2040), wire=True)}
    if s == "nopdm":
        return {"chain_no_pdm": _engine_stage(
            S, full_chain_config(P.RP2350), pdm=False)}
    if s == "passthrough":
        c1 = DeviceConfig(platform=P.RP2350)
        c1.eq = None
        c1.__post_init__()
        return {"passthrough": _engine_stage(S, c1, pdm=False)}
    if s == "peq":
        c2 = DeviceConfig(platform=P.RP2350)
        for ch in (0, 1):
            for b_ in range(10):
                c2.eq[ch][b_] = EqBand(FilterType.PEAKING, 100.0 * (b_ + 1),
                                       1.5, 2.0)
        return {"peq10": _engine_stage(S, c2, pdm=False)}
    if s == "full96":
        dev = _device(S)
        if dev.type == "cuda":
            sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        r = _engine_stage(S, full_chain_config(P.RP2350, sample_rate=96000.0))
        r["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None)
        r["streams"], r["samples"] = S.B, S.NPKT * 96
        print(f"full96: {S.B} streams x {S.NPKT}x96 samples, RTF "
              f"{r['rtf']:.1f}x, peak memory "
              + ("not measured (CPU)" if r["peak_gb"] is None
                 else f"{r['peak_gb']:.2f} GB"), flush=True)
        return {"full_96k": r}
    if s == "q28":
        return {"full_chain_q28": _engine_stage(
            S, full_chain_config(P.RP2040))}
    if s in ("grouped", "grouped_q28"):
        plat = P.RP2040 if s.endswith("q28") else P.RP2350
        rtf, dt = bench_grouped(S, platform=plat)
        print(f"{s} 8x{S.B // 8}: {rtf:.0f}x", flush=True)
        return {"grouped_k8" + ("_q28" if plat is P.RP2040 else ""):
                {"rtf": rtf, "wall": dt}}
    if s in ("hetero", "hetero_q28"):
        plat = P.RP2040 if s.endswith("q28") else P.RP2350
        rtf, dt, waste = bench_hetero(S, platform=plat)
        print(f"{s} 8 cfgs across {S.B}: {rtf:.0f}x (padding "
              f"{100 * waste:.1f}%)", flush=True)
        key = "hetero_k8_q28" if plat is P.RP2040 else "hetero_k8_scattered"
        return {key: {"rtf": rtf, "wall": dt, "padding_waste": waste}}
    if s in ("deframe", "deframe24"):
        bits = 24 if s == "deframe24" else 16
        d = bench_deframe(S, bits)
        print(f"deframe s{bits} on the card: "
              f"{d['deframe_ms_per_segment']:.2f} ms/segment = "
              f"{d['deframe_pct_of_chain']:.1f}% of the chain", flush=True)
        return {"deframe_dev_resident" + ("_s24" if bits == 24 else ""): d}
    if s in ("sched441", "sched441_q28"):
        plat = P.RP2040 if s.endswith("q28") else P.RP2350
        rtf = bench_sched441(S, platform=plat)
        print(f"44.1k sched full chain ({plat.value}): {rtf:.0f}x",
              flush=True)
        return {"full_44k1_sched" + ("_q28" if plat is P.RP2040 else ""):
                {"rtf": rtf}}
    raise ValueError(f"unknown stage {s!r}; stages: {' '.join(STAGES)}")


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    stages = [a for a in argv if not a.startswith("--")] or [
        "pdm", "chain", "nopdm", "passthrough", "peq"]
    S = settings_from_env("cpu" if "--cpu" in argv else None)
    dev = _device(S)
    out = {"B": S.B, "NPKT": S.NPKT, "DEPTH": S.DEPTH,
           "device": card_line(dev)}
    print(out["device"], flush=True)
    for s in stages:
        t0 = time.time()
        out.update(run_stage(s, S))
        print(f"[{s}] done in {time.time() - t0:.0f}s", flush=True)

    print(json.dumps(out, indent=2), flush=True)
    if os.environ.get("DSPI_BENCH_COMMIT"):
        entries = {k: v for k, v in out.items()
                   if k not in ("B", "NPKT", "DEPTH", "device")}
        merge_details(DETAILS, entries)
        print(f"merged {len(entries)} entries into {DETAILS}", flush=True)
    return out


if __name__ == "__main__":
    main()
