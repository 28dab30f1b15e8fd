#!/usr/bin/env python
"""Where one full-width segment of the port's main path spends its time.

    python3 profile_torch.py [rp2350|rp2040|rp2040_hetero|rp2040_44k1|
                              rp2350_wire|rp2350_44k1|rp2350_hetero|
                              rp2350_serve|rp2350_scan|rp2350_scan_hetero]

Runs one full-width path on one CUDA card (emit "reduced", PDM on): the
headline chain of the platform (default rp2350: the float chain; rp2040:
the Q28 chain; 48 kHz, full_chain_config) at 16384 streams x 128 packets of
48 samples; rp2350_wire: the float chain with the device wire words
(wire=True, examples/serve.py's engine); *_hetero: a HeteroServer over 8
configs of one structure (configs.hetero_variants) scattered over the same
16384 streams; *_44k1: the chain at 44.1 kHz, 16384 streams x 130 packets
on the 44/45 cadence (5733 samples); rp2350_scan*: the float chain (and
its hetero server) on the scan lowering (mxu=False: the float cascade and
crossfeed kernels; the hetero server in the flat per-lane layout).  It
warms up, then traces one
segment with torch.profiler (CPU and CUDA activity).
Prints the card, the segment's wall time, the number of device kernels and
their summed time, the device's idle share (1 - kernel time / wall), and
the ops with the most device time; writes the full table to
chiprun_out/profile_<path>.txt.  Then reads the same profile through the
benchmark's reduction of the program's spans (benchmark/spans.py): for
each span (dspi.segment and its phases, dspi.q15_mul, the bucket gathers,
the ack fold; "host" outside them) its host self time and the part of it
spent waiting for the device, the device time, count and uploads of the
operations it launched, and the idle time in gaps that began in it.  rp2350_serve traces one batch of the serving entry point
instead (dspi_tpu_torch.serve's serve_chained --framed-dev: the wire
engine under a ChainedRunner, 8 chained segments of 32 packets deframed
on the card from uploaded s16 payload words, one readback): its upload,
kernels, idle share and spans.  With
wire words (rp2350_wire), it then traces the wire stage alone on one
segment's arguments: its kernels and their device time, and the bytes its
torch ops move, in passes of a channel pair's [2, T, B] int32 plane.

Last, it counts the instructions of each CUDA kernel's per-sample loop in
the SASS of the built libraries (cuobjdump), by opcode and by pipe (the
integer multiply-adds, IMAD*, issue to the FMA pipe; the other per-thread
arithmetic to the integer ALU), in all and a sample (the loop's samples
an iteration from its global loads, or from its stores where it reads
shared memory, or, for each float cascade instance the path loaded, from
its cp.async copies, one a step of its skewed loop), which checks the
operation counts that chip_smoke.py's bounds assume; the SASS goes to
chiprun_out/<lib>_sass.txt.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

STREAMS, PACKETS, BLOCK = 16384, 128, 48
SCHED441 = ((44,) * 9 + (45,)) * 13
PATHS = ("rp2350", "rp2040", "rp2040_hetero", "rp2040_44k1", "rp2350_wire",
         "rp2350_44k1", "rp2350_hetero", "rp2350_serve", "rp2350_scan",
         "rp2350_scan_hetero")
SERVE_DEPTH, SERVE_PACKETS = 8, 32
# (library, a piece of the kernel's mangled name, label, the memory op
# that counts the loop's samples, its count a sample): the cascade
# kernel's instantiations <NB, LOUD, ENV> that the paths launch (the
# schedule mode runs the uniform instances, the per-lane mode
# lane_kernel); the crossfeed reads its inputs from shared memory and
# stores two words a sample.  The float cascade kernel is one library a
# band-kinds signature: loop_ops counts each one the path loaded, a sample
# being a step of its skewed loop (one cp.async each).  The leveller's gain
# kernel walks packets, not samples, and stores one word a packet (its
# uniform-packet instances, the cells'); its sample kernel stores two
# words a sample (the float and the Q28 instance of each, by the mangled
# names of their template arguments)
_LOOPS = (("pdm", "pdm_kernel", "pdm", "ldg", 1),
          ("eq_q28", "cascade_kernelILi10ELb1ELb1EE",
           "eq master <10,1,1>", "ldg", 1),
          ("eq_q28", "cascade_kernelILi10ELb0ELb0EE",
           "eq output <10,0,0>", "ldg", 1),
          ("eq_q28", "lane_kernelILi10ELb1ELb1EE",
           "eq master lane_cf <10,1,1>", "ldg", 1),
          ("eq_q28", "lane_kernelILi10ELb0ELb0EE",
           "eq output lane_cf <10,0,0>", "ldg", 1),
          ("xf_q28", "xf_kernel", "xf", "stg", 2),
          ("xf_f32", "xf_kernel", "xf_f32", "stg", 2),
          ("lev", "5FloatELb0E", "lev_gain float (a packet)", "stg", 1),
          ("lev", "3Q28ELb0E", "lev_gain q28 (a packet)", "stg", 1),
          ("lev", "9FloatRampE", "lev_apply float", "stg", 2),
          ("lev", "7Q28RampE", "lev_apply q28", "stg", 2))


def span_table(prof, segments: int) -> None:
    """Print the profile's time by program span, through the benchmark's
    reduction (the step must lie in a ``bench.window`` span)."""
    from benchmark import spans

    tr = spans.from_profiler(prof, segments)
    print(f"by span over {tr.window_s * 1e3:.3f} ms ({segments} segments, "
          f"{tr.launches()} device operations): host self ms, of it "
          f"waiting ms, device ms, launches, uploads, idle ms")
    for name, host, wait, dev, n, up, idle in spans.span_table(tr):
        print(f"  {name:18s} {host:10.3f} {wait:10.3f} {dev:10.3f} {n:7d} "
              f"{up:5d} {idle:10.3f}")
    for k, read in spans.READINGS.items():
        print(f"  {k}: {read(tr)}")


def loop_ops(out: Path) -> None:
    """Print the opcode counts of each kernel's sample loop (the longest
    innermost backward branch's body) in the SASS of the built libraries,
    and the same a sample."""
    from dspi_tpu_torch.kernels import build, eq_f32_cuda

    sass = {}
    loops = list(_LOOPS)
    for sig in eq_f32_cuda.loaded():
        kinds, loud, env, lane = eq_f32_cuda.unpack_signature(sig)
        lib = f"eq_f32_{sig:x}"
        sass[lib] = build.sass("eq_f32", build.SRC_DIR,
                               eq_f32_cuda.defines(sig))
        (out / f"{lib}_sass.txt").write_text(sass[lib])
        loops.append((lib, "cascade_kernel",
                      f"eq_f32 {sig:#x} (kinds {kinds}, loudness {loud}, "
                      f"envelope {env}, per lane {lane})", "ldgsts", 1))
    for lib, pattern, label, op, per in loops:
        if lib not in sass:
            sass[lib] = build.sass(lib)
            (out / f"{lib}_sass.txt").write_text(sass[lib])
        c = build.loop_counts(sass[lib], pattern)
        ps = build.per_sample(c, op, per)
        top = sorted(c["hist"].items(), key=lambda kv: -kv[1])[:16]
        print(f"{label} SASS: sample loop 0x{c['head']:x}-0x{c['end']:x}, "
              f"{ps['samples_per_iteration']:g} samples an iteration, "
              f"{c['instructions']} instructions, {c['imad'] + c['alu']} "
              f"per-thread arithmetic (not control, memory, uniform or "
              f"special): IMAD* {c['imad']}, integer ALU {c['alu']} "
              f"({c['alu_only']} of them ALU-only); a sample "
              f"{ps['arith']:g} arithmetic, {ps['alu_only']:g} ALU-only; "
              f"LDG {c['ldg']}, LDS {c['lds']}, LDGSTS {c['ldgsts']}, STG "
              f"{c['stg']}; scheduled stalls {c['stall']} clocks; by opcode "
              f"{top}")


def wire_trace(eng, x) -> None:
    """The wire stage of one segment alone, on the arguments the segment
    gives it: its device kernels (count and summed time, torch.profiler)
    and the bytes its torch ops read and write (each operand's and each
    result's storage, from a dispatch trace of the same call; views move
    none), also in
    passes of one [2, T, B] int32 plane (a channel pair)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from dspi_tpu_torch.chain import pipeline

    fn, saved = pipeline._wire_stage, {}

    def grab(static, st, s24, *rest):
        saved.update(static=static, st=st, s24=s24, rest=rest)
        return fn(static, st, s24, *rest)

    pipeline._wire_stage = grab
    try:
        eng.process(x)
    finally:
        pipeline._wire_stage = fn

    def call():
        Ttot, _, *rest = saved["rest"]
        return fn(saved["static"], saved["st"], saved["s24"], Ttot, {},
                  *rest)

    class Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view:                 # an alias: moves no bytes
                return out
            self.ops += 1
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += min(t.untyped_storage().nbytes(),
                                      t.numel() * t.element_size())
            return out

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    n = sum(e.count for e in kernels)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    with Bytes() as b:
        call()
    plane = 2 * x.shape[-1] * saved["rest"][0] * 4
    print(f"wire stage alone ({len(saved['static'].wire)} pairs, slots "
          f"{saved['static'].wire}): {n} kernels, device time {dev_ms:.3f} "
          f"ms; {b.ops} torch ops moving {b.bytes / 1e9:.3f} GB (operands "
          f"and results), {b.bytes / plane:.1f} passes of a [2, T, B] "
          f"int32 pair plane ({plane / 1e6:.1f} MB), "
          f"{b.bytes / plane / len(saved['static'].wire):.1f} a pair; "
          f"{b.bytes / max(dev_ms, 1e-9) / 1e9:.3f} TB/s over the "
          f"kernels' time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"  wire kernel x{e.count}: "
              f"{e.self_device_time_total / 1e3:.3f} ms  {e.key[:90]}")


def _path(path, dev):
    """(engine, one segment's input) of a path."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, HeteroServer
    from dspi_tpu_torch.configs import full_chain_config, hetero_variants

    kw = dict(emit="reduced", pdm=True, pdm_fade=False, device=dev,
              mxu="_scan" not in path)
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (PACKETS, 2, BLOCK, STREAMS)
    platform = Platform(path.split("_")[0])
    if path.endswith("_hetero"):
        ids = np.random.default_rng(5).integers(0, 8, STREAMS)
        eng = HeteroServer(hetero_variants(8, platform), ids,
                           block_size=BLOCK, **kw)
    elif path.endswith("_44k1"):
        eng = Engine(full_chain_config(platform, 44100.0),
                     n_streams=STREAMS, schedule=SCHED441, **kw)
        shape = (2, sum(SCHED441), STREAMS)
    else:
        eng = Engine(full_chain_config(platform), n_streams=STREAMS,
                     block_size=BLOCK, wire=path.endswith("_wire"), **kw)
    x = torch.randint(-16000, 16000, shape, generator=gen,
                      dtype=torch.int32, device=dev)
    return eng, x


def _serve_batch(dev):
    """(run one batch, the batch's audio-seconds): serve_chained's
    --framed-dev engine and runner at full width, fed s16 payload words
    that are uploaded each batch."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.kernels.deframe import make_pre
    from dspi_tpu_torch.runtime.executor import ChainedRunner

    eng = Engine(full_chain_config(Platform.RP2350), n_streams=STREAMS,
                 block_size=BLOCK, emit="reduced", pdm=True, pdm_fade=False,
                 wire=True, device=dev)
    runner = ChainedRunner(eng, depth=SERVE_DEPTH,
                           pre=make_pre(SERVE_PACKETS, BLOCK))
    words = np.random.default_rng(0).integers(
        -2**31, 2**31, size=(SERVE_DEPTH, STREAMS, SERVE_PACKETS * BLOCK),
        dtype=np.int64).astype(np.int32)

    def batch():
        runner.feed(torch.from_numpy(words).to(dev))
        runner.drain()

    return batch, SERVE_DEPTH * SERVE_PACKETS * BLOCK / 48000.0


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "rp2350"
    if path not in PATHS:
        raise SystemExit(f"unknown path {path}: one of {', '.join(PATHS)}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import WINDOW

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    if path == "rp2350_serve":
        run, audio_s = _serve_batch(dev)
        warm = (run, run)
        segments = SERVE_DEPTH
        what = (f"batch of {SERVE_DEPTH} x {SERVE_PACKETS} packets "
                f"({audio_s * 1e3:.0f} ms of audio a stream)")
    else:
        segments = 1
        eng, x = _path(path, dev)
        warm = [functools.partial(eng.process, x ^ i) for i in range(2)]
        run = functools.partial(eng.process, x ^ 2)
        what = f"segment {tuple(x.shape[:-1])}"
    for fn in warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    copies = [e for e in kernels if "memcpy" in e.key.lower()]
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"profile_{path}.txt").write_text(
        f"card: {card}\nwall {wall * 1e3:.3f} ms\n{table}\n")
    print(f"card: {card}")
    print(f"{path} {what}, {STREAMS} streams: wall {wall * 1e3:.3f} ms "
          f"(profiled), {n_kernels} kernels, device kernel time "
          f"{dev_us / 1e3:.3f} ms, idle share "
          f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}; of them copies "
          f"{sum(e.count for e in copies)}, "
          f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    span_table(prof, segments)
    if path == "rp2350_serve":
        loop_ops(out)
        return
    if eng.static.wire:
        wire_trace(eng, x ^ 4)
    loop_ops(out)


if __name__ == "__main__":
    main()
