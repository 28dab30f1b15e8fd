#!/usr/bin/env python
"""Where one full-width segment of the port's main path spends its time.

    python3 profile_torch.py

Runs the headline chain (RP2350, 48 kHz, full_chain_config, emit
"reduced", PDM on) on one CUDA card at 16384 streams x 128 packets of 48
samples, warms up, then traces one segment with torch.profiler (CPU and
CUDA activity).  Prints the card, the segment's wall time, the number of
device kernels and their summed time, the device's idle share (1 - kernel
time / wall), and the ops with the most device time; writes the full
table to chiprun_out/profile_main.txt.  Then times each stage of one more
segment (synchronized before and after each stage).

Last, it counts the instructions of the PDM kernel's per-sample loop in
the SASS of the built library (cuobjdump), by opcode, which checks the
operation count that chip_smoke.py's bound for that kernel assumes; the
kernel's SASS goes to chiprun_out/pdm_sass.txt.
"""

from __future__ import annotations

import re
import subprocess
import time
from pathlib import Path

import torch

STREAMS, PACKETS, BLOCK = 16384, 128, 48
# SASS opcodes (before the first '.') that are not per-thread arithmetic
_CONTROL = {"BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
            "BPT", "NOP", "WARPSYNC", "BAR", "YIELD"}
_MEMORY = {"LDG", "STG", "LDC", "LD", "ST", "LDS", "STS", "LDL", "STL"}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def stage_times(eng, x) -> dict:
    """Wall milliseconds per stage of one segment.  Each stage is wrapped
    with a synchronize before and after, so stages cannot overlap and
    the sum is slower than an unwrapped segment."""
    from dspi_tpu_torch.chain import mxu, pipeline

    stages = [(mxu, "chain_a", "loudness + master EQ (block products)"),
              (mxu, "env_packet_ends", "leveller envelope"),
              (mxu, "chain_b", "crossfeed + matrix + output EQ"),
              (pipeline, "pdm_segment", "PDM (mode prologue + kernel)")]
    times = {}
    saved = []
    for mod, name, label in stages:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = _fn(*a, **k)
            torch.cuda.synchronize()
            times[_label] = 1e3 * (time.perf_counter() - t)
            return r
        setattr(mod, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.process(x)
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    times["rest: unpack, leveller gain + limiter, gains, delays, peaks, "
          "s24, sums"] = total - sum(times.values())
    times["segment (synchronized stages)"] = total
    return times


def pdm_loop_ops(out: Path) -> None:
    """Print the opcode counts of the PDM kernel's sample loop (the longest
    backward branch's body) in the SASS of the built library."""
    from dspi_tpu_torch.kernels import build

    build.load("pdm")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.lib_path("pdm"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    (out / "pdm_sass.txt").write_text(sass)
    code = sass[sass.index("pdm_kernel"):]
    ins = [(int(a, 16), op, args) for a, op, args in _SASS_LINE.findall(code)]
    loops = [(addr, int(m.group(1), 16)) for addr, op, args in ins
             if op.startswith("BRA") and (m := re.search(r"0x([0-9a-f]+)",
                                                         args))
             and int(m.group(1), 16) < addr]
    end, head = max(loops, key=lambda lp: lp[0] - lp[1])
    hist: dict[str, int] = {}
    for addr, op, _ in ins:
        if head <= addr <= end:
            hist[op] = hist.get(op, 0) + 1
    base = {op: op.split(".")[0] for op in hist}
    thread = sum(n for op, n in hist.items()
                 if base[op] not in _CONTROL | _MEMORY
                 and not base[op].startswith(("U", "S2")))
    top = sorted(hist.items(), key=lambda kv: -kv[1])[:16]
    print(f"pdm kernel SASS: sample loop 0x{head:x}-0x{end:x}, "
          f"{sum(hist.values())} instructions, {thread} per-thread "
          f"arithmetic (not control, memory, uniform or special), STG "
          f"{sum(n for op, n in hist.items() if base[op] == 'STG')}; "
          f"by opcode {top}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    eng = Engine(full_chain_config(Platform.RP2350), n_streams=STREAMS,
                 block_size=BLOCK, emit="reduced", pdm=True, pdm_fade=False,
                 device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-16000, 16000, (PACKETS, 2, BLOCK, STREAMS),
                      generator=gen, dtype=torch.int32, device=dev)
    for i in range(2):
        eng.process(x ^ i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.process(x ^ 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_main.txt").write_text(
        f"card: {card}\nwall {wall * 1e3:.3f} ms\n{table}\n")
    print(f"card: {card}")
    print(f"segment {STREAMS} x {PACKETS}x{BLOCK}: wall "
          f"{wall * 1e3:.3f} ms (profiled), {n_kernels} kernels, device "
          f"kernel time {dev_us / 1e3:.3f} ms, idle share "
          f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    for label, ms in stage_times(eng, x ^ 3).items():
        print(f"stage {ms:10.3f} ms  {label}")
    pdm_loop_ops(out)


if __name__ == "__main__":
    main()
