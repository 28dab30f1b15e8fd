#!/usr/bin/env python
"""Time the port's PDM, crossfeed and cascade kernels against other
revisions of the same sources, in turns, on one NVIDIA card.

    python3 compare_kernels.py OTHER_CSRC_DIR [OTHER_CSRC_DIR ...]

Each OTHER_CSRC_DIR holds a ``pdm.cu``, an ``xf_q28.cu`` and an
``eq_q28.cu`` with the same C entry points as
``dspi_tpu_torch/kernels/csrc/`` (for example the parent commit's, unpacked
with ``git archive`` into a git-ignored directory).  Every source is built
with the port's nvcc flags, all at once, and each build is launched
through its wrapper's own ``bind`` and ``launch`` (those that
``pdm_words``, ``xf_q28`` and ``q28_cascades`` use).  Then, per kernel and
shape, the repo's build and each other build run in turns (other, repo,
repo, other; CUDA events, 5 calls each after a warm-up) on the same
inputs, and every build's outputs and state are held equal to the repo's:

  pdm       6144 x 16384 and 6144 x 17408 (all streams modulating)
  xf_q28    6144 x 16384 with [3] and with per-lane [3, B] coefficients
  eq_q28    the hetero path's two per-lane (lane_cf) calls at 6144 x 17408,
            master (G=2, loudness + 10 bands + envelope) and outputs (G=5,
            10 bands), with columns uniform over 8 buckets of 2176 lanes
            (the HeteroServer layout) and with random per-lane columns;
            the q28 path's two scalar-mode calls at 6144 x 16384; the
            44.1 kHz path's two schedule-mode calls at 5733 x 16384

It prints the card's name and power limit, each build's sample-loop SASS
counts a sample (build.loop_counts / build.per_sample; the cascade
kernel's for each instance the paths launch) and registers, one line per
kernel and shape, and last one JSON object with every number; the same
object goes to chiprun_out/compare_kernels.json.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

T = 6144
# per source: (the wrapper's module, its sample loops: (label, pieces of
# the kernel's mangled name in the order tried (this repo's first; the
# cascade kernel's instances were cascade_kernel<NB, LOUD, ENV, LANE> up
# to commit 84fe37b), the memory op that counts the loop's samples, its
# count a sample))
LOOPS = {
    "pdm": ("pdm_cuda", [("pdm", ("pdm_kernel",), "ldg", 1)]),
    "xf_q28": ("xf_cuda", [("xf_q28", ("xf_kernel",), "stg", 2)]),
    "eq_q28": ("eq_cuda", [
        (f"eq_q28 {label} <10,{int(loud)},{int(loud)}>",
         (f"{kern}ILi10ELb{int(loud)}ELb{int(loud)}EE",
          f"cascade_kernelILi10ELb{int(loud)}ELb{int(loud)}ELb{int(lane)}EE"),
         "ldg", 1)
        for label, kern, lane in (("lane_cf", "lane_kernel", True),
                                  ("scalar", "cascade_kernel", False))
        for loud in (True, False)])}
SCHED441 = ((44,) * 9 + (45,)) * 13


def _runner(name: str, src_dir: Path, args: list, kw: dict):
    """A closure launching ``<src_dir>/<name>.cu``'s kernel on ``args``
    and ``kw`` through its wrapper's ``bind``/``launch``."""
    import importlib

    from dspi_tpu_torch.kernels import build

    mod = importlib.import_module(f"dspi_tpu_torch.kernels.{LOOPS[name][0]}")
    fn = mod.bind(build.load(name, src_dir))
    return lambda: mod.launch(fn, *args, **kw)


def _same(u, v) -> bool:
    return u is None and v is None or (
        u is not None and v is not None and torch.equal(u, v))


def _ms(run, reps: int = 5) -> float:
    run()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _cases(dev):
    gen = torch.Generator(device=dev).manual_seed(23)

    def rand(shape, lo=-(1 << 28), hi=1 << 28):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                             device=dev)
    for b in (16384, 17408):
        s16 = torch.zeros((16, b), dtype=torch.int32, device=dev)
        s16[7], s16[8], s16[9], s16[10] = 123456789, 1024, 1, 1
        yield "pdm", f"{T}x{b}", [rand((T, b)), s16], {}
    b = 16384
    for label, coef in (
            ("[3]", torch.tensor([19000000, 249000000, -180000000],
                                 dtype=torch.int32, device=dev)),
            ("[3, B]", rand((3, b), -2**31, 2**31 - 1))):
        yield "xf_q28", f"{T}x{b} {label}", [rand((T, b)), rand((T, b)),
                                            coef, rand((4, b), -(1 << 24),
                                                       1 << 24)], {}
    yield from _eq_cases(dev, rand)


def _eq_cases(dev, rand):
    """The cascade kernel's calls on the hetero, q28 and 44.1 kHz paths:
    (kernel, label, args, keywords)."""
    def scalars(g, lanes):
        # loudness bypass flags (mixed, and per lane with lanes), alphas
        a_rms = rand((g, *lanes), 200000000, 268000000)
        flags = (rand((g, *lanes), 0, 2) for _ in range(2)) if lanes else (
            torch.zeros((g,), dtype=torch.int32, device=dev),) * 2
        return torch.stack([*flags, a_rms, (1 << 28) - a_rms], dim=1)

    def call(g, t, b, master, lanes, **kw):
        # the master call has the loudness filters and the envelope
        nr = (2 if master else 0) + 10
        cf = rand((g, nr, 5, *lanes), -(1 << 27), 1 << 27) >> 2
        scal = scalars(g, lanes)
        if lanes and lanes[0] < b:
            # columns uniform over buckets of lanes[0]: repeat each bucket's
            cf = cf.repeat_interleave(b // lanes[0], dim=-1)
            scal = scal.repeat_interleave(b // lanes[0], dim=-1)
        args = [rand((g, t, b)), cf.contiguous(),
                rand((g, 2 * nr + master, b), -(1 << 20), 1 << 20),
                scal.contiguous()]
        return args, dict(nb=10, has_loud=master, has_env=master, **kw)

    b = 17408
    for cols, lanes in (("bucket-uniform 8x2176", (8,)),
                        ("random per lane", (b,))):
        for label, g, master in (("master", 2, True),
                                 ("outputs", 5, False)):
            yield ("eq_q28", f"lane_cf {label} {T}x{b} {cols}",
                   *call(g, T, b, master, lanes))
    b = 16384
    for label, g, master in (("master", 2, True), ("outputs", 5, False)):
        yield ("eq_q28", f"scalar {label} {T}x{b}",
               *call(g, T, b, master, ()))
        yield ("eq_q28", f"sched {label} {sum(SCHED441)}x{b}",
               *call(g, sum(SCHED441), b, master, (), sched=SCHED441))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    others = [Path(p).resolve() for p in sys.argv[1:]]
    if not others:
        raise SystemExit(__doc__)
    from dspi_tpu_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dirs = {"repo": build.SRC_DIR, **{str(p): p for p in others}}
    report = build.build_all(tuple(LOOPS), tuple(dirs.values()))
    regs = {}
    for key, r in report.items():
        regs[key] = build.registers(r["log"])
        spill = sum(map(int, re.findall(r"(\d+) bytes spill", r["log"])))
        print(f"built {key}: registers {sorted(set(regs[key].values()))}, "
              f"spill bytes {spill}, {r['seconds']:.1f} s", flush=True)
    result = {"card": card, "sass": {}, "runs": []}
    for label, d in dirs.items():
        for name, (_, loops) in LOOPS.items():
            text = build.sass(name, d)
            built = regs.get(name if label == "repo" else f"{d}/{name}", {})
            for loop, kernels, op, per in loops:
                kernel = next(k for k in kernels if k in text)
                c = build.loop_counts(text, kernel)
                ps = build.per_sample(c, op, per)
                key = f"{label} {loop}"
                result["sass"][key] = {
                    "kernel": kernel,
                    "registers": next((n for f, n in built.items()
                                       if kernel in f), None),
                    **ps,
                    "stall_a_sample": (None if c["stall"] is None else
                                       c["stall"]
                                       / ps["samples_per_iteration"]),
                    "imad": c["imad"], "alu": c["alu"],
                    "alu_only_loop": c["alu_only"], "ldg": c["ldg"],
                    "lds": c["lds"], "stg": c["stg"], "ldgsts": c["ldgsts"],
                    "instructions": c["instructions"]}
                print(f"SASS {key}: {result['sass'][key]}", flush=True)
    dev = torch.device("cuda", 0)
    for name, shape, args, kw in _cases(dev):
        mine = _runner(name, build.SRC_DIR, args, kw)
        for label, d in dirs.items():
            if label == "repo":
                continue
            theirs = _runner(name, d, args, kw)
            times = [_ms(theirs), _ms(mine), _ms(mine), _ms(theirs)]
            equal = all(_same(u, v) for u, v in zip(mine(), theirs()))
            row = {"kernel": name, "shape": shape, "other": label,
                   "other_ms": [times[0], times[3]],
                   "repo_ms": [times[1], times[2]], "equal": equal}
            result["runs"].append(row)
            print(f"{name} {shape}: other {label} {times[0]:.3f} "
                  f"{times[3]:.3f} ms, repo {times[1]:.3f} {times[2]:.3f} "
                  f"ms; outputs equal: {equal}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "compare_kernels.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    if not all(r["equal"] for r in result["runs"]):
        raise SystemExit("a build's outputs differ from the repo's")


if __name__ == "__main__":
    main()
