#!/usr/bin/env python
"""Time the port's PDM, crossfeed and cascade kernels against other
revisions of the same sources, in turns, on one NVIDIA card.

    python3 compare_kernels.py OTHER_CSRC_DIR [OTHER_CSRC_DIR ...]

Each OTHER_CSRC_DIR holds a ``pdm.cu``, an ``xf_q28.cu`` and an
``eq_q28.cu`` with the same C entry points as
``dspi_tpu_torch/kernels/csrc/``, and an ``eq_f32.cu`` with the float
cascade wrapper of its own revision beside it (``../eq_f32_cuda.py``):
for example the parent commit's ``dspi_tpu_torch/kernels``, unpacked with
``git archive`` into a git-ignored directory.  Every source is built with
the port's nvcc flags, all at once, and each build is launched through
its wrapper's own ``bind`` and ``launch`` (those that ``pdm_words``,
``xf_q28`` and ``q28_cascades`` use; for ``eq_f32`` its own revision's
wrapper, imported from beside it, since the C entry changed with the
one-library-a-signature design).  Then, per kernel and shape, the repo's
build and each other build run in turns (other, repo, repo, other; CUDA
events, 5 calls each after a warm-up) on the same inputs, and every
build's outputs and state are held equal to the repo's.  A kernel whose
source is the same file in every other directory is left out (nothing
differs to compare):

  pdm       6144 x 16384 and 6144 x 17408 (all streams modulating)
  xf_q28    6144 x 16384 with [3] and with per-lane [3, B] coefficients
  eq_q28    the hetero path's two per-lane (lane_cf) calls at 6144 x 17408,
            master (G=2, loudness + 10 bands + envelope) and outputs (G=5,
            10 bands), with columns uniform over 8 buckets of 2176 lanes
            (the HeteroServer layout) and with random per-lane columns;
            the q28 path's two scalar-mode calls at 6144 x 16384; the
            44.1 kHz path's two schedule-mode calls at 5733 x 16384
  eq_f32    the float scan paths' master (G=2, loudness + 10 bands +
            envelope) and output (G=9, 10 bands) calls at the headline's
            band kinds: per cascade at 6144 x 16384, per lane at 6144 x
            17408 with columns uniform over 8 buckets of 2176 lanes and
            with random per-lane columns, and at 5733 x 16384 on the
            44.1 kHz schedule

It prints the card's name and power limit, each build's sample-loop SASS
counts a sample (build.loop_counts / build.per_sample; the cascade
kernels' for each instance the paths launch, the float cascades' with
FMUL, FADD, BRA and ISETP a sample, registers, resident blocks an SM and
waves) and registers, one line per
kernel and shape, and last one JSON object with every number; the same
object goes to chiprun_out/compare_kernels.json.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
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
# the float scan paths' cascade calls: the headline's band kinds (HP, 3
# peaking, shelf, peaking, TDF2 x 3 around it) and (label, cascades, with
# the loudness rows and the envelope)
EQF_HEAD = (3, 4, 4, 5, 4, 4, 4, 1, 1, 1)
EQF_CALLS = (("master", 2, True), ("output", 9, False))


def _eqf_module(src_dir: Path):
    """The float cascade wrapper of ``src_dir``'s revision: the repo's, or
    the ``eq_f32_cuda.py`` beside another csrc/, imported into this repo's
    kernels package so that its relative imports resolve here."""
    from dspi_tpu_torch.kernels import build, eq_f32_cuda

    if src_dir == build.SRC_DIR:
        return eq_f32_cuda
    path = src_dir.parent / "eq_f32_cuda.py"
    name = ("dspi_tpu_torch.kernels._eq_f32_cuda_"
            + hashlib.sha256(str(path).encode()).hexdigest()[:8])
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def _eqf_builds(src_dir: Path) -> list:
    """(label, lane, loudness, signature or None, the library's defines)
    of the four float cascade instances the scan paths launch, as
    ``src_dir``'s revision builds them: one library a signature, or (up to
    commit 286fbb3) one library of run-time kinds, its instances
    cascade_kernel<NB, LOUD, ENV, LANE>."""
    mod = _eqf_module(src_dir)
    rows = []
    for lane in (False, True):
        for label, _, loud in EQF_CALLS:
            sig = (mod.signature(EQF_HEAD, loud, loud, lane)
                   if hasattr(mod, "libraries") else None)
            rows.append((f"{label}{' per lane' if lane else ''}", lane, loud,
                         sig, mod.defines(sig) if sig is not None else ()))
    return rows


def _eqf_sass(src_dir: Path, lane: bool, loud: bool, sig, defines) -> dict:
    """Sample-loop SASS counts a sample of one float cascade instance."""
    from dspi_tpu_torch.kernels import build

    text = build.sass("eq_f32", src_dir, defines)
    if sig is None:          # run-time kinds: one word loaded a sample
        kernel, op = (f"cascade_kernelILi10ELb{int(loud)}ELb{int(loud)}"
                      f"ELb{int(lane)}EE", "ldg")
    else:                    # staged input: one cp.async a step
        kernel, op = "cascade_kernel", "ldgsts"
    c = build.loop_counts(text, kernel)
    ps = build.per_sample(c, op, 1)
    n = ps["samples_per_iteration"]
    ops = build.opcodes_per_sample(c, n)
    return {"kernel": kernel, "instructions": c["instructions"] / n,
            "arith": ps["arith"],
            **{k.lower(): ops.get(k, 0.0) for k in (
                "FMUL", "FADD", "BRA", "ISETP", "LDG", "LDS", "LDGSTS",
                "STG")},
            "stall_a_sample": None if c["stall"] is None else c["stall"] / n,
            "samples_per_iteration": n}


def _eqf_runner(src_dir: Path, args: list, kw: dict):
    """A closure running one float cascade call through ``src_dir``'s
    revision's own wrapper."""
    from dspi_tpu_torch.kernels import build

    mod = _eqf_module(src_dir)
    if not hasattr(mod, "libraries"):       # one library, run-time kinds
        fn = mod.bind(build.load("eq_f32", src_dir))
        return lambda: mod.launch(fn, *args, **kw)
    plan = mod.split(kw["kinds"], kw["has_loud"], kw["has_env"],
                     args[1].dim() == 4)
    libs = mod.libraries([sig for sig, _ in plan], src_dir)
    return lambda: mod.launch(libs, plan, *args, has_env=kw["has_env"],
                              tc=kw["tc"], sched=kw.get("sched"))


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
    yield from _eqf_cases(dev)

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


def _eqf_cases(dev):
    """The float cascade calls of the scan paths: (kernel, label, args,
    keywords)."""
    from chip_smoke import f32_rows

    gen = torch.Generator(device=dev).manual_seed(29)

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def call(g, t, b, master, lanes, sched=None):
        nr = (2 if master else 0) + len(EQF_HEAD)
        if lanes:        # [G, nr, 11, B], columns repeated over buckets
            cf = f32_rows(gen, (g, nr, lanes[0]), dev).movedim(-1, 2)
            cf = cf.repeat_interleave(b // lanes[0], dim=-1)
            flags = (torch.rand((2, g, lanes[0]), generator=gen, device=dev)
                     < 0.5).float().repeat_interleave(b // lanes[0], dim=-1)
            a = uniform(0.99, 0.9999, (g, lanes[0])).repeat_interleave(
                b // lanes[0], dim=-1)
        else:            # no bypass: every row does its work
            cf = f32_rows(gen, (g, nr), dev)
            flags = torch.zeros((2, g), device=dev)
            a = torch.linspace(0.995, 0.9999, g, device=dev)
        scal = torch.stack([flags[0], flags[1], a, 1.0 - a], dim=1)
        s0 = uniform(-0.1, 0.1, (g, 2 * nr + master, b))
        if master:
            s0[:, -1] = uniform(0.0, 0.3, (g, b))
        args = [uniform(-1.0, 1.0, (g, t, b)), cf.contiguous(), s0,
                scal.contiguous()]
        return args, dict(kinds=(EQF_HEAD,) * g, has_loud=master,
                          has_env=master, tc=48, sched=sched)

    for b, lanes, cols in ((16384, (), "per cascade"),
                           (17408, (8,), "bucket-uniform 8x2176"),
                           (17408, (17408,), "random per lane")):
        for label, g, master in EQF_CALLS:
            yield ("eq_f32", f"{label} {T}x{b} {cols}",
                   *call(g, T, b, master, lanes))
    for label, g, master in EQF_CALLS:
        yield ("eq_f32", f"sched {label} {sum(SCHED441)}x16384",
               *call(g, sum(SCHED441), 16384, master, (), SCHED441))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    others = [Path(p).resolve() for p in sys.argv[1:]]
    if not others:
        raise SystemExit(__doc__)
    from dspi_tpu_torch.kernels import build

    # the kernels whose source differs in some other directory
    kernels = [k for k in (*LOOPS, "eq_f32")
               if any(build.lib_path(k, d) != build.lib_path(k)
                      for d in others)]
    loops = {k: v for k, v in LOOPS.items() if k in kernels}
    print(f"kernels whose sources differ: {kernels}", flush=True)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dirs = {"repo": build.SRC_DIR, **{str(p): p for p in others}}
    eqf = ({label: _eqf_builds(d) for label, d in dirs.items()}
           if "eq_f32" in kernels else {})
    report = build.build_all(
        tuple(loops), tuple(dirs.values()),
        {("eq_f32", dirs[label], defs) for label, rows in eqf.items()
         for *_, defs in rows})
    regs = {}
    for key, r in report.items():
        regs[key] = build.registers(r["log"])
        spill = sum(map(int, re.findall(r"(\d+) bytes spill", r["log"])))
        print(f"built {key}: registers {sorted(set(regs[key].values()))}, "
              f"spill bytes {spill}, {r['seconds']:.1f} s", flush=True)
    result = {"card": card, "sass": {}, "runs": []}
    for label, d in dirs.items():
        for name, (_, loops_of) in loops.items():
            text = build.sass(name, d)
            built = regs.get(build.lib_key(name, d), {})
            for loop, kernels_of, op, per in loops_of:
                kernel = next(k for k in kernels_of if k in text)
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, rows in eqf.items():
        d = dirs[label]
        for inst, lane, loud, sig, defs in rows:
            row = _eqf_sass(d, lane, loud, sig, defs)
            built = regs.get(build.lib_key("eq_f32", d, defs), {})
            row["registers"] = next((n for f, n in built.items()
                                     if row["kernel"] in f), None)
            if sig is not None:        # the CUDA runtime's answers
                occ = _eqf_module(d).occupancy(
                    _eqf_module(d).libraries([sig], d)[sig])
                g = dict((n, c) for n, c, _ in EQF_CALLS)[inst.split()[0]]
                b = 17408 if lane else 16384
                per_sm, threads = occ["blocks_per_sm"], occ["threads"]
                row.update(occ, warps_per_sm=per_sm * threads // 32,
                           waves=g * math.ceil(b / threads)
                           / (per_sm * sms), waves_at=[g, b])
            key = f"{label} eq_f32 {inst}"
            result["sass"][key] = row
            print(f"SASS {key}: {row}", flush=True)
    dev = torch.device("cuda", 0)
    for name, shape, args, kw in _cases(dev):
        if name not in kernels:
            continue
        run = _eqf_runner if name == "eq_f32" else \
            lambda d, a, k, _n=name: _runner(_n, d, a, k)
        mine = run(build.SRC_DIR, args, kw)
        for label, d in dirs.items():
            if label == "repo":
                continue
            theirs = run(d, args, kw)
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
