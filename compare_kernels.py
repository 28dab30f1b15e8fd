#!/usr/bin/env python
"""Time the port's PDM and crossfeed kernels against other revisions of
the same sources, in turns, on one NVIDIA card.

    python3 compare_kernels.py OTHER_CSRC_DIR [OTHER_CSRC_DIR ...]

Each OTHER_CSRC_DIR holds a ``pdm.cu`` and an ``xf_q28.cu`` with the same C
entry points as ``dspi_tpu_torch/kernels/csrc/`` (for example the parent
commit's, unpacked with ``git archive`` into a git-ignored directory).
Every source is built with the port's nvcc flags, all at once, and each
build is launched through its wrapper's own ``bind`` and ``launch`` (those
that ``pdm_words`` and ``xf_q28`` use).  Then, per kernel and shape, the
repo's build and each other build run in turns (other,
repo, repo, other; CUDA events, 5 calls each after a warm-up) on the same
inputs, and every build's words and state are held equal to the repo's:

  pdm       6144 x 16384 and 6144 x 17408 (all streams modulating)
  xf_q28    6144 x 16384 with [3] and with per-lane [3, B] coefficients

It prints the card's name and power limit, each build's sample-loop SASS
counts per sample (build.loop_counts / build.per_sample), one line per
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
# (the wrapper's module, kernel name in the SASS, the memory op that counts
# the sample loop's samples, its count a sample)
LOOPS = {"pdm": ("pdm_cuda", "pdm_kernel", "ldg", 1),
         "xf_q28": ("xf_cuda", "xf_kernel", "stg", 2)}


def _runner(name: str, src_dir: Path, args: list):
    """A closure launching ``<src_dir>/<name>.cu``'s kernel on ``args``
    through its wrapper's ``bind``/``launch``."""
    import importlib

    from dspi_tpu_torch.kernels import build

    mod = importlib.import_module(f"dspi_tpu_torch.kernels.{LOOPS[name][0]}")
    fn = mod.bind(build.load(name, src_dir))
    return lambda: mod.launch(fn, *args)


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
        yield "pdm", f"{T}x{b}", [rand((T, b)), s16]
    b = 16384
    for label, coef in (
            ("[3]", torch.tensor([19000000, 249000000, -180000000],
                                 dtype=torch.int32, device=dev)),
            ("[3, B]", rand((3, b), -2**31, 2**31 - 1))):
        yield "xf_q28", f"{T}x{b} {label}", [rand((T, b)), rand((T, b)),
                                            coef, rand((4, b), -(1 << 24),
                                                       1 << 24)]


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
    for key, r in report.items():
        regs = re.findall(r"Used (\d+) registers", r["log"])
        spill = sum(map(int, re.findall(r"(\d+) bytes spill", r["log"])))
        print(f"built {key}: registers {regs}, spill bytes {spill}, "
              f"{r['seconds']:.1f} s", flush=True)
    result = {"card": card, "sass": {}, "runs": []}
    for label, d in dirs.items():
        for name, (_, kernel, op, per) in LOOPS.items():
            c = build.loop_counts(build.sass(name, d), kernel)
            ps = build.per_sample(c, op, per)
            result["sass"][f"{label} {name}"] = {
                **ps, "imad": c["imad"], "alu": c["alu"],
                "alu_only_loop": c["alu_only"], "ldg": c["ldg"],
                "lds": c["lds"], "stg": c["stg"], "ldgsts": c["ldgsts"],
                "instructions": c["instructions"]}
            print(f"SASS {label} {name}: {result['sass'][f'{label} {name}']}",
                  flush=True)
    dev = torch.device("cuda", 0)
    for name, shape, args in _cases(dev):
        mine = _runner(name, build.SRC_DIR, args)
        for label, d in dirs.items():
            if label == "repo":
                continue
            theirs = _runner(name, d, args)
            times = [_ms(theirs), _ms(mine), _ms(mine), _ms(theirs)]
            equal = all(torch.equal(u, v) for u, v in zip(mine(), theirs()))
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
