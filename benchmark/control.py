"""The controls of ``correct``, and the readings its limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds <a,b,...> \
        --seconds <s> [--control]

Runs the cell once a seed, in one process, at the cell's own size, and
prints each run's compared numbers as a JSON line: without ``--control``
the program as it is (the lower readings), with ``--control`` the cell's
control (the upper readings):

* float cells: the program with TF32 on its block products (the program
  refuses TF32; the control lifts that guard), the step below float32;
* Q28 cells: the reference put in the program's place with its Q28 EQ
  coefficients 4 bits short (Q24), the step below the Q28 words.

The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_GUARD: dict = {}


def tf32_on(cell) -> None:
    """The float cells' control: TF32 on the program's block products."""
    import torch
    from dspi_tpu_torch.chain import mxu

    _GUARD.setdefault("check", mxu._check_fp32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    mxu._check_fp32 = lambda: None


def tf32_off() -> None:
    """Undo ``tf32_on``: full float32 products and the program's guard."""
    from dspi_tpu_torch.chain import mxu

    mxu.require_fp32()
    if "check" in _GUARD:
        mxu._check_fp32 = _GUARD["check"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    from benchmark import harness
    from benchmark.reference import config

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 3
    work = harness.workload(args.workload)
    is_float = config.load(work["config"])["device"]["platform"] == "rp2350"
    for seed in (int(s) for s in args.seeds.split(",")):
        kw = {}
        if args.control:
            kw = {"fault": tf32_on} if is_float else {"control_bits": 4}
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                               "cuda:0", log=lambda s: None, **kw)
        tf32_off()
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "control": args.control, "correct": res["correct"],
                          "checked": res["checked"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
