"""The multi-tenant scan cell's control readings, which its limits are set
from beside ``control.py``'s.

    python3 benchmark/control_scan.py --seeds <a,b,...> --seconds <s>

Runs ``rp2350_scan_tenants8`` once a seed, in one process, at the cell's
own size, with ``entries.hetero_scan.bf16_coefficients`` (the server's
float cascade, loudness and crossfeed coefficients rounded to bfloat16
and back before the window, the step below float32 on this path), and
prints each run's compared numbers as a JSON line.  The scan lowering
runs no block product, so ``control.py``'s TF32 control may leave it
untouched; ``python3 benchmark/control.py --workload rp2350_scan_tenants8
--seeds ... --control`` reads that one, and without ``--control`` the
program as it is.  The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CELL = "rp2350_scan_tenants8"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    from benchmark import harness
    from benchmark.entries.hetero_scan import bf16_coefficients

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(CELL, seed, args.seconds, False, t0, "cuda:0",
                               log=lambda s: None, fault=bf16_coefficients)
        print(json.dumps({"cell": CELL, "seed": seed,
                          "control": "bf16_coefficients",
                          "correct": res["correct"],
                          "checked": res["checked"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
