"""Run one cell of the benchmark of the port (``dspi_tpu_torch``) once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (``BENCHMARK.json``,
``benchmark/workloads/<cell>.json``), builds the program and warms it up
(set-up), measures for ``--seconds``, checks what the timed path produced
against the reference, and prints as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checked``, each
compared number beside its limit, which also end standard error.  Without
a CUDA card it exits with 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    # a library that could load JAX by itself is told not to
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness

    sys.exit(harness.main(args, T_START))
