"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port; ``run.py`` gives no result without a
card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "dspi_tpu"}


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_entries_metrics_and_program_load_no_jax():
    code = "\n".join([
        "import pkgutil, importlib, benchmark",
        "from benchmark import harness, compare, roofline, trace",
        "import benchmark.entries, benchmark.metrics, benchmark.reference",
        "for pkg in (benchmark.entries, benchmark.metrics, "
        "benchmark.reference):",
        "    for m in pkgutil.iter_modules(pkg.__path__):",
        "        importlib.import_module(pkg.__name__ + '.' + m.name)",
        "import dspi_tpu_torch.chain, dspi_tpu_torch.runtime.executor",
        "import dspi_tpu_torch.kernels.deframe"])
    tops = _tops(code)
    assert "dspi_tpu_torch" in tops and "benchmark" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = "\n".join([
        "import pkgutil, importlib, benchmark.reference as r",
        "for m in pkgutil.iter_modules(r.__path__):",
        "    importlib.import_module('benchmark.reference.' + m.name)",
        "import benchmark.compare, benchmark.roofline, benchmark.trace"])
    tops = _tops(code)
    assert "benchmark" in tops
    assert not tops & (FORBIDDEN | {"dspi_tpu_torch"})


def test_run_gives_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "rp2040_render", "--seed", str(2**31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
