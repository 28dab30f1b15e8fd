"""One run of one cell: set-up, a measured window, the check, the result.

Everything a cell is made of is found by name: ``BENCHMARK.json`` lists
the cells and metrics; ``workloads/<cell>.json`` holds a cell's traffic,
its entry, its check and the limits of its compared numbers;
``configs/<config>.json`` the deployment; ``entries/<entry>.py`` how the
program is driven; ``metrics/<metric>.py`` how each metric is read.  A new
cell, configuration, entry or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here changes.

``run_cell`` takes a device.  ``run.py`` hands it the card and refuses to
run without one; the CPU tests hand it the CPU at a tiny size, with the
traffic's sizes overridden, to drive the same code.
"""

from __future__ import annotations

import importlib
import json
import math
import multiprocessing
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import compare, trace
from .reference import config as ref_config

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dspi_tpu")
REF_WORKERS = 8


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    path = ROOT / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic file {path.relative_to(REPO)}")
    return json.loads(path.read_text())


def entry(name: str):
    return importlib.import_module(f"{__package__}.entries.{name}")


def metric_reader(name: str):
    return importlib.import_module(f"{__package__}.metrics.{name}")


def cell_metrics(man: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those without a ``workloads`` list and those that list it."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


@dataclass
class Ctx:
    """What an entry is given to build its cell."""
    work: dict                 # the traffic file
    spec: dict                 # the configuration file
    seed: int
    device: object             # a torch.device
    traffic: dict = field(default_factory=dict)

    def rng(self, salt: int) -> np.random.Generator:
        """A host generator drawn from the seed (lane samples, tenant ids)."""
        return np.random.default_rng([self.seed & (2**64 - 1), salt])


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: str
    work: dict
    spec: dict
    shape: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    audio_s: float = 0.0
    segments: int = 0
    latencies_s: list = field(default_factory=list)
    peak_bytes: int = 0
    counters: dict = field(default_factory=dict)
    trace: object = None


def _window(cell, seconds: float, traced: bool, run: Run, log) -> None:
    """Step the cell until ``seconds`` have passed, then stop at the end of
    a step; with ``traced``, profile the second step (a short one)."""
    import torch

    t0 = time.perf_counter()
    n = 0
    walls = []
    while True:
        prof_this = traced and n == 1
        if prof_this:
            k = cell.trace_segments
            acts = [torch.profiler.ProfilerActivity.CPU]
            if run.shape["device_type"] == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    lat = cell.step(k)
            run.trace = trace.from_profiler(prof, k)
        else:
            k = cell.step_segments
            lat = cell.step(k)
        run.latencies_s.extend(lat)
        run.segments += k
        n += 1
        walls.append(time.perf_counter() - t0 - sum(walls))
        if time.perf_counter() - t0 >= seconds and (
                run.trace is not None or not traced):
            break
    run.window_s = time.perf_counter() - t0
    run.audio_s = cell.audio_s_per_segment * run.segments
    log(f"window: {n} steps, {run.segments} segments in {run.window_s:.4f} s;"
        f" step walls {[round(w, 4) for w in walls]}")


def _reference(tasks: list, workers: int) -> list:
    """The reference over every task, in spawned worker processes (each
    imports the reference and nothing of the program), all ended before
    this returns."""
    from .reference import lanes

    if workers <= 1 or len(tasks) <= 1:
        return [lanes.run_lane(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(min(workers, len(tasks)))
    try:
        out = pool.map(lanes.run_lane, tasks, chunksize=1)
    finally:
        pool.close()
        pool.join()
    return out


def _as_program(per_lane: list) -> dict:
    """Reference results of several lanes laid out as the program's part of
    a check: each leaf with a trailing lane axis."""
    def stack(pick):
        return np.stack([np.asarray(pick(r)) for r in per_lane], axis=-1)

    outs = [{k: stack(lambda r: r["outs"][j][k])
             for k in per_lane[0]["outs"][j]}
            for j in range(len(per_lane[0]["outs"]))]
    state = {f: stack(lambda r: r["state"][f])
             for f, v in per_lane[0]["state"].items() if v is not None}
    return {"outs": outs, "state": state}


def loaded_forbidden() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device, traffic: dict | None = None,
             workers: int = REF_WORKERS, fault=None, control_bits=None,
             log=None) -> dict:
    """One run of ``cell_name``; returns the result line's object.
    ``traffic`` overrides sizes of the traffic file (the CPU tests');
    ``fault(cell)`` breaks the timed path underneath (the fault tests);
    ``control_bits`` puts the reference in the program's place, its Q28
    coefficients ``control_bits`` bits short (the Q28 cells' control)."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    man = manifest()
    if cell_name not in {w["name"] for w in man["workloads"]}:
        raise KeyError(f"{cell_name} is not a cell of BENCHMARK.json")
    work = workload(cell_name)
    spec = ref_config.load(work["config"])
    device = torch.device(device)
    ctx = Ctx(work, spec, seed, device,
              {**work["traffic"], **(traffic or {})})
    cell = entry(work["entry"]).build(ctx)
    if fault is not None:
        fault(cell)
    cell.warm()
    run = Run(cell_name, work, spec, {**cell.shape,
                                      "device_type": device.type})
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up: {run.setup_s:.4f} s")

    _window(cell, seconds, traced, run, log)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    run.counters = cell.counters()
    for k, v in run.counters.items():
        log(f"counter {k}: {v}")

    # the check: the program's part gathered, its state freed, then the
    # reference over the same streams
    checks, tasks = cell.collect()
    del cell
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    results = _reference(tasks, workers)
    for ck in checks:
        ck["ref"] = [results[i] for i in ck["tasks"]]
    if control_bits:
        low = _reference([{**t, "quantize": control_bits} for t in tasks],
                         workers)
        for ck in checks:
            ck["prog"] = _as_program([low[i] for i in ck["tasks"]])
    detail: dict = {}
    nums = compare.numbers(spec["device"]["platform"] == "rp2350", checks,
                           detail)
    if detail:
        log("state gaps by leaf: " + json.dumps(detail))
    correct, table = compare.judge(nums, work["limits"])
    log(f"reference: {len(tasks)} lane checks in "
        f"{time.perf_counter() - t_ref:.4f} s")

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(man, cell_name, kind):
        value = metric_reader(m["name"]).read(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} read {value}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": int(work["chips"]),
                "memory_peak_bytes": run.peak_bytes}
    result = {"correct": bool(correct), "attempted": run.segments,
              "failed": 0, "metrics": metrics, "device": dev_info}
    if traced:
        tr = run.trace
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(tr),
                               "idle_gaps": trace.idle_gaps(tr)}
    result["checked"] = table
    return result


def main(args, t_start: float) -> int:
    import torch

    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "out" / "triton_cache"))
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}")
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 3
    from .entries import card_line

    log(card_line())
    res = run_cell(args.workload, args.seed, float(args.seconds),
                   bool(args.trace), t_start, "cuda:0", log=log)
    bad = loaded_forbidden()
    if bad:
        log(f"modules of {bad} were loaded: no result")
        return 4
    for k, v in res["checked"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0
