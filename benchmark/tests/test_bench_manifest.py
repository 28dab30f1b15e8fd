"""BENCHMARK.json and every file it names: present, loadable, within the
contract's limits of names, units and keys; and a cell added as files
alone is found and run."""

from __future__ import annotations

import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(MAN) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len(MAN["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                    assert "\t" not in e[k]
    assert len(names) == len(set(names))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_named_file_loads():
    from benchmark import harness
    from benchmark.reference import config

    cfgs = {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]
        assert spec["source"] == c["source"]
        config.load(c["name"])
    used = set()
    for w in MAN["workloads"]:
        work = harness.workload(w["traffic"])
        assert work["config"] == w["config"] in cfgs
        assert work["chips"] == w["chips"] and work["why"] == w["why"]
        harness.entry(work["entry"])
        assert work["limits"]
        used.add(w["config"])
    assert used == cfgs
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_cell_reports_what_the_contract_asks():
    from benchmark.harness import cell_metrics

    e2e = {m["name"] for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        mine = {m["name"] for m in cell_metrics(MAN, w["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell_metrics(MAN, w["name"], "per_layer")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in MAN["workloads"]]):
            moved = {x["name"] for x in cell_metrics(MAN, cell, "end_to_end")}
            assert m["moves"] in moved, (m["name"], cell)


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A copy of the benchmark with one more traffic file and one more
    entry in BENCHMARK.json runs that cell, on the CPU, with no code
    changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    man = dict(MAN)
    work = json.loads((ROOT / "benchmark/workloads/rp2040_render.json")
                      .read_text())
    work["why"] = "a throwaway cell: the Q28 render traffic at 3 packets"
    work["traffic"] = {**work["traffic"], "packets": 3}
    (tmp_path / "benchmark/workloads/tmp_q28_3pkt.json").write_text(
        json.dumps(work))
    man["workloads"] = MAN["workloads"] + [
        {"name": "tmp_q28_3pkt", "config": "rp2040_full",
         "traffic": "tmp_q28_3pkt", "chips": 1, "why": work["why"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.append(sys.argv[2]); "
            "from benchmark.tests import cpu_run; "
            "r = cpu_run.run('tmp_q28_3pkt'); "
            "import benchmark; print(benchmark.__file__); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=600, check=True).stdout.splitlines()
    assert out[-2].startswith(str(tmp_path))
    res = json.loads(out[-1])
    assert res["correct"] and res["attempted"] >= 2
    assert set(res["metrics"]) == {"rtf", "setup_s"}
