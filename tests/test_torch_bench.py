"""The port's benchmark twin, ``dspi_tpu_torch.bench``, on the CPU.

* ``bench_engine`` returns a finite RTF and latency for the float chain,
  the Q28 chain, the 44.1 kHz schedule and the device wire words.
* Its chained loop against the JAX package's engine:
  ``test_torch_bench_vs_jax.py``.
* Restoring the snapshot makes two timed runs fold to the same value, and
  without the restore they differ: the repeat check means something.
* ``main()`` prints the JAX benchmark's four keys as its last line and,
  under DSPI_BENCH_FULL, writes its sweep to its own record, leaving the
  committed BENCH_DETAILS.json as it was."""

import hashlib
import json
import math
from pathlib import Path

import pytest
import torch

from dspi_tpu_torch import Platform, bench
from dspi_tpu_torch.chain import Engine
from dspi_tpu_torch.configs import full_chain_config

REPO = Path(__file__).resolve().parents[1]
B, NPKT, DEPTH = 2, 1, 2


@pytest.mark.parametrize("case", ["float", "q28", "sched441", "wire"])
def test_bench_engine_runs_on_cpu(case):
    plat = Platform.RP2040 if case == "q28" else Platform.RP2350
    rate = 44100.0 if case == "sched441" else 48000.0
    rtf, latency = bench.bench_engine(
        full_chain_config(plat, rate), B, NPKT, 2, depth=1,
        schedule=(44, 45) if case == "sched441" else None,
        wire=case == "wire", device="cpu")
    assert math.isfinite(rtf) and rtf > 0
    assert math.isfinite(latency) and latency > 0


def test_restored_state_repeats_the_fold():
    """Two chained runs from the restored snapshot fold to one value, and
    the segment processor leaves the state it is given as it was; a run
    that carries on from where the last one left gives another."""
    cfg = full_chain_config(Platform.RP2040)
    cfg.leveller.lookahead = False        # outputs from the first sample
    eng = Engine(cfg, n_streams=B, emit="reduced", pdm=False,
                 pdm_fade=False, device="cpu")
    x = bench.bench_input(B, NPKT, 48, None, "cpu")
    pm = torch.ones(NPKT, dtype=torch.float32)
    def run(state):
        return bench.chained_segments(eng.segment_fn, eng.params, state, x,
                                      pm, DEPTH)

    snap, _ = run(eng.state)                                # warm-up
    copy = [v.clone() for v in snap if v is not None]
    (end, f1), (_, f2) = run(snap), run(snap)
    assert all(torch.equal(a, b) for a, b in
               zip(copy, [v for v in snap if v is not None]))
    assert float(f1) == float(f2) != 0.0
    assert float(run(end)[1]) != float(f1)


def test_main_prints_the_benchmark_line(tmp_path, monkeypatch, capsys):
    committed = REPO / "BENCH_DETAILS.json"
    before = hashlib.sha256(committed.read_bytes()).hexdigest()
    for k, v in (("DSPI_BENCH_STREAMS", "2"), ("DSPI_BENCH_PACKETS", "2"),
                 ("DSPI_BENCH_ITERS", "2"), ("DSPI_BENCH_DEPTH", "1"),
                 ("DSPI_BENCH_FULL", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "DETAILS", tmp_path / "details.json")
    details = bench.main(["--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "x realtime" and last["value"] >= 0
    assert lines[-2] == "device: cpu"
    written = json.loads((tmp_path / "details.json").read_text())
    assert set(written) == {"full_chain_48k", "cfg1_passthrough",
                            "cfg2_peq10", "cfg5_full_96k",
                            "full_chain_48k_q28"} == set(details)
    assert all(math.isfinite(v["rtf"]) for v in written.values())
    assert hashlib.sha256(committed.read_bytes()).hexdigest() == before


def test_main_needs_a_card_without_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: main() would run on it")
    monkeypatch.setenv("DSPI_BENCH_STREAMS", "2")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
