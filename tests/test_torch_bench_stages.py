"""Every stage of the port's per-stage benchmark twin,
``dspi_tpu_torch.bench_stages``, once on the CPU at a tiny size (8
streams, 1 packet, one segment a call; pdm_sweep over 8 and 16 lanes; the
44.1 kHz stages on one 44/45 pair): each returns its entries under the
JAX package's keys with finite, positive readings."""

import math

import pytest

from dspi_tpu_torch import bench_stages

TINY = bench_stages.Settings(B=8, NPKT=1, ITERS=1, DEPTH=1, device="cpu",
                             sweep_widths=(8, 16), pdm_chain=1,
                             schedule=(44, 45))
KEYS = {"pdm": {"pdm_alone"}, "pdm_sweep": {"pdm_B8", "pdm_B16"},
        "chain": {"full_chain"}, "wire": {"full_chain_wire"},
        "wire_q28": {"full_chain_wire_q28"}, "nopdm": {"chain_no_pdm"},
        "passthrough": {"passthrough"}, "peq": {"peq10"},
        "full96": {"full_96k"}, "q28": {"full_chain_q28"},
        "grouped": {"grouped_k8"}, "hetero": {"hetero_k8_scattered"},
        "grouped_q28": {"grouped_k8_q28"}, "hetero_q28": {"hetero_k8_q28"},
        "deframe": {"deframe_dev_resident"},
        "deframe24": {"deframe_dev_resident_s24"},
        "sched441": {"full_44k1_sched"},
        "sched441_q28": {"full_44k1_sched_q28"}}


def test_every_stage_has_a_case():
    assert set(KEYS) == set(bench_stages.STAGES)


@pytest.mark.parametrize("stage", bench_stages.STAGES)
def test_stage_runs_on_cpu(stage):
    out = bench_stages.run_stage(stage, TINY)
    assert set(out) == KEYS[stage]
    for entry in out.values():
        if "rtf" in entry:
            assert math.isfinite(entry["rtf"]) and entry["rtf"] > 0
        else:                                   # the deframe stages
            assert entry["wall_chain_alone"] > 0
            assert math.isfinite(entry["deframe_ms_per_segment"])
    if stage.startswith("hetero"):
        assert next(iter(out.values()))["padding_waste"] >= 0
    if stage == "full96":
        assert out["full_96k"]["peak_gb"] is None       # no card here


def test_unknown_stage_is_refused():
    with pytest.raises(ValueError, match="unknown stage"):
        bench_stages.run_stage("sweep", TINY)
