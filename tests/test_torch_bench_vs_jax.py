"""The port's benchmark loop against the JAX package's engine.

``dspi_tpu_torch.bench.chained_segments`` (``depth`` segments, segment i on
``x ^ i``, state carried: the loop ``bench_engine`` times) gives the
outputs of the JAX package's ``Engine`` fed the same inputs in turn from
the same params and state: on the Q28 chain with the device wire words,
every output and wire word; on the float chain, the peaks within 1 LSB,
the s24 sums within 1e-6 relative and the PDM sums equal; the clip flags
equal.  This shows the carried state and the fresh input.  (The folds
are not compared: the port carries uint32 words as int32, so its fold
differs from the JAX package's.)"""

import numpy as np
import pytest
import torch

import bench as jbench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu_torch import Platform, bench
from dspi_tpu_torch.chain import Engine
from dspi_tpu_torch.configs import full_chain_config

B, DEPTH = 2, 3


def _pair(plat, wire):
    jcfg = jbench.full_chain_config(plat)
    je = JEngine(jcfg, n_streams=B, block_size=48, emit="reduced",
                 pdm_fade=False, wire=wire, unroll=1)
    te = Engine(full_chain_config(Platform(plat.value)), n_streams=B,
                emit="reduced", pdm_fade=False, wire=wire, device="cpu")
    te.load_params_state(je.params, je.state)
    return je, te


@pytest.mark.parametrize("case", ["float", "q28_wire"])
def test_chained_segments_match_jax_engine(case):
    je, te = _pair(JPlatform.RP2040 if case == "q28_wire"
                   else JPlatform.RP2350, wire=case == "q28_wire")
    x = bench.bench_input(B, 4, 48, None, "cpu")
    pm = torch.ones(4, dtype=torch.float32)
    kept = []
    te.state, _ = bench.chained_segments(te.segment_fn, te.params, te.state,
                                         x, pm, DEPTH, keep=kept)
    xs = x.numpy()
    for i, got in enumerate(kept):
        want = {k: np.asarray(v) for k, v in je.process(xs ^ i).items()}
        got = {k: v.numpy() for k, v in got.items()}
        assert set(got) == set(want), i
        for k in want:
            g, w = got[k].astype(np.int64), want[k].astype(np.int64)
            if case == "q28_wire" or k == "pdm_sum":
                if k in ("pdm_sum", "wire_sum"):
                    g, w = g & 0xFFFFFFFF, w & 0xFFFFFFFF
                assert np.array_equal(g, w), (i, k)
            elif k == "peaks":
                assert np.abs(g - w).max() <= 1, (i, k)
            else:
                rel = np.abs(g - w).max() / max(np.abs(w).max(), 1)
                assert rel <= 1e-6, (i, k, rel)
    # the leveller's 480-sample lookahead holds the first 2.5 segments
    assert np.any(want["s24_sum"] != 0)
    assert np.array_equal(te.state.clip_flags.numpy(),
                          np.asarray(je.state.clip_flags))
