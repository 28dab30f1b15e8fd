"""Multi-tenant Pico 2 presets on the float chain's scan lowering, the
benchmark's ``rp2350_scan`` deployment: ``HeteroServer(..., mxu=False)``
on the configuration file and its 8 tenant rules, against the benchmark's
frozen golden model (``benchmark/reference``: NumPy float32, nothing of
the program) on every stream.

On the CPU the scan lowering's recurrences are the kernels' plain
versions, which round every float32 operation on its own in the
firmware's order, as the golden model does, so every word is held equal:
the s24 sums, peaks and PDM word sums of each chained segment, and after
the last every state leaf (filter states, leveller, crossfeed, delay
rings, the PDM counters and the clip flags) at the stream's lane in the
server's bucket layout.
"""

import functools
import json

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.entries.hetero import bucket_lanes
from benchmark.harness import ROOT
from benchmark.reference import config as ref_config
from benchmark.reference import lanes
from dspi_tpu_torch.chain import HeteroServer, pipeline
from dspi_tpu_torch.params import types as program_types

K, G, NPKT, BLOCK, NSEG = 8, 16, 3, 48, 2
SEEDS = (0x5CA1, 0x5CA2, 0x5CA3)
SPEC = ref_config.load("rp2350_scan")
TENANTS = json.loads((ROOT / "workloads" / "rp2350_scan_tenants8.json")
                     .read_text())["traffic"]["tenants"]


def _server(ids, **kw):
    cfgs = [ref_config.build(SPEC, program_types, t) for t in TENANTS]
    return HeteroServer(cfgs, ids, block_size=BLOCK, emit="reduced",
                        pdm=True, pdm_fade=False, mxu=False, device="cpu",
                        **kw)


def _ids(seed: int, equal: bool) -> np.ndarray:
    """Each tenant's 16 streams in a seeded order, or 24 streams of
    seeded tenants (unequal buckets, some empty, padding lanes)."""
    rng = np.random.default_rng(seed)
    if equal:
        return rng.permutation(np.repeat(np.arange(K), G))
    return rng.integers(0, K, size=24)


@functools.lru_cache(maxsize=None)
def _run(seed: int, equal: bool):
    """NSEG chained segments of the server and of the reference: (the
    server's outputs a segment, its state at each stream's lane, the
    reference's results a stream, the server)."""
    ids = _ids(seed, equal)
    B = len(ids)
    srv = _server(ids)
    rng = np.random.default_rng([seed, 1])
    x = rng.integers(-16000, 16000, (NPKT, 2, BLOCK, B), dtype=np.int32)
    outs = [{k: v.numpy() for k, v in srv.process(
        torch.from_numpy(x ^ i)).items()} for i in range(NSEG)]
    width = srv.grouped.state.lev_gain.shape[-1] // K
    lane = torch.from_numpy(bucket_lanes(ids, K, width))
    state = {f: v.index_select(-1, lane).numpy()
             for f, v in zip(srv.state._fields, srv.state)
             if v is not None and v.dim() > 0}
    ref = [lanes.run_lane({
        "spec": SPEC, "block": BLOCK, "state": None,
        "tenant": TENANTS[ids[s]],
        "xs": np.stack([x[..., s] ^ i for i in range(NSEG)])})
        for s in range(B)]
    return outs, state, ref, srv


def _assert_every_word_equal(seed, equal):
    outs, state, ref, _ = _run(seed, equal)
    B = len(ref)
    for j, out in enumerate(outs):
        for k in compare.OUT_KEYS:
            want = np.stack([np.asarray(r["outs"][j][k]) for r in ref], -1)
            assert out[k].shape[-1] == B, k
            np.testing.assert_array_equal(compare._wrap32(out[k]),
                                          compare._wrap32(want),
                                          err_msg=f"segment {j} {k}")
    assert set(state) == set(ref[0]["state"]) - {
        f for f, v in ref[0]["state"].items() if v is None}
    for f, got in state.items():
        want = np.stack([np.asarray(r["state"][f]) for r in ref], -1)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.astype(got.dtype).view(np.int32),
                                      err_msg=f)
    nums = compare.float_numbers([{"prog": {"outs": outs, "state": state},
                                   "ref": ref}])
    assert nums == {"state_gap": 0.0, "s24_gap": 0.0, "exact_mismatch": 0.0}


@pytest.mark.parametrize("seed", SEEDS)
def test_every_stream_matches_the_reference(seed):
    """8 x 16 streams of the 8 tenants, in a seeded order."""
    _assert_every_word_equal(seed, True)


@pytest.mark.parametrize("seed", SEEDS)
def test_padding_lanes_do_not_leak(seed):
    """Unequal buckets (tenants drawn for 24 streams): the padding lanes
    recompute a stream of their bucket, and every real stream's outputs
    and state are still its own reference's, word for word."""
    ids = _ids(seed, False)
    srv = _run(seed, False)[3]
    assert srv.padding_waste > 0
    assert srv.grouped.state.lev_gain.shape[-1] > len(ids)
    _assert_every_word_equal(seed, False)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_flat_layout_and_per_lane_kernels_are_taken(seed, monkeypatch):
    """The server runs the flat per-lane layout with no block matrices,
    and a segment makes two float cascade calls on per-lane
    coefficients ([G, rows, 11, lanes]) and one crossfeed call."""
    ids = _ids(seed, True)
    srv = _server(ids)
    assert srv.grouped.layout == "flat" and srv.grouped.blocks is None
    assert pipeline._master_lane(srv.static, srv.params)
    calls = []
    cascades, xf = pipeline.f32_cascades, pipeline.xf_f32

    def cascade_spy(x, cf, *a, **kw):
        calls.append(("f32_cascades", tuple(cf.shape)))
        return cascades(x, cf, *a, **kw)

    def xf_spy(l, r, coef, s4):
        calls.append(("xf_f32", tuple(coef.shape)))
        return xf(l, r, coef, s4)

    monkeypatch.setattr(pipeline, "f32_cascades", cascade_spy)
    monkeypatch.setattr(pipeline, "xf_f32", xf_spy)
    x = np.random.default_rng(seed).integers(
        -16000, 16000, (1, 2, BLOCK, len(ids)), dtype=np.int32)
    srv.process(torch.from_numpy(x))
    lanes_ = srv.grouped.state.lev_gain.shape[-1]
    assert calls == [("f32_cascades", (2, 12, 11, lanes_)),
                     ("xf_f32", (3,)),
                     ("f32_cascades", (9, 10, 11, lanes_))]
