"""The port's spans (``runtime.telemetry.span``): under ``torch.profiler``
every segment emits its span tree once, nested as its phases run; with no
profiler recording no span opens; a profile changes no output or state
word; and the span helper imports nothing of the chain."""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, HeteroServer
from dspi_tpu_torch.configs import full_chain_config, hetero_variants
from dspi_tpu_torch.kernels import build
from dspi_tpu_torch.runtime import telemetry
from dspi_tpu_torch.runtime.executor import ack_fold

from util import make_input

# the CPU runs the kernels' plain versions, whose per-sample loops the
# profiler records op by op: one packet a segment, and the PDM sub off
B, NPKT, BLOCK, NSEG = 2, 1, 48, 2
PHASES = ["dspi.unpack", "dspi.master", "dspi.leveller", "dspi.outputs",
          "dspi.tail", "dspi.wire"]
PATHS = ("float_block", "float_scan", "q28", "q28_hetero")


def _engine(path):
    kw = dict(block_size=BLOCK, emit="reduced", pdm=False, device="cpu")
    if path == "q28_hetero":
        return HeteroServer(hetero_variants(2, Platform.RP2040),
                            np.arange(B) % 2, **kw)
    platform = Platform.RP2040 if path == "q28" else Platform.RP2350
    return Engine(full_chain_config(platform), n_streams=B,
                  mxu=path != "float_scan", **kw)


def _tree(prof) -> list:
    """The program's spans in the order they opened, each with the span
    it nests in (None at the top): [(name, parent), ...].  The profiler's
    raw events, nested by time (one thread), since parsing every recorded
    op of the plain kernels takes minutes."""
    spans = sorted((e.start_ns(), -e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(telemetry.SPAN_PREFIX))
    out, open_ = [], []
    for s, neg_e, name in spans:
        while open_ and open_[-1][0] <= s:
            open_.pop()
        out.append((name, open_[-1][1] if open_ else None))
        open_.append((-neg_e, name))
    return out


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


@functools.lru_cache(maxsize=None)
def _runs(path):
    """NSEG segments of the path on two engines, one of them with a
    profiler recording, and the spans opened outside and inside it:
    (plain outputs, traced outputs, their engines, the traced spans'
    tree, names opened with no profiler, names opened under it)."""
    real, opened = telemetry._open, []

    def counting(name):
        opened.append(name)
        return real(name)

    plain, traced = _engine(path), _engine(path)
    x = make_input(np.random.default_rng(0x5A7), NPKT, BLOCK, B)
    want, got = [], []
    telemetry._open = counting
    try:
        for i in range(NSEG):
            want.append(plain.process(x ^ i))
            ack_fold(want[-1])
        closed = list(opened)
        prof = _traced(lambda: [got.append(traced.process(x ^ i))
                                for i in range(NSEG)]
                       + [ack_fold(got[-1])])
    finally:
        telemetry._open = real
    return (want, got, plain, traced, _tree(prof), closed,
            opened[len(closed):])


@pytest.mark.parametrize("path", PATHS)
def test_each_segment_emits_its_span_tree_once(path):
    *_, traced, tree, _, opened = _runs(path)
    top = ["dspi.segment"]
    if path == "q28_hetero":
        top = ["dspi.bucket_in", "dspi.segment", "dspi.bucket_out"]
    assert [n for n, p in tree if p is None] == top * NSEG + ["dspi.ack_fold"]
    assert [n for n, p in tree if p == "dspi.segment"] == PHASES * NSEG
    q15 = [p for n, p in tree if n == "dspi.q15_mul"]
    st = traced.static
    if st.is_float:
        assert q15 == []
    else:
        # volume staging, two a matrix row, one an output gain
        live = [o for o in range(st.n_outputs) if st.output_enabled[o]]
        gains = [o for o in live if not st.output_mute[o]]
        assert len(q15) == NSEG * (2 + 2 * len(live) + len(gains))
        assert set(q15) == {"dspi.unpack", "dspi.outputs", "dspi.tail"}
    assert len(tree) == NSEG * (len(top) + len(PHASES)) + len(q15) + 1
    assert sorted(opened) == sorted(n for n, _ in tree)


@pytest.mark.parametrize("path", PATHS)
def test_no_span_opens_without_a_profiler(path):
    closed = _runs(path)[5]
    assert closed == []


@pytest.mark.parametrize("path", PATHS)
def test_a_profile_changes_no_word(path):
    want, got, plain, traced = _runs(path)[:4]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for f, a, b in zip(plain.state._fields, plain.state, traced.state):
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f


def test_ack_fold_and_kernel_load_spans(monkeypatch, tmp_path):
    out = {"peaks": torch.arange(6, dtype=torch.int32).reshape(3, 2)}
    assert _tree(_traced(lambda: ack_fold(out))) == [("dspi.ack_fold", None)]
    # a library built at first use: one span; loaded again, none
    lib = tmp_path / "libx.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "lib_path", lambda *a: lib)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda p: ("lib", p))
    tree = _tree(_traced(lambda: [build.load("x") for _ in range(3)]))
    assert tree == [("dspi.kernel_load", None)]


def test_the_profiler_class_a_span_opens_exists():
    # span() opens this private class of torch while a profiler records
    # (``telemetry._open``); a torch that renamed it fails here first
    assert hasattr(torch._C._profiler, "_RecordFunctionFast")
    def probe():
        with telemetry._open("dspi.probe"):
            pass

    assert _tree(_traced(probe)) == [("dspi.probe", None)]


def test_span_imports_nothing_of_the_chain():
    code = ("import sys; import dspi_tpu_torch.core.qmath; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('dspi_tpu_torch.chain')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert out.strip() == "[]"
