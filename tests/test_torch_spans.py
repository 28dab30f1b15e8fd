"""The port's spans (``runtime.telemetry.span``): under ``torch.profiler``
every segment emits its span tree once, nested as its phases run; with no
profiler recording no span opens; a profile changes no output or state
word; and the span helper imports nothing of the chain.  The spans'
record (``telemetry.record``): a summary a segment of what its spans did,
kept only while a profiler records; and its upload site
(``telemetry.upload``), the same tensors as the code it replaced."""

import functools
import subprocess
import sys
from itertools import count

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
OUTPUT_SPANS = ["dspi.xf", "dspi.mix", "dspi.out_eq"]
PATHS = ("float_block", "float_scan", "q28", "q28_hetero")
SCAN_SPANS = ("dspi.f32_cascade",)


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
    tree, names opened with no profiler, names opened under it, the
    record's summaries before and after the profiled segments)."""
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
        before = telemetry.record(telemetry.KEEP)
        prof = _traced(lambda: [got.append(traced.process(x ^ i))
                                for i in range(NSEG)]
                       + [ack_fold(got[-1])])
        after = telemetry.record(NSEG)
    finally:
        telemetry._open = real
    return (want, got, plain, traced, _tree(prof), closed,
            opened[len(closed):], before, after)


@pytest.mark.parametrize("path", PATHS)
def test_each_segment_emits_its_span_tree_once(path):
    traced, tree, _, opened = _runs(path)[3:7]
    top = ["dspi.segment"]
    if path == "q28_hetero":
        top = ["dspi.bucket_in", "dspi.segment", "dspi.bucket_out"]
    assert [n for n, p in tree if p is None] == top * NSEG + ["dspi.ack_fold"]
    assert [n for n, p in tree if p == "dspi.segment"] == PHASES * NSEG
    inner = [n for n, p in tree if p == "dspi.outputs"]
    q15 = [p for n, p in tree if n == "dspi.q15_mul"]
    st = traced.static
    if st.is_float:
        assert q15 == []
    else:
        # volume staging two, the matrix mix one (all live outputs in
        # one kernel call); the output gains' Q15 products are the segment
        # tail's, inside dspi.tail, and open no span of their own
        assert len(q15) == NSEG * (2 + 1)
        assert set(q15) == {"dspi.unpack", "dspi.mix"}
    scan = [n for n, _ in tree if n in SCAN_SPANS]
    assert len(tree) == (NSEG * (len(top) + len(PHASES)) + len(inner)
                         + len(q15) + len(scan) + 1)
    assert sorted(opened) == sorted(n for n, _ in tree)


@pytest.mark.parametrize("path", PATHS)
def test_scan_lowering_spans_nest_in_master_and_outputs(path):
    """The scan lowering's float cascade calls: one span in
    ``dspi.master`` and one in ``dspi.outputs``' ``dspi.out_eq``, once a
    segment each; no other path opens them.  Its crossfeed opens the
    ``dspi.xf`` of every path (``dspi.xf_f32`` is gone)."""
    tree = _runs(path)[4]
    got = [(n, p) for n, p in tree if n in SCAN_SPANS]
    if path == "float_scan":
        assert got == [("dspi.f32_cascade", "dspi.master"),
                       ("dspi.f32_cascade", "dspi.out_eq")] * NSEG
    else:
        assert got == []
    assert "dspi.xf_f32" not in {n for n, _ in tree}


@pytest.mark.parametrize("path", PATHS)
def test_outputs_opens_xf_mix_and_out_eq(path):
    """Every chain and lowering splits ``dspi.outputs`` into the same
    three spans, once a segment each, in the order they run: the
    crossfeed, the matrix mix, the per-output EQ (the headline configs
    have all three); the master peaks stay in ``dspi.outputs`` itself."""
    tree = _runs(path)[4]
    assert [n for n, p in tree if p == "dspi.outputs"] == \
        OUTPUT_SPANS * NSEG
    assert [p for n, p in tree if n in OUTPUT_SPANS] == \
        ["dspi.outputs"] * (3 * NSEG)


@pytest.mark.parametrize("path", PATHS)
def test_the_record_summarises_each_segment(path):
    """Under the profiler the record gains one summary a segment, holding
    the spans opened inside it and the segment's host seconds; on the CPU
    no device seconds and no upload (a copy to the CPU is none); with no
    profiler it gains nothing."""
    tree, closed, _, before, after = _runs(path)[4:9]
    assert closed == [] and len(after) == NSEG
    assert after != before[-NSEG:]
    top = [n for n, p in tree if p is None]
    inside = {n for n, _ in tree if n not in
              ("dspi.bucket_in", "dspi.bucket_out", "dspi.ack_fold")}
    assert top.count("dspi.segment") == NSEG
    for summ in after:
        assert set(summ) == inside
        for n, e in summ.items():
            assert (e["device_s"], e["uploads"], e["upload_s"]) == \
                (None, 0, 0.0)
            assert ("host_s" in e) == (n == "dspi.segment")
        assert summ["dspi.segment"]["host_s"] > 0.0


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


class _Clock:
    """``time.perf_counter`` for the record: each read one tick later."""

    def __init__(self, tick=1.0):
        self.t = count()
        self.tick = tick

    def __call__(self):
        return next(self.t) * self.tick


def test_the_record_times_the_segment_and_bounds_its_summaries(
        monkeypatch):
    """Nested spans on a clock that ticks once a read: a summary a segment
    with every span opened inside it, the segment's host seconds and no
    other host time read; spans outside a segment kept out; the oldest
    summaries dropped past KEEP."""
    monkeypatch.setattr(telemetry, "_REC", telemetry._Record(keep=3))
    monkeypatch.setattr(telemetry.time, "perf_counter", _Clock())
    span = telemetry.span
    with profile(activities=[ProfilerActivity.CPU]):
        with span("dspi.ack_fold"):                  # outside a segment
            pass
        for k in range(5):
            with span("dspi.segment", "cpu"):        # reads 2k, 2k + 1
                with span("dspi.outputs"):
                    with span("dspi.mix"):
                        pass
                    with span("dspi.mix"):
                        telemetry.upload([k], "cpu")  # no copy, no read
                        with span("dspi.q15_mul"):
                            pass
    got = telemetry.record(10)
    assert len(got) == 3 and len(telemetry.record(2)) == 2
    assert telemetry.record(0) == []
    for summ in got:
        assert set(summ) == {"dspi.segment", "dspi.outputs", "dspi.mix",
                             "dspi.q15_mul"}
        assert summ["dspi.segment"]["host_s"] == 1.0
        assert all(e["device_s"] is None and e["uploads"] == 0
                   for e in summ.values())
        assert [n for n, e in summ.items() if "host_s" in e] == \
            ["dspi.segment"]


def test_uploads_count_against_the_innermost_span(monkeypatch):
    """A copy to a card counts one upload and its seconds against the
    innermost open span (here a CPU copy stands in for the
    copy to the card); a copy to the CPU counts none."""
    monkeypatch.setattr(telemetry, "_REC", telemetry._Record(keep=4))
    monkeypatch.setattr(telemetry.time, "perf_counter", _Clock(0.5))
    real = torch.Tensor.to
    monkeypatch.setattr(
        torch.Tensor, "to", lambda self, dev, *a, **k:
        self.clone() if str(dev) == "cuda" else real(self, dev, *a, **k))
    span = telemetry.span
    with profile(activities=[ProfilerActivity.CPU]):
        with span("dspi.segment", "cpu"):
            telemetry.upload(np.arange(6, dtype=np.int32), "cuda")
            with span("dspi.sched"):
                telemetry.upload([1, 2, 3], "cuda", torch.int32)
                telemetry.upload([4], "cpu")
                telemetry.upload([4], "cuda")
    (summ,) = telemetry.record(1)
    assert (summ["dspi.segment"]["uploads"],
            summ["dspi.segment"]["upload_s"],
            summ["dspi.segment"]["host_s"]) == (1, 0.5, 3.5)
    assert (summ["dspi.sched"]["uploads"],
            summ["dspi.sched"]["upload_s"]) == (2, 1.0)


def test_no_record_and_no_event_without_a_profiler(monkeypatch):
    """With no profiler a span is the shared no-op and an upload a plain
    copy: the record gains nothing and no CUDA event is made; under one on
    the CPU, still no event."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    n = len(telemetry._REC.summaries)
    last = telemetry.record(1)
    with telemetry.span("dspi.segment", "cpu") as s:
        assert s is None
        t = telemetry.upload([3, 1], "cpu", torch.int32)
    assert torch.equal(t, torch.tensor([3, 1], dtype=torch.int32))
    assert len(telemetry._REC.summaries) == n
    assert telemetry.record(1) == last
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("dspi.segment", torch.device("cpu")):
            pass
    assert telemetry.record(1)[0]["dspi.segment"]["device_s"] is None
    assert made == []


@pytest.mark.parametrize("site", ["scatter", "loudness", "ends", "rows",
                                  "numpy"])
def test_the_upload_site_gives_the_tensors_it_replaced(site):
    """Each site routed through ``telemetry.upload`` computes what its old
    form did: list-indexed writes and reads as ``index_put_`` and
    ``index_select``, host arrays and lists as tensors of their dtype."""
    up = telemetry.upload
    g = torch.Generator().manual_seed(7)
    if site == "scatter":
        a = torch.randn(3, 5, 4, generator=g)
        b, v = a.clone(), torch.randn(3, 4, generator=g)
        cs, bs = [0, 2, 1], [4, 0, 2]
        a[cs, bs] = v
        b.index_put_((up(cs, "cpu"), up(bs, "cpu")), v)
        want, got = a, b
    elif site == "loudness":
        sF = torch.randn(2, 9, 4, generator=g)
        want = (sF[:, [0, 2]], sF[:, [1, 3]])
        got = (sF.index_select(1, up([0, 2], "cpu")),
               sF.index_select(1, up([1, 3], "cpu")))
        assert all(w.dtype == x.dtype for w, x in zip(want, got))
        want, got = torch.stack(want), torch.stack(got)
    elif site == "ends":
        sched = np.array([44] * 9 + [45], np.int64)
        want = torch.from_numpy(np.cumsum(sched).astype(np.int32)).to("cpu")
        got = up(np.cumsum(sched).astype(np.int32), "cpu")
    elif site == "rows":
        want = torch.tensor([(1 << 28, 0, 0, 0, 0)], dtype=torch.int32)
        got = up([(1 << 28, 0, 0, 0, 0)], "cpu", torch.int32)
    else:
        sched = np.array([44, 45, 44])
        want = torch.from_numpy(sched - 1).to("cpu")
        got = up(sched - 1, "cpu")
    assert got.dtype == want.dtype and torch.equal(got, want)
