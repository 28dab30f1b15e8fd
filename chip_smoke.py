#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

  1. the card: name and power limit (nvidia-smi)
  2. build every CUDA kernel from dspi_tpu_torch/kernels/csrc/ (nvcc, one
     process per library, all in parallel: one a source, and for the
     float cascade kernel one a band-kinds signature that the phases
     below launch), with each source's register and spill report from
     ptxas and each float cascade instance's registers, spills and
     seconds; then the first use of a signature none of them has (the
     output call's after a SET_EQ changes a band's type), timed alone
  3. PDM kernel vs its plain PyTorch version on the card: 4100 streams (a
     ragged edge), three 96-sample segments with per-lane enable flips
     (fade-out, stop, restart, mid-fade re-enable); words and all 16 state
     rows bit-equal.  Then the kernel alone at the headline shape
     (16384 streams x 6144 samples) and at the hetero path's 17408 lanes,
     timed with CUDA events, beside its bound (the function's pinned
     operation counts, PDM_OPS) and the build's own SASS counts; both
     calls are held against the plain version in phase 12
  4. Q28 cascade kernel vs its plain version on the card: 4100 streams, two
     packets, (loudness, envelope, bands) = (no, no, 3), (yes, no, 2),
     (no, yes, 0), (yes, yes, 10), (no, no, 10), bypass flags and envelope
     alphas that differ per cascade; outputs, envelopes and states equal
     word for word.  Then the same five cases in each of the kernel's other
     modes: per-lane coefficients (lane_cf) with coefficients, bypass flags
     (mixed within a warp) and alphas that differ lane by lane; a periodic
     44/45 schedule; a schedule with a 1-sample packet; lane_cf and a
     schedule together; lane_cf with columns uniform over buckets of 160
     lanes (the HeteroServer's layout)
  5. Q28 crossfeed kernel vs its plain version, the same way, with [3] and
     per-lane [3, B] coefficients.  Then the float scan lowering's two
     kernels vs their plain versions on the card, bit for bit (every float
     operation of both rounds on its own): the float cascade kernel on
     4100 streams, the master call's shape (2 cascades, loudness + 10
     bands + envelope, the headline's band kinds), the output call's (9
     cascades, 10 bands) and band kinds that differ across cascades (SKIP
     rows among them), in its scalar, per-lane, 44/45-schedule and
     per-lane + 1-sample-packet-schedule modes, with the envelope's
     packet-end flush firing, and the master call's at full length (6144
     samples); the float crossfeed over three chained segments, the last
     with per-lane coefficients.  A mismatch prints the largest gap and
     fails
  6. the float main path at full width: Engine on the headline RP2350
     chain at 48 kHz, 16384 streams, 4 chained segments of 128 packets x 48
     samples with state carried and a fresh input each (x ^ i); launch
     counts reset just before and read just after; per-segment time and
     real-time factor.  Then the PDM call of one more segment, timed alone
     on the path's own arguments beside its bound and held against the
     plain version in phase 12
  7. card vs CPU on the float chain at 8 streams: out/s24 <= 1e-6 relative
     RMS, peaks within 1 LSB, PDM words equal up to the first differing
     modulator input
  8. the Q28 main path at full width: Engine on the RP2040 headline chain
     (full_chain_config, 7 channels), the same geometry, 16- and 24-bit
     input, 4 chained segments each; fails unless a segment launches the
     cascade kernel twice, the crossfeed kernel once and the PDM kernel
     once.  Then the cascade, crossfeed and PDM kernels alone, on the
     very arguments the path gave them, timed with CUDA events, beside
     their bounds (the crossfeed's from XF_OPS, the PDM kernel's from
     PDM_OPS and the per-lane cascade's from EQ_LANE_OPS, with the build's
     own SASS counts beside); and each of those
     calls at its full shape held word for word against the plain version
     run on the CPU over 128 of its streams (the PDM calls in phase 12)
  9. card vs CPU on the Q28 chain at 8 streams, 16- and 24-bit: every
     output word and every state word equal
 10. the multi-tenant path at full width: HeteroServer over 8 configs of
     one structure (hetero_variants) scattered over 16384 streams, 48 kHz,
     the same geometry; its cascade calls run lane_cf.  Then the 44.1 kHz
     path: Engine on the RP2040 headline chain at 44.1 kHz, 16384 streams,
     130 packets on the 44/45 cadence (5733 samples); its cascade calls run
     the schedule mode.  Each as phase 8 (warm-up, 4 chained segments,
     launches per segment exactly 2 cascade, 1 crossfeed, 1 PDM, each call
     of one more segment timed alone and held against the plain version
     on 128 streams), with the padding waste for the server
 11. card vs CPU on both: a HeteroServer of 3 configs over 24 scattered
     streams, 2 segments with an update_group between; a 44.1 kHz Engine
     at 8 streams, 2 segments; every output word and every state word equal
 12. the float chain's serving paths at full width, each as phase 6
     (warm-up, 4 chained segments, exactly 1 PDM launch a segment, the PDM
     call of one more segment timed alone beside its bound): the float
     chain with the device wire words (examples/serve.py's engine:
     wire=True, emit "reduced"), with the wire stage's synchronized time
     beside the segment's and a fused encoder's byte bound; the float
     chain at 44.1 kHz (130 packets on the 44/45 cadence, 5733 samples),
     with the LTI block size chosen; a HeteroServer over 8 RP2350 configs
     of one structure over 16384 scattered streams (one flat lane axis,
     per-group block matrices), with its padding waste.  Each prints its
     setup time
 13. card vs CPU on this slice's paths: the float wire engine (8 streams, 2
     segments; its words equal to the port's encoder run on the CPU over
     the card's own s24), the Q28 wire engine (every word equal), the
     float 44.1 kHz engine (8 streams, 2 segments), a float HeteroServer
     (3 configs over 24 scattered streams, an update_group between 2
     segments) and the float engine at 24-bit input: out/s24 <= 1e-6
     relative RMS, PDM words equal up to the first differing modulator
     input
 13b. the float scan lowering at full width, each as phase 6: the headline
     RP2350 chain with mxu=False (float_scan; launches a segment exactly
     2 float cascade, 1 float crossfeed, 1 PDM) and a HeteroServer over 8
     RP2350 configs with mxu=False, the flat per-lane layout over 17,408
     lanes (float_scan_hetero; both cascade calls per lane); each kernel
     call of one more segment timed alone beside its bound (the pinned
     float operation counts, F32_BAND_OPS and XF_F32_OPS, or the bytes),
     the float cascade calls with their instances' registers, resident
     warps, waves and sample-loop SASS a sample (failing on a branch in
     that loop other than its back edge), and held bit for bit against
     the plain version on the CPU over 128 of its streams.  Then card vs
     CPU on the scan engine at 8 streams, 48 kHz (3 segments of 4
     packets) and 44.1 kHz (2 segments of 441 samples): float_close
 14. the serving entry point (dspi_tpu_torch.serve, examples/serve.py's
     twin) at full width, as a user runs it: serve_chained at 16384
     streams, batches of 8 chained segments of 32 packets (device wire
     words, one readback a batch), fed s16 payload words deframed on the
     card and packed s24 bytes deframed on the host (native/dspi_host.cpp
     built into dspi_tpu_torch/_build/); serve_hetero over 8 configs fed
     s16 payload words; 5 batches each (a warm-up, then 4 read) with the
     mid-run commits.  The entry point prints each batch (wall, RTF, each
     stream's real-time ratio, upload, launches, starvations); this
     script prints each run's summary and peak memory.  Fails unless
     every segment launched the PDM kernel exactly once and nothing else,
     and the starvation counters equal the firmware's count of the feed
     gaps over a batch's audio time; starvations themselves do not fail
 15. runner card vs CPU: a ChainedRunner fed payloads through
     pre=make_pre, 8 streams, 3 segments, 16- and 24-bit: the RP2040
     chain's folds, peaks, clips and every state word equal; the RP2350
     chain's clips equal, peaks within 1 LSB, float state within 1e-6
     relative RMS (the leveller's envelope and gain within 1e-5, their
     budget against the golden model)
 15b. tests/test_fuzz.py's random configs (a copy, random_config) at full
     width, 16384 lanes x 24 packets of 48, one segment each, against the
     port's golden model on the first and the last lane: the Q28 chain on
     6 seeds and on 2 random aperiodic 9-packet schedules (3 segments)
     word for word (out, s24, PDM words, peaks, clip flags); the float
     scan lowering on 6 seeds bit for bit, building the float cascade
     libraries of their band-kinds signatures at first use (each build's
     time printed); the block lowering on the same seeds card vs CPU
     (float_close) where the CPU port meets 1e-6 against the golden
     model, else (fault F1) the card no farther from the golden model
     than 1.5x the CPU port on the same lanes.  Each kernel call of a
     first segment held at its full shape against the plain version on
     the CPU over 128 lanes (the PDM calls in phase 16); launches set to
     0 before each segment and read after it; the phase's time printed
 16. the PDM kernel's calls at full length (the two timed in phase 3, the
     one of each path in phases 6, 8, 10, 12 and 13b, the first of
     phase 14 and those of phase 15b) against the plain version on the
     CPU over the first and the last 64 lanes of each, all lanes of one
     segment length in one plain call (its time goes by samples, not
     lanes), the segment lengths' calls in parallel worker processes:
     every word and state word equal
 17. the benchmark twin's headline (dspi_tpu_torch.bench.bench_engine) at
     full width: the headline float chain, 16384 streams x 128 packets, 8
     chained segments a run (x ^ i each), best of 2 runs from the
     restored state with every run's fold equal, and one synchronous
     segment's latency, beside phase 6's float path of this run; then
     bench_stages' full96 at full width (16384 streams x 64 packets x 96
     samples) with its peak memory; then every other bench_stages stage
     once at 1024 streams x 8 packets.  Each with its launches, set to 0
     just before and read just after
 18. graft_entry: dryrun_multichip(1), its seven sections over a mesh of
     this card, ticked; entry()'s step card vs CPU
 19. the firmware oracles (dspi_tpu_torch.native, built with g++) against
     the card's engines on 8 streams x 24 packets, half of them quiet: the
     float chain on its block matmuls within 1e-6 relative RMS of
     FirmwareFloat on the loud streams and of the golden model on all
     (the quiet streams no farther from FirmwareFloat than the golden
     model, which sits ~3.5e-6 from it there); the Q28 chain word for word
     with FirmwareQ28 with the leveller off, within tests/test_fw_oracle.py's
     48 kHz LSB bounds on its q5 config with the leveller on, and word for
     word with the golden model on the headline chain with the leveller on
     (its distance to FirmwareQ28 read)
 20. one JSON line {"bench": {...}, "fuzz": {...}} with phases 17-19's
     and 15b's readings, then one
     {"kernels": [...]} for every kernel of the port and each mode of the
     Q28 cascade kernel, with every path's segment time, RTF and peak
     memory, and the serving cells
 21. last line: {"ok": true, "device": {...}}

Exits non-zero, printing no result, when no CUDA device is present.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

STREAMS, PACKETS, BLOCK, SEGMENTS = 16384, 128, 48, 4
RATE = 48000.0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# 32-bit integer issue per SM and clock (CUDA C Programming Guide,
# throughput table, compute capability 9.0): 64 multiplies (IMAD, on the
# FMA pipe), 64 operations on the integer ALU, and at most 128
# thread-instructions in all (4 schedulers, one 32-thread instruction
# each).  Adds, moves and left shifts may issue to either pipe (IADD3 on
# the ALU, IMAD.IADD / IMAD.MOV / IMAD.SHL on the FMA pipe).  So a kernel's
# operation time is at least the longest of: the multiplies its function
# needs over 64, the ALU-only instructions of its sample loop over 64, and
# all per-thread arithmetic instructions there over 128 (the last two
# counted in the SASS, build.loop_counts; profile_torch.py prints the same
# counts), in SM clocks at the card's maximum SM clock, read at run time.
# Its bound is that or the bytes' time, whichever is longer.
# For the cascade kernel's scalar and schedule modes the SASS counts are
# read from the build being measured.  For the PDM modulator, the
# crossfeed and the cascade kernel's per-lane (lane_cf) instances they are
# pinned, so that a redesign is measured against the same work as the
# design before it: the counts a sample of their sample loops in the SASS
# of commit f15a17e's sources (PDM, crossfeed) and of commit 84fe37b's
# (lane_cf, keyed by (nb, loudness, envelope): the hetero path's master and
# output instances), one thread a stream, a sample an iteration; nvcc with
# build.NVCC_FLAGS for sm_90a, read with compare_kernels.py.  The new
# builds' own counts, a stream-sample, are printed beside them.
PIPE_OPS_PER_SM_CLOCK = 64
ISSUE_PER_SM_CLOCK = 128
# multiplies of two run-time values each function needs: fast_mul_q28 is
# three 16 x 16 partial products, five of them a band and three for the
# leveller envelope; the crossfeed runs eight a sample.  The PDM
# modulator's multiplies on the enabled, unfaded path are all by
# constants, which shifts and adds can do, so it needs none.
MUL_PER_BAND, MUL_PER_ENV, MUL_XF, MUL_PDM = 15, 9, 24, 0
PDM_OPS = {"alu_only": 851.0, "arith": 1744.0}
XF_OPS = {"alu_only": 25.5, "arith": 74.5}
EQ_LANE_OPS = {(10, True, True): {"alu_only": 109.0, "arith": 361.0},
               (10, False, False): {"alu_only": 74.0, "arith": 270.0}}
# The float scan lowering's kernels (eq_f32.cu, xf_f32.cu) are bound by
# float32 issue or bytes: FP32_PER_SM_CLOCK float multiplies, adds and
# subtracts a clock on each SM (4 x 32 FP32 lanes), at the card's maximum
# SM clock.  Their operation counts a stream-sample are pinned from the
# functions (kernels/eq_f32.py, kernels/xf_f32_cuda.py), every multiply,
# add and subtract counted once, since none may fuse: by band kind (SKIP
# 0, TDF2 9: 5 multiplies and 4 adds; an SVF's state 12, plus its output
# mix: low-pass 0, high-pass 3, peaking 2, shelf 5), a loudness filter a
# shelf's 17, the envelope 4 (3 multiplies, 1 add), the crossfeed 18.
FP32_PER_SM_CLOCK = 128
F32_BAND_OPS = {0: 0, 1: 9, 2: 12, 3: 15, 4: 14, 5: 17}
F32_LOUD_OPS, F32_ENV_OPS, XF_F32_OPS = 17, 4, 18
# The headline's band kinds (its first 10: HP, peaking x 2, shelf,
# peaking x 3, TDF2 x 3, the signature of all 11 channels), and the float
# cascade instances the scan paths launch at them: (loudness and envelope,
# per lane) by call.  Each is a library of its own (eq_f32_cuda.signature).
EQF_HEAD = (3, 4, 4, 5, 4, 4, 4, 1, 1, 1, 2, 5)
F32_INSTANCES = {"master": (True, False), "output": (False, False),
                 "master per lane": (True, True),
                 "output per lane": (False, True)}
# band kinds no phase builds: the output call's after a SET_EQ turns its
# first band from high-pass to peaking (phase_build times that build)
F32_NEW_KINDS = (4, 4, 4, 5, 4, 4, 4, 1, 1, 1)
# each float cascade instance phase_build built: {signature: registers,
# spill bytes, seconds}
F32_BUILT: dict = {}


def f32_instance_signature(label: str) -> int:
    """The packed signature of one of F32_INSTANCES."""
    from dspi_tpu_torch.kernels import eq_f32_cuda

    loud, lane = F32_INSTANCES[label]
    return eq_f32_cuda.signature(EQF_HEAD[:10], loud, loud, lane)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _edge_lanes(b: int, dev) -> torch.Tensor:
    """The first and the last 64 of ``b`` lanes."""
    return torch.cat([torch.arange(64), torch.arange(b - 64, b)]).to(dev)


# PDM kernel calls waiting for phase_pdm_plain: (label, x, s16, words,
# s16') of each, cut to _edge_lanes, on the CPU
PDM_HELD: list = []


def hold_pdm(label: str, x, s16, got) -> None:
    """Queue one PDM kernel call (x [T, B], s16 [16, B] -> ``got`` = (words,
    s16')) for phase_pdm_plain."""
    idx = _edge_lanes(x.shape[-1], x.device)
    PDM_HELD.append((label, *(v.index_select(-1, idx).cpu()
                              for v in (x, s16, *got))))


def _smi(query: str) -> str:
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_card() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    line = _smi("name,power.limit")
    print(f"card: {line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return torch.cuda.get_device_name(0), line


@functools.lru_cache(maxsize=None)
def sm_clocks_per_s() -> float:
    """SM clocks a second over all of card 0: SMs x max SM clock."""
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * mhz * 1e6


def phase_build() -> dict:
    """Build every kernel; print per source its kernel count, most
    registers and spill bytes, the registers of the cascade kernels'
    instances that the paths launch, and each float cascade instance;
    then time the build of one new float cascade signature alone; return
    that summary."""
    import re

    from dspi_tpu_torch.kernels import build, eq_f32_cuda

    t0 = time.perf_counter()
    sigs = {build.lib_key("eq_f32", build.SRC_DIR, eq_f32_cuda.defines(s)): s
            for s in eqf_signatures()}
    report = build.build_all(variants=[
        ("eq_f32", build.SRC_DIR, eq_f32_cuda.defines(s))
        for s in sigs.values()])
    summary = {}
    for name, r in report.items():
        regs = build.registers(r["log"])
        spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill",
                                               r["log"]))
        if name in sigs:
            F32_BUILT[sigs[name]] = {"registers": max(regs.values()),
                                     "spill_bytes": spill,
                                     "seconds": round(r["seconds"], 1)}
            continue
        summary[name] = {"kernels": len(regs),
                         "max_registers": max(regs.values()),
                         "spill_bytes": spill,
                         "seconds": round(r["seconds"], 1)}
        if name == "eq_q28":
            # the instances the q28 and hetero paths launch
            summary[name]["registers"] = {
                inst: next(n for f, n in regs.items() if inst in f)
                for inst in ("cascade_kernelILi10ELb1ELb1EE",
                             "cascade_kernelILi10ELb0ELb0EE",
                             "lane_kernelILi10ELb1ELb1EE",
                             "lane_kernelILi10ELb0ELb0EE")}
    if F32_BUILT:
        summary["eq_f32"] = {
            "instances": len(F32_BUILT),
            "max_registers": max(v["registers"] for v in F32_BUILT.values()),
            "spill_bytes": sum(v["spill_bytes"] for v in F32_BUILT.values()),
            "seconds": max(v["seconds"] for v in F32_BUILT.values()),
            "registers": {label: F32_BUILT.get(
                f32_instance_signature(label), {}).get("registers")
                for label in F32_INSTANCES}}
    print(f"build: {time.perf_counter() - t0:.1f} s; "
          f"{summary or 'nothing (cached)'}", flush=True)
    for sig, v in F32_BUILT.items():
        kinds, loud, env, lane = eq_f32_cuda.unpack_signature(sig)
        print(f"  eq_f32 instance {sig:#x} (kinds {kinds}, loudness "
              f"{loud}, envelope {env}, per lane {lane}): {v}", flush=True)
    new = eq_f32_cuda.signature(F32_NEW_KINDS, False, False, False)
    cached = build.lib_path("eq_f32", build.SRC_DIR,
                            eq_f32_cuda.defines(new)).exists()
    t1 = time.perf_counter()
    eq_f32_cuda.libraries([new])
    one = time.perf_counter() - t1
    print(f"  first use of a new float cascade signature {new:#x} (kinds "
          f"{F32_NEW_KINDS}): built and loaded in {one:.1f} s"
          f"{' (was cached)' if cached else ''}", flush=True)
    summary.setdefault("eq_f32", {})["one_instance_build_s"] = (
        None if cached else one)
    return summary


def _pdm_lane_state(b: int, dev):
    """A ChainState whose PDM rows put every machine mode in some lanes."""
    from dspi_tpu_torch.chain.pack import ChainState, to_device

    g = np.arange(b) % 6
    rng = np.random.default_rng(11)
    z = np.zeros(b, np.int32)
    st = dict(
        pdm_err=rng.integers(-9000, 9000, b).astype(np.int32),
        pdm_err2=rng.integers(-9000, 9000, b).astype(np.int32),
        pdm_ns=z[None].repeat(5, 0),
        pdm_rng=rng.integers(1, 2**32, b, dtype=np.uint64).astype(np.uint32),
        pdm_fade=np.where(g == 4, 0, 1024).astype(np.int32),
        pdm_ena=np.isin(g, (0, 1, 4)).astype(np.int32),
        pdm_run=(g != 3).astype(np.int32),
        pdm_fout=np.where(g == 2, 50, 0).astype(np.int32),
        pdm_base=np.where(g == 2, 2500, 0).astype(np.int32))
    fields = {f: st.get(f) for f in ChainState._fields}
    return to_device(ChainState(**fields), dev), g


def phase_pdm(dev) -> dict:
    """Kernel vs plain version on the card, then the kernel's time."""
    from dspi_tpu_torch.kernels import pdm_cuda
    from dspi_tpu_torch.kernels.pdm import mode_prologue, pdm_words_plain

    B, T = 4100, 2 * BLOCK
    # per-lane enables for 3 segments: 0 steady, 1 disable then re-enable
    # mid-fade, 2 fade-out ends and stops then restart, 3 stopped, 4 fade-in,
    # 5 disabled (fade-out starts)
    enables = {0: (1, 1, 1), 1: (1, 0, 1), 2: (0, 0, 1), 3: (0, 0, 0),
               4: (1, 1, 1), 5: (0, 0, 0)}
    st, g = _pdm_lane_state(B, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err = 0
    plain_ms = kern_small_ms = 0.0
    pdm_cuda.pdm_words(*(torch.zeros(s, dtype=torch.int32, device=dev)
                         for s in ((1, 1), (16, 1))))   # loads the kernel
    for seg in range(3):
        ena = np.array([enables[int(k)][seg] for k in g], np.int32)
        st = mode_prologue(st._replace(pdm_ena=torch.from_numpy(ena).to(dev)))
        s16 = pdm_cuda.pack_pdm_state(st)
        x = torch.randint(-(1 << 28), 1 << 28, (T, B), generator=gen,
                          dtype=torch.int32, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        w_plain, s_plain = pdm_words_plain(x, s16)
        ev[1].record()
        ev[2].record()
        w_kern, s_kern = pdm_cuda.pdm_words(x, s16)
        ev[3].record()
        torch.cuda.synchronize()
        plain_ms += ev[0].elapsed_time(ev[1]) / 3
        kern_small_ms += ev[2].elapsed_time(ev[3]) / 3
        if not (torch.equal(w_plain, w_kern) and torch.equal(s_plain, s_kern)):
            bad = (w_plain != w_kern).nonzero()[:5].tolist()
            fail(f"PDM kernel != plain version in segment {seg}: {bad}")
        max_err = max(max_err, int((w_plain.long() - w_kern.long()).abs()
                                   .max()))
        st = pdm_cuda.unpack_pdm_state(st, s_kern)
    silence = int(np.uint32(0xAAAAAAAA).view(np.int32))
    stopped = torch.from_numpy(g == 3).to(dev)
    restarted = torch.from_numpy(g == 2).to(dev)
    if not ((w_kern[:, :, stopped] == silence).all()
            and (st.pdm_run[restarted] == 1).all()):
        fail("PDM mode machine did not reach the expected modes")

    # the kernel alone at the headline shape: all streams modulating
    T, B = PACKETS * BLOCK, STREAMS
    x = torch.randint(-(1 << 28), 1 << 28, (T, B), generator=gen,
                      dtype=torch.int32, device=dev)
    s16 = torch.zeros((16, B), dtype=torch.int32, device=dev)
    s16[7] = 123456789
    s16[8] = 1024
    s16[9] = 1
    s16[10] = 1
    ms = cuda_ms(lambda: pdm_cuda.pdm_words(x, s16), reps=5)
    hold_pdm(f"{T}x{B}", x, s16, pdm_cuda.pdm_words(x, s16))
    bound_ms, by, text = bound(*_pdm_work(T, B))
    # the hetero path's lane count: 17408 = 8 buckets of 2176
    B2 = 17408
    x2 = torch.randint(-(1 << 28), 1 << 28, (T, B2), generator=gen,
                       dtype=torch.int32, device=dev)
    s2 = s16[:, :1].repeat(1, B2)
    ms2 = cuda_ms(lambda: pdm_cuda.pdm_words(x2, s2), reps=5)
    hold_pdm(f"{T}x{B2}", x2, s2, pdm_cuda.pdm_words(x2, s2))
    print(f"pdm: kernel == plain on 4100 streams x 3 x 96 samples "
          f"(fade-out, stop, restart, mid-fade re-enable); plain "
          f"{plain_ms:.1f} ms / kernel {kern_small_ms:.3f} ms per segment "
          f"there; headline {T}x{B}: kernel {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms by {by} ({text}); {T}x{B2}: kernel "
          f"{ms2:.3f} ms ({ms2 / ms:.3f}x), both held for the plain "
          f"version; this build's SASS a sample "
          f"{sample_ops('pdm', 'pdm_kernel', 'ldg', 1)} (pinned "
          f"{PDM_OPS})", flush=True)
    return {"name": "pdm_modulator", "route": "cuda",
            "source": "dspi_tpu_torch/kernels/csrc/pdm.cu",
            "replaces": "dspi_tpu/kernels/pdm_pallas.py:138",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "equal_to_plain": True,
            "shape": [T, B], "plain_shape": [2 * BLOCK, 4100],
            "kernel_ms_at_plain_shape": kern_small_ms,
            "ms_at_17408_lanes": ms2}


def phase_main(dev, card: str) -> dict:
    """The float main path at full width (drive_path), then its PDM call
    of one more segment (record_calls)."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    t0 = time.perf_counter()
    eng = Engine(full_chain_config(Platform.RP2350, RATE), n_streams=STREAMS,
                 block_size=BLOCK, emit="reduced", pdm=True, pdm_fade=False,
                 device=dev)
    print(f"main path: {STREAMS} streams x {PACKETS}x{BLOCK} samples, "
          f"{SEGMENTS} chained segments; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-16000, 16000, (PACKETS, 2, BLOCK, STREAMS),
                      generator=gen, dtype=torch.int32, device=dev)
    result = drive_path(dev, card, "main path", eng, x,
                        STREAMS * PACKETS * BLOCK / RATE, {"pdm": 1}, 11,
                        peak_max=32767)
    result["calls"] = record_calls(eng, x, "main path", kinds=("pdm",))
    return result


def float_close(label: str, gpu: dict, cpu: dict) -> tuple[float, int]:
    """The float budgets, card against CPU: out/s24 <= 1e-6 relative RMS,
    peaks within 1 LSB, PDM words equal for each stream up to its first
    differing modulator input (emit='full' outputs: out [Npkt, nout, T,
    B] or time-flat [nout, Ttot, B]).  Returns (the worst relative RMS,
    the sample-streams of PDM words compared)."""
    from dspi_tpu_torch.core.qmath import f32_to_i32

    worst = 0.0
    for k in ("out", "s24"):
        err = rel_rms(gpu[k].cpu().numpy(), cpu[k].numpy())
        worst = max(worst, err)
        if err > 1e-6:
            fail(f"{label}: {k} relative RMS {err:.3e} > 1e-6")
    if (gpu["peaks"].cpu() - cpu["peaks"]).abs().max() > 1:
        fail(f"{label}: peaks differ by more than 1 LSB")
    compared = 0
    if "pdm" in cpu:
        subs = []
        for o in (gpu, cpu):
            out = o["out"].cpu()
            sub = out[-1] if out.dim() == 3 else out[:, -1].reshape(
                -1, out.shape[-1])
            subs.append(f32_to_i32(sub * float(1 << 28)) >> 14)
        for s_ in range(subs[0].shape[1]):
            diff = (subs[0][:, s_] != subs[1][:, s_]).nonzero()
            k = int(diff[0, 0]) if len(diff) else subs[0].shape[0]
            if not torch.equal(gpu["pdm"][:k, :, s_].cpu(),
                               cpu["pdm"][:k, :, s_]):
                fail(f"{label}: PDM words differ in stream {s_} before the "
                     f"modulator inputs do (sample {k})")
            compared += k
    return worst, compared


def phase_card_vs_cpu(dev) -> None:
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    B, npkt, nseg = 8, 8, 2
    rng = np.random.default_rng(3)
    engs = [Engine(full_chain_config(Platform.RP2350, RATE), n_streams=B,
                   block_size=BLOCK, emit="full", device=d)
            for d in (dev, "cpu")]
    worst = 0.0
    compared = 0
    for seg in range(nseg):
        x = rng.integers(-16000, 16000, size=(npkt, 2, BLOCK, B)).astype(
            np.int32)
        gpu, cpu = (e.process(x) for e in engs)
        ref = cpu["out"].double()
        if seg == nseg - 1 and ref.pow(2).mean().sqrt() < 1e-4:
            fail("card vs CPU: reference signal is silent")
        w, n = float_close(f"card vs CPU, segment {seg}", gpu, cpu)
        worst, compared = max(worst, w), compared + n
    if (engs[0].state.clip_flags.cpu() != engs[1].state.clip_flags).any():
        fail("card vs CPU: clip flags differ")
    print(f"card vs CPU: {B} streams x {nseg} segments of {npkt}x{BLOCK}: "
          f"out/s24 worst relative RMS {worst:.3e} (<= 1e-6); PDM words "
          f"equal over {compared} sample-streams before any modulator "
          f"input differs", flush=True)


def phase_float_paths_card_vs_cpu(dev) -> None:
    """This slice's paths on the card and on the CPU: the float chain with
    wire words (8 streams, 2 segments; its words equal to the port's
    encoder run on the CPU over the card's own s24), the Q28 chain with
    wire words (every output word equal), the float chain at 44.1 kHz (8
    streams, 2 segments), a float HeteroServer (3 configs over 24
    scattered streams, 2 segments with an update_group between) and the
    float chain at 24-bit input; float budgets as float_close."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, HeteroServer
    from dspi_tpu_torch.configs import full_chain_config, hetero_variants
    from dspi_tpu_torch.kernels import encoders

    rng = np.random.default_rng(61)
    t0 = time.perf_counter()
    B, npkt = 8, 8
    cfg = full_chain_config(Platform.RP2350, RATE)
    cfg.hardware.output_types = [0, 1, 0, 0]
    engs = [Engine(cfg, n_streams=B, block_size=BLOCK, emit="full",
                   wire=True, device=d) for d in (dev, "cpu")]
    worst, pos = 0.0, 0
    for seg in range(2):
        x = rng.integers(-16000, 16000, size=(npkt, 2, BLOCK, B)).astype(
            np.int32)
        gpu, cpu = (e.process(x) for e in engs)
        worst = max(worst, float_close(f"float wire card vs CPU ({seg})",
                                       gpu, cpu)[0])
        s24 = gpu["s24"].cpu()
        flat = [s24[:, ch].reshape(-1, B) for ch in range(8)]
        for pair, typ in enumerate(engs[0].static.wire):
            lr = flat[2 * pair], flat[2 * pair + 1]
            want = (torch.stack([encoders.encode_i2s(v) for v in lr], dim=1)
                    if typ == 1 else encoders.encode_spdif_block(
                        *lr, pos, int(RATE)))
            if not torch.equal(gpu[f"wire{pair}"].cpu(), want):
                fail(f"float wire card vs CPU: the card's wire{pair} words "
                     f"!= the encoder on its s24 (segment {seg})")
        pos = (pos + npkt * BLOCK) % 192
    if int(engs[0].state.wire_pos) != pos:
        fail("float wire card vs CPU: wire position")
    text = [f"float wire {worst:.3e}"]

    qcfg = full_chain_config(Platform.RP2040, RATE)
    qcfg.hardware.output_types = [0, 1]
    engs = [Engine(qcfg, n_streams=B, block_size=BLOCK, emit="full",
                   pdm=False, wire=True, device=d) for d in (dev, "cpu")]
    for seg in range(2):
        x = rng.integers(-16000, 16000, size=(npkt, 2, BLOCK, B)).astype(
            np.int32)
        gpu, cpu = (e.process(x) for e in engs)
        _same_words(f"Q28 wire card vs CPU (segment {seg})", gpu, cpu)
    if not cpu["s24"].ne(0).any():
        fail("Q28 wire card vs CPU: silent s24")
    _same_state("Q28 wire card vs CPU", engs[0].state, engs[1].state)

    sched = (44,) * 9 + (45,)
    engs = [Engine(full_chain_config(Platform.RP2350, 44100.0), n_streams=B,
                   schedule=sched, emit="full", device=d)
            for d in (dev, "cpu")]
    worst = 0.0
    for seg in range(2):
        x = rng.integers(-16000, 16000, size=(2, sum(sched), B)).astype(
            np.int32)
        gpu, cpu = (e.process(x) for e in engs)
        worst = max(worst, float_close(f"float 44.1 kHz card vs CPU ({seg})",
                                       gpu, cpu)[0])
    text.append(f"float 44.1 kHz {worst:.3e}")

    cfgs = hetero_variants(3, Platform.RP2350)
    ids = rng.integers(0, 3, 24)
    srvs = [HeteroServer(cfgs, ids, block_size=BLOCK, emit="full", device=d)
            for d in (dev, "cpu")]
    quiet = hetero_variants(3, Platform.RP2350)[1]
    quiet.master_volume_db = -30.0
    worst = 0.0
    for seg in range(2):
        if seg:
            for srv in srvs:
                srv.update_group(1, quiet)
        x = rng.integers(-16000, 16000, size=(npkt, 2, BLOCK, 24)).astype(
            np.int32)
        gpu, cpu = (srv.process(x) for srv in srvs)
        worst = max(worst, float_close(f"float hetero card vs CPU ({seg})",
                                       gpu, cpu)[0])
    text.append(f"float hetero {worst:.3e}")

    engs = [Engine(full_chain_config(Platform.RP2350, RATE), n_streams=B,
                   block_size=BLOCK, bit_depth=24, emit="full", pdm=False,
                   device=d) for d in (dev, "cpu")]
    worst = 0.0
    for seg in range(2):
        x = rng.integers(-(1 << 22), 1 << 22,
                         size=(npkt, 2, BLOCK, B)).astype(np.int32)
        gpu, cpu = (e.process(x) for e in engs)
        worst = max(worst, float_close(f"float 24-bit card vs CPU ({seg})",
                                       gpu, cpu)[0])
    text.append(f"float 24-bit {worst:.3e}")
    print(f"float paths card vs CPU ({time.perf_counter() - t0:.1f} s): "
          f"out/s24 worst relative RMS {', '.join(text)} (<= 1e-6), PDM "
          f"words equal up to the first differing modulator input, the "
          f"float wire words equal to the encoder on the card's s24; Q28 "
          f"wire: every output and state word equal", flush=True)


# (has_loud, has_env, nb) of the cascade kernel's checks; the last two are
# the template instances the Q28 main path launches
EQ_CASES = ((False, False, 3), (True, False, 2), (False, True, 0),
            (True, True, 10), (False, False, 10))


def _rand_i32(gen, lo, hi, shape, dev):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                         device=dev)


def phase_eq(dev) -> dict:
    """Cascade kernel vs its plain version on the card, word for word."""
    from dspi_tpu_torch.kernels.eq import q28_cascades_plain
    from dspi_tpu_torch.kernels.eq_cuda import q28_cascades

    G, T, B = 4, 2 * BLOCK, 4100
    gen = torch.Generator(device=dev).manual_seed(13)
    a_rms = [260000000 - 9999999 * g for g in range(G)]
    # every pair of loudness bypass flags, a different alpha per cascade
    scal = torch.tensor([[g % 2, g // 2, a_rms[g], (1 << 28) - a_rms[g]]
                         for g in range(G)], dtype=torch.int32, device=dev)
    times = {}
    for has_loud, has_env, nb in EQ_CASES:
        nr = (2 if has_loud else 0) + nb
        x = _rand_i32(gen, -(1 << 27), 1 << 27, (G, T, B), dev)
        cf = _rand_i32(gen, -(1 << 27), 1 << 27, (G, nr, 5), dev) >> 2
        s0 = _rand_i32(gen, -(1 << 20), 1 << 20,
                       (G, 2 * nr + int(has_env), B), dev)
        kw = dict(nb=nb, has_loud=has_loud, has_env=has_env, tc=BLOCK)
        got = q28_cascades(x, cf, s0, scal, **kw)    # loads the kernel
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        want = q28_cascades_plain(x, cf, s0, scal, **kw)
        ev[1].record()
        ev[2].record()
        q28_cascades(x, cf, s0, scal, **kw)
        ev[3].record()
        torch.cuda.synchronize()
        times[(has_loud, has_env, nb)] = (ev[0].elapsed_time(ev[1]),
                                          ev[2].elapsed_time(ev[3]))
        for name, u, v in zip(("y", "env", "state"), got, want):
            if (u is None) != (v is None) or (
                    u is not None and not torch.equal(u, v)):
                fail(f"cascade kernel != plain version ({name}) for "
                     f"loudness={has_loud} envelope={has_env} nb={nb}")
    plain_ms, kern_ms = times[(True, True, 10)]
    print(f"eq_q28: kernel == plain on {G} cascades x {B} streams x {T} "
          f"samples for (loudness, envelope, bands) in {list(EQ_CASES)}; "
          f"plain / kernel ms there: "
          f"{ {str(k): [round(v, 3) for v in t] for k, t in times.items()} }",
          flush=True)
    return {"name": "eq_q28_cascade", "route": "cuda",
            "source": "dspi_tpu_torch/kernels/csrc/eq_q28.cu",
            "replaces": "dspi_tpu/kernels/eq_pallas.py:102",
            "max_abs_err": 0, "plain_ms": plain_ms, "library_ms": None,
            "equal_to_plain": True, "plain_shape": [G, T, B],
            "plain_case": "loudness + 10 bands + envelope",
            "kernel_ms_at_plain_shape": kern_ms}


# the cascade kernel's other modes: (lane_cf, schedule); SCHED is periodic
# (the 44/45 cadence), SCHED1 is not and has a 1-sample packet
SCHED, SCHED1 = (44, 45, 44, 45), (44, 1, 45, 7)
EQ_MODES = {"lane_cf": (True, None), "sched": (False, SCHED),
            "sched_1": (False, SCHED1), "lane_cf+sched": (True, SCHED1),
            "lane_cf bucket-uniform": (True, None)}
# bucket width of the bucket-uniform lane_cf mode: columns (coefficients,
# flags, alphas) constant over buckets of this many lanes, as in the
# HeteroServer's flat layout; the last bucket is ragged
EQ_BUCKET = 160


def _buckets(v, width: int):
    """``v`` [..., B] with every lane set to its bucket's first lane
    (buckets of ``width`` lanes), contiguous."""
    idx = torch.arange(v.shape[-1], device=v.device) // width * width
    return v.index_select(-1, idx).contiguous()


def phase_eq_modes(dev) -> dict:
    """Cascade kernel vs its plain version on the card in the per-lane and
    schedule modes, every flag case of EQ_CASES in each; returns the
    (plain ms, kernel ms) of the loudness + 10 bands + envelope case per
    mode."""
    from dspi_tpu_torch.kernels.eq import q28_cascades_plain
    from dspi_tpu_torch.kernels.eq_cuda import q28_cascades

    G, B = 4, 4100
    gen = torch.Generator(device=dev).manual_seed(31)
    times = {}
    for mode, (lane, sched) in EQ_MODES.items():
        T = sum(sched) if sched else 2 * BLOCK
        if lane:
            # bypass flags that differ lane by lane, so warps mix them
            a_rms = _rand_i32(gen, 200000000, 268000000, (G, B), dev)
            scal = torch.stack([_rand_i32(gen, 0, 2, (G, B), dev),
                                _rand_i32(gen, 0, 2, (G, B), dev), a_rms,
                                (1 << 28) - a_rms], dim=1)
        else:
            a_rms = [260000000 - 9999999 * g for g in range(G)]
            scal = torch.tensor([[g % 2, g // 2, a_rms[g],
                                  (1 << 28) - a_rms[g]] for g in range(G)],
                                dtype=torch.int32, device=dev)
        bucket = EQ_BUCKET if mode.endswith("bucket-uniform") else 1
        if bucket > 1:
            scal = _buckets(scal, bucket)
        for has_loud, has_env, nb in EQ_CASES:
            nr = (2 if has_loud else 0) + nb
            x = _rand_i32(gen, -(1 << 27), 1 << 27, (G, T, B), dev)
            cf = _rand_i32(gen, -(1 << 27), 1 << 27,
                           (G, nr, 5, B) if lane else (G, nr, 5), dev) >> 2
            if bucket > 1:
                cf = _buckets(cf, bucket)
            s0 = _rand_i32(gen, -(1 << 20), 1 << 20,
                           (G, 2 * nr + int(has_env), B), dev)
            kw = dict(nb=nb, has_loud=has_loud, has_env=has_env, tc=BLOCK,
                      sched=sched)
            got = q28_cascades(x, cf, s0, scal, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            want = q28_cascades_plain(x, cf, s0, scal, **kw)
            ev[1].record()
            ev[2].record()
            q28_cascades(x, cf, s0, scal, **kw)
            ev[3].record()
            torch.cuda.synchronize()
            if (has_loud, has_env, nb) == (True, True, 10):
                times[mode] = (ev[0].elapsed_time(ev[1]),
                               ev[2].elapsed_time(ev[3]))
            for name, u, v in zip(("y", "env", "state"), got, want):
                if (u is None) != (v is None) or (
                        u is not None and not torch.equal(u, v)):
                    fail(f"cascade kernel != plain version ({name}) in mode "
                         f"{mode} for loudness={has_loud} "
                         f"envelope={has_env} nb={nb}")
    print(f"eq_q28 modes: kernel == plain on {G} cascades x {B} streams in "
          f"modes {list(EQ_MODES)} (schedules {SCHED}, {SCHED1}; buckets "
          f"of {EQ_BUCKET} lanes) for every "
          f"case of {list(EQ_CASES)}; plain / kernel ms, loudness + 10 bands "
          f"+ envelope: "
          f"{ {m: [round(v, 3) for v in t] for m, t in times.items()} }",
          flush=True)
    return times


def phase_xf(dev) -> dict:
    """Crossfeed kernel vs its plain version on the card, word for word,
    over two chained segments."""
    from dspi_tpu_torch.kernels.xf_cuda import xf_q28, xf_q28_plain

    T, B = 2 * BLOCK, 4100
    gen = torch.Generator(device=dev).manual_seed(17)
    s_plain = s_kern = _rand_i32(gen, -(1 << 24), 1 << 24, (4, B), dev)
    plain_ms = kern_ms = 0.0
    for seg, coef in enumerate((
            [19000000, 249000000, -180000000],                 # BS2B-like
            _rand_i32(gen, -2**31, 2**31 - 1, (3,), dev).tolist(),
            _rand_i32(gen, -2**31, 2**31 - 1, (3, B), dev))):  # per lane
        coef = torch.as_tensor(coef, dtype=torch.int32, device=dev)
        l, r = (_rand_i32(gen, -(1 << 28), 1 << 28, (T, B), dev)
                for _ in range(2))
        got = xf_q28(l, r, coef, s_kern)             # loads the kernel
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        want = xf_q28_plain(l, r, coef, s_plain)
        ev[1].record()
        ev[2].record()
        xf_q28(l, r, coef, s_kern)
        ev[3].record()
        torch.cuda.synchronize()
        plain_ms += ev[0].elapsed_time(ev[1]) / 3
        kern_ms += ev[2].elapsed_time(ev[3]) / 3
        if not all(torch.equal(u, v) for u, v in zip(got, want)):
            fail(f"crossfeed kernel != plain version in segment {seg}")
        s_plain, s_kern = want[2], got[2]
    print(f"xf_q28: kernel == plain on {B} streams x 3 chained segments of "
          f"{T} samples, the last with per-lane [3, B] coefficients; plain "
          f"{plain_ms:.1f} ms / kernel {kern_ms:.3f} ms per segment there",
          flush=True)
    return {"name": "xf_q28", "route": "cuda",
            "source": "dspi_tpu_torch/kernels/csrc/xf_q28.cu",
            "replaces": "dspi_tpu/chain/pipeline.py:1072 (a lax.scan, "
                        "no TPU kernel)",
            "max_abs_err": 0, "plain_ms": plain_ms, "library_ms": None,
            "equal_to_plain": True, "plain_shape": [T, B],
            "kernel_ms_at_plain_shape": kern_ms}


def max_gap(u, v) -> float:
    """The largest absolute difference of two tensors (NaN where a NaN
    stands against a number)."""
    d = (u.double() - v.double()).abs()
    return float(d.max()) if d.numel() else 0.0


def _uniform(gen, lo, hi, shape, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev,
                                       dtype=torch.float64)


def f32_rows(gen, shape, dev):
    """[..., 11] float cascade coefficient rows of stable filters, as
    tests/test_torch_cuda.py makes them: SVF columns from a tuning g and a
    damping k (mix terms in +-1.5), TDF2 columns with b0..b2 in +-0.6 and
    a conjugate pole pair inside radius 0.98."""
    g = _uniform(gen, 0.02, 1.2, shape, dev)
    k = _uniform(gen, 0.4, 2.0, shape, dev)
    a1 = 1.0 / (1.0 + g * (g + k))
    r = _uniform(gen, 0.5, 0.98, shape, dev)
    th = _uniform(gen, 0.05, 3.0, shape, dev)
    cols = ([a1, g * a1, g * g * a1]
            + [_uniform(gen, -1.5, 1.5, shape, dev) for _ in range(3)]
            + [_uniform(gen, -0.6, 0.6, shape, dev) for _ in range(3)]
            + [-2 * r * torch.cos(th), r * r])
    return torch.stack(cols, dim=-1).float()


# (loudness, envelope, bands, cascades, kinds mixed across the cascades):
# the float scan path's master call (2 cascades, loudness + 10 bands +
# envelope) and output call (9 cascades, 10 bands), then band kinds that
# differ across cascades, SKIP rows among them
EQF_CASES = ((True, True, 10, 2, False), (False, False, 10, 9, False),
             (True, True, 12, 4, True), (False, True, 0, 2, True),
             (True, False, 5, 3, True))
EQF_MODES = {"scalar": (False, None), "lane": (True, None),
             "sched": (False, SCHED), "lane+sched": (True, SCHED1)}


def _eqf_kinds(G: int, nb: int, mixed: bool) -> tuple:
    """The band kinds of a phase_eq_f32 case: the headline's for every
    cascade, or kinds that differ across the cascades (SKIP among them)."""
    return tuple(tuple((1, 2, 3, 4, 5, 0)[(g + j) % 6] if mixed
                       else EQF_HEAD[j] for j in range(nb))
                 for g in range(G))


def eqf_signatures() -> list:
    """Every float cascade signature this script launches: those of
    phase_eq_f32's cases in each mode and of the scan paths' calls."""
    from dspi_tpu_torch.kernels import eq_f32_cuda

    sigs = [f32_instance_signature(label) for label in F32_INSTANCES]
    for lane, _ in EQF_MODES.values():
        for has_loud, has_env, nb, G, mixed in EQF_CASES:
            sigs += [sig for sig, _ in eq_f32_cuda.split(
                _eqf_kinds(G, nb, mixed), has_loud, has_env, lane)]
    return list(dict.fromkeys(sigs))


def _eqf_args(gen, G, T, B, nb, has_loud, has_env, lane, mixed, dev):
    """Float cascade inputs on the card: per-cascade or per-lane rows,
    bypass flags in every pair (lane by lane with ``lane``), a different
    envelope alpha a cascade, and on cascade 0's first 4 lanes a silent
    input and zero states under a 1e-31 envelope, so that the 1e-30
    flush fires at a packet end."""
    kinds = _eqf_kinds(G, nb, mixed)
    nr = (2 if has_loud else 0) + nb
    x = _uniform(gen, -1.0, 1.0, (G, T, B), dev).float()
    s0 = _uniform(gen, -0.1, 0.1, (G, 2 * nr + has_env, B), dev).float()
    if has_env:
        s0[:, -1] = _uniform(gen, 0.0, 0.3, (G, B), dev).float()
        x[0, :, :4] = 0.0
        s0[0, :, :4] = 0.0
        s0[0, -1, :4] = 1e-31
    if lane:
        cf = f32_rows(gen, (G, nr, B), dev).movedim(-1, 2).contiguous()
        byp = (torch.rand((2, G, B), generator=gen, device=dev) < 0.5)
        a = _uniform(gen, 0.99, 0.9999, (G, B), dev).float()
    else:
        cf = f32_rows(gen, (G, nr), dev)
        gi = torch.arange(G, device=dev)
        byp = torch.stack([gi % 2, gi // 2 % 2])
        a = torch.linspace(0.995, 0.9999, G, device=dev)
    scal = torch.stack([byp[0].float(), byp[1].float(), a, 1.0 - a], dim=1)
    return (x, cf, s0, scal.contiguous()), kinds


def phase_eq_f32(dev) -> dict:
    """Float cascade kernel vs its plain version on the card, bit for bit,
    every case of EQF_CASES in every mode of EQF_MODES, then the master
    call's case (the headline's signature) at full length; returns the
    (plain ms, kernel ms) of the master and output cases per mode."""
    from dspi_tpu_torch.kernels.eq_f32 import f32_cascades_plain
    from dspi_tpu_torch.kernels.eq_f32_cuda import f32_cascades

    B = 4100
    gen = torch.Generator(device=dev).manual_seed(61)
    times = {}
    cases = [(mode, lane, sched, sum(sched) if sched else 2 * BLOCK, case)
             for mode, (lane, sched) in EQF_MODES.items()
             for case in EQF_CASES]
    cases.append(("full", False, None, PACKETS * BLOCK, EQF_CASES[0]))
    for mode, lane, sched, T, case in cases:
        has_loud, has_env, nb, G, mixed = case
        a, kinds = _eqf_args(gen, G, T, B, nb, has_loud, has_env, lane,
                             mixed, dev)
        kw = dict(kinds=kinds, has_loud=has_loud, has_env=has_env,
                  tc=BLOCK, sched=sched)
        got = f32_cascades(*a, **kw)               # loads the kernel
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        want = f32_cascades_plain(*a, **kw)
        ev[1].record()
        ev[2].record()
        f32_cascades(*a, **kw)
        ev[3].record()
        torch.cuda.synchronize()
        if not mixed:
            times[f"{mode} G={G}"] = (ev[0].elapsed_time(ev[1]),
                                      ev[2].elapsed_time(ev[3]))
        for name, u, v in zip(("y", "env", "state"), got, want):
            if (u is None) != (v is None) or (
                    u is not None and not torch.equal(u, v)):
                gap = "" if u is None or v is None else max_gap(u, v)
                fail(f"float cascade kernel != plain version ({name}) "
                     f"in mode {mode} for loudness={has_loud} "
                     f"envelope={has_env} nb={nb} G={G} T={T}: largest "
                     f"gap {gap}")
        if has_env and not bool((want[1][0, :, :4] == 0).all()):
            fail("float cascade phase: the envelope flush never fired")
    print(f"eq_f32: kernel == plain bit for bit on {B} streams in modes "
          f"{list(EQF_MODES)} (schedules {SCHED}, {SCHED1}) for every case "
          f"of {list(EQF_CASES)}, and the first case at {PACKETS * BLOCK} "
          f"samples (mode full); plain / kernel ms: "
          f"{ {m: [round(v, 3) for v in t] for m, t in times.items()} }",
          flush=True)
    return times


def phase_xf_f32(dev) -> dict:
    """Float crossfeed kernel vs its plain version on the card, bit for
    bit, over three chained segments, the last with per-lane
    coefficients."""
    from dspi_tpu_torch.kernels.xf_f32_cuda import xf_f32, xf_f32_plain

    T, B = 2 * BLOCK, 4100
    gen = torch.Generator(device=dev).manual_seed(67)
    s_plain = s_kern = _uniform(gen, -0.3, 0.3, (4, B), dev).float()
    plain_ms = kern_ms = 0.0
    for seg, coef in enumerate((
            [0.1184, 0.8816, -0.6421],                          # BS2B-like
            _uniform(gen, -0.9, 0.9, (3,), dev).tolist(),
            torch.stack([_uniform(gen, 0.01, 0.3, (B,), dev),    # per lane
                         _uniform(gen, 0.6, 0.99, (B,), dev),
                         _uniform(gen, -0.9, -0.1, (B,), dev)]))):
        coef = torch.as_tensor(coef, dtype=torch.float32,
                               device=dev).contiguous()
        l, r = (_uniform(gen, -1.0, 1.0, (T, B), dev).float()
                for _ in range(2))
        got = xf_f32(l, r, coef, s_kern)             # loads the kernel
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        want = xf_f32_plain(l, r, coef, s_plain)
        ev[1].record()
        ev[2].record()
        xf_f32(l, r, coef, s_kern)
        ev[3].record()
        torch.cuda.synchronize()
        plain_ms += ev[0].elapsed_time(ev[1]) / 3
        kern_ms += ev[2].elapsed_time(ev[3]) / 3
        if not all(torch.equal(u, v) for u, v in zip(got, want)):
            fail(f"float crossfeed kernel != plain version in segment "
                 f"{seg}: largest gap "
                 f"{max(max_gap(u, v) for u, v in zip(got, want)):.3e}")
        s_plain, s_kern = want[2], got[2]
    print(f"xf_f32: kernel == plain bit for bit on {B} streams x 3 chained "
          f"segments of {T} samples, the last with per-lane [3, B] "
          f"coefficients; plain {plain_ms:.1f} ms / kernel {kern_ms:.3f} ms "
          f"per segment there", flush=True)
    return {"name": "xf_f32", "route": "cuda",
            "source": "dspi_tpu_torch/kernels/csrc/xf_f32.cu",
            "replaces": "dspi_tpu/chain/pipeline.py:594-611 (xf_body, a "
                        "lax.scan, no TPU kernel)",
            "max_abs_err": 0.0, "plain_ms": plain_ms, "library_ms": None,
            "equal_to_plain": True, "plain_shape": [T, B],
            "kernel_ms_at_plain_shape": kern_ms}


def eq_sample_ops(nb: int, loud: bool, env: bool, lane: bool) -> dict:
    """This build's SASS counts a stream-sample of the cascade kernel's
    instance <nb, loud, env>: cascade_kernel, or lane_kernel per lane."""
    kernel = "lane_kernel" if lane else "cascade_kernel"
    return sample_ops("eq_q28", f"{kernel}ILi{nb}ELb{int(loud)}ELb{int(env)}"
                      f"EE", "ldg", 1)


def _eq_work(a, k) -> tuple[dict, int]:
    """(operations, bytes) of one cascade call, from its arguments and the
    SASS counts of the template instance it launches: this build's in the
    scalar and schedule modes, the pinned EQ_LANE_OPS per lane (lane_cf).
    Per-lane calls read their coefficient rows and scalars per stream, and
    a per-lane bypass costs the same work, so no work is skipped there."""
    x, cf, s0, scal = a
    G, T, B = x.shape
    loud, env = bool(k.get("has_loud")), bool(k.get("has_env"))
    lane = cf.dim() == 4
    if loud and not lane and bool((scal[:, :2] != 0).any()):
        fail("a bypassed loudness filter skips work the SASS count holds")
    if lane:
        ops = EQ_LANE_OPS.get((k["nb"], loud, env))
        if ops is None:
            fail(f"no pinned lane_cf counts for {(k['nb'], loud, env)}")
    else:
        ops = eq_sample_ops(k["nb"], loud, env, False)
    mul = MUL_PER_BAND * cf.shape[1] + (MUL_PER_ENV if env else 0)
    sched = k.get("sched")
    npkt = len(sched) if sched else T // k["tc"]
    nbytes = 4 * (2 * x.numel() + (G * npkt * B if env else 0)
                  + 2 * s0.numel() + cf.numel() + scal.numel()
                  + (npkt if sched and env else 0))
    return work(ops, mul, G * T * B), nbytes


def _pdm_work(T: int, B: int) -> tuple[dict, int]:
    """(operations, bytes) of one PDM call over T samples of B modulating
    streams: the pinned counts, the input and the words once, the state in
    and out."""
    return work(PDM_OPS, MUL_PDM, T * B), 4 * T * B + 32 * T * B + 2 * 64 * B


@functools.lru_cache(maxsize=None)
def _sass(lib: str) -> str:
    from dspi_tpu_torch.kernels import build

    return build.sass(lib)


def sample_ops(lib: str, kernel: str, op: str, per: int) -> dict:
    """ALU-only and all per-thread arithmetic instructions per sample and
    thread of a kernel's sample loop, from its SASS; the loop's samples
    an iteration are its count of ``op`` over ``per``, that
    instruction's count a sample (build.per_sample)."""
    from dspi_tpu_torch.kernels import build

    c = build.per_sample(build.loop_counts(_sass(lib), kernel), op, per)
    return {"alu_only": c["alu_only"], "arith": c["arith"]}


def work(per_sample: dict, mul: int, n: int) -> dict:
    """Operation counts over ``n`` sample-threads: ``mul`` multiplies a
    sample, the SASS counts of ``per_sample``."""
    return {"mul": mul * n, **{k: v * n for k, v in per_sample.items()}}


def bound(ops: dict, nbytes) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the numbers) for operation counts (see
    PIPE_OPS_PER_SM_CLOCK; "fp32": FP32_PER_SM_CLOCK) and a byte count."""
    rates = {"mul": ("multiplies", PIPE_OPS_PER_SM_CLOCK),
             "alu_only": ("ALU-only", PIPE_OPS_PER_SM_CLOCK),
             "arith": ("issue", ISSUE_PER_SM_CLOCK),
             "fp32": ("float32", FP32_PER_SM_CLOCK)}
    terms = {rates[k][0]: v / rates[k][1] for k, v in ops.items()}
    top = max(terms, key=terms.get)
    t_ops, t_bytes = terms[top] / sm_clocks_per_s(), nbytes / HBM_BYTES_PER_S
    counts = ", ".join(f"{v:.4e} {rates[k][0]}" for k, v in ops.items())
    text = (f"{counts} operations, longest term {top}; "
            f"{sm_clocks_per_s():.4e} SM clocks/s; {nbytes:.4e} bytes")
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", text)


@functools.lru_cache(maxsize=None)
def eqf_instance(sig: int) -> dict:
    """One float cascade instance: its spills and build seconds
    (phase_build), threads a block, registers a thread and resident
    blocks an SM (the CUDA runtime), and its sample loop's SASS a sample
    (one cp.async a step).  Fails if that loop branches more than once a
    sample: its back edge is the only branch it may have."""
    from dspi_tpu_torch.kernels import build, eq_f32_cuda

    occ = eq_f32_cuda.occupancy(eq_f32_cuda.libraries([sig])[sig])
    c = build.loop_counts(build.sass("eq_f32", build.SRC_DIR,
                                     eq_f32_cuda.defines(sig)),
                          "cascade_kernel")
    n = build.per_sample(c, "ldgsts", 1)["samples_per_iteration"]
    ops = build.opcodes_per_sample(c, n)
    per = {"instructions": c["instructions"] / n,
           **{op.lower(): ops.get(op, 0.0) for op in (
               "FMUL", "FADD", "BRA", "ISETP", "LDS", "LDGSTS", "LDG",
               "STG")},
           "stall": None if c["stall"] is None else c["stall"] / n,
           "steps_per_iteration": n}
    if per["bra"] > 1:
        fail(f"float cascade instance {sig:#x}: {per['bra']} branches a "
             f"sample in its sample loop")
    return {"signature": f"{sig:#x}", **F32_BUILT.get(sig, {}), **occ,
            "warps_per_sm": occ["blocks_per_sm"] * occ["threads"] // 32,
            "sass_per_sample": per}


def eqf_instances(a, k) -> list:
    """The instances one float cascade call launches (eqf_instance), each
    with its cascades and its grid's waves on this card."""
    from dspi_tpu_torch.kernels import eq_f32_cuda

    B = a[0].shape[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for sig, idx in eq_f32_cuda.split(k["kinds"], bool(k.get("has_loud")),
                                      bool(k.get("has_env")),
                                      a[1].dim() == 4):
        inst = dict(eqf_instance(sig))
        blocks = len(idx) * -(-B // inst["threads"])
        rows.append({**inst, "cascades": len(idx),
                     "waves": blocks / (inst["blocks_per_sm"] * sms)})
    return rows


def _eqf_work(a, k) -> tuple[dict, int]:
    """(operations, bytes) of one float cascade call, from its arguments
    and the pinned counts: each cascade's loudness rows, bands by kind and
    envelope over T samples of B streams; inputs and outputs once."""
    x, cf, s0, scal = a
    G, T, B = x.shape
    loud, env = bool(k.get("has_loud")), bool(k.get("has_env"))
    per = sum((2 * F32_LOUD_OPS if loud else 0)
              + sum(F32_BAND_OPS[kd] for kd in row)
              + (F32_ENV_OPS if env else 0) for row in k["kinds"])
    sched = k.get("sched")
    npkt = len(sched) if sched else T // k["tc"]
    nbytes = 4 * (2 * x.numel() + (G * npkt * B if env else 0)
                  + 2 * s0.numel() + cf.numel() + scal.numel())
    return {"fp32": per * T * B}, nbytes


def drive_path(dev, card: str, label: str, eng, x, audio_s: float,
               want: dict, n_peaks: int, peak_max: int = 0xFFFF,
               keys: tuple = ("peaks", "s24_sum", "pdm_sum")) -> dict:
    """A main path at full width: one warm-up segment, then SEGMENTS
    chained segments with a fresh input each (x ^ i), launch counts set to
    0 just before and read just after.  Fails unless the launches are
    exactly ``want`` per segment and the outputs are sane (exactly
    ``keys``, ``n_peaks`` channels of peaks in 0..``peak_max``, sums not
    all zero, float state finite).  ``audio_s``: the audio-seconds one
    segment carries (the RTF counts real streams)."""
    from dspi_tpu_torch.kernels import LAUNCHES

    eng.process(x ^ SEGMENTS)                      # warm-up segment
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for k in list(LAUNCHES):
        LAUNCHES[k] = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(SEGMENTS + 1)]
    outs = []
    h0 = time.perf_counter()
    ev[0].record()
    for i in range(SEGMENTS):
        outs.append(eng.process(x ^ i))
        ev[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    launches = {k: n for k, n in LAUNCHES.items() if n}

    want = {k: n * SEGMENTS for k, n in want.items()}
    if launches != want:
        fail(f"{label} launched {launches} in {SEGMENTS} segments, not "
             f"{want}")
    B = x.shape[-1]
    for i, out in enumerate(outs):
        if set(out) != set(keys):
            fail(f"{label} segment {i}: outputs {sorted(out)}")
        if out["peaks"].shape != (n_peaks, B) or not (
                (out["peaks"] >= 0) & (out["peaks"] <= peak_max)).all():
            fail(f"{label} segment {i}: peaks out of range")
        if not all(out[k].ne(0).any() for k in keys if k != "peaks"):
            fail(f"{label} segment {i}: silent outputs")
    for f, v in zip(eng.state._fields, eng.state):
        if v is not None and v.is_floating_point() and \
                not torch.isfinite(v).all():
            fail(f"{label}: state {f} not finite")
    seg_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(SEGMENTS)]
    mean_ms = sum(seg_ms) / SEGMENTS
    rtf = audio_s / (mean_ms / 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: per segment {[round(m, 3) for m in seg_ms]} ms (CUDA "
          f"events), mean {mean_ms:.3f} ms, host wall "
          f"{1e3 * wall / SEGMENTS:.3f} ms; RTF {rtf:.1f}x; peak memory "
          f"{peak_gb:.2f} GB; launches {launches}; card {card}", flush=True)
    return {"launches": launches, "seg_ms": seg_ms,
            "mean_ms": mean_ms, "rtf": rtf, "peak_gb": peak_gb}


# the kernel wrappers record_calls wraps: (module, name, kind); eqf and
# xff are the float scan lowering's cascade and crossfeed
_RECORDED = (("pipeline", "q28_cascades", "eq"), ("pipeline", "xf_q28", "xf"),
             ("pipeline", "f32_cascades", "eqf"),
             ("pipeline", "xf_f32", "xff"), ("pdm_cuda", "pdm_words", "pdm"))


@contextlib.contextmanager
def recording(calls: list):
    """Append each cascade, crossfeed and PDM wrapper call made inside the
    block to ``calls`` as (kind, wrapper, args, keywords)."""
    from dspi_tpu_torch.chain import pipeline
    from dspi_tpu_torch.kernels import pdm_cuda

    mods = {"pipeline": pipeline, "pdm_cuda": pdm_cuda}
    saved = [(mods[m], name, getattr(mods[m], name))
             for m, name, _ in _RECORDED]

    def recorder(fn, kind):
        def call(*a, **k):
            calls.append((kind, fn, a, k))
            return fn(*a, **k)
        return call

    for (mod, name, fn), (_, _, kind) in zip(saved, _RECORDED):
        setattr(mod, name, recorder(fn, kind))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def record_calls(eng, x, label: str,
                 kinds: tuple = ("eq", "xf", "eq", "pdm")) -> list:
    """Each cascade, crossfeed and PDM call of one more segment (fails
    unless they are ``kinds``, in order), timed alone on its own arguments
    beside its bound, then held at its full shape against the plain
    version on the CPU over 128 of its streams (check_path_call)."""
    with recording([]) as calls:
        eng.process(x ^ (SEGMENTS + 1))
    if tuple(kind for kind, *_ in calls) != kinds:
        fail(f"{label} segment made calls {[c[0] for c in calls]}")
    rows = []
    for kind, fn, a, k in calls:
        ms = cuda_ms(lambda: fn(*a, **k), reps=5)
        if kind == "eq":
            ops, nbytes = _eq_work(a, k)
            loud, env = k.get("has_loud", False), k.get("has_env", False)
            lane = a[1].dim() == 4
            extra = {"nb": k["nb"], "has_loud": loud, "has_env": env,
                     "lane_cf": lane, "sched": bool(k.get("sched"))}
            if lane:
                extra["sass_per_sample"] = eq_sample_ops(k["nb"], loud, env,
                                                         True)
                extra["pinned"] = EQ_LANE_OPS[(k["nb"], loud, env)]
        elif kind == "xf":
            T, B = a[0].shape
            ops = work(XF_OPS, MUL_XF, T * B)
            nbytes = 4 * (4 * T * B + 8 * B + a[2].numel())
            extra = {"lane_cf": a[2].dim() == 2,
                     "sass_per_sample": sample_ops("xf_q28", "xf_kernel",
                                                   "stg", 2)}
        elif kind == "eqf":
            ops, nbytes = _eqf_work(a, k)
            extra = {"G": a[0].shape[0], "has_loud": bool(k.get("has_loud")),
                     "has_env": bool(k.get("has_env")),
                     "lane": a[1].dim() == 4, "sched": bool(k.get("sched")),
                     "kinds": [list(r) for r in k["kinds"]],
                     "instances": eqf_instances(a, k)}
        elif kind == "xff":
            T, B = a[0].shape
            ops = {"fp32": XF_F32_OPS * T * B}
            nbytes = 4 * (4 * T * B + 8 * B + a[2].numel())
            extra = {"lane": a[2].dim() == 2}
        else:
            ops, nbytes = _pdm_work(*a[0].shape)
            extra = {"sass_per_sample": sample_ops("pdm", "pdm_kernel",
                                                   "ldg", 1)}
        bound_ms, by, text = bound(ops, nbytes)
        rows.append({"kind": kind, "shape": list(a[0].shape), "ms": ms,
                     "bound_ms": bound_ms, "bound_by": by, "ops": ops,
                     "bytes": nbytes, "work": text, **extra})
    pinned = {"xf": XF_OPS, "pdm": PDM_OPS}
    for r in rows:
        pin = r.get("pinned", pinned.get(r["kind"]))
        sass = (f"; this build's SASS a sample {r['sass_per_sample']} "
                f"(pinned {pin})" if pin else "")
        if r["kind"] == "eqf":
            sass = f"; instances {r['instances']}"
        print(f"  {r['kind']} {r['shape']}: kernel {r['ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms by {r['bound_by']} ({r['work']})"
              f"{sass}", flush=True)
    for (kind, fn, a, k), r in zip(calls, rows):
        if kind == "pdm":
            hold_pdm(f"{label} {list(a[0].shape)}", *a, fn(*a))
            print(f"  pdm {r['shape']}: streams 0-63 and {r['shape'][1] - 64}"
                  f"-{r['shape'][1] - 1} held for the plain version at full "
                  f"length", flush=True)
            continue
        r.update(check_path_call(kind, fn, a, k))
        print(f"  {kind} {r['shape']}: kernel == plain version on the "
              f"path's arguments, at full length, on streams "
              f"{r['checked_streams']} (plain on the CPU "
              f"{r['plain_cpu_s']:.1f} s)", flush=True)
    return rows


def phase_q28_main(dev, card: str, bit_depth: int, record: bool) -> dict:
    """The Q28 main path at full width; with ``record``, then each cascade
    and crossfeed call of one more segment, timed alone on its own
    arguments."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    t0 = time.perf_counter()
    eng = Engine(full_chain_config(Platform.RP2040, RATE), n_streams=STREAMS,
                 block_size=BLOCK, bit_depth=bit_depth, emit="reduced",
                 pdm=True, pdm_fade=False, device=dev)
    print(f"Q28 main path ({bit_depth}-bit): {STREAMS} streams x "
          f"{PACKETS}x{BLOCK} samples, {SEGMENTS} chained segments; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lim = 1 << (bit_depth - 2)
    gen = torch.Generator(device=dev).manual_seed(19 + bit_depth)
    x = _rand_i32(gen, -lim, lim, (PACKETS, 2, BLOCK, STREAMS), dev)
    result = drive_path(dev, card, f"Q28 main path ({bit_depth}-bit)", eng, x,
                        STREAMS * PACKETS * BLOCK / RATE,
                        {"eq_q28": 2, "xf_q28": 1, "pdm": 1}, 7)
    if record:
        result["calls"] = record_calls(eng, x, "Q28 main path")
    return result


# the 44.1 kHz path's schedule: 13 ten-millisecond groups of the 44/45
# cadence, 130 packets, 5733 samples (bench_stages.py sched441)
SCHED441 = ((44,) * 9 + (45,)) * 13
HETERO_CONFIGS = 8


def phase_hetero(dev, card: str) -> dict:
    """The multi-tenant path at full width: HeteroServer over 8 configs of
    one structure scattered over 16384 streams (bench_stages.py hetero)."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import HeteroServer
    from dspi_tpu_torch.configs import hetero_variants

    t0 = time.perf_counter()
    ids = np.random.default_rng(5).integers(0, HETERO_CONFIGS, STREAMS)
    srv = HeteroServer(hetero_variants(HETERO_CONFIGS, Platform.RP2040), ids,
                       block_size=BLOCK, emit="reduced", pdm=True,
                       pdm_fade=False, device=dev)
    lanes = srv.grouped.n_groups * srv.grouped.streams_per_group
    print(f"Q28 hetero path: {HETERO_CONFIGS} configs over {STREAMS} "
          f"streams ({lanes} lanes, padding waste {srv.padding_waste:.4f}) x "
          f"{PACKETS}x{BLOCK} samples, {SEGMENTS} chained segments; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(37)
    x = _rand_i32(gen, -16000, 16000, (PACKETS, 2, BLOCK, STREAMS), dev)
    result = drive_path(dev, card, "Q28 hetero path", srv, x,
                        STREAMS * PACKETS * BLOCK / RATE,
                        {"eq_q28": 2, "eq_q28_lane_cf": 2, "xf_q28": 1,
                         "pdm": 1}, 7)
    result.update(padding_waste=srv.padding_waste, lanes=lanes,
                  calls=record_calls(srv, x, "Q28 hetero path"))
    if not all(c["lane_cf"] for c in result["calls"] if c["kind"] == "eq"):
        fail("Q28 hetero path: a cascade call did not run per lane")
    return result


def phase_44k1(dev, card: str) -> dict:
    """The 44.1 kHz path at full width: the RP2040 headline chain on the
    44/45 packet cadence (bench_stages.py sched441)."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    t0 = time.perf_counter()
    eng = Engine(full_chain_config(Platform.RP2040, 44100.0),
                 n_streams=STREAMS, schedule=SCHED441, emit="reduced",
                 pdm=True, pdm_fade=False, device=dev)
    ttot = sum(SCHED441)
    print(f"Q28 44.1 kHz path: {STREAMS} streams x {len(SCHED441)} packets "
          f"({ttot} samples), {SEGMENTS} chained segments; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(41)
    x = _rand_i32(gen, -16000, 16000, (2, ttot, STREAMS), dev)
    result = drive_path(dev, card, "Q28 44.1 kHz path", eng, x,
                        STREAMS * ttot / 44100.0,
                        {"eq_q28": 2, "eq_q28_sched": 2, "xf_q28": 1,
                         "pdm": 1}, 7)
    result["calls"] = record_calls(eng, x, "Q28 44.1 kHz path")
    if not all(c["sched"] for c in result["calls"] if c["kind"] == "eq"):
        fail("Q28 44.1 kHz path: a cascade call ran without the schedule")
    return result


def wire_stage_time(eng, x) -> dict:
    """One more segment with the wire stage (pipeline._wire_stage)
    synchronized before and after: its host-clock ms beside the segment's
    (synchronized around), and the byte bound of a fused encoder that
    reads the s24 samples once and writes one fold a pair."""
    from dspi_tpu_torch.chain import pipeline

    saved = pipeline._wire_stage
    took = {}

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = saved(*a, **k)
        torch.cuda.synchronize()
        took["ms"] = 1e3 * (time.perf_counter() - t0)
        return r

    pipeline._wire_stage = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.process(x ^ (SEGMENTS + 2))
        torch.cuda.synchronize()
        seg_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        pipeline._wire_stage = saved
    n_ch = 2 * len(eng.static.wire)
    fused_bytes = 4 * n_ch * x[:, 0].numel()
    return {"wire_ms": took["ms"], "wire_segment_ms": seg_ms,
            "wire_share": took["ms"] / seg_ms,
            "fused_wire_bound_ms": 1e3 * fused_bytes / HBM_BYTES_PER_S}


def phase_float_wire(dev, card: str) -> dict:
    """The float chain with the device-side wire words at full width:
    examples/serve.py's engine (wire=True, emit 'reduced')."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    t0 = time.perf_counter()
    eng = Engine(full_chain_config(Platform.RP2350, RATE), n_streams=STREAMS,
                 block_size=BLOCK, emit="reduced", pdm=True, pdm_fade=False,
                 wire=True, device=dev)
    print(f"float wire path: {STREAMS} streams x {PACKETS}x{BLOCK} samples, "
          f"slots {eng.static.wire}, {SEGMENTS} chained segments; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(47)
    x = _rand_i32(gen, -16000, 16000, (PACKETS, 2, BLOCK, STREAMS), dev)
    result = drive_path(dev, card, "float wire path", eng, x,
                        STREAMS * PACKETS * BLOCK / RATE, {"pdm": 1}, 11,
                        peak_max=32767,
                        keys=("peaks", "s24_sum", "pdm_sum", "wire_sum"))
    result["calls"] = record_calls(eng, x, "float wire path", kinds=("pdm",))
    result.update(wire_stage_time(eng, x))
    print(f"  wire stage (synchronized): {result['wire_ms']:.3f} ms of a "
          f"{result['wire_segment_ms']:.3f} ms segment "
          f"({100 * result['wire_share']:.1f}%); a fused encoder's byte "
          f"bound {result['fused_wire_bound_ms']:.3f} ms; card {card}",
          flush=True)
    return result


def phase_float_44k1(dev, card: str) -> dict:
    """The float chain at 44.1 kHz at full width: the headline RP2350 chain
    on the 44/45 cadence, 130 packets (5733 samples)."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, mxu
    from dspi_tpu_torch.configs import full_chain_config

    t0 = time.perf_counter()
    eng = Engine(full_chain_config(Platform.RP2350, 44100.0),
                 n_streams=STREAMS, schedule=SCHED441, emit="reduced",
                 pdm=True, pdm_fade=False, device=dev)
    ttot = sum(SCHED441)
    lay = mxu.sched_layout(eng.static, len(SCHED441), lti=True)
    print(f"float 44.1 kHz path: {STREAMS} streams x {len(SCHED441)} packets "
          f"({ttot} samples), LTI block size {lay.tmax} "
          f"({len(lay.sched)} blocks, uniform {lay.uniform}), {SEGMENTS} "
          f"chained segments; setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(53)
    x = _rand_i32(gen, -16000, 16000, (2, ttot, STREAMS), dev)
    result = drive_path(dev, card, "float 44.1 kHz path", eng, x,
                        STREAMS * ttot / 44100.0, {"pdm": 1}, 11,
                        peak_max=32767)
    result.update(lti_block=lay.tmax,
                  calls=record_calls(eng, x, "float 44.1 kHz path",
                                     kinds=("pdm",)))
    return result


def phase_float_hetero(dev, card: str) -> dict:
    """Grouped serving of float configs at full width: HeteroServer over 8
    RP2350 configs of one structure scattered over 16384 streams, the Q28
    hetero path's mix on the float chain."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import HeteroServer
    from dspi_tpu_torch.configs import hetero_variants

    t0 = time.perf_counter()
    ids = np.random.default_rng(5).integers(0, HETERO_CONFIGS, STREAMS)
    srv = HeteroServer(hetero_variants(HETERO_CONFIGS, Platform.RP2350), ids,
                       block_size=BLOCK, emit="reduced", pdm=True,
                       pdm_fade=False, device=dev)
    lanes = srv.grouped.n_groups * srv.grouped.streams_per_group
    print(f"float hetero path: {HETERO_CONFIGS} configs over {STREAMS} "
          f"streams ({lanes} lanes, padding waste {srv.padding_waste:.4f}, "
          f"layout {srv.grouped.layout}) x {PACKETS}x{BLOCK} samples, "
          f"{SEGMENTS} chained segments; setup (block matrices of "
          f"{HETERO_CONFIGS} groups on the CPU) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(59)
    x = _rand_i32(gen, -16000, 16000, (PACKETS, 2, BLOCK, STREAMS), dev)
    result = drive_path(dev, card, "float hetero path", srv, x,
                        STREAMS * PACKETS * BLOCK / RATE, {"pdm": 1}, 11,
                        peak_max=32767)
    result.update(padding_waste=srv.padding_waste, lanes=lanes,
                  calls=record_calls(srv, x, "float hetero path",
                                     kinds=("pdm",)))
    return result


def phase_float_scan(dev, card: str) -> dict:
    """The float chain's scan lowering at full width: the headline RP2350
    chain (the float cell's geometry) with mxu=False, its recurrences as
    the float cascade kernel (2 calls) and the float crossfeed kernel."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    t0 = time.perf_counter()
    eng = Engine(full_chain_config(Platform.RP2350, RATE), n_streams=STREAMS,
                 block_size=BLOCK, emit="reduced", pdm=True, pdm_fade=False,
                 mxu=False, device=dev)
    print(f"float scan path: {STREAMS} streams x {PACKETS}x{BLOCK} samples, "
          f"{SEGMENTS} chained segments; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(71)
    x = _rand_i32(gen, -16000, 16000, (PACKETS, 2, BLOCK, STREAMS), dev)
    result = drive_path(dev, card, "float scan path", eng, x,
                        STREAMS * PACKETS * BLOCK / RATE,
                        {"eq_f32": 2, "xf_f32": 1, "pdm": 1}, 11,
                        peak_max=32767)
    result["calls"] = record_calls(eng, x, "float scan path",
                                   kinds=("eqf", "xff", "eqf", "pdm"))
    gs = [c["G"] for c in result["calls"] if c["kind"] == "eqf"]
    if gs != [2, 9]:
        fail(f"float scan path: cascade calls over {gs} cascades")
    return result


def phase_float_scan_hetero(dev, card: str) -> dict:
    """The float scan lowering's flat per-lane layout at full width:
    HeteroServer over 8 RP2350 configs of one structure scattered over
    16384 streams with mxu=False (the float hetero cell's mix): both
    cascade calls per lane."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import HeteroServer
    from dspi_tpu_torch.configs import hetero_variants

    t0 = time.perf_counter()
    ids = np.random.default_rng(5).integers(0, HETERO_CONFIGS, STREAMS)
    srv = HeteroServer(hetero_variants(HETERO_CONFIGS, Platform.RP2350), ids,
                       block_size=BLOCK, emit="reduced", pdm=True,
                       pdm_fade=False, mxu=False, device=dev)
    lanes = srv.grouped.n_groups * srv.grouped.streams_per_group
    print(f"float scan hetero path: {HETERO_CONFIGS} configs over {STREAMS} "
          f"streams ({lanes} lanes, padding waste {srv.padding_waste:.4f}, "
          f"layout {srv.grouped.layout}) x {PACKETS}x{BLOCK} samples, "
          f"{SEGMENTS} chained segments; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if srv.grouped.layout != "flat":
        fail("float scan hetero path: not the flat per-lane layout")
    gen = torch.Generator(device=dev).manual_seed(73)
    x = _rand_i32(gen, -16000, 16000, (PACKETS, 2, BLOCK, STREAMS), dev)
    result = drive_path(dev, card, "float scan hetero path", srv, x,
                        STREAMS * PACKETS * BLOCK / RATE,
                        {"eq_f32": 2, "eq_f32_lane": 2, "xf_f32": 1,
                         "pdm": 1}, 11, peak_max=32767)
    result.update(padding_waste=srv.padding_waste, lanes=lanes,
                  calls=record_calls(srv, x, "float scan hetero path",
                                     kinds=("eqf", "xff", "eqf", "pdm")))
    return result


def phase_scan_card_vs_cpu(dev) -> None:
    """The float scan engine at 8 streams on the card and on the CPU: 48
    kHz (3 segments of 4 packets) and 44.1 kHz (2 segments of the 10-packet
    44/45 cadence), past the 480-sample lookahead; float_close, clip flags
    equal, and whether the outputs are equal bit for bit."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, packet_geometry
    from dspi_tpu_torch.configs import full_chain_config

    B = 8
    rng = np.random.default_rng(79)
    sched = packet_geometry(44100, 10)[1]
    notes = []
    for label, rate, kw, nseg in (
            ("48 kHz", RATE, dict(block_size=BLOCK), 3),
            ("44.1 kHz", 44100.0, dict(schedule=sched), 2)):
        engs = [Engine(full_chain_config(Platform.RP2350, rate), n_streams=B,
                       emit="full", mxu=False, device=d, **kw)
                for d in (dev, "cpu")]
        worst, compared, same = 0.0, 0, True
        for seg in range(nseg):
            if "schedule" in kw:
                x = rng.integers(-16000, 16000, size=(2, sum(sched), B))
            else:
                x = rng.integers(-16000, 16000, size=(4, 2, BLOCK, B))
            gpu, cpu = (e.process(x.astype(np.int32)) for e in engs)
            w, n = float_close(f"scan card vs CPU ({label}, segment {seg})",
                               gpu, cpu)
            worst, compared = max(worst, w), compared + n
            same = same and all(torch.equal(gpu[k].cpu(), cpu[k])
                                for k in cpu)
        if cpu["out"].double().pow(2).mean().sqrt() < 1e-4:
            fail(f"scan card vs CPU ({label}): reference signal is silent")
        if not torch.equal(engs[0].state.clip_flags.cpu(),
                           engs[1].state.clip_flags):
            fail(f"scan card vs CPU ({label}): clip flags differ")
        notes.append(f"{label}: worst out/s24 relative RMS {worst:.3e}, PDM "
                     f"words equal over {compared} sample-streams, every "
                     f"output equal bit for bit: {same}")
    print(f"scan card vs CPU, {B} streams: " + "; ".join(notes), flush=True)


def check_path_call(kind, fn, a, k) -> dict:
    """One recorded call of a main path: the kernel at the path's own
    shape, held against the plain version run on the CPU over the first
    and the last 64 streams of the same arguments (per-lane coefficients
    cut to the same lanes), every word equal."""
    from dspi_tpu_torch.kernels.eq import q28_cascades_plain
    from dspi_tpu_torch.kernels.eq_f32 import f32_cascades_plain
    from dspi_tpu_torch.kernels.xf_cuda import xf_q28_plain
    from dspi_tpu_torch.kernels.xf_f32_cuda import xf_f32_plain

    B = a[0].shape[-1]
    idx = _edge_lanes(B, a[0].device)
    got = fn(*a, **k)

    def cut(v):
        return v.index_select(-1, idx).cpu()

    t0 = time.perf_counter()
    if kind in ("eq", "eqf"):
        x, cf, s0, scal = a
        lane = cf.dim() == 4
        plain = q28_cascades_plain if kind == "eq" else f32_cascades_plain
        want = plain(cut(x), cut(cf) if lane else cf.cpu(), cut(s0),
                     cut(scal) if lane else scal.cpu(), **k)
        names = ("y", "env", "state")
    else:
        l, r, coef, s4 = a
        plain = xf_q28_plain if kind == "xf" else xf_f32_plain
        want = plain(cut(l), cut(r),
                     cut(coef) if coef.dim() == 2 else coef.cpu(), cut(s4))
        names = ("left", "right", "state")
    plain_s = time.perf_counter() - t0
    for name, u, v in zip(names, got, want):
        if (u is None) != (v is None) or (
                u is not None and not torch.equal(cut(u), v)):
            gap = ("" if u is None or v is None else
                   f"; largest gap {max_gap(cut(u), v):.3e}")
            fail(f"{kind} kernel != plain version ({name}) on the main "
                 f"path's arguments {list(a[0].shape)} {k}{gap}")
    return {"checked_streams": f"0-63 and {B - 64}-{B - 1}",
            "plain_cpu_s": plain_s, "equal_to_plain_at_path_shape": True}


def _same_words(label: str, gpu: dict, cpu: dict) -> None:
    for k in cpu:
        if not torch.equal(gpu[k].cpu(), cpu[k]):
            fail(f"{label}: {k} differs")


def _same_state(label: str, card_state, cpu_state) -> None:
    for f, g, c in zip(cpu_state._fields, card_state, cpu_state):
        if (g is None) != (c is None) or (
                g is not None and not torch.equal(g.cpu(), c)):
            fail(f"{label}: state {f} differs")


def phase_q28_card_vs_cpu(dev) -> None:
    """Q28 chain at 8 streams on the card and on the CPU: every output word
    and every state word equal."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config

    B, npkt, nseg = 8, 8, 2
    rng = np.random.default_rng(29)
    for bd in (16, 24):
        engs = [Engine(full_chain_config(Platform.RP2040, RATE),
                       n_streams=B, block_size=BLOCK, bit_depth=bd,
                       emit="full", device=d) for d in (dev, "cpu")]
        lim = 1 << (bd - 2)
        for seg in range(nseg):
            x = rng.integers(-lim, lim, size=(npkt, 2, BLOCK, B)).astype(
                np.int32)
            gpu, cpu = (e.process(x) for e in engs)
            _same_words(f"Q28 card vs CPU ({bd}-bit, segment {seg})", gpu,
                        cpu)
        if cpu["out"].abs().max() <= 1 << 20:
            fail("Q28 card vs CPU: reference signal is silent")
        _same_state(f"Q28 card vs CPU ({bd}-bit)", engs[0].state,
                    engs[1].state)
    print(f"Q28 card vs CPU: {B} streams x {nseg} segments of {npkt}x{BLOCK}"
          f", 16- and 24-bit: every output and state word equal", flush=True)


def phase_new_paths_card_vs_cpu(dev) -> None:
    """The hetero server (3 configs over 24 scattered streams, an
    update_group between its 2 segments) and the 44.1 kHz engine (8
    streams, 2 segments) on the card and on the CPU: every output word and
    every state word equal."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine, HeteroServer
    from dspi_tpu_torch.configs import full_chain_config, hetero_variants

    rng = np.random.default_rng(43)
    cfgs = hetero_variants(3, Platform.RP2040)
    ids = rng.integers(0, 3, 24)
    srvs = [HeteroServer(cfgs, ids, block_size=BLOCK, emit="full", device=d)
            for d in (dev, "cpu")]
    quiet = hetero_variants(3, Platform.RP2040)[1]
    quiet.master_volume_db = -30.0
    for seg in range(2):
        if seg:
            for srv in srvs:
                srv.update_group(1, quiet)
        x = rng.integers(-16000, 16000, size=(8, 2, BLOCK, 24)).astype(
            np.int32)
        gpu, cpu = (srv.process(x) for srv in srvs)
        _same_words(f"hetero card vs CPU (segment {seg})", gpu, cpu)
    if cpu["out"].abs().max() <= 1 << 20:
        fail("hetero card vs CPU: reference signal is silent")
    _same_state("hetero card vs CPU", srvs[0].state, srvs[1].state)

    sched = (44,) * 9 + (45,)
    engs = [Engine(full_chain_config(Platform.RP2040, 44100.0), n_streams=8,
                   schedule=sched, emit="full", device=d)
            for d in (dev, "cpu")]
    for seg in range(2):
        x = rng.integers(-16000, 16000, size=(2, sum(sched), 8)).astype(
            np.int32)
        gpu, cpu = (e.process(x) for e in engs)
        _same_words(f"44.1 kHz card vs CPU (segment {seg})", gpu, cpu)
    if cpu["out"].abs().max() <= 1 << 20:
        fail("44.1 kHz card vs CPU: reference signal is silent")
    _same_state("44.1 kHz card vs CPU", engs[0].state, engs[1].state)
    print("hetero + 44.1 kHz card vs CPU: HeteroServer 3 configs x 24 "
          "streams x 2 segments of 8x48 with an update_group, Engine 8 "
          "streams x 2 segments of 441 samples: every output and state "
          "word equal", flush=True)


SERVE_BATCHES = 5          # the entry point's warm-up batch, then 4 read
# (cell, entry point, its options): examples/serve.py's modes at full width
SERVE_CELLS = (("serve_chained", "serve_chained", {"framed": "device"}),
               ("serve_chained_s24_host", "serve_chained",
                {"framed": "host", "bits": 24}),
               ("serve_hetero", "serve_hetero", {"framed": "device"}))


def phase_serving(card: str) -> dict:
    """The serving entry point (dspi_tpu_torch.serve) at full width, as a
    user runs it: serve_chained at 16384 streams, 8 chained segments of
    32 packets a batch, device wire words, fed s16 payload words deframed
    on the card and packed s24 bytes deframed on the host; serve_hetero
    over 8 configs fed s16 payload words.  SERVE_BATCHES batches each,
    with the mid-run commits; launch counts set to 0 just before each run
    and read just after.  Fails unless every segment launched the PDM
    kernel exactly once and nothing else, and the starvation counters are
    the firmware's count of the feed gaps that exceeded a batch's audio
    time (n_slots a gap, none while a preset operation held the mute);
    starvations themselves do not fail.  The first PDM call of the first
    run is held against the plain version in phase_pdm_plain."""
    from dspi_tpu_torch import serve
    from dspi_tpu_torch.kernels import LAUNCHES, pdm_cuda

    cells = {}
    for label, entry, kw in SERVE_CELLS:
        first = []
        saved = pdm_cuda.pdm_words
        if label == SERVE_CELLS[0][0]:        # every call has its shape
            def record(x, s16, _fn=saved):
                got = _fn(x, s16)
                if not first:
                    first.append((x, s16, got))
                return got
            pdm_cuda.pdm_words = record
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in list(LAUNCHES):
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        try:
            r = getattr(serve, entry)(STREAMS, SERVE_BATCHES, **kw)
        finally:
            pdm_cuda.pdm_words = saved
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {k: n for k, n in LAUNCHES.items() if n}
        depth = r["depth"]
        if launches != {"pdm": depth * SERVE_BATCHES}:
            fail(f"{label} launched {launches} in {SERVE_BATCHES} batches "
                 f"of {depth} segments, not one PDM launch a segment")
        for b in r["batches"]:
            if b["launches"] != {"pdm": depth}:
                fail(f"{label} batch {b['batch']} launched {b['launches']}")
        st = r["stats"]
        want = min(st.n_slots, 4) * (r["gaps_over_deadline"]
                                     - st.starvations_suppressed)
        if st.starvations_total != want or r["starvations"] != want:
            fail(f"{label}: {st.starvations_total} starvations counted "
                 f"(GET_STATUS {r['starvations']}), the feed gaps give "
                 f"{want}")
        if first:
            x, s16, got = first[0]
            hold_pdm(f"{label} {list(x.shape)}", x, s16, got)
        read = r["batches"][1:]
        walls = [b["wall_s"] for b in read]
        mean_wall = sum(walls) / len(walls)
        up = [b["deframe_ms"] + b["upload_ms"] for b in read]
        cell = {
            "entry": f"{entry}({STREAMS}, {SERVE_BATCHES}, {kw})",
            "batch_audio_s": r["batch_audio_s"], "depth": depth,
            "npkt": r["npkt"], "walls_ms": [1e3 * w for w in walls],
            "mean_wall_ms": 1e3 * mean_wall,
            "rtf": STREAMS * r["batch_audio_s"] / mean_wall,
            "stream_rt": r["batch_audio_s"] / mean_wall,
            "deframe_ms": [b["deframe_ms"] for b in read],
            "upload_ms": [b["upload_ms"] for b in read],
            "upload_share": sum(up) / 1e3 / sum(walls),
            "upload_bytes": read[-1]["upload_bytes"],
            "starvations": st.starvations_total,
            "starvations_per_batch": st.starvations_total / (SERVE_BATCHES
                                                             - 1),
            "gaps_over_deadline": r["gaps_over_deadline"],
            "suppressed": st.starvations_suppressed,
            "launches": launches, "setup_s": r["setup_s"],
            "run_s": total_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"{label}: {STREAMS} streams, {depth} x {r['npkt']} packets a "
              f"batch ({1e3 * r['batch_audio_s']:.0f} ms of audio), "
              f"walls {[round(w, 1) for w in cell['walls_ms']]} ms, mean "
              f"{cell['mean_wall_ms']:.1f} ms: RTF {cell['rtf']:.1f}x, "
              f"{cell['stream_rt']:.4f}x real time a stream; host deframe "
              f"{[round(u, 1) for u in cell['deframe_ms']]} ms, upload "
              f"{[round(u, 1) for u in cell['upload_ms']]} ms of "
              f"{cell['upload_bytes']} B (together "
              f"{100 * cell['upload_share']:.1f}% of the walls); "
              f"starvations {st.starvations_total} "
              f"({cell['starvations_per_batch']:.1f} a batch, "
              f"{r['gaps_over_deadline']} gaps over the deadline, "
              f"{st.starvations_suppressed} suppressed); launches "
              f"{launches}; peak memory {cell['peak_gb']:.2f} GB; setup "
              f"{r['setup_s']:.1f} s, run {total_s:.1f} s; card {card}",
              flush=True)
        cells[label] = cell
    return cells


# the float leveller's envelope and gain state: held to 1e-5 relative RMS,
# its budget against the golden model (tests/test_torch_float_leveller.py);
# the envelope's long recursion carries the matrix products' rounding on
LEVELLER_STATE = ("lev_env", "lev_gain_db", "lev_gain", "lev_gain_prev")


def phase_runner_card_vs_cpu(dev) -> None:
    """A ChainedRunner fed payloads through pre=make_pre (8 streams, 3
    chained segments of 4 packets, device wire words, PDM) on the card and
    on the CPU, at 16 and 24 bits (payload words over the full range): on
    the RP2040 chain the folds, peaks, clip flags and every state word
    equal; on the RP2350 chain the clip flags equal, the peaks within 1
    LSB, the float state within 1e-6 relative RMS and the leveller's
    envelope and gain within 1e-5 (LEVELLER_STATE)."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.kernels.deframe import make_pre
    from dspi_tpu_torch.runtime.executor import ChainedRunner

    B, depth, npkt = 8, 3, 4            # 12 ms: past the 10 ms lookahead
    rng = np.random.default_rng(71)
    t0 = time.perf_counter()
    text = []
    for plat in (Platform.RP2040, Platform.RP2350):
        for bits in (16, 24):
            if bits == 16:
                fed = rng.integers(-2**31, 2**31,
                                   size=(depth, B, npkt * BLOCK),
                                   dtype=np.int64).astype(np.int32)
            else:
                fed = rng.integers(0, 256, size=(depth, B, npkt * BLOCK * 6),
                                   dtype=np.int64).astype(np.uint8)
            runs = []
            for d in (dev, "cpu"):
                eng = Engine(full_chain_config(plat, RATE), n_streams=B,
                             block_size=BLOCK, emit="reduced", wire=True,
                             pdm_fade=False, bit_depth=bits, device=d)
                r = ChainedRunner(eng, depth=depth,
                                  pre=make_pre(npkt, BLOCK, bits))
                out = r.feed(fed)
                r.drain()
                runs.append((out, eng.state))
            ((fg, pg, cg), sg), ((fc, pc, cc), sc) = runs
            label = f"runner card vs CPU ({plat.name}, {bits}-bit)"
            if not pc[2:].ne(0).any():
                fail(f"{label}: silent outputs")
            if plat is Platform.RP2040:
                for what, g, c in (("folds", fg, fc), ("peaks", pg, pc),
                                   ("clips", cg, cc)):
                    if not torch.equal(g.cpu(), c):
                        fail(f"{label}: {what} differ")
                _same_state(label, sg, sc)
                text.append(f"{plat.name} {bits}-bit equal")
                continue
            if (pg.cpu() - pc).abs().max() > 1:
                fail(f"{label}: peaks differ by more than 1 LSB")
            if not torch.equal(cg.cpu(), cc):
                fail(f"{label}: clip flags differ")
            worst = {"lev": 0.0, "rest": 0.0}
            for f, g, c in zip(sc._fields, sg, sc):
                if c is not None and c.is_floating_point():
                    err = rel_rms(g.cpu().numpy(), c.numpy())
                    part = "lev" if f in LEVELLER_STATE else "rest"
                    worst[part] = max(worst[part], err)
                    if err > (1e-5 if part == "lev" else 1e-6):
                        fail(f"{label}: state {f} relative RMS {err:.3e}")
            fold_err = float(((fg.cpu() - fc).abs() / fc.abs()).max())
            text.append(f"{plat.name} {bits}-bit float state "
                        f"{worst['rest']:.3e}, leveller envelope and gain "
                        f"{worst['lev']:.3e}, folds {fold_err:.2e} apart")
    print(f"runner card vs CPU ({time.perf_counter() - t0:.1f} s): "
          f"ChainedRunner, pre=make_pre, {B} streams x {depth} segments of "
          f"{npkt}x{BLOCK}: {'; '.join(text)} (RP2040: folds, peaks, clips "
          f"and every state word; RP2350: clips equal, peaks within 1 LSB, "
          f"float state <= 1e-6, the leveller's envelope and gain <= 1e-5)",
          flush=True)


# ----------------------------------------------------------------------------
# random configs (tests/test_fuzz.py's) at full width
# ----------------------------------------------------------------------------

FUZZ_PACKETS = 24         # past the lookahead's 10-13 silent packets
FUZZ_Q28 = (1, 2, 3, 5, 101, 303)
FUZZ_SCHED, FUZZ_SCHED_SEGMENTS = (606, 707), 3
# the F1 classes (tests/fuzz_twin.py): 303 meets the block lowering's
# budget on the CPU, 1 and 202 break it by the block path's own rounding,
# 3, 36 and 505 by the firmware's own float32 recursion
FUZZ_FLOAT = (303, 1, 202, 3, 36, 505)
# where the CPU port breaks the 1e-6 budget, the card's distance to the
# golden model over the CPU port's, at most
FUZZ_BLOCK_RATIO = 1.5


def random_config(rng, platform):
    """tests/test_fuzz.py's random_config on the port's own types: the
    same draws in the same order (tests/test_torch_fuzz_sched.py holds the
    two field for field on every seed used here)."""
    from dspi_tpu_torch import DeviceConfig, EqBand, FilterType
    from dspi_tpu_torch.params.types import Crosspoint

    types = [FilterType.FLAT, FilterType.PEAKING, FilterType.LOWSHELF,
             FilterType.HIGHSHELF, FilterType.LOWPASS, FilterType.HIGHPASS]
    cfg = DeviceConfig(platform=platform)
    nout = cfg.num_outputs
    cfg.preamp_db = [float(rng.uniform(-12, 6)) for _ in range(2)]
    cfg.master_volume_db = float(rng.uniform(-40, 0))
    cfg.host_volume_index = int(rng.integers(30, 61))
    for ch in range(cfg.num_channels):
        for b in range(10):
            cfg.eq[ch][b] = EqBand(
                types[int(rng.integers(len(types)))],
                float(rng.uniform(10, 20000)),
                float(rng.uniform(0.3, 10.0)),
                float(rng.uniform(-10, 10)))
    for o in range(nout):
        cfg.outputs[o].enabled = bool(rng.random() < 0.8)
        cfg.outputs[o].mute = bool(rng.random() < 0.1)
        cfg.outputs[o].gain_db = float(rng.uniform(-12, 3))
        cfg.outputs[o].delay_ms = float(rng.uniform(0, 8))
        for i in range(2):
            cfg.crosspoints[i][o] = Crosspoint(
                bool(rng.random() < 0.8), bool(rng.random() < 0.2),
                float(rng.uniform(-20, 6)))
    cfg.sync_delays()
    cfg.leveller.enabled = bool(rng.random() < 0.7)
    cfg.leveller.amount = float(rng.uniform(10, 100))
    cfg.leveller.speed = int(rng.integers(0, 3))
    cfg.leveller.lookahead = bool(rng.random() < 0.7)
    cfg.crossfeed.enabled = bool(rng.random() < 0.7)
    cfg.crossfeed.preset = int(rng.integers(0, 4))
    if cfg.crossfeed.preset == 3:
        cfg.crossfeed.custom_fc = float(rng.uniform(500, 2000))
        cfg.crossfeed.custom_feed_db = float(rng.uniform(0, 15))
    cfg.loudness.enabled = bool(rng.random() < 0.7)
    cfg.loudness.intensity_pct = float(rng.uniform(0, 100))
    return cfg


def fuzz_case(seed: int, platform, scheduled: bool = False):
    """A seed's (config, schedule or None), drawn as tests/test_fuzz.py
    draws them: the config, then a random aperiodic schedule's nine
    packet sizes."""
    rng = np.random.default_rng(seed)
    cfg = random_config(rng, platform)
    if not scheduled:
        return cfg, None
    return cfg, tuple(int(v) for v in rng.integers(24, 64, size=9))


def golden_lanes(golds, x, sched) -> dict:
    """Feed one segment of the first and the last lane of ``x`` ([Npkt,
    2, T, B], or [2, sum(sched), B]) to ``golds``, one golden device
    each: their out, s24 and PDM words (int32 bits) in the engine's
    emit='full' layout, and each packet's peaks [Npkt, nch, 2]."""
    xl = x.index_select(-1, torch.tensor([0, x.shape[-1] - 1],
                                         device=x.device)).cpu().numpy()
    per = []
    for s, g in enumerate(golds):
        if sched:
            offs = np.cumsum((0,) + tuple(sched))
            frames = [xl[:, a:b, s].T for a, b in zip(offs[:-1], offs[1:])]
        else:
            frames = [xl[k, :, :, s].T for k in range(xl.shape[0])]
        per.append([g.process_packet(np.ascontiguousarray(f), bit_depth=16)
                    for f in frames])

    def planes(key, axis):
        if sched:               # each lane's packets joined in time
            return np.stack([np.concatenate([np.asarray(p[key])
                                             for p in pk], axis=axis)
                             for pk in per], axis=-1)
        return np.stack([np.stack([np.asarray(p[key]) for p in pk])
                         for pk in per], axis=-1)

    s24 = np.moveaxis(planes("spdif", 1), -2, -3)
    pdm = np.stack([np.array([w for p in pk for w in p["pdm_words"]],
                             np.uint32).reshape(-1, 8) for pk in per], -1)
    return {"out": planes("buf_out", -1),
            "s24": s24.reshape(*s24.shape[:-4], -1, *s24.shape[-2:]),
            "pdm": pdm.view(np.int32),
            "packet_peaks": np.stack([np.array([p["peaks"] for p in pk])
                                      for pk in per], axis=-1)}


def _edge2(out: dict) -> dict:
    """An engine's outputs on its first and last lane, as NumPy."""
    return {k: v.index_select(-1, torch.tensor(
        [0, v.shape[-1] - 1], device=v.device)).cpu().numpy()
        for k, v in out.items()}


def fuzz_q28_words(label: str, got: dict, want: dict, clips) -> None:
    """A Q28 segment's words on the edge lanes against the golden model's:
    out, s24 and PDM equal; each channel's peak (max |x| >> 13) & 0xFFFF
    the largest of its packets' where it never clipped (no packet's
    value wrapped), else its loudest packet's, one of theirs."""
    for k in got:
        if k == "peaks":
            for ch, s in np.ndindex(*got[k].shape):
                pk = want["packet_peaks"][:, ch, s]
                ok = (got[k][ch, s] in pk if clips[s] >> ch & 1
                      else got[k][ch, s] == pk.max())
                if not ok:
                    fail(f"{label}: peak of channel {ch}, lane {s}: "
                         f"{got[k][ch, s]}, packets {pk.tolist()}")
        elif got[k].shape != want[k].shape or not np.array_equal(got[k],
                                                                  want[k]):
            n = (got[k] != want[k]).sum() if got[k].shape == want[k].shape \
                else "shape"
            fail(f"{label}: {k} differs from the golden model's ({n})")


def phase_fuzz(dev, card: str) -> dict:
    """tests/test_fuzz.py's random configs at full width (16384 lanes x
    24 packets of 48), each one segment against the port's golden model
    on the first and the last lane: the Q28 chain (FUZZ_Q28) and its
    random aperiodic schedules (FUZZ_SCHED, 3 segments of 9 packets)
    word for word, the float scan lowering (FUZZ_FLOAT, PDM off) bit for
    bit, and the block lowering card against CPU (float_close), or where
    the CPU port breaks 1e-6 (F1) no farther than FUZZ_BLOCK_RATIO times
    the CPU port's distance.  Every kernel call of a first segment is held
    against its plain version at its full shape on the edge lanes
    (check_path_call; PDM calls in phase_pdm_plain).  Launch counts are
    set to 0 before each segment and read after it; the float cascade
    libraries that its new band-kinds signatures need are built at first
    use and each build's time printed."""
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.golden.model import GoldenDevice
    from dspi_tpu_torch.kernels import build

    t0 = time.perf_counter()
    launches: dict = {}
    builds: dict = {}
    held = [0]

    def segment(eng, x, record: bool):
        calls = []
        _zero_launches()
        with recording(calls if record else []):
            out = eng.process(x)
        torch.cuda.synchronize()
        for k, n in _launches().items():
            launches[k] = launches.get(k, 0) + n
        for kind, fn, a, k in calls:
            if kind == "pdm":
                hold_pdm(f"fuzz {list(a[0].shape)}", *a, fn(*a))
            else:
                check_path_call(kind, fn, a, k)
            held[0] += 1
        return out

    def built_at_first_use(*a, **k):
        report = build_all(*a, **k)
        builds.update({key: round(r["seconds"], 1)
                       for key, r in report.items()})
        return report

    build_all = build.build_all
    build.build_all = built_at_first_use
    try:
        for seed in FUZZ_Q28 + FUZZ_SCHED:
            t1 = time.perf_counter()
            cfg, sched = fuzz_case(seed, Platform.RP2040, seed in FUZZ_SCHED)
            eng = Engine(cfg, n_streams=STREAMS, emit="full", schedule=sched,
                         device=dev)
            golds = [GoldenDevice(cfg.copy()) for _ in range(2)]
            gen = torch.Generator(device=dev).manual_seed(seed)
            nseg = FUZZ_SCHED_SEGMENTS if sched else 1
            for i in range(nseg):
                shape = ((2, sum(sched), STREAMS) if sched else
                         (FUZZ_PACKETS, 2, BLOCK, STREAMS))
                x = _rand_i32(gen, -16383, 16383, shape, dev)
                got = _edge2(segment(eng, x, record=i == 0))
                want = golden_lanes(golds, x, sched)
                fuzz_q28_words(f"fuzz Q28 seed {seed} segment {i}", got,
                               want, [g.clip_flags for g in golds])
            clips = _edge2({"c": eng.state.clip_flags})["c"]
            if clips.tolist() != [g.clip_flags for g in golds]:
                fail(f"fuzz Q28 seed {seed}: clip flags differ")
            if not np.abs(want["s24"]).any():
                fail(f"fuzz Q28 seed {seed}: the golden model is silent")
            print(f"fuzz Q28 seed {seed}"
                  f"{f' schedule {sched} x {nseg}' if sched else ''}: "
                  f"{STREAMS} lanes, out/s24/PDM/peaks/clip flags word for "
                  f"word with the golden model on lanes 0 and {STREAMS - 1} "
                  f"({time.perf_counter() - t1:.1f} s)", flush=True)
            del eng, x

        block = {}
        for seed in FUZZ_FLOAT:
            t1 = time.perf_counter()
            cfg, _ = fuzz_case(seed, Platform.RP2350)
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = _rand_i32(gen, -16383, 16383,
                          (FUZZ_PACKETS, 2, BLOCK, STREAMS), dev)
            want = golden_lanes([GoldenDevice(cfg.copy()) for _ in range(2)],
                                x, None)["out"]
            eng = Engine(cfg, n_streams=STREAMS, emit="full", pdm=False,
                         mxu=False, device=dev)
            got = _edge2(segment(eng, x, record=True))["out"]
            if not np.array_equal(got, want):
                fail(f"fuzz scan seed {seed}: out differs from the golden "
                     f"model's, relative RMS {rel_rms(got, want):.3e}")
            t_scan = time.perf_counter() - t1
            eng = Engine(cfg, n_streams=STREAMS, emit="full", pdm=False,
                         device=dev)
            on_card = {k: torch.from_numpy(v) for k, v in
                       _edge2(segment(eng, x, record=False)).items()}
            del eng
            cpu = Engine(cfg, n_streams=2, emit="full", pdm=False,
                         device="cpu").process(_edge2({"x": x})["x"])
            d_card = rel_rms(on_card["out"].numpy(), want)
            d_cpu = rel_rms(cpu["out"].numpy(), want)
            d_cross = rel_rms(on_card["out"].numpy(), cpu["out"].numpy())
            if d_cpu < 1e-6:
                w, _ = float_close(f"fuzz block seed {seed} card vs CPU",
                                   on_card, cpu)
                how = f"card vs CPU float_close, worst {w:.3e}"
            elif d_card > FUZZ_BLOCK_RATIO * d_cpu:
                fail(f"fuzz block seed {seed}: card {d_card:.3e} from the "
                     f"golden model, > {FUZZ_BLOCK_RATIO} x the CPU port's "
                     f"{d_cpu:.3e}")
            else:
                how = (f"F1: card / CPU distance {d_card / d_cpu:.3f} <= "
                       f"{FUZZ_BLOCK_RATIO}")
            block[seed] = {"card": d_card, "cpu": d_cpu,
                           "card_vs_cpu": d_cross}
            print(f"fuzz float seed {seed}: {STREAMS} lanes; the scan bit for"
                  f" bit with the golden model on lanes 0 and {STREAMS - 1} "
                  f"({t_scan:.1f} s, float cascade builds included); the "
                  f"block lowering {d_card:.3e} from it on the card, "
                  f"{d_cpu:.3e} on the CPU, card vs CPU {d_cross:.3e} "
                  f"({how}; {time.perf_counter() - t1:.1f} s in all)",
                  flush=True)
    finally:
        build.build_all = build_all
    for key, sec in builds.items():
        print(f"  built at first use: {key} in {sec} s", flush=True)
    need = ("eq_q28", "eq_q28_sched", "xf_q28", "pdm", "eq_f32", "xf_f32")
    if not all(launches.get(k) for k in need):
        fail(f"fuzz: launches {launches} miss one of {need}")
    seconds = time.perf_counter() - t0
    print(f"fuzz phase: {seconds:.1f} s; launches {launches}; {held[0]} "
          f"kernel calls held against their plain versions; card {card}",
          flush=True)
    return {"launches": launches, "seconds": seconds, "builds": builds,
            "block": block}


def _pdm_plain_worker(x, s16):
    """pdm_words_plain in a worker process, on one thread."""
    from dspi_tpu_torch.kernels.pdm import pdm_words_plain

    torch.set_num_threads(1)
    return pdm_words_plain(x, s16)


def phase_pdm_plain() -> dict:
    """Every PDM call held by hold_pdm against the plain version on the
    CPU, word for word: the held lanes of all calls of one segment length
    side by side in one plain call, the plain calls of the segment lengths
    in parallel, one worker process each (each a Python loop over its
    samples)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    by_len: dict = {}
    for held in PDM_HELD:
        by_len.setdefault(held[1].shape[0], []).append(held)
    t0 = time.perf_counter()
    groups = list(by_len.values())
    args = [tuple(torch.cat([h[i] for h in items], -1) for i in (1, 2))
            for items in groups]
    with ProcessPoolExecutor(
            len(args), mp_context=multiprocessing.get_context("spawn")) as ex:
        plain = list(ex.map(_pdm_plain_worker, *zip(*args)))
    for items, (words, s_out) in zip(groups, plain):
        lo = 0
        for label, xi, _, w, s in items:
            hi = lo + xi.shape[-1]
            if not (torch.equal(words[..., lo:hi], w)
                    and torch.equal(s_out[:, lo:hi], s)):
                fail(f"PDM kernel != plain version on {label}")
            lo = hi
    plain_s = time.perf_counter() - t0
    labels = [h[0] for h in PDM_HELD]
    print(f"pdm at full length: kernel == plain version (CPU, {plain_s:.1f} "
          f"s) on the first and last 64 lanes of {labels}", flush=True)
    return {"equal_to_plain_at_path_shape": labels,
            "plain_cpu_s_at_path_shape": plain_s}


# ----------------------------------------------------------------------------
# the benchmark and graft entry points, the firmware oracles
# ----------------------------------------------------------------------------

BENCH_DEPTH, BENCH_ITERS = 8, 2
# bench_stages' other stages, once each at a small width on the card
STAGE_SMALL = dict(B=1024, NPKT=8, ITERS=2, DEPTH=2)


def _launches() -> dict:
    from dspi_tpu_torch.kernels import LAUNCHES

    return {k: n for k, n in LAUNCHES.items() if n}


def _zero_launches() -> None:
    from dspi_tpu_torch.kernels import LAUNCHES

    for k in list(LAUNCHES):
        LAUNCHES[k] = 0


def phase_bench(dev, card: str, main_path: dict) -> dict:
    """The benchmark twin's headline (``dspi_tpu_torch.bench``'s
    ``bench_engine``, as ``python -m dspi_tpu_torch.bench`` runs it) at
    full width: the headline float chain, 16384 streams x 128 packets,
    BENCH_DEPTH chained segments a run (x ^ i each), best of BENCH_ITERS
    runs from the restored state, each run's fold equal to the first's;
    launch counts set to 0 just before and read just after (one PDM
    launch a segment: the warm-up run, the timed runs and the two latency
    segments).  Printed beside this run's float main path (phase 6)."""
    from dspi_tpu_torch import Platform, bench
    from dspi_tpu_torch.configs import full_chain_config

    cfg = full_chain_config(Platform.RP2350, RATE)
    _zero_launches()
    t0 = time.perf_counter()
    try:
        rtf, latency = bench.bench_engine(cfg, STREAMS, PACKETS, BENCH_ITERS,
                                          depth=BENCH_DEPTH, device=dev)
    except RuntimeError as e:
        fail(f"bench headline: {e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    segments = BENCH_DEPTH * (1 + max(BENCH_ITERS, 2)) + 2
    if launches != {"pdm": segments}:
        fail(f"bench headline launched {launches}, not {segments} PDM")
    audio_s = STREAMS * PACKETS * BLOCK / RATE
    seg_ms = 1e3 * audio_s / rtf
    gap = seg_ms / main_path["mean_ms"] - 1.0
    print(f"bench headline (dspi_tpu_torch.bench): RTF {rtf:.1f}x at "
          f"{STREAMS} x {PACKETS}x{BLOCK}, best of {max(BENCH_ITERS, 2)} "
          f"chained runs of {BENCH_DEPTH} segments ({seg_ms:.3f} ms a "
          f"segment, host clock), one synchronous segment "
          f"{1e3 * latency:.3f} ms; this run's float main path (phase 6, "
          f"mean of {SEGMENTS}, CUDA events) {main_path['mean_ms']:.3f} ms, "
          f"RTF {main_path['rtf']:.1f}x: the benchmark's segment "
          f"{100 * gap:+.1f}% from it; {wall:.1f} s in all; launches "
          f"{launches}; card {card}", flush=True)
    return {"rtf": rtf, "latency_s": latency, "segment_ms": seg_ms,
            "main_path_mean_ms": main_path["mean_ms"],
            "main_path_rtf": main_path["rtf"], "gap": gap,
            "launches": launches, "depth": BENCH_DEPTH,
            "iters": max(BENCH_ITERS, 2)}


def phase_full96(dev, card: str) -> dict:
    """bench_stages' full96 stage at full width: the headline chain at 96
    kHz, 16384 streams x 64 packets x 96 samples (the 48 kHz segment's
    samples), 4 chained segments a run, with the card's peak memory (the
    port applies the 96 kHz blocks without the JAX package's x-chunking);
    one PDM launch a segment."""
    from dspi_tpu_torch import bench_stages

    S = bench_stages.Settings(B=STREAMS, NPKT=PACKETS // 2, ITERS=2, DEPTH=4,
                              device=dev)
    _zero_launches()
    t0 = time.perf_counter()
    r = bench_stages.run_stage("full96", S)["full_96k"]
    launches = _launches()
    segments = S.DEPTH * (1 + max(S.ITERS, 2)) + 2
    if launches != {"pdm": segments}:
        fail(f"full96 launched {launches}, not {segments} PDM")
    print(f"full96 (bench_stages): {S.B} streams x {S.NPKT}x96 samples, RTF "
          f"{r['rtf']:.1f}x, one synchronous segment "
          f"{1e3 * r['wall']:.3f} ms, peak memory {r['peak_gb']:.2f} GB; "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}; card "
          f"{card}", flush=True)
    return {**r, "launches": launches}


def phase_stages(dev, card: str) -> dict:
    """Every other bench_stages stage once on the card at a small width
    (STAGE_SMALL; the 44.1 kHz stages on their 130-packet cadence,
    pdm_sweep at its four widths), each printing its readings and
    launches."""
    from dspi_tpu_torch import bench_stages

    S = bench_stages.Settings(device=dev, **STAGE_SMALL)
    out = {}
    for stage in bench_stages.STAGES:
        if stage == "full96":
            continue
        _zero_launches()
        t0 = time.perf_counter()
        try:
            got = bench_stages.run_stage(stage, S)
        except Exception as e:                  # noqa: BLE001
            fail(f"bench_stages {stage}: {type(e).__name__}: {e}")
        torch.cuda.synchronize()
        launches = _launches()
        if not launches.get("pdm") and stage not in ("nopdm", "passthrough",
                                                     "peq"):
            fail(f"bench_stages {stage} launched no PDM kernel: {launches}")
        readings = {k: {m: (round(v, 4) if isinstance(v, float) else v)
                        for m, v in e.items()} for k, e in got.items()}
        print(f"bench_stages {stage} ({S.B} streams, {S.NPKT} packets, "
              f"depth {S.DEPTH}): {json.dumps(readings)}; "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}",
              flush=True)
        out[stage] = {"entries": got, "launches": launches}
    print(f"bench_stages: {len(out)} stages ran on {card}", flush=True)
    return out


def phase_graft(dev) -> dict:
    """graft_entry on the card: dryrun_multichip(1), its seven sections
    over a mesh of this card, ticked; then entry()'s step on the card
    against the same step on the CPU (float state <= 1e-6 relative RMS,
    peaks and PDM sums equal)."""
    import contextlib
    import io

    from dspi_tpu_torch import graft_entry

    _zero_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(1)
    torch.cuda.synchronize()
    ticks = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[dryrun]")]
    for ln in ticks:
        print(ln, flush=True)
    if len(ticks) != 7:
        fail(f"dryrun_multichip ticked {len(ticks)} sections, not 7")
    launches = _launches()

    runs = []
    for d in (dev, "cpu"):
        fn, args = graft_entry.entry(device=d)
        runs.append(fn(*args))
    (sg, og), (sc, oc) = runs
    for k in ("peaks", "pdm_sum"):
        if not torch.equal(og[k].cpu(), oc[k]):
            fail(f"graft entry card vs CPU: {k} differ")
    worst = 0.0
    for f, g, c in zip(sc._fields, sg, sc):
        if c is not None and c.is_floating_point():
            worst = max(worst, rel_rms(g.cpu().numpy(), c.numpy()))
    if worst > 1e-6:
        fail(f"graft entry card vs CPU: float state {worst:.3e}")
    print(f"graft_entry: dryrun_multichip(1) 7 sections "
          f"({time.perf_counter() - t0:.1f} s with the entry step; launches "
          f"{launches}); entry() card vs CPU: peaks and PDM sums equal, "
          f"float state {worst:.3e}", flush=True)
    return {"ticks": ticks, "launches": launches, "entry_state_rel": worst}


ORACLE_STREAMS, ORACLE_PACKETS = 8, 24


def oracle_input(rng) -> np.ndarray:
    """int32 [ORACLE_PACKETS, 2, BLOCK, ORACLE_STREAMS] of s16 samples:
    the first half of the streams loud (half scale), the rest quiet
    (1/50 scale, which holds the leveller in its boost region)."""
    scale = np.where(np.arange(ORACLE_STREAMS) < ORACLE_STREAMS // 2,
                     0.5, 0.02) * 32767
    u = rng.uniform(-1.0, 1.0,
                    size=(ORACLE_PACKETS, 2, BLOCK, ORACLE_STREAMS))
    return (u * scale).astype(np.int32)


def phase_fw_oracle(dev) -> dict:
    """The card's engines against the port's firmware oracles
    (``dspi_tpu_torch.native``, native/dspi_host.cpp built with g++), each
    stream of ORACLE_STREAMS run through the oracle alone over
    ORACLE_PACKETS packets at 48 kHz:

      * the float chain (headline config, block matmuls) against
        FirmwareFloat(coeff_source="design"): the loud streams' outputs
        within 1e-6 relative RMS of it; every stream's within 1e-6 of the
        golden model (``dspi_tpu_torch.golden``); the quiet streams',
        where the leveller boosts and the golden model itself sits
        ~3.5e-6 from the firmware's libm gain, within 1e-6 farther from
        the firmware than the golden model is;
      * the Q28 chain (headline config) with the leveller off against
        FirmwareQ28: every output and PDM word equal;
      * the Q28 chain, leveller on, on the config tests/test_fw_oracle.py
        measured its 48 kHz bounds on (``q5_config``): each stream's
        outputs within 512 Q28 LSBs and its s24 words within 8 (the libm
        gain can flip a quantized LSB), its PDM modulator input differing
        on under 2% of samples and its words equal where that input never
        differs;
      * the Q28 headline chain, leveller on: every output and PDM word
        the golden model's, and its distance to FirmwareQ28 read: the
        golden model itself sits outside the q5 bounds there, a property
        of the reference's deterministic gain math against libm, not of
        the port (PERF.md)."""
    from dspi_tpu_torch import Platform, native
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.golden.model import GoldenDevice

    rng = np.random.default_rng(0xD5B1F)
    x = oracle_input(rng)
    t0 = time.perf_counter()
    res = {}

    def engine_out(cfg):
        eng = Engine(cfg, n_streams=ORACLE_STREAMS, block_size=BLOCK,
                     device=dev)
        out = eng.process(torch.from_numpy(x).to(dev))
        return {k: v.cpu().numpy() for k, v in out.items()}

    cfg = full_chain_config(Platform.RP2350, RATE)
    got = engine_out(cfg)["out"]
    fw, gold, rels = [], [], []
    for s in range(ORACLE_STREAMS):
        want, _ = native.FirmwareFloat(cfg, coeff_source="design").process(
            x[..., s])
        if np.abs(want).max() <= 0:
            fail(f"firmware oracle: float stream {s} is silent")
        g = GoldenDevice(cfg)
        ref = np.stack([g.process_packet(np.ascontiguousarray(
            x[p, :, :, s].T))["buf_out"] for p in range(ORACLE_PACKETS)])
        fw.append(rel_rms(got[..., s], want))
        gold.append(rel_rms(got[..., s], ref))
        rels.append(rel_rms(ref, want))
    loud = ORACLE_STREAMS // 2
    if max(fw[:loud]) > 1e-6 or max(gold) > 1e-6 or any(
            f > r + 1e-6 for f, r in zip(fw[loud:], rels[loud:])):
        fail(f"float engine vs FirmwareFloat {fw}, vs the golden model "
             f"{gold}; the golden model vs FirmwareFloat {rels}")
    res["float"] = {"engine_vs_fw": fw, "engine_vs_golden": gold,
                    "golden_vs_fw": rels}

    # (label, config, mode): "exact" every output and PDM word equal to
    # FirmwareQ28; "bounds" within tests/test_fw_oracle.py's 48 kHz LSB
    # bounds; "golden" every word equal to the golden model, the distance
    # to FirmwareQ28 read (the golden model's own)
    nolev = full_chain_config(Platform.RP2040, RATE)
    nolev.leveller.enabled = False
    cases = (("headline, leveller off", nolev, "exact"),
             ("q5_full 48 kHz, leveller on", q5_config(), "bounds"),
             ("headline, leveller on",
              full_chain_config(Platform.RP2040, RATE), "golden"))
    for label, cfg, mode in cases:
        out = engine_out(cfg)
        got = out["out"].astype(np.int64)
        words = out["pdm"].view(np.uint32).reshape(-1, 8, ORACLE_STREAMS)
        worst = {"q28_lsb": 0, "s24_lsb": 0, "pdm_in_flip": 0.0,
                 "pdm_flip": 0.0}
        for s in range(ORACLE_STREAMS):
            want, want_words = native.FirmwareQ28(cfg).process(x[..., s])
            g = got[..., s]
            s24 = [np.clip((v.astype(np.int64) + 32) >> 6, -0x800000,
                           0x7FFFFF) for v in (g, want)]
            sub = g.shape[1] - 1
            m = {"q28_lsb": int(np.abs(g - want).max()),
                 "s24_lsb": int(np.abs(s24[0] - s24[1]).max()),
                 "pdm_in_flip": float(((g[:, sub] >> 14) != (
                     want[:, sub].astype(np.int64) >> 14)).mean()),
                 "pdm_flip": float((words[..., s] != want_words).mean())}
            bad = {"exact": m["q28_lsb"] or m["pdm_flip"],
                   "bounds": (m["q28_lsb"] > 512 or m["s24_lsb"] > 8
                              or m["pdm_in_flip"] >= 2e-2
                              or (m["pdm_in_flip"] == 0 and m["pdm_flip"])),
                   "golden": False}[mode]
            if mode == "golden":
                gd = GoldenDevice(cfg)
                pk = [gd.process_packet(np.ascontiguousarray(
                    x[p, :, :, s].T)) for p in range(ORACLE_PACKETS)]
                ref = np.stack([np.asarray(q["buf_out"]) for q in pk])
                ref_words = np.array([w for q in pk for w in q["pdm_words"]],
                                     np.uint32).reshape(-1, 8)
                bad = not (np.array_equal(g, ref)
                           and np.array_equal(words[..., s], ref_words))
            if bad:
                fail(f"Q28 engine vs FirmwareQ28 ({label}) stream {s}: "
                     f"{m}" + (" and not the golden model's words"
                               if mode == "golden" else ""))
            worst = {k: max(worst[k], v) for k, v in m.items()}
        res[label] = worst
    print(f"firmware oracles ({time.perf_counter() - t0:.1f} s; "
          f"{ORACLE_STREAMS} streams x {ORACLE_PACKETS}x{BLOCK}, half of "
          f"them quiet): float engine (block matmuls) vs FirmwareFloat "
          f"relative RMS {max(fw[:loud]):.3e} at most on the loud streams "
          f"(<= 1e-6), {max(fw[loud:]):.3e} on the quiet ones (the golden "
          f"model's own {max(rels[loud:]):.3e}), vs the golden model "
          f"{max(gold):.3e} (<= 1e-6); Q28 engine vs FirmwareQ28, headline "
          f"leveller off: every output and PDM word equal; q5_full leveller "
          f"on: worst {res['q5_full 48 kHz, leveller on']} (q28 <= 512, s24 "
          f"<= 8 LSBs); headline leveller on: every word the golden "
          f"model's, FirmwareQ28 worst {res['headline, leveller on']}",
          flush=True)
    return res


def q5_config():
    """The RP2040 config tests/test_fw_oracle.py's leveller-on LSB bounds
    were measured on (``q5_full`` at 48 kHz): 8 peaking bands a channel,
    every output live with delays, loudness, crossfeed, and the leveller
    at amount 70, speed 2, lookahead, gate -70 dB."""
    from dspi_tpu_torch import DeviceConfig, EqBand, FilterType, Platform
    from dspi_tpu_torch.params.types import Crosspoint

    cfg = DeviceConfig(platform=Platform.RP2040, sample_rate=RATE)
    for ch in range(cfg.num_channels):
        for b in range(8):
            cfg.eq[ch][b] = EqBand(FilterType.PEAKING, 150.0 * (b + 1), 1.2,
                                   1.5 if (ch + b) % 2 else -2.0)
    for o in range(cfg.num_outputs):
        cfg.outputs[o].enabled = True
        cfg.outputs[o].delay_ms = 0.4 * o
        cfg.crosspoints[0][o] = Crosspoint(True, False, -3.0)
        cfg.crosspoints[1][o] = Crosspoint(True, False, -3.0)
    cfg.sync_delays()
    cfg.loudness.enabled = True
    cfg.crossfeed.enabled = True
    lv = cfg.leveller
    lv.enabled, lv.amount, lv.speed = True, 70.0, 2
    lv.lookahead, lv.gate_threshold_db = True, -70.0
    return cfg


def _path_rows(calls: list, kind: str) -> dict:
    """ms, bound and what bounds it of one kernel's calls in one segment
    of a path, summed."""
    mine = [c for c in calls if c["kind"] == kind]
    return {"ms": sum(c["ms"] for c in mine),
            "bound_ms": sum(c["bound_ms"] for c in mine),
            "bound_by": max(mine, key=lambda c: c["bound_ms"])["bound_by"],
            "calls": mine}


def main() -> None:
    kind, card = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    built = phase_build()
    pdm_row = phase_pdm(dev)
    eq_row = phase_eq(dev)
    mode_times = phase_eq_modes(dev)
    xf_row = phase_xf(dev)
    eqf_times = phase_eq_f32(dev)
    xff_row = phase_xf_f32(dev)
    main_path = phase_main(dev, card)
    phase_card_vs_cpu(dev)
    q28 = phase_q28_main(dev, card, 16, record=True)
    q28_24 = phase_q28_main(dev, card, 24, record=False)
    phase_q28_card_vs_cpu(dev)
    hetero = phase_hetero(dev, card)
    s441 = phase_44k1(dev, card)
    phase_new_paths_card_vs_cpu(dev)
    f_wire = phase_float_wire(dev, card)
    f_441 = phase_float_44k1(dev, card)
    f_het = phase_float_hetero(dev, card)
    phase_float_paths_card_vs_cpu(dev)
    f_scan = phase_float_scan(dev, card)
    f_scan_het = phase_float_scan_hetero(dev, card)
    phase_scan_card_vs_cpu(dev)
    serving = phase_serving(card)
    phase_runner_card_vs_cpu(dev)
    fuzz = phase_fuzz(dev, card)
    pdm_row.update(phase_pdm_plain())
    bench_head = phase_bench(dev, card, main_path)
    full96 = phase_full96(dev, card)
    stages = phase_stages(dev, card)
    graft = phase_graft(dev)
    oracle = phase_fw_oracle(dev)

    # launches: each path's counted run (SEGMENTS segments each; the Q28
    # chain at 16-bit and at 24-bit)
    paths = {"rp2350_float": main_path["launches"],
             "rp2040_q28_16bit": q28["launches"],
             "rp2040_q28_24bit": q28_24["launches"],
             "rp2040_q28_hetero": hetero["launches"],
             "rp2040_q28_44k1": s441["launches"],
             "rp2350_float_wire": f_wire["launches"],
             "rp2350_float_44k1": f_441["launches"],
             "rp2350_float_hetero": f_het["launches"],
             "rp2350_float_scan": f_scan["launches"],
             "rp2350_float_scan_hetero": f_scan_het["launches"],
             **{label: cell["launches"] for label, cell in serving.items()},
             "bench_headline": bench_head["launches"],
             "bench_stages_full96": full96["launches"],
             **{f"bench_stages_{st}": r["launches"]
                for st, r in stages.items()},
             "graft_dryrun_multichip": graft["launches"],
             "fuzz_random_configs": fuzz["launches"]}
    # the cascade kernel's scalar-coefficient, uniform-packet mode: its
    # launches less the other modes' (no path combines lane_cf and a
    # schedule)
    for n in paths.values():
        n["eq_q28_scalar"] = (n.get("eq_q28", 0) - n.get("eq_q28_lane_cf", 0)
                              - n.get("eq_q28_sched", 0))
    lane_row = {"name": "eq_q28_cascade_lane_cf", "route": "cuda",
                "source": "dspi_tpu_torch/kernels/csrc/eq_q28.cu",
                "replaces": "dspi_tpu/kernels/eq_pallas.py:142 (_core, "
                            "lane_cf mode)",
                "max_abs_err": 0, "plain_ms": mode_times["lane_cf"][0],
                "library_ms": None, "equal_to_plain": True,
                "plain_shape": [4, 2 * BLOCK, 4100],
                "kernel_ms_at_plain_shape": mode_times["lane_cf"][1],
                **_path_rows(hetero["calls"], "eq")}
    sched_row = {"name": "eq_q28_cascade_sched", "route": "cuda",
                 "source": "dspi_tpu_torch/kernels/csrc/eq_q28.cu",
                 "replaces": "dspi_tpu/kernels/eq_pallas.py:196 (_core, "
                             "schedule mode: dense envelope :305, packet-end "
                             "gather :352)",
                 "max_abs_err": 0, "plain_ms": mode_times["sched"][0],
                 "library_ms": None, "equal_to_plain": True,
                 "plain_shape": [4, sum(SCHED), 4100],
                 "kernel_ms_at_plain_shape": mode_times["sched"][1],
                 **_path_rows(s441["calls"], "eq")}
    eqf_row = {"name": "eq_f32_cascade", "route": "cuda",
               "source": "dspi_tpu_torch/kernels/csrc/eq_f32.cu",
               "replaces": "dspi_tpu/chain/pipeline.py:418-485 and :626-639 "
                           "(scan A and scan B, lax.scan, no TPU kernel)",
               "max_abs_err": 0.0,
               "plain_ms": eqf_times["scalar G=2"][0]
               + eqf_times["scalar G=9"][0],
               "library_ms": None, "equal_to_plain": True,
               "plain_shape": [[2, 2 * BLOCK, 4100], [9, 2 * BLOCK, 4100]],
               "kernel_ms_at_plain_shape": eqf_times["scalar G=2"][1]
               + eqf_times["scalar G=9"][1],
               "phase_ms_by_mode": eqf_times,
               "registers": built.get("eq_f32", {}).get("registers"),
               "instances_built": built.get("eq_f32", {}).get("instances"),
               "one_instance_build_s": built.get("eq_f32", {}).get(
                   "one_instance_build_s"),
               "pinned_ops": {"band": F32_BAND_OPS, "loudness": F32_LOUD_OPS,
                              "envelope": F32_ENV_OPS},
               **_path_rows(f_scan["calls"], "eqf"),
               "hetero": _path_rows(f_scan_het["calls"], "eqf")}
    xff_row.update(_path_rows(f_scan["calls"], "xff"),
                   hetero=_path_rows(f_scan_het["calls"], "xff"),
                   pinned_ops=XF_F32_OPS,
                   registers=built.get("xf_f32", {}).get("max_registers"))
    for row, key in ((pdm_row, "pdm"), (eq_row, "eq_q28_scalar"),
                     (lane_row, "eq_q28_lane_cf"),
                     (sched_row, "eq_q28_sched"), (xf_row, "xf_q28"),
                     (eqf_row, "eq_f32"), (xff_row, "xf_f32")):
        row["launches_by_path"] = {p: n.get(key, 0) for p, n in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    # the scalar mode's time and bound per segment: its two calls
    eq_row.update(_path_rows(q28["calls"], "eq"))
    xf_call = next(c for c in q28["calls"] if c["kind"] == "xf")
    pdm_row["path_calls"] = {
        p: next(c for c in r["calls"] if c["kind"] == "pdm")
        for p, r in (("rp2350_float", main_path), ("rp2040_q28_16bit", q28),
                     ("rp2040_q28_hetero", hetero),
                     ("rp2040_q28_44k1", s441),
                     ("rp2350_float_wire", f_wire),
                     ("rp2350_float_44k1", f_441),
                     ("rp2350_float_hetero", f_het),
                     ("rp2350_float_scan", f_scan),
                     ("rp2350_float_scan_hetero", f_scan_het))}
    pdm_row["paths"] = {
        p: {k: r[k] for k in ("mean_ms", "rtf", "peak_gb")}
        for p, r in (("rp2350_float", main_path), ("rp2040_q28_16bit", q28),
                     ("rp2040_q28_24bit", q28_24),
                     ("rp2040_q28_hetero", hetero), ("rp2040_q28_44k1", s441),
                     ("rp2350_float_wire", f_wire),
                     ("rp2350_float_44k1", f_441),
                     ("rp2350_float_hetero", f_het),
                     ("rp2350_float_scan", f_scan),
                     ("rp2350_float_scan_hetero", f_scan_het))}
    pdm_row["serving"] = serving
    pdm_row["wire_stage"] = {k: f_wire[k] for k in (
        "wire_ms", "wire_segment_ms", "wire_share", "fused_wire_bound_ms")}
    xf_row.update(ms=xf_call["ms"], bound_ms=xf_call["bound_ms"],
                  bound_by=xf_call["bound_by"], shape=xf_call["shape"],
                  hetero_call=next(c for c in hetero["calls"]
                                     if c["kind"] == "xf"))
    print(json.dumps({"bench": {
        "headline": bench_head, "full96": full96,
        "stages": {st: r["entries"] for st, r in stages.items()},
        "stage_settings": STAGE_SMALL, "graft": graft,
        "firmware_oracles": oracle}, "fuzz": fuzz}), flush=True)
    print(json.dumps({"kernels": [pdm_row, eq_row, lane_row, sched_row,
                                  xf_row, eqf_row, xff_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
