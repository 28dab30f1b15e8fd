#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

  1. the card: name and power limit (nvidia-smi)
  2. build every CUDA kernel from dspi_tpu_torch/kernels/csrc/ (nvcc, one
     process per source, in parallel)
  3. PDM kernel vs its plain PyTorch version on the card: 4100 streams (a
     ragged edge), three 96-sample segments with per-lane enable flips
     (fade-out, stop, restart, mid-fade re-enable); words and all 16 state
     rows bit-equal.  Then the kernel alone at the headline shape
     (16384 streams x 6144 samples), timed with CUDA events, beside its
     bound.
  4. the main path at full width: Engine on the headline RP2350 chain at
     48 kHz, 16384 streams, 4 chained segments of 128 packets x 48 samples
     with state carried and a fresh input each (x ^ i); launch counts reset
     just before and read just after; per-segment time and real-time
     factor
  5. card vs CPU on the same config at 8 streams: out/s24 <= 1e-6
     relative RMS, PDM words equal up to the first differing modulator
     input
  6. one JSON line {"kernels": [...]} for every ported kernel
  7. last line: {"ok": true, "device": {...}}

Exits non-zero, printing no result, when no CUDA device is present.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

STREAMS, PACKETS, BLOCK, SEGMENTS = 16384, 128, 48, 4
RATE = 48000.0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# 32-bit integer issue: the integer pipes of an SM (16 lanes in each of its
# 4 partitions) take 64 int32 operations per clock; the rate is that times
# the SM count times the card's maximum SM clock, both read at run time.
INT32_OPS_PER_SM_CLOCK = 64
# int32 operations per modulated sample and stream, counted on the
# kernel's own form (pdm.cu; profile_torch.py checks the count in the
# SASS): a bit step is 6 (sign shift, two masks, two three-input adds, the
# word's shift-add), 256 of them; a chunk is 22 (xorshift 6, dither 2,
# shaper 12 with the multiply-adds fused, dither add, word end, err2
# restore); 36 per sample (mode machine, clip, fade, target, leaky
# integrators, freeze selects)
PDM_OPS_PER_SAMPLE = 256 * 6 + 8 * 22 + 36


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


def int32_ops_per_s() -> float:
    """Peak int32 issue rate of card 0: SMs x 64 ops x max SM clock."""
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_OPS_PER_SM_CLOCK * mhz * 1e6


def phase_build() -> None:
    from dspi_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    regs = {n: [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln] for n, r in report.items()}
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'nothing (cached)'}; ptxas: {regs}",
          flush=True)


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
    nbytes = 4 * T * B + 32 * T * B + 2 * 64 * B
    ops = PDM_OPS_PER_SAMPLE * T * B
    int_rate = int32_ops_per_s()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / int_rate
    bound_ms = 1e3 * max(t_bytes, t_ops)
    print(f"pdm: kernel == plain on 4100 streams x 3 x 96 samples "
          f"(fade-out, stop, restart, mid-fade re-enable); plain "
          f"{plain_ms:.1f} ms / kernel {kern_small_ms:.3f} ms per segment "
          f"there; headline {T}x{B}: kernel {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({ops:.3e} int32 ops at {int_rate:.4e}/s, "
          f"{nbytes:.3e} bytes)",
          flush=True)
    return {"name": "pdm_modulator", "route": "cuda",
            "source": "dspi_tpu_torch/kernels/csrc/pdm.cu",
            "replaces": "dspi_tpu/kernels/pdm_pallas.py:138",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "equal_to_plain": True,
            "shape": [T, B], "plain_shape": [2 * BLOCK, 4100],
            "kernel_ms_at_plain_shape": kern_small_ms}


def phase_main(dev, card: str) -> dict:
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    eng = Engine(full_chain_config(Platform.RP2350, RATE), n_streams=STREAMS,
                 block_size=BLOCK, emit="reduced", pdm=True, pdm_fade=False,
                 device=dev)
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-16000, 16000, (PACKETS, 2, BLOCK, STREAMS),
                      generator=gen, dtype=torch.int32, device=dev)
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
    launches = dict(LAUNCHES)

    seg_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(SEGMENTS)]
    if launches.get("pdm", 0) != SEGMENTS:
        fail(f"PDM kernel launched {launches.get('pdm', 0)} times in "
             f"{SEGMENTS} segments")
    for i, out in enumerate(outs):
        if set(out) != {"peaks", "s24_sum", "pdm_sum"}:
            fail(f"segment {i}: outputs {sorted(out)}")
        if out["peaks"].shape != (11, STREAMS) or not (
                (out["peaks"] >= 0) & (out["peaks"] <= 32767)).all():
            fail(f"segment {i}: peaks out of range")
        if not out["pdm_sum"].ne(0).any() or not out["s24_sum"].ne(0).any():
            fail(f"segment {i}: silent outputs")
    for f, v in zip(eng.state._fields, eng.state):
        if v is not None and v.is_floating_point() and \
                not torch.isfinite(v).all():
            fail(f"state {f} not finite")
    audio_s = STREAMS * PACKETS * BLOCK / RATE
    mean_ms = sum(seg_ms) / SEGMENTS
    rtf = audio_s / (mean_ms / 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path: {STREAMS} streams x {PACKETS}x{BLOCK} samples, "
          f"{SEGMENTS} chained segments: per segment "
          f"{[round(m, 3) for m in seg_ms]} ms (CUDA events), mean "
          f"{mean_ms:.3f} ms, host wall {1e3 * wall / SEGMENTS:.3f} ms; "
          f"RTF {rtf:.1f}x; peak memory {peak_gb:.2f} GB; setup "
          f"{setup_s:.1f} s; launches {launches}; card {card}", flush=True)
    return launches


def phase_card_vs_cpu(dev) -> None:
    from dspi_tpu_torch import Platform
    from dspi_tpu_torch.chain import Engine
    from dspi_tpu_torch.configs import full_chain_config
    from dspi_tpu_torch.core.qmath import f32_to_i32

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
        gpu, cpu = ({k: v.cpu() for k, v in e.process(x).items()}
                    for e in engs)
        ref = cpu["out"].double()
        if seg == nseg - 1 and ref.pow(2).mean().sqrt() < 1e-4:
            fail("card vs CPU: reference signal is silent")
        for k in ("out", "s24"):
            err = rel_rms(gpu[k].numpy(), cpu[k].numpy())
            worst = max(worst, err)
            if err > 1e-6:
                fail(f"card vs CPU: {k} relative RMS {err:.3e} > 1e-6")
        if (gpu["peaks"] - cpu["peaks"]).abs().max() > 1:
            fail("card vs CPU: peaks differ by more than 1 LSB")
        subs = [f32_to_i32(o["out"][:, -1].reshape(-1, B) * float(1 << 28))
                >> 14 for o in (gpu, cpu)]
        for s in range(B):
            diff = (subs[0][:, s] != subs[1][:, s]).nonzero()
            k = int(diff[0, 0]) if len(diff) else subs[0].shape[0]
            if not torch.equal(gpu["pdm"][:k, :, s], cpu["pdm"][:k, :, s]):
                fail(f"card vs CPU: PDM words differ in stream {s} before "
                     f"the modulator inputs do (sample {k})")
            compared += k
    if (engs[0].state.clip_flags.cpu() != engs[1].state.clip_flags).any():
        fail("card vs CPU: clip flags differ")
    print(f"card vs CPU: {B} streams x {nseg} segments of {npkt}x{BLOCK}: "
          f"out/s24 worst relative RMS {worst:.3e} (<= 1e-6); PDM words "
          f"equal over {compared} sample-streams before any modulator "
          f"input differs", flush=True)


def main() -> None:
    kind, card = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    pdm_row = phase_pdm(dev)
    launches = phase_main(dev, card)
    phase_card_vs_cpu(dev)
    pdm_row["launches"] = launches["pdm"]
    print(json.dumps({"kernels": [pdm_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
