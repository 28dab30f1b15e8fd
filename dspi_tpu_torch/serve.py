"""End-to-end serving: many virtual DSPi devices on one card.

The twin of the JAX package's ``examples/serve.py`` on the PyTorch port:

  1. boot a vendor-protocol device, full 11-channel chain
  2. spin up the batched engine (device-side S/PDIF wire words on)
  3. serve batches through ChainedRunner with real-time accounting:
     ``depth`` segments a batch on the card, one host readback a batch
  4. live control changes (master volume, preset save) applied at batch
     boundaries with the firmware's deferred-update semantics
  5. telemetry (peaks, loads, starvations) read back through the vendor
     protocol

Run:  python -m dspi_tpu_torch.serve [n_streams] [n_batches]
        [--interactive | --hetero] [--framed | --framed-dev] [--bits24]
        [--mesh] [--cpu]

  --interactive  segment-at-a-time StreamRunner, host wire encoder
  --hetero       8 configs scattered over the streams (HeteroServer), a
                 live update_group + commit_params mid-run
  --framed       every batch starts from raw USB payload bytes, deframed
                 on the host by the native data plane and uploaded
  --framed-dev   raw payload words uploaded and deframed on the card
                 (kernels/deframe.py), half the upload bytes at 16 bits
  --bits24       the UAC alt-2 24-bit wire format (packed s24 payloads)
  --mesh         split the stream axis over every visible card
  --cpu          run on the CPU at depth 2 x 8 packets (no card needed);
                 without it the engine runs on the card and raises
                 without one

The modes compose as the JAX demo's do.  Each batch prints its wall, the
real-time factor over all streams, each stream's own real-time ratio
(audio a stream / wall), the load, the peaks, the input upload and the
kernel launches; the run ends with the starvation total GET_STATUS 17
reads.  ``serve_chained``/``serve_hetero``/``serve_interactive`` also
return these readings.
"""

from __future__ import annotations

import struct
import sys
import time

import numpy as np
import torch

from . import Platform
from .chain import Engine
from .configs import full_chain_config
from .control import requests as R
from .control.device import VirtualDSPi
from .kernels import LAUNCHES
from .runtime.executor import ChainedRunner, StreamRunner
from .runtime.telemetry import EngineTelemetry
from .runtime.wire_out import WireEncoder


def _trimmed_mean_wall(walls):
    """Steady-state per-batch wall: trimmed mean (drop the fastest and
    slowest batch) rather than the minimum — a single feed interval can
    under-measure when the deferred readback of batch N-1 overlaps batch
    N's host packetization, so the min overstates sustained throughput."""
    if not walls:
        return float("inf")
    w = sorted(walls)
    if len(w) > 4:
        w = w[1:-1]
    return sum(w) / len(w)


def _s24_bytes(rng, lead_shape, frames):
    """Random s24 LRLR payload bytes (little-endian 3 bytes/sample,
    2 samples/frame) shaped [*lead_shape, frames*6] — the UAC alt-2
    24-bit wire layout (usb_audio.c:997-1006)."""
    s = rng.integers(-(20000 << 8), 20000 << 8,
                     size=lead_shape + (frames, 2)).astype(np.int32)
    b = np.stack([s & 0xFF, (s >> 8) & 0xFF, (s >> 16) & 0xFF],
                 axis=-1).astype(np.uint8)
    return np.ascontiguousarray(b.reshape(lead_shape + (frames * 6,)))


def _s16_samples(rng, lead_shape, frames):
    """Random interleaved s16 LRLR frames, int16 [*lead_shape, frames*2]."""
    return np.ascontiguousarray(rng.integers(
        -20000, 20000, size=lead_shape + (frames * 2,), dtype=np.int16))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches_since(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in LAUNCHES.items()
            if n != before.get(k, 0)}


class _Gaps:
    """The feed gaps seen from outside the runner: how many exceeded the
    deadline (each one is a starvation the runner must count on every
    slot, unless a preset operation suppressed it; the modes here make no
    structural commit, which would reset the runner's clock)."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.t_last = None
        self.over = 0

    def feed(self) -> None:
        now = time.perf_counter()
        if self.t_last is not None and now - self.t_last > self.deadline_s:
            self.over += 1
        self.t_last = now


def _mesh(device):
    from .runtime.executor import make_mesh
    return make_mesh(None if device is None else [device])


def serve_chained(n_streams: int, n_batches: int, depth: int = 8,
                  npkt: int = 32, block: int = 48, use_mesh: bool = False,
                  framed: str | None = None, bits: int = 16,
                  device=None) -> dict:
    """The production loop on one device config (``full_chain_config``):
    ChainedRunner, ``depth`` x ``npkt`` packets a batch, emit "reduced",
    device wire words, the PDM sub without its fade-in.  ``framed``: None
    (a device-resident input pool), "host" (native deframe + upload of
    planes each batch) or "device" (upload of payload words each batch,
    deframed on the card).  ``device``: None = the card."""
    dev = VirtualDSPi(Platform.RP2350)
    dev.cfg = full_chain_config(Platform.RP2350)   # full 11-channel chain

    eng = Engine(dev.cfg, n_streams=n_streams, block_size=block,
                 emit="reduced", pdm=True, pdm_fade=False, wire=True,
                 bit_depth=bits, device=device)
    dev.dirty = False
    where = eng.device

    mesh = None
    if use_mesh:
        from .runtime.executor import shard_engine
        mesh = _mesh(device)
        eng = shard_engine(eng, mesh)
        where = eng.device
        print(f"mesh: {mesh.size} devices, stream axis split, params "
              "copied to each, no collectives", flush=True)

    pre = None
    if framed == "device":
        from .kernels.deframe import make_pre
        pre = make_pre(npkt, block, bit_depth=bits)

    batch_audio_s = depth * npkt * block / dev.cfg.sample_rate
    runner = ChainedRunner(eng, depth=depth, deadline_s=batch_audio_s,
                           mesh=mesh, pre=pre)
    dev.attach_runner(runner)
    tele = EngineTelemetry(sample_rate=dev.cfg.sample_rate)

    rng = np.random.default_rng(0)
    # each batch's host deframe and upload (framed modes)
    io = {"deframe_ms": [], "upload_ms": [], "bytes": 0, "usb_bytes": 0}
    t_setup = time.perf_counter()
    if framed:
        from . import native
        frames = npkt * block
        if framed == "host":
            # one stream's bytes for the WHOLE batch are contiguous, so a
            # single native call deframes all depth segments
            if bits == 24:
                payload = _s24_bytes(rng, (n_streams,), depth * frames)
            else:
                payload = _s16_samples(rng, (n_streams,),
                                       depth * frames).view(np.uint8)
        elif bits == 24:
            payload = _s24_bytes(rng, (depth, n_streams), frames)
            words = payload                        # [depth, B, frames*6]
        else:
            samples = _s16_samples(rng, (depth, n_streams), frames)
            payload = samples.view(np.uint8)
            words = samples.view(np.int32)         # [depth, B, frames]
        io["usb_bytes"] = payload.nbytes

        def next_batch():
            t0 = time.perf_counter()
            if framed == "host":
                xb_ = native.deframe_batch(payload, depth * npkt, block,
                                           bit_depth=bits)
                xb_ = xb_.reshape(depth, npkt, 2, block, n_streams)
            else:
                xb_ = words
            t1 = time.perf_counter()
            xb_ = torch.from_numpy(xb_).to(where)
            _sync(where)                # the finished upload, not its dispatch
            io["deframe_ms"].append(1e3 * (t1 - t0))
            io["upload_ms"].append(1e3 * (time.perf_counter() - t1))
            io["bytes"] = xb_.numel() * xb_.element_size()
            return xb_
    else:
        # one device-resident pool of `depth` DISTINCT segments; each feed
        # is a fresh dispatch over it
        amp = 20000 << 8 if bits == 24 else 20000
        pool = torch.from_numpy(rng.integers(
            -amp, amp, size=(depth, npkt, 2, block, n_streams)).astype(
                np.int32)).to(where)

        def next_batch():
            return pool
    setup_s = time.perf_counter() - t_setup

    mode = {None: "device wire words on",
            "host": "native host deframe from USB bytes",
            "device": "on-device deframe from USB bytes"}[framed]
    if bits == 24:
        mode += f", {bits}-bit (UAC alt-2)"
    print(f"serving {n_streams} streams on {where}, {n_batches} batches of "
          f"{depth} x {npkt} packets ({1000 * batch_audio_s:.0f} ms audio "
          f"per batch), {mode}", flush=True)

    def gains():
        return np.stack([dev.packet_gains(npkt, block)
                         for _ in range(depth)])

    gaps = _Gaps(batch_audio_s)
    walls, batches = [], []
    for b in range(n_batches):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        xb = next_batch()
        gaps.feed()
        done = runner.feed(xb, preset_mute=gains())
        wall = time.perf_counter() - t0
        rec = {"batch": b, "wall_s": wall,
               "launches": _launches_since(before),
               "deframe_ms": io["deframe_ms"][-1] if framed else 0.0,
               "upload_ms": io["upload_ms"][-1] if framed else 0.0,
               "upload_bytes": io["bytes"]}
        if b > 0:
            # steady-state: each feed forces the PREVIOUS batch; its wall
            # is the sustained per-batch cost
            walls.append(wall)
            folds, peaks, clips = done
            dev.update_telemetry(peaks, clips)
            tele.load.update(wall / batch_audio_s)
            rtf = n_streams * batch_audio_s / wall
            status = dev.get(R.GET_STATUS, 9)
            pk = struct.unpack("<11H", status[:22])
            starv = struct.unpack("<I", dev.get(R.GET_STATUS, 17))[0]
            rec.update(rtf=rtf, stream_rt=batch_audio_s / wall,
                       load=tele.load.percent, peaks_lr=pk[:2],
                       starvations=starv)
            print(f"  batch {b:2d}: {rtf:9.0f}x RT sustained, "
                  f"{batch_audio_s / wall:.3f}x real time a stream, wall "
                  f"{1e3 * wall:.1f} ms, load {tele.load.percent}%, peak "
                  f"L/R {pk[0]}/{pk[1]}, host deframe "
                  f"{rec['deframe_ms']:.1f} ms, upload "
                  f"{rec['upload_ms']:.1f} ms ({rec['upload_bytes']} B), "
                  f"launches {sum(rec['launches'].values())} (pdm "
                  f"{rec['launches'].get('pdm', 0)}), starvations {starv}",
                  flush=True)
        batches.append(rec)

        if b == n_batches // 2:
            dev.set(R.SET_MASTER_VOLUME, 0, struct.pack("<f", -6.0))
            if dev.commit(eng):
                runner.commit_params()
            print("  [mid-run] master volume -> -6 dB "
                  "(params swap at batch boundary)", flush=True)
        if b == n_batches // 2 + 1:
            dev.set(R.PRESET_SAVE, 1)
            dev.commit(eng)
            runner.commit_params()
            print("  [mid-run] preset save -> 8 ms mute envelope armed",
                  flush=True)

    runner.drain()
    per_batch = _trimmed_mean_wall(walls)
    sustained = n_streams * batch_audio_s / per_batch
    starv = struct.unpack("<I", dev.get(R.GET_STATUS, 17))[0]
    print(f"done: {n_batches * depth * npkt} packets/stream, "
          f"{sustained:.0f}x RT sustained (trimmed mean, {n_streams} "
          f"streams), {batch_audio_s / per_batch:.3f}x real time a stream, "
          f"starvations {starv}", flush=True)
    if framed and n_batches > 1:
        d = _trimmed_mean_wall(io["deframe_ms"][1:])
        u = _trimmed_mean_wall(io["upload_ms"][1:])
        stage = ("host deframe + upload" if framed == "host"
                 else "payload upload")
        print(f"  {stage}: {d + u:.1f} ms/batch (host deframe {d:.1f} ms, "
              f"upload {u:.1f} ms; {io['usb_bytes'] / 1e3 / (d + u):.0f} "
              f"MB/s of USB bytes, {io['bytes']} B uploaded a batch)",
              flush=True)
    return {"mode": "chained", "framed": framed, "bits": bits,
            "n_streams": n_streams, "depth": depth, "npkt": npkt,
            "batch_audio_s": batch_audio_s, "setup_s": setup_s,
            "batches": batches, "sustained_rtf": sustained,
            "starvations": starv, "stats": runner.stats,
            "gaps_over_deadline": gaps.over,
            "usb_bytes": io["usb_bytes"]}


def serve_hetero(n_streams: int, n_batches: int, n_cfgs: int = 8,
                 depth: int = 8, npkt: int = 32, block: int = 48,
                 use_mesh: bool = False, framed: str | None = None,
                 bits: int = 16, device=None) -> dict:
    """Multi-tenant serving: ``n_cfgs`` device configs (each with its own
    EQ frequency and master volume) scattered across the streams in
    arbitrary order, bucketed by HeteroServer and chained by
    ChainedRunner, one readback a batch, a live per-tenant coefficient
    swap mid-run.  ``framed`` feeds raw USB payloads in the caller's
    stream order, deframed on the card ("device") or by the native host
    data plane ("host") ahead of the bucketing gather."""
    from .chain import HeteroServer

    cfgs = []
    for k in range(n_cfgs):
        c = full_chain_config(Platform.RP2350)
        c.eq[0][0].freq = 60.0 + 15.0 * k
        c.eq[1][0].freq = 60.0 + 15.0 * k
        c.master_volume_db = -6.0 - 1.5 * k
        cfgs.append(c)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, n_cfgs, size=n_streams)

    mesh = None
    lane_multiple = 1
    if use_mesh:
        mesh = _mesh(device)
        lane_multiple = mesh.size
    pre = None
    if framed == "device":
        from .kernels.deframe import make_pre
        pre = make_pre(npkt, block, bit_depth=bits)
    t_setup = time.perf_counter()
    srv = HeteroServer(cfgs, ids, block_size=block, emit="reduced",
                       pdm=True, pdm_fade=False,
                       lane_multiple=lane_multiple, bit_depth=bits,
                       device=device)
    if mesh is not None:
        from .runtime.executor import shard_engine
        srv = shard_engine(srv, mesh)
        print(f"mesh: {mesh.size} devices, each bucket's lanes split",
              flush=True)
    where = srv.device
    batch_audio_s = depth * npkt * block / cfgs[0].sample_rate
    runner = ChainedRunner(srv, depth=depth, deadline_s=batch_audio_s,
                           mesh=mesh, pre=pre)

    frames = npkt * block
    if framed == "host":
        from . import native
        if bits == 24:
            payload = _s24_bytes(rng, (n_streams,), depth * frames)
        else:
            payload = _s16_samples(rng, (n_streams,),
                                   depth * frames).view(np.uint8)
        xb = native.deframe_batch(payload, depth * npkt, block,
                                  bit_depth=bits)
        xb = xb.reshape(depth, npkt, 2, block, n_streams)
    elif framed == "device":
        if bits == 24:
            xb = _s24_bytes(rng, (depth, n_streams), frames)
        else:
            xb = _s16_samples(rng, (depth, n_streams),
                              frames).view(np.int32)     # [depth, B, frames]
    else:
        xb = rng.integers(
            -20000, 20000,
            size=(depth, npkt, 2, block, n_streams)).astype(np.int32)
    xb = torch.from_numpy(np.ascontiguousarray(xb)).to(where)
    setup_s = time.perf_counter() - t_setup
    mode = {None: "", "host": ", native host deframe from USB bytes",
            "device": ", on-device deframe from USB bytes"}[framed]
    if bits == 24:
        mode += f" ({bits}-bit)"
    print(f"hetero serving: {n_cfgs} configs scattered over {n_streams} "
          f"streams (padding waste {100 * srv.padding_waste:.1f}%), "
          f"{n_batches} batches of {depth} x {npkt} packets{mode}", flush=True)

    gaps = _Gaps(batch_audio_s)
    walls, batches = [], []
    for b in range(n_batches):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        gaps.feed()
        runner.feed(xb)
        wall = time.perf_counter() - t0
        rec = {"batch": b, "wall_s": wall,
               "launches": _launches_since(before), "deframe_ms": 0.0,
               "upload_ms": 0.0, "upload_bytes": 0}
        if b > 0:
            walls.append(wall)
            rtf = n_streams * batch_audio_s / wall
            rec.update(rtf=rtf, stream_rt=batch_audio_s / wall,
                       starvations=runner.stats.starvations_total)
            print(f"  batch {b:2d}: {rtf:9.0f}x RT sustained, "
                  f"{batch_audio_s / wall:.3f}x real time a stream, wall "
                  f"{1e3 * wall:.1f} ms, launches "
                  f"{sum(rec['launches'].values())} "
                  f"(pdm {rec['launches'].get('pdm', 0)}), starvations "
                  f"{runner.stats.starvations_total}", flush=True)
        batches.append(rec)
        if b == n_batches // 2:
            hushed = cfgs[0].copy()
            hushed.master_volume_db = -40.0
            srv.update_group(0, hushed)
            runner.commit_params()
            print("  [mid-run] tenant 0 master volume -> -40 dB "
                  "(update_group + commit_params)", flush=True)
    runner.drain()
    rtf = n_streams * batch_audio_s / _trimmed_mean_wall(walls)
    print(f"done: {rtf:.0f}x RT sustained (trimmed mean), starvations "
          f"{runner.stats.starvations_total}", flush=True)
    return {"mode": "hetero", "framed": framed, "bits": bits,
            "n_streams": n_streams, "depth": depth, "npkt": npkt,
            "batch_audio_s": batch_audio_s, "setup_s": setup_s,
            "batches": batches, "sustained_rtf": rtf,
            "starvations": runner.stats.starvations_total,
            "stats": runner.stats, "gaps_over_deadline": gaps.over,
            "padding_waste": srv.padding_waste}


def serve_interactive(n_streams: int, n_segments: int, npkt: int = 16,
                      block: int = 48, device=None) -> dict:
    """Latency-bound loop: one segment a feed (StreamRunner), emit
    "full", the host-side WireEncoder, telemetry every segment."""
    dev = VirtualDSPi(Platform.RP2350)
    dev.set(R.SET_LOUDNESS, 0, b"\x01")
    dev.set(R.SET_LEVELLER_ENABLE, 0, b"\x01")
    dev.set(R.SET_MASTER_VOLUME, 0, struct.pack("<f", -12.0))

    eng = Engine(dev.cfg, n_streams=n_streams, block_size=block,
                 emit="full", pdm=False, device=device)
    dev.dirty = False
    where = eng.device
    wire = WireEncoder(dev.cfg, block)
    tele = EngineTelemetry(sample_rate=dev.cfg.sample_rate)
    seg_audio_s = npkt * block / dev.cfg.sample_rate
    runner = StreamRunner(eng, max_inflight=2, deadline_s=seg_audio_s)
    dev.attach_runner(runner)

    rng = np.random.default_rng(0)
    print(f"serving {n_streams} streams on {where}, {n_segments} segments "
          f"of {npkt * block / 48:.0f} ms (interactive mode)", flush=True)
    segments = []
    for seg in range(n_segments):
        x = rng.integers(-20000, 20000,
                         size=(npkt, 2, block, n_streams)).astype(np.int32)
        tele.segment_begin()
        out = runner.feed(x, preset_mute=dev.packet_gains(npkt, block))
        _sync(where)
        rtf = tele.segment_end(npkt, block, n_streams)
        tele.feed_device(dev, out)
        segments.append({"segment": seg, "rtf": rtf})

        if seg == n_segments // 2:
            dev.set(R.SET_MASTER_VOLUME, 0, struct.pack("<f", -6.0))
            dev.commit(eng)
            print("  [mid-run] master volume -> -6 dB", flush=True)
        if seg == n_segments // 2 + 1:
            dev.set(R.PRESET_SAVE, 1)
            dev.commit(eng)
            print("  [mid-run] preset save -> 8 ms mute envelope armed",
                  flush=True)

        if seg % 5 == 0:
            words = wire.encode(out["s24"])
            status = dev.get(R.GET_STATUS, 9)
            peaks = struct.unpack("<11H", status[:22])
            print(f"  seg {seg:3d}: {rtf:9.0f}x RT  load "
                  f"{dev.cpu_loads[0]}%  peak L/R {peaks[0]}/{peaks[1]}  "
                  f"spdif words {tuple(words['pair0'].shape)}", flush=True)

    runner.drain()
    starv = struct.unpack("<I", dev.get(R.GET_STATUS, 17))[0]
    print(f"done: {tele.packets_processed} packets, mean load "
          f"{dev.cpu_loads[0]}%, starvations {starv}", flush=True)
    return {"mode": "interactive", "segments": segments,
            "starvations": starv, "stats": runner.stats}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    n_streams = int(args[0]) if args else 8192
    n_batches = int(args[1]) if len(args) > 1 else 12
    kw = {}
    if "--cpu" in argv:
        kw = dict(device="cpu")
    framed = ("device" if "--framed-dev" in argv
              else "host" if "--framed" in argv else None)
    bits = 24 if "--bits24" in argv else 16
    mesh = "--mesh" in argv
    if "--interactive" in argv:
        serve_interactive(n_streams, n_batches, **kw)
        return
    if "--cpu" in argv:
        kw.update(depth=2, npkt=8)
    if "--hetero" in argv:
        serve_hetero(n_streams, n_batches, use_mesh=mesh, framed=framed,
                     bits=bits, **kw)
    else:
        serve_chained(n_streams, n_batches, use_mesh=mesh, framed=framed,
                      bits=bits, **kw)


if __name__ == "__main__":
    main()
