"""Entry points of the port: one forward step, and a dry run over a mesh.

The twin of the JAX package's ``__graft_entry__.py``:

  * ``entry()`` returns ``(fn, example_args)``: one forward step of the
    headline float chain (``configs.full_chain_config``) at 128 streams x
    2 packets x 48 samples on the block-matmul lowering; ``fn(*args)`` is
    ``chain.process_float`` with the step's block matrices bound;
  * ``dryrun_multichip(n)`` runs seven sections with the stream axis split
    over n devices (``runtime.executor``'s mesh, ``shard_engine``,
    ``ChainedRunner`` and ``make_pre``), each ticked with its wall time.

Both run on the card unless the caller passes devices:
``entry(device="cpu")``, ``dryrun_multichip(n, [torch.device("cpu")] * n)``.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .configs import full_chain_config
from .core.constants import Platform


def entry(device=None):
    """(fn, (params, state, x, preset_mute)): one forward step of the
    flagship chain (all 11 channels, float, block matmuls) at small
    shapes, on ``device`` (None: the card, raising without one)."""
    from .chain import build_params, build_static, init_state
    from .chain.mxu import build_blocks
    from .chain.pack import resolve_device, to_device
    from .chain.pipeline import process_float
    from .params.design import derive

    dev = resolve_device(device)
    B, NPKT, T = 128, 2, 48
    d = derive(full_chain_config(Platform.RP2350))
    static = build_static(d, block_size=T, emit="reduced", mxu=True)
    params = to_device(build_params(d, static), dev)
    state = to_device(init_state(static, B), dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(
        -16000, 16000, size=(NPKT, 2, T, B)).astype(np.int32)).to(dev)
    pm = torch.ones(NPKT, dtype=torch.float32, device=dev)
    fn = functools.partial(process_float, static,
                           blocks=build_blocks(static, params, dev))
    return fn, (params, state, x, pm)


def _slim_config(platform):
    """``full_chain_config`` with 2 EQ bands a channel instead of 10: every
    pass stays live (preamp, loudness, EQ, leveller, crossfeed, matrix,
    per-output EQ, delays, PDM), and the dry run checks the split of the
    stream axis, not throughput."""
    cfg = full_chain_config(platform)
    for ch in range(len(cfg.eq)):
        for b in range(2, 10):
            cfg.eq[ch][b] = type(cfg.eq[ch][b])()   # flat band
    return cfg


def _devices(n_devices: int, devices):
    if devices is None:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have}; "
                               "pass a device list to run without")
        return [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    return devices[:n_devices]


def _check_shards(split, n_devices: int) -> None:
    """The ShardedEngine holds ``n_devices`` shards of state, shard d on
    mesh device d (the JAX package checks its arrays' device sets)."""
    assert len(split.state) == n_devices, len(split.state)
    for st, dev in zip(split.state, split.mesh.devices):
        for v in st:
            if v is not None:
                assert v.device == dev, (v.device, dev)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The chain with its stream axis split over an n-device mesh.

    The DSP chain is stream-parallel by construction: the split is pure
    data parallelism over independent streams with no communication
    beyond feed and drain (the firmware's analog: the dual-core output
    split and multi-instance DMA outputs, usb_audio.c:782-871,
    pdm_generator.c:427-667).  Seven sections, each ticked: the float
    block-matmul chain, the Q28 chain, the 44.1 kHz (44, 45) schedule, a
    depth-2 ``ChainedRunner``, framed serving with the on-device deframe,
    a float ``HeteroServer`` with a second config's coefficients swapped
    mid-run, and the Q28 flat ``HeteroServer`` fed 24-bit payload bytes.
    ``devices``: the mesh's devices (None: the first ``n_devices`` cards).
    """
    from .chain import Engine
    from .chain.grouped import HeteroServer
    from .kernels.deframe import make_pre
    from .runtime.executor import ChainedRunner, make_mesh, shard_engine

    t_start = time.perf_counter()

    def tick(label):
        print(f"[dryrun] {label}: {time.perf_counter() - t_start:.1f}s",
              flush=True)

    mesh = make_mesh(_devices(n_devices, devices))
    dev0 = mesh.devices[0]
    B = 2 * n_devices
    NPKT, T = 1, 48
    rng = np.random.default_rng(0)

    def ints(lo, hi, shape, dtype=np.int32):
        return rng.integers(lo, hi, size=shape).astype(dtype)

    def sharded(eng):
        split = shard_engine(eng, mesh)
        _check_shards(split, n_devices)
        return split

    cfg = _slim_config(Platform.RP2350)
    cfg_q = _slim_config(Platform.RP2040)
    kw = dict(block_size=T, emit="reduced", device=dev0)
    x = ints(-16000, 16000, (NPKT, 2, T, B))

    # the float block-matmul chain: each shard runs its lanes' products
    split = sharded(Engine(cfg, n_streams=B, mxu=True, **kw))
    out = split.process(x)
    assert out["peaks"].shape[-1] == B
    tick("float block-matmul chain")

    split_q = sharded(Engine(cfg_q, n_streams=B, **kw))
    out_q = split_q.process(x)
    assert out_q["peaks"].shape[-1] == B
    tick("Q28 chain")

    # the 44.1 kHz variable-packet schedule (per-size block matrices)
    sched = (44, 45)
    split_s = sharded(Engine(cfg, n_streams=B, schedule=sched, mxu=True,
                             **kw))
    out_s = split_s.process(ints(-16000, 16000, (2, sum(sched), B)))
    assert out_s["peaks"].shape[-1] == B
    tick("scheduled 44.1k block-matmul chain")

    # the serving loop: depth segments a batch, state carried on the mesh
    split_r = sharded(Engine(cfg, n_streams=B, pdm=False, mxu=True, **kw))
    runner = ChainedRunner(split_r, depth=2, mesh=mesh)
    runner.feed(ints(-16000, 16000, (2, NPKT, 2, T, B)))
    folds = runner.drain()[0]
    assert torch.isfinite(folds).all()
    _check_shards(split_r, n_devices)
    tick("depth-2 ChainedRunner serving loop")

    # framed serving: raw USB payload words in, deframed on the device by
    # the runner's pre hook, then split over the mesh
    runner_f = ChainedRunner(split_r, depth=2, mesh=mesh,
                             pre=make_pre(NPKT, T))
    samples = ints(-16000, 16000, (2, B, NPKT * T * 2), np.int16)
    runner_f.feed(samples.view(np.int32))
    assert torch.isfinite(runner_f.drain()[0]).all()
    tick("framed serving loop (on-device deframe)")

    # multi-tenant serving: the grouped state splits on its lane axis and
    # the bucketing gathers run ahead of the split; a second config's
    # coefficients are swapped between two batches
    K = 2
    cfg_b = _slim_config(Platform.RP2350)
    cfg_b.master_volume_db = -16.0
    ids = np.arange(B) % K                  # even buckets: G = B / K
    split_h = sharded(HeteroServer([cfg, cfg_b], ids, pdm=False, mxu=True,
                                   **kw))
    runner_h = ChainedRunner(split_h, depth=2, mesh=mesh)
    runner_h.feed(ints(-16000, 16000, (2, NPKT, 2, T, B)))
    cfg_c = _slim_config(Platform.RP2350)
    cfg_c.master_volume_db = -20.0
    split_h.update_group(1, cfg_c)
    runner_h.commit_params()
    runner_h.feed(ints(-16000, 16000, (2, NPKT, 2, T, B)))
    assert torch.isfinite(runner_h.drain()[0]).all()
    tick("multi-tenant HeteroServer over the mesh")

    # a Q28 fleet, which runs the flat per-lane layout, fed raw 24-bit
    # payload bytes deframed on the device ahead of the bucketing gather
    cfg_q2 = _slim_config(Platform.RP2040)
    cfg_q2.master_volume_db = -16.0
    srv_q = HeteroServer([cfg_q, cfg_q2], ids, pdm=False, bit_depth=24,
                         **kw)
    assert srv_q.grouped.layout == "flat", srv_q.grouped.layout
    runner_hf = ChainedRunner(sharded(srv_q), depth=2, mesh=mesh,
                              pre=make_pre(NPKT, T, bit_depth=24))
    s24 = ints(-(1 << 23), 1 << 23, (2, B, NPKT * T, 2))
    payload = np.stack([s24 & 0xFF, (s24 >> 8) & 0xFF, (s24 >> 16) & 0xFF],
                       axis=-1).astype(np.uint8)
    runner_hf.feed(payload.reshape(2, B, NPKT * T * 6))
    assert torch.isfinite(runner_hf.drain()[0]).all()
    tick("hetero framed 24-bit (flat layout) over the mesh")
