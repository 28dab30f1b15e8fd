"""dspi_tpu_torch — the DSPi chain in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``dspi_tpu`` (which stays the reference) to
PyTorch on an NVIDIA H100.  It imports nothing of JAX or of ``dspi_tpu``:
the plain-Python modules it needs are its own copies.

It runs the RP2350 float chain on both of its lowerings (block matmuls;
the scan, ``mxu=False``) and the RP2040 Q28 chain, both at 44.1/48/96
kHz, with the device-side wire words and grouped/hetero serving
(``chain.GroupedEngine``, ``chain.HeteroServer``), on the Q28 chain and
the float scan lowering also with per-stream parameters, and the
delta-sigma PDM modulator, the Q28 EQ cascades and crossfeed, and the
float EQ cascades and crossfeed as hand-written CUDA kernels.  Its serving surface is the
JAX package's: the runners, the vendor control plane and the entry
points ``python -m dspi_tpu_torch.serve`` and ``python -m
dspi_tpu_torch.console``, and its benchmarks' and oracles' too: the
benchmark twins ``python -m dspi_tpu_torch.bench`` and ``python -m
dspi_tpu_torch.bench_stages``, the graft entry points, the firmware
oracles and the golden model.

Layout:
  core/     numerics substrate (constants, exact Q28/Q15 and float math)
  params/   control-plane model + coefficient design (NumPy)
  chain/    pack + the batched pipeline + the Engine + grouped serving
  kernels/  CUDA kernels (csrc/), their wrappers and plain versions, the
            wire encoders and the on-device USB deframe
  runtime/  the runners, the stream-axis split over devices, telemetry,
            the host wire encoder
  control/  the vendor-protocol device (VirtualDSPi) and its envelope
  io/       preset-slot, directory and bulk codecs, the preset store
  golden/   the sample-sequential golden model of the firmware
  native    ctypes binding of native/dspi_host.cpp: the host data plane,
            the firmware oracles and the scalar oracles
  configs   the headline device configuration and its serving mix
  serve, console   the entry points
  bench, bench_stages, graft_entry   the benchmark and graft twins
"""

from .core.constants import FilterType, Platform
from .params.types import (
    CrossfeedConfig,
    DeviceConfig,
    EqBand,
    LevellerConfig,
    LoudnessConfig,
    OutputChannel,
)

__version__ = "0.1.0"

__all__ = [
    "DeviceConfig", "EqBand", "CrossfeedConfig", "LevellerConfig",
    "LoudnessConfig", "OutputChannel", "FilterType", "Platform",
]
