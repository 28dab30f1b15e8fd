"""dspi_tpu_torch — the DSPi chain in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``dspi_tpu`` (which stays the reference) to
PyTorch on an NVIDIA H100.  It imports nothing of JAX or of ``dspi_tpu``:
the plain-Python modules it needs are its own copies.

It runs the RP2350 float chain on the block-matmul lowering and the
RP2040 Q28 chain, both at 44.1/48/96 kHz, with the device-side wire words
and grouped/hetero serving (``chain.GroupedEngine``,
``chain.HeteroServer``), on the Q28 chain also with per-stream
parameters, and the delta-sigma PDM modulator, the Q28 EQ cascades and the
Q28 crossfeed as hand-written CUDA kernels.

Layout:
  core/     numerics substrate (constants, exact Q28/Q15 and float math)
  params/   control-plane model + coefficient design (NumPy)
  chain/    pack + the batched pipeline + the Engine + grouped serving
  kernels/  CUDA kernels (csrc/), their wrappers and plain versions, and
            the wire encoders
  configs   the headline device configuration and its serving mix
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
