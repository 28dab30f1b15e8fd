"""dspi_tpu_torch — the DSPi chain in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``dspi_tpu`` (which stays the reference) to
PyTorch on an NVIDIA H100.  It imports nothing of JAX or of ``dspi_tpu``:
the plain-Python modules it needs are its own copies.

This slice runs the RP2350 float chain at 48/96 kHz on the block-matmul
lowering, with the delta-sigma PDM modulator as a hand-written CUDA kernel.

Layout:
  core/     numerics substrate (constants, exact Q28/Q15 and float math)
  params/   control-plane model + coefficient design (NumPy)
  chain/    pack + the batched pipeline + the Engine
  kernels/  CUDA kernels (csrc/), their wrappers and plain versions
  configs   the headline device configuration
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
