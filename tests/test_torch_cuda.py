"""Tests of the port that need an NVIDIA card; they skip elsewhere.

This file imports neither JAX nor the JAX package, so it runs on a card
host that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dspi_tpu_torch.kernels import LAUNCHES, pdm_cuda
from dspi_tpu_torch.kernels.pdm import pdm_words_plain


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(96, 197), (5, 1), (48, 64)])
def test_pdm_kernel_equals_plain(T, B):
    """The CUDA kernel against the plain version: ragged stream counts,
    every machine mode, state rows word for word."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    rng = np.random.default_rng(33 + B)
    x = rng.integers(-(1 << 28), 1 << 28, size=(T, B)).astype(np.int32)
    s = np.zeros((16, B), np.int32)
    s[0:7] = rng.integers(-9000, 9000, size=(7, B))
    s[7] = rng.integers(-2**31, 2**31, size=B, dtype=np.int64)
    s[8] = rng.integers(0, 1025, size=B)          # fade position <= 1024
    # machine rows as the segment-start reactions leave them: enabled
    # streams run with no fade-out pending; disabled ones are fading out
    # (fout >= 1) or stopped (fout == 0)
    s[9] = rng.integers(0, 2, size=B)
    s[10] = np.where(s[9] == 1, 1, rng.integers(0, 2, size=B))
    s[11] = np.where((s[9] == 0) & (s[10] == 1),
                     rng.integers(1, 1025, size=B), 0)
    s[12] = rng.integers(-29500, 29500, size=B)
    s[13:] = rng.integers(-5, 5, size=(3, B))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    want_w, want_s = pdm_words_plain(xt, st)
    n0 = LAUNCHES["pdm"]
    got_w, got_s = pdm_cuda.pdm_words(xt.cuda(), st.cuda())
    torch.cuda.synchronize()
    assert LAUNCHES["pdm"] == n0 + 1
    np.testing.assert_array_equal(got_w.cpu().numpy(), want_w.numpy())
    np.testing.assert_array_equal(got_s.cpu().numpy(), want_s.numpy())
