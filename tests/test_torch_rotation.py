"""Rotation geometry: the port's Hadamard blocks and padding against
``repro.compression.rotation``."""
import numpy as np
import pytest
import torch

import test_torch_harness  # noqa: F401  (jax.core alias before repro)
from repro.compression import rotation as ref
from repro_torch.compression import rotation as port


@pytest.mark.parametrize("n", [1, 2, 4, 64, 128])
def test_hadamard_matrix_matches_reference(n):
    np.testing.assert_array_equal(port.hadamard_matrix(n),
                                  ref.hadamard_matrix(n))


@pytest.mark.parametrize("block", [16_384, 8192, 4096, 1024])
def test_block_geometry_matches_reference(block):
    # includes quickstart's d=2762 (b=4096) and odd log2(b) (r != c)
    for d in (1, 7, 100, 2762, 4096, 4097, 8192, 25_450, 100_000):
        assert port.DEFAULT_BLOCK == ref.DEFAULT_BLOCK
        assert port._block_size(d, block) == ref._block_size(d, block)
        assert port.pad_len(d, block) == ref.pad_len(d, block)
        b = port._block_size(d, block)
        assert port._factor(b) == ref._factor(b)


def test_small_vector_blocks():
    assert port._block_size(2762, port.DEFAULT_BLOCK) == 4096
    assert port._factor(4096) == (64, 64)
    assert port._factor(8192) == (128, 64)
    assert port.pad_len(25_450) == 32_768


def test_signs_are_rademacher():
    g = torch.Generator()
    g.manual_seed(0)
    s = port.signs(g, 10_000)
    assert s.dtype == torch.float32 and s.shape == (10_000,)
    assert set(torch.unique(s).tolist()) == {-1.0, 1.0}
    assert abs(float(s.mean())) < 0.05
