"""Randomized Hadamard rotation geometry (port of
``repro.compression.rotation``).

The flat vector is padded to a multiple of the block size b (a power of
two) and each block is multiplied by H_b D / sqrt(b), D a Rademacher
diagonal. H_b = H_r ⊗ H_c (b = r·c); acting on the row-major (r, c) view of
a block it is the Sylvester H_b on the contiguous b-vector, which is how the
CUDA kernels compute it (a radix-2 butterfly).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

DEFAULT_BLOCK = 16_384  # 128 x 128


@lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester construction; n must be a power of two."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"Hadamard order must be a power of two, got {n}")
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _factor(block: int):
    """(r, c) with r·c = block; r = 2c when log2(block) is odd."""
    k = int(np.log2(block))
    r = 1 << ((k + 1) // 2)
    c = 1 << (k // 2)
    if r * c != block:
        raise ValueError(f"block {block} is not a power of two")
    return r, c


def _block_size(d: int, block: int) -> int:
    """The Hadamard block: the least power of two >= min(d, block), so a
    small vector gets a small block (d=2762 -> 4096)."""
    b = 1
    while b < min(d, block):
        b <<= 1
    return b


def pad_len(d: int, block: int = DEFAULT_BLOCK) -> int:
    b = _block_size(d, block)
    return int(np.ceil(d / b)) * b


def signs(generator: torch.Generator, n: int) -> torch.Tensor:
    """Rademacher ±1 diagonal of length n, fp32, on the generator's
    device."""
    bits = torch.randint(0, 2, (n,), generator=generator,
                         device=generator.device)
    return (bits * 2 - 1).to(torch.float32)
