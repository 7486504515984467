"""The kernels' public API (port of ``repro.kernels.ops``).

On CUDA tensors every function here launches a hand-written kernel of
``csrc/``; on CPU tensors it runs that kernel's plain PyTorch version.
``rotate_blocks`` is the counterpart of the reference's ``rotate_pallas``:
a drop-in for :func:`repro_torch.compression.rotation.rotate` with the
Hadamard core on :func:`hadamard_blocks`.
"""
from __future__ import annotations

import torch

from repro_torch.compression.rotation import (DEFAULT_BLOCK, _block_size,
                                              _factor, pad_len)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.hadamard import hadamard_blocks
from repro_torch.kernels.lattice_quant import (lattice_decode,  # noqa: F401
                                               lattice_encode)


def rotate_blocks(x, signs, block: int = DEFAULT_BLOCK,
                  inverse: bool = False):
    """Randomized Hadamard rotation of a flat (d,) vector with the Hadamard
    core on the kernel: the port of ``repro.kernels.ops.rotate_pallas``.

    ``signs`` is the (pad_len(d, block),) ±1 diagonal (the reference draws
    it from its key inside; the port takes randomness as an input).
    forward:  y = (H x*s) / sqrt(b)   (per block)
    inverse:  x = (H y) / sqrt(b) * s
    Returns the padded length; the caller keeps the first d.
    """
    d = x.shape[0]
    b = _block_size(d, block)
    padded = pad_len(d, block)
    if tuple(signs.shape) != (padded,):
        raise ValueError(f"signs: expected ({padded},), got "
                         f"{tuple(signs.shape)}")
    x = torch.nn.functional.pad(x.to(torch.float32), (0, padded - d))
    r, c = _factor(b)
    if not inverse:
        x = x * signs
    y = hadamard_blocks(x.reshape(-1, r, c)).reshape(-1)
    return y * signs if inverse else y
