"""Blocked Hadamard transform: the CUDA kernel and its plain version (port
of ``repro.kernels.hadamard``).

``hadamard_blocks`` launches the kernel of ``csrc/hadamard.cu`` on a CUDA
tensor, on PyTorch's current stream; on a CPU tensor it runs
:func:`hadamard_plain`; it raises on anything else. It counts its launches
in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.exchange import _CHUNK, _MAX_CLUSTER, _fwht, _scale

# the largest block: 8 CTAs of 4,096 coordinates
MAX_BLOCK = 32_768

# Launches since the last reset_launches(); the wrapper adds one where it
# launches the kernel and nowhere else.
LAUNCHES = {"hadamard_blocks": 0}

_SIGNATURES = {"hadamard_blocks_fwd": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The built and loaded ``csrc/hadamard.cu``."""
    return build.load("hadamard", _SIGNATURES)


def _check(x_blocks):
    if x_blocks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_blocks: expected float32 or bfloat16, got "
                        f"{x_blocks.dtype}")
    if x_blocks.dim() != 3 or x_blocks.shape[0] < 1:
        raise ValueError(f"x_blocks: expected (n >= 1, r, c), got "
                         f"{tuple(x_blocks.shape)}")
    _, r, c = x_blocks.shape
    for name, v in (("r", r), ("c", c)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name}={v} is not a power of two")
    if r * c > MAX_BLOCK:
        raise ValueError(f"block {r}x{c} = {r * c} exceeds {MAX_BLOCK}, "
                         f"the most one cluster's shared memory holds")


def launch_geometry(n: int, r: int, c: int):
    """The grid of a ``hadamard_blocks`` launch on n (r, c) blocks: the
    cluster of CTAs that holds one block (b / 2,048 of them, at most 8; 1
    for b <= 2,048, as ``fused_rotate``'s; nothing is packed, so the rows
    do not bound it), CTAs, threads a CTA and coordinates a CTA."""
    b = r * c
    cluster = max(1, min(_MAX_CLUSTER, b // _CHUNK))
    chunk = b // cluster
    return {"cluster": cluster, "ctas": n * cluster,
            "threads": max(32, chunk // 8), "chunk": chunk}


def hadamard_plain(x_blocks):
    """(n, r, c) -> (H_r X H_c)/sqrt(rc) per block, fp32: the Sylvester
    H_rc on each contiguous block, as the kernel's butterfly stages."""
    n, r, c = x_blocks.shape
    y = _fwht(x_blocks.to(torch.float32).reshape(n, r * c)) * _scale(r * c)
    return y.reshape(n, r, c)


@build.costed(build.no_flops)
def hadamard_blocks(x_blocks):
    """x_blocks: (n, r, c) fp32 or bf16, r and c powers of two, rc <=
    32,768 -> (H_r X H_c)/sqrt(rc) per block, fp32. H is symmetric, so this
    is its own inverse-rotation core.

    Replaces ``repro/kernels/hadamard.py`` · ``hadamard_blocks``
    (``_hadamard_kernel``, two MXU matmuls per block). Bound on the H100:
    bytes, 8 per coordinate for fp32 input and 6 for bf16. Design:
    ``fused_rotate``'s cluster butterfly without signs, a cluster of
    :func:`launch_geometry`'s C CTAs a block (2,048 coordinates a CTA, 8 a
    thread), all log2(rc) radix-2 stages in exact fp32 (no TF32) in
    registers, across lanes, through shared memory and across the cluster;
    a thread reads its 8 bf16 inputs in one 16-byte load and widens them.
    """
    _check(x_blocks)
    if build.on_meta(x_blocks):
        return x_blocks.new_empty(x_blocks.shape, dtype=torch.float32)
    if build.on_cpu(x_blocks):
        return hadamard_plain(x_blocks)
    if not x_blocks.is_contiguous():
        raise ValueError("x_blocks must be contiguous")
    n, r, c = x_blocks.shape
    return _launch(x_blocks, launch_geometry(n, r, c)["cluster"])


def _launch(x_blocks, cluster: int):
    """The kernel on checked, contiguous CUDA input, each block across a
    cluster of ``cluster`` CTAs (1, 2, 4 or 8, at most 8,192 coordinates a
    CTA and, in a cluster, at least 256)."""
    n, r, c = x_blocks.shape
    out = torch.empty((n, r, c), dtype=torch.float32, device=x_blocks.device)
    LAUNCHES["hadamard_blocks"] += 1
    build.check(library().hadamard_blocks_fwd(
        build.ptr(x_blocks), build.ptr(out), n, r * c,
        int(x_blocks.dtype == torch.bfloat16), _scale(r * c), cluster,
        build.stream()), "hadamard_blocks_fwd")
    return out
