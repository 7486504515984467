"""The cluster kernel behind ``hadamard_blocks`` (``csrc/hadamard.cu``,
``hadamard_cluster_kernel<C, T>``), emulated on the CPU.

The kernel is ``fused_rotate``'s cluster butterfly without signs: a block
of b = rc coordinates split across a cluster of C CTAs (C from
``hadamard.launch_geometry``), 8 coordinates a thread, bf16 input widened
exactly to fp32 as it is loaded, the scale applied last with one fp32
multiply. ``emulate_fwht`` of ``test_torch_exchange_cluster.py`` moves the
values as the kernel does, so the emulation must be ``torch.equal`` to
``hadamard_plain`` at every cluster size the kernel takes. Against the
reference's ``hadamard_blocks`` (two matmuls, another rounding) it is held
within 1e-5·max|out|, the tolerance of ``test_torch_kernel_ops.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_exchange_cluster import VALS, WARP, emulate_fwht
from test_torch_harness import gauss, npy, tt
from repro.kernels.hadamard import hadamard_blocks as ref_hadamard
from repro_torch.kernels import exchange as kx
from repro_torch.kernels import hadamard as hd

ROT_TOL = 1e-5          # max |Δ| / max |out|
MAX_CHUNK = 8192        # kMaxHadamardChunk: 1,024 threads of 8


def emulate_hadamard(x_blocks, cluster=None):
    """hadamard_blocks as the cluster kernel computes it."""
    n, r, c = x_blocks.shape
    cluster = cluster or hd.launch_geometry(n, r, c)["cluster"]
    x = x_blocks.to(torch.float32).reshape(n, r * c)
    y = emulate_fwht(x, cluster) * kx._scale(r * c)
    return y.reshape(n, r, c)


def kernel_takes(b, cluster):
    """The cluster sizes hadamard_cluster_ok admits for a b-block."""
    n = b // cluster
    return n <= MAX_CHUNK and (cluster == 1 or n >= VALS * WARP)


# the reference's test shapes, the largest block (C = 8, chunks of 4,096),
# blocks under 8 coordinates and a block of one row
SHAPES = [(1, 128, 128), (3, 128, 128), (4, 64, 64), (2, 128, 64),
          (7, 16, 16), (4, 256, 128), (5, 2, 2), (3, 1, 4), (2, 1, 1),
          (2, 1, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,c", SHAPES)
def test_emulated_hadamard_is_the_plain_version(n, r, c, dtype):
    x = tt(gauss(n * r + c, (n, r, c))).to(dtype)
    out = emulate_hadamard(x)
    assert out.dtype == torch.float32
    assert torch.equal(out, hd.hadamard_plain(x))
    b = r * c
    for cl in (1, 2, 4, 8):     # every cluster size gives the same bits
        if b % cl == 0 and kernel_takes(b, cl):
            assert torch.equal(emulate_hadamard(x, cl), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,c", SHAPES[:7])
def test_emulated_hadamard_matches_reference(n, r, c, dtype):
    x = gauss(n * r + c + 1, (n, r, c))
    x_port = tt(x).to(dtype)
    x_ref = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                  else jnp.float32)
    want = np.asarray(ref_hadamard(x_ref))
    out = npy(emulate_hadamard(x_port))
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= ROT_TOL * np.abs(want).max()


def test_hadamard_cluster_sizes_the_wrapper_picks():
    """b / 2,048 CTAs a block, at most 8, whatever the split into rows."""
    picks = {(r, c): hd.launch_geometry(2048, r, c)
             for r, c in ((2, 2), (32, 32), (32, 64), (64, 64), (128, 128),
                          (1, 16_384), (256, 128))}
    assert {k: g["cluster"] for k, g in picks.items()} == {
        (2, 2): 1, (32, 32): 1, (32, 64): 1, (64, 64): 2, (128, 128): 8,
        (1, 16_384): 8, (256, 128): 8}
    assert picks[(128, 128)] == {"cluster": 8, "ctas": 16_384,
                                 "threads": 256, "chunk": 2048}
    assert picks[(256, 128)]["chunk"] == 4096
    assert picks[(2, 2)]["threads"] == 32
    for (r, c), g in picks.items():
        assert kernel_takes(r * c, g["cluster"])
