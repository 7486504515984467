"""The port's ``flash_attention`` (on the CPU: ``flash_attention_plain``)
against the reference's Pallas ``flash_attention`` in interpret mode and its
``flash_attention_ref`` oracle.

The sweep is the reference's own (``tests/test_kernels.py``'s flash
sweep) plus bf16 inputs. Inputs are unit normals from numpy seeds.
Tolerances are the reference's: fp32 max |Δ| ≤ 2e-5 (the sums run in
another order), bf16 ≤ 3e-2 (both sides round an fp32 result to bf16; one
bf16 ulp near |o| ≈ 1 is 2^-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import gauss, npy, tt
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import flash_attention as fa

SWEEP = [(2, 256, 4, 2, 64, 0, 0.0),      # GQA causal
         (1, 512, 8, 8, 32, 0, 0.0),      # MHA long
         (1, 256, 8, 2, 64, 128, 0.0),    # sliding window
         (2, 128, 4, 1, 64, 0, 50.0),     # MQA + softcap (gemma)
         (1, 256, 4, 2, 128, 64, 30.0)]   # window + softcap
FP32_TOL, BF16_TOL = 2e-5, 3e-2


def _qkv(b, t, h, kv, dh, seed):
    return (gauss(seed, (b, t, h, dh)), gauss(seed + 1, (b, t, kv, dh)),
            gauss(seed + 2, (b, t, kv, dh)))


def _port(q, k, v, dtype=torch.float32, **kw):
    return fa.flash_attention(tt(q, dtype), tt(k, dtype), tt(v, dtype), **kw)


@pytest.mark.parametrize("b,t,h,kv,dh,window,cap", SWEEP)
def test_flash_matches_reference_fp32(b, t, h, kv, dh, window, cap):
    q, k, v = _qkv(b, t, h, kv, dh, seed=4)
    out = npy(_port(q, k, v, causal=True, window=window, softcap=cap))
    want_ref = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       softcap=cap)
    want_kernel = ref_flash(q, k, v, causal=True, window=window, softcap=cap,
                            block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(out, np.asarray(want_ref), atol=FP32_TOL,
                               rtol=0)
    np.testing.assert_allclose(out, np.asarray(want_kernel), atol=FP32_TOL,
                               rtol=0)


@pytest.mark.parametrize("b,t,h,kv,dh,window,cap",
                         [(1, 128, 4, 2, 64, 0, 0.0),
                          (1, 256, 8, 4, 32, 64, 50.0)])
def test_flash_matches_reference_bf16(b, t, h, kv, dh, window, cap):
    q, k, v = _qkv(b, t, h, kv, dh, seed=5)
    out = _port(q, k, v, torch.bfloat16, window=window, softcap=cap)
    assert out.dtype == torch.bfloat16
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want_ref = ref.flash_attention_ref(qb, kb, vb, window=window,
                                       softcap=cap)
    want_kernel = ref_flash(qb, kb, vb, window=window, softcap=cap,
                            block_q=64, block_k=64, interpret=True)
    got = npy(out.float())
    np.testing.assert_allclose(got, np.asarray(want_ref, np.float32),
                               atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_kernel, np.float32),
                               atol=BF16_TOL, rtol=0)


def test_flash_masked_rows_and_uneven_lengths():
    """tq != tk, a window narrower than a tile, and a query length that is
    not a tile multiple: the -1e30 mask fill and the causal index of the
    reference's oracle."""
    q = gauss(7, (2, 96, 4, 32))
    k, v = gauss(8, (2, 160, 2, 32)), gauss(9, (2, 160, 2, 32))
    for window in (0, 5):
        out = npy(_port(q, k, v, window=window, softcap=20.0))
        want = ref.flash_attention_ref(q, k, v, window=window, softcap=20.0)
        np.testing.assert_allclose(out, np.asarray(want), atol=FP32_TOL,
                                   rtol=0)


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    q, k, v = (tt(a) for a in _qkv(1, 128, 4, 2, 16, seed=11))
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, window=32, softcap=10.0)
    want = fa.flash_attention_plain(q, k, v, window=32, softcap=10.0)
    assert torch.equal(out, want)
    assert fa.LAUNCHES == {"flash_attention": 0}
