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


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's arithmetic (csrc/flash_wgmma.cu), emulated
# ---------------------------------------------------------------------------

# the card's bf16 gates in chip_smoke.py: max |Δ| ≤ 3e-2; per row of dh
# outputs max |Δ| ≤ 2^-7·max|want_row| + 1e-3; ‖Δ‖ ≤ 1e-2·‖want‖
ROW_TOL, REL_TOL = (2.0 ** -7, 1e-3), 1e-2
EMU_BQ, EMU_BK = 128, 64      # the kernel's query and key tiles


def _emulate_wgmma_kernel(q, k, v, *, window=0, softcap=0.0, round_p=True):
    """What the bf16 kernel computes, step by step: one 128-query tile at a
    time walks the 64-key tiles of its causal/window band (every tile when
    one of its rows sees no key: qi >= tk + window - 1); scores in fp32
    (products of bf16 values are exact), scale, softcap, -1e30 for masked
    entries and -inf for keys past tk; online max and sum in fp32 from
    m = -1e30; P rounded to bf16 before P V, the denominator summed from
    that rounded P; floored at 1e-30; output rounded to bf16. q: (b, tq, h,
    dh), k, v: (b, tk, kv, dh) bf16 tensors. ``round_p=False`` keeps P in
    fp32."""
    b, tq, h, dh = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    qf = q.float().reshape(b, tq, kvh, g, dh)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, tq, kvh, g, dh))
    for q0 in range(0, tq, EMU_BQ):
        q1 = min(q0 + EMU_BQ, tq)
        rows = torch.arange(q0, q1)[:, None]
        walk_all = window > 0 and q1 - 1 >= tk + window - 1
        k_begin = max(0, q0 - window + 1) if window and not walk_all else 0
        k_end = tk if walk_all else min(tk, q1)
        m = torch.full((b, kvh, g, q1 - q0), -1e30)
        den = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, q1 - q0, dh))
        for k0 in range(k_begin // EMU_BK * EMU_BK, k_end, EMU_BK):
            k1 = min(k0 + EMU_BK, tk)
            keys = torch.arange(k0, k0 + EMU_BK)[None, :]
            s = torch.einsum("btkgd,bskd->bkgts", qf[:, q0:q1],
                             kf[:, k0:k1]) * scale
            s = torch.nn.functional.pad(s, (0, k0 + EMU_BK - k1))
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            keep = rows >= keys
            if window:
                keep &= keys > rows - window
            s = torch.where(keep, s, -1e30)
            s = torch.where(keys < tk, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            if round_p:
                p = p.to(torch.bfloat16).float()
            den = alpha * den + p.sum(-1)
            vt = torch.nn.functional.pad(vf[:, k0:k1],
                                         (0, 0, 0, 0, 0, k0 + EMU_BK - k1))
            acc = alpha[..., None] * acc + torch.einsum("bkgts,bskd->bkgtd",
                                                        p, vt)
            m = m_new
        o = acc / torch.clamp(den, min=1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(b, tq, h, dh).to(torch.bfloat16)


def _gate_stats(got, want):
    err = np.abs(got - want)
    rel, floor = ROW_TOL
    row_excess = err.max(-1) - (rel * np.abs(want).max(-1) + floor)
    return (float(err.max()), float(row_excess.max()),
            float(np.linalg.norm(err) / np.linalg.norm(want)))


@pytest.mark.parametrize("b,t,h,kv,dh,window,cap", [
    (1, 512, 8, 4, 256, 0, 50.0),      # gemma2-2b global, cut in length
    (1, 512, 8, 4, 256, 160, 50.0),    # a window that binds, mid-tile edge
    (2, 256, 8, 1, 256, 0, 50.0),      # MQA
    (1, 320, 4, 2, 256, 100, 50.0),    # ragged q tile, window
    (1, 256, 8, 4, 64, 0, 0.0)])       # llama-like heads, no softcap
def test_wgmma_arithmetic_meets_the_card_gates(b, t, h, kv, dh, window,
                                                cap):
    """bf16 P (the one rounding the tensor-core kernel adds) keeps the
    output within the card's three bf16 gates of the JAX reference."""
    q, k, v = _qkv(b, t, h, kv, dh, seed=21)
    qb, kb, vb = (tt(a, torch.bfloat16) for a in (q, k, v))
    got = npy(_emulate_wgmma_kernel(qb, kb, vb, window=window,
                                    softcap=cap).float())
    want = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(npy(x.float())).astype(jnp.bfloat16)
          for x in (qb, kb, vb)), window=window, softcap=cap), np.float32)
    max_err, row_excess, rel = _gate_stats(got, want)
    assert max_err <= BF16_TOL and row_excess <= 0.0 and rel <= REL_TOL, \
        (max_err, row_excess, rel)


def test_wgmma_arithmetic_rows_that_see_no_key():
    """tq > tk + window - 1: rows 191-255 see no key, and the reference
    gives each the mean of V over all tk keys. The kernel's CTA holding them
    walks every kv tile, which the emulation follows; the other rows keep
    their band."""
    b, tq, tk, h, kv, dh, window = 1, 256, 128, 2, 1, 32, 64
    q = gauss(31, (b, tq, h, dh))
    k, v = gauss(32, (b, tk, kv, dh)), gauss(33, (b, tk, kv, dh))
    qb, kb, vb = (tt(a, torch.bfloat16) for a in (q, k, v))
    got = npy(_emulate_wgmma_kernel(qb, kb, vb, window=window).float())
    want = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(npy(x.float())).astype(jnp.bfloat16)
          for x in (qb, kb, vb)), window=window), np.float32)
    max_err, row_excess, rel = _gate_stats(got, want)
    assert max_err <= BF16_TOL and row_excess <= 0.0 and rel <= REL_TOL, \
        (max_err, row_excess, rel)
    # the empty rows are the mean of V, not 0
    mean_v = npy(vb.float()).mean(axis=1)[:, None]
    np.testing.assert_allclose(got[:, tk + window - 1:], np.broadcast_to(
        mean_v, got[:, tk + window - 1:].shape), atol=BF16_TOL, rtol=0)


def test_wgmma_emulation_is_the_plain_version_but_for_bf16_p():
    """With P kept in fp32 the emulation's online softmax over 64-key tiles
    is the plain version up to fp32 summation order: the tiling, masks and
    -1e30/-inf fills add no error of their own."""
    q, k, v = (tt(a, torch.bfloat16) for a in _qkv(1, 320, 4, 2, 64, 23))
    emu = _emulate_wgmma_kernel(q, k, v, window=100, softcap=30.0,
                                round_p=False).float()
    plain = fa.flash_attention_plain(q, k, v, window=100,
                                     softcap=30.0).float()
    # one bf16 ulp of each output at most: both round an fp32 result
    ulp = 2.0 ** -7 * plain.abs().clamp(min=2.0 ** -126)
    assert bool(((emu - plain).abs() <= ulp).all())
