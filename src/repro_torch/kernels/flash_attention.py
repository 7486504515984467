"""Causal GQA flash attention: two CUDA kernels and their plain version
(port of ``repro.kernels.flash_attention``).

``flash_attention`` launches a kernel on CUDA tensors, on PyTorch's current
stream, chosen by dtype alone: bf16 takes the tensor-core kernel of
``csrc/flash_wgmma.cu`` (wgmma, TMA, mbarriers), fp32 the CUDA-core kernel
of ``csrc/flash_attention.cu``. Neither falls back to the other or to the
plain version: a kernel that fails to build or launch raises. On CPU tensors
it runs :func:`flash_attention_plain`, the math of the reference's
``repro.kernels.ref.flash_attention_ref``; it raises on anything else. Both
kernels count in :data:`LAUNCHES`. There is no backward kernel, as in the
reference, so a CUDA input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# head dims the kernel is instantiated for: the reduced configs (16, 32),
# llama3.2-1b (64), olmo-1b (128) and gemma2-2b (256)
HEAD_DIMS = (16, 32, 64, 128, 256)

# Launches since the last reset_launches(); the wrapper adds one where it
# launches the kernel and nowhere else.
LAUNCHES = {"flash_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, o, b, tq, tk, h, kv, dh, scale, softcap, causal, window, stream)
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]
# dtype -> (source under csrc/, C entry point)
_KERNELS = {torch.float32: ("flash_attention", "flash_attention_f32_fwd"),
            torch.bfloat16: ("flash_wgmma", "flash_attention_bf16_fwd")}
TMA_ALIGN = 16    # bytes: a TMA tensor map's base address


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library(dtype=torch.float32):
    """The built and loaded library of ``dtype``'s kernel:
    ``csrc/flash_attention.cu`` for fp32, ``csrc/flash_wgmma.cu`` for
    bf16."""
    name, fn = _KERNELS[dtype]
    return build.load(name, {fn: _ARGS})


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0):
    """q: (b, tq, h, dh); k, v: (b, tk, kv, dh). GQA by head grouping; fp32
    inside, out in q's dtype."""
    b, tq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, dh).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
    scores = scores / float(np.sqrt(dh))
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    tk = k.shape[1]
    qpos = torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.to(torch.float32))
    return out.reshape(b, tq, h, dh).to(q.dtype)


def visible_pairs(tq: int, tk: int, causal: bool = True,
                  window: int = 0) -> int:
    """(query, key) pairs the mask lets through: query i sees key j when
    j <= i (causal) and j > i - window (a window)."""
    i = np.arange(tq, dtype=np.int64)
    hi = np.minimum(i, tk - 1) if causal else np.full(tq, tk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(q, k, v, *, causal: bool = True, window: int = 0,
                softcap: float = 0.0) -> float:
    """The kernel's matmul work: 4·dh flops per visible (query, key) pair
    and head (q kᵀ and p v, two each)."""
    b, tq, h, dh = q.shape
    return 4.0 * dh * b * h * visible_pairs(tq, k.shape[1], causal, window)


def _check_inputs(q, k, v, window, aligned=True):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: expected {q.dtype} like q, got "
                            f"{t.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"expected q (b, tq, h, dh) and k, v (b, tk, kv, "
                         f"dh); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (h % kv must be 0)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not taken by the kernel; it takes "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the kernel has no "
                             f"backward")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.dtype == torch.bfloat16 and aligned:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % TMA_ALIGN:
                raise ValueError(
                    f"{name}: base address not {TMA_ALIGN}-byte aligned (a "
                    f"view with an offset?); the bf16 kernel's TMA loads "
                    f"need it")


@build.costed(flash_flops)
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Causal GQA attention with an online softmax, optional sliding
    window and logit softcap. q: (b, tq, h, dh); k, v: (b, tk, kv, dh) with
    h % kv == 0; query head i reads kv head i // (h // kv). Out in q's
    dtype.

    Replaces ``repro/kernels/flash_attention.py`` · ``flash_attention``
    (``_flash_kernel``, grid (b·h, tq/128, tk/128) over VMEM tiles). Bound
    on the H100 at the serve shapes: operations, 4·dh flops per visible
    query-key pair (0.352 ms of bf16 tensor-core work at b=4, t=4,608, h=8,
    dh=256). Design for bf16 (``csrc/flash_wgmma.cu``): one CTA per
    (b·h, 128-query tile), longest tiles first; a producer warpgroup
    streams 64-key K/V tiles by TMA through a 2-stage mbarrier ring; two
    consumer warpgroups run S = Q Kᵀ and O += P V on wgmma (P rounded to
    bf16 in registers, the denominator summed from that rounded P), the
    softmax on the accumulators in registers; the tensor maps are encoded
    on the host for each call. fp32 (``csrc/flash_attention.cu``): one
    CTA per (b·h, 64-query tile) walks the kv tiles of its causal/window
    band with fp32 FMAs on the CUDA cores, exact to the reference's 2e-5.
    """
    if build.on_meta(q, k, v):
        _check_inputs(q, k, v, window, aligned=False)
        return torch.empty_like(q)
    if build.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    _check_inputs(q, k, v, window)
    b, tq, h, dh = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _KERNELS[q.dtype][1]
    LAUNCHES["flash_attention"] += 1
    build.check(getattr(library(q.dtype), fn)(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b, tq, tk,
        h, kvh, dh, float(np.float32(1.0 / np.sqrt(dh))), float(softcap),
        int(causal), int(window), build.stream()), fn)
    return out
