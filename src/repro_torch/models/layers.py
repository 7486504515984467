"""Shared building blocks of the LM zoo: norms, RoPE, dense MLPs,
embeddings (port of ``repro.models.layers``). Same arithmetic, in the same
dtypes: norms and RoPE in fp32 inside, matmuls in the activation dtype."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.params import torch_dtype


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm with scale ``1 + weight``; weight=None gives the
    non-parametric form (OLMo-style). fp32 inside, out in x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * (1.0 + weight.to(torch.float32))
    return x.to(dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def softcap_(x, cap: float):
    """:func:`softcap` in place on an fp32 tensor (same operations, same
    order): the full-sequence logits are the prefill's largest tensor."""
    if cap:
        x.div_(cap).tanh_().mul_(cap)
    return x


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0
                            / head_dim))


@lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """:func:`rope_freqs` as a tensor on ``device``, copied there once (a
    captured round must not copy from the host)."""
    return torch.from_numpy(np.asarray(rope_freqs(head_dim, theta),
                                       np.float32)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., t, heads, head_dim); positions: (..., t) integer. Half-split
    rotation in fp32, out in x's dtype."""
    head_dim = x.shape[-1]
    freqs = _rope_freqs_on(head_dim, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., t, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., t, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense (SwiGLU) MLP
# ---------------------------------------------------------------------------

def init_mlp(ctx, d_model: int, d_ff: int):
    ctx.param("w_gate", (d_model, d_ff), ("embed", "mlp"))
    ctx.param("w_up", (d_model, d_ff), ("embed", "mlp"))
    ctx.param("w_down", (d_ff, d_model), ("mlp", "embed"))


def apply_mlp(p, x, prefix: str = ""):
    pre = prefix + "/" if prefix else ""
    h = F.silu(x @ p[f"{pre}w_gate"].to(x.dtype)) \
        * (x @ p[f"{pre}w_up"].to(x.dtype))
    return h @ p[f"{pre}w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def init_embed(ctx, cfg):
    ctx.param("embed/tok", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
              scale=1.0 / np.sqrt(cfg.d_model))
    if not cfg.tie_embeddings:
        ctx.param("lm_head/w", (cfg.d_model, cfg.vocab_size),
                  ("embed", "vocab"))


def embed_tokens(cfg, p, tokens):
    dt = torch_dtype(cfg.dtype)
    # a gather, as indexing; its backward, unlike indexing's accumulate on
    # the CPU, sums repeated tokens in a fixed order, so a training run
    # repeats bit for bit
    x = torch.nn.functional.embedding(tokens, p["embed/tok"]).to(dt)
    if cfg.tie_embeddings:
        # tied-head models (gemma) scale the embedding stream; the factor is
        # cast to the activation dtype before the multiply
        # (a fill on the device, not a host copy: a captured round runs it)
        x = x * torch.full((), float(np.sqrt(cfg.d_model)), dtype=dt,
                           device=x.device)
    return x


def lm_logits(cfg, p, x):
    """fp32 logits: the matmul in the activation dtype, then the softcap
    (in place, unless autograd needs its input for the backward)."""
    if cfg.tie_embeddings:
        logits = x @ p["embed/tok"].to(x.dtype).T
    else:
        logits = x @ p["lm_head/w"].to(x.dtype)
    out = logits.to(torch.float32)
    del logits
    if out.requires_grad:
        return softcap(out, cfg.logit_softcap)
    return softcap_(out, cfg.logit_softcap)
