"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) (port of
``repro.models.mla``).

Prefill uses the expanded (naive) form with query chunking. Decode uses the
ABSORBED form: W_UK is folded into the query and W_UV into the output, so
each step attends directly over the compressed (kv_lora + rope) cache.
MLA never reaches the flash kernel: its qk dim is not its v dim.

The cache (``c_kv`` (b, s, kv_lora), ``k_rope`` (b, s, rope)) is written
in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.params import torch_dtype

NEG_INF = -1e30


def init_mla(ctx, cfg):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    ctx.param("wq_a", (d, m.q_lora_rank), ("embed", "lora"))
    ctx.param("q_norm/scale", (m.q_lora_rank,), (None,), init="zeros")
    ctx.param("wq_b", (m.q_lora_rank, h * qd), ("lora", "q_flat"))
    ctx.param("wkv_a", (d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "lora"))
    ctx.param("kv_norm/scale", (m.kv_lora_rank,), (None,), init="zeros")
    ctx.param("wkv_b", (m.kv_lora_rank, h * (m.qk_nope_dim + m.v_head_dim)),
              ("lora", "q_flat"))
    ctx.param("wo", (h * m.v_head_dim, d), ("q_flat", "embed"))


def _project_q(cfg, p, x, positions, pre):
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    ql = rms_norm(x @ p[f"{pre}wq_a"].to(x.dtype), p[f"{pre}q_norm/scale"])
    q = (ql @ p[f"{pre}wq_b"].to(x.dtype)).reshape(b, t, h, qd)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(cfg, p, x, positions, pre):
    m = cfg.mla
    kv = x @ p[f"{pre}wkv_a"].to(x.dtype)
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], p[f"{pre}kv_norm/scale"])
    k_rope = kv[..., m.kv_lora_rank:]           # (b, t, rope_dim), head-shared
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _wkv_b(cfg, p, pre, dtype):
    m = cfg.mla
    return p[f"{pre}wkv_b"].to(dtype).reshape(
        m.kv_lora_rank, cfg.n_heads, m.qk_nope_dim + m.v_head_dim)


def _write(buf, new, start: int):
    """``lax.dynamic_update_slice_in_dim`` on axis 1, in place: the start
    clamped so that ``new`` fits."""
    start = max(0, min(start, buf.shape[1] - new.shape[1]))
    buf[:, start:start + new.shape[1]] = new.to(buf.dtype)


def mla_prefill(cfg, p, x, positions, prefix: str = "", cache=None,
                write_pos: int = 0):
    """Expanded-form causal MLA over the full sequence; writes the latent
    cache (in place) when given."""
    pre = prefix + "/" if prefix else ""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _project_q(cfg, p, x, positions, pre)
    c_kv, k_rope = _project_kv_latent(cfg, p, x, positions, pre)
    wkv_b = _wkv_b(cfg, p, pre, x.dtype)
    k_nope = torch.einsum("btk,khn->bthn", c_kv, wkv_b[..., :m.qk_nope_dim])
    v = torch.einsum("btk,khv->bthv", c_kv, wkv_b[..., m.qk_nope_dim:])
    scale = 1.0 / np.sqrt(m.qk_nope_dim + m.qk_rope_dim)

    cq = 1024 if (t % 1024 == 0 and t > 1024) else t
    kpos = torch.arange(t, device=x.device)
    outs = []
    for c0 in range(0, t, cq):
        qpos = c0 + torch.arange(cq, device=x.device)
        mask = qpos[:, None] >= kpos[None, :]
        outs.append(_mla_sdpa(q_nope[:, c0:c0 + cq], q_rope[:, c0:c0 + cq],
                              k_nope, k_rope, v, mask, scale))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    if cache is not None:
        s = cache["c_kv"].shape[1]
        if t >= s:
            cache["c_kv"].copy_(c_kv[:, t - s:])
            cache["k_rope"].copy_(k_rope[:, t - s:])
        else:
            _write(cache["c_kv"], c_kv, write_pos)
            _write(cache["k_rope"], k_rope, write_pos)
    return out.reshape(b, t, -1) @ p[f"{pre}wo"].to(x.dtype)


def _mla_sdpa(q_nope, q_rope, k_nope, k_rope, v, mask, scale):
    """Scores in fp32 from the nope and rope parts, softmax and the value
    sum in fp32; out in q's dtype."""
    f32 = torch.float32
    scores = (torch.einsum("bthn,bshn->bhts", q_nope.to(f32),
                           k_nope.to(f32))
              + torch.einsum("bthr,bsr->bhts", q_rope.to(f32),
                             k_rope.to(f32))) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshv->bthv", probs, v.to(f32))
    return out.to(q_nope.dtype)


def init_mla_cache(cfg, batch: int, max_seq: int, device):
    m = cfg.mla
    dt = torch_dtype(cfg.dtype)
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dt,
                                device=device),
            "k_rope": torch.zeros((batch, max_seq, m.qk_rope_dim), dtype=dt,
                                  device=device)}


def mla_cache_axes():
    return {"c_kv": ("batch", "kv_seq", "kv_lora"),
            "k_rope": ("batch", "kv_seq", None)}


def mla_decode(cfg, p, x, cur_pos: int, cache, prefix: str = ""):
    """Absorbed-form single-token decode over the compressed cache. x: (b,
    1, d). Writes the new token's latent into the cache (in place), then
    attends; returns the block's output."""
    pre = prefix + "/" if prefix else ""
    m = cfg.mla
    b = x.shape[0]
    f32 = torch.float32
    positions = torch.full((1,), cur_pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(cfg, p, x, positions, pre)    # (b, 1, h, *)
    c_new, r_new = _project_kv_latent(cfg, p, x, positions, pre)
    _write(cache["c_kv"], c_new, cur_pos)
    _write(cache["k_rope"], r_new, cur_pos)
    wkv_b = _wkv_b(cfg, p, pre, x.dtype)
    w_uk = wkv_b[..., :m.qk_nope_dim]            # (kv_lora, h, nope)
    w_uv = wkv_b[..., m.qk_nope_dim:]            # (kv_lora, h, v)
    # absorb W_UK into the query: q_c (b, 1, h, kv_lora)
    q_c = torch.einsum("bthn,khn->bthk", q_nope, w_uk)
    scale = 1.0 / np.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    c_kv = cache["c_kv"].to(f32)
    s = c_kv.shape[1]
    mask = torch.arange(s, device=x.device) <= cur_pos          # (s,)
    scores = (torch.einsum("bthk,bsk->bhts", q_c.to(f32), c_kv)
              + torch.einsum("bthr,bsr->bhts", q_rope.to(f32),
                             cache["k_rope"].to(f32))) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_c = torch.einsum("bhts,bsk->bthk", probs, c_kv)       # (b,1,h,kvl)
    out = torch.einsum("bthk,khv->bthv", out_c.to(x.dtype), w_uv)
    return out.reshape(b, 1, -1) @ p[f"{pre}wo"].to(x.dtype)
