"""Mixture-of-Experts layer: top-k router + grouped-product experts (port
of ``repro.models.moe``).

Two implementations:
  * 'ragged' — tokens sorted by expert (a stable sort), then a grouped
    product: each expert's rows times that expert's weights, in the
    compute dtype. Only the experts that receive a token are cast and
    multiplied (the reference casts every expert tensor whole; the values
    are the same). The group sizes are read on the host, so a round that
    routes tokens cannot be captured in a CUDA graph (``launch/train.py``
    refuses ``--scan-chunk`` for MoE archs; a grouped GEMM that takes
    device offsets is ROADMAP Queue 2 work).
  * 'dense'  — capacity-based one-hot dispatch/combine einsums (GShard);
    tokens over an expert's capacity are dropped, as in the reference.

Shared experts (DeepSeek/Llama4) are plain dense MLPs added to the output.
The router's aux load-balance loss is returned to the caller and added to
each client's local objective by ``models.model.lm_loss``.

The reference's shard_map variant ('ragged_shmap', ``set_moe_mesh``) has
only a dry-run caller and raises here (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, init_mlp

SHMAP_NOT_PORTED = ("the shard_map MoE ('ragged_shmap', set_moe_mesh) is "
                    "not ported yet (ROADMAP Queue 1 item 14)")


def set_moe_mesh(mesh):
    """The reference's launcher hook for 'ragged_shmap': not ported."""
    raise NotImplementedError(SHMAP_NOT_PORTED)


def init_moe(ctx, cfg):
    m = cfg.moe
    d = cfg.d_model
    ctx.param("router", (d, m.n_experts), ("embed", "experts"), scale=0.02)
    ctx.param("w_gate", (m.n_experts, d, m.d_ff_expert),
              ("experts", "embed", "expert_mlp"))
    ctx.param("w_up", (m.n_experts, d, m.d_ff_expert),
              ("experts", "embed", "expert_mlp"))
    ctx.param("w_down", (m.n_experts, m.d_ff_expert, d),
              ("experts", "expert_mlp", "embed"))
    if m.n_shared:
        ff = m.d_ff_shared or m.d_ff_expert * m.n_shared
        init_mlp(ctx.sub("shared"), d, ff)


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``lax.top_k``'s order): a stable
    descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg, p, x, pre):
    """x: (T, d) -> (weights (T, k) in x's dtype, idx (T, k), aux_loss)."""
    m = cfg.moe
    logits = (x @ p[f"{pre}router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k(probs, m.top_k)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    density = torch.mean(probs, dim=0)                          # (E,)
    one_hot = F.one_hot(idx, m.n_experts).to(torch.float32)     # (T, k, E)
    frac = torch.mean(torch.sum(one_hot, dim=1), dim=0)         # (E,)
    aux = m.n_experts * torch.sum(frac * density) * m.router_aux_coef
    return weights.to(x.dtype), idx, aux


def _moe_ragged(cfg, p, x, weights, idx, pre):
    m = cfg.moe
    T, d = x.shape
    k = m.top_k
    flat_idx = idx.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_idx, stable=True)
    inv = torch.argsort(order, stable=True)
    xs = torch.repeat_interleave(x, k, dim=0)[order]            # sorted
    sizes = torch.bincount(flat_idx, minlength=m.n_experts).tolist()
    # each stacked weight unbound once, so that under autograd its
    # gradient is assembled once, not zero-filled for every expert
    wg, wu, wd = (p[f"{pre}{n}"].unbind(0)
                  for n in ("w_gate", "w_up", "w_down"))
    parts, off = [], 0
    for e, n in enumerate(sizes):
        if not n:
            continue
        xe = xs[off:off + n]
        h = (F.silu(xe @ wg[e].to(x.dtype)) * (xe @ wu[e].to(x.dtype)))
        parts.append(h @ wd[e].to(x.dtype))
        off += n
    y = torch.cat(parts)[inv].reshape(T, k, d)
    return torch.sum(y * weights[..., None], dim=1)


def _moe_dense(cfg, p, x, weights, idx, pre):
    """Capacity-based dispatch/combine (GShard). Exact when capacity covers
    all routed tokens; tokens over capacity are dropped (standard)."""
    m = cfg.moe
    T, d = x.shape
    f32 = torch.float32
    cap = max(1, int(m.capacity_factor * T * m.top_k / m.n_experts))
    one_hot = F.one_hot(idx, m.n_experts).to(f32)               # (T, k, E)
    pos = torch.cumsum(one_hot, dim=0) * one_hot - 1.0          # slot ids
    keep = ((pos < cap) & (one_hot > 0)).to(f32)
    # one-hot of the slot: none for -1 (not routed) or past the capacity
    pos_oh = (pos.to(torch.int64)[..., None]
              == torch.arange(cap, device=x.device)).to(f32)    # (T,k,E,c)
    dispatch = torch.einsum("tke,tkec->tec", one_hot * keep, pos_oh)
    combine = torch.einsum("tke,tkec->tec",
                           weights.to(f32)[..., None] * one_hot * keep,
                           pos_oh)
    xe = torch.einsum("td,tec->ecd", x.to(f32), dispatch).to(x.dtype)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe,
                             p[f"{pre}w_gate"].to(x.dtype)))
         * torch.einsum("ecd,edf->ecf", xe, p[f"{pre}w_up"].to(x.dtype)))
    y = torch.einsum("ecf,efd->ecd", h, p[f"{pre}w_down"].to(x.dtype))
    out = torch.einsum("ecd,tec->td", y.to(f32), combine)
    return out.to(x.dtype)


def apply_moe(cfg, p, x, prefix: str = ""):
    """x: (b, t, d) -> (out, aux_loss)."""
    pre = prefix + "/" if prefix else ""
    m = cfg.moe
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    weights, idx, aux = _router(cfg, p, xf, pre)
    if m.impl == "ragged":
        out = _moe_ragged(cfg, p, xf, weights, idx, pre)
    elif m.impl == "dense":
        out = _moe_dense(cfg, p, xf, weights, idx, pre)
    elif m.impl == "ragged_shmap":
        raise NotImplementedError(SHMAP_NOT_PORTED)
    else:
        raise ValueError(f"unknown MoE impl {m.impl!r}")
    if m.n_shared:
        out = out + apply_mlp(p, xf, prefix=(prefix + "/shared" if prefix
                                             else "shared"))
    return out.reshape(b, t, d), aux
