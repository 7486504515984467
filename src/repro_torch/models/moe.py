"""Mixture-of-Experts layer: top-k router + grouped-product experts (port
of ``repro.models.moe``).

Three implementations:
  * 'ragged' — tokens sorted by expert (a stable sort), then three grouped
    products (``kernels/grouped_mm.py``: a CUDA kernel each way, forward,
    dgrad and wgrad, on the card; a loop over the groups on the CPU),
    each expert's rows times that expert's weights, rounded to the compute
    dtype as they are read (the reference casts every expert tensor whole;
    the values are the same). The group offsets are built and read on the
    device, so a round that routes tokens captures in a CUDA graph
    (``--scan-chunk``) and a serve step reads nothing on the host. On
    ``meta`` the grouped product's cost depends on the shapes alone.
  * 'ragged_shmap' — 'ragged' on this rank's block of the expert-FFN
    dimension of the mesh set by :func:`set_moe_mesh` (``w_gate``/``w_up``
    cut on their last axis, ``w_down`` on its middle one, over 'model'),
    then ``mesh.psum`` of the down-projection's partial sums over 'model':
    the reference's shard_map variant. The mesh steps hand it the rank's
    blocks (the prefill and serve steps gather no expert leaf over
    'model'); given whole leaves it cuts the block itself (a contiguous
    copy, which the grouped product reads densely), and under
    autograd the block's gradient is gathered back over 'model' and the
    input's summed over it, so every model rank holds the whole gradient.
  * 'dense'  — capacity-based one-hot dispatch/combine einsums (GShard);
    tokens over an expert's capacity are dropped, as in the reference.

Shared experts (DeepSeek/Llama4) are plain dense MLPs added to the output.
The router's aux load-balance loss is returned to the caller and added to
each client's local objective by ``models.model.lm_loss``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_mm import grouped_mm
from repro_torch.models.layers import apply_mlp, init_mlp

_MOE_MESH = None  # set by the launcher or the mesh steps for 'ragged_shmap'


def set_moe_mesh(mesh):
    """Launcher hook: the mesh the shard_map MoE implementation runs on."""
    global _MOE_MESH
    _MOE_MESH = mesh


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


def one_hot(idx, n: int):
    """``F.one_hot(idx, n)`` as float32, by comparison with ``arange(n)``:
    the same values, and no host read (``F.one_hot`` checks the index range
    on the host everywhere but on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _router(cfg, p, x, pre):
    """x: (T, d) -> (weights (T, k) in x's dtype, idx (T, k), aux_loss)."""
    m = cfg.moe
    logits = (x @ p[f"{pre}router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k(probs, m.top_k)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    density = torch.mean(probs, dim=0)                          # (E,)
    frac = torch.mean(torch.sum(one_hot(idx, m.n_experts), dim=1),
                      dim=0)                                    # (E,)
    aux = m.n_experts * torch.sum(frac * density) * m.router_aux_coef
    return weights.to(x.dtype), idx, aux


def group_offsets(flat_idx, n_experts: int):
    """The groups' cumulative row ends (E,) int32 of the rows sorted by
    expert, on the rows' device: counts by ``scatter_add_`` (integer adds,
    exact in any order) and an int32 ``cumsum``. Nothing is read on the
    host (``bincount`` would be: its output length depends on the data)."""
    counts = torch.zeros(n_experts, dtype=torch.int32,
                         device=flat_idx.device)
    counts.scatter_add_(0, flat_idx, torch.ones_like(flat_idx,
                                                     dtype=torch.int32))
    return torch.cumsum(counts, 0, dtype=torch.int32)


def _moe_ragged(cfg, p, x, weights, idx, pre):
    m = cfg.moe
    T, d = x.shape
    k = m.top_k
    flat_idx = idx.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_idx, stable=True)
    inv = torch.argsort(order, stable=True)
    xs = x[order // k]                      # repeat(x, k)[order], sorted
    offs = group_offsets(flat_idx, m.n_experts)
    wg, wu, wd = (p[f"{pre}{n}"] for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(grouped_mm(xs, wg, offs)) * grouped_mm(xs, wu, offs)
    y = grouped_mm(h, wd, offs)[inv].reshape(T, k, d)
    return torch.sum(y * weights[..., None], dim=1)


def _moe_dense(cfg, p, x, weights, idx, pre):
    """Capacity-based dispatch/combine (GShard). Exact when capacity covers
    all routed tokens; tokens over capacity are dropped (standard)."""
    m = cfg.moe
    T, d = x.shape
    f32 = torch.float32
    cap = max(1, int(m.capacity_factor * T * m.top_k / m.n_experts))
    oh = one_hot(idx, m.n_experts)                              # (T, k, E)
    pos = torch.cumsum(oh, dim=0) * oh - 1.0                    # slot ids
    keep = ((pos < cap) & (oh > 0)).to(f32)
    # one-hot of the slot: none for -1 (not routed) or past the capacity
    pos_oh = (pos.to(torch.int64)[..., None]
              == torch.arange(cap, device=x.device)).to(f32)    # (T,k,E,c)
    dispatch = torch.einsum("tke,tkec->tec", oh * keep, pos_oh)
    combine = torch.einsum("tke,tkec->tec",
                           weights.to(f32)[..., None] * oh * keep, pos_oh)
    xe = torch.einsum("td,tec->ecd", x.to(f32), dispatch).to(x.dtype)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe,
                             p[f"{pre}w_gate"].to(x.dtype)))
         * torch.einsum("ecd,edf->ecf", xe, p[f"{pre}w_up"].to(x.dtype)))
    y = torch.einsum("ecf,efd->ecd", h, p[f"{pre}w_down"].to(x.dtype))
    out = torch.einsum("ecd,tec->td", y.to(f32), combine)
    return out.to(x.dtype)


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over 'model' (each model rank
    contributes its block's share)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, "model"), None


class _FromModel(torch.autograd.Function):
    """``psum`` over 'model' forward; identity gradient (every model rank
    holds the whole output's gradient)."""

    @staticmethod
    def forward(ctx, y, mesh):
        return mesh.psum(y, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelBlock(torch.autograd.Function):
    """This rank's block of a whole leaf along ``dim``; its gradient
    gathered back over 'model' into the whole leaf's."""

    @staticmethod
    def forward(ctx, w, mesh, dim):
        n = mesh.shape["model"]
        blk = w.shape[dim] // n
        ctx.mesh, ctx.dim = mesh, dim
        # copied contiguous: the grouped product reads an expert's block
        # densely (a narrowed leaf is strided)
        return w.narrow(dim, mesh.axis_index("model") * blk,
                        blk).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather_tiled(g.contiguous(), "model", ctx.dim),
                None, None)


def _moe_ragged_shmap(cfg, p, x, weights, idx, pre):
    """'ragged' on this rank's block of the expert-FFN dimension, then the
    psum of the partial sums over 'model' (see the module docstring). A
    leaf whose expert-FFN width does not split over 'model' runs whole,
    without the psum."""
    mesh = _MOE_MESH
    if mesh is None:
        raise ValueError("set_moe_mesh(mesh) before using ragged_shmap")
    n = int(mesh.shape.get("model", 1))
    w = {k: p[f"{pre}{k}"] for k in ("w_gate", "w_up", "w_down")}
    f, full = w["w_gate"].shape[-1], cfg.moe.d_ff_expert
    if f == full and full % n:
        return _moe_ragged(cfg, p, x, weights, idx, pre)
    if f == full and n > 1:
        w = {"w_gate": _ModelBlock.apply(w["w_gate"], mesh, 2),
             "w_up": _ModelBlock.apply(w["w_up"], mesh, 2),
             "w_down": _ModelBlock.apply(w["w_down"], mesh, 1)}
    if torch.is_grad_enabled():
        x, weights = _ToModel.apply(x, mesh), _ToModel.apply(weights, mesh)
    y = _moe_ragged(cfg, {f"{pre}{k}": v for k, v in w.items()}, x,
                    weights, idx, pre)
    return _FromModel.apply(y, mesh)


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
        out = _moe_ragged_shmap(cfg, p, xf, weights, idx, pre)
    else:
        raise ValueError(f"unknown MoE impl {m.impl!r}")
    if m.n_shared:
        out = out + apply_mlp(p, xf, prefix=(prefix + "/shared" if prefix
                                             else "shared"))
    return out.reshape(b, t, d), aux
