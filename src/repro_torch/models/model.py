"""Model assembly for the dense decoders: layer blocks, the stacked body,
prefill and decode, and the LM loss (port of the dense subset of
``repro.models.model``).

Params and caches are FLAT dicts keyed like the reference's:
  embed/tok, lm_head/w, final_norm/scale,
  pre/{i}/<layer params>                      (unstacked prefix layers)
  body/{j}/<layer params>                     (leading 'layers' axis)
Caches mirror the layer paths. The reference scans the body over periods;
here a Python loop indexes the stacked tensors' leading axis, and the cache
slices it writes are views, so the stacked cache fills in place.

Mamba, MLA and MoE layers, encoder-decoder models and modality frontends
raise ``NotImplementedError`` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import default_device
from repro_torch.configs.base import ATTN_MLA, KIND_MAMBA, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, embed_tokens, init_embed,
                                       init_mlp, lm_logits, rms_norm)
from repro_torch.models.params import Ctx, subtree, torch_dtype

NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 12)"


def _require_dense(cfg: ModelConfig):
    if cfg.encdec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models and modality frontends are "
            f"{NOT_PORTED}")
    for spec in cfg.prefix + cfg.schedule:
        _require_dense_layer(spec)


def _require_dense_layer(spec):
    if spec.kind == KIND_MAMBA or spec.attn == ATTN_MLA or spec.mlp != "dense":
        raise NotImplementedError(
            f"layer {spec}: Mamba, MLA and MoE layers are {NOT_PORTED}")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _init_norm(ctx, cfg, name):
    if not cfg.nonparametric_ln:
        ctx.param(f"{name}/scale", (cfg.d_model,), (None,), init="zeros")


def _norm(cfg, p, name, x):
    w = None if cfg.nonparametric_ln else p[f"{name}/scale"]
    return rms_norm(x, w)


def init_layer(ctx, cfg: ModelConfig, spec):
    _require_dense_layer(spec)
    _init_norm(ctx, cfg, "ln_seq")
    attn.init_attention(ctx.sub("attn"), cfg)
    _init_norm(ctx, cfg, "ln_mlp")
    init_mlp(ctx.sub("mlp"), cfg.d_model, cfg.d_ff)


def apply_layer_prefill(cfg, spec, p, x, positions, cache=None,
                        write_pos: int = 0):
    """One layer over the sequence; writes its K/V into ``cache`` (in
    place) when given. Dense layers carry no auxiliary loss."""
    h = _norm(cfg, p, "ln_seq", x)
    lc = ({"k": cache["attn/k"], "v": cache["attn/v"]}
          if cache is not None else None)
    x = x + attn.attn_block_prefill(cfg, spec, p, h, positions,
                                    prefix="attn", cache=lc,
                                    write_pos=write_pos)
    return x + apply_mlp(p, _norm(cfg, p, "ln_mlp", x), prefix="mlp")


def apply_layer_decode(cfg, spec, p, x, cur_pos: int, cache):
    """Single-token decode of one layer; writes the cache in place."""
    h = _norm(cfg, p, "ln_seq", x)
    x = x + attn.attn_block_decode(
        cfg, spec, p, h, cur_pos,
        {"k": cache["attn/k"], "v": cache["attn/v"]}, prefix="attn")
    return x + apply_mlp(p, _norm(cfg, p, "ln_mlp", x), prefix="mlp")


# ---------------------------------------------------------------------------
# whole-model init
# ---------------------------------------------------------------------------

def build_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Returns (params flat dict, axes flat dict), on ``device`` (the card
    when None)."""
    _require_dense(cfg)
    ctx = Ctx(seed, cfg.param_dtype, default_device(device))
    root = ctx.sub("")
    init_embed(root, cfg)
    for i, spec in enumerate(cfg.prefix):
        init_layer(root.sub(f"pre/{i}"), cfg, spec)
    for j, spec in enumerate(cfg.schedule):
        init_layer(root.stacked(f"body/{j}", cfg.n_periods), cfg, spec)
    _init_norm(root, cfg, "final_norm")
    return ctx.params, ctx.axes


def init_lm(cfg: ModelConfig, seed: int = 0, device=None):
    return build_params(cfg, seed=seed, device=device)


def abstract_lm(cfg: ModelConfig):
    """(params as meta tensors, axes): the shapes and logical axes of the
    LM's leaves, holding no memory."""
    return build_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Flat zero cache dict mirroring layer paths, stacked for the body."""
    _require_dense(cfg)
    dev = default_device(device)
    cache: Dict[str, torch.Tensor] = {}
    for i, spec in enumerate(cfg.prefix):
        for k, v in attn.init_attn_cache(cfg, spec, batch, max_seq,
                                         dev).items():
            cache[f"pre/{i}/attn/{k}"] = v
    n = cfg.n_periods
    for j, spec in enumerate(cfg.schedule):
        s = attn.cache_len(spec, max_seq)
        for k in ("k", "v"):
            cache[f"body/{j}/attn/{k}"] = torch.zeros(
                (n, batch, s, cfg.n_kv_heads, cfg.head_dim),
                dtype=torch_dtype(cfg.dtype), device=dev)
    return cache


def _layer_slice(tree: Dict[str, torch.Tensor], i: int):
    """Layer i of a stacked subtree (views)."""
    return {k: v[i] for k, v in tree.items()}


def _layers(tree: Dict[str, torch.Tensor], n: int):
    """The n layers of a stacked subtree, each a dict of views. The leaves
    are unbound once, so that under autograd each stacked leaf's gradient
    is assembled once (indexing layer by layer would make every layer's
    backward fill and add a zero gradient of the whole stack)."""
    parts = {k: v.unbind(0) for k, v in tree.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, batch, *, cache=None,
            write_pos: int = 0):
    """Full-sequence forward (prefill). batch: {'tokens': (b, t)}.
    Returns (fp32 logits (b, t, V), the cache written in place or None,
    aux loss)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)

    for i, spec in enumerate(cfg.prefix):
        lc = subtree(cache, f"pre/{i}") if cache is not None else None
        x = apply_layer_prefill(cfg, spec, subtree(params, f"pre/{i}"), x,
                                positions, cache=lc, write_pos=write_pos)

    body_p = [_layers(subtree(params, f"body/{j}"), cfg.n_periods)
              for j in range(len(cfg.schedule))]
    body_c = ([subtree(cache, f"body/{j}") for j in range(len(cfg.schedule))]
              if cache is not None else None)
    for n in range(cfg.n_periods):
        for j, spec in enumerate(cfg.schedule):
            lc = _layer_slice(body_c[j], n) if cache is not None else None
            x = apply_layer_prefill(cfg, spec, body_p[j][n], x, positions,
                                    cache=lc, write_pos=write_pos)

    x = _norm(cfg, params, "final_norm", x)
    logits = lm_logits(cfg, params, x)
    return logits, cache, torch.zeros((), device=logits.device)


def decode_step(cfg: ModelConfig, params, token, cur_pos: int, cache):
    """One-token decode. token: (b, 1) integer; cur_pos: absolute position
    of this token (tokens already in the cache). Writes the cache in place.
    Returns (fp32 logits (b, 1, V), cache)."""
    _require_dense(cfg)
    x = embed_tokens(cfg, params, token)
    for i, spec in enumerate(cfg.prefix):
        x = apply_layer_decode(cfg, spec, subtree(params, f"pre/{i}"), x,
                               cur_pos, subtree(cache, f"pre/{i}"))
    body_p = [subtree(params, f"body/{j}") for j in range(len(cfg.schedule))]
    body_c = [subtree(cache, f"body/{j}") for j in range(len(cfg.schedule))]
    for n in range(cfg.n_periods):
        for j, spec in enumerate(cfg.schedule):
            x = apply_layer_decode(cfg, spec, _layer_slice(body_p[j], n),
                                   x, cur_pos, _layer_slice(body_c[j], n))
    x = _norm(cfg, params, "final_norm", x)
    return lm_logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params, batch):
    """Next-token cross-entropy, differentiable in ``params`` (under
    autograd the prefill takes the plain attention branches). Returns
    (loss, metrics)."""
    logits, _, aux = forward(cfg, params, batch)
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    lg = logits[:, :-1].to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    # negative targets are masked out; clamp them to a valid index
    idx = targets.clamp(min=0).to(torch.int64)[..., None]
    tgt = torch.gather(lg, -1, idx)[..., 0]
    mask = (targets >= 0).to(torch.float32)
    ce = torch.sum((lse - tgt) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}
