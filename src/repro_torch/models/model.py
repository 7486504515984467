"""Model assembly for the LM zoo: layer blocks (attention or MLA or
Mamba2, a cross-attention over an encoder's output in encoder-decoder
models, then a dense MLP, an MoE or nothing), the stacked body, the
bidirectional encoder, prefill and decode, and the LM loss (port of
``repro.models.model``).

Params and caches are FLAT dicts keyed like the reference's:
  embed/tok, lm_head/w, final_norm/scale,
  pre/{i}/<layer params>                      (unstacked prefix layers)
  body/{j}/<layer params>                     (leading 'layers' axis)
  enc/body/0/<layer params>, enc/final_norm   (encoder stack, enc-dec)
Caches mirror the layer paths (``attn/{k,v}``, ``mla/{c_kv,k_rope}``,
``mamba/{conv,ssm}``, and ``cross/{k,v}``, the encoder's K/V, in
encoder-decoder models). The reference scans the body over periods; here
a Python loop indexes the stacked tensors' leading axis, and the cache
slices it writes are views, so the stacked cache fills in place.

A modality frontend is a stub, as in the reference: its embeddings come
in the batch (``batch["frontend"]``, (b, F, d)). An encoder-decoder model
encodes them; a frontend model prepends them to the text's embeddings
and its logits cover the text positions only.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs.base import (ATTN_MLA, KIND_MAMBA, LayerSpec,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_rope, embed_tokens,
                                       init_embed, init_mlp, lm_logits,
                                       rms_norm)
from repro_torch.models.params import Ctx, subtree, torch_dtype


def frontend_refusal(cfg: ModelConfig, where: str) -> str:
    """Why ``where``, a path that carries token batches only, refuses
    ``cfg``; '' when ``cfg`` takes tokens alone."""
    if not (cfg.encdec or cfg.frontend):
        return ""
    return (f"{where} takes token batches only: {cfg.name} needs frontend "
            f"embeddings beside its tokens, and the reference's token path "
            f"carries no frontend batches. Pick a decoder-only arch, or "
            f"drive it through models.model (forward, decode_step, lm_loss) "
            f"or the mesh steps of launch/steps.py")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _init_norm(ctx, cfg, name):
    if not cfg.nonparametric_ln:
        ctx.param(f"{name}/scale", (cfg.d_model,), (None,), init="zeros")


def _norm(cfg, p, name, x):
    w = None if cfg.nonparametric_ln else p[f"{name}/scale"]
    return rms_norm(x, w)


def _mixer(spec) -> str:
    """The sequence mixer of a layer, also its params' and cache's path."""
    if spec.kind == KIND_MAMBA:
        return "mamba"
    return "mla" if spec.attn == ATTN_MLA else "attn"


def init_layer(ctx, cfg: ModelConfig, spec, cross: bool = False):
    _init_norm(ctx, cfg, "ln_seq")
    kind = _mixer(spec)
    {"mamba": mam.init_mamba, "mla": mla_mod.init_mla,
     "attn": attn.init_attention}[kind](ctx.sub(kind), cfg)
    if cross:
        _init_norm(ctx, cfg, "ln_cross")
        attn.init_attention(ctx.sub("cross"), cfg)
    if spec.mlp == "dense":
        _init_norm(ctx, cfg, "ln_mlp")
        init_mlp(ctx.sub("mlp"), cfg.d_model, cfg.d_ff)
    elif spec.mlp == "moe":
        _init_norm(ctx, cfg, "ln_mlp")
        moe_mod.init_moe(ctx.sub("moe"), cfg)


def _cross_attend(cfg, p, x, enc_k, enc_v):
    """Cross attention over the encoder's K/V (non-causal, no softcap)."""
    b, t, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["cross/wq"].to(x.dtype)).reshape(b, t, h, dh)
    mask = torch.ones((t, enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = attn.sdpa(q, enc_k, enc_v, mask, 1.0 / np.sqrt(dh), 0.0)
    return out.reshape(b, t, -1) @ p["cross/wo"].to(x.dtype)


def _cross_kv(cfg, p, enc_out):
    b, s, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p["cross/wk"].to(enc_out.dtype)).reshape(b, s, kv, dh)
    v = (enc_out @ p["cross/wv"].to(enc_out.dtype)).reshape(b, s, kv, dh)
    return k, v


def _apply_mlp(cfg, spec, p, x):
    """The layer's MLP half: (x, aux loss or None)."""
    if spec.mlp == "dense":
        return x + apply_mlp(p, _norm(cfg, p, "ln_mlp", x), prefix="mlp"), None
    if spec.mlp == "moe":
        y, aux = moe_mod.apply_moe(cfg, p, _norm(cfg, p, "ln_mlp", x),
                                   prefix="moe")
        return x + y, aux
    return x, None


def apply_layer_prefill(cfg, spec, p, x, positions, cache=None,
                        write_pos: int = 0, enc_out=None):
    """One layer over the sequence, attending to ``enc_out`` (b, F, d)
    after its mixer when given; writes its cache (in place) when given,
    the encoder's K/V into ``cross/{k,v}``. Returns (x, aux loss: the MoE
    router's, None for other layers)."""
    h = _norm(cfg, p, "ln_seq", x)
    kind = _mixer(spec)
    lc = subtree(cache, kind) if cache is not None else None
    if kind == "mamba":
        y = mam.mamba_prefill(cfg, p, h, prefix="mamba", cache=lc)
    elif kind == "mla":
        y = mla_mod.mla_prefill(cfg, p, h, positions, prefix="mla", cache=lc,
                                write_pos=write_pos)
    else:
        y = attn.attn_block_prefill(cfg, spec, p, h, positions,
                                    prefix="attn", cache=lc,
                                    write_pos=write_pos)
    x = x + y
    if enc_out is not None:
        ek, ev = _cross_kv(cfg, p, enc_out)
        x = x + _cross_attend(cfg, p, _norm(cfg, p, "ln_cross", x), ek, ev)
        if cache is not None:
            cache["cross/k"].copy_(ek)
            cache["cross/v"].copy_(ev)
    return _apply_mlp(cfg, spec, p, x)


def apply_layer_decode(cfg, spec, p, x, cur_pos: int, cache):
    """Single-token decode of one layer, attending to the encoder's K/V
    where the cache holds them; writes the cache in place."""
    h = _norm(cfg, p, "ln_seq", x)
    kind = _mixer(spec)
    lc = subtree(cache, kind)
    if kind == "mamba":
        y = mam.mamba_decode(cfg, p, h, lc, prefix="mamba")
    elif kind == "mla":
        y = mla_mod.mla_decode(cfg, p, h, cur_pos, lc, prefix="mla")
    else:
        y = attn.attn_block_decode(cfg, spec, p, h, cur_pos, lc,
                                   prefix="attn")
    x = x + y
    if "cross/k" in cache:
        x = x + _cross_attend(cfg, p, _norm(cfg, p, "ln_cross", x),
                              cache["cross/k"], cache["cross/v"])
    return _apply_mlp(cfg, spec, p, x)[0]


# ---------------------------------------------------------------------------
# whole-model init
# ---------------------------------------------------------------------------

def build_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Returns (params flat dict, axes flat dict), on ``device`` (the card
    when None)."""
    ctx = Ctx(seed, cfg.param_dtype, default_device(device))
    root = ctx.sub("")
    init_embed(root, cfg)
    if cfg.encdec:
        # full-attention dense encoder layers
        init_layer(root.stacked("enc/body/0", cfg.n_enc_layers), cfg,
                   LayerSpec())
        _init_norm(root.sub("enc"), cfg, "final_norm")
    for i, spec in enumerate(cfg.prefix):
        init_layer(root.sub(f"pre/{i}"), cfg, spec, cross=cfg.encdec)
    for j, spec in enumerate(cfg.schedule):
        init_layer(root.stacked(f"body/{j}", cfg.n_periods), cfg, spec,
                   cross=cfg.encdec)
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

def _layer_cache(cfg, spec, batch: int, max_seq: int, device,
                 enc_len: int):
    kind = _mixer(spec)
    if kind == "mamba":
        c = mam.init_mamba_cache(cfg, batch, device)
    elif kind == "mla":
        c = mla_mod.init_mla_cache(cfg, batch, max_seq, device)
    else:
        c = attn.init_attn_cache(cfg, spec, batch, max_seq, device)
    out = {f"{kind}/{k}": v for k, v in c.items()}
    if cfg.encdec:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        for k in ("cross/k", "cross/v"):
            out[k] = torch.zeros(shape, dtype=torch_dtype(cfg.dtype),
                                 device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               enc_len: int = 0):
    """Flat zero cache dict mirroring layer paths, stacked for the body;
    an encoder-decoder model's layers also hold ``enc_len`` encoder
    positions of cross K/V (the frontend's length F for a prefill)."""
    dev = default_device(device)
    cache: Dict[str, torch.Tensor] = {}
    for i, spec in enumerate(cfg.prefix):
        for k, v in _layer_cache(cfg, spec, batch, max_seq, dev,
                                 enc_len).items():
            cache[f"pre/{i}/{k}"] = v
    n = cfg.n_periods
    meta = torch.device("meta")
    for j, spec in enumerate(cfg.schedule):
        for k, v in _layer_cache(cfg, spec, batch, max_seq, meta,
                                 enc_len).items():
            cache[f"body/{j}/{k}"] = torch.zeros((n,) + tuple(v.shape),
                                                 dtype=v.dtype, device=dev)
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

def _encode(cfg, params, frontend):
    """Bidirectional encoder over the stub frontend embeddings (b, F, d):
    rope on positions 0..F-1, no qk-norm, no window, the model's attention
    softcap, then ``enc/final_norm``."""
    x = frontend.to(torch_dtype(cfg.dtype))
    b, t, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.arange(t, device=x.device)
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device)
    for p in _layers(subtree(params, "enc/body/0"), cfg.n_enc_layers):
        hn = _norm(cfg, p, "ln_seq", x)
        q = (hn @ p["attn/wq"].to(hn.dtype)).reshape(b, t, h, dh)
        k = (hn @ p["attn/wk"].to(hn.dtype)).reshape(b, t, kv, dh)
        v = (hn @ p["attn/wv"].to(hn.dtype)).reshape(b, t, kv, dh)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attn.sdpa(q, k, v, mask, 1.0 / np.sqrt(dh), cfg.attn_softcap)
        x = x + o.reshape(b, t, -1) @ p["attn/wo"].to(hn.dtype)
        x = x + apply_mlp(p, _norm(cfg, p, "ln_mlp", x), prefix="mlp")
    return _norm(cfg, subtree(params, "enc"), "final_norm", x)


def _check_cross_cache(cache, f: int):
    """The cache must hold the encoder's F positions: the port writes
    the cross K/V in place (``init_cache(..., enc_len=F)``)."""
    for k, v in cache.items():
        if k.endswith("cross/k") and v.shape[-3] != f:
            raise ValueError(
                f"cache {k} holds {v.shape[-3]} encoder positions, the "
                f"frontend {f}: make the cache with init_cache(..., "
                f"enc_len={f})")


def forward(cfg: ModelConfig, params, batch, *, cache=None,
            write_pos: int = 0):
    """Full-sequence forward (prefill). batch: {'tokens': (b, t_text)},
    plus 'frontend': (b, F, d) for an encoder-decoder or frontend model.
    Returns (fp32 logits over the text positions (b, t_text, V), the
    cache written in place or None, the fp32 aux loss summed over the
    prefix and body layers)."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    enc_out = None
    if cfg.encdec:
        enc_out = _encode(cfg, params, batch["frontend"])
        if cache is not None:
            _check_cross_cache(cache, enc_out.shape[1])
    elif cfg.frontend:
        # early fusion: the frontend's embeddings before the text's
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(spec, p, x, lc):
        nonlocal aux
        x, a = apply_layer_prefill(cfg, spec, p, x, positions, cache=lc,
                                   write_pos=write_pos, enc_out=enc_out)
        if a is not None:
            aux = aux + a
        return x

    for i, spec in enumerate(cfg.prefix):
        lc = subtree(cache, f"pre/{i}") if cache is not None else None
        x = layer(spec, subtree(params, f"pre/{i}"), x, lc)

    body_p = [_layers(subtree(params, f"body/{j}"), cfg.n_periods)
              for j in range(len(cfg.schedule))]
    body_c = ([subtree(cache, f"body/{j}") for j in range(len(cfg.schedule))]
              if cache is not None else None)
    for n in range(cfg.n_periods):
        for j, spec in enumerate(cfg.schedule):
            lc = _layer_slice(body_c[j], n) if cache is not None else None
            x = layer(spec, body_p[j][n], x, lc)

    x = _norm(cfg, params, "final_norm", x)
    if cfg.frontend and not cfg.encdec:
        x = x[:, -tokens.shape[1]:]              # the text positions
    logits = lm_logits(cfg, params, x)
    return logits, cache, aux


def decode_step(cfg: ModelConfig, params, token, cur_pos: int, cache):
    """One-token decode. token: (b, 1) integer; cur_pos: absolute position
    of this token (tokens already in the cache, a frontend model's
    frontend positions included). Writes the cache in place. Returns (fp32
    logits (b, 1, V), cache)."""
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
    """Next-token cross-entropy over the text positions plus the MoE
    routers' aux loss, differentiable in ``params`` (under autograd the
    prefill takes the plain attention branches). Returns (loss, {'ce',
    'aux'})."""
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
