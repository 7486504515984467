"""Shape-and-dtype stand-ins for every input of the mesh steps, and the
logical axes of their data and of the serving cache (port of
``repro.launch.specs``).

A stand-in (:func:`sds`) is a tensor on the ``meta`` device: a shape and
a dtype, no memory. :func:`input_specs` and :func:`input_axes` give the
train, prefill and decode steps' data arguments and their logical axes;
:func:`abstract_cache` and :func:`cache_axes` the decode cache, flat
paths as :func:`repro_torch.models.model.init_cache` makes them, over the
blocks' own cache axes (``attn_cache_axes``, ``mla_cache_axes``,
``mamba_cache_axes``, and an encoder-decoder model's ``cross/{k,v}``).
Each rank's block of any of them follows from
:func:`repro_torch.sharding.rules.pspec_for`.

Encoder-decoder and frontend models take ``frontend`` embeddings beside
their tokens: an encoder-decoder model seq_len//2 frames and seq_len//2
text tokens, a frontend model its ``n_frontend_tokens`` embeddings and the
rest of seq_len in text. The decode cache sizes an encoder-decoder
model's cross K/V at :func:`enc_len_for`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (ATTN_MLA, KIND_MAMBA, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mam
from repro_torch.models import mla as mla_mod
from repro_torch.models.model import init_cache
from repro_torch.models.params import torch_dtype


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype``: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def enc_len_for(shape: ShapeConfig) -> int:
    """The encoder length an encoder-decoder model would take at
    ``shape``."""
    return min(4096, max(shape.seq_len // 8, 16))


def _train_text_len(cfg: ModelConfig, seq_len: int) -> int:
    """The text tokens of a sequence of ``seq_len`` positions."""
    if cfg.encdec:
        return seq_len // 2
    if cfg.frontend:
        return seq_len - cfg.n_frontend_tokens
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, n_slots: int = 1,
                local_steps: int = 1) -> Dict[str, torch.Tensor]:
    """Stand-ins of the step's data arguments at ``shape``: the train
    step's ``tokens`` (n_slots, K, b_local, t_text) and ``frontend``
    (n_slots, K, b_local, F, d), the prefill step's ``tokens`` (b, t_text)
    and ``frontend`` (b, F, d) (an encoder-decoder or frontend model's:
    F = seq_len//2 frames beside t_text = seq_len//2 tokens, or the
    model's ``n_frontend_tokens`` before the rest of seq_len), the decode
    step's ``token`` (b, 1) and ``pos`` ()."""
    i32, act = torch.int32, torch_dtype(cfg.dtype)
    t_text = _train_text_len(cfg, shape.seq_len)
    f = shape.seq_len // 2 if cfg.encdec else shape.seq_len - t_text
    if shape.kind == "train":
        lead = (n_slots, local_steps, max(shape.global_batch // n_slots, 1))
    elif shape.kind == "prefill":
        lead = (shape.global_batch,)
    else:
        return {"token": sds((shape.global_batch, 1), i32),
                "pos": sds((), i32)}
    specs = {"tokens": sds(lead + (t_text,), i32)}
    if f:
        specs["frontend"] = sds(lead + (f, cfg.d_model), act)
    return specs


def input_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """Logical axes of :func:`input_specs`' arguments."""
    fe = cfg.encdec or bool(cfg.frontend)
    if shape.kind == "train":
        ax = {"tokens": ("clients", None, "batch_local", None)}
        if fe:
            ax["frontend"] = ("clients", None, "batch_local", None, None)
        return ax
    if shape.kind == "prefill":
        ax = {"tokens": ("batch", None)}
        if fe:
            ax["frontend"] = ("batch", None, None)
        return ax
    return {"token": ("batch", None), "pos": ()}


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """(the decode cache as stand-ins, its axes) at ``shape``: batch
    ``global_batch``, ``seq_len`` deep, an encoder-decoder model's cross
    K/V :func:`enc_len_for` long."""
    enc = enc_len_for(shape) if cfg.encdec else 0
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device="meta", enc_len=enc)
    return cache, cache_axes(cfg)


def cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat dict of logical axes matching ``init_cache``'s paths; the
    body's leaves lead with 'layers'."""

    def layer_axes(spec):
        if spec.kind == KIND_MAMBA:
            kind, ax = "mamba", mam.mamba_cache_axes()
        elif spec.attn == ATTN_MLA:
            kind, ax = "mla", mla_mod.mla_cache_axes()
        else:
            kind, ax = "attn", attn_mod.attn_cache_axes(spec)
        out = {f"{kind}/{k}": v for k, v in ax.items()}
        if cfg.encdec:
            out["cross/k"] = ("batch", None, None, None)
            out["cross/v"] = ("batch", None, None, None)
        return out

    out = {}
    for i, spec in enumerate(cfg.prefix):
        for k, v in layer_axes(spec).items():
            out[f"pre/{i}/{k}"] = v
    for j, spec in enumerate(cfg.schedule):
        for k, v in layer_axes(spec).items():
            out[f"body/{j}/{k}"] = ("layers",) + tuple(v)
    return out
