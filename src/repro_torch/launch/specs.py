"""Shape-and-dtype stand-ins for every input of the mesh steps, and the
logical axes of their data and of the serving cache (port of
``repro.launch.specs``).

A stand-in (:func:`sds`) is a tensor on the ``meta`` device: a shape and
a dtype, no memory. :func:`input_specs` and :func:`input_axes` give the
train, prefill and decode steps' data arguments and their logical axes;
:func:`abstract_cache` and :func:`cache_axes` the decode cache, flat
paths as :func:`repro_torch.models.model.init_cache` makes them, over the
blocks' own cache axes (``attn_cache_axes``, ``mla_cache_axes``,
``mamba_cache_axes``). Each rank's block of any of them follows from
:func:`repro_torch.sharding.rules.pspec_for`.

Encoder-decoder models and modality frontends raise
``NotImplementedError`` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (ATTN_MLA, KIND_MAMBA, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mam
from repro_torch.models import mla as mla_mod
from repro_torch.models.model import NOT_PORTED, init_cache


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype``: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def enc_len_for(shape: ShapeConfig) -> int:
    """The encoder length an encoder-decoder model would take at
    ``shape``."""
    return min(4096, max(shape.seq_len // 8, 16))


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.encdec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the specs of encoder-decoder models and modality "
            f"frontends are {NOT_PORTED}")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, n_slots: int = 1,
                local_steps: int = 1) -> Dict[str, torch.Tensor]:
    """Stand-ins of the step's data arguments at ``shape``: the train
    step's ``tokens`` (n_slots, K, b_local, t), the prefill step's
    ``tokens`` (b, t), the decode step's ``token`` (b, 1) and ``pos`` ()."""
    _decoder_only(cfg)
    i32 = torch.int32
    if shape.kind == "train":
        b_local = max(shape.global_batch // n_slots, 1)
        return {"tokens": sds((n_slots, local_steps, b_local,
                               shape.seq_len), i32)}
    if shape.kind == "prefill":
        return {"tokens": sds((shape.global_batch, shape.seq_len), i32)}
    return {"token": sds((shape.global_batch, 1), i32), "pos": sds((), i32)}


def input_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """Logical axes of :func:`input_specs`' arguments."""
    _decoder_only(cfg)
    if shape.kind == "train":
        return {"tokens": ("clients", None, "batch_local", None)}
    if shape.kind == "prefill":
        return {"tokens": ("batch", None)}
    return {"token": ("batch", None), "pos": ()}


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """(the decode cache as stand-ins, its axes) at ``shape``: batch
    ``global_batch``, ``seq_len`` deep."""
    _decoder_only(cfg)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device="meta")
    return cache, cache_axes(cfg)


def cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat dict of logical axes matching ``init_cache``'s paths; the
    body's leaves lead with 'layers'."""
    _decoder_only(cfg)

    def layer_axes(spec):
        if spec.kind == KIND_MAMBA:
            kind, ax = "mamba", mam.mamba_cache_axes()
        elif spec.attn == ATTN_MLA:
            kind, ax = "mla", mla_mod.mla_cache_axes()
        else:
            kind, ax = "attn", attn_mod.attn_cache_axes(spec)
        return {f"{kind}/{k}": v for k, v in ax.items()}

    out = {}
    for i, spec in enumerate(cfg.prefix):
        for k, v in layer_axes(spec).items():
            out[f"pre/{i}/{k}"] = v
    for j, spec in enumerate(cfg.schedule):
        for k, v in layer_axes(spec).items():
            out[f"body/{j}/{k}"] = ("layers",) + tuple(v)
    return out
