"""The paper's MLP classifier (port of ``repro.models.mlp``).

Parameters are a plain dict ``{"w1": (d_in, h), "b1": (h,), "w2": (h, C),
"b2": (C,)}``, the reference's names and layout. The batched forms take a
leading client axis on every leaf and run all s clients through
``torch.bmm``, so one autograd call gives every client's gradient. The MLP's
products lie outside any kernel in the reference too (XLA's dots), so they
are PyTorch's matmuls here.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import normal_param


def init_mlp_classifier(generator: torch.Generator, d_in: int,
                        d_hidden: int, n_classes: int
                        ) -> Dict[str, torch.Tensor]:
    dev = generator.device
    return {"w1": normal_param(generator, (d_in, d_hidden)),
            "b1": torch.zeros(d_hidden, device=dev),
            "w2": normal_param(generator, (d_hidden, n_classes)),
            "b2": torch.zeros(n_classes, device=dev)}


def mlp_logits(params, x):
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _loss_acc(logits, y):
    loss = F.cross_entropy(logits, y)
    acc = (logits.argmax(-1) == y).to(torch.float32).mean()
    return loss, acc


def mlp_loss(params, batch):
    """batch: {'x': (b, d), 'y': (b,) int}. Returns (loss, metrics)."""
    logits = mlp_logits(params, batch["x"]).to(torch.float32)
    loss, acc = _loss_acc(logits, batch["y"])
    return loss, {"acc": acc}


def mlp_logits_batched(params, x):
    """params leaves with a leading (s,) axis; x (s, b, d_in) -> (s, b, C)."""
    h = torch.relu(torch.bmm(x, params["w1"]) + params["b1"][:, None, :])
    return torch.bmm(h, params["w2"]) + params["b2"][:, None, :]


def mlp_loss_batched(params, batch):
    """s clients at once: batch {'x': (s, b, d_in), 'y': (s, b)}. Returns
    ((s,) per-client mean losses, metrics)."""
    logits = mlp_logits_batched(params, batch["x"]).to(torch.float32)
    s, b, n_cls = logits.shape
    per = F.cross_entropy(logits.reshape(s * b, n_cls),
                          batch["y"].reshape(s * b), reduction="none")
    return per.reshape(s, b).mean(dim=1), {}
