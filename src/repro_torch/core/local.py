"""Local SGD of a batch of clients through one batched loss.

The reference runs each client's local steps under ``jax.vmap``; here the
loss is batched over a leading client axis (``models.mlp.mlp_loss_batched``)
so one autograd call per step gives every client's gradient.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_unflatten_vector


def batched_grads(loss_fn, template, flat, batch) -> torch.Tensor:
    """Per-client gradients (s, d) of the batched loss at (s, d) ``flat``."""
    v = flat.detach().requires_grad_(True)
    losses, _ = loss_fn(tree_unflatten_vector(template, v), batch)
    (g,) = torch.autograd.grad(losses.sum(), v)
    return g


def local_sgd(loss_fn, template, start, xs, ys, lr: float) -> torch.Tensor:
    """Exactly K SGD steps of every client from ``start`` (s, d); xs (s, K,
    B, ...) and ys (s, K, B) hold each step's minibatch. Returns (s, d)."""
    x = start
    for q in range(xs.shape[1]):
        x = x - lr * batched_grads(loss_fn, template, x,
                                   {"x": xs[:, q], "y": ys[:, q]})
    return x
