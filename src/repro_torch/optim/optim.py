"""Minimal optimizers over dicts of tensors (port of
``repro.optim.optim``).

API: ``opt.init(params) -> state``; ``opt.update(grads, state, params)
-> (updates, state)``. Updates are SUBTRACTED, ``p <- p - update``: the
learning rate is folded into the update. The arithmetic is the
reference's, in its order; Adam's moments are fp32 whatever the
gradients' dtype. Neither the inputs nor the state are written in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple]


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, or heavy-ball momentum: m <- momentum·m + g, update
    lr·m."""
    def init(params):
        if momentum:
            return {k: torch.zeros_like(v) for k, v in params.items()}
        return ()

    def update(grads, state, params=None):
        if momentum:
            state = {k: momentum * state[k] + g for k, g in grads.items()}
            upd = {k: lr * m for k, m in state.items()}
        else:
            upd = {k: lr * g for k, g in grads.items()}
        return upd, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor     # int32 step count


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction, the moments in fp32."""
    def init(params):
        z = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in params.items()}
        dev = next(iter(params.values())).device if params else None
        return AdamState(mu=z, nu={k: v.clone() for k, v in z.items()},
                         count=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    def update(grads, state, params=None):
        count = state.count + 1
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.to(torch.float32)
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k]
              + (1 - b2) * torch.square(g.to(torch.float32))
              for k, g in grads.items()}
        n = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.full_like(n, b1), n)
        c2 = 1 - torch.pow(torch.full_like(n, b2), n)
        upd = {k: lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
               for k in mu}
        return upd, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)
