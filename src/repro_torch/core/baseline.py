"""Sequential baseline (port of ``repro.core.baseline``; paper Fig. 3/10):
a single slow node performing one SGD step per round, acting as both
client and server. There is no communication, so both bit counters stay 0.

``round(state, data, generator, draws=None)``: ``draws`` may supply
``batch_idx`` (B,) of client 0's samples and ``duration`` (the round's
Exp(λ_slow) step time). With ``batch_fn`` the loss is the reference's
per-client one (:mod:`repro_torch.core.local`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch import default_device
from repro_torch.configs.base import FedConfig
from repro_torch.core.local import (batched_grads, client_data, client_grad,
                                   pool_size)
from repro_torch.fed.api import counters0
from repro_torch.utils.tree import tree_flatten_vector, tree_unflatten_vector


class BaselineState(NamedTuple):
    """Counters as 0-d device tensors: ``t`` int64, ``sim_time`` fp32 (a
    device draw), the (zero) bits fp64."""
    server: torch.Tensor
    t: torch.Tensor
    sim_time: torch.Tensor
    bits_up: torch.Tensor
    bits_down: torch.Tensor

    @property
    def bits_sent(self):
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class Sequential:
    fed: FedConfig
    loss_fn: Callable[[Any, Any], Any]   # batched over clients, or per
    #                                    # client with batch_fn
    template: Dict[str, torch.Tensor]
    batch_fn: Callable = None            # (client_data, rows) -> batch
    batch_size: int = 32
    device: Any = None                   # None = the card

    def __post_init__(self):
        self.device = default_device(self.device)

    def init(self, params0) -> BaselineState:
        return BaselineState(
            server=tree_flatten_vector(params0).to(self.device),
            **counters0(self.device, torch.float32))

    def round(self, state: BaselineState, data, generator: torch.Generator,
              draws: Dict[str, torch.Tensor] = None):
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}
        if "batch_idx" in draws:
            bidx = draws["batch_idx"].long()
        else:
            bidx = torch.randint(0, pool_size(data), (self.batch_size,),
                                 generator=generator, device=self.device)
        if self.batch_fn is not None:
            zero = torch.zeros(1, dtype=torch.int64, device=self.device)
            g = client_grad(self.loss_fn, self.template, state.server,
                            self.batch_fn(client_data(data, zero), bidx))
        else:
            batch = {"x": data["x"][0][bidx][None],
                     "y": data["y"][0][bidx][None]}
            g = batched_grads(self.loss_fn, self.template,
                              state.server[None], batch)[0]
        # a single SLOW node: Exp(λ_slow) step duration
        if "duration" in draws:
            dt = draws["duration"]
        else:
            dt = (torch.empty((), device=self.device)
                  .exponential_(generator=generator) / self.fed.lam_slow)
        new_time = state.sim_time + dt
        metrics = {
            "sim_time": new_time,
            "round_time": dt,
            "bits_up": 0.0, "bits_down": 0.0,
            "h_steps_mean": 1.0,      # one step per round, by design
            "quant_err": 0.0,
        }
        return BaselineState(server=state.server - self.fed.lr * g,
                             t=state.t + 1, sim_time=new_time,
                             bits_up=state.bits_up,
                             bits_down=state.bits_down), metrics

    def device_round(self, state: BaselineState, data,
                     generator: torch.Generator):
        """:meth:`round` with every draw from ``generator``: the one round
        body of the eager loop and the round engine's chunks."""
        return self.round(state, data, generator)

    def eval_params(self, state: BaselineState):
        return tree_unflatten_vector(self.template, state.server)
