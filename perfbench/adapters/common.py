"""What every cell's program side shares: the federation's knobs, the
window's call, and the read-out of a QuAFL state."""
from __future__ import annotations

from functools import partial

import torch


def fed_config(traffic):
    from repro_torch.configs.base import FedConfig
    part = traffic["participation"]
    return FedConfig(n_clients=traffic["n_clients"], s=traffic["s"],
                     local_steps=traffic["local_steps"], lr=traffic["lr"],
                     bits=traffic["bits"], swt=traffic["swt"],
                     sit=traffic["sit"],
                     participation="" if part == "uniform" else part)


class WindowCall:
    """The window's call: ``chunk`` rounds through the round engine's
    ``run_chunk`` (a captured CUDA graph on the card) when ``chunk`` > 0,
    else one eager ``round``. ``step`` returns the round metrics'
    ``h_steps_mean`` of each round it ran, a device tensor."""

    def __init__(self, alg, data, generator, chunk: int):
        self.alg, self.data, self.gen = alg, data, generator
        self.chunk = chunk
        self.rounds_per_step = max(chunk, 1)
        self.engine = None
        if chunk > 0:
            from repro_torch.fed.engine import RoundEngine
            self.engine = RoundEngine(alg)

    def step(self, state):
        if self.engine is not None:
            state, m = self.engine.run_chunk(state, self.data, self.gen,
                                             self.chunk)
            return state, m["h_steps_mean"]
        state, m = self.alg.round(state, self.data, self.gen)
        return state, m["h_steps_mean"].reshape(1)


class LossProbe:
    """Wraps the algorithm's loss (the per-client protocol: one client's
    scalar loss a step) so that a :class:`compare.FirstSteps` record ``rec``
    gets each step's loss and, at a client's first step, each leaf's
    gradient as autograd hands it over, until :meth:`remove`."""

    def __init__(self, alg, rec):
        self.alg, self.real, self.rec = alg, alg.loss_fn, rec
        alg.loss_fn = self

    def __call__(self, params, batch):
        r = self.rec.begin()
        if r is not None:
            for name, leaf in params.items():
                if leaf.requires_grad:
                    leaf.register_hook(partial(self._grad, r, name))
        loss, aux = self.real(params, batch)
        self.rec.loss(loss)
        return loss, aux

    def _grad(self, r, name, g):
        self.rec.put(r, name, g)

    def remove(self) -> None:
        self.rec.on = False
        self.alg.loss_fn = self.real


def snapshot(state):
    """The state's server and client rows copied to the host, and its
    cumulative bits."""
    return {"server": state.server.detach().to("cpu", copy=True),
            "clients": state.clients.detach().to("cpu", copy=True),
            "bits_up": float(state.bits_up),
            "bits_down": float(state.bits_down)}


def release(call) -> None:
    """Drop the engine's graphs and static buffers."""
    call.engine = None
    call.alg = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
