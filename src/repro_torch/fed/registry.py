"""String registry of server algorithms (port of ``repro.fed.registry``).

``make_algorithm("quafl", fed, loss_fn=..., template=..., batch_size=...)``
builds paper Algorithm 1. The reference's other algorithms are registered
by name and raise until their slice is ported.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import FedConfig


def _build_quafl(fed, loss_fn, template, **kw):
    from repro_torch.core.quafl import QuAFL
    return QuAFL(fed=fed, loss_fn=loss_fn, template=template, **kw)


_BUILDERS: Dict[str, Callable] = {"quafl": _build_quafl}

_NOT_PORTED = {
    "fedavg": "ROADMAP Queue 1 item 8",
    "fedbuff": "ROADMAP Queue 1 item 8",
    "sequential": "ROADMAP Queue 1 item 8",
    "fedbuff_device": "ROADMAP Queue 1 item 8",
    "compressed_fedavg": "ROADMAP Queue 1 item 8",
    "quafl_scaffold": "ROADMAP Queue 1 item 9",
    "adaptive_quafl": "ROADMAP Queue 1 item 9",
    "spmd": "ROADMAP Queue 1 item 11",
}


def make_algorithm(name: str, fed: FedConfig, *, loss_fn, template,
                   **kwargs):
    """Build the named server algorithm. ``loss_fn`` is batched over the
    sampled clients (``repro_torch.models.mlp.mlp_loss_batched``);
    ``template`` is the params dict the flat vectors unflatten against;
    other keyword arguments go to the algorithm (``batch_size``,
    ``uplink``, ``downlink``, ``avg_mode``, ``device``, ...)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"algorithm {name!r} is not ported yet "
                                  f"({_NOT_PORTED[name]})")
    if name not in _BUILDERS:
        raise ValueError(f"unknown algorithm {name!r}; choose from "
                         f"{sorted(_BUILDERS)}")
    return _BUILDERS[name](fed, loss_fn, template, **kwargs)
