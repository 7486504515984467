"""String registry of server algorithms (port of ``repro.fed.registry``).

``make_algorithm(name, fed, loss_fn=..., template=..., batch_size=...)``
builds:

  ``quafl``              paper Alg. 1; kwargs ``avg_mode``, ``uplink``,
                         ``downlink``
  ``fedavg``             synchronous FedAvg (waits for stragglers); kwargs
                         ``uniform_speeds``, ``uplink``, ``downlink``
  ``compressed_fedavg``  FedPAQ-family compressed FedAvg; FedAvg kwargs
                         plus ``server_lr``
  ``fedbuff``            buffered asynchronous aggregation; kwargs
                         ``buffer_size``, ``server_lr``, ``quantize``,
                         ``quantizer``, ``uniform_speeds``, ``uplink``,
                         ``downlink``
  ``sequential``         single slow node, one step per round

and every algorithm takes ``device``. The reference's other algorithms are
registered by name and raise until their slice is ported.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import FedConfig


def _build_quafl(fed, loss_fn, template, **kw):
    from repro_torch.core.quafl import QuAFL
    return QuAFL(fed=fed, loss_fn=loss_fn, template=template, **kw)


def _build_fedavg(fed, loss_fn, template, **kw):
    from repro_torch.core.fedavg import FedAvg
    return FedAvg(fed=fed, loss_fn=loss_fn, template=template, **kw)


def _build_compressed_fedavg(fed, loss_fn, template, **kw):
    from repro_torch.core.fedavg import CompressedFedAvg
    return CompressedFedAvg(fed=fed, loss_fn=loss_fn, template=template,
                            **kw)


def _build_fedbuff(fed, loss_fn, template, **kw):
    from repro_torch.core.fedbuff import FedBuff
    return FedBuff(fed=fed, loss_fn=loss_fn, template=template, **kw)


def _build_sequential(fed, loss_fn, template, **kw):
    from repro_torch.core.baseline import Sequential
    return Sequential(fed=fed, loss_fn=loss_fn, template=template, **kw)


_BUILDERS: Dict[str, Callable] = {
    "quafl": _build_quafl,
    "fedavg": _build_fedavg,
    "compressed_fedavg": _build_compressed_fedavg,
    "fedbuff": _build_fedbuff,
    "sequential": _build_sequential,
}

_NOT_PORTED = {
    "fedbuff_device": "ROADMAP Queue 1 item 10",
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
