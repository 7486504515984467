"""String registry of server algorithms (port of ``repro.fed.registry``).

``make_algorithm(name, fed, loss_fn=..., template=..., batch_size=...)``
builds:

  ``quafl``              paper Alg. 1; kwargs ``avg_mode``,
                         ``uniform_speeds``, ``exchange_impl``, ``uplink``
                         (a spec or a ``{"fast": ..., "slow": ...}``
                         group map), ``downlink``, ``participation``
  ``fedavg``             synchronous FedAvg (waits for stragglers); kwargs
                         ``uniform_speeds``, ``uplink``, ``downlink``,
                         ``participation``
  ``compressed_fedavg``  FedPAQ-family compressed FedAvg; FedAvg kwargs
                         plus ``server_lr``
  ``fedbuff``            buffered asynchronous aggregation; kwargs
                         ``buffer_size``, ``server_lr``, ``quantize``,
                         ``quantizer``, ``uniform_speeds``, ``uplink``,
                         ``downlink``
  ``sequential``         single slow node, one step per round

and every algorithm takes ``device``. The reference's other algorithms are
registered by name and raise until their slice is ported. Third-party
variants join through :func:`register_algorithm`.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.configs.base import FedConfig
from repro_torch.fed.api import FedAlgorithm


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


def _not_ported(name: str, item: str) -> Callable:
    def build(*args, **kw):
        raise NotImplementedError(f"algorithm {name!r} is not ported yet "
                                  f"(ROADMAP Queue 1 item {item})")
    return build


# the reference's registration order
_BUILDERS: Dict[str, Callable[..., FedAlgorithm]] = {
    "quafl": _build_quafl,
    "fedavg": _build_fedavg,
    "fedbuff": _build_fedbuff,
    "sequential": _build_sequential,
    "quafl_scaffold": _not_ported("quafl_scaffold", "9"),
    "adaptive_quafl": _not_ported("adaptive_quafl", "9"),
    "fedbuff_device": _not_ported("fedbuff_device", "10"),
    "spmd": _not_ported("spmd", "11"),
    "compressed_fedavg": _build_compressed_fedavg,
}


def registered_algorithms() -> Tuple[str, ...]:
    """Names accepted by :func:`make_algorithm`, in registration order."""
    return tuple(_BUILDERS)


def register_algorithm(name: str,
                       builder: Callable[..., FedAlgorithm]) -> None:
    """Register a custom server variant. ``builder`` receives ``(fed,
    loss_fn, template, **kwargs)`` and must return a
    :class:`~repro_torch.fed.api.FedAlgorithm`."""
    if name in _BUILDERS:
        raise ValueError(f"algorithm {name!r} already registered")
    _BUILDERS[name] = builder


def make_algorithm(name: str, fed: FedConfig, *, loss_fn, template,
                   **kwargs) -> FedAlgorithm:
    """Build the named server algorithm. ``loss_fn`` is batched over the
    sampled clients (``repro_torch.models.mlp.mlp_loss_batched``);
    ``template`` is the params dict the flat vectors unflatten against;
    other keyword arguments go to the algorithm (``batch_size``,
    ``uplink``, ``downlink``, ``avg_mode``, ``participation``, ``device``,
    ...)."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown algorithm {name!r}; choose from "
                         f"{sorted(_BUILDERS)}")
    return _BUILDERS[name](fed, loss_fn, template, **kwargs)
