"""String registry of server algorithms (port of ``repro.fed.registry``).

``make_algorithm(name, fed, loss_fn=..., template=..., batch_fn=None,
batch_size=...)`` builds any algorithm under one of two client protocols:

  * ``batch_fn`` given — the reference's protocol, any model:
    ``loss_fn(params, batch) -> (loss, aux)`` of ONE client and
    ``batch_fn(client_data, rows) -> batch``, the minibatch at the (B,) row
    indices the algorithm drew from that client's pool (``data`` leaves
    (n, m, ...)); gradients one client at a time. The LM task
    (``data.synthetic.federated_token_task``) is in this shape.
  * ``batch_fn`` None — the batched protocol of the paper's MLP:
    ``loss_fn`` batched over a leading client axis
    (``models.mlp.mlp_loss_batched``) on ``data = {"x", "y"}``; one autograd
    call a step for every sampled client.

Either way ``batch_size`` is B, and the algorithm draws the row indices
(injectable as ``draws["batch_idx"]``). The names:

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
  ``fedbuff_device``     the same on a device ring buffer (the round
                         engine can chunk it); FedBuff kwargs plus
                         ``completion_table`` (the seed bridge)
  ``sequential``         single slow node, one step per round
  ``quafl_scaffold``     QuAFL with SCAFFOLD control variates
                         (beyond-paper); QuAFL kwargs
  ``adaptive_quafl``     QuAFL under the adaptive bit-width controller
                         (beyond-paper); QuAFL kwargs plus ``lo``, ``hi``,
                         ``b_min``, ``b_max``

  ``spmd``               the mesh train step behind the protocol (one
                         client per mesh data slice,
                         :mod:`repro_torch.launch.spmd`); kwargs ``cfg``
                         (the ModelConfig, required), ``mesh``, ``batch``,
                         ``seq``, ``fed_mode``, ``transport`` (``batch``
                         is the registry's ``batch_size``)

and every algorithm takes ``device``. The algorithms with a sampled
cohort (``quafl``, ``fedavg``, ``compressed_fedavg``, ``quafl_scaffold``,
``adaptive_quafl``) and ``fedbuff_device`` also take ``client_mesh=``
(:func:`repro_torch.fed.population.client_mesh`), which splits their
per-client population store over the ranks of the process group;
``fedbuff``, ``sequential`` and ``spmd`` have no such store: their
classes take no such field, so the builder's ``TypeError`` (prefixed
with the algorithm's name, as any keyword an algorithm does not take)
refuses it.
Third-party variants join through :func:`register_algorithm`.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.configs.base import FedConfig
from repro_torch.fed.api import FedAlgorithm


def _build_quafl(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.quafl import QuAFL
    return QuAFL(fed=fed, loss_fn=loss_fn, template=template,
                 batch_fn=batch_fn, **kw)


def _build_fedavg(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.fedavg import FedAvg
    return FedAvg(fed=fed, loss_fn=loss_fn, template=template,
                  batch_fn=batch_fn, **kw)


def _build_compressed_fedavg(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.fedavg import CompressedFedAvg
    return CompressedFedAvg(fed=fed, loss_fn=loss_fn, template=template,
                            batch_fn=batch_fn, **kw)


def _build_fedbuff(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.fedbuff import FedBuff
    return FedBuff(fed=fed, loss_fn=loss_fn, template=template,
                   batch_fn=batch_fn, **kw)


def _build_fedbuff_device(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.fedbuff import FedBuffDevice
    return FedBuffDevice(fed=fed, loss_fn=loss_fn, template=template,
                         batch_fn=batch_fn, **kw)


def _build_sequential(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.baseline import Sequential
    return Sequential(fed=fed, loss_fn=loss_fn, template=template,
                      batch_fn=batch_fn, **kw)


def _build_scaffold(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.extensions import QuaflScaffold
    return QuaflScaffold(fed=fed, loss_fn=loss_fn, template=template,
                         batch_fn=batch_fn, **kw)


# the keyword arguments adaptive_quafl hands to each of its QuAFL instances
_QUAFL_KW = ("avg_mode", "uniform_speeds", "exchange_impl", "uplink",
             "downlink", "participation", "client_mesh", "batch_size",
             "device")


def _build_adaptive(fed, loss_fn, template, batch_fn, **kw):
    from repro_torch.core.extensions import AdaptiveQuaflAlgorithm
    from repro_torch.core.quafl import QuAFL
    quafl_kw = {k: kw.pop(k) for k in _QUAFL_KW if k in kw}

    def make_alg(f):
        return QuAFL(fed=f, loss_fn=loss_fn, template=template,
                     batch_fn=batch_fn, **quafl_kw)

    return AdaptiveQuaflAlgorithm(fed, make_alg, **kw)


def _build_spmd(fed, loss_fn, template, batch_fn, **kw):
    # loss_fn / batch_fn are protocol-uniform arguments the mesh path does
    # not consume: the step takes the LM loss and samples its minibatches
    # from the token pools itself; the registry's batch_size is its batch
    from repro_torch.launch.spmd import SpmdAlgorithm
    if "batch_size" in kw:
        kw.setdefault("batch", kw.pop("batch_size"))
    return SpmdAlgorithm(fed=fed, template=template, **kw)


# the reference's registration order
_BUILDERS: Dict[str, Callable[..., FedAlgorithm]] = {
    "quafl": _build_quafl,
    "fedavg": _build_fedavg,
    "fedbuff": _build_fedbuff,
    "sequential": _build_sequential,
    "quafl_scaffold": _build_scaffold,
    "adaptive_quafl": _build_adaptive,
    "fedbuff_device": _build_fedbuff_device,
    "spmd": _build_spmd,
    "compressed_fedavg": _build_compressed_fedavg,
}


def registered_algorithms() -> Tuple[str, ...]:
    """Names accepted by :func:`make_algorithm`, in registration order."""
    return tuple(_BUILDERS)


def register_algorithm(name: str,
                       builder: Callable[..., FedAlgorithm]) -> None:
    """Register a custom server variant. ``builder`` receives ``(fed,
    loss_fn, template, batch_fn=..., **kwargs)`` (``batch_fn`` by keyword,
    so a builder taking ``**kwargs`` may pass it on) and must return a
    :class:`~repro_torch.fed.api.FedAlgorithm`."""
    if name in _BUILDERS:
        raise ValueError(f"algorithm {name!r} already registered")
    _BUILDERS[name] = builder


def make_algorithm(name: str, fed: FedConfig, *, loss_fn, template,
                   batch_fn=None, **kwargs) -> FedAlgorithm:
    """Build the named server algorithm. With ``batch_fn``, ``loss_fn`` is
    one client's ``(params, batch) -> (loss, aux)``, as the reference's;
    without it, batched over the sampled clients
    (``repro_torch.models.mlp.mlp_loss_batched``). ``template`` is the
    params dict the flat vectors unflatten against (only its shapes are
    read: meta tensors do). Other keyword arguments go to the algorithm
    (``batch_size``, ``uplink``, ``downlink``, ``avg_mode``,
    ``participation``, ``device``, ...)."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown algorithm {name!r}; choose from "
                         f"{sorted(_BUILDERS)}")
    try:
        return _BUILDERS[name](fed, loss_fn, template, batch_fn=batch_fn,
                               **kwargs)
    except TypeError as e:      # a keyword the algorithm does not take
        raise TypeError(f"{name}: {e}") from e
