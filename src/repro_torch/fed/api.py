"""The federated-algorithm protocol and the standardized metrics schema
(port of ``repro.fed.api``).

Every server algorithm implements :class:`FedAlgorithm`: ``init(params0)
-> state``, ``round(state, data, generator) -> (state, metrics)`` (one
server round; ``data`` the per-client datasets leading with the client
axis, ``generator`` a ``torch.Generator`` the round draws from) and
``eval_params(state) -> params``, so one harness
(:mod:`repro_torch.fed.simulate`) runs any of them to an equal budget.

Every ``round`` returns a dict holding at least :data:`METRIC_KEYS`:
``sim_time`` (cumulative simulated seconds), ``round_time``, ``bits_up`` /
``bits_down`` (bits sent this round, from the codecs' wire accounting),
``h_steps_mean`` and ``quant_err`` (mean relative uplink quantization
error).
"""
from __future__ import annotations

from typing import Any, Dict, Protocol, Tuple, runtime_checkable

import torch

METRIC_KEYS = ("sim_time", "round_time", "bits_up", "bits_down",
               "h_steps_mean", "quant_err")

_DEFAULTS = {"sim_time": 0.0, "round_time": 0.0, "bits_up": 0.0,
             "bits_down": 0.0, "h_steps_mean": 0.0, "quant_err": 0.0}


@runtime_checkable
class FedAlgorithm(Protocol):
    """Structural type every registered server algorithm satisfies."""

    def init(self, params0) -> Any:
        ...

    def round(self, state, data, generator) -> Tuple[Any, Dict[str, Any]]:
        ...

    def eval_params(self, state) -> Any:
        ...


def normalize_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Schema-complete, python-float view of a round's metrics dict: missing
    schema keys get their defaults, every value goes through ``float``
    (device scalars become host floats), non-scalar extras are dropped."""
    out = dict(_DEFAULTS)
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            continue  # non-scalar extras are not part of the trace format
    return out


def counters0(device, time_dtype=torch.float64):
    """A state's zero counters as 0-d device tensors: ``t`` int64, the
    simulated time in ``time_dtype`` (fp32 where it sums device draws),
    the cumulative bits fp64 (exact integers)."""
    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=device)
    return dict(t=zero(torch.int64), sim_time=zero(time_dtype),
                bits_up=zero(torch.float64), bits_down=zero(torch.float64))
