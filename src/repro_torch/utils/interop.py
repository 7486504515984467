"""Carry the JAX package's weights and state into the port.

Both sides of a parity test then start from the same numbers. The
reference's arrays arrive as numpy arrays (``np.asarray`` of its JAX
arrays), so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.quafl import QuaflState
from repro_torch.fed.population import Population

QUAFL_ROWS = ("lam", "group", "model", "last_time")


def _tensor(a, device, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def params_from_numpy(params: Dict[str, np.ndarray], device
                      ) -> Dict[str, torch.Tensor]:
    """The reference's params dict (numpy leaves) as fp32 tensors."""
    return {k: _tensor(v, device, torch.float32) for k, v in params.items()}


def data_from_numpy(data: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A reference dataset {'x': fp32, 'y': int} with int64 labels, as
    PyTorch's losses take them."""
    return {"x": _tensor(data["x"], device, torch.float32),
            "y": _tensor(data["y"], device, torch.int64)}


def quafl_state_from_numpy(*, server, rows: Dict[str, np.ndarray], t,
                           sim_time, bits_up, bits_down, srv_dist_est,
                           device) -> QuaflState:
    """A reference ``QuaflState`` — server vector, population rows and
    scalars, all as numpy — as the port's state. The port's store keeps
    :data:`QUAFL_ROWS`; the reference's empty ``codec_up`` row (stateless
    codecs) has no counterpart yet."""
    pop = Population(rows={k: _tensor(rows[k], device) for k in QUAFL_ROWS})
    return QuaflState(server=_tensor(server, device, torch.float32),
                      pop=pop, t=int(t), sim_time=float(sim_time),
                      bits_up=float(bits_up), bits_down=float(bits_down),
                      srv_dist_est=_tensor(srv_dist_est, device,
                                           torch.float32))
