"""Carry the JAX package's weights and state into the port.

Both sides of a parity test then start from the same numbers. The
reference's arrays arrive as numpy arrays (``np.asarray`` of its JAX
arrays), so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.fedavg import CompressedFedAvgState, FedAvgState
from repro_torch.core.extensions import ScaffoldState
from repro_torch.core.fedbuff import FedBuffDeviceState, FedBuffState
from repro_torch.core.quafl import QuaflState
from repro_torch.fed.clock import ArrivalQueue
from repro_torch.fed.engine import RingBuffer
from repro_torch.fed.population import Population

QUAFL_ROWS = ("lam", "group", "model", "last_time")
FEDAVG_ROWS = ("lam", "group")


def _codec_row(a, device):
    """A ``codec_up`` row: (n, d) residuals as a tensor; the reference's
    empty row of a stateless codec (``()``, numpy shape (0,)) as ``()``."""
    if a is None or np.ndim(a) < 2:
        return ()
    return _tensor(a, device, torch.float32)


def _tensor(a, device, dtype=None):
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # the reference's bf16 arrays arrive as ml_dtypes' bfloat16, which
        # torch.from_numpy does not take: carry the bits across
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _counters(t, sim_time, bits_up, bits_down, time_dtype, device):
    """A state's counters as the port keeps them: 0-d tensors, ``t``
    int64, the simulated time in ``time_dtype``, the bits fp64."""
    def scalar(x, dtype):
        return torch.tensor(np.asarray(x).item(), dtype=dtype, device=device)
    return dict(t=scalar(t, torch.int64),
                sim_time=scalar(sim_time, time_dtype),
                bits_up=scalar(bits_up, torch.float64),
                bits_down=scalar(bits_down, torch.float64))


def train_state_from_numpy(server: Dict[str, np.ndarray],
                          clients: Dict[str, np.ndarray], t, mesh, specs,
                          device):
    """A reference mesh ``TrainState`` (server leaves, clients stacked
    (n_slots, ...), all numpy) as the port's on the rank of ``mesh``: its
    blocks of every leaf by ``specs`` (the state specs of
    :func:`repro_torch.launch.steps.abstract_train_state`)."""
    from repro_torch.launch.steps import shard_train_state
    return shard_train_state(params_from_numpy(server, device),
                             params_from_numpy(clients, device),
                             torch.tensor(int(np.asarray(t)),
                                          dtype=torch.int64, device=device),
                             mesh, specs)


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
    scalars, all as numpy — as the port's state: the rows
    :data:`QUAFL_ROWS`, the ``codec_up`` row (EF residuals, or empty), and
    SCAFFOLD's ``control`` row where the reference has one."""
    pop = Population(rows={k: _tensor(rows[k], device) for k in QUAFL_ROWS})
    pop.rows["codec_up"] = _codec_row(rows.get("codec_up"), device)
    if "control" in rows:
        pop.rows["control"] = _tensor(rows["control"], device, torch.float32)
    return QuaflState(server=_tensor(server, device, torch.float32),
                      pop=pop, **_counters(t, sim_time, bits_up, bits_down,
                                           torch.float64, device),
                      srv_dist_est=_tensor(srv_dist_est, device,
                                           torch.float32))


def fedavg_state_from_numpy(*, server, rows: Dict[str, np.ndarray], t,
                            sim_time, bits_up, bits_down, device
                            ) -> FedAvgState:
    """A reference ``FedAvgState`` as the port's state (rows
    :data:`FEDAVG_ROWS`)."""
    pop = Population(rows={k: _tensor(rows[k], device)
                           for k in FEDAVG_ROWS})
    return FedAvgState(server=_tensor(server, device, torch.float32),
                       pop=pop, **_counters(t, sim_time, bits_up, bits_down,
                                            torch.float32, device))


def scaffold_state_from_numpy(*, c_server, device, **quafl
                              ) -> ScaffoldState:
    """A reference ``ScaffoldState`` — its base QuAFL state's fields (rows
    with ``control``) and the server control ``c_server`` — as the
    port's."""
    return ScaffoldState(base=quafl_state_from_numpy(device=device, **quafl),
                         c_server=_tensor(c_server, device, torch.float32))


def compressed_fedavg_state_from_numpy(*, srv_prev, srv_dist_est, device,
                                       **fedavg) -> CompressedFedAvgState:
    """A reference ``CompressedFedAvgState`` (with its ``codec_up`` row:
    the EF residuals of a stateful uplink, else empty) as the port's
    state."""
    codec_up = _codec_row(fedavg["rows"].get("codec_up"), device)
    base = fedavg_state_from_numpy(device=device, **fedavg)
    base.pop.rows["codec_up"] = codec_up
    return CompressedFedAvgState(
        *base, srv_prev=_tensor(srv_prev, device, torch.float32),
        srv_dist_est=_tensor(srv_dist_est, device, torch.float32))


def fedbuff_state_from_numpy(*, server, start_model: Sequence[np.ndarray],
                             events, buffer: Sequence[np.ndarray], sim_time,
                             t, bits_up, bits_down,
                             rng: np.random.Generator, device,
                             ef: Optional[Sequence[np.ndarray]] = None
                             ) -> FedBuffState:
    """A reference ``FedBuffState`` — vectors as numpy, the pending
    ``(time, client)`` events, its numpy event rng, whose state is copied,
    and the per-client ``ef`` residuals of a stateful uplink — as the
    port's state."""
    new_rng = np.random.default_rng()
    new_rng.bit_generator.state = rng.bit_generator.state
    return FedBuffState(
        server=_tensor(server, device, torch.float32),
        start_model=[_tensor(v, device, torch.float32) for v in start_model],
        queue=ArrivalQueue([(float(a), int(i)) for a, i in events]),
        buffer=[_tensor(v, device, torch.float32) for v in buffer],
        sim_time=float(sim_time), t=int(t), bits_up=float(bits_up),
        bits_down=float(bits_down), rng=new_rng,
        ef=None if ef is None else [_tensor(v, device, torch.float32)
                                    for v in ef])


def fedbuff_device_state_from_numpy(*, server, rows: Dict[str, np.ndarray],
                                    queue_times, queue_clients, sim_time, t,
                                    bits_up, bits_down, live, device
                                    ) -> FedBuffDeviceState:
    """A reference ``FedBuffDeviceState`` — server, the store's rows
    (``lam``, ``group``, ``start``, ``occ``), the ring's times and client
    ids, the counters and ``live``, all as numpy — as the port's state.
    The reference's event key has no counterpart: the port's rounds draw
    from their generator."""
    pop = Population(rows={
        "lam": _tensor(rows["lam"], device, torch.float32),
        "group": _tensor(rows["group"], device, torch.int32),
        "start": _tensor(rows["start"], device, torch.float32),
        "occ": _tensor(rows["occ"], device, torch.int64)})
    queue = RingBuffer(times=_tensor(queue_times, device, torch.float32),
                       clients=_tensor(queue_clients, device, torch.int64))
    return FedBuffDeviceState(
        server=_tensor(server, device, torch.float32), pop=pop, queue=queue,
        **_counters(t, sim_time, bits_up, bits_down, torch.float32, device),
        live=bool(live))


def lm_params_from_numpy(params: Dict[str, np.ndarray], device
                         ) -> Dict[str, torch.Tensor]:
    """The reference's LM params (``init_lm``'s flat dict, numpy leaves) as
    tensors of the same keys, shapes and dtypes."""
    return {k: _tensor(v, device) for k, v in params.items()}


def cache_from_numpy(cache: Dict[str, np.ndarray], device
                     ) -> Dict[str, torch.Tensor]:
    """The reference's cache (``init_cache`` / ``forward`` / ``decode_step``
    flat dict, numpy leaves: attention K/V, MLA's latent ``c_kv`` and
    ``k_rope``, Mamba's ``conv`` and fp32 ``ssm``; bf16 included) as
    tensors of the same keys, shapes and dtypes."""
    return {k: _tensor(v, device) for k, v in cache.items()}
