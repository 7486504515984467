"""Synchronous FedAvg baselines (port of ``repro.core.fedavg``).

:class:`FedAvg` — paper App. A.2: each round the server sends its model to
s random clients; each performs EXACTLY K local steps and returns the
result; the server averages. The round lasts as long as the slowest sampled
client: max_i Gamma(K, λ_i) + sit. Codecs default to ``identity`` both
ways (the paper's uncompressed baseline); any codec plugs in per direction,
the uplink decoded against the server, the downlink a broadcast Enc(X_t)
each sampled client decodes before its local steps.

:class:`CompressedFedAvg` — the FedPAQ family, built from the codec API:
clients upload codec-compressed model DELTAS decoded against the zero
vector, the server applies the averaged decoded delta with a server
learning rate, and the downlink is ONE broadcast Enc(X_t) decoded against
the previous round's server model. A stateful uplink (``topk_ef``) gets
its per-client error-feedback residuals threaded through the store's
``codec_up`` row: the sampled clients' rows are gathered, encoded with,
and scattered back.

The s clients' K local steps run as one batched autograd per step, or,
given ``batch_fn`` (the reference's per-client protocol, any model), one
client at a time (:mod:`repro_torch.core.local`). A round's uplink is one
batched ``encode`` and one batched ``decode`` over its s messages, so
with a lattice codec one ``fused_encode`` and one ``fused_decode``
launch.

``round(state, data, generator, draws=None)``: ``draws`` may supply any of
the values the reference takes from its key splits — ``idx`` (s,),
``batch_idx`` (s, K, B), ``durations`` (s,) (each sampled client's K-step
duration), ``key_up`` (a :class:`MessageKey` of s rows) and ``key_dn`` (one
row) — so a test can feed the reference's own draws to the port.

With ``client_mesh`` (:func:`repro_torch.fed.population.client_mesh`) the
store is split over the ranks of the process group when the state is made
(the ``group`` row and compressed FedAvg's ``codec_up`` residuals; ``lam``,
which the participation specs read, stays whole), as in the reference;
every rank runs the same round on the same draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch import default_device
from repro_torch.compression.codecs import (IdentityCodec,
                                            init_client_states,
                                            resolve_codec)
from repro_torch.configs.base import FedConfig
from repro_torch.core.local import (cohort_sgd, gather_batches, local_sgd,
                                   pool_size)
from repro_torch.fed.api import counters0
from repro_torch.fed.clock import speeds_for, straggler_round_time
from repro_torch.fed.population import (Population, build_population,
                                        resolve_participation, scatter_rows,
                                        shard_population, take_rows,
                                        whole_row)
from repro_torch.utils.tree import (tree_flatten_vector, tree_size,
                                    tree_unflatten_vector)


def _norms(x2):
    return torch.linalg.vector_norm(x2, dim=1)


def _draw(draws, name, fn):
    """The injected value ``name``, else a fresh draw ``fn()``."""
    return draws[name] if name in draws else fn()


class FedAvgState(NamedTuple):
    """Server model + the store (rows lam, group). Every counter is a 0-d
    device tensor, so a captured chunk of rounds carries it: ``t`` int64,
    ``sim_time`` fp32 (the straggler draw happens on the device), the
    cumulative bits fp64 (exact integers)."""
    server: torch.Tensor
    pop: Population
    t: torch.Tensor
    sim_time: torch.Tensor
    bits_up: torch.Tensor
    bits_down: torch.Tensor

    @property
    def bits_sent(self):
        """Total communication bits, both directions."""
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class FedAvg:
    fed: FedConfig
    loss_fn: Callable[[Any, Any], Any]   # batched over clients, or per
    #                                    # client with batch_fn
    template: Dict[str, torch.Tensor]
    batch_fn: Callable = None            # (client_data, rows) -> batch
    batch_size: int = 32
    uniform_speeds: bool = False
    uplink: Any = None                   # codec spec (default: identity)
    downlink: Any = None                 # codec spec (default: identity)
    participation: Any = None            # spec (default: fed.participation)
    client_mesh: Any = None              # split the store over its ranks
    device: Any = None                   # None = the card
    # subclasses override the per-direction codec defaults (None = the
    # legacy fed.quantizer map)
    _codec_default_up = "identity"
    _codec_default_down = "identity"

    def __post_init__(self):
        self.device = default_device(self.device)
        n = self.fed.n_clients
        self.lam = speeds_for(self.fed, n, uniform=self.uniform_speeds)
        self.part = resolve_participation(self.participation, self.fed)
        self.d = tree_size(self.template)
        self.codec_up = resolve_codec(self.uplink, self.fed, direction="up",
                                      default=self._codec_default_up)
        self.codec_down = resolve_codec(self.downlink, self.fed,
                                        direction="down",
                                        default=self._codec_default_down)
        self._up_identity = isinstance(self.codec_up, IdentityCodec)
        self._down_identity = isinstance(self.codec_down, IdentityCodec)

    def _pop0(self, **extra_rows) -> Population:
        """The store, split over ``client_mesh`` when given."""
        return shard_population(
            build_population(self.fed, self.fed.n_clients, lam=self.lam,
                             device=self.device, **extra_rows),
            self.client_mesh)

    def init(self, params0) -> FedAvgState:
        return FedAvgState(
            server=tree_flatten_vector(params0).to(self.device),
            pop=self._pop0(), **counters0(self.device, torch.float32))

    # ------------------------------------------------------------------
    def _cohort(self, state, data, generator, draws):
        """The sampled clients' ids, their (s, K, B) minibatch row
        indices and the straggler round time of their K-step durations."""
        fed = self.fed
        n, s, K = fed.n_clients, fed.s, fed.local_steps
        lam_row = state.pop.rows["lam"]
        idx = _draw(draws, "idx", lambda: self.part.sample(
            generator, state.t, n, s, lam_row)).long()
        bidx = _draw(draws, "batch_idx", lambda: torch.randint(
            0, pool_size(data), (s, K, self.batch_size),
            generator=generator, device=self.device)).long()
        dt = straggler_round_time(generator, lam_row[idx], K, fed.sit,
                                  durations=draws.get("durations"))
        return idx, bidx, dt

    def _local(self, start, data, idx, bidx):
        """EXACTLY K local SGD steps of every sampled client ``idx`` from
        the (d,) ``start``, at its minibatch rows ``bidx`` (s, K, B)."""
        if self.batch_fn is not None:
            return cohort_sgd(self.loss_fn, self.template, self.batch_fn,
                              start, data, idx, bidx, self.fed.lr)
        s = idx.shape[0]
        return local_sgd(self.loss_fn, self.template,
                         start[None].repeat(s, 1),
                         *gather_batches(data, idx, bidx), self.fed.lr)

    def round(self, state: FedAvgState, data, generator: torch.Generator,
              draws: Dict[str, Any] = None):
        fed = self.fed
        s, K = fed.s, fed.local_steps
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}
        idx, bidx, dt = self._cohort(state, data, generator, draws)

        # downlink: ONE broadcast Enc(X_t); every sampled client decodes it
        # against the server reference before stepping
        if self._down_identity:
            start = state.server
        else:
            key = _draw(draws, "key_dn", lambda: self.codec_down.keys(
                generator, 1, self.d))
            srv = state.server[None]
            hint = torch.full((1,), 1e-8, device=self.device)
            start = self.codec_down.decode(
                key, self.codec_down.encode(key, srv, hint), srv)[0]

        models = self._local(start, data, idx, bidx)

        # uplink: client models decoded against the server
        if self._up_identity:
            QY = models
            rel_err = torch.zeros((), device=self.device)
        else:
            key = _draw(draws, "key_up", lambda: self.codec_up.keys(
                generator, s, self.d))
            hints = _norms(models - state.server[None]) + 1e-8
            QY = self.codec_up.decode(
                key, self.codec_up.encode(key, models, hints),
                state.server[None])
            rel_err = torch.mean(_norms(QY - models)
                                 / (_norms(models) + 1e-9))
        server_new = torch.mean(QY, 0)
        # wire accounting by the codecs: s unicasts each way
        bits_up = s * self.codec_up.message_bits(self.d)
        bits_down = s * self.codec_down.message_bits(self.d)
        new_time = state.sim_time + dt
        metrics = {
            "sim_time": new_time,
            "round_time": dt,
            "bits_up": float(bits_up),
            "bits_down": float(bits_down),
            "h_steps_mean": float(K),      # exactly K, always
            "quant_err": rel_err,
            "bits": float(bits_up + bits_down),
        }
        return FedAvgState(server=server_new, pop=state.pop, t=state.t + 1,
                           sim_time=new_time,
                           bits_up=state.bits_up + bits_up,
                           bits_down=state.bits_down + bits_down), metrics

    def device_round(self, state, data, generator: torch.Generator):
        """:meth:`round` with every draw from ``generator``: the one round
        body of the eager loop and the round engine's chunks."""
        return self.round(state, data, generator)

    def eval_params(self, state):
        return tree_unflatten_vector(self.template, state.server)


# ---------------------------------------------------------------------------
# compressed FedAvg (FedPAQ family) — registry name "compressed_fedavg"
# ---------------------------------------------------------------------------

class CompressedFedAvgState(NamedTuple):
    server: torch.Tensor
    pop: Population              # rows: lam, group, codec_up (EF residuals)
    t: torch.Tensor              # counters as FedAvgState's
    sim_time: torch.Tensor
    bits_up: torch.Tensor
    bits_down: torch.Tensor
    srv_prev: torch.Tensor       # previous server model (downlink ref)
    srv_dist_est: torch.Tensor   # running ‖X_t − X_{t-1}‖ (0-d)

    @property
    def codec_up_state(self):
        """Per-client error-feedback residuals, a row of the store (``()``
        for a stateless uplink; all-gathered when split)."""
        return whole_row(self.pop.rows["codec_up"])

    @property
    def bits_sent(self):
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class CompressedFedAvg(FedAvg):
    """Compressed synchronous FedAvg, composed from the codec API. Uplink:
    per-client model deltas, encoded with hint ‖Δ‖ and decoded against the
    ZERO vector (FedPAQ when ``uplink="scalar"``). Downlink: one broadcast
    Enc(X_t) decoded against the previous server model. Defaults: uplink
    from the legacy ``fed.quantizer`` map, downlink ``identity``."""
    server_lr: float = 1.0
    _codec_default_up = None
    _codec_default_down = "identity"

    def init(self, params0) -> CompressedFedAvgState:
        x0 = tree_flatten_vector(params0).to(self.device)
        cs0 = init_client_states(self.codec_up, self.fed.n_clients, self.d,
                                 self.device)
        return CompressedFedAvgState(
            server=x0, pop=self._pop0(codec_up=cs0),
            **counters0(self.device, torch.float32),
            srv_prev=x0.clone(),
            srv_dist_est=torch.tensor(1e-3, device=self.device))

    def round(self, state: CompressedFedAvgState, data,
              generator: torch.Generator, draws: Dict[str, Any] = None):
        fed = self.fed
        s, K, d = fed.s, fed.local_steps, self.d
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}
        idx, bidx, dt = self._cohort(state, data, generator, draws)

        # downlink broadcast: Enc(X_t) decoded against X_{t-1}
        key_dn = _draw(draws, "key_dn",
                       lambda: self.codec_down.keys(generator, 1, d))
        msg_dn = self.codec_down.encode(key_dn, state.server[None],
                                        (state.srv_dist_est + 1e-8)[None])
        start = self.codec_down.decode(key_dn, msg_dn,
                                       state.srv_prev[None])[0]

        models = self._local(start, data, idx, bidx)
        deltas = start[None] - models                # descent direction

        # uplink: codec-compressed deltas decoded against zero
        key_up = _draw(draws, "key_up",
                       lambda: self.codec_up.keys(generator, s, d))
        hints = _norms(deltas) + 1e-12
        zero = torch.zeros((1, d), device=self.device)
        pop = state.pop
        if self.codec_up.stateful:
            msg, cs_new = self.codec_up.encode_stateful(
                key_up, deltas, hints,
                take_rows(pop.rows["codec_up"], idx))
            # the sampled clients' residuals back into the store (O(s·d))
            pop = scatter_rows(pop, idx, {"codec_up": cs_new})
        else:
            msg = self.codec_up.encode(key_up, deltas, hints)
        QD = self.codec_up.decode(key_up, msg, zero)

        server_new = state.server - self.server_lr * torch.mean(QD, 0)
        rel_err = torch.mean(_norms(QD - deltas) / (_norms(deltas) + 1e-12))
        bits_up = s * self.codec_up.message_bits(d)
        bits_down = self.codec_down.message_bits(d)  # ONE broadcast
        new_time = state.sim_time + dt
        new_state = CompressedFedAvgState(
            server=server_new, pop=pop, t=state.t + 1,
            sim_time=new_time, bits_up=state.bits_up + bits_up,
            bits_down=state.bits_down + bits_down, srv_prev=state.server,
            srv_dist_est=0.5 * state.srv_dist_est
            + 0.5 * torch.linalg.vector_norm(server_new - state.server))
        metrics = {
            "sim_time": new_time,
            "round_time": dt,
            "bits_up": float(bits_up),
            "bits_down": float(bits_down),
            "h_steps_mean": float(K),
            "quant_err": rel_err,
            "bits": float(bits_up + bits_down),
        }
        return new_state, metrics
