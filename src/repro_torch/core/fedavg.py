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
the previous round's server model. The reference's stateful ``topk_ef``
uplink is not ported yet (ROADMAP Queue 1 item 9).

The s clients' K local steps run as one batched autograd per step
(:mod:`repro_torch.core.local`). A round's uplink is one batched
``encode`` and one batched ``decode`` over its s messages, so with a
lattice codec one ``fused_encode`` and one ``fused_decode`` launch.

``round(state, data, generator, draws=None)``: ``draws`` may supply any of
the values the reference takes from its key splits — ``idx`` (s,),
``batch_idx`` (s, K, B), ``durations`` (s,) (each sampled client's K-step
duration), ``key_up`` (a :class:`MessageKey` of s rows) and ``key_dn`` (one
row) — so a test can feed the reference's own draws to the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch import default_device
from repro_torch.compression.codecs import IdentityCodec, resolve_codec
from repro_torch.configs.base import FedConfig
from repro_torch.core.local import local_sgd
from repro_torch.fed.clock import speeds_for, straggler_round_time
from repro_torch.fed.population import (Population, build_population,
                                        resolve_participation)
from repro_torch.utils.tree import (tree_flatten_vector, tree_size,
                                    tree_unflatten_vector)


def _norms(x2):
    return torch.linalg.vector_norm(x2, dim=1)


def _draw(draws, name, fn):
    """The injected value ``name``, else a fresh draw ``fn()``."""
    return draws[name] if name in draws else fn()


class FedAvgState(NamedTuple):
    """Server model + the store (rows lam, group). ``t`` and the bit
    counters are exact host numbers; ``sim_time`` is a 0-d device tensor,
    since the straggler draw happens on the device."""
    server: torch.Tensor
    pop: Population
    t: int
    sim_time: torch.Tensor
    bits_up: float
    bits_down: float

    @property
    def bits_sent(self):
        """Total communication bits, both directions."""
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class FedAvg:
    fed: FedConfig
    loss_fn: Callable[[Any, Any], Any]   # batched over clients
    template: Dict[str, torch.Tensor]
    batch_size: int = 32
    uniform_speeds: bool = False
    uplink: Any = None                   # codec spec (default: identity)
    downlink: Any = None                 # codec spec (default: identity)
    participation: Any = None            # spec (default: fed.participation)
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

    def _pop0(self) -> Population:
        return build_population(self.fed, self.fed.n_clients, lam=self.lam,
                                device=self.device)

    def init(self, params0) -> FedAvgState:
        return FedAvgState(
            server=tree_flatten_vector(params0).to(self.device),
            pop=self._pop0(), t=0,
            sim_time=torch.zeros((), device=self.device), bits_up=0.0,
            bits_down=0.0)

    # ------------------------------------------------------------------
    def _cohort(self, state, data, generator, draws):
        """The sampled clients' (s, K, B) minibatches and the straggler
        round time of their K-step durations."""
        fed = self.fed
        n, s, K = fed.n_clients, fed.s, fed.local_steps
        lam_row = state.pop.rows["lam"]
        idx = _draw(draws, "idx", lambda: self.part.sample(
            generator, state.t, n, s, lam_row)).long()
        m = data["y"].shape[1]
        bidx = _draw(draws, "batch_idx", lambda: torch.randint(
            0, m, (s, K, self.batch_size), generator=generator,
            device=self.device)).long()
        rows = idx[:, None, None]
        batch = (data["x"][rows, bidx], data["y"][rows, bidx])
        dt = straggler_round_time(generator, lam_row[idx], K, fed.sit,
                                  durations=draws.get("durations"))
        return batch, dt

    def _local(self, start, batch):
        """EXACTLY K local SGD steps of every sampled client from the
        (d,) ``start``."""
        s = batch[0].shape[0]
        return local_sgd(self.loss_fn, self.template,
                         start[None].repeat(s, 1), *batch, self.fed.lr)

    def round(self, state: FedAvgState, data, generator: torch.Generator,
              draws: Dict[str, Any] = None):
        fed = self.fed
        s, K = fed.s, fed.local_steps
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}
        batch, dt = self._cohort(state, data, generator, draws)

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

        models = self._local(start, batch)

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

    def eval_params(self, state):
        return tree_unflatten_vector(self.template, state.server)


# ---------------------------------------------------------------------------
# compressed FedAvg (FedPAQ family) — registry name "compressed_fedavg"
# ---------------------------------------------------------------------------

class CompressedFedAvgState(NamedTuple):
    server: torch.Tensor
    pop: Population
    t: int
    sim_time: torch.Tensor
    bits_up: float
    bits_down: float
    srv_prev: torch.Tensor       # previous server model (downlink ref)
    srv_dist_est: torch.Tensor   # running ‖X_t − X_{t-1}‖ (0-d)

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
        return CompressedFedAvgState(
            server=x0, pop=self._pop0(), t=0,
            sim_time=torch.zeros((), device=self.device), bits_up=0.0,
            bits_down=0.0, srv_prev=x0.clone(),
            srv_dist_est=torch.tensor(1e-3, device=self.device))

    def round(self, state: CompressedFedAvgState, data,
              generator: torch.Generator, draws: Dict[str, Any] = None):
        fed = self.fed
        s, K, d = fed.s, fed.local_steps, self.d
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}
        batch, dt = self._cohort(state, data, generator, draws)

        # downlink broadcast: Enc(X_t) decoded against X_{t-1}
        key_dn = _draw(draws, "key_dn",
                       lambda: self.codec_down.keys(generator, 1, d))
        msg_dn = self.codec_down.encode(key_dn, state.server[None],
                                        (state.srv_dist_est + 1e-8)[None])
        start = self.codec_down.decode(key_dn, msg_dn,
                                       state.srv_prev[None])[0]

        models = self._local(start, batch)
        deltas = start[None] - models                # descent direction

        # uplink: codec-compressed deltas decoded against zero
        key_up = _draw(draws, "key_up",
                       lambda: self.codec_up.keys(generator, s, d))
        hints = _norms(deltas) + 1e-12
        zero = torch.zeros((1, d), device=self.device)
        QD = self.codec_up.decode(
            key_up, self.codec_up.encode(key_up, deltas, hints), zero)

        server_new = state.server - self.server_lr * torch.mean(QD, 0)
        rel_err = torch.mean(_norms(QD - deltas) / (_norms(deltas) + 1e-12))
        bits_up = s * self.codec_up.message_bits(d)
        bits_down = self.codec_down.message_bits(d)  # ONE broadcast
        new_time = state.sim_time + dt
        new_state = CompressedFedAvgState(
            server=server_new, pop=state.pop, t=state.t + 1,
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
