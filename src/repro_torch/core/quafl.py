"""QuAFL — paper Algorithm 1 (port of ``repro.core.quafl``).

The optimisation state is flat fp32 vectors: ``server`` (X_t) plus a
:class:`~repro_torch.fed.population.Population` store holding every client
row (models X^i, speeds λ, last-interaction times). A round:

  * samples s clients by the participation spec (``uniform``,
    ``gamma_straggler``, ``cyclic:...``) and gathers their rows;
  * draws each one's lazy H_i = min(K, Poisson(λ_i · elapsed_i)) and replays
    K masked SGD steps, all s clients at once through a batched loss, so
    one autograd call per step gives every client's gradient;
  * exchanges the models: when both codecs are lattice-family (including
    the sub-byte ``lattice_packed`` wire and a per-client ``{"fast": ...,
    "slow": ...}`` uplink) through the rotated-space pipeline
    (:meth:`ExchangePipeline.quafl_round`: s+1 forward and s+1 inverse
    rotations, on the CUDA kernels by default), otherwise message by
    message through the codec API (s uplink encodes decoded against X_t,
    one downlink encode that each client decodes against its own model);
    then the (s+1)-averaging;
  * scatters the s new client rows back into the store.

``round(state, data, generator, draws=None)``: ``draws`` may supply any of
the values the reference takes from its key splits — ``idx``,
``part_noise`` (the participation spec's draw, see
:meth:`Participation.sample`), ``h_steps``, ``batch_idx`` (s, K, B), the
pipeline's ``signs``, ``u_cl``, ``u_srv``, and the per-message branch's
``key_up`` (a :class:`MessageKey` of s rows) and ``key_dn`` (one row) — so
a test can feed the reference's own draws to the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.compression.codecs import (GroupedLatticeCodec,
                                            is_lattice_family, resolve_codec)
from repro_torch.compression.pipeline import ExchangePipeline
from repro_torch.configs.base import FedConfig
from repro_torch.core.local import batched_grads
from repro_torch.fed.clock import expected_steps, speeds_for
from repro_torch.fed.population import (Population, build_population,
                                        gather_rows, resolve_participation,
                                        scatter_rows)
from repro_torch.utils.tree import (tree_flatten_vector, tree_size,
                                    tree_unflatten_vector)


class QuaflState(NamedTuple):
    """Server state + the :class:`Population` store of per-client rows.
    Counters are host numbers (``t``, ``sim_time``, cumulative bits, kept
    exact as python numbers); ``srv_dist_est`` stays on the device."""
    server: torch.Tensor       # X_t (d,)
    pop: Population            # rows: lam, group, model (n, d), last_time
    t: int                     # server round
    sim_time: float            # simulated wall-clock
    bits_up: float             # cumulative client->server bits
    bits_down: float           # cumulative server->client bits
    srv_dist_est: torch.Tensor  # running ‖X_t − X^i‖ estimate (0-d)

    @property
    def clients(self):
        """X^i stacked (n, d) — view into the population store."""
        return self.pop.rows["model"]

    @property
    def last_time(self):
        return self.pop.rows["last_time"]


@dataclass(eq=False)
class QuAFL:
    fed: FedConfig
    loss_fn: Callable[[Any, Any], Any]   # batched: (params_s, batch_s) ->
    #                                    # ((s,) losses, aux)
    template: Dict[str, torch.Tensor]    # params dict (shapes, leaf order)
    batch_size: int = 32                 # minibatch per local step
    avg_mode: str = "both"   # 'both'|'server_only'|'client_only'|'none'
    uniform_speeds: bool = False
    exchange_impl: str = "pipeline"      # 'pipeline' | 'reference' (oracle)
    uplink: Any = None                   # codec spec (default: fed-derived)
    downlink: Any = None
    participation: Any = None            # spec (default: fed.participation)
    client_mesh: Any = None              # a sharded store: not ported
    device: Any = None                   # None = the card

    def __post_init__(self):
        if self.client_mesh is not None:
            raise NotImplementedError("QuAFL's client_mesh (a sharded "
                                      "population store) is not ported yet "
                                      "(ROADMAP Queue 1 item 11)")
        if self.exchange_impl not in ("pipeline", "reference"):
            raise ValueError(f"unknown exchange_impl {self.exchange_impl!r}")
        self.device = default_device(self.device)
        fed = self.fed
        n = fed.n_clients
        self.lam = speeds_for(fed, n, uniform=self.uniform_speeds)
        # the straggler mask resolves group specs ({"fast": ..., "slow":
        # ...}) into per-client bit budgets
        slow_mask = self.lam == np.float32(fed.lam_slow)
        self.codec_up = resolve_codec(self.uplink, fed, direction="up",
                                      slow_mask=slow_mask)
        self.codec_down = resolve_codec(self.downlink, fed,
                                        direction="down")
        # the rotated-space engine whenever BOTH directions are
        # lattice-family; any other pair runs the per-message branch
        self.pipeline = (ExchangePipeline(bits=self.codec_up.bits,
                                          block=self.codec_up.block,
                                          safety=self.codec_up.safety,
                                          backend=fed.kernel_backend)
                         if (is_lattice_family(self.codec_up)
                             and is_lattice_family(self.codec_down))
                         else None)
        self.H = expected_steps(fed, self.lam)
        self.eta_i = ((self.H.min() / self.H) if fed.weighted
                      else np.ones(n)).astype(np.float32)
        self._eta_t = torch.as_tensor(self.eta_i, device=self.device)
        self.part = resolve_participation(self.participation, fed)
        self.d = tree_size(self.template)

    def init(self, params0) -> QuaflState:
        x0 = tree_flatten_vector(params0).to(self.device)
        n = self.fed.n_clients
        pop = build_population(
            self.fed, n, lam=self.lam, device=self.device,
            model=x0[None].repeat(n, 1),
            last_time=torch.zeros(n, dtype=torch.float32,
                                  device=self.device))
        return QuaflState(server=x0.clone(), pop=pop, t=0, sim_time=0.0,
                          bits_up=0.0, bits_down=0.0,
                          srv_dist_est=torch.tensor(1e-3,
                                                    device=self.device))

    # ------------------------------------------------------------------
    def _local_progress(self, cl, xs, ys, h_steps):
        """Replay K masked SGD steps of every sampled client; returns h̃,
        the sum of the active steps' gradients, (s, d)."""
        eta = self.fed.lr
        x, h = cl, torch.zeros_like(cl)
        for q in range(self.fed.local_steps):
            g = batched_grads(self.loss_fn, self.template, x,
                              {"x": xs[:, q], "y": ys[:, q]})
            act = (q < h_steps).to(torch.float32)[:, None]
            x = x - eta * act * g
            h = h + act * g
        return h

    # ------------------------------------------------------------------
    def _per_message(self, server, cl, Y, hints_up, generator, draws):
        """The exchange of any codec pair that is not both lattice-family
        (scalar, identity): s uplink encodes, each decoded against X_t;
        ONE downlink encode of X_t, which each client decodes against its
        own model ``cl``; then the (s+1)-averaging. Returns (server_new,
        clients_new, hint_srv, rel_err)."""
        s, d = Y.shape
        key_up = (draws["key_up"] if "key_up" in draws
                  else self.codec_up.keys(generator, s, d))
        QY = self.codec_up.decode(
            key_up, self.codec_up.encode(key_up, Y, hints_up), server[None])

        key_dn = (draws["key_dn"] if "key_dn" in draws
                  else self.codec_down.keys(generator, 1, d))
        hint_srv = (torch.max(torch.linalg.vector_norm(QY - server[None],
                                                       dim=1)) + 1e-8)
        msg = self.codec_down.encode(key_dn, server[None], hint_srv[None])
        # a codec that ignores the reference decodes one row for all
        QX = self.codec_down.decode(key_dn, msg, cl).expand(s, d)

        if self.avg_mode in ("both", "server_only"):
            server_new = (server + torch.sum(QY, 0)) / (s + 1)
        else:
            server_new = torch.mean(QY, 0)
        if self.avg_mode in ("both", "client_only"):
            cl_new = QX / (s + 1) + s * Y / (s + 1)
        else:
            cl_new = QX
        rel_err = torch.mean(torch.linalg.vector_norm(QY - Y, dim=1)
                             / (torch.linalg.vector_norm(Y, dim=1) + 1e-9))
        return server_new, cl_new, hint_srv, rel_err

    # ------------------------------------------------------------------
    def round(self, state: QuaflState, data, generator: torch.Generator,
              draws: Dict[str, torch.Tensor] = None):
        """One server round. data: per-client datasets {'x': (n, m, d_in),
        'y': (n, m)}. Consumes ``state`` (its store is updated in place)."""
        fed = self.fed
        n, s, K = fed.n_clients, fed.s, fed.local_steps
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}

        def draw(name, fn):
            return draws[name] if name in draws else fn()

        lam_row = state.pop.rows["lam"]
        idx = draw("idx", lambda: self.part.sample(
            generator, state.t, n, s, lam_row,
            noise=draws.get("part_noise"))).long()
        got = gather_rows(state.pop, idx)
        elapsed = state.sim_time + fed.swt + fed.sit - got["last_time"]
        h_steps = draw("h_steps", lambda: self.part.h_steps(
            generator, idx, got["lam"], elapsed, K))

        m = data["y"].shape[1]
        bidx = draw("batch_idx", lambda: torch.randint(
            0, m, (s, K, self.batch_size), generator=generator,
            device=self.device)).long()
        rows = idx[:, None, None]
        cl = got["model"]                                         # (s, d)
        h_tilde = self._local_progress(cl, data["x"][rows, bidx],
                                       data["y"][rows, bidx], h_steps)
        prog = fed.lr * self._eta_t[idx][:, None] * h_tilde       # η·η_i·h̃
        Y = cl - prog

        hints_up = (torch.linalg.vector_norm(prog, dim=1)
                    + state.srv_dist_est + 1e-8)
        if self.pipeline is not None:
            fn = (self.pipeline.quafl_round
                  if self.exchange_impl == "pipeline"
                  else self.pipeline.quafl_round_reference)
            server_new, cl_new, hint_srv, rel_err = fn(
                state.server, Y, hints_up, generator=generator,
                signs=draws.get("signs"), u_cl=draws.get("u_cl"),
                u_srv=draws.get("u_srv"), avg_mode=self.avg_mode,
                up=self.codec_up.wire(idx), down=self.codec_down.wire())
        else:
            server_new, cl_new, hint_srv, rel_err = self._per_message(
                state.server, cl, Y, hints_up, generator, draws)

        # wire accounting by the codecs: s uplink messages (per-client
        # widths under a grouped codec) + ONE downlink broadcast Enc(X_t)
        # that every sampled client decodes
        if isinstance(self.codec_up, GroupedLatticeCodec):
            bits_up = self.codec_up.bits_for(idx, self.d)
        else:
            bits_up = s * self.codec_up.message_bits(self.d)
        bits_down = self.codec_down.message_bits(self.d)
        dt = fed.swt + fed.sit
        new_time = state.sim_time + dt
        pop = scatter_rows(state.pop, idx, {"model": cl_new,
                                            "last_time": new_time})
        state = QuaflState(
            server=server_new, pop=pop, t=state.t + 1, sim_time=new_time,
            bits_up=state.bits_up + bits_up,
            bits_down=state.bits_down + bits_down,
            srv_dist_est=0.5 * state.srv_dist_est + 0.5 * hint_srv)
        hs = h_steps.to(torch.float32)
        metrics = {
            "sim_time": new_time,
            "round_time": dt,
            "bits_up": float(bits_up),
            "bits_down": float(bits_down),
            "h_steps_mean": hs.mean(),
            "h_zero_frac": (hs == 0).to(torch.float32).mean(),
            "quant_err": rel_err,
            "bits": float(bits_up + bits_down),
        }
        return state, metrics

    def eval_params(self, state: QuaflState):
        return tree_unflatten_vector(self.template, state.server)

    def mean_model(self, state: QuaflState):
        """μ_t = (X_t + Σ_i X^i) / (n + 1), the model mean the paper's
        potential argument tracks, as a params dict."""
        mu = ((state.server + torch.sum(state.clients, 0))
              / (self.fed.n_clients + 1))
        return tree_unflatten_vector(self.template, mu)
