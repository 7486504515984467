"""QuAFL — paper Algorithm 1 (port of ``repro.core.quafl``).

The optimisation state is flat fp32 vectors: ``server`` (X_t) plus a
:class:`~repro_torch.fed.population.Population` store holding every client
row (models X^i, speeds λ, last-interaction times). A round:

  * samples s clients by the participation spec (``uniform``,
    ``gamma_straggler``, ``cyclic:...``) and gathers their rows;
  * draws each one's lazy H_i = min(K, Poisson(λ_i · elapsed_i)) and replays
    K masked SGD steps: without ``batch_fn``, all s clients at once through
    a batched loss, so one autograd call per step gives every client's
    gradient; with ``batch_fn`` (the reference's protocol, any model) one
    client at a time (:mod:`repro_torch.core.local`);
  * exchanges the models: when both codecs are lattice-family (including
    the sub-byte ``lattice_packed`` wire and a per-client ``{"fast": ...,
    "slow": ...}`` uplink) through the rotated-space pipeline
    (:meth:`ExchangePipeline.quafl_round`: s+1 forward and s+1 inverse
    rotations, on the CUDA kernels by default), otherwise message by
    message through the codec API (s uplink encodes decoded against X_t,
    one downlink encode that each client decodes against its own model;
    an uplink codec that declares itself reference-agnostic,
    ``ef_zero_ref_only=False``, gets its error-feedback residuals threaded
    through the store's ``codec_up`` row); then the (s+1)-averaging;
  * scatters the s new client rows back into the store.

With ``client_mesh`` (:func:`repro_torch.fed.population.client_mesh`) the
store is split over the ranks of the process group at :meth:`QuAFL.init`
(:func:`~repro_torch.fed.population.shard_population`: the ``model``,
``last_time``, ``group`` and ``codec_up`` rows; ``lam`` stays whole): each
rank holds n/R clients' rows, a round all-gathers the cohort's rows from
their owners and each rank writes back its own. Every rank runs the same
round on the same draws (generators seeded alike), so every rank's server
equals the whole-store run's bit for bit. The legacy whole-store views
(``clients``, ``last_time``, ``codec_up_state``) all-gather a split row:
a collective, so every rank must read them together.

``round(state, data, generator, draws=None)``: ``draws`` may supply any of
the values the reference takes from its key splits — ``idx``,
``part_noise`` (the participation spec's draw, see
:meth:`Participation.sample`), ``h_steps``, ``batch_idx`` (s, K, B), the
pipeline's ``signs``, ``u_cl``, ``u_srv``, and the per-message branch's
``key_up`` (a :class:`MessageKey` of s rows) and ``key_dn`` (one row) — so
a test can feed the reference's own draws to the port.

A round holds few full-model copies at once: the sampled rows, their
progress and Y are dropped once the exchange has Y, and the exchange
itself frees each rotated temporary as soon as it is dead
(:meth:`ExchangePipeline.quafl_round`), so an LM at full width fits the
card (about 15 copies of the model at n = s = 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.compression.codecs import (GroupedLatticeCodec,
                                            init_client_states,
                                            is_lattice_family, resolve_codec)
from repro_torch.compression.pipeline import ExchangePipeline
from repro_torch.configs.base import FedConfig
from repro_torch.core.local import (batched_grads, cohort_progress,
                                   gather_batches, pool_size)
from repro_torch.fed.api import counters0
from repro_torch.fed.clock import expected_steps, speeds_for
from repro_torch.fed.population import (Population, build_population,
                                        client_rows, gather_rows,
                                        resolve_participation, scatter_rows,
                                        shard_population, whole_row)
from repro_torch.utils import spans
from repro_torch.utils.tree import (tree_flatten_vector, tree_size,
                                    tree_unflatten_vector)


def _metric(x):
    """A host number as a python float (constant from round to round), a
    tensor (the grouped uplink's bits) as it is."""
    return x if isinstance(x, torch.Tensor) else float(x)


class QuaflState(NamedTuple):
    """Server state + the :class:`Population` store of per-client rows.
    Every counter is a 0-d device tensor, so a captured chunk of rounds
    carries it: ``t`` int64, ``sim_time`` and the cumulative bits fp64
    (the values python floats held: fp64 sums, exact integer bits)."""
    server: torch.Tensor       # X_t (d,)
    pop: Population            # rows: lam, group, model (n, d),
    #                          # last_time, codec_up (EF residuals or ())
    t: torch.Tensor            # server round (int64)
    sim_time: torch.Tensor     # simulated wall-clock (fp64)
    bits_up: torch.Tensor      # cumulative client->server bits (fp64)
    bits_down: torch.Tensor    # cumulative server->client bits (fp64)
    srv_dist_est: torch.Tensor  # running ‖X_t − X^i‖ estimate (0-d)

    @property
    def clients(self):
        """X^i stacked (n, d): a view into the store, or a split row
        all-gathered (every rank must read it)."""
        return whole_row(self.pop.rows["model"])

    @property
    def last_time(self):
        return whole_row(self.pop.rows["last_time"])

    @property
    def codec_up_state(self):
        """Per-client error-feedback residuals, a row of the store (``()``
        unless the uplink's residuals are threaded; all-gathered when
        split)."""
        return whole_row(self.pop.rows["codec_up"])

    @property
    def bits_sent(self):
        """Total communication bits, both directions."""
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class QuAFL:
    fed: FedConfig
    loss_fn: Callable[[Any, Any], Any]   # batched: (params_s, batch_s) ->
    #                                    # ((s,) losses, aux); per client
    #                                    # with batch_fn: (params, batch)
    #                                    # -> (loss, aux)
    template: Dict[str, torch.Tensor]    # params dict (shapes, leaf order)
    batch_fn: Callable = None            # (client_data, rows) -> batch
    batch_size: int = 32                 # minibatch per local step
    avg_mode: str = "both"   # 'both'|'server_only'|'client_only'|'none'
    uniform_speeds: bool = False
    exchange_impl: str = "pipeline"      # 'pipeline' | 'reference' (oracle)
    uplink: Any = None                   # codec spec (default: fed-derived)
    downlink: Any = None
    participation: Any = None            # spec (default: fed.participation)
    client_mesh: Any = None              # split the store over its ranks
    device: Any = None                   # None = the card

    def __post_init__(self):
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

    @property
    def _thread_ef(self) -> bool:
        """QuAFL's uplink decodes against the SERVER model, a non-zero
        reference, so error-feedback residuals (which assume the decoder
        reconstructs zero off the sent support) are threaded only for a
        codec that declares itself reference-agnostic; every other codec
        uses its stateless encode."""
        return self.codec_up.stateful and not getattr(
            self.codec_up, "ef_zero_ref_only", True)

    def _codec_state0(self):
        return (init_client_states(self.codec_up, self.fed.n_clients,
                                   self.d, self.device)
                if self._thread_ef else ())

    def init(self, params0) -> QuaflState:
        with spans.span("quafl.init"):
            x0 = tree_flatten_vector(params0).to(self.device)
            n = self.fed.n_clients
            pop = shard_population(build_population(
                self.fed, n, lam=self.lam, device=self.device,
                model=client_rows(x0, n),
                last_time=torch.zeros(n, dtype=torch.float32,
                                      device=self.device),
                codec_up=self._codec_state0()), self.client_mesh)
            # x0 is a fresh vector, so the server takes it without a copy
            return QuaflState(server=x0, pop=pop,
                              **counters0(self.device),
                              srv_dist_est=torch.tensor(1e-3,
                                                        device=self.device))

    # ------------------------------------------------------------------
    def _local_progress(self, cl, data, idx, rows, h_steps,
                        correction=None):
        """Replay K masked SGD steps of every sampled client ``idx`` at its
        minibatch rows ``rows`` (s, K, B); returns h̃, the sum of the
        active steps' gradients, (s, d). ``correction`` (s, d), when given,
        is taken off every gradient (SCAFFOLD's c_i − c). Masked steps
        run in full: ``local.steps_computed`` counts every step,
        ``local.steps_active`` the unmasked ones."""
        eta = self.fed.lr
        spans.count("local.steps_computed", rows.shape[0] * rows.shape[1])
        spans.count("local.steps_active", h_steps)
        if self.batch_fn is not None:
            return cohort_progress(self.loss_fn, self.template,
                                   self.batch_fn, cl, data, idx, rows,
                                   h_steps, eta, correction)
        xs, ys = gather_batches(data, idx, rows)
        x, h = cl, torch.zeros_like(cl)
        for q in range(self.fed.local_steps):
            with spans.span("local.step", eager_only=True):
                g = batched_grads(self.loss_fn, self.template, x,
                                  {"x": xs[:, q], "y": ys[:, q]})
                if correction is not None:
                    g = g - correction
                act = (q < h_steps).to(torch.float32)[:, None]
                x = x - eta * act * g
                h = h + act * g
        return h

    # ------------------------------------------------------------------
    def _per_message(self, server, cl, Y, hints_up, generator, draws,
                     cs=None):
        """The exchange of any codec pair that is not both lattice-family
        (scalar, identity, top-k): s uplink encodes, each decoded against
        X_t (with the sampled clients' residuals ``cs`` when they are
        threaded); ONE downlink encode of X_t, which each client decodes
        against its own model ``cl``; then the (s+1)-averaging. Returns
        (server_new, clients_new, hint_srv, rel_err, the new residuals or
        None)."""
        s, d = Y.shape
        with spans.span("exchange.draws", eager_only=True):
            key_up = (draws["key_up"] if "key_up" in draws
                      else self.codec_up.keys(generator, s, d))
        cs_new = None
        with spans.span("exchange.uplink", eager_only=True):
            if cs is not None:
                msg, cs_new = self.codec_up.encode_stateful(key_up, Y,
                                                            hints_up, cs)
            else:
                msg = self.codec_up.encode(key_up, Y, hints_up)
            QY = self.codec_up.decode(key_up, msg, server[None])

        with spans.span("exchange.downlink", eager_only=True):
            key_dn = (draws["key_dn"] if "key_dn" in draws
                      else self.codec_down.keys(generator, 1, d))
            hint_srv = (torch.max(torch.linalg.vector_norm(
                QY - server[None], dim=1)) + 1e-8)
            msg = self.codec_down.encode(key_dn, server[None],
                                         hint_srv[None])
            # a codec that ignores the reference decodes one row for all
            QX = self.codec_down.decode(key_dn, msg, cl).expand(s, d)

        with spans.span("exchange.average", eager_only=True):
            if self.avg_mode in ("both", "server_only"):
                server_new = (server + torch.sum(QY, 0)) / (s + 1)
            else:
                server_new = torch.mean(QY, 0)
            if self.avg_mode in ("both", "client_only"):
                cl_new = QX / (s + 1) + s * Y / (s + 1)
            else:
                cl_new = QX
            rel_err = torch.mean(torch.linalg.vector_norm(QY - Y, dim=1)
                                 / (torch.linalg.vector_norm(Y, dim=1)
                                    + 1e-9))
        return server_new, cl_new, hint_srv, rel_err, cs_new

    # ------------------------------------------------------------------
    def _cohort(self, state: QuaflState, data, generator, draws):
        """The round's cohort: the sampled ids, their gathered rows, their
        H_i draws and their (s, K, B) minibatch row indices, each from
        ``draws`` where given."""
        fed = self.fed
        n, s, K = fed.n_clients, fed.s, fed.local_steps

        def draw(name, fn):
            return draws[name] if name in draws else fn()

        idx = draw("idx", lambda: self.part.sample(
            generator, state.t, n, s, state.pop.rows["lam"],
            noise=draws.get("part_noise"))).long()
        got = gather_rows(state.pop, idx)
        elapsed = state.sim_time + fed.swt + fed.sit - got["last_time"]
        h_steps = draw("h_steps", lambda: self.part.h_steps(
            generator, idx, got["lam"], elapsed, K))
        bidx = draw("batch_idx", lambda: torch.randint(
            0, pool_size(data), (s, K, self.batch_size),
            generator=generator, device=self.device)).long()
        return idx, got, h_steps, bidx

    def round(self, state: QuaflState, data, generator: torch.Generator,
              draws: Dict[str, torch.Tensor] = None):
        """One server round. data: per-client datasets, {'x': (n, m, d_in),
        'y': (n, m)} under the batched protocol, any leaves (n, m, ...)
        that ``batch_fn`` reads under the per-client one. Consumes
        ``state`` (its store is updated in place)."""
        fed = self.fed
        s = fed.s
        # the round's five phases (utils/spans); off, every `with` below
        # enters a shared null context
        with spans.span("quafl.round"):
            with spans.span("quafl.cohort"):
                draws = {k: v.to(self.device)
                         for k, v in (draws or {}).items()}
                idx, got, h_steps, bidx = self._cohort(state, data,
                                                       generator, draws)
                cl = got.pop("model")                             # (s, d)
            with spans.span("quafl.local"):
                h_tilde = self._local_progress(cl, data, idx, bidx, h_steps)
            with spans.span("quafl.progress"):
                # η·η_i·h̃
                prog = fed.lr * self._eta_t[idx][:, None] * h_tilde
                del h_tilde
                Y = cl - prog
                hints_up = (torch.linalg.vector_norm(prog, dim=1)
                            + state.srv_dist_est + 1e-8)
                del prog
            cs_new = None      # the sampled clients' new EF rows, if any
            with spans.span("quafl.exchange"):
                if self.pipeline is not None:
                    del cl     # the rotated-space exchange reads Y only
                    fn = (self.pipeline.quafl_round
                          if self.exchange_impl == "pipeline"
                          else self.pipeline.quafl_round_reference)
                    server_new, cl_new, hint_srv, rel_err = fn(
                        state.server, Y, hints_up, generator=generator,
                        signs=draws.get("signs"), u_cl=draws.get("u_cl"),
                        u_srv=draws.get("u_srv"), avg_mode=self.avg_mode,
                        up=self.codec_up.wire(idx),
                        down=self.codec_down.wire())
                    del Y
                else:
                    server_new, cl_new, hint_srv, rel_err, cs_new = \
                        self._per_message(state.server, cl, Y, hints_up,
                                          generator, draws,
                                          got["codec_up"] if self._thread_ef
                                          else None)
            with spans.span("quafl.commit"):
                # wire accounting by the codecs: s uplink messages
                # (per-client widths under a grouped codec) + ONE downlink
                # broadcast Enc(X_t) that every sampled client decodes
                if isinstance(self.codec_up, GroupedLatticeCodec):
                    bits_up = self.codec_up.bits_for(idx, self.d)
                else:
                    bits_up = s * self.codec_up.message_bits(self.d)
                bits_down = self.codec_down.message_bits(self.d)
                dt = fed.swt + fed.sit
                new_time = state.sim_time + dt
                updates = {"model": cl_new, "last_time": new_time}
                if cs_new is not None:
                    updates["codec_up"] = cs_new
                pop = scatter_rows(state.pop, idx, updates)
                state = QuaflState(
                    server=server_new, pop=pop, t=state.t + 1,
                    sim_time=new_time, bits_up=state.bits_up + bits_up,
                    bits_down=state.bits_down + bits_down,
                    srv_dist_est=0.5 * state.srv_dist_est + 0.5 * hint_srv)
                hs = h_steps.to(torch.float32)
                metrics = {
                    "sim_time": new_time,
                    "round_time": dt,
                    "bits_up": _metric(bits_up),
                    "bits_down": float(bits_down),
                    "h_steps_mean": hs.mean(),
                    "h_zero_frac": (hs == 0).to(torch.float32).mean(),
                    "quant_err": rel_err,
                    "bits": _metric(bits_up + bits_down),
                }
        return state, metrics

    def device_round(self, state: QuaflState, data,
                     generator: torch.Generator):
        """:meth:`round` with every draw from ``generator``: the one round
        body of the eager loop and the round engine's chunks."""
        return self.round(state, data, generator)

    def eval_params(self, state: QuaflState):
        return tree_unflatten_vector(self.template, state.server)

    def mean_model(self, state: QuaflState):
        """μ_t = (X_t + Σ_i X^i) / (n + 1), the model mean the paper's
        potential argument tracks, as a params dict."""
        mu = ((state.server + torch.sum(state.clients, 0))
              / (self.fed.n_clients + 1))
        return tree_unflatten_vector(self.template, mu)
