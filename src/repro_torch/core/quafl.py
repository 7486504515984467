"""QuAFL — paper Algorithm 1 (port of ``repro.core.quafl``, the
lattice-pipeline branch).

The optimisation state is flat fp32 vectors: ``server`` (X_t) plus a
:class:`~repro_torch.fed.population.Population` store holding every client
row (models X^i, speeds λ, last-interaction times). A round:

  * samples s clients (uniform participation) and gathers their rows;
  * draws each one's lazy H_i = min(K, Poisson(λ_i · elapsed_i)) and replays
    K masked SGD steps, all s clients at once through a batched loss, so
    one autograd call per step gives every client's gradient;
  * runs the lattice-quantized exchange in rotated coordinates
    (:meth:`ExchangePipeline.quafl_round`: s+1 forward and s+1 inverse
    rotations, on the CUDA kernels by default) with (s+1)-averaging;
  * scatters the s new client rows back into the store.

``round(state, data, generator, draws=None)``: ``draws`` may supply any of
the values the reference takes from its key splits — ``idx``, ``h_steps``,
``batch_idx`` (s, K, B), ``signs``, ``u_cl``, ``u_srv`` — so a test can
feed the reference's own draws to the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.compression.codecs import resolve_codec
from repro_torch.compression.pipeline import ExchangePipeline
from repro_torch.configs.base import FedConfig
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
    avg_mode: str = "both"               # 'both'|'server_only'|'client_only'
    uplink: Any = None                   # codec spec (default: fed-derived)
    downlink: Any = None
    device: Any = None                   # None = the card

    def __post_init__(self):
        self.device = default_device(self.device)
        fed = self.fed
        n = fed.n_clients
        self.lam = speeds_for(fed, n)
        self.codec_up = resolve_codec(self.uplink, fed, direction="up")
        self.codec_down = resolve_codec(self.downlink, fed,
                                        direction="down")
        self.pipeline = ExchangePipeline(bits=self.codec_up.bits,
                                         block=self.codec_up.block,
                                         safety=self.codec_up.safety,
                                         backend=fed.kernel_backend)
        self.H = expected_steps(fed, self.lam)
        self.eta_i = ((self.H.min() / self.H) if fed.weighted
                      else np.ones(n)).astype(np.float32)
        self._eta_t = torch.as_tensor(self.eta_i, device=self.device)
        self.part = resolve_participation(None, fed)
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
    def _grads(self, flat, batch):
        """Per-client gradients of the batched loss at (s, d) ``flat``."""
        v = flat.detach().requires_grad_(True)
        losses, _ = self.loss_fn(tree_unflatten_vector(self.template, v),
                                 batch)
        (g,) = torch.autograd.grad(losses.sum(), v)
        return g

    def _local_progress(self, cl, xs, ys, h_steps):
        """Replay K masked SGD steps of every sampled client; returns h̃,
        the sum of the active steps' gradients, (s, d)."""
        eta = self.fed.lr
        x, h = cl, torch.zeros_like(cl)
        for q in range(self.fed.local_steps):
            g = self._grads(x, {"x": xs[:, q], "y": ys[:, q]})
            act = (q < h_steps).to(torch.float32)[:, None]
            x = x - eta * act * g
            h = h + act * g
        return h

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
        idx = draw("idx", lambda: self.part.sample(generator, state.t, n, s,
                                                   lam_row)).long()
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
        server_new, cl_new, hint_srv, rel_err = self.pipeline.quafl_round(
            state.server, Y, hints_up, generator=generator,
            signs=draws.get("signs"), u_cl=draws.get("u_cl"),
            u_srv=draws.get("u_srv"), avg_mode=self.avg_mode,
            up=self.codec_up.wire(), down=self.codec_down.wire())

        # wire accounting by the codecs: s uplink messages + ONE downlink
        # broadcast Enc(X_t) that every sampled client decodes
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
