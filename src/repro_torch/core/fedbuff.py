"""FedBuff baseline [Nguyen et al.]: buffered asynchronous aggregation
(port of the event-driven ``FedBuff`` of ``repro.core.fedbuff``).

Clients run continuously; when client i finishes its K local steps
(duration Gamma(K, 1/λ_i)) it ships the model DELTA to a shared buffer and
restarts from the current server model. Once the buffer holds Z updates the
server applies the averaged delta. The deltas can be compressed
(``quantize=True``) with ``quantizer="qsgd"`` (the paper's variant, the
``scalar`` codec) or ``"lattice"`` (a delta decodes against the zero vector
with hint ‖Δ‖: one ``fused_encode`` and one ``fused_decode`` launch per
completion); ``uplink=`` / ``downlink=`` codec specs override both knobs.
A stateful uplink (``topk_ef``) gets each client's error-feedback residual
threaded through ``FedBuffState.ef``.

The event machinery is host-side, as in the reference: a min-heap of
completion times (:class:`~repro_torch.fed.clock.ArrivalQueue`) fed by a
numpy rng, seeded on the first ``round`` from one integer drawn from the
generator (or injected), so the same seed gives the reference's event
stream draw for draw. ``round`` advances the simulation until ONE buffer
flush, exactly ``buffer_size`` completions; the state is forked, not
mutated. ``run`` is the legacy time-budget loop over the same
single-completion step.

Each completion's draws come from the round's generator, or from
``draws``: ``event_seed`` (int, first round only), ``batch_idx`` (Z, K, B),
``key_up`` and ``key_dn`` (:class:`MessageKey` of Z rows, row z for the
round's z-th completion). A client's K local steps run through the batched
loss, or, given ``batch_fn`` (the reference's per-client protocol, any
model), through the per-client one (:mod:`repro_torch.core.local`).

:class:`FedBuffDevice` (registry name ``fedbuff_device``) is the same event
simulation with every value on the device: the heap becomes a
:class:`~repro_torch.fed.engine.RingBuffer` and a flush is a Python loop
over Z completions with no host read, so the round engine can capture
chunks of flushes. Its durations are device draws, or, given a
``completion_table`` (the seed bridge,
:func:`~repro_torch.fed.engine.fedbuff_completion_table`), the host
FedBuff's own numpy draws.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.compression.codecs import IdentityCodec, resolve_codec
from repro_torch.configs.base import FedConfig
from repro_torch.core.local import (client_data, client_steps, local_sgd,
                                   pool_size)
from repro_torch.fed.api import counters0
from repro_torch.fed.clock import (ArrivalQueue, completion_time,
                                   completion_time_device, speeds_for)
from repro_torch.fed.engine import RingBuffer, ring_init, ring_pop, ring_push
from repro_torch.fed.population import (Population, build_population,
                                        client_rows, put_rows,
                                        shard_population, take_rows,
                                        whole_row, with_rows)
from repro_torch.utils.tree import (tree_flatten_vector, tree_size,
                                    tree_unflatten_vector)


def _copy_rng(rng: np.random.Generator) -> np.random.Generator:
    new = np.random.default_rng()
    new.bit_generator.state = rng.bit_generator.state
    return new


@dataclass
class FedBuffState:
    """Event-driven simulation state (host-side containers around device
    vectors)."""
    server: torch.Tensor
    start_model: List[torch.Tensor]     # model each client started from
    queue: Optional[ArrivalQueue]       # pending completion events
    buffer: List[torch.Tensor]          # deltas awaiting the next flush
    sim_time: float = 0.0
    t: int = 0                          # server updates applied
    bits_up: float = 0.0
    bits_down: float = 0.0
    rng: Optional[np.random.Generator] = None   # seeded on first round
    ef: Optional[List[torch.Tensor]] = None     # per-client (d,) residuals
    #                                           # of a stateful uplink

    @property
    def bits_sent(self):
        """Total communication bits, both directions."""
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class FedBuff:
    fed: FedConfig
    loss_fn: Callable[[Any, Any], Any]   # batched over clients, or per
    #                                    # client with batch_fn
    template: Dict[str, torch.Tensor]
    batch_fn: Callable = None            # (client_data, rows) -> batch
    batch_size: int = 32
    buffer_size: int = 10
    server_lr: float = 1.0
    quantize: bool = False
    quantizer: str = "qsgd"   # 'qsgd' (paper) | 'lattice' (delta-vs-zero)
    uniform_speeds: bool = False
    uplink: Any = None        # codec spec; default from quantize/quantizer
    downlink: Any = None      # codec spec for the restart broadcast
    device: Any = None        # None = the card

    def __post_init__(self):
        self.device = default_device(self.device)
        n = self.fed.n_clients
        self.lam = speeds_for(self.fed, n, uniform=self.uniform_speeds)
        legacy_up = ({"qsgd": "scalar", "lattice": "lattice",
                      "none": "identity"}.get(self.quantizer, "identity")
                     if self.quantize else "identity")
        self.codec_up = resolve_codec(self.uplink, self.fed, direction="up",
                                      default=legacy_up)
        self.codec_down = resolve_codec(self.downlink, self.fed,
                                        direction="down",
                                        default="identity")
        self._down_identity = isinstance(self.codec_down, IdentityCodec)
        self._up_compressed = not isinstance(self.codec_up, IdentityCodec)
        self.d = tree_size(self.template)

    # ------------------------------------------------------------------
    def init(self, params0) -> FedBuffState:
        server = tree_flatten_vector(params0).to(self.device)
        n = self.fed.n_clients
        ef = ([self.codec_up.init_state(self.d, self.device)
               for _ in range(n)] if self.codec_up.stateful else None)
        return FedBuffState(server=server,
                            start_model=[server for _ in range(n)],
                            queue=None, buffer=[], ef=ef)

    def _seed(self, state: FedBuffState, generator, seed=None
              ) -> FedBuffState:
        """Seed the event rng: one integer from the generator, or
        ``seed``."""
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                     device=generator.device))
        rng = np.random.default_rng(int(seed))
        queue = ArrivalQueue.initial(rng, self.lam, self.fed.local_steps)
        return replace(state, rng=rng, queue=queue)

    @staticmethod
    def _fork(state: FedBuffState) -> FedBuffState:
        """Copy the mutable containers so the caller's state stays usable
        (once per round, not per completion)."""
        return replace(state, queue=state.queue.copy(),
                       start_model=list(state.start_model),
                       buffer=list(state.buffer), rng=_copy_rng(state.rng),
                       ef=None if state.ef is None else list(state.ef))

    def _client_end(self, start, data, i, bidx):
        """The model client ``i`` ends at after its K local steps from
        ``start`` (d,), minibatch rows ``bidx`` (K, B); ``i`` an int or a
        0-d or (1,) index tensor (gathered without a host read)."""
        i1 = torch.as_tensor(i, device=self.device).reshape(1)
        if self.batch_fn is not None:
            return client_steps(self.loss_fn, self.template, self.batch_fn,
                                start.clone(), client_data(data, i1), bidx,
                                self.fed.lr)
        xs = data["x"].index_select(0, i1)[:, bidx]
        ys = data["y"].index_select(0, i1)[:, bidx]
        return local_sgd(self.loss_fn, self.template, start[None], xs, ys,
                         self.fed.lr)[0]

    def _key(self, codec, draws, name, z, generator):
        if name in draws:
            return draws[name].row(z)
        return codec.keys(generator, 1, self.d)

    def _completion(self, state: FedBuffState, data, generator, draws=None,
                    z: int = 0, want_metrics: bool = False):
        """Process ONE client completion event, MUTATING ``state``. With
        ``want_metrics`` returns the relative quantization error of this
        delta as a device scalar (None when uncompressed)."""
        draws = draws or {}
        K, d = self.fed.local_steps, self.d
        t_now, i = state.queue.pop()
        if "batch_idx" in draws:
            bidx = draws["batch_idx"][z].long()
        else:
            bidx = torch.randint(0, pool_size(data),
                                 (K, self.batch_size), generator=generator,
                                 device=self.device)
        start = state.start_model[i]
        end = self._client_end(start, data, i, bidx)
        delta = start - end           # positive direction of descent
        rel_err = None
        if self._up_compressed:
            key = self._key(self.codec_up, draws, "key_up", z, generator)
            hint = torch.linalg.vector_norm(delta) + 1e-12
            if self.codec_up.stateful:
                msg, ef = self.codec_up.encode_stateful(
                    key, delta[None], hint[None], state.ef[i][None])
                state.ef[i] = ef[0]
            else:
                msg = self.codec_up.encode(key, delta[None], hint[None])
            dq = self.codec_up.decode(
                key, msg, torch.zeros((1, d), device=self.device))[0]
            if want_metrics:
                rel_err = (torch.linalg.vector_norm(dq - delta)
                           / (torch.linalg.vector_norm(delta) + 1e-12))
            delta = dq
        state.bits_up += self.codec_up.message_bits(d)
        state.buffer.append(delta)
        if len(state.buffer) >= self.buffer_size:
            # Δ = start − end points downhill: w ← w − η_g·avg(Δ)
            state.server = state.server - self.server_lr * torch.mean(
                torch.stack(state.buffer), 0)
            state.buffer = []
            state.t += 1
        # the client restarts from the downlinked server model: fp32 by
        # default, else decoded against its previous start model
        if self._down_identity:
            state.start_model[i] = state.server
        else:
            key = self._key(self.codec_down, draws, "key_dn", z, generator)
            hint_dn = (torch.linalg.vector_norm(state.server
                                                - state.start_model[i])
                       + 1e-12)
            msg_dn = self.codec_down.encode(key, state.server[None],
                                            hint_dn[None])
            state.start_model[i] = self.codec_down.decode(
                key, msg_dn, state.start_model[i][None])[0]
        state.bits_down += self.codec_down.message_bits(d)
        state.sim_time = float(t_now)
        state.queue.push(t_now + completion_time(
            state.rng, K, self.lam[i]), i)
        return rel_err

    def round(self, state: FedBuffState, data, generator: torch.Generator,
              draws: Dict[str, Any] = None):
        """Advance the event simulation until ONE buffer flush (one server
        update). The input state is forked, not mutated."""
        draws = dict(draws or {})
        seed = draws.pop("event_seed", None)
        draws = {k: v.to(self.device) for k, v in draws.items()}
        if state.rng is None:
            state = self._seed(state, generator, seed)
        state = self._fork(state)
        t_before, errs = state.t, []
        time_before, up_before, down_before = (state.sim_time, state.bits_up,
                                               state.bits_down)
        z = 0
        while state.t == t_before:
            rel = self._completion(state, data, generator, draws, z,
                                   want_metrics=True)
            if rel is not None:
                errs.append(rel)
            z += 1
        metrics = {
            "sim_time": state.sim_time,
            "round_time": state.sim_time - time_before,
            "bits_up": state.bits_up - up_before,
            "bits_down": state.bits_down - down_before,
            # every buffered arrival carries exactly K completed steps
            "h_steps_mean": float(self.fed.local_steps),
            "quant_err": (torch.mean(torch.stack(errs)) if errs
                          else 0.0),
            "buffer_flushes": 1.0,
        }
        return state, metrics

    def eval_params(self, state: FedBuffState):
        return tree_unflatten_vector(self.template, state.server)

    # ------------------------------------------------------------------
    def run(self, params0, data, generator: torch.Generator,
            total_time: float, eval_every: float, eval_fn):
        """Simulate until ``total_time``; returns a list of (time, eval,
        bits sent). The same single-completion step as ``round``, in the
        same order."""
        state = self._seed(self.init(params0), generator)
        history, next_eval = [], 0.0
        while len(state.queue):
            t_now, _ = state.queue.peek()
            if t_now > total_time:
                break
            while t_now >= next_eval:
                history.append((next_eval, eval_fn(self.eval_params(state)),
                                state.bits_sent))
                next_eval += eval_every
            self._completion(state, data, generator)   # run owns state
        while next_eval <= total_time:
            history.append((next_eval, eval_fn(self.eval_params(state)),
                            state.bits_sent))
            next_eval += eval_every
        return history


# ---------------------------------------------------------------------------
# the device formulation (registry name fedbuff_device)
# ---------------------------------------------------------------------------

class FedBuffDeviceState(NamedTuple):
    """FedBuff's state with every value on the device: the heap becomes a
    :class:`RingBuffer` (one pending completion per client, so capacity n
    and the ring always full), the per-client restart models and draw
    counters rows of the :class:`Population` store; counters are 0-d
    tensors. ``live`` (host) says the ring was seeded."""
    server: torch.Tensor        # (d,)
    pop: Population             # rows: lam, group, start (n, d), occ (n,)
    queue: RingBuffer           # pending completion events
    sim_time: torch.Tensor      # fp32
    t: torch.Tensor             # int64, server updates applied
    bits_up: torch.Tensor       # fp64
    bits_down: torch.Tensor     # fp64
    live: bool = False

    @property
    def start(self):
        """(n, d) model each client restarted from, a row of the store
        (all-gathered when split)."""
        return whole_row(self.pop.rows["start"])

    @property
    def occ(self):
        """(n,) int64 completion-draw counters, a row of the store."""
        return self.pop.rows["occ"]

    @property
    def bits_sent(self):
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class FedBuffDevice(FedBuff):
    """Buffered asynchronous aggregation as a device round.

    The event simulation of :class:`FedBuff`: pop the earliest completion
    (a masked min on the device ring, the client id a 0-d tensor), run that
    client's K local steps, encode and decode its delta, buffer it, flush
    at the Z-th completion, send the restart model down, draw the client's
    next duration and push it back. The draws of a completion follow
    ``FedBuff._completion``: batch indices, the uplink key, the downlink
    key, then the duration. With ``completion_table`` (the seed bridge,
    built from the integer the first round draws) the duration is the
    table's ``(client, occurrence)`` entry, NaN once the table is
    exhausted, so the run walks the host FedBuff's events; without it a
    device Gamma(K, 1/λ) draw.

    The first round seeds the ring on the host side of the round
    (:meth:`begin`): it draws the integer ``FedBuff._seed`` draws, then the
    n initial durations (column 0 of the table, or device draws). The round
    engine calls :meth:`begin` before each chunk, outside the captured
    region; :meth:`device_round` is the captured body. A stateful uplink
    codec runs its stateless encode, as in the reference.

    With ``client_mesh`` the store is split over the ranks of the process
    group when the state is made: the ``start`` rows (and ``group``); the
    ``occ`` counters and ``lam`` stay whole. A completion all-gathers its
    client's start row from its owner and the owner writes the restart
    back; every rank runs the same completions on the same draws.
    """
    completion_table: Optional[np.ndarray] = None
    client_mesh: Any = None             # split the store over its ranks

    def __post_init__(self):
        super().__post_init__()
        self._table = (None if self.completion_table is None else
                       torch.as_tensor(np.asarray(self.completion_table,
                                                  np.float32),
                                       device=self.device))

    def init(self, params0) -> FedBuffDeviceState:
        server = tree_flatten_vector(params0).to(self.device)
        n = self.fed.n_clients
        pop = shard_population(build_population(
            self.fed, n, lam=self.lam, device=self.device,
            start=client_rows(server, n),
            occ=torch.zeros(n, dtype=torch.int64, device=self.device)),
            self.client_mesh)
        return FedBuffDeviceState(
            server=server, pop=pop, queue=ring_init(n, self.device),
            **counters0(self.device, torch.float32))

    def begin(self, state: FedBuffDeviceState, generator: torch.Generator
              ) -> FedBuffDeviceState:
        """Seed the ring on the first round; the state as it is after."""
        if state.live:
            return state
        n = self.fed.n_clients
        # the integer FedBuff._seed draws: the draws after it then line up
        # with the host FedBuff's, whose event rng it seeds (the table is
        # built from it)
        torch.randint(0, 2**31 - 1, (1,), generator=generator,
                      device=generator.device)
        if self._table is not None:
            times = self._table[:, 0].clone()
        else:
            times = completion_time_device(generator, self.fed.local_steps,
                                           state.pop.rows["lam"])
        queue = RingBuffer(times=times.to(torch.float32), clients=torch.arange(
            n, dtype=torch.int64, device=self.device))
        occ = torch.ones(n, dtype=torch.int64, device=self.device)
        return state._replace(pop=with_rows(state.pop, occ=occ), queue=queue,
                              live=True)

    def _duration(self, generator, i1, occ_i, lam_i):
        """Client i's next K-step duration, (1,): the table's entry (NaN
        past its end, so an exhausted bridge is loud), else a device
        draw."""
        if self._table is not None:
            last = self._table.shape[1] - 1
            val = self._table[i1, occ_i.clamp(max=last)]
            return torch.where(occ_i <= last, val, float("nan"))
        return completion_time_device(generator, self.fed.local_steps,
                                      lam_i)

    def device_round(self, state: FedBuffDeviceState, data,
                     generator: torch.Generator,
                     draws: Dict[str, Any] = None):
        """One server update: exactly ``buffer_size`` completions, every
        value on the device. Consumes ``state`` (its rows are updated in
        place). ``draws`` may supply the z-th completion's ``batch_idx``
        (Z, K, B), ``key_up`` and ``key_dn`` (:class:`MessageKey` of Z
        rows), as :class:`FedBuff`'s; the durations come from the table or
        the generator."""
        if not state.live:
            raise ValueError("fedbuff_device: the ring is not seeded; call "
                             "begin(state, generator) first (round does)")
        K, d, Z = self.fed.local_steps, self.d, self.buffer_size
        m = pool_size(data)
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}
        start, occ = state.pop.rows["start"], state.occ
        lam_row = state.pop.rows["lam"]
        queue, server, t_now = state.queue, state.server, state.sim_time
        buffer, errs = [], []
        for z in range(Z):
            queue, t_now, i = ring_pop(queue)
            i1 = i.reshape(1)
            if "batch_idx" in draws:
                bidx = draws["batch_idx"][z].long()
            else:
                bidx = torch.randint(0, m, (K, self.batch_size),
                                     generator=generator, device=self.device)
            start_i = take_rows(start, i1)[0]
            end = self._client_end(start_i, data, i1, bidx)
            delta = start_i - end
            if self._up_compressed:
                key = self._key(self.codec_up, draws, "key_up", z, generator)
                hint = torch.linalg.vector_norm(delta) + 1e-12
                msg = self.codec_up.encode(key, delta[None], hint[None])
                dq = self.codec_up.decode(
                    key, msg, torch.zeros((1, d), device=self.device))[0]
                errs.append(torch.linalg.vector_norm(dq - delta)
                            / (torch.linalg.vector_norm(delta) + 1e-12))
                delta = dq
            buffer.append(delta)
            if z == Z - 1:
                server = server - self.server_lr * torch.mean(
                    torch.stack(buffer), 0)
            if self._down_identity:
                restart = server
            else:
                key = self._key(self.codec_down, draws, "key_dn", z,
                                generator)
                hint_dn = torch.linalg.vector_norm(server - start_i) + 1e-12
                msg_dn = self.codec_down.encode(key, server[None],
                                                hint_dn[None])
                restart = self.codec_down.decode(key, msg_dn,
                                                 start_i[None])[0]
            put_rows(start, i1, restart[None])
            occ_i = occ.index_select(0, i1)
            dur = self._duration(generator, i1, occ_i,
                                 lam_row.index_select(0, i1))
            occ.index_put_((i1,), occ_i + 1)
            queue = ring_push(queue, t_now + dur, i)

        bits_up = Z * self.codec_up.message_bits(d)
        bits_down = Z * self.codec_down.message_bits(d)
        new_state = FedBuffDeviceState(
            server=server, pop=state.pop, queue=queue, sim_time=t_now,
            t=state.t + 1, bits_up=state.bits_up + bits_up,
            bits_down=state.bits_down + bits_down, live=True)
        metrics = {
            "sim_time": t_now,
            "round_time": t_now - state.sim_time,
            "bits_up": float(bits_up),
            "bits_down": float(bits_down),
            "h_steps_mean": float(K),
            "quant_err": (torch.mean(torch.stack(errs)) if errs else 0.0),
            "buffer_flushes": 1.0,
        }
        return new_state, metrics

    def round(self, state: FedBuffDeviceState, data,
              generator: torch.Generator, draws: Dict[str, Any] = None):
        """One buffer flush: :meth:`begin` (seeds the ring on the first
        round), then :meth:`device_round` (``draws`` as there)."""
        return self.device_round(self.begin(state, generator), data,
                                 generator, draws)

    # the legacy time-budget loop belongs to the host FedBuff only
    run = None
