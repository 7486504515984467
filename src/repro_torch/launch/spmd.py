"""The mesh train step behind the federated-algorithm protocol (port of
``repro.launch.spmd``).

:class:`SpmdAlgorithm` (registry name ``"spmd"``) wraps
:class:`~repro_torch.launch.steps.TrainStep` so that mesh training runs
through ``make_algorithm`` and ``simulate`` like every other algorithm, in
the same trace format, and through the round engine's chunks
(``simulate(..., scan_chunk=K)``): its ``device_round`` keeps every value
that changes between rounds in a tensor on the rank's device.

Mapping notes:
  * one client per mesh slot — ``n_slots`` comes from the mesh (the 'data'
    axis, or 'pod' in cohort mode), NOT from ``fed.n_clients``; ``data``
    (the per-client token pools of
    :func:`repro_torch.data.synthetic.federated_token_task`) must hold at
    least ``n_slots`` clients, and the first ``n_slots`` are used.
  * every rank runs the same program on its own blocks, with a generator
    seeded alike on every rank: each round samples every slot's (K, b)
    minibatch rows from its pool, then the step's H-steps, so all ranks
    draw the same values; the exchange draws from the rank's own streams
    (:class:`~repro_torch.launch.steps.ExchangeStreams`, seeded from
    ``seed``, back to their start at each ``init``), which the round
    engine registers with its graphs (:meth:`SpmdAlgorithm.generators`).
  * the clock is QuAFL's: every round lasts ``swt + sit`` simulated
    seconds; H_i is drawn inside the step.
  * bits are QuAFL's: n quantized uplink messages (``n·tree_bits(up)``)
    plus ONE downlink broadcast (``tree_bits(down)``), plus the
    transport's gathered side-channel rows or coded re-gather
    (``Transport.extra_bits_down`` per leaf at the mesh's slot count)
    charged into ``bits_down``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import default_device
from repro_torch.compression.codecs import IdentityCodec, resolve_codec
from repro_torch.compression.transports import transport_for_mode
from repro_torch.configs.base import FedConfig, ModelConfig, ShapeConfig
from repro_torch.core.transport import tree_bits
from repro_torch.fed.api import counters0
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (TrainState, TrainStep, fed_mode_for,
                                      n_slots_for)
from repro_torch.sharding.rules import cut_block


class SpmdState(NamedTuple):
    """This rank's train state + the clock and bit counters of the schema
    (``sim_time`` and the bits fp64, as every port state's)."""
    train: TrainState
    sim_time: torch.Tensor
    bits_up: torch.Tensor
    bits_down: torch.Tensor

    @property
    def bits_sent(self):
        return self.bits_up + self.bits_down


@dataclass(eq=False)
class SpmdAlgorithm:
    """Registry name ``"spmd"``. Needs ``cfg`` (the ModelConfig whose params
    ``init`` / ``round`` operate on); ``mesh`` defaults to the (1, 1)
    data×model mesh: the local instance without a process group, over it
    when ``torch.distributed`` is initialised (a group of one)."""
    fed: FedConfig
    template: Any                      # params dict (shapes only)
    cfg: ModelConfig = None
    mesh: Any = None
    batch: int = 2                     # per-client microbatch rows
    seq: int = 32
    fed_mode: Optional[str] = None
    transport: Optional[str] = None
    device: Any = None                 # None = the card
    seed: int = 0                      # the exchange streams' seed

    def __post_init__(self):
        if self.cfg is None:
            raise ValueError("SpmdAlgorithm needs cfg=<ModelConfig> (pass "
                             "it through make_algorithm('spmd', ..., "
                             "cfg=...))")
        if self.cfg.frontend:
            raise NotImplementedError("spmd registry path covers token-only "
                                      "architectures (no frontend batches)")
        self.device = default_device(self.device)
        if self.mesh is None:
            self.mesh = make_mesh((1, 1), ("data", "model"))
        self.fed_mode = self.fed_mode or fed_mode_for(self.cfg.name)
        self.n_slots = n_slots_for(self.mesh, self.fed_mode)
        shape = ShapeConfig("spmd", self.seq, self.batch * self.n_slots,
                            "train")
        # per-direction codecs drive both the step and the wire accounting
        self.codec_up = resolve_codec(None, self.fed, direction="up")
        self.codec_down = resolve_codec(None, self.fed, direction="down")
        quantized = not (isinstance(self.codec_up, IdentityCodec)
                         and isinstance(self.codec_down, IdentityCodec))
        self._step = TrainStep(self.cfg, self.fed, self.mesh, shape,
                               fed_mode=self.fed_mode,
                               transport=self.transport, quantized=quantized,
                               device=self.device, seed=self.seed)
        self._specs = self._step.specs
        self._bits_up_msg = tree_bits(self.codec_up, self.template)
        self._bits_down_msg = tree_bits(self.codec_down, self.template)
        # the transport's redistribution payload (gathered γ/levels rows,
        # or the fused reduce_scatter's coded shard re-gather) is downlink
        # traffic the per-message codec math cannot see: charged per leaf
        # at the mesh's slot count (0 on the (1, 1) mesh)
        tr = transport_for_mode(self.transport or self.fed.transport)
        self._extra_bits_down = 0
        if tr is not None:
            self._extra_bits_down = sum(
                tr.extra_bits_down(self.codec_up, self.codec_down,
                                   int(v.numel()), self.n_slots)
                for v in self.template.values())
        # the ranks' server blocks partition each leaf over the non-client
        # axes; a leaf replicated along such an axis counts once
        axis = self._step.client_axis
        coords = self.mesh.coords()
        self._model_axes = tuple(a for a in self.mesh.axis_names
                                 if a != axis)
        self._counts = {
            k: all(coords[a] == 0 for a in self._model_axes if a not in sp)
            for k, sp in self._specs.server.items()}

    # ------------------------------------------------------------------
    def init(self, params0) -> SpmdState:
        """This rank's blocks of ``params0`` as the server and its client
        (fresh copies: the state never aliases the caller's params); the
        exchange streams back to their start."""
        self._step.streams.reset()
        coords, shape = self.mesh.coords(), self.mesh.shape
        server = {k: cut_block(v, self._specs.server[k], shape, coords)
                  .to(self.device, copy=True) for k, v in params0.items()}
        clients = {k: cut_block(v, self._specs.clients[k][1:], shape,
                                coords)[None].to(self.device, copy=True)
                   for k, v in params0.items()}
        c = counters0(self.device)
        return SpmdState(train=TrainState(server=server, clients=clients,
                                          t=c["t"]),
                         sim_time=c["sim_time"], bits_up=c["bits_up"],
                         bits_down=c["bits_down"])

    def generators(self):
        """The generators a round draws from besides the caller's: the
        rank's exchange streams."""
        return self._step.streams.generators()

    def device_round(self, state: SpmdState, data, generator,
                     draws=None):
        """One mesh round: sample each slot's (K, b) microbatch rows from
        its token pool (``draws["rows"]`` (n, K, b) injects them), run the
        step (its draws injectable as :class:`TrainStep`'s), standardize
        the metrics."""
        fed = self.fed
        draws = draws or {}
        n, K = self.n_slots, fed.local_steps
        tokens = data["tokens"]
        rows = draws.get("rows")
        if rows is None:
            rows = torch.randint(0, tokens.shape[1], (n, K, self.batch),
                                 generator=generator, device=tokens.device)
        slots = torch.arange(n, device=tokens.device)[:, None, None]
        toks = tokens[slots, rows.to(tokens.device)]
        train, m = self._step(state.train, {"tokens": toks}, generator,
                              draws)

        # QuAFL bit accounting: n uplink messages, one downlink broadcast,
        # plus the transport's gathered side-channel rows / coded re-gather
        bits_up = n * self._bits_up_msg
        bits_down = self._bits_down_msg + self._extra_bits_down
        dt = fed.swt + fed.sit
        new_time = state.sim_time + dt
        # schema quant_err: RMS decode error relative to the server norm
        # (the step measures the squared error summed over leaves)
        srv_sq = sum(torch.sum(torch.square(v.to(torch.float32)))
                     * float(self._counts[k])
                     for k, v in train.server.items())
        srv_sq = self.mesh.psum(srv_sq, self._model_axes)
        rel = torch.sqrt(m["quant_err_sq"]) / (torch.sqrt(srv_sq) + 1e-12)
        metrics = {
            "sim_time": new_time,
            "round_time": float(dt),
            "bits_up": float(bits_up),
            "bits_down": float(bits_down),
            "h_steps_mean": m["h_steps_mean"],
            "quant_err": rel,
            "quant_err_sq": m["quant_err_sq"],
        }
        return SpmdState(train=train, sim_time=new_time,
                         bits_up=state.bits_up + bits_up,
                         bits_down=state.bits_down + bits_down), metrics

    def round(self, state: SpmdState, data, generator, draws=None):
        return self.device_round(state, data, generator, draws)

    def eval_params(self, state: SpmdState):
        """The server, every leaf whole (a gather over the model axes: every
        rank calls it)."""
        return self._step.server_leaves(state.train)
