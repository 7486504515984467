"""The mesh steps over a ``torch.distributed`` mesh (port of
``repro.launch.steps``): the train step, one QuAFL round, and the prefill
and serve steps, inference of the server model.

The QuAFL mapping onto the mesh:
  * client_dp — one client per data slice: client replicas are stacked on a
    leading 'clients' axis sharded over the mesh 'data' axis, each leaf's
    block over 'model' by the tensor-parallel rules.
  * cohort    — one client per POD (giant architectures): parameters are
    also sharded over 'data' (FSDP rules); without a 'pod' axis n_slots=1
    and QuAFL runs its s=1 instance (server + one cohort, still fully
    quantized).

One process per mesh position: rank r holds its client slot's block of
each leaf (by :func:`repro_torch.sharding.rules.pspec_for`) and the
server's block on the model axes. :class:`TrainState` holds those blocks.

A step is ONE server round of Algorithm 1: every client slot runs up to K
masked local SGD steps (H_i ~ min(K, Poisson(λ_i·Δt)), drawn inside the
step), both directions of the exchange are quantized, and the
(s+1)-averaging preserves the model mean. The model axis shards state and
exchange, not compute: the local steps all-gather each leaf over the
non-client axes, run the forward and backward whole on every model rank
of a client (each computes the same), and keep the rank's block of Y.
Tensor-parallel compute is later work (ROADMAP).

Two exchange families, by ``FedConfig.transport``:
  * ``shard_local`` / ``shard_local_codes`` / ``shard_local_rs`` — the
    shard-local exchange (:mod:`repro_torch.core.exchange_local`) on each
    rank's blocks, client sum by the named transport;
  * ``dequant_psum`` / ``code_allgather`` — whole leaves: each client
    encodes its full leaf of Y (every model rank the same message), the
    server decodes against X_t and sums over the client axis (an fp32
    all-reduce of the decoded messages, or an all-gather of the messages
    and a decode of each), then one Enc(X_t) that each client decodes
    against its current model; each rank keeps its blocks.

Randomness: the H-steps from the generator every rank holds seeded
alike; each leaf's exchange draws from the rank's :class:`ExchangeStreams`
(each stream a generator of its own, so a rank draws only what its blocks
need); or either injected through ``draws``.

The prefill and serve steps (:func:`build_prefill_step`,
:func:`build_serve_step`): each rank holds its blocks of the parameters by
``pspec_for`` under the client_dp rules, and its blocks of the batch and
of the cache by :func:`repro_torch.launch.specs.input_axes` and
:func:`~repro_torch.launch.specs.cache_axes`. A step all-gathers the
leaves (``Mesh.gather_leaf``), runs the model's ``forward`` or
``decode_step`` whole on every rank, and keeps the rank's blocks of what
it returns: the prefill the last position's fp32 logits (b, V), whole,
and the cache; the serve step the greedy next token and the cache. With
the shard_map MoE (``moe.impl == "ragged_shmap"``) they gather no expert
leaf over 'model': each rank runs its block of the expert-FFN dimension
and the partial sums meet in a psum (:mod:`repro_torch.models.moe`); the
train step gathers them whole, since the exchange takes whole leaves of Y.
Each call of a step with the shard_map MoE sets its mesh as the MoE's
(``models.moe.set_moe_mesh``).

Every step also runs abstractly, on ``meta`` tensors over an abstract mesh
(:func:`repro_torch.launch.mesh.make_abstract_mesh`, ``device="meta"``):
the exchange's streams are then :class:`MetaGenerator` s, whose draws have
the shapes of the real ones and no values (``launch/dryrun.py``).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.compression.codecs import resolve_codec
from repro_torch.compression.lattice import MessageKey
from repro_torch.compression.transports import (gather_message,
                                                transport_for_mode)
from repro_torch.configs.base import FedConfig, ModelConfig, ShapeConfig
from repro_torch.core.exchange_local import make_shardlocal_exchange
from repro_torch.fed.clock import client_speeds
from repro_torch.launch.specs import (abstract_cache, input_axes,
                                      input_specs)
from repro_torch.models.model import (abstract_lm, decode_step, forward,
                                      init_cache, init_lm, lm_loss)
from repro_torch.models.moe import set_moe_mesh
from repro_torch.sharding.rules import cut_block, pspec_for, rules_for_mode

# architectures too large for per-data-slice client replicas get cohort mode
FED_MODE: Dict[str, str] = {
    "llama4-scout-17b-a16e": "cohort",
    "deepseek-v2-236b": "cohort",
    "jamba-1.5-large-398b": "cohort",
    "llava-next-34b": "cohort",
}

SHARD_LOCAL = ("shard_local", "shard_local_codes", "shard_local_rs")
TRANSPORTS = ("dequant_psum", "code_allgather") + SHARD_LOCAL


def fed_mode_for(arch_name: str) -> str:
    return FED_MODE.get(arch_name, "client_dp")


def client_axis_for(fed_mode: str) -> str:
    return "pod" if fed_mode == "cohort" else "data"


class TrainState(NamedTuple):
    """This rank's blocks: ``server`` X_t (leaf -> block), ``clients`` its
    client slot's X^i (leaf -> (1, *block)), and the round ``t`` (int64)."""
    server: Dict[str, Any]
    clients: Dict[str, Any]
    t: torch.Tensor


def n_slots_for(mesh, fed_mode: str) -> int:
    if fed_mode == "cohort":
        return int(mesh.shape.get("pod", 1))
    return int(mesh.shape["data"])


# ---------------------------------------------------------------------------
# abstract state: which rank holds which block
# ---------------------------------------------------------------------------

def abstract_train_state(cfg: ModelConfig, mesh, fed_mode: str):
    """(state of meta tensors at the FULL shapes, state of specs): the
    server leaves, the clients' leaves with their leading (n_slots,) axis,
    and each leaf's spec, from which every rank cuts its block."""
    spec, axes = abstract_lm(cfg)
    n = n_slots_for(mesh, fed_mode)
    rules = rules_for_mode(fed_mode)
    cl_spec = {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                              device="meta") for k, v in spec.items()}
    srv_ps = {k: pspec_for(tuple(v.shape), axes[k], rules, mesh)
              for k, v in spec.items()}
    cl_ps = {k: pspec_for((n,) + tuple(v.shape), ("clients",) + tuple(axes[k]),
                          rules, mesh) for k, v in spec.items()}
    state = TrainState(server=spec, clients=cl_spec,
                       t=torch.empty((), dtype=torch.int64, device="meta"))
    return state, TrainState(server=srv_ps, clients=cl_ps, t=())


def rank_blocks(tree: Dict[str, torch.Tensor], specs: Dict[str, tuple],
                mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of every full leaf of ``tree`` (copies)."""
    coords = mesh.coords()
    return {k: cut_block(v, specs[k], mesh.shape, coords).clone()
            for k, v in tree.items()}


def shard_train_state(server, clients, t, mesh, specs: TrainState
                      ) -> TrainState:
    """A state of FULL leaves (server leaves, clients (n_slots, ...)) cut to
    this rank's blocks."""
    return TrainState(server=rank_blocks(server, specs.server, mesh),
                      clients=rank_blocks(clients, specs.clients, mesh),
                      t=torch.as_tensor(t, dtype=torch.int64).clone())


def init_train_state(cfg: ModelConfig, seed: int, n_slots: int,
                     device=None) -> TrainState:
    """Full leaves: the LM from ``seed`` as the server and every client
    (cut them to a rank's blocks with :func:`shard_train_state`)."""
    params, _ = init_lm(cfg, seed=seed, device=device)
    clients = {k: v[None].repeat((n_slots,) + (1,) * v.dim())
               for k, v in params.items()}
    dev = next(iter(params.values())).device
    return TrainState(server=params, clients=clients,
                      t=torch.zeros((), dtype=torch.int64, device=dev))


# ---------------------------------------------------------------------------
# the exchange's random streams
# ---------------------------------------------------------------------------

def stream_seed(seed: int, name: str) -> int:
    """The seed of stream ``name``: a hash of (seed, name) in [0, 2^63)."""
    h = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device, so the draws made
    from it (``device=generator.device``) are meta tensors of the real
    draws' shapes: an abstract step's randomness."""

    @property
    def device(self):
        return torch.device("meta")


def make_generator(device) -> torch.Generator:
    """A generator on ``device``; a :class:`MetaGenerator` on ``meta``."""
    if torch.device(device).type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device)


def shmap_moe(cfg: ModelConfig) -> bool:
    """True for the shard_map MoE ('ragged_shmap')."""
    return cfg.moe is not None and cfg.moe.impl == "ragged_shmap"


class ExchangeStreams:
    """The exchange's randomness on one rank: a generator per role, seeded
    from (``seed``, the stream's name), so every rank that shares a stream
    draws the same values and no rank draws another's. Each round takes
    each leaf's next values from them (leaves in sorted order).

    * shard-local family: ``"model"`` (stream ``model/<mid>``, one per
      model index: rotation signs, downlink noise, the generic pair's keys;
      the same on every client of the index) and ``"rank"``
      (``rank/<client>/<mid>``: uplink noise, the fused path's per-shard
      noise);
    * whole-leaf family: ``"client/<i>"`` (client i's uplink keys, the same
      on each of its model ranks) and ``"server"`` (the downlink key, the
      same everywhere)."""

    def __init__(self, seed: int, names: Dict[str, str], device):
        self.seed, self.names = seed, dict(names)
        self._gens = {r: make_generator(device) for r in self.names}
        self.reset()

    def reset(self) -> None:
        """Every stream back to its first value."""
        for role, g in self._gens.items():
            g.manual_seed(stream_seed(self.seed, self.names[role]))

    def generators(self):
        return tuple(self._gens.values())

    def __getitem__(self, role: str) -> torch.Generator:
        return self._gens[role]


def cat_keys(keys) -> MessageKey:
    """One MessageKey of the rows of ``keys``, in order."""
    return MessageKey(*(None if f[0] is None else torch.cat(f)
                        for f in zip(*keys)))


# ---------------------------------------------------------------------------
# train step (one QuAFL round)
# ---------------------------------------------------------------------------

class TrainStep:
    """``step(state, batch, generator=None, draws=None) -> (state,
    metrics)``: one QuAFL round on this rank. ``batch["tokens"]`` is the
    global (n_slots, K, b, t) batch, with ``batch["frontend"]`` (n_slots,
    K, b, F, d) for an encoder-decoder or frontend model (each rank reads
    its client's rows);
    ``draws`` may hold ``h_steps`` (n_slots,) and the exchange's draws:
    ``exchange`` (leaf -> this rank's shard-local draws, see
    :func:`~repro_torch.core.exchange_local.make_shardlocal_exchange`), or
    ``keys_up`` (leaf -> MessageKey of n_slots rows) and ``key_dn`` (leaf
    -> one row) for the whole-leaf family. Metrics: ``h_steps_mean`` and
    ``quant_err_sq`` (summed over leaves and clients, over n_slots). The
    exchange's own draws come from :attr:`streams`, seeded from ``seed``."""

    def __init__(self, cfg: ModelConfig, fed: FedConfig, mesh,
                 shape: ShapeConfig, *, fed_mode: str = None,
                 transport: str = None, quantized: bool = True,
                 device=None, seed: int = 0):
        self.cfg, self.fed, self.mesh = cfg, fed, mesh
        self.seed = seed
        self._streams = None
        self.fed_mode = fed_mode or fed_mode_for(cfg.name)
        self.transport = transport or fed.transport
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}; choose "
                             f"from {TRANSPORTS}")
        self.device = default_device(device)
        self.n_slots = n_slots_for(mesh, self.fed_mode)
        self.client_axis = client_axis_for(self.fed_mode)
        self.in_mesh = self.client_axis in mesh.shape
        # per-direction codecs: the legacy fed.quantizer map by default,
        # any registry codec via fed.codec_up / codec_down; quantized=False
        # forces the uncompressed identity pair. Stateful codecs use their
        # stateless encode (no residual buffers in the train state).
        name = None if quantized else "identity"
        self.quant_up = resolve_codec(name, fed, direction="up")
        self.quant_down = resolve_codec(name, fed, direction="down")
        n, K = self.n_slots, fed.local_steps
        lam = (client_speeds(fed, n) if n > 1
               else np.array([fed.lam_fast], np.float32))
        H = np.minimum(K, np.maximum(lam * (fed.swt + fed.sit), 1e-3))
        self.eta_i = ((H.min() / H) if fed.weighted
                      else np.ones(n)).astype(np.float32)
        self._rates = torch.as_tensor(lam * np.float32(fed.swt + fed.sit),
                                      device=self.device)
        self.state_spec, self.specs = abstract_train_state(cfg, mesh,
                                                           self.fed_mode)
        in_ax, rules = input_axes(cfg, shape), rules_for_mode(self.fed_mode)
        self.batch_spec = {
            k: pspec_for(tuple(v.shape), in_ax[k], rules, mesh)
            for k, v in input_specs(cfg, shape, n_slots=n,
                                    local_steps=K).items()}
        self._gather = self.transport == "code_allgather" and self.in_mesh
        self._slx = None
        if self.transport in SHARD_LOCAL and quantized:
            self._slx = make_shardlocal_exchange(
                self.quant_up, self.quant_down, mesh, self.client_axis, n,
                transport_for_mode(self.transport))

    @property
    def streams(self) -> ExchangeStreams:
        """This rank's exchange streams (made at first use)."""
        if self._streams is None:
            ci = self.client_index
            if self._slx is not None:
                mid = 0
                for a in self.mesh.axis_names:
                    if a != self.client_axis:
                        mid = (mid * self.mesh.shape[a]
                               + self.mesh.axis_index(a))
                names = {"model": f"model/{mid}",
                         "rank": f"rank/{ci}/{mid}"}
            else:
                # code_allgather decodes every client's message
                clients = range(self.n_slots) if self._gather else (ci,)
                names = {"server": "server",
                         **{f"client/{c}": f"client/{c}" for c in clients}}
            self._streams = ExchangeStreams(self.seed, names, self.device)
        return self._streams

    @property
    def client_index(self) -> int:
        return (self.mesh.axis_index(self.client_axis) if self.in_mesh
                else 0)

    def _full(self, block, spec):
        """A leaf gathered over the non-client axes."""
        return self.mesh.gather_leaf(block, spec, skip=self.client_axis)

    def client_leaves(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """This rank's client model, every leaf whole."""
        return {k: self._full(v, self.specs.clients[k])[0]
                for k, v in state.clients.items()}

    def server_leaves(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The server model, every leaf whole."""
        return {k: self._full(v, self.specs.server[k])
                for k, v in state.server.items()}

    def rank_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's client's rows of the global batch: ``tokens`` (K,
        b, t) and, for an encoder-decoder or frontend model,
        ``frontend`` (K, b, F, d)."""
        coords = self.mesh.coords()
        out = {}
        for k, spec in self.batch_spec.items():
            blk = cut_block(batch[k], spec, self.mesh.shape, coords)
            out[k] = self._full(blk, spec)[0]
        return out

    # -- local work -----------------------------------------------------
    def progress(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 h_i: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Y of this rank's client, every leaf whole: K masked SGD steps
        from X^i on ``batch`` (:meth:`rank_batch`'s: step q on the q-th
        rows of each entry), step q active iff q < ``h_i``, then Y =
        (1−η_i)·X^i + η_i·X_K."""
        fed, cfg = self.fed, self.cfg
        cp = self.client_leaves(state)
        p = {k: v.detach().clone() for k, v in cp.items()}
        keys = sorted(p)
        for q in range(fed.local_steps):
            leaves = {k: p[k].detach().requires_grad_(True) for k in keys}
            loss, _ = lm_loss(cfg, leaves,
                              {k: v[q] for k, v in batch.items()})
            grads = list(torch.autograd.grad(
                loss, [leaves[k] for k in keys], allow_unused=True))
            del loss, leaves
            lr_act = fed.lr * (h_i > q).to(torch.float32)
            for j, k in enumerate(keys):
                g, grads[j] = grads[j], None
                if g is not None:
                    p[k].sub_(lr_act * g.to(p[k].dtype))
                del g
        eta = float(self.eta_i[self.client_index])
        # Y = X − η·η_i·h̃ = (1−η_i)·X + η_i·X_K, written over X_K
        for k in keys:
            p[k].mul_(eta).add_(cp[k].to(torch.float32) * (1.0 - eta))
        return p

    # -- the exchange ---------------------------------------------------
    def exchange(self, state: TrainState, Ys: Dict[str, torch.Tensor],
                 draws=None):
        """(server blocks, client blocks, qerr) of the exchange of this
        rank's client's whole-leaf ``Ys``."""
        draws = draws or {}
        if self._slx is not None:
            coords = self.mesh.coords()
            yb = {k: cut_block(v, self.specs.clients[k][1:],
                               self.mesh.shape, coords)[None]
                  for k, v in Ys.items()}
            return self._slx(state.server, state.clients, yb, self.streams,
                             draws.get("exchange"))
        return self._leaf_exchange(state, Ys, draws)

    def _up_keys(self, d: int):
        """(this client's uplink key, every client's when the codes are
        gathered) from the client streams."""
        qu, ci, st = self.quant_up, self.client_index, self.streams
        if not self._gather:
            return qu.keys(st[f"client/{ci}"], 1, d), None
        keys = cat_keys([qu.keys(st[f"client/{c}"], 1, d)
                         for c in range(self.n_slots)])
        return keys.row(ci), keys

    def _leaf_exchange(self, state, Ys, draws):
        """The whole-leaf family: dequant_psum and code_allgather."""
        mesh, ax, n = self.mesh, self.client_axis, self.n_slots
        qu, qd = self.quant_up, self.quant_down
        ci, denom = self.client_index, n + 1
        gather = self._gather
        keys_up, keys_dn = draws.get("keys_up", {}), draws.get("key_dn", {})
        coords = mesh.coords()
        server_new, clients_new, qerr = {}, {}, None
        for k in sorted(state.server):
            srv = self._full(state.server[k], self.specs.server[k])
            cp = self._full(state.clients[k], self.specs.clients[k])[0]
            y = Ys[k]
            shape, d = tuple(srv.shape), int(srv.numel())
            ref = srv.to(torch.float32).reshape(1, d)
            y2 = y.to(torch.float32).reshape(1, d)
            key_all = keys_up.get(k)
            if key_all is None:
                key_own, key_all = self._up_keys(d)
            else:
                key_own = key_all.row(ci)
            # client -> server: Enc(Y^i), decoded against X_t
            hint = torch.linalg.vector_norm(y2 - cp.to(torch.float32)
                                            .reshape(1, d))
            msg = qu.encode(key_own, y2, (hint + 1e-12)[None])
            if gather:
                # every client's message to every rank, decoded there
                msgs = gather_message(mesh, msg, ax, qu)
                qys = qu.decode(key_all, msgs, ref)
                qy, qy_sum = qys[ci:ci + 1], torch.sum(qys, 0, keepdim=True)
                del qys, msgs
            else:
                qy = qu.decode(key_own, msg, ref)
                qy_sum = mesh.psum(qy, ax) if self.in_mesh else qy
            del msg
            srv_new = ((ref + qy_sum) / denom).reshape(shape).to(srv.dtype)
            del qy_sum
            qerr_k = torch.sum(torch.square(qy - y2))
            qerr = qerr_k if qerr is None else qerr + qerr_k
            # server -> clients: ONE Enc(X_t), decoded against each
            # client's current model
            h_dn = torch.linalg.vector_norm(qy - ref)
            if self.in_mesh:
                h_dn = mesh.pmax(h_dn, ax)
            del qy
            key_dn = keys_dn.get(k)
            if key_dn is None:
                key_dn = qd.keys(self.streams["server"], 1, d)
            msg_s = qd.encode(key_dn, ref, (2.0 * h_dn + 1e-12)[None])
            qx = qd.decode(key_dn, msg_s, cp.to(torch.float32).reshape(1, d))
            del msg_s, ref
            cl_new = (qx / denom + (denom - 1) * y2 / denom).reshape(
                (1,) + shape).to(cp.dtype)
            del qx, y2
            server_new[k] = cut_block(srv_new, self.specs.server[k],
                                      mesh.shape, coords).clone()
            clients_new[k] = cut_block(cl_new[0], self.specs.clients[k][1:],
                                       mesh.shape, coords)[None].clone()
            del srv_new, cl_new, srv, cp
        if self.in_mesh:
            qerr = mesh.psum(qerr, ax)
        # the leaves in the state's own order
        return ({k: server_new[k] for k in state.server},
                {k: clients_new[k] for k in state.server}, qerr / n)

    # -- one round ------------------------------------------------------
    def __call__(self, state: TrainState, batch, generator=None,
                 draws=None):
        if shmap_moe(self.cfg):
            set_moe_mesh(self.mesh)
        draws = draws or {}
        K = self.fed.local_steps
        h_steps = draws.get("h_steps")
        if h_steps is None:
            h_steps = torch.poisson(self._rates, generator=generator)
        h_steps = torch.clamp(h_steps.to(self.device), max=K).to(torch.int32)
        Ys = self.progress(state, self.rank_batch(batch),
                           h_steps[self.client_index])
        server, clients, qerr = self.exchange(state, Ys, draws)
        del Ys
        metrics = {"h_steps_mean": torch.mean(h_steps.to(torch.float32)),
                   "quant_err_sq": qerr}
        return TrainState(server=server, clients=clients,
                          t=state.t + 1), metrics


def build_train_step(cfg: ModelConfig, fed: FedConfig, mesh,
                     shape: ShapeConfig, *, fed_mode: str = None,
                     transport: str = None, quantized: bool = True,
                     device=None, seed: int = 0):
    """Returns ``(train_step, state_spec, specs)``: the
    :class:`TrainStep`, the state of meta tensors at full shapes, and
    ``(state specs, batch specs)``, the blocks each rank holds."""
    step = TrainStep(cfg, fed, mesh, shape, fed_mode=fed_mode,
                     transport=transport, quantized=quantized, device=device,
                     seed=seed)
    return step, step.state_spec, (step.specs, step.batch_spec)



# ---------------------------------------------------------------------------
# prefill / serve steps (inference of the server model)
# ---------------------------------------------------------------------------

def _leaf_specs(shapes: Dict[str, torch.Tensor], axes: Dict[str, tuple],
                mesh) -> Dict[str, tuple]:
    rules = rules_for_mode("client_dp")
    return {k: pspec_for(tuple(v.shape), axes[k], rules, mesh)
            for k, v in shapes.items()}


class _InferenceStep:
    """The blocks a rank holds of the parameters and of the cache at
    ``shape``, and the gathers and cuts between blocks and whole leaves."""

    def __init__(self, cfg: ModelConfig, mesh, shape: ShapeConfig):
        self.cfg, self.mesh, self.shape = cfg, mesh, shape
        spec, axes = abstract_lm(cfg)
        self.param_spec = spec
        self.param_specs = _leaf_specs(spec, axes, mesh)
        # the shard_map MoE takes the rank's expert-FFN blocks as they are
        self._skip = {}
        if shmap_moe(cfg):
            self._skip = {k: "model" for k, ax in axes.items()
                          if "expert_mlp" in ax}
        self.cache_spec, c_axes = abstract_cache(cfg, shape)
        self.cache_specs = _leaf_specs(self.cache_spec, c_axes, mesh)

    def _whole(self, blocks, specs):
        return {k: self.mesh.gather_leaf(v, specs[k],
                                         skip=self._skip.get(k, ()))
                for k, v in blocks.items()}

    def _blocks(self, tree, specs):
        coords = self.mesh.coords()
        return {k: cut_block(v, specs[k], self.mesh.shape, coords).clone()
                for k, v in tree.items()}


class PrefillStep(_InferenceStep):
    """``step(params, batch) -> (logits, cache)``: the prefill of this
    rank's blocks of the parameters and of ``batch["tokens"]`` (b, t) (and
    ``batch["frontend"]`` (b, F, d) for an encoder-decoder or frontend
    model), t (plus F for a frontend model) at most ``shape.seq_len``; the
    last position's fp32 logits (b, V), whole, and this rank's blocks of
    the ``seq_len``-deep cache. An encoder-decoder model's cross K/V are
    sized at F, the frontend given: the reference's prefill returns the
    K/V it computed, whatever length its cache had."""

    def __init__(self, cfg: ModelConfig, mesh, shape: ShapeConfig):
        super().__init__(cfg, mesh, shape)
        self.batch_specs = _leaf_specs(input_specs(cfg, shape),
                                       input_axes(cfg, shape), mesh)

    def __call__(self, params, batch):
        if shmap_moe(self.cfg):
            set_moe_mesh(self.mesh)
        p = self._whole(params, self.param_specs)
        whole = {k: self.mesh.gather_leaf(v, self.batch_specs[k])
                 for k, v in batch.items() if k in self.batch_specs}
        whole["tokens"] = whole["tokens"].long()
        enc = whole["frontend"].shape[1] if self.cfg.encdec else 0
        cache = init_cache(self.cfg, whole["tokens"].shape[0],
                           self.shape.seq_len, whole["tokens"].device,
                           enc_len=enc)
        logits, cache, _ = forward(self.cfg, p, whole, cache=cache,
                                   write_pos=0)
        del p
        last = logits[:, -1].clone()   # the (b, t, V) logits freed here
        del logits
        return last, self._blocks(cache, self.cache_specs)


class ServeStep(_InferenceStep):
    """``step(params, cache, token, pos) -> (next_token, cache)``: one
    greedy decode step from this rank's blocks of the parameters, the
    cache and ``token`` (b, 1) at absolute position ``pos`` (a frontend
    model's frontend positions included); the rank's blocks of the next
    token (int32) and of the cache. An encoder-decoder model's cross K/V
    ride in the cache at the length its prefill gave them."""

    def __init__(self, cfg: ModelConfig, mesh, shape: ShapeConfig):
        super().__init__(cfg, mesh, shape)
        self.token_spec = pspec_for((shape.global_batch, 1),
                                    ("batch", None),
                                    rules_for_mode("client_dp"), mesh)
        self.pos_spec = ()

    def __call__(self, params, cache, token, pos):
        if shmap_moe(self.cfg):
            set_moe_mesh(self.mesh)
        p = self._whole(params, self.param_specs)
        c = self._whole(cache, self.cache_specs)
        tok = self.mesh.gather_leaf(token, self.token_spec).long()
        logits, c = decode_step(self.cfg, p, tok, int(pos), c)
        del p
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        coords = self.mesh.coords()
        return (cut_block(nxt, self.token_spec, self.mesh.shape,
                          coords).clone(),
                self._blocks(c, self.cache_specs))


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """Returns ``(prefill_step, param_spec, (param specs, batch specs))``:
    the :class:`PrefillStep`, the parameters as meta tensors at full
    shapes, and the blocks each rank holds (cut them with
    :func:`rank_blocks`)."""
    step = PrefillStep(cfg, mesh, shape)
    return step, step.param_spec, (step.param_specs, step.batch_specs)


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """One-token decode against a ``seq_len``-deep cache: ``(serve_step,
    param_spec, cache_spec, (param specs, cache specs, token spec, pos
    spec))``, the :class:`ServeStep`, the parameters and the cache as meta
    tensors at full shapes, and the blocks each rank holds."""
    step = ServeStep(cfg, mesh, shape)
    return step, step.param_spec, step.cache_spec, (
        step.param_specs, step.cache_specs, step.token_spec, step.pos_spec)
