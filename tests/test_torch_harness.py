"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Importing this module makes the JAX reference importable under jax 0.9,
which moved ``ClosedJaxpr``, ``Jaxpr``, ``Literal`` and ``Primitive`` out of
``jax.core`` while ``repro.analysis`` (pulled in by
``repro.compression.pipeline``) still reads them there: the four names are
aliased from ``jax.extend.core`` onto ``jax.core`` before any ``repro``
import. Only the tests do this; no file of either package changes.

Inputs are made with numpy from a seed and handed to both sides; JAX stays
on the CPU and arrays cross as numpy.
"""
import jax
import jax.core
import jax.extend.core

for _name in ("ClosedJaxpr", "Jaxpr", "Literal", "Primitive"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import repro.compression.pipeline as ref_pipeline  # noqa: E402
from repro.compression.rotation import _signs as ref_signs  # noqa: E402
from repro.fed.population import gather_rows  # noqa: E402
from repro_torch.compression.codecs import ScalarCodec  # noqa: E402
from repro_torch.compression.lattice import MessageKey  # noqa: E402
from repro_torch.compression.rotation import pad_len  # noqa: E402
from repro_torch.utils import interop  # noqa: E402
from lattice_log import LatticeLog  # noqa: E402,F401


def pool_size(data) -> int:
    """Rows per client of per-client datasets, (n, m, ...) leaves: the
    classification task's ``x`` and ``y``, or the LM task's ``tokens``."""
    return int(next(iter(data.values())).shape[1])


def tt(a, dtype=None) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def npy(x) -> np.ndarray:
    """A tensor or JAX array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gauss(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def uniform(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def signs_np(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(
        np.array([-1.0, 1.0], np.float32), size=n)


def circular_gap(a: np.ndarray, b: np.ndarray, levels) -> np.ndarray:
    """|a − b| on the ring Z_L, elementwise."""
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return np.minimum(diff, np.asarray(levels, np.int64) - diff)


class StepLog:
    """A codec that records the quantization step of every message it
    encodes: γ for lattice codecs, ‖x‖/levels for ``scalar``, nothing for
    ``identity``."""

    def __init__(self, codec):
        self.codec = codec
        self.steps = [0.0]

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def encode(self, key, x, hint=None):
        msg = self.codec.encode(key, x, hint)
        div = (self.codec.quant.levels if isinstance(self.codec, ScalarCodec)
               else 1)
        if msg.gamma.numel() and self.codec.name != "identity":
            self.steps.append(float(msg.gamma.max()) / div)
        return msg


def port_quafl_state(state):
    """A reference ``QuaflState`` as the port's, on the CPU."""
    return interop.quafl_state_from_numpy(
        server=npy(state.server),
        rows={k: npy(v) for k, v in state.pop.rows.items()},
        t=int(state.t), sim_time=float(state.sim_time),
        bits_up=float(state.bits_up), bits_down=float(state.bits_down),
        srv_dist_est=npy(state.srv_dist_est), device="cpu")


def reference_round_draws(alg, state, data, key, batch: int):
    """The values the reference ``QuAFL.round`` takes from its key splits
    (``core/quafl.py:237-252`` and ``pipeline._round_randomness``), as
    numpy: idx, h_steps, per-client per-step batch indices, and, on the
    pipeline branch, signs, u_cl, u_srv (the per-message branch's keys:
    :func:`reference_message_keys`)."""
    fed = alg.fed
    n, s, K = fed.n_clients, fed.s, fed.local_steps
    k_sel, k_h, k_q, k_loc = jax.random.split(key, 4)
    idx = alg.part.sample(k_sel, state.t, n, s, state.pop.rows["lam"])
    got = gather_rows(state.pop, idx)
    elapsed = state.sim_time + fed.swt + fed.sit - got["last_time"]
    h_steps = alg.part.h_steps(k_h, idx, got["lam"], elapsed, K)
    m = pool_size(data)
    keys = jax.random.split(k_loc, s)
    bidx = np.stack([np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(keys[i], q), (batch,), 0, m)) for q in range(K)])
        for i in range(s)])
    out = {"idx": npy(idx), "h_steps": npy(h_steps), "batch_idx": bidx}
    if alg.pipeline is not None:
        sg, u_cl, u_srv = alg.pipeline._round_randomness(k_q, s, alg.d)
        out.update(signs=npy(sg), u_cl=npy(u_cl), u_srv=npy(u_srv))
    return out


def reference_message_keys(alg, key, port):
    """The per-message branch's codec randomness of the reference
    ``QuAFL.round`` (``core/quafl.py:277``, ``:296``): the uplink keys
    ``split(fold_in(k_q, 1), s)`` and the downlink key ``fold_in(k_q,
    0)``, as the :class:`MessageKey`s of the codecs of ``port``; and
    ``key_ctl``, the control messages' keys ``fold_in(kq_cl[i], 17)`` of
    ``QuaflScaffold.round`` (``core/extensions.py:121``)."""
    k_q = jax.random.split(key, 4)[2]
    kq_cl = jax.random.split(jax.random.fold_in(k_q, 1), alg.fed.s)
    return {"key_up": message_key(port.codec_up, list(kq_cl), port.d),
            "key_ctl": message_key(port.codec_up,
                                   [jax.random.fold_in(k, 17)
                                    for k in kq_cl], port.d),
            "key_dn": message_key(port.codec_down,
                                  [jax.random.fold_in(k_q, 0)], port.d)}


def _batch_idx(key, K: int, batch: int, m: int) -> np.ndarray:
    """(K, B) indices of the reference's ``client_batch`` under
    ``fold_in(key, q)``, q = 0..K-1."""
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, q), (batch,), 0, m)) for q in range(K)])


def message_key(codec, keys, d: int) -> MessageKey:
    """The draws the reference codec takes from each of ``keys`` (one key
    per message), as the port codec's batched :class:`MessageKey`: for the
    lattice quantizer ``krot, krnd = split(key)``, signs from ``krot`` and
    u from ``krnd`` (``lattice.py:90-92``); for QSGD u from the key itself;
    nothing for identity."""
    if getattr(codec, "family", "") == "lattice":
        d_pad = pad_len(d, codec.block)
        sg, u = [], []
        for k in keys:
            krot, krnd = jax.random.split(k)
            sg.append(npy(ref_signs(krot, d_pad)))
            u.append(npy(jax.random.uniform(krnd, (d_pad,), jnp.float32)))
        return MessageKey(tt(np.stack(sg)), tt(np.stack(u)))
    if codec.name == "scalar":
        return MessageKey(u=tt(np.stack([npy(jax.random.uniform(
            k, (d,), jnp.float32)) for k in keys])))
    return MessageKey()


def reference_fedavg_draws(alg, state, data, key, batch: int, port):
    """The values the reference ``FedAvg.round`` / ``CompressedFedAvg.
    round`` take from their key splits (``core/fedavg.py:131-171``,
    ``:259-283``): idx, (s, K, B) batch indices, the sampled clients'
    K-step durations, and the uplink (s) and downlink (1) message keys for
    the codecs of ``port``."""
    fed = alg.fed
    n, s, K = fed.n_clients, fed.s, fed.local_steps
    k_sel, k_loc, k_t = jax.random.split(key, 3)
    k_q = jax.random.fold_in(key, 17)
    idx = alg.part.sample(k_sel, state.t, n, s, state.pop.rows["lam"])
    m = pool_size(data)
    keys = jax.random.split(k_loc, s)
    bidx = np.stack([_batch_idx(keys[i], K, batch, m) for i in range(s)])
    lam = state.pop.rows["lam"][idx]
    durations = jax.random.gamma(k_t, K * jnp.ones((s,))) / lam
    kq_cl = jax.random.split(jax.random.fold_in(k_q, 1), s)
    return {"idx": tt(npy(idx)), "batch_idx": tt(bidx),
            "durations": tt(npy(durations)),
            "key_up": message_key(port.codec_up, list(kq_cl), port.d),
            "key_dn": message_key(port.codec_down,
                                  [jax.random.fold_in(k_q, 0)], port.d)}


def reference_fedbuff_draws(alg, state, key, batch: int, m: int, port):
    """The draws of the reference ``FedBuff.round``'s next ``buffer_size``
    completions (``core/fedbuff.py:166-225``): the event seed on the first
    round, then per completion ``jkey, sub = split(jkey)`` for the batches,
    ``jkey, qk = split(jkey)`` for the uplink message key (compressed
    uplinks only) and ``jkey, dk = split(jkey)`` for the downlink one
    (compressed downlinks only)."""
    K = alg.fed.local_steps
    draws = {}
    if state.rng is None:
        draws["event_seed"] = int(jax.random.randint(key, (), 0,
                                                     2**31 - 1))
        jkey = key
    else:
        jkey = state.jkey
    bidx, kq, kd = [], [], []
    for _ in range(alg.buffer_size):
        jkey, sub = jax.random.split(jkey)
        bidx.append(_batch_idx(sub, K, batch, m))
        if alg._up_compressed:
            jkey, qk = jax.random.split(jkey)
            kq.append(qk)
        if not alg._down_identity:
            jkey, dk = jax.random.split(jkey)
            kd.append(dk)
    draws["batch_idx"] = tt(np.stack(bidx))
    if kq:
        draws["key_up"] = message_key(port.codec_up, kq, port.d)
    if kd:
        draws["key_dn"] = message_key(port.codec_down, kd, port.d)
    return draws


def reference_sequential_draws(alg, data, key, batch: int):
    """``Sequential.round``'s batch of client 0 and its Exp(λ_slow) step
    time (``core/baseline.py:55-60``)."""
    k_b, k_t = jax.random.split(key)
    m = pool_size(data)
    return {"batch_idx": tt(np.asarray(jax.random.randint(
                k_b, (batch,), 0, m))),
            "duration": tt(np.asarray(jax.random.exponential(k_t)
                                      / alg.fed.lam_slow))}


def test_alias_makes_reference_pipeline_importable():
    assert hasattr(ref_pipeline, "ExchangePipeline")
    assert jax.core.Primitive is jax.extend.core.Primitive


# ---------------------------------------------------------------------------
# the mesh train step (repro.launch.steps / repro.core.exchange_local)
# ---------------------------------------------------------------------------

def reference_step_draws(step, key_raw, coords, exchange_key=None):
    """The values the reference ``build_train_step``'s step takes from its
    key (``launch/steps.py:182-192``) for the rank at mesh ``coords`` of the
    port's ``step`` (a :class:`repro_torch.launch.steps.TrainStep`), as its
    ``draws``: ``h_steps``; then for the shard-local family each leaf's
    ``signs``, ``u_up``, ``u_dn`` (and ``u_rs`` on the fused reduce-scatter
    path) folded as ``exchange_local.py:112-148, 207-214`` fold them (the
    leaf name, the model index, the client index), or the generic pair's
    ``key_up`` / ``key_dn``; for the whole-leaf family each leaf's uplink
    keys ``fold_in_str(split(fold_in(k_q, 1), n)[i], leaf)`` and the
    downlink key ``fold_in_str(fold_in(k_q, n + 7), leaf)``. With
    ``exchange_key`` (the raw key the reference's shard-local exchange is
    called with directly) only that exchange's draws."""
    from repro.core.quafl import client_speeds as ref_speeds
    from repro.utils.tree import fold_in_str
    from repro_torch.compression.transports import _shardable
    from repro_torch.sharding.rules import block_shape
    fed, n, mesh_shape = step.fed, step.n_slots, step.mesh.shape
    K = fed.local_steps
    full = step.state_spec.server
    qu, qd = step.quant_up, step.quant_down
    draws = {}
    if exchange_key is None:
        key = jax.random.wrap_key_data(jnp.asarray(key_raw))
        k_h, k_q, _ = jax.random.split(key, 3)
        lam = ref_speeds(fed, n) if n > 1 else np.array([fed.lam_fast],
                                                        np.float32)
        h = jnp.minimum(jax.random.poisson(
            k_h, jnp.asarray(lam) * (fed.swt + fed.sit), (n,)), K)
        draws["h_steps"] = tt(npy(h.astype(jnp.int32)))
        kx = jax.random.fold_in(k_q, 3)
    else:
        kx = jax.random.wrap_key_data(jnp.asarray(exchange_key))
    if step._slx is None:
        q_keys = jax.random.split(jax.random.fold_in(k_q, 1), n)
        k_srv = jax.random.fold_in(k_q, n + 7)
        draws["keys_up"] = {k: message_key(
            qu, [fold_in_str(q_keys[i], k) for i in range(n)],
            int(full[k].numel())) for k in full}
        draws["key_dn"] = {k: message_key(qd, [fold_in_str(k_srv, k)],
                                          int(full[k].numel()))
                           for k in full}
        return draws
    axis = step.client_axis
    model_axes = [a for a in mesh_shape if a != axis]
    mid = 0
    for a in model_axes:
        mid = mid * mesh_shape[a] + coords[a]
    ci = coords.get(axis, 0) if axis in mesh_shape else 0
    n_cl = mesh_shape.get(axis, 1)
    lattice = getattr(qu, "family", "") == "lattice" and getattr(
        qd, "family", "") == "lattice"
    ex = {}
    for k, v in full.items():
        numel = int(np.prod(block_shape(v.shape, step.specs.server[k],
                                        mesh_shape)))
        d = numel + (-numel) % 1024
        kk = jax.random.fold_in(fold_in_str(kx, k), mid)
        k_up, k_dn = jax.random.fold_in(kk, 1), jax.random.fold_in(kk, 2)
        if not lattice:
            ex[k] = {"key_up": message_key(qu, [k_up], d),
                     "key_dn": message_key(qd, [k_dn], d)}
            continue
        d_pad = pad_len(d, qu.block)
        r = {"signs": tt(npy(ref_signs(jax.random.split(k_up)[0], d_pad))),
             "u_up": tt(npy(jax.random.uniform(
                 jax.random.fold_in(jax.random.split(k_up)[1], ci),
                 (1, d_pad), jnp.float32))),
             "u_dn": tt(npy(jax.random.uniform(
                 jax.random.split(k_dn)[1], (1, d_pad), jnp.float32)))}
        if (step.transport == "shard_local_rs" and axis in mesh_shape
                and _shardable(d_pad, n_cl, qd.wire(), qu.block)):
            r["u_rs"] = tt(npy(jax.random.uniform(
                jax.random.fold_in(jax.random.split(k_dn)[0], ci),
                (1, d_pad // n_cl), jnp.float32)))
        ex[k] = r
    draws["exchange"] = ex
    return draws


def _rotated(call):
    """y/γ + u of a recorded call, by the reference's rotation."""
    be = ref_pipeline.get_backend("jnp")
    y = call["x"]
    if call["kind"] == "encode":
        y = np.asarray(be.rotate(jnp.asarray(y), jnp.asarray(call["signs"]),
                                 block=call["kw"]["block"]))
    return y / call["gam"].reshape(-1, 1) + call["u"]


def lattice_flips(call, boundary: float = 1e-3) -> int:
    """The codes of a recorded call that differ from the reference's
    encode (or quantize) of the same inputs; every difference is asserted
    ±1 mod L where y/γ + u lies within ``boundary`` of an integer."""
    be = ref_pipeline.get_backend("jnp")
    kw = call["kw"]
    bits, pack, block = kw["bits"], kw.get("pack", 1), kw["block"]
    assert pack == 1 and kw.get("levels2") is None
    args = [jnp.asarray(call["x"]), jnp.asarray(call["u"]),
            jnp.asarray(call["gam"])]
    if call["kind"] == "encode":
        ref = be.encode(args[0], jnp.asarray(call["signs"]), *args[1:],
                        bits=bits, block=block, want_rotated=False,
                        pack=pack)
    else:
        ref = be.quantize(*args, bits=bits, block=block, pack=pack)
    ref = np.asarray(ref)
    diff = call["codes"] != ref
    if diff.any():
        assert circular_gap(call["codes"], ref, 1 << bits)[diff].max() == 1
        t = _rotated(call)
        assert np.abs(t - np.round(t))[diff].max() < boundary
    return int(diff.sum())


def lattice_candidates(call, eps: float = 1e-4) -> int:
    """Places where y/γ + u lies within ``eps`` of an integer: the only
    places a code can round the other way when y differs in its last
    bits."""
    t = _rotated(call)
    return int((np.abs(t - np.round(t)) < eps).sum())


def leaf_stats(log: LatticeLog, leaves, count) -> dict:
    """``{leaf: {"up"|"rs"|"down": (count(call), max γ, γ a unit of
    hint)}}`` of one exchange's recorded calls (``count`` is
    :func:`lattice_flips` or :func:`lattice_candidates`). The last, the
    wrap window's slope at the call's padded length and width (safety 8),
    turns a γ back into its hint."""
    from repro_torch.compression.pipeline import wrap_gamma

    def slope(c):
        kw = c["kw"]
        return float(wrap_gamma(torch.tensor(1.0), c["x"].shape[-1],
                                bits=kw["bits"], block=kw["block"],
                                safety=8.0))
    return {k: {part: (count(c), float(c["gam"].max()), slope(c))
                for part, c in g.items() if c is not None}
            for k, g in log.by_leaf(leaves).items()}


def flip_slack(stats, n_slots: int, srv_scale, cl_scale):
    """What the counted code changes can move, from :func:`leaf_stats` of
    every rank, per leaf (L2, so also elementwise):
    * the server: γ/(n+1) for each changed uplink or redistribution code;
      and, on the reduce-scatter path, its γ's rescaling by the uplink's
      shift of its hint, times ``srv_scale[leaf]`` (max |X|);
    * the clients: γ/(n+1) for each changed downlink code; and the
      downlink γ's rescaling — its hint is the decoded uplink's distance to
      X_t, which each changed uplink code shifts by up to γ_up — times
      ``cl_scale[leaf]``;
    and ``quant_err_sq``'s change: at most 4γ²/n a changed uplink code."""
    denom = n_slots + 1
    shift, srv, cl, qerr = {}, {}, {}, 0.0
    h_dn, h_rs = {}, {}
    for st in stats:
        for k, parts in st.items():
            up, dn, rs = parts["up"], parts["down"], parts.get("rs")
            shift[k] = shift.get(k, 0.0) + up[0] * up[1]
            srv[k] = srv.get(k, 0.0) + up[0] * up[1] / denom
            cl[k] = cl.get(k, 0.0) + dn[0] * dn[1] / denom
            h_dn[k] = min(h_dn.get(k, np.inf), dn[1] / dn[2])
            if rs is not None:
                srv[k] += rs[0] * rs[1] / denom
                h_rs[k] = min(h_rs.get(k, np.inf), rs[1] / rs[2])
            qerr += up[0] * 4 * up[1] ** 2 / n_slots
    for k in srv:
        cl[k] += cl_scale[k] * 2 * shift[k] / h_dn[k]
        if k in h_rs:
            srv[k] += srv_scale[k] * shift[k] / h_rs[k]
    return srv, cl, qerr
