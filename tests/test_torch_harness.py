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
    m = data["y"].shape[1]
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
    0)``, as the :class:`MessageKey`s of the codecs of ``port``."""
    k_q = jax.random.split(key, 4)[2]
    kq_cl = jax.random.split(jax.random.fold_in(k_q, 1), alg.fed.s)
    return {"key_up": message_key(port.codec_up, list(kq_cl), port.d),
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
    m = data["y"].shape[1]
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
    m = data["y"].shape[1]
    return {"batch_idx": tt(np.asarray(jax.random.randint(
                k_b, (batch,), 0, m))),
            "duration": tt(np.asarray(jax.random.exponential(k_t)
                                      / alg.fed.lam_slow))}


def test_alias_makes_reference_pipeline_importable():
    assert hasattr(ref_pipeline, "ExchangePipeline")
    assert jax.core.Primitive is jax.extend.core.Primitive
