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

import repro.compression.pipeline as ref_pipeline  # noqa: E402
from repro.fed.population import gather_rows  # noqa: E402


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


def reference_round_draws(alg, state, data, key, batch: int):
    """The values the reference ``QuAFL.round`` takes from its key splits
    (``core/quafl.py:237-252`` and ``pipeline._round_randomness``), as
    numpy: idx, h_steps, per-client per-step batch indices, signs, u_cl,
    u_srv."""
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
    sg, u_cl, u_srv = alg.pipeline._round_randomness(k_q, s, alg.d)
    return {"idx": npy(idx), "h_steps": npy(h_steps), "batch_idx": bidx,
            "signs": npy(sg), "u_cl": npy(u_cl), "u_srv": npy(u_srv)}


def test_alias_makes_reference_pipeline_importable():
    assert hasattr(ref_pipeline, "ExchangePipeline")
    assert jax.core.Primitive is jax.extend.core.Primitive
