"""Shared simulation clock (port of the QuAFL half of ``repro.fed.clock``):
client speeds and the lazy H-step draws.

Per-step durations are Exp(λ_i) with λ from a fast/slow split (paper
App. A). QuAFL polls s clients per round and lazily replays the
``min(K, Poisson(λ_i · elapsed))`` local steps each would have completed
since its last interaction (App. B.1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FedConfig


def client_speeds(fed: FedConfig, n: int) -> np.ndarray:
    """λ per client: the first ``slow_frac``·n clients are slow."""
    lam = np.full(n, fed.lam_fast, dtype=np.float32)
    n_slow = int(round(fed.slow_frac * n))
    lam[:n_slow] = fed.lam_slow
    return lam


def speeds_for(fed: FedConfig, n: int, uniform: bool = False) -> np.ndarray:
    """Speed vector, optionally forcing every client to the fast rate."""
    if uniform:
        return np.full(n, fed.lam_fast, np.float32)
    return client_speeds(fed, n)


def expected_steps(fed: FedConfig, lam: np.ndarray) -> np.ndarray:
    """H_i = E[steps between interactions], capped at K: between
    interactions a client has ≈ n/s · (swt+sit) time in expectation."""
    elapsed = (fed.swt + fed.sit) * max(fed.n_clients / fed.s, 1.0)
    return np.minimum(fed.local_steps, np.maximum(lam * elapsed, 1e-3))


def lazy_h_steps(generator: torch.Generator, lam, elapsed,
                 local_steps: int) -> torch.Tensor:
    """H_i^t = min(K, Poisson(λ_i · elapsed_i)) as int32; may be 0 (the
    client is polled mid-flight and still participates)."""
    draws = torch.poisson((lam * elapsed).to(torch.float32),
                          generator=generator)
    return torch.clamp(draws, max=local_steps).to(torch.int32)
