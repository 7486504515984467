"""Shared simulation clock (port of ``repro.fed.clock``): client speeds,
the lazy H-step draws, straggler round times and buffered arrivals.

Per-step durations are Exp(λ_i) with λ from a fast/slow split (paper
App. A). QuAFL polls s clients per round and lazily replays the
``min(K, Poisson(λ_i · elapsed))`` local steps each would have completed
since its last interaction (App. B.1). A synchronous round (FedAvg) lasts
as long as its slowest client's K steps, Gamma(K, λ_i). FedBuff's event
stream is host-side numpy, as in the reference, so the same numpy seed
gives the same events draw for draw.
"""
from __future__ import annotations

import heapq
from typing import List, Tuple

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


def sample_clients(generator: torch.Generator, n: int, s: int
                   ) -> torch.Tensor:
    """The round's polled-client index set: s of n, uniform, without
    replacement, on the generator's device."""
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:s]


def lazy_h_steps(generator: torch.Generator, lam, elapsed,
                 local_steps: int) -> torch.Tensor:
    """H_i^t = min(K, Poisson(λ_i · elapsed_i)) as int32; may be 0 (the
    client is polled mid-flight and still participates)."""
    draws = torch.poisson((lam * elapsed).to(torch.float32),
                          generator=generator)
    return torch.clamp(draws, max=local_steps).to(torch.int32)


def straggler_round_time(generator: torch.Generator, lam, local_steps: int,
                         sit: float, durations=None) -> torch.Tensor:
    """Synchronous round duration: the slowest sampled client's K-step
    duration plus the server interaction time. Client i's duration is
    Gamma(K, λ_i), drawn as the sum of K Exp(1) draws over λ_i (K is an
    integer), unless ``durations`` (s,) are given."""
    if durations is None:
        steps = torch.empty((lam.shape[0], local_steps), dtype=torch.float32,
                            device=lam.device)
        durations = steps.exponential_(generator=generator).sum(1) / lam
    return torch.max(durations) + sit


def completion_time(rng: np.random.Generator, local_steps: int,
                    lam: float) -> float:
    """Duration of one client's K local steps: Gamma(K, 1/λ)."""
    return float(rng.gamma(local_steps, 1.0 / lam))


class ArrivalQueue:
    """Min-heap of (finish_time, client) completion events. Pure container:
    all randomness comes from the caller's numpy rng through
    :func:`completion_time`."""

    def __init__(self, events: List[Tuple[float, int]] = None):
        self.events: List[Tuple[float, int]] = list(events or [])
        heapq.heapify(self.events)

    @classmethod
    def initial(cls, rng: np.random.Generator, lam: np.ndarray,
                local_steps: int) -> ArrivalQueue:
        q = cls()
        for i in range(len(lam)):
            q.push(completion_time(rng, local_steps, lam[i]), i)
        return q

    def push(self, t: float, client: int):
        heapq.heappush(self.events, (t, client))

    def pop(self) -> Tuple[float, int]:
        return heapq.heappop(self.events)

    def peek(self) -> Tuple[float, int]:
        return self.events[0]

    def __len__(self):
        return len(self.events)

    def copy(self) -> ArrivalQueue:
        return ArrivalQueue(self.events)
