"""The per-client state store and uniform participation (port of
``repro.fed.population``).

:class:`Population` holds every per-client row (speeds λ, speed class,
last-interaction times, client models) as stacked (n, ...) tensors. A round
reaches the store only through :func:`gather_rows` of the s sampled clients
and :func:`scatter_rows` of their updated rows, both O(s·row). Unlike the
reference's functional ``.at[].set``, :func:`scatter_rows` writes the rows
in place: the state a round is given is consumed, as the reference's
scanned engine donates it, and an (n, d) copy per round is saved.

:class:`UniformParticipation` draws s of n clients without replacement: a
dense permutation up to :data:`DENSE_SAMPLE_MAX` clients and Floyd's O(s²)
sampler above it, so the draw costs nothing that grows with n.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs.base import FedConfig
from repro_torch.fed.clock import lazy_h_steps, speeds_for

DENSE_SAMPLE_MAX = 4096


class Population(NamedTuple):
    """All per-client state as stacked rows leading with the client axis."""
    rows: Dict[str, Any]


def build_population(fed: FedConfig, n: int = None, *, lam=None,
                     device=None, **extra_rows) -> Population:
    """The base store: speeds ``lam`` and ``group`` speed-class labels (1 =
    slow), plus any ``extra_rows`` (models, last-interaction times, ...);
    ``device=None`` means the card, as for every entry point."""
    n = fed.n_clients if n is None else n
    if lam is None:
        lam = speeds_for(fed, n)
    lam = torch.as_tensor(lam, dtype=torch.float32,
                          device=default_device(device))
    group = (lam == float(np.float32(fed.lam_slow))).to(torch.int32)
    return Population(rows=dict(lam=lam, group=group, **extra_rows))


def gather_rows(pop: Population, idx) -> Dict[str, Any]:
    """Sparse O(s·row) gather of the participating clients' rows."""
    return {k: v[idx] for k, v in pop.rows.items()}


def scatter_rows(pop: Population, idx, updates: Dict[str, Any]
                 ) -> Population:
    """Write updated rows back in place (O(s·row)); returns the store."""
    for name, val in updates.items():
        pop.rows[name][idx] = val
    return pop


def floyd_sample(generator: torch.Generator, n: int, s: int) -> torch.Tensor:
    """Exact uniform s-subset of [0, n) without replacement in O(s²)
    (Floyd's algorithm): no O(n) permutation is materialised."""
    draws = [int(torch.randint(0, n - s + i + 1, (1,), generator=generator,
                               device=generator.device))
             for i in range(s)]
    chosen = []
    for i, t in enumerate(draws):
        chosen.append(n - s + i if t in chosen else t)
    return torch.tensor(chosen, dtype=torch.int64, device=generator.device)


def uniform_sample(generator: torch.Generator, n: int, s: int
                   ) -> torch.Tensor:
    """Uniform without replacement: a dense permutation draw up to
    :data:`DENSE_SAMPLE_MAX` clients, Floyd's sampler above."""
    if n <= DENSE_SAMPLE_MAX:
        return torch.randperm(n, generator=generator,
                              device=generator.device)[:s]
    return floyd_sample(generator, n, s)


@dataclass(frozen=True)
class UniformParticipation:
    """The paper's sampling: s clients uniformly without replacement."""

    def sample(self, generator, t, n: int, s: int, lam=None):
        return uniform_sample(generator, n, s)

    def h_steps(self, generator, ids, lam_i, elapsed, local_steps: int):
        """Lazy local-progress draws for the sampled clients."""
        return lazy_h_steps(generator, lam_i, elapsed, local_steps)


def resolve_participation(spec, fed: FedConfig = None):
    """``uniform`` (or ``None``/``""``, or an instance passed through); the
    reference's ``gamma_straggler`` and ``cyclic`` are not ported yet."""
    if isinstance(spec, UniformParticipation):
        return spec
    if spec is None or spec == "":
        spec = getattr(fed, "participation", "") or "uniform"
    if spec != "uniform":
        raise NotImplementedError(f"participation {spec!r} is not ported "
                                  f"yet (ROADMAP Queue 1 item 5)")
    return UniformParticipation()
