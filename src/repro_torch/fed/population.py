"""The per-client state store, the lazy per-client RNG and the
participation specs (port of ``repro.fed.population``).

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
:class:`GammaStragglerParticipation` samples in proportion to λ^strength
(Gumbel top-k) and :class:`CyclicParticipation` polls one phase group at a
time; specs are strings in the codecs' ``name:key=val,...`` grammar.

**The lazy per-client RNG.** The reference derives a client's key as
``fold_in(base_key, client_id)``; a ``torch.Generator`` has no such split.
Here a round draws ONE base integer from its generator, and
:func:`client_keys` hashes (base, client id) with a counter-based integer
hash on the device, so a client's draw depends on (base, id) only, not on
the sample order or on which other clients were sampled, and no
per-client generator or host loop is needed.

**The split store.** :func:`client_mesh` is a 1-D mesh, axis ``"clients"``,
over every rank of the default process group (one process a card: NCCL on
cards, gloo on the CPU), and :func:`shard_population` splits the store
over it: a row whose leading dimension n divides the axis size R becomes
a :class:`SplitRow`, and rank r holds its rows ``[r·n/R, (r+1)·n/R)``;
any other row stays whole on every rank. The rows a round reads whole
rather than through :func:`gather_rows` stay whole even where they
divide (:data:`WHOLE_ROWS`: ``lam``, which the participation specs read,
and FedBuffDevice's ``occ``), so the rows split are the client models
(``model``, FedBuffDevice's ``start``), the interaction times
``last_time``, the speed classes ``group``, the error-feedback residuals
``codec_up`` and SCAFFOLD's ``control``: the memory is in the (n, d)
rows. Values never change, only placement moves. Every rank runs the
same program on the same draws (generators seeded alike): the cohort,
its rows, the local steps and the exchange are computed whole on every
rank; only the store is split. :func:`gather_rows` on a split row is an
exact all-gather of each cohort row from its owner, and
:func:`scatter_rows` writes each rank's own rows, with static shapes and
no host read, so a captured chunk holds the collectives
(:mod:`repro_torch.fed.engine`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import default_device
from repro_torch.configs.base import FedConfig
from repro_torch.fed.clock import lazy_h_steps, sample_clients, speeds_for
from repro_torch.utils.specs import parse_spec

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


def with_rows(pop: Population, **rows) -> Population:
    """A copy of the store with the named rows added or replaced."""
    return Population(rows={**pop.rows, **rows})


def gather_rows(pop: Population, idx) -> Dict[str, Any]:
    """Sparse O(s·row) gather of the participating clients' rows; an empty
    row (``()``, a stateless codec's ``codec_up``) comes back as it is."""
    return {k: take_rows(v, idx) for k, v in pop.rows.items()}


def scatter_rows(pop: Population, idx, updates: Dict[str, Any]
                 ) -> Population:
    """Write updated rows back in place (O(s·row)); returns the store.
    Rows not named in ``updates`` (an empty ``codec_up`` among them) are
    left untouched. A tensor value is cast to its row's dtype, as a host
    number is."""
    for name, val in updates.items():
        put_rows(pop.rows[name], idx, val)
    return pop


def take_rows(row, idx):
    """Rows ``idx`` of one row of the store, whole or split."""
    if isinstance(row, SplitRow):
        return row.gather(idx)
    return row[idx] if isinstance(row, torch.Tensor) else row


def put_rows(row, idx, val) -> None:
    """Write ``val`` into rows ``idx`` of one row of the store, in
    place."""
    if isinstance(row, SplitRow):
        row.scatter_(idx, val)
        return
    if isinstance(val, torch.Tensor) and val.dtype != row.dtype:
        val = val.to(row.dtype)
    row[idx] = val


def client_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` as an (n, ...) row of the store, one copy a client: a
    broadcast view here, which :func:`shard_population` gives memory of
    its own (each rank copies only the rows it keeps)."""
    return x[None].expand((n,) + tuple(x.shape))


def whole_row(row):
    """A row of the store whole, (n, ...): a split row all-gathered from
    every rank (a collective: every rank must call it), any other as it
    is."""
    return row.whole() if isinstance(row, SplitRow) else row


# ---------------------------------------------------------------------------
# the split store: the client axis over the ranks of a process group
# ---------------------------------------------------------------------------

CLIENTS = "clients"
# rows a round reads whole, not through gather_rows: never split
WHOLE_ROWS = ("lam", "occ")


@dataclass(eq=False)
class SplitRow:
    """One row of the store split over the mesh's ``"clients"`` axis of R
    ranks: this rank holds rows ``[r·m, (r+1)·m)`` of the n, m = n/R, in
    ``store[:m]``; ``store[m]`` is a spare row that the writes this rank
    does not own go to, so a scatter has static shapes."""
    store: torch.Tensor     # (m + 1, ...)
    n: int
    mesh: Any

    @property
    def rows_per_rank(self) -> int:
        return self.n // self.mesh.shape[CLIENTS]

    @property
    def block(self) -> torch.Tensor:
        """This rank's m rows."""
        return self.store[:self.rows_per_rank]

    @property
    def shape(self):
        """The whole row's shape, (n, ...)."""
        return torch.Size((self.n,) + tuple(self.store.shape[1:]))

    def _owners(self, idx):
        m = self.rows_per_rank
        idx = torch.as_tensor(idx, device=self.store.device).long()
        owner = torch.div(idx, m, rounding_mode="floor")
        return idx, owner, idx - owner * m

    def gather(self, idx) -> torch.Tensor:
        """Rows ``idx`` (s,), exact: each rank takes the rows it owns
        (zeros elsewhere), one all-gather over ``"clients"`` stacks them
        (R, s, ...), and each row is read from its owner. No sum, so a
        -0.0 or a NaN row comes back as it is."""
        idx, owner, local = self._owners(idx)
        part = self.store.index_select(0, local)
        mine = (owner == self.mesh.axis_index(CLIENTS)).reshape(
            (-1,) + (1,) * (part.dim() - 1))
        part = torch.where(mine, part, torch.zeros((), dtype=part.dtype,
                                                   device=part.device))
        every = self.mesh.all_gather(part, CLIENTS)
        return every[owner, torch.arange(idx.shape[0],
                                         device=idx.device)]

    def scatter_(self, idx, val) -> None:
        """Write ``val`` into rows ``idx`` (s,): each rank writes the rows
        it owns; the others go to its spare row. Static shapes, no host
        read."""
        idx, owner, local = self._owners(idx)
        mine = owner == self.mesh.axis_index(CLIENTS)
        at = torch.where(mine, local, torch.full_like(local,
                                                      self.rows_per_rank))
        val = torch.as_tensor(val, device=self.store.device).to(
            self.store.dtype)
        self.store.index_put_((at,), val.expand(
            (idx.shape[0],) + tuple(self.store.shape[1:])))

    def whole(self) -> torch.Tensor:
        """The whole (n, ...) row, all-gathered from every rank."""
        every = self.mesh.all_gather(self.block.contiguous(), CLIENTS)
        return every.reshape(self.shape)


def client_mesh(devices: Sequence = None):
    """A 1-D mesh with the axis ``"clients"`` over every rank of the
    default process group (``devices``, when given, must name one device a
    rank); without a process group, the local mesh of one."""
    from repro_torch.launch.mesh import make_mesh
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if devices is not None and len(devices) != world:
        raise ValueError(f"client_mesh: {len(devices)} devices for {world} "
                         f"ranks; the port runs one process a device "
                         f"(torchrun --nproc-per-node {len(devices)})")
    return make_mesh((world,), (CLIENTS,))


def own_row(a):
    """``a`` with memory of its own: a view of another tensor (the
    broadcast of :func:`client_rows`, whose rows share memory) is copied,
    so a write to one client's row writes no other; anything else as it
    is."""
    if isinstance(a, torch.Tensor) and a._base is not None:
        return a.clone(memory_format=torch.contiguous_format)
    return a


def split_row(a, mesh):
    """``a`` split over ``mesh``'s ``"clients"`` axis when its leading
    dimension divides it; else ``a`` with memory of its own
    (:func:`own_row`)."""
    if isinstance(a, SplitRow) or not isinstance(a, torch.Tensor):
        return a
    R = mesh.shape[CLIENTS]
    if a.dim() < 1 or a.shape[0] % R:
        return own_row(a)
    m = a.shape[0] // R
    r = mesh.axis_index(CLIENTS)
    store = a.new_zeros((m + 1,) + tuple(a.shape[1:]))
    store[:m].copy_(a[r * m:(r + 1) * m])
    return SplitRow(store=store, n=int(a.shape[0]), mesh=mesh)


def shard_population(pop: Population, mesh) -> Population:
    """The store with every row whose leading dimension divides the
    ``"clients"`` axis split over it (rank r keeps its n/R rows), but the
    rows of :data:`WHOLE_ROWS`; other rows stay whole on every rank. The
    values are unchanged: only placement moves. A row already split stays
    as it is; a whole row that is a view (:func:`client_rows`) gets memory
    of its own. ``mesh`` must have a ``"clients"`` axis
    (:func:`client_mesh`); with ``mesh`` None the store stays whole."""
    if mesh is None:
        return Population(rows={k: own_row(v) for k, v in pop.rows.items()})
    if CLIENTS not in mesh.shape:
        raise ValueError(f"shard_population needs a mesh with a "
                         f"{CLIENTS!r} axis (client_mesh()); got axes "
                         f"{tuple(mesh.shape)}")
    return Population(rows={k: own_row(v) if k in WHOLE_ROWS
                            else split_row(v, mesh)
                            for k, v in pop.rows.items()})


# ---------------------------------------------------------------------------
# lazy per-client RNG
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 x in [0, 2^32): two 16-bit halves of c,
    so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer mix (the ``lowbias32`` constants) on
    int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def draw_base(generator: torch.Generator) -> torch.Tensor:
    """One round's base integer for :func:`client_keys`, a 0-d int64 in
    [0, 2^32) on the generator's device."""
    return torch.randint(0, 1 << 32, (), generator=generator,
                         device=generator.device)


def client_keys(base, ids) -> torch.Tensor:
    """A 32-bit key per client, derived lazily from ``(base, client_id)``:
    the same ids give the same keys whatever the sample order or round
    composition (the reference's ``fold_in(base_key, id)`` contract)."""
    ids = torch.as_tensor(ids).to(torch.int64) & _MASK32
    return _hash32(_hash32(ids) ^ _hash32(torch.as_tensor(
        base, dtype=torch.int64, device=ids.device) & _MASK32))


def client_uniforms(base, ids) -> torch.Tensor:
    """One uniform in (0, 1) per client from its key: the top 24 bits of
    the key, centred in their cell, exact in fp32."""
    return (((client_keys(base, ids) >> 8).to(torch.float32) + 0.5)
            / float(1 << 24))


def truncated_poisson(u, rate, local_steps: int) -> torch.Tensor:
    """min(K, Poisson(rate)) by inversion of uniforms ``u``: H counts the
    k < K whose CDF P(X <= k) lies below u, which needs the Poisson CDF at
    0..K-1 only (fp64, from the pmf's recurrence)."""
    rate = torch.as_tensor(rate).to(torch.float64)
    u = u.to(torch.float64)
    pmf = torch.exp(-rate)
    cdf = pmf
    h = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for k in range(local_steps):
        h = h + (u > cdf).to(torch.int32)
        pmf = pmf * rate / (k + 1)
        cdf = cdf + pmf
    return h


def lazy_h_steps_per_client(base, ids, lam_i, elapsed,
                            local_steps: int) -> torch.Tensor:
    """Per-client-keyed :func:`repro_torch.fed.clock.lazy_h_steps`: H_i =
    min(K, Poisson(λ_i · elapsed_i)) from client i's own uniform, so its
    progress draw is stable under reordering and recomposition of the
    cohort (used by the non-uniform participation specs)."""
    return truncated_poisson(client_uniforms(base, ids), lam_i * elapsed,
                             local_steps)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def floyd_sample(generator: torch.Generator, n: int, s: int) -> torch.Tensor:
    """Exact uniform s-subset of [0, n) without replacement in O(s²)
    (Floyd's algorithm): no O(n) permutation is materialised. Its s draws
    and the duplicate test stay on the device (no host read), so a
    captured chunk can hold it."""
    dev = generator.device
    chosen = torch.full((s,), -1, dtype=torch.int64, device=dev)
    for i in range(s):
        j = n - s + i
        t = torch.randint(0, j + 1, (1,), generator=generator, device=dev)
        dup = (chosen[:i] == t).any()
        chosen[i:i + 1] = torch.where(dup, torch.full_like(t, j), t)
    return chosen


def uniform_sample(generator: torch.Generator, n: int, s: int
                   ) -> torch.Tensor:
    """Uniform without replacement: a dense permutation draw up to
    :data:`DENSE_SAMPLE_MAX` clients, Floyd's sampler above."""
    if n <= DENSE_SAMPLE_MAX:
        return sample_clients(generator, n, s)
    return floyd_sample(generator, n, s)


# ---------------------------------------------------------------------------
# participation specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Participation:
    """Who participates in round t: a function of (the round's draws, t, n,
    s[, λ]). ``sample(generator, t, n, s, lam=None, noise=None)`` takes
    the spec's one random draw from ``generator``, or ``noise`` in its
    place (a test feeds the reference's draw there).

    ``per_client_rng`` selects the H-draw derivation: False keeps the
    batched Poisson draw, True derives each client's draw from its
    identity (:func:`lazy_h_steps_per_client`)."""

    per_client_rng: ClassVar[bool] = False
    name: ClassVar[str] = "base"

    def sample(self, generator, t, n: int, s: int, lam=None, noise=None):
        raise NotImplementedError

    def h_steps(self, generator, ids, lam_i, elapsed, local_steps: int):
        """Lazy local-progress draws for the sampled clients."""
        if self.per_client_rng:
            return lazy_h_steps_per_client(draw_base(generator), ids, lam_i,
                                           elapsed, local_steps)
        return lazy_h_steps(generator, lam_i, elapsed, local_steps)


@dataclass(frozen=True)
class UniformParticipation(Participation):
    """The paper's sampling: s clients uniformly without replacement;
    ``noise`` is the (s,) sample itself."""

    name: ClassVar[str] = "uniform"

    def sample(self, generator, t, n: int, s: int, lam=None, noise=None):
        if noise is not None:
            return noise.long()
        return uniform_sample(generator, n, s)


@dataclass(frozen=True)
class GammaStragglerParticipation(Participation):
    """Availability follows speed: P(client i enters) ∝ λ_i^strength, so
    fast clients answer polls more often and slow ones drift longer
    between contacts. Exact weighted sampling without replacement: the
    top s of strength·log λ + Gumbel, in descending score (``noise`` is
    the (n,) Gumbel row; drawn as −log Exp(1))."""

    strength: float = 1.0
    per_client_rng: ClassVar[bool] = True
    name: ClassVar[str] = "gamma_straggler"

    def sample(self, generator, t, n: int, s: int, lam=None, noise=None):
        if lam is None:
            raise ValueError("gamma_straggler participation needs the "
                             "population's lam row")
        if noise is None:
            noise = -torch.log(torch.empty(
                (n,), device=lam.device).exponential_(generator=generator))
        scores = self.strength * torch.log(lam) + noise.to(lam.device)
        return torch.topk(scores, s).indices


@dataclass(frozen=True)
class CyclicParticipation(Participation):
    """Periodic availability: the population splits into ``phase_groups``
    contiguous blocks; block ``(t // (period/phase_groups)) mod
    phase_groups`` is available during round t and the s participants are
    drawn uniformly within it (``noise`` is that (s,) within-group draw).
    Over a full period every client has the same chance to participate."""

    period: int = 8
    phase_groups: int = 4
    per_client_rng: ClassVar[bool] = True
    name: ClassVar[str] = "cyclic"

    def __post_init__(self):
        if self.phase_groups < 1 or self.period < self.phase_groups:
            raise ValueError(
                f"cyclic participation needs period >= phase_groups >= 1; "
                f"got period={self.period}, phase_groups={self.phase_groups}")
        if self.period % self.phase_groups:
            raise ValueError(
                f"cyclic period {self.period} must be a multiple of "
                f"phase_groups {self.phase_groups} (each group is available "
                f"for period/phase_groups consecutive rounds)")

    def rounds_per_phase(self) -> int:
        return self.period // self.phase_groups

    def group_at(self, t):
        """The phase group available during round t (an int, or a 0-d
        integer tensor on the device, which stays there)."""
        return (t // self.rounds_per_phase()) % self.phase_groups

    def sample(self, generator, t, n: int, s: int, lam=None, noise=None):
        G = self.phase_groups
        if n % G:
            raise ValueError(f"cyclic participation: n_clients {n} must be "
                             f"divisible by phase_groups {G}")
        m = n // G
        if s > m:
            raise ValueError(f"cyclic participation: s={s} exceeds the "
                             f"phase-group size {m} (= n/G = {n}/{G})")
        inner = (noise.long() if noise is not None
                 else uniform_sample(generator, m, s))
        return self.group_at(t) * m + inner


# ---------------------------------------------------------------------------
# spec registry + parser (the codecs' ``name:key=val,...`` grammar)
# ---------------------------------------------------------------------------

_PARTICIPATIONS = {
    "uniform": UniformParticipation,
    "gamma_straggler": GammaStragglerParticipation,
    "cyclic": CyclicParticipation,
}


def registered_participations() -> Tuple[str, ...]:
    return tuple(_PARTICIPATIONS)


def register_participation(name: str, builder) -> None:
    """Register a custom availability pattern; ``builder(**params)`` must
    return a :class:`Participation`."""
    if name in _PARTICIPATIONS:
        raise ValueError(f"participation {name!r} already registered")
    _PARTICIPATIONS[name] = builder


def resolve_participation(spec, fed: FedConfig = None) -> Participation:
    """Build a :class:`Participation` from a spec string (``"uniform"``,
    ``"gamma_straggler:strength=2"``, ``"cyclic:period=8,phase_groups=4"``),
    pass an instance through, or, given ``None``/``""``, fall back to
    ``fed.participation`` and finally to ``uniform``."""
    if isinstance(spec, Participation):
        return spec
    if spec is None or spec == "":
        spec = getattr(fed, "participation", "") or "uniform"
        if isinstance(spec, Participation):
            return spec
    if not isinstance(spec, str):
        raise TypeError(f"participation spec must be a name string or "
                        f"Participation instance; got {type(spec).__name__}")
    name, params = parse_spec(spec, "participation")
    if name not in _PARTICIPATIONS:
        raise ValueError(f"unknown participation {name!r}; choose from "
                         f"{sorted(_PARTICIPATIONS)}")
    return _PARTICIPATIONS[name](**params)
