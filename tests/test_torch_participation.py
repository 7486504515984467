"""The participation specs against the reference: ``cyclic`` and
``gamma_straggler`` indices exactly the reference's with its within-group
draw or its Gumbel row injected; the ``name:key=val`` grammar, the registry
and their errors; and the lazy per-client RNG that replaces the reference's
``fold_in(base_key, client_id)``: a client's H draw depends on (base, id,
λ, elapsed) only, and H follows min(K, Poisson(λ·elapsed)) (a χ² test at
10^5 draws).
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

from test_torch_harness import npy, tt  # noqa: F401  (the jax.core alias)
from repro.configs.base import FedConfig as RefFedConfig
from repro.fed import population as ref_pop
from repro.fed.clock import client_speeds as ref_client_speeds
from repro_torch.configs.base import FedConfig
from repro_torch.fed import population as pop
from repro_torch.fed.clock import sample_clients


@pytest.mark.parametrize("n,s,period,groups", [(16, 4, 8, 4), (300, 16, 8, 4),
                                               (20, 5, 6, 2)])
def test_cyclic_indices_match_reference(n, s, period, groups):
    ref = ref_pop.CyclicParticipation(period=period, phase_groups=groups)
    port = pop.CyclicParticipation(period=period, phase_groups=groups)
    m = n // groups
    for t in range(2 * period + 1):
        key = jax.random.PRNGKey(100 + t)
        want = npy(ref.sample(key, t, n, s))
        inner = npy(ref_pop.uniform_sample(key, m, s))
        got = port.sample(None, t, n, s, noise=tt(inner))
        np.testing.assert_array_equal(npy(got), want)
        g = port.group_at(t)
        assert g == int(ref.group_at(t)) == (t // (period // groups)) % groups
        # drawn from the port's generator: inside the phase group, distinct
        gen = torch.Generator()
        gen.manual_seed(t)
        own = npy(port.sample(gen, t, n, s))
        assert len(set(own)) == s and (own // m == g).all()


@pytest.mark.parametrize("strength", [1.0, 2.0, 0.5])
@pytest.mark.parametrize("n,s", [(16, 4), (300, 16)])
def test_gamma_straggler_indices_match_reference(n, s, strength):
    lam = ref_client_speeds(RefFedConfig(n_clients=n), n)
    ref = ref_pop.GammaStragglerParticipation(strength=strength)
    port = pop.GammaStragglerParticipation(strength=strength)
    for t in range(8):
        key = jax.random.PRNGKey(7 + t)
        want = npy(ref.sample(key, t, n, s, jax.numpy.asarray(lam)))
        noise = npy(jax.random.gumbel(key, (n,)))
        got = port.sample(None, t, n, s, lam=tt(lam), noise=tt(noise))
        # the order too: row i of the cohort pairs with row i of u_cl
        np.testing.assert_array_equal(npy(got), want)
    gen = torch.Generator()
    gen.manual_seed(0)
    own = npy(port.sample(gen, 0, n, s, lam=tt(lam)))
    assert len(set(own)) == s


def test_gamma_straggler_favours_fast_clients():
    """P(enter) ∝ λ^strength: with λ_fast = 4 λ_slow, a fast client enters
    far more often than a slow one (n=16, s=4, 2,000 draws)."""
    n, s = 16, 4
    lam = torch.as_tensor(ref_client_speeds(RefFedConfig(n_clients=n), n))
    part = pop.GammaStragglerParticipation(strength=1.0)
    gen = torch.Generator()
    gen.manual_seed(0)
    hits = torch.zeros(n)
    for _ in range(2000):
        hits[part.sample(gen, 0, n, s, lam=lam)] += 1
    slow, fast = hits[:5].mean(), hits[5:].mean()
    assert fast > 2.0 * slow, (float(slow), float(fast))


def test_participation_precedence_and_grammar():
    inst = pop.CyclicParticipation(period=4, phase_groups=2)
    assert pop.resolve_participation(inst) is inst
    assert isinstance(pop.resolve_participation("uniform"),
                      pop.UniformParticipation)
    fed = FedConfig(n_clients=8, s=2,
                    participation="gamma_straggler:strength=2")
    p = pop.resolve_participation(None, fed)
    assert isinstance(p, pop.GammaStragglerParticipation) and p.strength == 2
    assert isinstance(pop.resolve_participation("uniform", fed),
                      pop.UniformParticipation)
    assert isinstance(pop.resolve_participation(None, None),
                      pop.UniformParticipation)
    for spec in ("cyclic:period=8,phase_groups=4", "gamma_straggler",
                 "gamma_straggler:strength=0.5", "cyclic:period=6,"
                 "phase_groups=3"):
        got, want = (pop.resolve_participation(spec),
                     ref_pop.resolve_participation(spec))
        assert got.name == want.name
        assert got.per_client_rng == want.per_client_rng
        assert {k: getattr(got, k) for k in ("period", "phase_groups",
                                             "strength")
                if hasattr(want, k)} == \
            {k: getattr(want, k) for k in ("period", "phase_groups",
                                           "strength") if hasattr(want, k)}


PART_ERRORS = [
    (lambda m: m.resolve_participation("diurnal"), ValueError),
    (lambda m: m.resolve_participation("cyclic:period8"), ValueError),
    (lambda m: m.resolve_participation(42), TypeError),
    (lambda m: m.CyclicParticipation(period=3, phase_groups=2), ValueError),
    (lambda m: m.CyclicParticipation(period=2, phase_groups=4), ValueError),
    (lambda m: m.resolve_participation("cyclic:period=8,nope=1"), TypeError),
    (lambda m: m.register_participation("uniform", None), ValueError),
]


@pytest.mark.parametrize("case", range(len(PART_ERRORS)))
def test_participation_errors_match_reference(case):
    fn, exc = PART_ERRORS[case]
    msgs = []
    for module in (pop, ref_pop):
        with pytest.raises(exc) as err:
            fn(module)
        msgs.append(str(err.value))
    if exc is ValueError:
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n,s", [(15, 3), (16, 5)])
def test_cyclic_sample_errors_match_reference(n, s):
    msgs = []
    for module, key in ((pop, None), (ref_pop, jax.random.PRNGKey(0))):
        with pytest.raises(ValueError) as err:
            module.CyclicParticipation(period=8, phase_groups=4).sample(
                key, 0, n, s)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_participation_registry_extensible_and_loud_on_duplicates():
    assert pop.registered_participations() == \
        ref_pop.registered_participations()
    pop.register_participation("test_everyone_0",
                               lambda **kw: pop.UniformParticipation())
    try:
        assert isinstance(pop.resolve_participation("test_everyone_0"),
                          pop.UniformParticipation)
        with pytest.raises(ValueError, match="already registered"):
            pop.register_participation("test_everyone_0", None)
    finally:
        pop._PARTICIPATIONS.pop("test_everyone_0")
    with pytest.raises(ValueError, match="gamma_straggler participation "
                                         "needs"):
        pop.GammaStragglerParticipation().sample(None, 0, 8, 2)


def test_uniform_participation_and_sample_clients():
    gen = torch.Generator()
    gen.manual_seed(0)
    idx = sample_clients(gen, 16, 4)
    assert idx.shape == (4,) and len(set(idx.tolist())) == 4
    gen.manual_seed(0)
    assert torch.equal(pop.UniformParticipation().sample(gen, 0, 16, 4), idx)
    noise = torch.tensor([3, 1, 4, 9])
    assert torch.equal(pop.UniformParticipation().sample(None, 0, 16, 4,
                                                         noise=noise), noise)


def test_per_client_h_steps_depend_on_identity_only():
    base = torch.tensor(123_456_789)
    ids = torch.tensor([3, 17, 250, 0, 99, 42])
    lam = torch.tensor([0.5, 0.125, 0.5, 0.125, 0.5, 0.5])
    elapsed = torch.tensor([11.0, 33.0, 22.0, 55.0, 11.0, 44.0])
    h = pop.lazy_h_steps_per_client(base, ids, lam, elapsed, 5)
    assert h.dtype == torch.int32 and h.shape == (6,)
    # a permutation of the cohort permutes the draws
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    hp = pop.lazy_h_steps_per_client(base, ids[perm], lam[perm],
                                     elapsed[perm], 5)
    assert torch.equal(hp, h[perm])
    # other clients in the cohort change nothing for clients 3 and 17
    others = pop.lazy_h_steps_per_client(
        base, torch.tensor([3, 1000, 17]), torch.tensor([0.5, 0.1, 0.125]),
        torch.tensor([11.0, 1.0, 33.0]), 5)
    assert torch.equal(others[[0, 2]], h[:2])
    # keys: one per id, any order; another base gives other keys
    keys = pop.client_keys(base, torch.arange(10_000))
    assert len(set(keys.tolist())) == 10_000
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    assert not torch.equal(keys, pop.client_keys(base + 1,
                                                 torch.arange(10_000)))
    # drawn through the spec: one base from the generator, then per client
    gen = torch.Generator()
    gen.manual_seed(5)
    spec = pop.CyclicParticipation()
    a = spec.h_steps(gen, ids, lam, elapsed, 5)
    gen.manual_seed(5)
    b = spec.h_steps(gen, ids[perm], lam[perm], elapsed[perm], 5)
    assert torch.equal(b, a[perm])


@pytest.mark.parametrize("rate,K", [(0.7, 5), (2.5, 5), (4.0, 10)])
def test_per_client_h_distribution_chi2(rate, K):
    """H over 10^5 client ids against min(K, Poisson(rate))."""
    n = 100_000
    ids = torch.arange(n)
    h = pop.lazy_h_steps_per_client(torch.tensor(987_654_321), ids,
                                    torch.full((n,), rate),
                                    torch.ones(n), K)
    counts = np.bincount(h.numpy(), minlength=K + 1)
    pmf = stats.poisson.pmf(np.arange(K), rate)
    expected = n * np.append(pmf, 1.0 - pmf.sum())
    keep = expected >= 5            # the χ² test's rule for its cells
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    chi2, p = stats.chisquare(obs, exp)
    assert p > 1e-3, (counts, expected, chi2)


def test_truncated_poisson_edges():
    u = torch.tensor([0.1, 0.5, 0.999999])
    assert pop.truncated_poisson(u, torch.zeros(3), 5).tolist() == [0, 0, 0]
    assert pop.truncated_poisson(u, torch.full((3,), 800.0),
                                 5).tolist() == [5, 5, 5]
    # inversion: u just under / over P(X <= 0) = e^-1 at rate 1
    e = float(np.exp(-1.0))
    got = pop.truncated_poisson(torch.tensor([e - 1e-6, e + 1e-6]),
                                torch.ones(2), 5)
    assert got.tolist() == [0, 1]
