"""The QuAFL slice against the reference: flattening, the MLP and its
gradients, the clock and the store, one full ``QuAFL.round`` on the
quickstart's 32-64-10 MLP (n=16, s=4) with the reference's params, state and
draws injected, and the simulation harness.

Round outputs must agree within one lattice step, max(γ_up, γ_dn); the bit
counters exactly (131,200 up and 32,800 down at d=2762, s=4, b=8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import gauss, npy, reference_round_draws, tt
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.quafl import QuAFL as RefQuAFL
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.fed import clock as ref_clock
from repro.fed import population as ref_population
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro.utils.tree import tree_flatten_vector as ref_flatten
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_mlp import dims
from repro_torch.data.synthetic import (client_batch,
                                        make_federated_classification)
from repro_torch.fed import clock, population
from repro_torch.fed.api import METRIC_KEYS, normalize_metrics
from repro_torch.fed.registry import make_algorithm
from repro_torch.fed.simulate import simulate
from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                    mlp_loss_batched)
from repro_torch.utils import interop
from repro_torch.utils.tree import (tree_flatten_vector,
                                    tree_unflatten_vector)

BATCH = 16
FED_KW = dict(n_clients=16, s=4, local_steps=5, lr=0.3, bits=8, swt=10.0)


def _ref_params():
    params, _ = ref_init(jax.random.PRNGKey(0), 32, 64, 10)
    return params


def test_flatten_order_matches_reference():
    params = _ref_params()
    flat_ref = npy(ref_flatten(params))
    port = interop.params_from_numpy({k: npy(v) for k, v in params.items()},
                                     "cpu")
    flat = tree_flatten_vector(port)
    np.testing.assert_array_equal(npy(flat), flat_ref)
    back = tree_unflatten_vector(port, flat)
    for k in port:
        np.testing.assert_array_equal(npy(back[k]), npy(port[k]))
    batched = tree_unflatten_vector(port, flat[None].repeat(3, 1))
    assert batched["w1"].shape == (3, 32, 64)


def test_mlp_loss_and_batched_grads_match_reference():
    params = _ref_params()
    port = interop.params_from_numpy({k: npy(v) for k, v in params.items()},
                                     "cpu")
    x = gauss(0, (3, 8, 32))
    y = np.random.default_rng(1).integers(0, 10, (3, 8)).astype(np.int32)
    flat = tree_flatten_vector(port)
    # three clients at three different points
    flats = torch.stack([flat, flat * 0.9, flat * 1.1])
    v = flats.clone().requires_grad_(True)
    losses, _ = mlp_loss_batched(tree_unflatten_vector(port, v),
                                 {"x": tt(x), "y": tt(y, torch.int64)})
    (g,) = torch.autograd.grad(losses.sum(), v)
    tmpl = params
    for i in range(3):
        def f(vec):
            p = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(tmpl),
                [vec[o:o + n].reshape(s) for o, n, s in _offsets(tmpl)])
            return ref_mlp_loss(p, {"x": jnp.asarray(x[i]),
                                    "y": jnp.asarray(y[i])})[0]
        li, gi = jax.value_and_grad(f)(jnp.asarray(npy(flats[i])))
        np.testing.assert_allclose(float(losses[i].detach()), float(li),
                                   rtol=1e-5)
        np.testing.assert_allclose(npy(g[i]), npy(gi), atol=1e-6)
    loss, aux = mlp_loss(port, {"x": tt(x[0]), "y": tt(y[0], torch.int64)})
    ref_loss, ref_aux = ref_mlp_loss(params, {"x": jnp.asarray(x[0]),
                                              "y": jnp.asarray(y[0])})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert float(aux["acc"]) == float(ref_aux["acc"])


def _offsets(tree):
    out, off = [], 0
    for leaf in jax.tree_util.tree_leaves(tree):
        out.append((off, int(np.prod(leaf.shape)), leaf.shape))
        off += int(np.prod(leaf.shape))
    return out


def test_port_init_and_data_shapes():
    g = torch.Generator()
    g.manual_seed(0)
    p = init_mlp_classifier(g, *dims())
    assert tree_flatten_vector(p).shape == (25_450,)
    assert float(p["b1"].abs().sum()) == 0.0
    assert abs(float(p["w1"].std()) - 1 / np.sqrt(784)) < 2e-3
    part, test = make_federated_classification(0, 8, samples_per_client=20,
                                               d=16, iid=False, device="cpu")
    assert part["x"].shape == (8, 20, 16) and part["y"].dtype == torch.int64
    assert test["x"].shape == (1024, 16)
    iid, _ = make_federated_classification(0, 8, samples_per_client=20,
                                           d=16, device="cpu")
    assert iid["y"].shape == (8, 20)

    def classes(p):
        return sum(len(torch.unique(p["y"][i])) for i in range(8))
    # by-class split: a client holds a run of the class-sorted samples
    assert classes(part) < classes(iid)
    b = client_batch(g, {"x": part["x"][0], "y": part["y"][0]}, 5)
    assert b["x"].shape == (5, 16)


def test_clock_matches_reference():
    fed, ref_fed = FedConfig(**FED_KW), RefFedConfig(**FED_KW)
    lam = clock.client_speeds(fed, 16)
    np.testing.assert_array_equal(lam, ref_clock.client_speeds(ref_fed, 16))
    np.testing.assert_array_equal(clock.expected_steps(fed, lam),
                                  ref_clock.expected_steps(ref_fed, lam))
    np.testing.assert_array_equal(clock.speeds_for(fed, 16, uniform=True),
                                  ref_clock.speeds_for(ref_fed, 16, True))
    g = torch.Generator()
    g.manual_seed(0)
    h = clock.lazy_h_steps(g, tt(lam), torch.full((16,), 11.0), 5)
    assert h.dtype == torch.int32 and int(h.max()) <= 5
    assert int(h.min()) >= 0


@pytest.mark.parametrize("n", [50, 10_000])
def test_uniform_sampling_dense_and_floyd(n):
    g = torch.Generator()
    g.manual_seed(0)
    part = population.resolve_participation(None, FedConfig())
    for _ in range(20):
        idx = part.sample(g, 0, n, 8)
        assert len(set(idx.tolist())) == 8
        assert 0 <= int(idx.min()) and int(idx.max()) < n
    cyc = population.resolve_participation("cyclic:period=8", None)
    ref_cyc = ref_population.resolve_participation("cyclic:period=8", None)
    assert (cyc.period, cyc.phase_groups) == (ref_cyc.period,
                                              ref_cyc.phase_groups) == (8, 4)
    for spec in ("cyclic:period", "cyclic:=8"):
        for resolve in (population.resolve_participation,
                        ref_population.resolve_participation):
            with pytest.raises(ValueError,
                               match="malformed participation spec"):
                resolve(spec, None)


def test_build_population_means_the_card_by_default():
    fed = FedConfig(**FED_KW)
    assert population.build_population(
        fed, device="cpu").rows["lam"].device == torch.device("cpu")
    if torch.cuda.is_available():
        assert population.build_population(fed).rows["lam"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            population.build_population(fed)


def test_population_gather_scatter():
    fed = FedConfig(**FED_KW)
    pop = population.build_population(fed, device="cpu",
                                      model=torch.zeros((16, 3)),
                                      last_time=torch.zeros(16))
    assert int(pop.rows["group"].sum()) == 5          # 30% of 16 slow
    idx = torch.tensor([3, 7])
    got = population.gather_rows(pop, idx)
    assert got["model"].shape == (2, 3)
    population.scatter_rows(pop, idx, {"model": torch.ones((2, 3)),
                                       "last_time": 11.0})
    assert float(pop.rows["model"].sum()) == 6.0
    assert float(pop.rows["last_time"][7]) == 11.0


def _reference_setup():
    fed = RefFedConfig(**FED_KW)
    part, test = ref_data(0, fed.n_clients, d=32, n_classes=10, iid=False)
    params = _ref_params()
    alg = RefQuAFL(fed=fed, loss_fn=ref_mlp_loss, template=params,
                   batch_fn=lambda d, k: ref_client_batch(k, d, BATCH))
    state = alg.init(params)
    state, _ = alg.round(state, part, jax.random.PRNGKey(11))
    return alg, state, part, params


def test_full_round_matches_reference_with_injected_draws():
    alg, state, part, params = _reference_setup()
    key = jax.random.PRNGKey(12)
    draws = reference_round_draws(alg, state, part, key, BATCH)
    port_state = interop.quafl_state_from_numpy(
        server=npy(state.server),
        rows={k: npy(v) for k, v in state.pop.rows.items()},
        t=int(state.t), sim_time=float(state.sim_time),
        bits_up=float(state.bits_up), bits_down=float(state.bits_down),
        srv_dist_est=npy(state.srv_dist_est), device="cpu")
    new_ref, m_ref = alg.round(state, part, key)

    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    port = make_algorithm("quafl", FedConfig(**FED_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, device="cpu")
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    seen = []
    gammas = port.pipeline.gammas
    port.pipeline.gammas = lambda *a, **k: seen.append(gammas(*a, **k)) \
        or seen[-1]
    new, m = port.round(port_state, data, None,
                        draws={k: tt(v) for k, v in draws.items()})

    assert m["bits_up"] == float(m_ref["bits_up"]) == 131_200
    assert m["bits_down"] == float(m_ref["bits_down"]) == 32_800
    assert new.bits_up == float(new_ref.bits_up)
    assert float(m["h_steps_mean"]) == float(m_ref["h_steps_mean"])
    assert new.t == int(new_ref.t) and new.sim_time == float(
        new_ref.sim_time)
    # one lattice step: the largest γ either direction used this round
    step = max(float(g.max()) for g in seen)
    np.testing.assert_array_less(
        np.abs(npy(new.server) - npy(new_ref.server)).max(), step)
    np.testing.assert_array_less(
        np.abs(npy(new.clients) - npy(new_ref.clients)).max(), step)
    np.testing.assert_allclose(float(new.srv_dist_est),
                               float(new_ref.srv_dist_est), rtol=1e-4)
    np.testing.assert_allclose(float(m["quant_err"]),
                               float(m_ref["quant_err"]), rtol=1e-3)
    np.testing.assert_array_equal(npy(new.last_time),
                                  npy(new_ref.last_time))


def test_simulate_trains_and_traces():
    fed = FedConfig(**FED_KW)
    part, test = make_federated_classification(0, 16, d=32, iid=False,
                                               device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    p0 = init_mlp_classifier(g, 32, 64, 10)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched,
                         template=p0, batch_size=32, device="cpu")
    acc0 = float(mlp_loss(p0, test)[1]["acc"])
    rows = []
    tr = simulate(alg, p0, part, g, rounds=30, eval_every=10,
                  on_row=rows.append,
                  eval_fn=lambda p: {"acc": float(mlp_loss(p, test)[1]
                                                  ["acc"])})
    assert tr.rounds == 30 and [r["round"] for r in tr.rows] == [10, 20, 30]
    assert rows == tr.rows
    assert tr.final["acc"] > max(acc0, 0.1)
    assert tr.final["bits_up_total"] == 30 * 131_200
    assert tr.final["bits_down_total"] == 30 * 32_800
    assert all(k in tr.final for k in METRIC_KEYS)
    assert alg.pipeline.stats.counts() == {"rotation_fwd": 150,
                                           "rotation_inv": 150}
    tr2 = simulate(alg, p0, part, g, until_sim_time=55.0, eval_every=0)
    assert tr2.rounds == 5 and tr2.final["sim_time"] == 55.0


def test_registry_and_metrics_schema():
    # quafl_scaffold is ported: it builds, with the QuAFL state's base
    scaffold = make_algorithm("quafl_scaffold", FedConfig(), loss_fn=None,
                              template={}, device="cpu")
    assert type(scaffold).__name__ == "QuaflScaffold"
    assert scaffold.fed == FedConfig() and scaffold.pipeline is not None
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_algorithm("nope", FedConfig(), loss_fn=None, template={})
    out = normalize_metrics({"bits_up": torch.tensor(3.0),
                             "vec": torch.zeros(3)})
    assert out["bits_up"] == 3.0 and "vec" not in out
    assert set(METRIC_KEYS) <= set(out)
