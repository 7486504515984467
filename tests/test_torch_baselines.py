"""The paper's baselines against the reference, with the reference's draws
injected: FedAvg (identity and lattice codecs), CompressedFedAvg (two
rounds; ``lattice``, ``lattice_packed:bits=4`` and ``scalar`` uplinks, and
a lattice downlink decoded against the previous server), FedBuff (lattice
and qsgd deltas, three flushes) and Sequential, on the 32-64-10 MLP (d=2762,
d_pad 4096) with n=8, s=4, K=2. Also ``compare`` and the registry.

Tolerances: bits exactly equal; the server within 1e-5 absolute for
identity codecs (fp32 sums in another order) and within one quantization
step of the round's codecs otherwise (a code may sit on an integer
boundary and round to either side); ``sim_time`` within 1e-5 relative;
FedBuff's event queue (client ids and times) exactly equal for the same
numpy seed.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_harness import (StepLog, npy, reference_fedavg_draws,
                                reference_fedbuff_draws,
                                reference_sequential_draws)
from repro.configs.base import FedConfig as RefFedConfig
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.fed.registry import make_algorithm as ref_make_algorithm
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import make_federated_classification
from repro_torch.fed import clock
from repro_torch.fed.registry import make_algorithm
from repro_torch.fed.simulate import compare, simulate
from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                    mlp_loss_batched)
from repro_torch.utils import interop

BATCH = 16
D = 2762
FED_KW = dict(n_clients=8, s=4, local_steps=2, lr=0.3, bits=8, swt=10.0)


def _setup():
    part, _ = ref_data(0, FED_KW["n_clients"], d=32, n_classes=10,
                       iid=False)
    params, _ = ref_init(jax.random.PRNGKey(0), 32, 64, 10)
    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    return part, params, template, data


def _ref_alg(name, params, **kw):
    return ref_make_algorithm(
        name, RefFedConfig(**FED_KW), loss_fn=ref_mlp_loss, template=params,
        batch_fn=lambda d, k: ref_client_batch(k, d, BATCH), **kw)


def _port_alg(name, template, **kw):
    alg = make_algorithm(name, FedConfig(**FED_KW), loss_fn=mlp_loss_batched,
                         template=template, batch_size=BATCH, device="cpu",
                         **kw)
    if hasattr(alg, "codec_up"):
        alg.codec_up = StepLog(alg.codec_up)
        alg.codec_down = StepLog(alg.codec_down)
    return alg


def _step(port):
    return max(port.codec_up.steps + port.codec_down.steps)


def _check_server(port, new, new_ref):
    diff = np.abs(npy(new.server) - npy(new_ref.server)).max()
    tol = max(_step(port), 1e-5)
    assert diff <= tol, (diff, tol)


def _check_round(port, new, m, new_ref, m_ref):
    assert m["bits_up"] == float(m_ref["bits_up"])
    assert m["bits_down"] == float(m_ref["bits_down"])
    assert new.bits_up == float(new_ref.bits_up)
    assert new.bits_down == float(new_ref.bits_down)
    assert new.t == int(new_ref.t)
    np.testing.assert_allclose(float(new.sim_time), float(new_ref.sim_time),
                               rtol=1e-5)
    _check_server(port, new, new_ref)


def _fedavg_state(state, cls_kw):
    kw = dict(server=npy(state.server),
              rows={k: npy(v) for k, v in state.pop.rows.items()},
              t=int(state.t), sim_time=npy(state.sim_time),
              bits_up=float(state.bits_up), bits_down=float(state.bits_down),
              device="cpu")
    if "srv_prev" in cls_kw:
        return interop.compressed_fedavg_state_from_numpy(
            srv_prev=npy(state.srv_prev),
            srv_dist_est=npy(state.srv_dist_est), **kw)
    return interop.fedavg_state_from_numpy(**kw)


@pytest.mark.parametrize("codecs", [{}, {"uplink": "lattice",
                                         "downlink": "lattice"}])
def test_fedavg_round_matches_reference(codecs):
    part, params, template, data = _setup()
    ref = _ref_alg("fedavg", params, **codecs)
    state, _ = ref.round(ref.init(params), part, jax.random.PRNGKey(11))
    port = _port_alg("fedavg", template, **codecs)
    key = jax.random.PRNGKey(12)
    draws = reference_fedavg_draws(ref, state, part, key, BATCH, port)
    pstate = _fedavg_state(state, {})
    new_ref, m_ref = ref.round(state, part, key)
    new, m = port.round(pstate, data, None, draws=draws)
    _check_round(port, new, m, new_ref, m_ref)
    per = 4 * (D * 32 if not codecs else 4096 * 8 + 32)
    assert m["bits_up"] == m["bits_down"] == per
    assert m["h_steps_mean"] == 2.0
    np.testing.assert_allclose(float(m["quant_err"]),
                               float(m_ref["quant_err"]), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("codecs", [
    {"uplink": "lattice"}, {"uplink": "lattice_packed:bits=4"},
    {"uplink": "scalar"}, {"uplink": "lattice", "downlink": "lattice"}])
def test_compressed_fedavg_two_rounds_match_reference(codecs):
    part, params, template, data = _setup()
    ref = _ref_alg("compressed_fedavg", params, **codecs)
    port = _port_alg("compressed_fedavg", template, **codecs)
    state = ref.init(params)
    pstate = _fedavg_state(state, {"srv_prev": True})
    for k in (11, 12):
        key = jax.random.PRNGKey(k)
        draws = reference_fedavg_draws(ref, state, part, key, BATCH, port)
        state, m_ref = ref.round(state, part, key)
        pstate, m = port.round(pstate, data, None, draws=draws)
        _check_round(port, pstate, m, state, m_ref)
        np.testing.assert_allclose(float(pstate.srv_dist_est),
                                   float(state.srv_dist_est), rtol=1e-3)
    up = {"lattice": 4096 * 8 + 32, "lattice_packed:bits=4": 4096 * 4 + 32,
          "scalar": D * 8 + 32}[codecs["uplink"]]
    assert m["bits_up"] == 4 * up
    assert m["bits_down"] == (4096 * 8 + 32 if "downlink" in codecs
                              else D * 32)


@pytest.mark.parametrize("quantizer", ["lattice", "qsgd"])
def test_fedbuff_flushes_match_reference(quantizer):
    part, params, template, data = _setup()
    kw = dict(buffer_size=5, quantize=True, quantizer=quantizer)
    ref = _ref_alg("fedbuff", params, **kw)
    port = _port_alg("fedbuff", template, **kw)
    m_samples = data["y"].shape[1]
    state, pstate = ref.init(params), port.init(template)
    for k in (21, 22, 23):
        key = jax.random.PRNGKey(k)
        draws = reference_fedbuff_draws(ref, state, key, BATCH, m_samples,
                                        port)
        state, m_ref = ref.round(state, part, key)
        pstate, m = port.round(pstate, data, None, draws=draws)
        # the same numpy seed: the same events, clients and times
        assert sorted(pstate.queue.events) == sorted(state.queue.events)
        _check_round(port, pstate, m, state, m_ref)
        assert m["round_time"] == m_ref["round_time"]
    up = 4096 * 8 + 32 if quantizer == "lattice" else D * 8 + 32
    assert m["bits_up"] == 5 * up and m["bits_down"] == 5 * D * 32

    # the reference's state carried across: one more flush on both
    pstate = interop.fedbuff_state_from_numpy(
        server=npy(state.server),
        start_model=[npy(v) for v in state.start_model],
        events=state.queue.events, buffer=[npy(v) for v in state.buffer],
        sim_time=state.sim_time, t=state.t, bits_up=state.bits_up,
        bits_down=state.bits_down, rng=state.rng, device="cpu")
    key = jax.random.PRNGKey(24)
    draws = reference_fedbuff_draws(ref, state, key, BATCH, m_samples, port)
    state, m_ref = ref.round(state, part, key)
    pstate, m = port.round(pstate, data, None, draws=draws)
    assert sorted(pstate.queue.events) == sorted(state.queue.events)
    _check_round(port, pstate, m, state, m_ref)


def test_sequential_round_matches_reference():
    part, params, template, data = _setup()
    ref = _ref_alg("sequential", params)
    port = _port_alg("sequential", template)
    state = ref.init(params)
    pstate = port.init(template)
    for k in (31, 32):
        key = jax.random.PRNGKey(k)
        draws = reference_sequential_draws(ref, part, key, BATCH)
        state, m_ref = ref.round(state, part, key)
        pstate, m = port.round(pstate, data, None, draws=draws)
        np.testing.assert_allclose(float(pstate.sim_time),
                                   float(state.sim_time), rtol=1e-5)
        assert m["bits_up"] == m["bits_down"] == 0.0
        np.testing.assert_allclose(npy(pstate.server), npy(state.server),
                                   atol=1e-5)


def test_straggler_round_time_and_arrivals():
    g = torch.Generator()
    g.manual_seed(0)
    lam = torch.tensor([0.5, 0.125, 0.5])
    dt = clock.straggler_round_time(g, lam, 5, 1.0)
    assert float(dt) > 1.0
    dur = torch.tensor([3.0, 9.0, 4.0])
    assert float(clock.straggler_round_time(g, lam, 5, 1.0, dur)) == 10.0
    # Gamma(K, λ) by sums of K exponentials: mean K/λ
    draws = [float(clock.straggler_round_time(g, torch.tensor([0.5]), 5,
                                              0.0)) for _ in range(400)]
    assert abs(np.mean(draws) - 10.0) < 1.0
    rng = np.random.default_rng(3)
    q = clock.ArrivalQueue.initial(rng, np.array([0.5, 0.125]), 4)
    assert len(q) == 2 and q.peek() == min(q.events)
    t, i = q.pop()
    q.push(t + clock.completion_time(rng, 4, 0.5), i)
    assert len(q.copy()) == 2


def _port_world(n=8, s=4):
    fed = FedConfig(**{**FED_KW, "n_clients": n, "s": s})
    part, test = make_federated_classification(0, n, d=32, iid=False,
                                               device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    p0 = init_mlp_classifier(g, 32, 64, 10)
    return fed, part, test, g, p0


def test_compare_runs_every_baseline_from_the_same_draws():
    fed, part, test, g, p0 = _port_world()
    kw = dict(loss_fn=mlp_loss_batched, template=p0, batch_size=16,
              device="cpu")
    algs = {"quafl": make_algorithm("quafl", fed, **kw),
            "fedavg": make_algorithm("fedavg", fed, **kw),
            "fedavg_again": make_algorithm("fedavg", fed, **kw),
            "compressed_fedavg": make_algorithm("compressed_fedavg", fed,
                                                **kw),
            "fedbuff": make_algorithm("fedbuff", fed, buffer_size=4,
                                      quantize=True, quantizer="lattice",
                                      **kw),
            "sequential": make_algorithm("sequential", fed, **kw)}

    def acc(p):
        return {"loss": float(mlp_loss(p, test)[0]),
                "acc": float(mlp_loss(p, test)[1]["acc"])}
    before = g.get_state()
    traces = compare(algs, p0, part, g, rounds=12, eval_every=6,
                     eval_fn=acc)
    assert torch.equal(g.get_state(), before)
    assert list(traces) == list(algs)
    assert [tr.algorithm for tr in traces.values()] == list(algs)
    a, b = traces["fedavg"], traces["fedavg_again"]
    assert torch.equal(a.final_state.server, b.final_state.server)
    assert a.final["sim_time"] == b.final["sim_time"]
    acc0 = acc(p0)["acc"]
    for name, tr in traces.items():
        assert tr.rounds == 12 and np.isfinite(tr.final["loss"]), name
        if name != "sequential":
            assert tr.final["acc"] > acc0, name
    assert traces["compressed_fedavg"].final["bits_up_total"] == \
        12 * 4 * (4096 * 8 + 32)
    assert traces["fedbuff"].final["bits_down_total"] == 12 * 4 * D * 32
    assert traces["sequential"].final["bits_up_total"] == 0.0
    tr = simulate(algs["fedavg"], p0, part, g, rounds=1, name="fa")
    assert tr.algorithm == "fa"


def test_fedbuff_run_legacy_loop():
    fed, part, test, g, p0 = _port_world()
    alg = make_algorithm("fedbuff", fed, loss_fn=mlp_loss_batched,
                         template=p0, batch_size=16, buffer_size=4,
                         device="cpu")
    hist = alg.run(p0, part, g, total_time=40.0, eval_every=10.0,
                   eval_fn=lambda p: float(mlp_loss(p, test)[0]))
    assert [h[0] for h in hist] == [0.0, 10.0, 20.0, 30.0, 40.0]
    assert hist[-1][2] > 0 and all(np.isfinite(h[1]) for h in hist)


def test_registry_builds_the_baselines():
    fed, part, _, g, p0 = _port_world()
    kw = dict(loss_fn=mlp_loss_batched, template=p0, device="cpu")
    names = {"fedavg": "FedAvg", "compressed_fedavg": "CompressedFedAvg",
             "fedbuff": "FedBuff", "sequential": "Sequential"}
    for name, cls in names.items():
        assert type(make_algorithm(name, fed, **kw)).__name__ == cls
    # fedbuff_device (ROADMAP Queue 1 item 10, ported): builds, and one
    # flush of 4 completions runs with FedBuff's bits
    dev = make_algorithm("fedbuff_device", fed, buffer_size=4,
                         batch_size=16, **kw)
    assert type(dev).__name__ == "FedBuffDevice"
    g_dev = torch.Generator()
    g_dev.manual_seed(0)
    st, m = dev.round(dev.init(p0), part, g_dev)
    assert int(st.t) == 1 and m["bits_up"] == m["bits_down"] == 4 * D * 32
    assert bool(torch.isfinite(st.server).all())
    # QuAFL with a scalar uplink runs the per-message branch
    alg = make_algorithm("quafl", fed, uplink="scalar", batch_size=16, **kw)
    assert alg.pipeline is None and alg.codec_up.name == "scalar"
    state, m = alg.round(alg.init(p0), part, g)
    assert m["bits_up"] == 4 * (D * 8 + 32)
    assert m["bits_down"] == 4096 * 8 + 32
    assert bool(torch.isfinite(state.server).all()) and state.t == 1


# FedBuff at the width of chip_smoke.py's baselines: the MLP 784-32-10,
# n=300 clients (by-class split), s=16, K=5, lr=0.3, Z=10, batch 32
CHIP_FED = dict(n_clients=300, s=16, local_steps=5, lr=0.3, bits=8, swt=10.0)
CHIP_BATCH = 32
CURVE_TOL = 1.2e-3   # the injected server's largest gap over 30 flushes


def fedbuff_curves(quant: str = "lattice", rounds: int = 30):
    """FedBuff's test loss and accuracy, flush by flush, from one seed:
    the reference; the port with the reference's draws injected into every
    flush (its server held against the reference's); the port drawing from
    its own generator. Yields one dict per flush (round 0 is the start) with
    (loss, accuracy) of each run on 4,096 test points and, from round 1,
    the injected run's largest server difference."""
    part, test = ref_data(0, CHIP_FED["n_clients"], d=784, n_classes=10,
                          iid=False, test_samples=4096)
    params, _ = ref_init(jax.random.PRNGKey(0), 784, 32, 10)
    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    ptest = interop.data_from_numpy({k: npy(v) for k, v in test.items()},
                                    "cpu")
    kw = dict(quantize=quant != "none",
              quantizer="lattice" if quant == "none" else quant)
    ref = ref_make_algorithm(
        "fedbuff", RefFedConfig(**CHIP_FED), loss_fn=ref_mlp_loss,
        template=params,
        batch_fn=lambda d, k: ref_client_batch(k, d, CHIP_BATCH), **kw)
    port, free = (make_algorithm("fedbuff", FedConfig(**CHIP_FED),
                                 loss_fn=mlp_loss_batched, template=template,
                                 batch_size=CHIP_BATCH, device="cpu", **kw)
                  for _ in range(2))

    def ev_ref(st):
        loss, aux = ref_mlp_loss(ref.eval_params(st), test)
        return float(loss), float(aux["acc"])

    def ev_port(alg, st):
        loss, aux = mlp_loss(alg.eval_params(st), ptest)
        return float(loss), float(aux["acc"])

    m = data["y"].shape[1]
    s_ref, s_port, s_free = (ref.init(params), port.init(template),
                             free.init(template))
    gen = torch.Generator()
    gen.manual_seed(0)
    yield {"codec": quant, "round": 0, "ref": ev_ref(s_ref),
           "port_injected": ev_port(port, s_port),
           "port_free": ev_port(free, s_free)}
    for r in range(rounds):
        key = jax.random.fold_in(jax.random.PRNGKey(1), r)
        draws = reference_fedbuff_draws(ref, s_ref, key, CHIP_BATCH, m, port)
        s_ref, _ = ref.round(s_ref, part, key)
        s_port, _ = port.round(s_port, data, None, draws=draws)
        s_free, _ = free.round(s_free, data, gen)
        yield {"codec": quant, "round": r + 1, "ref": ev_ref(s_ref),
               "port_injected": ev_port(port, s_port),
               "port_free": ev_port(free, s_free),
               "server_max_abs_diff": float(np.abs(
                   npy(s_port.server) - npy(s_ref.server)).max()),
               "server_max_abs": float(np.abs(npy(s_ref.server)).max())}


def test_fedbuff_curve_tracks_reference_at_chip_width():
    """The first flushes of the curve that settled whether FedBuff's rising
    test loss is the port's or the algorithm's: with the reference's draws
    injected, the port's server and test loss track the reference's."""
    rows = list(fedbuff_curves("lattice", rounds=4))
    assert rows[0]["ref"] == pytest.approx(rows[0]["port_injected"],
                                           abs=1e-5)
    for row in rows[1:]:
        assert row["server_max_abs_diff"] <= CURVE_TOL, row
        assert abs(row["ref"][0] - row["port_injected"][0]) <= 1e-3, row
        assert np.isfinite(row["port_free"][0]), row


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_baselines.py [lattice|qsgd|none]
    # prints the 30-flush curves as JSON lines (about a minute on a CPU)
    import json
    import sys
    for row in fedbuff_curves(*sys.argv[1:]):
        print(json.dumps(row), flush=True)
