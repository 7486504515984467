"""The rest of the quickstart path against the reference, on the
quickstart's 32-64-10 MLP (d=2762, d_pad 4096; n=16, s=4, K=5): QuAFL's
per-message branch (``scalar`` and ``identity`` uplinks, ``scalar`` and
``lattice`` downlinks) with the reference's message keys injected; the
``until_bits`` budget and the backstop's final row of ``simulate``;
``mean_model``; the ``FedAlgorithm`` protocol and the algorithm registry;
and the quickstart and heterogeneous-clients twins on the CPU.

Tolerances: bits exactly the reference's; the server and the clients within
one quantization step of the round's codecs (‖x‖/127 for ``scalar``, γ for
``lattice``); an ``identity`` uplink decodes exactly.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_harness import (StepLog, npy, port_quafl_state,
                                reference_message_keys,
                                reference_round_draws, tt)
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.quafl import QuAFL as RefQuAFL
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.fed import registry as ref_registry
from repro.fed.simulate import simulate as ref_simulate
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.configs.base import FedConfig
from repro_torch.examples import heterogeneous_clients, quickstart
from repro_torch.fed import (FedAlgorithm, make_algorithm,
                             register_algorithm, registered_algorithms,
                             simulate)
from repro_torch.fed import registry
from repro_torch.models.mlp import mlp_loss, mlp_loss_batched
from repro_torch.utils import interop

BATCH = 16
D = 2762
FED_KW = dict(n_clients=16, s=4, local_steps=5, lr=0.3, bits=8, swt=10.0)


def _world():
    part, test = ref_data(0, FED_KW["n_clients"], d=32, n_classes=10,
                          iid=False)
    params, _ = ref_init(jax.random.PRNGKey(0), 32, 64, 10)
    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    return part, test, params, template, data


def _ref_quafl(params, **kw):
    return RefQuAFL(fed=RefFedConfig(**FED_KW), loss_fn=ref_mlp_loss,
                    template=params,
                    batch_fn=lambda d, k: ref_client_batch(k, d, BATCH),
                    **kw)


# (uplink, downlink, bits up, bits down) a round at d=2762, s=4
PER_MESSAGE = [
    ("scalar", "scalar", 4 * (D * 8 + 32), D * 8 + 32),
    ("identity", "scalar", 4 * D * 32, D * 8 + 32),
    ("scalar", "lattice", 4 * (D * 8 + 32), 4096 * 8 + 32),
]


@pytest.mark.parametrize("uplink,downlink,up,down", PER_MESSAGE)
@pytest.mark.parametrize("avg_mode", ["both", "none"])
def test_per_message_round_matches_reference(uplink, downlink, up, down,
                                             avg_mode):
    part, _, params, template, data = _world()
    ref = _ref_quafl(params, uplink=uplink, downlink=downlink,
                     avg_mode=avg_mode)
    assert ref.pipeline is None
    state, _ = ref.round(ref.init(params), part, jax.random.PRNGKey(11))
    key = jax.random.PRNGKey(12)
    port = make_algorithm("quafl", FedConfig(**FED_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, uplink=uplink, downlink=downlink,
                          avg_mode=avg_mode, device="cpu")
    assert port.pipeline is None
    draws = {k: tt(v) for k, v in
             reference_round_draws(ref, state, part, key, BATCH).items()}
    draws.update(reference_message_keys(ref, key, port))
    port_state = port_quafl_state(state)
    new_ref, m_ref = ref.round(state, part, key)
    port.codec_up = StepLog(port.codec_up)
    port.codec_down = StepLog(port.codec_down)
    new, m = port.round(port_state, data, None, draws=draws)

    assert m["bits_up"] == float(m_ref["bits_up"]) == up
    assert m["bits_down"] == float(m_ref["bits_down"]) == down
    assert new.bits_up == float(new_ref.bits_up)
    step_up = max(port.codec_up.steps)
    step = max(step_up, max(port.codec_down.steps))
    srv_diff = np.abs(npy(new.server) - npy(new_ref.server)).max()
    cl_diff = np.abs(npy(new.clients) - npy(new_ref.clients)).max()
    # an identity uplink decodes exactly: the server then differs only by
    # the fp32 rounding of local SGD
    assert srv_diff <= (1e-5 if uplink == "identity" else step_up), srv_diff
    assert cl_diff <= step, (cl_diff, step)
    np.testing.assert_allclose(float(m["quant_err"]),
                               float(m_ref["quant_err"]), rtol=1e-3)
    if uplink == "identity":
        assert float(m["quant_err"]) == 0.0
    np.testing.assert_allclose(float(new.srv_dist_est),
                               float(new_ref.srv_dist_est), rtol=1e-3)


def test_until_bits_stops_after_the_same_round():
    """10 × 164,000 bits (131,200 up + 32,800 down a round) is 10 rounds in
    both packages; a budget one bit above takes an 11th."""
    part, _, params, template, data = _world()
    ref = _ref_quafl(params)
    port = make_algorithm("quafl", FedConfig(**FED_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, device="cpu")
    for budget, rounds in ((10 * 164_000, 10), (10 * 164_000 + 1, 11)):
        tr_ref = ref_simulate(ref, params, part, jax.random.PRNGKey(1),
                              until_bits=budget, eval_every=0)
        g = torch.Generator()
        g.manual_seed(1)
        tr = simulate(port, template, data, g, until_bits=budget,
                      eval_every=0)
        assert tr.rounds == tr_ref.rounds == rounds
        assert tr.final["bits_up_total"] == float(
            tr_ref.final["bits_up_total"]) == rounds * 131_200
    with pytest.raises(ValueError, match="until_bits"):
        simulate(port, template, data, g)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        simulate(port, template, data, g, rounds=2, scan_chunk=2)


@pytest.mark.parametrize("record_every,max_rounds", [(1, 3), (2, 3), (2, 4)])
def test_backstop_rows_match_reference(record_every, max_rounds):
    """An unreachable sim-time budget ends on ``max_rounds``: the final
    round's row carries the eval once, and ``on_row`` fires once a row, as
    in the reference's ``_Recorder.finalize``."""
    part, test, params, template, data = _world()
    ref = _ref_quafl(params)
    port = make_algorithm("quafl", FedConfig(**FED_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, device="cpu")
    kw = dict(until_sim_time=1e12, max_rounds=max_rounds, eval_every=0,
              record_every=record_every)
    streamed_ref, streamed = [], []
    tr_ref = ref_simulate(
        ref, params, part, jax.random.PRNGKey(1), on_row=streamed_ref.append,
        eval_fn=lambda p: {"acc": float(ref_mlp_loss(p, test)[1]["acc"])},
        **kw)
    g = torch.Generator()
    g.manual_seed(1)
    ptest = interop.data_from_numpy({k: npy(v) for k, v in test.items()},
                                    "cpu")
    tr = simulate(port, template, data, g, on_row=streamed.append,
                  eval_fn=lambda p: {"acc": float(mlp_loss(p, ptest)[1]
                                                  ["acc"])}, **kw)

    def shape(rows):
        return [(r["round"], "acc" in r, r["bits_up_total"],
                 r["bits_down_total"]) for r in rows]
    assert shape(tr.rows) == [(r, a, float(u), float(d))
                              for r, a, u, d in shape(tr_ref.rows)]
    assert shape(streamed) == shape(tr.rows)
    assert [r["round"] for r in streamed] == [r["round"] for r in
                                              streamed_ref]
    assert tr.rows[-1]["round"] == tr.rounds == max_rounds
    assert sum("acc" in r for r in tr.rows) == 1
    assert 0.0 < tr.eval_time_s < tr.wall_time_s
    assert tr.us_per_round == pytest.approx(
        (tr.wall_time_s - tr.eval_time_s) / max_rounds * 1e6)


def test_mean_model_matches_reference():
    part, _, params, template, data = _world()
    ref = _ref_quafl(params)
    state = ref.init(params)
    for k in (11, 12):
        state, _ = ref.round(state, part, jax.random.PRNGKey(k))
    port = make_algorithm("quafl", FedConfig(**FED_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, device="cpu")
    got = port.mean_model(port_quafl_state(state))
    want = ref.mean_model(state)
    for k in got:
        np.testing.assert_allclose(npy(got[k]), npy(want[k]), rtol=1e-5,
                                   atol=1e-7)


def test_fed_algorithm_protocol_and_registry():
    _, _, _, template, data = _world()
    fed = FedConfig(**FED_KW)
    assert registered_algorithms() == ref_registry.registered_algorithms()
    kw = dict(loss_fn=mlp_loss_batched, template=template, batch_size=BATCH,
              device="cpu")
    for name in ("quafl", "fedavg", "compressed_fedavg", "fedbuff",
                 "sequential"):
        assert isinstance(make_algorithm(name, fed, **kw), FedAlgorithm)
    for name in ("quafl_scaffold", "fedbuff_device", "spmd"):
        with pytest.raises(NotImplementedError, match="Queue 1 item"):
            make_algorithm(name, fed, **kw)
    with pytest.raises(ValueError, match="already registered"):
        register_algorithm("quafl", None)
    with pytest.raises(ValueError, match="already registered"):
        register_algorithm("spmd", None)

    def build(fed, loss_fn, template, **kw):
        return make_algorithm("quafl", fed, loss_fn=loss_fn,
                              template=template, avg_mode="server_only",
                              **kw)
    register_algorithm("test_quafl_server_only", build)
    try:
        assert registered_algorithms()[-1] == "test_quafl_server_only"
        alg = make_algorithm("test_quafl_server_only", fed, **kw)
        assert isinstance(alg, FedAlgorithm) and alg.avg_mode == "server_only"
        g = torch.Generator()
        g.manual_seed(0)
        assert simulate(alg, template, data, g, rounds=2).rounds == 2
    finally:
        registry._BUILDERS.pop("test_quafl_server_only")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        make_algorithm("quafl", fed, client_mesh=object(), **kw)
    assert not isinstance(object(), FedAlgorithm)


def test_quickstart_twin_bits_per_round(capsys):
    """The quickstart twin at a 12-round budget: each run's bits exactly
    the codecs' accounting, the grouped uplink's from each round's
    sampled ids (ids 0-4 are slow: 16,448 bits a message, else 32,832)."""
    dev = torch.device("cpu")
    params0, part, test = quickstart.setup(dev)
    algs = quickstart.build(quickstart.FED, params0, dev)
    sampled = []
    het = algs["quafl_het"]
    inner = het.part

    class Recording:
        def __getattr__(self, name):
            return getattr(inner, name)

        def sample(self, *a, **k):
            sampled.append(inner.sample(*a, **k))
            return sampled[-1]
    het.part = Recording()
    traces = quickstart.run(algs, params0, part, test, dev, rounds=12)
    q, h = traces["quafl"], traces["quafl_het"]
    assert q.rounds == h.rounds == 12
    assert q.final["bits_up_total"] == 12 * 131_200
    assert q.final["bits_down_total"] == 12 * 32_800
    n_slow = [int((idx < 5).sum()) for idx in sampled]
    assert len(n_slow) == 12 and 0 < sum(n_slow)
    assert h.final["bits_up_total"] == sum(131_328 - 16_384 * k
                                           for k in n_slow)
    assert h.final["bits_up"] == 131_328 - 16_384 * n_slow[-1]
    assert h.final["bits_down_total"] == 12 * 32_800
    for name, up, down in (("fedavg", 353_536, 353_536),
                           ("fedpaq", 88_512, 88_384)):
        tr = traces[name]
        assert tr.final["bits_up"] == up and tr.final["bits_down"] == down
        assert tr.final["bits_up_total"] == tr.rounds * up
        assert tr.final["bits_down_total"] == tr.rounds * down
        assert tr.final["sim_time"] >= 12 * 11.0
    quickstart.report(traces)
    out = capsys.readouterr().out
    assert out.startswith("algorithm | rounds |  sim t |   acc |")
    ratio = float(out.split("sends ")[1].split("x fewer uplink")[0])
    assert ratio > 1.0


def test_quickstart_and_heterogeneous_cli_on_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\n") >= 9 and "quafl_het |    120 |" in out
    traces = heterogeneous_clients.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "cyclic availability:" in out
    assert (traces["grouped"].final["bits_up_total"]
            < traces["uniform"].final["bits_up_total"])
    assert (traces["cyclic"].final["sim_time"]
            == traces["uniform"].final["sim_time"] == 120 * 3.0)
