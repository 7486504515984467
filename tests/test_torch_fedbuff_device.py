"""``fedbuff_device`` (``repro_torch.core.fedbuff.FedBuffDevice``) on the
CPU: FedBuff's event simulation on a device ring buffer.

With the seed bridge's table, built from the integer the host ``fedbuff``
draws on its first round, the device algorithm walks the host algorithm's
events: the same pop order and bits exactly, event times within rtol 1e-6
(the ring keeps fp32 times, the heap fp64 sums) and the server within
rtol 1e-5, atol 1e-6, the reference's own tolerances for its bridge
(``tests/test_engine.py``). An exhausted table poisons the clock with NaN;
without a table the durations are device draws, deterministic given the
generator. The reference's device state crosses into the port through
``interop.fedbuff_device_state_from_numpy``.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_harness import npy
from repro.configs.base import FedConfig as RefFedConfig
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.fed.engine import fedbuff_completion_table as ref_table
from repro.fed.registry import make_algorithm as ref_make_algorithm
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.configs.base import FedConfig
from repro_torch.core import fedbuff as fb
from repro_torch.data.synthetic import make_federated_classification
from repro_torch.fed import (ArrivalQueue, fedbuff_completion_table,
                             fedbuff_event_seed, make_algorithm, ring_size)
from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched
from repro_torch.utils import interop

FED_KW = dict(n_clients=5, s=3, local_steps=2, lr=0.2, bits=8)


def _world(n=5, seed=1):
    fed = FedConfig(**{**FED_KW, "n_clients": n})
    part, _ = make_federated_classification(seed, n, d=16, n_classes=4,
                                            iid=True, device="cpu")
    g = torch.Generator()
    g.manual_seed(seed)
    return fed, part, init_mlp_classifier(g, 16, 32, 4)


def _alg(name, fed, p0, **kw):
    return make_algorithm(name, fed, loss_fn=mlp_loss_batched, template=p0,
                          batch_size=8, device="cpu", **kw)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("codec", [{}, {"quantize": True,
                                        "quantizer": "lattice"},
                                   {"downlink": "lattice"}])
def test_with_the_table_it_walks_the_host_fedbuffs_events(codec,
                                                           monkeypatch):
    """Six flushes of Z=3 from copies of one generator: the pops (client
    ids exact, times rtol 1e-6), every flush's bits and sim_time, the
    server, and the generator's final state (the same draws consumed)."""
    fed, part, p0 = _world()
    rounds, Z = 6, 3
    kw = dict(buffer_size=Z, server_lr=0.5, **codec)
    g_py, g_dev = _gen(11), _gen(11)
    seed = fedbuff_event_seed(g_py)
    assert torch.equal(g_py.get_state(), g_dev.get_state())
    py = _alg("fedbuff", fed, p0, **kw)
    table = fedbuff_completion_table(seed, py.lam, fed.local_steps,
                                     Z * rounds + 2)
    dev = _alg("fedbuff_device", fed, p0, completion_table=table, **kw)

    pops_py, pops_dev = [], []
    heap_pop, ring_pop = ArrivalQueue.pop, fb.ring_pop

    def log_heap(self):
        ev = heap_pop(self)
        pops_py.append(ev)
        return ev

    def log_ring(rb):
        out = ring_pop(rb)
        pops_dev.append((float(out[1]), int(out[2])))
        return out

    monkeypatch.setattr(ArrivalQueue, "pop", log_heap)
    monkeypatch.setattr(fb, "ring_pop", log_ring)
    sp, sd = py.init(p0), dev.init(p0)
    for _ in range(rounds):
        sp, mp = py.round(sp, part, g_py)
        sd, md = dev.round(sd, part, g_dev)
        np.testing.assert_allclose(float(md["sim_time"]),
                                   float(mp["sim_time"]), rtol=1e-6)
        assert float(md["bits_up"]) == float(mp["bits_up"])
        assert float(md["bits_down"]) == float(mp["bits_down"])
    assert [c for _, c in pops_dev] == [c for _, c in pops_py]
    assert len(pops_dev) == Z * rounds
    np.testing.assert_allclose([t for t, _ in pops_dev],
                               [t for t, _ in pops_py], rtol=1e-6)
    torch.testing.assert_close(sd.server, sp.server, rtol=1e-5, atol=1e-6)
    assert int(sd.t) == sp.t == rounds
    assert float(sd.bits_up) == sp.bits_up
    assert torch.equal(g_py.get_state(), g_dev.get_state())
    # one pending event a client, each drawn once more than it completed
    assert int(ring_size(sd.queue)) == fed.n_clients
    assert int(sd.occ.sum()) == fed.n_clients + Z * rounds


def test_an_exhausted_table_poisons_the_clock():
    """Past the table's replayed events the next duration is NaN, not a
    clamped gather: an event stream no longer pinned to the host's is
    loud."""
    fed, part, p0 = _world(n=3)
    lam = np.full(3, fed.lam_fast, np.float32)
    table = fedbuff_completion_table(0, lam, fed.local_steps, n_events=1)
    alg = _alg("fedbuff_device", fed, p0, buffer_size=2,
               completion_table=table)
    st, g = alg.init(p0), _gen(0)
    for _ in range(4):    # 8 completions past the one replayed redraw
        st, _ = alg.round(st, part, g)
    assert np.isnan(float(st.sim_time))


def test_without_a_table_the_draws_are_deterministic():
    """Device Gamma(K, 1/λ) durations: the same generator seed gives the
    same trajectory, another seed another one."""
    fed, part, p0 = _world(n=4)
    alg = _alg("fedbuff_device", fed, p0, buffer_size=2)
    runs = []
    for seed in (4, 4, 5):
        st, g = alg.init(p0), _gen(seed)
        for _ in range(3):
            st, m = alg.round(st, part, g)
        runs.append((st.server.clone(), float(st.sim_time)))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    assert runs[0][1] != runs[2][1]
    assert np.isfinite(runs[0][1]) and runs[0][1] > 0


@pytest.mark.parametrize("quantizer", ["qsgd", "lattice"])
def test_quantized_deltas_ride_the_device_round(quantizer):
    """qsgd and lattice deltas: a flush's bits are Z messages each way,
    its quant_err finite and above 0, the server finite."""
    fed, part, p0 = _world(n=4)
    alg = _alg("fedbuff_device", fed, p0, buffer_size=2, quantize=True,
               quantizer=quantizer)
    st, m = alg.round(alg.init(p0), part, _gen(2))
    assert m["bits_up"] == 2 * alg.codec_up.message_bits(alg.d)
    assert m["bits_down"] == 2 * alg.d * 32
    assert np.isfinite(float(m["quant_err"])) and float(m["quant_err"]) > 0
    assert bool(torch.isfinite(st.server).all())
    with pytest.raises(ValueError, match="not seeded"):
        alg.device_round(alg.init(p0), part, _gen(2))


def test_the_reference_device_state_carries_into_the_port():
    """Two flushes of the reference's fedbuff_device (seed bridge on), its
    state as numpy into the port: every field equal, and the port's round
    runs on from it (already live: it draws no seed)."""
    fed_kw = dict(FED_KW, n_clients=4)
    part, _ = ref_data(0, 4, d=16, n_classes=4, iid=True)
    params, _ = ref_init(jax.random.PRNGKey(0), 16, 32, 4)
    key = jax.random.PRNGKey(7)
    lam = np.full(4, RefFedConfig(**fed_kw).lam_fast, np.float32)
    table = ref_table(key, lam, 2, n_events=12)
    ref = ref_make_algorithm(
        "fedbuff_device", RefFedConfig(**fed_kw), loss_fn=ref_mlp_loss,
        template=params, batch_fn=lambda d, k: ref_client_batch(k, d, 8),
        buffer_size=2, completion_table=table, uniform_speeds=True)
    st = ref.init(params)
    for _ in range(2):
        st, _ = ref.round(st, part, key)
    port = interop.fedbuff_device_state_from_numpy(
        server=npy(st.server), rows={k: npy(v) for k, v in
                                     st.pop.rows.items()},
        queue_times=npy(st.queue.times), queue_clients=npy(st.queue.clients),
        sim_time=npy(st.sim_time), t=npy(st.t), bits_up=npy(st.bits_up),
        bits_down=npy(st.bits_down), live=npy(st.live), device="cpu")
    np.testing.assert_array_equal(npy(port.server), npy(st.server))
    np.testing.assert_array_equal(npy(port.start), npy(st.start))
    np.testing.assert_array_equal(npy(port.occ), npy(st.occ))
    np.testing.assert_array_equal(npy(port.queue.times), npy(st.queue.times))
    np.testing.assert_array_equal(npy(port.queue.clients),
                                  npy(st.queue.clients))
    assert float(port.sim_time) == float(st.sim_time) and int(port.t) == 2
    assert float(port.bits_up) == float(st.bits_up) and port.live
    fed = FedConfig(**fed_kw)
    template = interop.params_from_numpy({k: npy(v) for k, v in
                                          params.items()}, "cpu")
    alg = _alg("fedbuff_device", fed, template, buffer_size=2,
               completion_table=table, uniform_speeds=True)
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    g = _gen(0)
    before = g.get_state()
    new, m = alg.round(port, data, g)
    assert int(new.t) == 3 and float(m["sim_time"]) >= float(st.sim_time)
    assert bool(torch.isfinite(new.server).all())
    # a live state draws no event seed: only the completions' batches
    g2 = _gen(0)
    g2.set_state(before)
    for _ in range(2):
        torch.randint(0, data["y"].shape[1], (2, 8), generator=g2)
    assert torch.equal(g.get_state(), g2.get_state())
