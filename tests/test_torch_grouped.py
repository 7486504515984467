"""The grouped per-client uplink against the reference: one QuAFL round
with ``uplink={"fast": "lattice", "slow": "lattice_packed:bits=4"}`` on the
quickstart's 32-64-10 MLP (d=2762, d_pad 4096; n=16, s=4, 5 slow clients)
with the reference's state and draws injected, on the reference's ``jnp``
backend and once on ``pallas_interpret``; and ``resolve_codec``'s group
grammar and errors.

Tolerances: the server and the clients within one lattice step, the
round's largest γ either direction (a slow message's γ is 16x a fast
one's); bits exactly the reference's (each slow message 16,448 bits, each
fast one 32,832, the downlink 32,800). Over 20 rounds the port's own state
tracks the reference's round by round (tolerances in that test).
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_harness import (npy, port_quafl_state,
                                reference_round_draws, tt)
from repro.compression import codecs as ref_codecs
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.quafl import QuAFL as RefQuAFL
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.compression import codecs
from repro_torch.configs.base import FedConfig
from repro_torch.fed.registry import make_algorithm
from repro_torch.models.mlp import mlp_loss_batched
from repro_torch.utils import interop

BATCH = 16
D = 2762
FED_KW = dict(n_clients=16, s=4, local_steps=5, lr=0.3, bits=8, swt=10.0)
GROUPED = {"fast": "lattice", "slow": "lattice_packed:bits=4"}
SLOW_MASK = np.arange(16) < 5          # 30% of 16 clients, ids 0-4


def _reference(backend):
    fed = RefFedConfig(**FED_KW, kernel_backend=backend)
    part, _ = ref_data(0, fed.n_clients, d=32, n_classes=10, iid=False)
    params, _ = ref_init(jax.random.PRNGKey(0), 32, 64, 10)
    alg = RefQuAFL(fed=fed, loss_fn=ref_mlp_loss, template=params,
                   batch_fn=lambda d, k: ref_client_batch(k, d, BATCH),
                   uplink=GROUPED)
    state = alg.init(params)
    state, _ = alg.round(state, part, jax.random.PRNGKey(11))
    return alg, state, part, params


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
def test_grouped_round_matches_reference(backend):
    alg, state, part, params = _reference(backend)
    # this key samples slow and fast clients alike: both moduli in a round
    key = jax.random.PRNGKey(4)
    draws = reference_round_draws(alg, state, part, key, BATCH)
    idx = draws["idx"]
    assert SLOW_MASK[idx].any() and not SLOW_MASK[idx].all(), idx
    port_state = port_quafl_state(state)
    new_ref, m_ref = alg.round(state, part, key)

    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    port = make_algorithm("quafl", FedConfig(**FED_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, uplink=GROUPED, device="cpu")
    assert isinstance(port.codec_up, codecs.GroupedLatticeCodec)
    np.testing.assert_array_equal(
        npy(port.codec_up.wire(tt(idx)).levels),
        npy(alg.codec_up.wire(idx).levels))
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    seen = []
    gammas = port.pipeline.gammas
    port.pipeline.gammas = lambda *a, **k: seen.append(gammas(*a, **k)) \
        or seen[-1]
    new, m = port.round(port_state, data, None,
                        draws={k: tt(v) for k, v in draws.items()})

    n_slow = int(SLOW_MASK[idx].sum())
    assert m["bits_up"] == float(m_ref["bits_up"]) == \
        131_328 - 16_384 * n_slow
    assert m["bits_down"] == float(m_ref["bits_down"]) == 32_800
    assert new.bits_up == float(new_ref.bits_up)
    step = max(float(g.max()) for g in seen)
    np.testing.assert_array_less(
        np.abs(npy(new.server) - npy(new_ref.server)).max(), step)
    np.testing.assert_array_less(
        np.abs(npy(new.clients) - npy(new_ref.clients)).max(), step)
    np.testing.assert_allclose(float(new.srv_dist_est),
                               float(new_ref.srv_dist_est), rtol=1e-4)
    np.testing.assert_allclose(float(m["quant_err"]),
                               float(m_ref["quant_err"]), rtol=1e-3)


def test_grouped_rounds_track_reference():
    """20 grouped rounds, the port's state carried on its own from the
    reference's after round one, with the reference's draws injected each
    round: a divergence that builds over rounds (srv_dist_est feeding the
    next round's γ, wraps of slow messages) would show here. Every round:
    bits exact; quant_err and srv_dist_est within 1e-3 relative (a single
    ±1 code moves them by at most ~4e-4 at this size); server and clients
    within the round's smallest uplink γ over s+1, the room of one ±1 code
    in a fast message."""
    alg, state, part, params = _reference("jnp")
    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    port = make_algorithm("quafl", FedConfig(**FED_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, uplink=GROUPED, device="cpu")
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    port_state = port_quafl_state(state)
    seen = []
    gammas = port.pipeline.gammas
    port.pipeline.gammas = lambda *a, **k: seen.append(gammas(*a, **k)) \
        or seen[-1]
    slow = []
    for r in range(20):
        key = jax.random.PRNGKey(100 + r)
        draws = reference_round_draws(alg, state, part, key, BATCH)
        slow.append(int(SLOW_MASK[draws["idx"]].sum()))
        state, m_ref = alg.round(state, part, key)
        seen.clear()
        port_state, m = port.round(port_state, data, None,
                                   draws={k: tt(v) for k, v in draws.items()})
        assert m["bits_up"] == float(m_ref["bits_up"]), r
        np.testing.assert_allclose(float(m["quant_err"]),
                                   float(m_ref["quant_err"]), rtol=1e-3)
        np.testing.assert_allclose(float(port_state.srv_dist_est),
                                   float(state.srv_dist_est), rtol=1e-3)
        room = float(seen[0].min()) / (FED_KW["s"] + 1)
        for got, want in ((port_state.server, state.server),
                          (port_state.clients, state.clients)):
            np.testing.assert_array_less(
                np.abs(npy(got) - npy(want)).max(), room)
    assert 0 < sum(slow) and 0 in slow       # both kinds of round ran
    assert port_state.bits_up == float(state.bits_up)


def test_grouped_codec_accounting_matches_reference():
    got = codecs.resolve_codec(GROUPED, FedConfig(**FED_KW), direction="up",
                               slow_mask=SLOW_MASK)
    want = ref_codecs.resolve_codec(GROUPED, RefFedConfig(**FED_KW),
                                    direction="up", slow_mask=SLOW_MASK)
    assert got.bits == want.bits == 8 and got.pack == want.pack == 1
    assert got.message_bits(D) == want.message_bits(D) == 4096 * 8 + 64
    np.testing.assert_array_equal(got.message_bits_per_client(D),
                                  want.message_bits_per_client(D))
    for ids in ([0, 1, 2, 3], [5, 6, 7, 8], [4, 5, 15, 0]):
        assert got.bits_for(torch.tensor(ids), D) == float(
            want.bits_for(np.asarray(ids), D))
    np.testing.assert_array_equal(npy(got.wire().levels),
                                  npy(want.wire().levels))
    # the chip width: fast 262,208 bits, slow 131,136
    assert got.message_bits_per_client(25_450)[[0, 5]].tolist() == [
        131_136, 262_208]


def test_grouped_bits_for_builds_its_table_once(monkeypatch):
    """``bits_for`` sums a per-device table made on first use: later rounds
    run nothing that grows with the number of clients."""
    got = codecs.resolve_codec(GROUPED, FedConfig(**FED_KW), direction="up",
                               slow_mask=SLOW_MASK)
    calls = []
    table = codecs.GroupedLatticeCodec.message_bits_per_client
    monkeypatch.setattr(codecs.GroupedLatticeCodec, "message_bits_per_client",
                        lambda self, d: calls.append(d) or table(self, d))
    want = table(got, D)
    for ids in ([0, 1, 2, 3], [5, 6, 7, 8], [4, 5, 15, 0]):
        assert got.bits_for(torch.tensor(ids), D) == int(want[ids].sum())
    assert calls == [D]


GROUP_SPECS = [
    {"fast": "lattice", "slow": "lattice_packed:bits=4"},
    {"fast": "lattice:bits=6", "slow": "lattice:bits=3"},
    {"slow": "lattice_packed:bits=2"},         # fast falls back to slow
    {"fast": "lattice_packed"},                # slow falls back to fast
]


@pytest.mark.parametrize("spec", GROUP_SPECS)
def test_group_grammar_matches_reference(spec):
    got = codecs.resolve_codec(spec, FedConfig(**FED_KW), direction="up",
                               slow_mask=SLOW_MASK)
    want = ref_codecs.resolve_codec(spec, RefFedConfig(**FED_KW),
                                    direction="up", slow_mask=SLOW_MASK)
    assert got.bits_per_client == want.bits_per_client
    assert got.wire_width_per_client == want.wire_width_per_client
    assert (got.block, got.safety, got.bits) == (want.block, want.safety,
                                                 want.bits)


GROUP_ERRORS = [
    ({"fast": "lattice"}, "down", SLOW_MASK, ValueError),
    ({"fast": "lattice"}, "up", None, ValueError),
    ({"medium": "lattice"}, "up", SLOW_MASK, ValueError),
    ({"fast": "lattice", "slow": "scalar"}, "up", SLOW_MASK,
     NotImplementedError),
    ({"fast": "lattice", "slow": "lattice:safety=4"}, "up", SLOW_MASK,
     ValueError),
    ({"fast": "lattice", "slow": "nope"}, "up", SLOW_MASK, ValueError),
]


@pytest.mark.parametrize("spec,direction,mask,exc", GROUP_ERRORS)
def test_group_errors_match_reference(spec, direction, mask, exc):
    msgs = []
    for resolve, fed in ((codecs.resolve_codec, FedConfig(**FED_KW)),
                         (ref_codecs.resolve_codec,
                          RefFedConfig(**FED_KW))):
        with pytest.raises(exc) as err:
            resolve(spec, fed, direction=direction, slow_mask=mask)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_codec_registry_matches_reference():
    assert codecs.registered_codecs() == ref_codecs.registered_codecs()
    with pytest.raises(ValueError, match="already registered"):
        codecs.register_codec("lattice", None)
    codecs.register_codec("test_half_scalar",
                          lambda **kw: codecs.ScalarCodec(bits=4))
    try:
        c = codecs.make_codec("test_half_scalar")
        assert isinstance(c, codecs.Codec) and c.bits == 4
        assert codecs.make_codec(c) is c
    finally:
        codecs._CODECS.pop("test_half_scalar")
    with pytest.raises(TypeError, match="codec spec"):
        codecs.make_codec(42)
