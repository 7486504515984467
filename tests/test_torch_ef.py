"""Error feedback against the reference: the ``topk_ef`` codec and
``ErrorFeedbackQSGD``, then the stateful branches of compressed FedAvg,
FedBuff and QuAFL on the quickstart's 32-64-10 MLP (d=2762, d_pad 4096),
with the reference's draws injected.

Tolerances:

* ``topk_ef`` does no arithmetic: its index sets, values, decodes and
  residuals are bit-equal to the reference's over threaded calls with ties
  present (index SETS are compared, not the order of ``idx``), and
  decoded + new residual == delta + old residual bit for bit.
* ``ErrorFeedbackQSGD``: codes bit-equal with the reference's u injected;
  the decoded value and the residual within 1e-6 of max|·| (the ‖x‖ sum
  runs in another order).
* Rounds (3 each): bits exactly the reference's; the server and the
  residual rows within 1e-5 of their max|·| (local SGD rounds in another
  order, and the top-k messages carry those values); QuAFL's clients
  within the lattice downlink's step γ on top of that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import (StepLog, gauss, message_key, npy,
                                port_quafl_state, reference_fedavg_draws,
                                reference_fedbuff_draws,
                                reference_message_keys,
                                reference_round_draws, tt)
from repro.compression import codecs as ref_codecs
from repro.compression.codecs import TopKMsg
from repro.compression.error_feedback import \
    ErrorFeedbackQSGD as RefErrorFeedbackQSGD
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.quafl import QuAFL as RefQuAFL
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.fed.registry import make_algorithm as ref_make_algorithm
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.compression import codecs
from repro_torch.compression.error_feedback import (EFState,
                                                    ErrorFeedbackQSGD)
from repro_torch.compression.lattice import MessageKey
from repro_torch.configs.base import FedConfig
from repro_torch.fed.registry import make_algorithm
from repro_torch.models.mlp import mlp_loss_batched
from repro_torch.utils import interop

BATCH = 16
D = 2762
FED_KW = dict(n_clients=8, s=4, local_steps=2, lr=0.3, bits=8, swt=10.0)


def _tied(seed, m, d):
    """Messages full of equal magnitudes: values on a coarse grid of both
    signs, a third of them exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(m, d)).astype(np.float32) * 0.25
    x[rng.random((m, d)) < 0.33] = 0.0
    return x


def _ref_topk(codec, x, state=None):
    """The reference codec message by message: (idx, vals, residual)."""
    out = []
    for i, row in enumerate(x):
        if state is None:
            msg, st = codec.encode(None, jnp.asarray(row)), None
        else:
            msg, st = codec.encode_stateful(None, jnp.asarray(row), None,
                                            jnp.asarray(state[i]))
        out.append((npy(msg.idx), npy(msg.vals),
                    None if st is None else npy(st)))
    return out


def _assert_same_message(msg, ref_rows):
    """Per row: the same index set, and the same value at every index."""
    for i, (idx, vals, _) in enumerate(ref_rows):
        got_idx, got_vals = npy(msg.idx[i]), npy(msg.vals[i])
        assert msg.idx.dtype == torch.int32
        assert sorted(got_idx.tolist()) == sorted(idx.tolist()), i
        order, ref_order = np.argsort(got_idx), np.argsort(idx)
        assert np.array_equal(got_vals[order], vals[ref_order]), i


def test_topk_picks_the_references_coordinates_among_ties():
    """XLA's TopK takes the lower index first among equal magnitudes: on
    [0, 1, 0, 1, 0, 2, 0, 0] with k=4 it picks {0, 1, 3, 5}."""
    x = np.array([[0, 1, 0, 1, 0, 2, 0, 0]], np.float32)
    port = codecs.TopKEFCodec(frac=0.5)
    ref = ref_codecs.TopKEFCodec(frac=0.5)
    msg = port.encode(MessageKey(), tt(x))
    assert sorted(npy(msg.idx[0]).tolist()) == [0, 1, 3, 5]
    _assert_same_message(msg, _ref_topk(ref, x))
    ref_rows = np.stack([x[0] * 0 + 7.0])
    got = port.decode(MessageKey(), msg, tt(ref_rows))
    want = ref.decode(None, ref.encode(None, jnp.asarray(x[0])),
                      jnp.asarray(ref_rows[0]))
    assert np.array_equal(npy(got[0]), npy(want))


@pytest.mark.parametrize("d,frac,m", [(8, 0.5, 3), (D, 0.01, 4),
                                      (4096, 0.05, 2), (25_450, 0.01, 2)])
def test_topk_ef_threaded_calls_equal_reference(d, frac, m):
    """Three threaded encode_stateful calls, each on a tied message: index
    sets, values, decodes against zero and against a non-zero reference,
    and residuals all bit-equal; the EF invariant exact."""
    port = codecs.make_codec(f"topk_ef:frac={frac}")
    ref = ref_codecs.make_codec(f"topk_ef:frac={frac}")
    assert port.k_for(d) == ref.k_for(d)
    assert port.message_bits(d) == ref.message_bits(d) == port.k_for(d) * 64
    state = codecs.init_client_states(port, m, d)
    assert state.shape == (m, d) and not bool(state.any())
    ref_state = np.zeros((m, d), np.float32)
    ref_point = gauss(d, (m, d))
    for call in range(3):
        x = _tied(10 * d + call, m, d)
        msg, new_state = port.encode_stateful(MessageKey(), tt(x), None,
                                              state)
        rows = _ref_topk(ref, x, ref_state)
        _assert_same_message(msg, rows)
        ref_state = np.stack([r[2] for r in rows])
        assert np.array_equal(npy(new_state), ref_state)
        zero = torch.zeros((1, d))
        dec = port.decode(MessageKey(), msg, zero)
        dec_ref = port.decode(MessageKey(), msg, tt(ref_point))
        for i, (idx, vals, _) in enumerate(rows):
            rmsg = TopKMsg(idx=jnp.asarray(idx), vals=jnp.asarray(vals))
            assert np.array_equal(npy(dec[i]), npy(ref.decode(
                None, rmsg, jnp.zeros((d,), jnp.float32))))
            assert np.array_equal(npy(dec_ref[i]), npy(ref.decode(
                None, rmsg, jnp.asarray(ref_point[i]))))
        # decoded + new residual == delta + old residual, bit for bit
        assert torch.equal(dec + new_state, tt(x) + state)
        state = new_state
    # the stateless encode is the stateful one from a zero residual
    plain = port.encode(MessageKey(), tt(x))
    _assert_same_message(plain, _ref_topk(ref, x))


def test_topk_ef_codec_protocol():
    port = codecs.make_codec("topk_ef:frac=0.05")
    assert isinstance(port, codecs.Codec) and port.stateful
    assert port.ef_zero_ref_only and port.name == "topk_ef"
    assert port.keys(None, 4, D) == MessageKey()
    assert codecs.make_codec("topk_ef").frac == 0.01
    for name in ("lattice", "scalar", "identity"):
        c = codecs.make_codec(name, backend="torch")
        assert not c.stateful and c.ef_zero_ref_only
        assert codecs.init_client_states(c, 4, D) == ()
        # the stateless fallback hands the state back as it was
        x = tt(gauss(1, (2, D)))
        key = c.keys(torch.Generator(), 2, D)
        msg, st = c.encode_stateful(key, x, torch.ones(2), ())
        assert st == ()
        assert torch.equal(c.decode(key, msg, x),
                           c.decode(key, c.encode(key, x, torch.ones(2)), x))
    with pytest.raises(ValueError, match="unknown codec parameter"):
        codecs.make_codec("topk_ef:bogus=1")
    assert codecs.TopKEFCodec(frac=1e-9).k_for(D) == 1


@pytest.mark.parametrize("bits,d", [(8, 1000), (4, 2762), (2, 500)])
def test_error_feedback_qsgd_equals_reference(bits, d):
    """Three threaded compress calls of 3 messages with the reference's u:
    codes bit-equal, the decoded value and the residual within 1e-6 of
    max|·|; the 1/(1+ω) scaling with ω = √d/levels."""
    m = 3
    port, ref = ErrorFeedbackQSGD(bits=bits), RefErrorFeedbackQSGD(bits=bits)
    assert port.message_bits(d) == ref.message_bits(d) == d * bits + 32
    st = port.init(d, m)
    assert isinstance(st, EFState) and st.error.shape == (m, d)
    ref_st = [ref.init(d) for _ in range(m)]
    for call in range(3):
        delta = gauss(100 * bits + call, (m, d))
        keys = [jax.random.PRNGKey(1000 * call + i) for i in range(m)]
        key = message_key(codecs.make_codec(f"scalar:bits={bits}"), keys, d)
        msg, dec, st = port.compress(key, tt(delta), st)
        for i in range(m):
            rmsg, rdec, ref_st[i] = ref.compress(keys[i],
                                                 jnp.asarray(delta[i]),
                                                 ref_st[i])
            assert np.array_equal(npy(msg.codes[i]), npy(rmsg.codes))
            scale = float(np.abs(npy(rdec)).max())
            assert np.abs(npy(dec[i]) - npy(rdec)).max() <= 1e-6 * scale
            err = npy(ref_st[i].error)
            assert (np.abs(npy(st.error[i]) - err).max()
                    <= 1e-6 * np.abs(err).max())
    omega = np.sqrt(d) / ((1 << (bits - 1)) - 1)
    raw = msg.codes.to(torch.float32) * (msg.gamma / ((1 << (bits - 1)) - 1)
                                         )[:, None]
    assert torch.allclose(dec * (1.0 + omega), raw, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the stateful rounds
# ---------------------------------------------------------------------------

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
    return make_algorithm(name, FedConfig(**FED_KW), loss_fn=mlp_loss_batched,
                          template=template, batch_size=BATCH, device="cpu",
                          **kw)


def _close(got, want, tol=1e-5):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    diff = float(np.abs(got - want).max())
    assert diff <= tol * scale, (diff, scale)


@pytest.mark.parametrize("frac", [0.01, 0.1])
def test_compressed_fedavg_topk_ef_three_rounds(frac):
    part, params, template, data = _setup()
    spec = f"topk_ef:frac={frac}"
    ref = _ref_alg("compressed_fedavg", params, uplink=spec)
    port = _port_alg("compressed_fedavg", template, uplink=spec)
    state, pstate = ref.init(params), port.init(template)
    assert pstate.codec_up_state.shape == (8, D)
    k = port.codec_up.k_for(D)
    for r, key_n in enumerate((11, 12, 13)):
        key = jax.random.PRNGKey(key_n)
        draws = reference_fedavg_draws(ref, state, part, key, BATCH, port)
        before = pstate.codec_up_state.clone()
        state, m_ref = ref.round(state, part, key)
        pstate, m = port.round(pstate, data, None, draws=draws)
        assert m["bits_up"] == float(m_ref["bits_up"]) == 4 * k * 64
        assert m["bits_down"] == float(m_ref["bits_down"]) == D * 32
        assert pstate.bits_up == float(state.bits_up)
        _close(pstate.server, state.server)
        _close(pstate.codec_up_state, state.codec_up_state)
        # the unsampled clients' residual rows stay as they were
        idx = draws["idx"].tolist()
        rest = [i for i in range(8) if i not in idx]
        assert torch.equal(pstate.codec_up_state[rest], before[rest])
        np.testing.assert_allclose(float(m["quant_err"]),
                                   float(m_ref["quant_err"]), rtol=1e-4)

    # the reference's state carried across: one more round on both
    pstate = interop.compressed_fedavg_state_from_numpy(
        server=npy(state.server),
        rows={k: npy(v) for k, v in state.pop.rows.items()},
        t=int(state.t), sim_time=npy(state.sim_time),
        bits_up=float(state.bits_up), bits_down=float(state.bits_down),
        srv_prev=npy(state.srv_prev), srv_dist_est=npy(state.srv_dist_est),
        device="cpu")
    assert np.array_equal(npy(pstate.codec_up_state),
                          npy(state.codec_up_state))
    key = jax.random.PRNGKey(14)
    draws = reference_fedavg_draws(ref, state, part, key, BATCH, port)
    state, _ = ref.round(state, part, key)
    pstate, _ = port.round(pstate, data, None, draws=draws)
    _close(pstate.server, state.server)
    _close(pstate.codec_up_state, state.codec_up_state)


def test_fedbuff_topk_ef_three_flushes():
    part, params, template, data = _setup()
    kw = dict(buffer_size=5, uplink="topk_ef:frac=0.05")
    ref = _ref_alg("fedbuff", params, **kw)
    port = _port_alg("fedbuff", template, **kw)
    m_samples = data["y"].shape[1]
    state, pstate = ref.init(params), port.init(template)
    assert len(pstate.ef) == 8 and pstate.ef[0].shape == (D,)
    k = port.codec_up.k_for(D)
    for key_n in (21, 22, 23):
        key = jax.random.PRNGKey(key_n)
        draws = reference_fedbuff_draws(ref, state, key, BATCH, m_samples,
                                        port)
        state, m_ref = ref.round(state, part, key)
        pstate, m = port.round(pstate, data, None, draws=draws)
        assert sorted(pstate.queue.events) == sorted(state.queue.events)
        assert m["bits_up"] == float(m_ref["bits_up"]) == 5 * k * 64
        assert m["bits_down"] == float(m_ref["bits_down"]) == 5 * D * 32
        _close(pstate.server, state.server)
        for got, want in zip(pstate.ef, state.ef):
            _close(got, want)
    # the reference's state carried across, EF list included
    pstate = interop.fedbuff_state_from_numpy(
        server=npy(state.server),
        start_model=[npy(v) for v in state.start_model],
        events=state.queue.events, buffer=[npy(v) for v in state.buffer],
        sim_time=state.sim_time, t=state.t, bits_up=state.bits_up,
        bits_down=state.bits_down, rng=state.rng, device="cpu",
        ef=[npy(v) for v in state.ef])
    key = jax.random.PRNGKey(24)
    draws = reference_fedbuff_draws(ref, state, key, BATCH, m_samples, port)
    state, _ = ref.round(state, part, key)
    pstate, _ = port.round(pstate, data, None, draws=draws)
    _close(pstate.server, state.server)
    for got, want in zip(pstate.ef, state.ef):
        _close(got, want)


def test_fedbuff_fork_copies_the_residual_list():
    _, _, template, data = _setup()
    port = _port_alg("fedbuff", template, buffer_size=3,
                     uplink="topk_ef:frac=0.05")
    g = torch.Generator()
    g.manual_seed(0)
    st0 = port.init(template)
    st1, _ = port.round(st0, data, g)
    assert st1.ef is not st0.ef
    assert all(not bool(e.any()) for e in st0.ef)      # input untouched
    assert sum(bool(e.any()) for e in st1.ef) >= 1


QUAFL_KW = dict(n_clients=16, s=4, local_steps=5, lr=0.3, bits=8, swt=10.0)


@pytest.mark.parametrize("threaded", [False, True])
def test_quafl_topk_uplink_three_rounds(threaded):
    """QuAFL's per-message branch with a top-k uplink: the registry codec
    (stateless encode, ``ef_zero_ref_only``) and an instance that declares
    itself reference-agnostic, whose residuals are threaded."""
    part, _ = ref_data(0, QUAFL_KW["n_clients"], d=32, n_classes=10,
                       iid=False)
    params, _ = ref_init(jax.random.PRNGKey(0), 32, 64, 10)
    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    if threaded:
        up_ref = ref_codecs.TopKEFCodec(frac=0.05, ef_zero_ref_only=False)
        up = codecs.TopKEFCodec(frac=0.05, ef_zero_ref_only=False)
    else:
        up_ref = up = "topk_ef:frac=0.05"
    ref = RefQuAFL(fed=RefFedConfig(**QUAFL_KW), loss_fn=ref_mlp_loss,
                   template=params, uplink=up_ref,
                   batch_fn=lambda d, k: ref_client_batch(k, d, BATCH))
    port = make_algorithm("quafl", FedConfig(**QUAFL_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, uplink=up, device="cpu")
    assert ref.pipeline is None and port.pipeline is None
    assert port._thread_ef == ref._thread_ef == threaded
    state = ref.init(params)
    pstate = port_quafl_state(state)
    if threaded:
        assert pstate.codec_up_state.shape == (16, D)
    else:
        assert pstate.codec_up_state == ()
    port.codec_down = StepLog(port.codec_down)
    k = port.codec_up.k_for(D)
    for key_n in (11, 12, 13):
        key = jax.random.PRNGKey(key_n)
        draws = {n: tt(v) for n, v in
                 reference_round_draws(ref, state, part, key, BATCH).items()}
        draws.update(reference_message_keys(ref, key, port))
        before = (pstate.codec_up_state.clone() if threaded else None)
        state, m_ref = ref.round(state, part, key)
        pstate, m = port.round(pstate, data, None, draws=draws)
        assert m["bits_up"] == float(m_ref["bits_up"]) == 4 * k * 64
        assert m["bits_down"] == float(m_ref["bits_down"]) == 4096 * 8 + 32
        _close(pstate.server, state.server)
        step = max(port.codec_down.steps)
        cl_diff = np.abs(npy(pstate.clients) - npy(state.clients)).max()
        assert cl_diff <= step + 1e-5 * np.abs(npy(state.clients)).max()
        if threaded:
            _close(pstate.codec_up_state, state.pop.rows["codec_up"])
            rest = [i for i in range(16) if i not in draws["idx"].tolist()]
            assert torch.equal(pstate.codec_up_state[rest], before[rest])
        else:
            assert pstate.codec_up_state == ()
    # the threaded state crosses over from numpy with its residual rows
    if threaded:
        again = port_quafl_state(state)
        assert np.array_equal(npy(again.codec_up_state),
                              npy(state.pop.rows["codec_up"]))

