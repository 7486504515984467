"""The beyond-paper extensions against the reference: QuAFL-SCAFFOLD and the
adaptive bit-width QuAFL, with the reference's draws injected, and the
SCAFFOLD example twin on the CPU.

* ``quafl_scaffold`` at ``tests/make_golden.py``'s configuration (n=6,
  s=3, K=2, b=8, the 16-32-4 MLP: d=676, d_pad 1024; ``PRNGKey(7)``),
  three rounds, each from the reference's live state carried across: the
  server, the clients, the controls and ``c_server`` within one lattice
  step of the reference (the largest γ the round's codecs drew; a code at
  an integer boundary may round to either side), the bits exactly
  ``golden_pr3.npz``'s.
* ``adaptive_quafl`` in the reference test's setup (n=8, s=4, K=3, from
  b=12, ``PRNGKey(3)``), 12 rounds, the port's state carried on its own
  and the draws injected at each round's width: the bit trace and every
  round's bits exactly the reference's. The walk reads each package's own
  ``quant_err``, so no round's ``quant_err`` may lie within 1e-3 relative
  of ``lo`` or ``hi``: rounding cannot decide a step.
* ``AdaptiveBits.walk`` equal to the reference's on a grid that holds the
  band's edges.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from test_torch_harness import (StepLog, npy, reference_message_keys,
                                reference_round_draws, tt)
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.extensions import AdaptiveBits as RefAdaptiveBits
from repro.core.extensions import \
    AdaptiveQuaflAlgorithm as RefAdaptiveQuaflAlgorithm
from repro.core.quafl import QuAFL as RefQuAFL
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.fed.registry import make_algorithm as ref_make_algorithm
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.configs.base import FedConfig
from repro_torch.core import extensions
from repro_torch.core.extensions import (AdaptiveBits,
                                         AdaptiveQuaflAlgorithm,
                                         AdaptiveQuAFL, QuaflScaffold,
                                         ScaffoldState)
from repro_torch.core.quafl import QuAFL
from repro_torch.examples import scaffold_noniid
from repro_torch.fed import make_algorithm, simulate
from repro_torch.fed.engine import clone_tree
from repro_torch.models.mlp import mlp_loss, mlp_loss_batched
from repro_torch.utils import interop

ROOT = Path(__file__).resolve().parents[1]
BATCH = 16
GOLDEN = np.load(ROOT / "tests" / "golden_pr3.npz")
GOLDEN_KW = dict(n_clients=6, s=3, local_steps=2, lr=0.3, bits=8)


def _world(fed_kw, seed=0, iid=True):
    part, test = ref_data(seed, fed_kw["n_clients"], d=16, n_classes=4,
                          iid=iid)
    params, _ = ref_init(jax.random.PRNGKey(seed), 16, 32, 4)
    template = interop.params_from_numpy(
        {k: npy(v) for k, v in params.items()}, "cpu")
    data = interop.data_from_numpy({k: npy(v) for k, v in part.items()},
                                   "cpu")
    ptest = interop.data_from_numpy({k: npy(v) for k, v in test.items()},
                                    "cpu")
    return part, params, template, data, ptest


def _bf(d, k):
    return ref_client_batch(k, d, BATCH)


def _port_scaffold_state(state):
    base = state.base
    return interop.scaffold_state_from_numpy(
        server=npy(base.server),
        rows={k: npy(v) for k, v in base.pop.rows.items()},
        t=int(base.t), sim_time=float(base.sim_time),
        bits_up=float(base.bits_up), bits_down=float(base.bits_down),
        srv_dist_est=npy(base.srv_dist_est), c_server=npy(state.c_server),
        device="cpu")


def test_scaffold_rounds_match_reference_and_golden_bits():
    part, params, template, data, _ = _world(GOLDEN_KW)
    ref = ref_make_algorithm("quafl_scaffold", RefFedConfig(**GOLDEN_KW),
                             loss_fn=ref_mlp_loss, template=params,
                             batch_fn=_bf)
    port = make_algorithm("quafl_scaffold", FedConfig(**GOLDEN_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, device="cpu")
    assert isinstance(port, QuaflScaffold) and port.d == 676
    port.codec_up = StepLog(port.codec_up)
    port.codec_down = StepLog(port.codec_down)
    state = ref.init(params)
    key = jax.random.PRNGKey(7)
    for r in range(3):
        key, sub = jax.random.split(key)
        draws = {k: tt(v) for k, v in reference_round_draws(
            ref, state.base, part, sub, BATCH).items()}
        draws.update(reference_message_keys(ref, sub, port))
        pstate = _port_scaffold_state(state)
        assert isinstance(pstate, ScaffoldState)
        assert torch.equal(pstate.c_clients,
                           tt(npy(state.c_clients)))
        port.codec_up.steps, port.codec_down.steps = [0.0], [0.0]
        state, m_ref = ref.round(state, part, sub)
        new, m = port.round(pstate, data, None, draws=draws)
        # 2 messages up per sampled client and 2 down, as the golden run
        assert m["bits_up"] == float(m_ref["bits_up"]) \
            == GOLDEN["quafl_scaffold/bits_up"][r] == 2 * 3 * 8224
        assert m["bits_down"] == float(m_ref["bits_down"]) \
            == GOLDEN["quafl_scaffold/bits_down"][r] == 2 * 8224
        assert new.bits_sent == float(state.bits_sent)
        assert new.base.t == int(state.base.t) == r + 1
        # three encodes a round: the models, the controls and X_t
        assert len(port.codec_up.steps) == 3
        assert len(port.codec_down.steps) == 2
        step = max(port.codec_up.steps + port.codec_down.steps)
        for got, want in ((new.base.server, state.base.server),
                          (new.base.clients, state.base.clients),
                          (new.c_clients, state.c_clients),
                          (new.c_server, state.c_server)):
            diff = float(np.abs(npy(got) - npy(want)).max())
            assert diff <= step, (r, diff, step)
        np.testing.assert_allclose(float(m["c_norm"]), float(m_ref["c_norm"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(m["quant_err"]),
                                   float(m_ref["quant_err"]), rtol=1e-3)
        np.testing.assert_allclose(float(new.base.srv_dist_est),
                                   float(state.base.srv_dist_est), rtol=1e-3)
        assert m["h_steps_mean"] == float(m_ref["h_steps_mean"])


def test_scaffold_controls_stay_put_for_unsampled_clients():
    _, _, template, data, _ = _world(GOLDEN_KW)
    port = make_algorithm("quafl_scaffold", FedConfig(**GOLDEN_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    state = port.init(template)
    assert state.c_clients.shape == (6, 676) and state.base.codec_up_state \
        == ()
    idx = torch.tensor([4, 0, 2])
    state, m = port.round(state, data, g, draws={"idx": idx})
    moved = state.c_clients.abs().amax(1) > 0
    assert moved.tolist() == [True, False, True, False, True, False]
    # from zero controls, c = Σ_i (c_i+ − c_i) / n = Σ_i c_i+ / n
    assert float((state.c_server - state.c_clients.sum(0) / 6).abs().max()) \
        < 1e-6
    assert float(m["c_norm"]) > 0


def test_scaffold_converges_noniid():
    """The reference test's run under the port's own RNG: 60 rounds on
    non-iid data cut the test loss below 0.8 of its start."""
    fed_kw = dict(n_clients=8, s=4, local_steps=4, lr=0.3, bits=10)
    _, _, template, data, test = _world(fed_kw, iid=False)
    alg = QuaflScaffold(fed=FedConfig(**fed_kw), loss_fn=mlp_loss_batched,
                        template=template, batch_size=BATCH, device="cpu")
    g = torch.Generator()
    g.manual_seed(1)
    loss0 = float(mlp_loss(template, test)[0])
    tr = simulate(alg, template, data, g, rounds=60, eval_every=60,
                  eval_fn=lambda p: {"loss": float(mlp_loss(p, test)[0])})
    assert tr.final["loss"] < 0.8 * loss0
    assert np.isfinite(tr.final["c_norm"]) and tr.final["c_norm"] > 0
    assert tr.final["bits_up"] == 2 * 4 * (1024 * 16 + 32)


ADAPT_KW = dict(n_clients=8, s=4, local_steps=3, lr=0.3, bits=12)


def _storage(b):
    return 8 if b <= 8 else 16


def test_adaptive_trace_and_bits_match_reference():
    part, params, template, data, _ = _world(ADAPT_KW, iid=False)
    ref = RefAdaptiveQuaflAlgorithm(
        RefFedConfig(**ADAPT_KW),
        lambda f: RefQuAFL(fed=f, loss_fn=ref_mlp_loss, template=params,
                           batch_fn=_bf))
    port = make_algorithm("adaptive_quafl", FedConfig(**ADAPT_KW),
                          loss_fn=mlp_loss_batched, template=template,
                          batch_size=BATCH, device="cpu")
    assert isinstance(port, AdaptiveQuaflAlgorithm)
    state, pstate = ref.init(params), port.init(template)
    key = jax.random.PRNGKey(3)
    errs = []
    for _ in range(12):
        key, sub = jax.random.split(key)
        draws = {k: tt(v) for k, v in reference_round_draws(
            ref._alg(state.bits), state.inner, part, sub, BATCH).items()}
        b = state.bits
        state, m_ref = ref.round(state, part, sub)
        pstate, m = port.round(pstate, data, None, draws=draws)
        assert m["bits_width"] == float(m_ref["bits_width"]) == float(b)
        assert m["bits_up"] == float(m_ref["bits_up"]) \
            == 4 * (1024 * _storage(b) + 32)
        assert m["bits_down"] == float(m_ref["bits_down"]) \
            == 1024 * _storage(b) + 32
        assert pstate.bits == state.bits
        errs += [float(m["quant_err"]), float(m_ref["quant_err"])]
    assert pstate.trace == state.trace and len(pstate.trace) == 12
    assert pstate.trace[-1] < 12                 # b=12 is too fine: down
    assert pstate.bits_sent == float(state.bits_sent)
    for e in errs:
        for edge in (0.01, 0.05):
            assert abs(e - edge) > 1e-3 * edge, (e, edge)
    assert set(port._algs) == set(ref._algs)
    assert all(isinstance(a, QuAFL) and a.fed.bits == b
               for b, a in port._algs.items())


def test_adaptive_walk_equals_reference_on_a_grid():
    for lo, hi in ((0.01, 0.05), (0.02, 0.02), (0.0, 1.0)):
        rels = sorted({0.0, lo, hi, 0.5 * (lo + hi), lo * 0.999,
                       hi * 1.001, 2.0, np.nextafter(lo, 0.0),
                       np.nextafter(hi, 1.0)})
        for b_min, b_max in ((4, 16), (1, 32), (8, 8)):
            for bits in range(0, 34):
                for rel in rels:
                    got = AdaptiveBits.walk(bits, rel, lo, hi, b_min, b_max)
                    want = RefAdaptiveBits.walk(bits, rel, lo, hi, b_min,
                                                b_max)
                    assert got == want, (bits, rel, lo, hi, b_min, b_max)
    c = AdaptiveBits(bits=8, lo=0.01, hi=0.05, b_min=4, b_max=12)
    assert c.update(0.10) == 9
    assert c.update(0.001) == 8
    for _ in range(20):
        c.update(0.001)
    assert c.bits == c.b_min


def test_adaptive_legacy_shim_and_scan_refusal():
    _, _, template, data, test = _world(ADAPT_KW, iid=False)

    def make_alg(f):
        return QuAFL(fed=f, loss_fn=mlp_loss_batched, template=template,
                     batch_size=BATCH, device="cpu")

    wrap = AdaptiveQuAFL(FedConfig(**ADAPT_KW), make_alg, template)
    g = torch.Generator()
    g.manual_seed(3)
    for _ in range(12):
        m = wrap.round(data, g)
    assert len(wrap.bits_trace) == 12 and wrap.bits_trace[0] == 12
    assert wrap.bits_trace[-1] < 12 and "bits_width" in m
    loss, _ = mlp_loss(wrap.eval_params(), test)
    assert np.isfinite(float(loss))
    # scan_rounds (ROADMAP Queue 1 item 10, ported): a chunk of 4 rounds
    # at the state's width, the walk once after it (on a copy: a chunk
    # consumes the state it is given)
    bits = wrap.state.bits
    st4, ms = wrap._impl.scan_rounds(clone_tree(wrap.state), data, g, 4)
    assert st4.trace[-4:] == (bits,) * 4 and len(st4.trace) == 16
    assert ms["quant_err"].shape == (4,) and ms["bits_width"] == float(bits)
    assert st4.bits == extensions.AdaptiveBits.walk(
        bits, float(ms["quant_err"][-1]), 0.01, 0.05, 4, 16)
    # the trace keeps the last _TRACE_CAP widths
    st = extensions.AdaptiveState(inner=wrap.state.inner, bits=8,
                                  trace=(8,) * extensions._TRACE_CAP)
    st2, _ = wrap._impl.round(st, data, g)
    assert len(st2.trace) == extensions._TRACE_CAP


def test_scaffold_twin_on_cpu(capsys):
    """The twin at the reference's sizes (32-64-10, n=16, s=4, K=5, b=10,
    80 rounds, eval every 16): its table, and each run's bits exactly the
    codecs' (d_pad 4096, 16-bit codes: 65,568 bits a message)."""
    traces = scaffold_noniid.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "round |  vanilla acc | scaffold acc | ||c||"
    assert [int(ln.split("|")[0]) for ln in out[1:6]] == [16, 32, 48, 64, 80]
    assert out[7].startswith("SCAFFOLD pays 2x")
    msg = 4096 * 16 + 32
    v, s = traces["quafl"], traces["quafl_scaffold"]
    assert v.rounds == s.rounds == 80
    assert v.final["bits_up_total"] == 80 * 4 * msg
    assert s.final["bits_up_total"] == 80 * 2 * 4 * msg
    assert s.final["bits_down_total"] == 80 * 2 * msg
    assert all(r["c_norm"] > 0 for r in s.rows)
    assert s.final["acc"] > 0.3


def test_scaffold_twin_cli():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.scaffold_noniid",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("round |") and len(lines) == 8
