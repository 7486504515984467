"""The port's round engine on the CPU (``repro_torch.fed.engine``,
``simulate(..., scan_chunk=K | "auto")``).

* the device :class:`RingBuffer` pops exactly what the host heap
  (``ArrivalQueue``) and the reference's ring pop, ties included, and the
  seed bridge's table is the reference's for the same seed integer;
* a chunked run (``scan_chunk=2``: chunks 2, 2, 1) is the eager run bit
  for bit for every device algorithm: every row, every eval, both
  cumulative totals, the final params and the generator's final state (on
  the CPU a chunk is the plain loop, so nothing fuses differently and no
  tolerance is needed);
* the reference's chunk semantics: budgets checked at chunk boundaries,
  the eager fallback of host-control algorithms, ``"auto"``, and the
  adaptive walk once per chunk;
* the structural guard of capture: every counter and metric that changes
  between rounds is a tensor, and the engine refuses a round that keeps
  one on the host.
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_harness  # noqa: F401  (makes the reference importable)
from repro.fed.engine import fedbuff_completion_table as ref_table
from repro.fed.engine import ring_init as ref_ring_init
from repro.fed.engine import ring_pop as ref_ring_pop
from repro.fed.engine import ring_push as ref_ring_push
from repro.fed.engine import ring_size as ref_ring_size
from repro_torch.configs.base import FedConfig
from repro_torch.core.extensions import AdaptiveBits
from repro_torch.data.synthetic import make_federated_classification
from repro_torch.fed import (AUTOTUNE_CANDIDATES, ArrivalQueue,
                             DeviceFedAlgorithm, RoundEngine,
                             fedbuff_completion_table, make_algorithm,
                             ring_init, ring_peek, ring_pop, ring_push,
                             ring_size, simulate, speeds_for, supports_scan)
from repro_torch.fed.engine import _host_leaves
from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                    mlp_loss_batched)
from repro_torch.utils.tree import tree_flatten_vector

FED_KW = dict(n_clients=6, s=3, local_steps=2, lr=0.3, bits=8)
GROUPED = {"fast": "lattice", "slow": "lattice_packed:bits=4"}


def _world(seed=0, **fed_kw):
    fed = FedConfig(**{**FED_KW, **fed_kw})
    part, test = make_federated_classification(seed, fed.n_clients, d=16,
                                               n_classes=4, iid=True,
                                               device="cpu")
    g = torch.Generator()
    g.manual_seed(seed)
    p0 = init_mlp_classifier(g, 16, 32, 4)
    return fed, part, test, p0


def _alg(name, fed, p0, **kw):
    return make_algorithm(name, fed, loss_fn=mlp_loss_batched, template=p0,
                          batch_size=8, device="cpu", **kw)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _rows(tr):
    return [{k: v for k, v in r.items() if k != "wall_time_s"}
            for r in tr.rows]


# ---------------------------------------------------------------------------
# the ring and the seed bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_ring_pops_equal_the_heap_and_the_reference_ring(seed):
    """Interleaved pushes and pops, times on a half-integer grid so exact
    ties are common: every pop (and peek) is the heap's (time, client) and
    the reference ring's, the sizes agree, and the slots end up holding
    the reference ring's times and ids. Pushes alternate between tensor
    and host values (``index_put`` and ``index_fill``)."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(2, 9))
    rb, ref, q = ring_init(cap), ref_ring_init(cap), ArrivalQueue()
    n_live = 0
    for step in range(60):
        if n_live == 0 or (n_live < cap and rng.random() < 0.6):
            t = np.float32(rng.integers(0, 6) + rng.choice([0.0, 0.5]))
            c = int(rng.integers(0, 5))
            if step % 2:
                rb = ring_push(rb, torch.tensor(t), torch.tensor(c))
            else:
                rb = ring_push(rb, float(t), c)
            ref = ref_ring_push(ref, t, c)
            q.push(float(t), c)
            n_live += 1
        else:
            tp, cp = ring_peek(rb)
            rb, t, c = ring_pop(rb)
            ref, tr, cr = ref_ring_pop(ref)
            want = q.pop()
            assert (float(t), int(c)) == (float(tp), int(cp)) == want
            assert (float(tr), int(cr)) == want
            n_live -= 1
        assert int(ring_size(rb)) == n_live == len(q) == int(
            ref_ring_size(ref))
    np.testing.assert_array_equal(rb.times.numpy(), np.asarray(ref.times))
    np.testing.assert_array_equal(rb.clients.numpy(),
                                  np.asarray(ref.clients))


@pytest.mark.parametrize("n,uniform", [(5, False), (7, True)])
def test_completion_table_equals_the_reference(n, uniform):
    """The same seed integer (the one the reference derives from its key)
    gives the reference's table exactly: the same numpy stream replayed in
    the same pop order."""
    fed = FedConfig(**{**FED_KW, "n_clients": n})
    key = jax.random.PRNGKey(11 + n)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    lam = speeds_for(fed, n, uniform=uniform)
    want = ref_table(key, lam, fed.local_steps, n_events=4 * n)
    got = fedbuff_completion_table(seed, lam, fed.local_steps, 4 * n)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# chunked == eager, bit for bit
# ---------------------------------------------------------------------------

SCAN_CASES = [
    ("quafl", {}),                                   # the lattice pipeline
    ("quafl", {"uplink": "scalar"}),                 # the per-message branch
    ("quafl", {"uplink": GROUPED}),                  # device bits_for
    ("quafl", {"participation": "cyclic:period=4,phase_groups=2"}),
    ("fedavg", {}),
    ("compressed_fedavg", {}),
    ("sequential", {}),
    ("quafl_scaffold", {}),
    ("fedbuff_device", {"buffer_size": 3, "quantize": True,
                        "quantizer": "lattice"}),
]


@pytest.mark.parametrize("name,kw", SCAN_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCAN_CASES)])
def test_chunked_run_equals_eager_bitwise(name, kw):
    """rounds=5, scan_chunk=2 (chunks 2, 2, 1), a row every round, an eval
    every 2: every row key and eval, both cumulative totals, the final
    params and the generator's final state equal the eager run's."""
    fed, part, test, p0 = _world()
    alg = _alg(name, fed, p0, **kw)
    assert supports_scan(alg) and isinstance(alg, DeviceFedAlgorithm)

    def run(chunk):
        g = _gen(3)
        tr = simulate(alg, p0, part, g, rounds=5, eval_every=2,
                      record_every=1, scan_chunk=chunk,
                      eval_fn=lambda p: {"loss": float(mlp_loss(p,
                                                                test)[0])})
        return tr, g

    (tre, ge), (trs, gs) = run(0), run(2)
    assert (tre.engine, trs.engine, trs.scan_chunk) == ("eager", "scanned",
                                                        2)
    assert tre.rounds == trs.rounds == len(trs.rows) == 5
    assert _rows(tre) == _rows(trs)
    assert [r["round"] for r in trs.rows if "loss" in r] == [2, 4, 5]
    assert torch.equal(tree_flatten_vector(alg.eval_params(tre.final_state)),
                       tree_flatten_vector(alg.eval_params(trs.final_state)))
    assert torch.equal(ge.get_state(), gs.get_state())


def test_budgets_are_checked_at_chunk_boundaries():
    """QuAFL rounds last swt + sit = 11 s: under a 50 s budget the eager
    run stops at round 5, the chunked one (chunks of 4) at the round-8
    boundary, past the budget and never short of it; an until_bits budget
    likewise."""
    fed, part, _, p0 = _world()
    alg = _alg("quafl", fed, p0)
    tre = simulate(alg, p0, part, _gen(1), until_sim_time=50.0)
    trs = simulate(alg, p0, part, _gen(1), until_sim_time=50.0,
                   scan_chunk=4)
    assert tre.rounds == 5 and trs.rounds == 8
    assert trs.final["sim_time"] >= 50.0
    per_round = tre.final["bits_up_total"] / 5 + tre.final[
        "bits_down_total"] / 5
    trb = simulate(alg, p0, part, _gen(1), until_bits=4.5 * per_round,
                   scan_chunk=4)
    assert trb.rounds == 8
    assert trb.final["bits_up_total"] == 8 * tre.final["bits_up_total"] / 5


def test_host_control_algorithms_fall_back_and_the_engine_refuses_them():
    """The host FedBuff has no device_round: scan_chunk (K or "auto") runs
    the eager engine silently, and RoundEngine refuses it."""
    fed, part, _, p0 = _world()
    alg = _alg("fedbuff", fed, p0, buffer_size=2)
    assert not supports_scan(alg)
    for chunk in (4, "auto"):
        tr = simulate(alg, p0, part, _gen(1), rounds=3, eval_every=0,
                      scan_chunk=chunk)
        assert tr.engine == "eager" and tr.rounds == 3 and tr.scan_chunk == 0
    with pytest.raises(TypeError, match="neither device_round"):
        RoundEngine(alg)
    with pytest.raises(ValueError, match="scan_chunk"):
        simulate(alg, p0, part, _gen(1), rounds=3, scan_chunk="fast")


def test_auto_equals_the_explicit_chunk_and_leaves_the_generator():
    """scan_chunk="auto" probes on a disposable state with a copy of the
    run's generator: the run equals the explicit run at the chosen K, row
    for row, and both leave their generators in the same state."""
    fed, part, _, p0 = _world()
    alg = _alg("quafl", fed, p0)
    g_auto, g_k = _gen(5), _gen(5)
    tra = simulate(alg, p0, part, g_auto, rounds=6, eval_every=0,
                   record_every=1, scan_chunk="auto")
    assert tra.engine == "scanned"
    assert tra.scan_chunk in {min(c, 6) for c in AUTOTUNE_CANDIDATES}
    trk = simulate(_alg("quafl", fed, p0), p0, part, g_k, rounds=6,
                   eval_every=0, record_every=1, scan_chunk=tra.scan_chunk)
    assert _rows(tra) == _rows(trk)
    assert torch.equal(tra.final_state.server, trk.final_state.server)
    assert torch.equal(g_auto.get_state(), g_k.get_state())


def test_adaptive_walks_once_per_chunk():
    """adaptive_quafl from b=12 in chunks of 3 (scan_rounds): the width is
    constant inside each chunk, each chunk's width is the walk of the
    previous chunk's last quant_err, and the b=12 lattice's tiny error
    walks down. Chunks of one round are the eager walk exactly."""
    fed, part, _, p0 = _world(bits=12)
    walk_kw = dict(lo=0.01, hi=0.05, b_min=4, b_max=12)
    alg = _alg("adaptive_quafl", fed, p0, **walk_kw)
    tr = simulate(alg, p0, part, _gen(3), rounds=9, eval_every=0,
                  record_every=1, scan_chunk=3)
    assert tr.engine == "scanned" and tr.rounds == 9
    trace = tr.final_state.trace
    widths = [int(w) for w in tr.column("bits_width")]
    assert list(trace) == widths and widths[0] == 12 and widths[-1] < 12
    errs = tr.column("quant_err")
    for c in range(3):
        assert len(set(widths[3 * c:3 * c + 3])) == 1
        if c:
            assert widths[3 * c] == AdaptiveBits.walk(
                widths[3 * c - 1], errs[3 * c - 1], **walk_kw)
    assert tr.final_state.bits == AdaptiveBits.walk(widths[-1], errs[-1],
                                                    **walk_kw)

    # chunks of one round: the eager walk, round for round
    eager = _alg("adaptive_quafl", fed, p0, **walk_kw)
    chunked = _alg("adaptive_quafl", fed, p0, **walk_kw)
    se, sc = eager.init(p0), chunked.init(p0)
    ge, gc = _gen(4), _gen(4)
    for _ in range(6):
        se, me = eager.round(se, part, ge)
        sc, mc = chunked.scan_rounds(sc, part, gc, 1)
        assert float(me["quant_err"]) == float(mc["quant_err"][0])
        assert me["bits_width"] == mc["bits_width"]
    assert se.trace == sc.trace and se.bits == sc.bits
    assert torch.equal(se.inner.server, sc.inner.server)


# ---------------------------------------------------------------------------
# the structural guard of capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", SCAN_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCAN_CASES)])
def test_what_changes_between_rounds_is_a_tensor(name, kw):
    """After two rounds: every host (non-tensor) value of the state is as
    it was after the first, every counter is a 0-d tensor, and every
    metric that differs between the rounds is a tensor (host metrics are
    constants). A captured chunk would freeze anything else."""
    fed, part, _, p0 = _world()
    alg = _alg(name, fed, p0, **kw)
    g = _gen(2)
    s1, m1 = alg.round(alg.init(p0), part, g)
    host1 = _host_leaves(s1)
    s2, m2 = alg.round(s1, part, g)
    assert _host_leaves(s2) == host1
    base = getattr(s2, "base", s2)
    for k in ("t", "sim_time", "bits_up", "bits_down"):
        v = getattr(base, k)
        assert isinstance(v, torch.Tensor) and v.dim() == 0, (k, v)
    assert int(base.t) == 2
    assert set(m1) == set(m2)
    for k in m1:
        if isinstance(m1[k], torch.Tensor) or isinstance(m2[k], torch.Tensor):
            assert isinstance(m1[k], torch.Tensor) and isinstance(
                m2[k], torch.Tensor), k
        else:
            assert m1[k] == m2[k], (k, m1[k], m2[k])


class _HostCounter:
    """A round that keeps its counter on the host: not capture-safe."""

    def __init__(self, host_metric: bool):
        self.host_metric = host_metric

    def init(self, params0):
        return (torch.zeros(()), 0)

    def device_round(self, state, data, generator):
        x, t = state
        if self.host_metric:
            return (x + 1, t), {"t": float(x) + 1}
        return (x + 1, t + 1), {"t": x + 1}

    round = device_round

    def eval_params(self, state):
        return {}


@pytest.mark.parametrize("host_metric", [False, True])
def test_the_engine_refuses_a_round_with_host_values(host_metric):
    """A round whose state or metrics keep a value that changes on the
    host raises in a chunk (a capture would replay it frozen), on the CPU
    as on the card."""
    eng = RoundEngine(_HostCounter(host_metric))
    with pytest.raises(ValueError, match="must be a tensor"):
        eng.run_chunk(eng.alg.init(None), {}, _gen(0), 3)
