"""The port's spans and counters (``repro_torch.utils.spans``) on the CPU:

* off, a round creates no ``record_function`` and no timing event;
* on, a QuAFL round's state, bits and generator are bit-equal to spans
  off, under the batched and the per-client protocol, eager and through
  the round engine's CPU loop;
* one round's span tree: the five phases under ``quafl.round``, the
  exchange's steps, ``local.step`` (K a round batched, s·K per client, each
  with ``local.grad`` and ``local.update``), the counters equal to the
  round's ``h_steps``;
* the device path on stand-in events: device ms, self ms, a captured
  chunk's records numbered after the log's rounds on every replay;
* the invariant gate stays clean with spans on: astlint, the recapture
  sentinel, the engine's chunk programs.
"""
import itertools
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import make_federated_classification
from repro_torch.fed import RoundEngine, make_algorithm
from repro_torch.fed.engine import _leaves, clone_tree
from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                    mlp_loss_batched)
from repro_torch.utils import spans

FED_KW = dict(n_clients=6, s=3, local_steps=3, lr=0.3, bits=8)
PHASES = ["quafl.cohort", "quafl.local", "quafl.progress", "quafl.exchange",
          "quafl.commit"]
EXCHANGE = ["exchange.draws", "exchange.uplink", "exchange.downlink",
            "exchange.average", "exchange.unrotate"]


def _client_batch(client, rows):
    return {"x": client["x"][rows], "y": client["y"][rows]}


def _world(protocol, seed=0):
    fed = FedConfig(**FED_KW)
    part, _ = make_federated_classification(seed, fed.n_clients, d=16,
                                            n_classes=4, iid=True,
                                            device="cpu")
    g = torch.Generator()
    g.manual_seed(seed)
    p0 = init_mlp_classifier(g, 16, 32, 4)
    kw = (dict(loss_fn=mlp_loss_batched) if protocol == "batched"
          else dict(loss_fn=mlp_loss, batch_fn=_client_batch))
    alg = make_algorithm("quafl", fed, template=p0, batch_size=8,
                         device="cpu", **kw)
    return alg, p0, part


def _gen(seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _run(alg, state, part, gen, path, rounds=4):
    """``rounds`` rounds eager, or through the engine's CPU loop in chunks
    of 2; returns the state and the rounds' h_steps_mean."""
    hs = []
    if path == "eager":
        for _ in range(rounds):
            state, m = alg.round(state, part, gen)
            hs.append(m["h_steps_mean"].reshape(1))
    else:
        eng = RoundEngine(alg)
        for _ in range(rounds // 2):
            state, m = eng.run_chunk(state, part, gen, 2)
            hs.append(m["h_steps_mean"])
    return state, torch.cat(hs)


class _Counted:
    """Stands in for a constructor and counts its calls."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.real(*a, **kw)


@pytest.mark.parametrize("protocol", ["batched", "per_client"])
def test_spans_off_make_no_record_function_and_no_event(monkeypatch,
                                                        protocol):
    alg, p0, part = _world(protocol)
    rf = _Counted(torch.profiler.record_function)
    ev = _Counted(torch.cuda.Event)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.cuda, "Event", ev)
    gen = _gen()
    state, _ = _run(alg, alg.init(p0), part, gen, "eager", rounds=2)
    state, _ = _run(alg, state, part, gen, "engine", rounds=2)
    assert not spans.on()
    assert rf.calls == 0 and ev.calls == 0
    with spans.recording(device_clock=False) as log:
        alg.round(state, part, gen)
    assert rf.calls == len(log.records) > 0 and ev.calls == 0


@pytest.mark.parametrize("protocol,path", list(itertools.product(
    ["batched", "per_client"], ["eager", "engine"])))
def test_spans_on_are_bit_equal_to_spans_off(protocol, path):
    alg, p0, part = _world(protocol)
    state0 = alg.init(p0)
    out = {}
    for on in (False, True):
        gen = _gen()
        st = clone_tree(state0)
        if on:
            with spans.recording(device_clock=False) as log:
                st, hs = _run(alg, st, part, gen, path)
            assert log.rounds == 4
        else:
            st, hs = _run(alg, st, part, gen, path)
        out[on] = (_leaves(st), hs, gen.get_state())
    (a, ha, ga), (b, hb, gb) = out[False], out[True]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert torch.equal(ha, hb) and torch.equal(ga, gb)


def _tree(log, rnd):
    """(name, parent name) of every record of round ``rnd``."""
    recs = log.records
    return [(r.name, None if r.parent is None else recs[r.parent].name)
            for r in recs if r.round == rnd]


@pytest.mark.parametrize("protocol", ["batched", "per_client"])
def test_one_rounds_span_tree_and_counters(protocol):
    alg, p0, part = _world(protocol)
    s, K = alg.fed.s, alg.fed.local_steps
    gen = _gen()
    state, _ = alg.round(alg.init(p0), part, gen)
    with spans.recording(device_clock=False) as log:
        _, m = alg.round(state, part, gen)
    tree = _tree(log, 0)
    assert tree[0] == ("quafl.round", None)
    assert [n for n, p in tree if p == "quafl.round"] == PHASES
    assert [n for n, p in tree if p == "quafl.exchange"] == EXCHANGE
    steps = [p for n, p in tree if n == "local.step"]
    assert steps == ["quafl.local"] * (K if protocol == "batched" else s * K)
    inner = [(n, p) for n, p in tree if p == "local.step"]
    if protocol == "batched":
        assert inner == []
    else:
        assert inner == [("local.grad", "local.step"),
                         ("local.update", "local.step")] * (s * K)
    assert len(tree) == len(log.records) and log.rounds == 1
    summ = log.summary()
    assert summ["counters"] == {
        "local.steps_computed": float(s * K),
        "local.steps_active": pytest.approx(float(m["h_steps_mean"]) * s)}
    sp = summ["spans"]
    assert sp["quafl.round"]["calls"] == 1
    assert sp["quafl.round"]["device_ms"] is None
    assert sp["quafl.round"]["host_ms"] >= sum(sp[p]["host_ms"]
                                               for p in PHASES)


class _Clock:
    """A stand-in for ``torch.cuda.Event``: each record takes the next
    tick of a shared clock, 1 ms apart."""
    now = itertools.count()

    def __init__(self, enable_timing=False, external=False):
        self.t = None

    def record(self, stream=None):
        self.t = next(_Clock.now)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_ms_and_a_captured_chunk_on_stand_in_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Clock)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    _Clock.now = itertools.count()
    with spans.recording(device_clock=True) as log:
        with spans.span("outer") as top:
            with spans.span("a", eager_only=True):
                pass
            spans.count("n", 2)
        with spans.captured() as tpl:
            for _ in range(2):
                with spans.span(spans.ROUND), spans.span("quafl.local"), \
                        spans.span("local.step", eager_only=True) as no:
                    assert no is None     # not a node of the graph
                    spans.count("local.steps_active", torch.tensor([1, 2]))
        assert log.rounds == 0 and len(log.records) == 2
        for k in range(2):            # two replays of the "graph": each
            for r in tpl.records:     # records its events anew
                r.events[0].t += 100
                r.events[1].t += 100
            with spans.span("engine.replay") as rec:
                pass
            spans.replayed(tpl, rec)
        spans.note("build.load", 5.0, compile_ms=2.0, library="x")
    summ = log.summary()
    sp = summ["spans"]
    # outer: 0 .. 3, a: 1 .. 2
    assert sp["outer"]["device_ms"] == 3.0 and sp["a"]["device_ms"] == 1.0
    assert sp["outer"]["self_device_ms"] == 2.0 and top == 0
    assert sp["quafl.round"]["calls"] == 4 and summ["rounds"] == 4
    assert sp["quafl.local"]["calls"] == 4
    assert sp["quafl.round"]["device_ms"] == 4 * 3.0
    assert sp["quafl.local"]["device_ms"] == 4 * 1.0
    assert sp["build.load"] == {"calls": 1, "device_ms": None,
                                "self_device_ms": None, "host_ms": 5.0,
                                "compile_ms": 2.0}
    assert summ["counters"] == {"n": 2.0, "local.steps_active": 12.0}
    recs = log.records
    rounds = [r for r in recs if r.name == spans.ROUND]
    assert [r.round for r in rounds] == [0, 1, 2, 3]
    assert all(recs[r.parent].name == "engine.replay" for r in rounds)
    assert all(recs[r.parent].name == spans.ROUND and r.round is not None
               for r in recs if r.name == "quafl.local")
    assert log.by_round("quafl.local") == {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}


def test_muted_and_nested_recordings():
    with spans.recording(device_clock=False) as outer:
        with spans.muted():
            assert not spans.on()
            with spans.span("hidden"):
                spans.count("hidden", 1)
            spans.note("kept", 1.0)
        with spans.recording(device_clock=False) as inner:
            with spans.span("inner"):
                pass
        assert spans.on()
    assert not spans.on()
    assert [r.name for r in outer.records] == ["kept"]
    assert outer.counts == [] and [r.name for r in inner.records] == \
        ["inner"]
    with spans.captured() as tpl:
        assert tpl is None


def test_the_gate_stays_clean_with_spans_on():
    from repro_torch.analysis.astlint import lint_path
    from repro_torch.analysis.lint import sentinel_run
    import repro_torch
    root = Path(repro_torch.__file__).parent
    assert lint_path(str(root)) == []
    with spans.recording(device_clock=False) as log:
        rep = sentinel_run("quafl", device="cpu", rounds=4, chunk=2)
    assert rep["violations"] == [] and rep["programs"] == {"chunk2": 1}
    assert log.rounds > 0


def test_a_spans_twin_is_the_same_chunk_program():
    alg, p0, part = _world("batched")
    eng = RoundEngine(alg)
    gen = _gen()
    state, _ = eng.run_chunk(alg.init(p0), part, gen, 2)
    with spans.recording(device_clock=False) as log:
        state, _ = eng.run_chunk(state, part, gen, 2)
    state, _ = eng.run_chunk(state, part, gen, 2)
    assert len(eng._loops) == 2 and eng.chunk_programs() == {2: 1}
    assert log.rounds == 2 and eng.graph_times() == {}
