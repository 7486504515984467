"""The phase passes of ``phases.py`` on tiny cells on the CPU, the readers
of the four phase numbers, the idle gaps put down to spans, and the
traced window of ``run.py`` left without any span."""
from __future__ import annotations

import pytest
import torch

from perfbench import harness, phases
from perfbench.tests import tiny
from repro_torch.utils import spans

NAMES = ["mlp_quafl_paper", "olmo1b_quafl_b8"]


def _summary(ms, rounds=2, active=6.0, computed=8.0):
    return {"spans": {n: {"device_ms": v} for n, v in ms.items()},
            "counters": {"local.steps_active": active,
                         "local.steps_computed": computed},
            "rounds": rounds}


def test_phase_metrics_read_a_summary():
    got = phases.phase_metrics(_summary({
        "quafl.cohort": 1.0, "quafl.local": 10.0, "quafl.progress": 2.0,
        "quafl.exchange": 6.0, "quafl.commit": 3.0}))
    assert got == {"local_ms_per_round": 5.0, "flat_ms_per_round": 3.0,
                   "exchange_phase_ms_per_round": 3.0,
                   "local_active_share": 75.0}
    # host records only (the CPU): the ms numbers say nothing
    got = phases.phase_metrics(_summary({n: None for n in phases.PHASES}))
    assert got["local_ms_per_round"] is None
    assert got["flat_ms_per_round"] is None
    assert got["exchange_phase_ms_per_round"] is None
    assert got["local_active_share"] == 75.0


def test_idle_gaps_go_to_the_innermost_span():
    kernels = [("k", 0.0, 10.0), ("quafl.local", 0.0, 100.0),
               ("k", 20.0, 30.0), ("k", 60.0, 70.0), ("k", 100.0, 101.0)]
    host = [("quafl.round", 0.0, 200.0), ("quafl.local", 0.0, 40.0),
            ("local.grad", 5.0, 25.0), ("aten::mm", 12.0, 18.0)]
    names = {"quafl.round", "quafl.local", "local.grad"}
    drop = [k for k in kernels if k[0] not in names]
    got = phases.idle_by_span(drop, host, names)
    # gaps 10-20 (middle 15: local.grad), 30-60 (45: quafl.round),
    # 70-100 (85: quafl.round)
    assert got["idle_by_span"] == [["quafl.round", pytest.approx(60e-6)],
                                   ["local.grad", pytest.approx(10e-6)]]
    assert got["idle_s"] == pytest.approx(70e-6)
    assert got["named_share"] == 1.0
    assert phases.idle_by_span(drop, [], names)["named_share"] == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_phase_passes_on_a_tiny_cell(name):
    c = tiny.cell(name)
    res = phases.run(c, 2**33 + 9, torch.device("cpu"), steps=2, windows=2,
                     check_bits=True)
    assert res["bits"] == {"on_equals_off": True, "off_equals_off": True}
    assert set(res["setup"]["spans"]) >= {"quafl.init"}
    for got, share in zip(res["phase_metrics"], res["h_steps_share"]):
        # on the CPU no device clock: the ms numbers read None
        assert got["local_ms_per_round"] is None
        assert got["flat_ms_per_round"] is None
        assert got["exchange_phase_ms_per_round"] is None
        assert got["local_active_share"] == pytest.approx(share, rel=1e-6)
    K = c.traffic["local_steps"]
    s = c.traffic["s"]
    assert res["counters"]["local.steps_computed"] == (
        2 * res["rounds_per_step"] * s * K)
    assert set(res["spans"]) >= {"quafl.round", *phases.PHASES,
                                 "local.step", "exchange.uplink"}
    assert res["kernel_pass"]["launches_per_round"] is None
    assert res["gap_step"]["idle_by_span"] == []
    assert len(res["rounds_per_s"]["on"]) == 2
    assert not spans.on()


def test_the_traced_window_of_run_py_holds_no_span(monkeypatch):
    """Spans are off in every window ``run.py`` measures: no span is open
    and no host range of a traced run bears a span's name."""
    on, ops, real = [], set(), harness.profiled

    def watched(fn, dev, host):
        on.append(spans.on())
        out = real(fn, dev, host)
        ops.update(op[0] for op in out[2] + out[3])
        return out

    monkeypatch.setattr(harness, "profiled", watched)
    res, _ = tiny.run(tiny.cell("mlp_quafl_paper"), trace=True)
    assert on == [False, False] and ops
    names = {"quafl.round", "engine.replay", "local.step",
             "exchange.uplink", *phases.PHASES}
    assert not names & ops
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
