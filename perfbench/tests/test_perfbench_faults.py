"""The comparison refuses what it must: the control (the reference in the
precision below the configuration's) and the program broken underneath a
run, each at a size the CPU holds, judged by the cells' own limits."""
from __future__ import annotations

import pytest
import torch

from perfbench import compare, control, harness
from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT

CELLS = ("mlp_quafl_paper", "olmo1b_quafl_b8")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    # the configuration's own precision, so the control is the one below
    # it: TF32 for the fp32 MLP, fp8 for olmo-1b's bf16
    cell = tiny.cell(name, compute_dtype=harness.find_cell(
        ROOT, name).config["compute_dtype"])
    got = control.readings(cell, 2**33 + 7, torch.device("cpu"),
                           variants=("control",))
    ok, _ = compare.verdict(got["control"], cell.limits)
    assert not ok, got["control"]


def _unchanged(alg):
    from repro_torch.fed.engine import clone_tree
    real = alg.round

    def frozen(state, data, generator, draws=None):
        _, m = real(clone_tree(state), data, generator, draws)
        return state, m
    alg.round = frozen


def _half_batch(alg):
    real = alg.loss_fn
    axis = 0 if alg.batch_fn is not None else 1

    def half(params, batch):
        return real(params, {k: v.narrow(axis, 0, v.shape[axis] // 2)
                             for k, v in batch.items()})
    alg.loss_fn = half


def _no_exchange(alg):
    def skipped(server, Y, hints_up, **kw):
        return server.clone(), Y, hints_up.max(), torch.zeros(())
    alg.pipeline.quafl_round = skipped


def _answer_altered(alg):
    real = alg.pipeline.quafl_round

    def altered(server, Y, hints_up, **kw):
        server_new, *rest = real(server, Y, hints_up, **kw)
        server_new[:alg.pipeline.block] = 0.0
        return (server_new, *rest)
    alg.pipeline.quafl_round = altered


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_round_is_not_correct(name, fault):
    res, _ = tiny.run(tiny.cell(name), plant=FAULTS[fault])
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_round_is_correct(name):
    res, _ = tiny.run(tiny.cell(name))
    assert res["correct"] is True, res["checks"]
