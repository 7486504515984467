"""The port's round against the plain reference at a size the CPU holds:
the same inputs and draws give the same state (the test may import the
port; the reference may not)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from perfbench import compare
from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT

# what the reference, the counts and the traffic may import
ALLOWED = {"__future__", "math", "hashlib", "dataclasses", "typing", "numpy",
           "torch", "perfbench"}


def test_mlp_round_equals_reference():
    res, _ = tiny.run(tiny.cell("mlp_quafl_paper"))
    c = res["checks"]
    assert res["correct"] and c["bits_gap"]["value"] == 0
    assert c["server_gap"]["value"] < 1e-5
    assert c["client_gap"]["value"] < 1e-5
    assert c["change_gap"]["value"] < 1e-6


def test_lm_round_equals_reference_in_fp32():
    res, obs = tiny.run(tiny.cell("olmo1b_quafl_b8", compute_dtype="float32"))
    c, n = res["checks"], obs["numbers"]
    assert res["correct"] and c["bits_gap"]["value"] == 0
    # fp32 on both sides: rounding alone
    assert c["step1_gap"]["value"] < 1e-4
    # the first round's local steps, recorded on both sides
    assert n["loss1_gap"] < 1e-6
    assert n["grad1_gap"] < 1e-6
    assert n["grad1_dir_gap"] < 1e-5


def test_first_step_gaps_of_hand_made_records():
    R = {"losses": torch.tensor([2.0, 4.0]),
         "norms": torch.tensor([[1.0, 2.0, 4.0]], dtype=torch.float64),
         "picks": [torch.tensor([[3.0, 4.0]], dtype=torch.float64),
                   torch.tensor([[0.0, 2.0]], dtype=torch.float64),
                   torch.tensor([[0.0, 4.0]], dtype=torch.float64)]}
    P = {"losses": torch.tensor([2.0, 4.2]),
         "norms": torch.tensor([[1.0, 2.2, 4.0]], dtype=torch.float64),
         "picks": [torch.tensor([[3.0, 4.0]], dtype=torch.float64),
                   torch.tensor([[0.0, 2.0]], dtype=torch.float64),
                   torch.tensor([[1.0, 4.0]], dtype=torch.float64)]}
    g = compare.first_step_gaps(P, R)
    assert g["loss1_gap"] == pytest.approx(0.05)
    # |2.2 - 2| over the median norm 2
    assert g["grad1_gap"] == pytest.approx(0.1)
    # |(1, 0)| over max(|(0, 4)|, the median picks' norm 4)
    assert g["grad1_dir_gap"] == pytest.approx(0.25)
    short = dict(P, losses=P["losses"][:1])
    assert compare.first_step_gaps(short, R)["loss1_gap"] == float("inf")


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for d in ("reference", "traffic")
    for p in (ROOT / "perfbench" / d).glob("*.py")) + [
        "perfbench/counts.py", "perfbench/compare.py"])
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(Path(ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in ALLOWED, (path, n)
