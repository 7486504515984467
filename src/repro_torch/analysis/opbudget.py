"""Rotation budget of the exchange (port of the counter half of
``repro.analysis.opbudget``).

The reference counts rotations at trace time; PyTorch runs eagerly, so here
the pipeline counts each rotation pass as it runs it, and a test or the
smoke script compares the counts with :func:`rotation_budget`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

ROT_FWD = "rotation_fwd"
ROT_INV = "rotation_inv"


@dataclass
class OpBudget:
    """Forward and inverse full-model rotation passes, by message."""
    fwd: int = 0
    inv: int = 0

    def counts(self) -> Dict[str, int]:
        return {ROT_FWD: self.fwd, ROT_INV: self.inv}


def rotation_budget(s: int) -> Dict[str, int]:
    """One QuAFL round's contract: ``s + 1`` forward rotations (the s client
    encodes and the server's rotation; the downlink Enc(X_t) quantizes the
    cached rotated server) and ``s + 1`` inverse ones (the s new client
    states and the new server)."""
    return {ROT_FWD: s + 1, ROT_INV: s + 1}
