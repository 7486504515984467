"""Op budgets of the exchange: named structural counters, the rotation
budget of a QuAFL round and the per-device bytes of the mesh's collectives
(port of ``repro.analysis.opbudget``).

The reference counts rotations while Python builds a trace and re-traces a
round with ``jax.eval_shape`` to audit it. PyTorch runs eagerly, so the
pipeline counts each rotation pass as it runs it (``pipeline.stats``, an
:class:`OpBudget` with the legacy ``.fwd``/``.inv`` surface), and
:func:`measure_round_counters` runs one round on a copy of the state with
the generator restored after it, so the caller's state and draws are
untouched. The reference's jaxpr-level half (collective bytes, op counts)
comes here from the mesh's collective records (``launch/mesh.py``,
:func:`collective_bytes`) and the op-cost walker's op counts
(``launch/hlocost.py``), merged by :func:`op_budget_report`. Findings are
:class:`~repro_torch.analysis.violation.Violation` records, not bare
asserts.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.analysis.violation import Violation

# counter names the rotation audit uses
ROT_FWD = "rotation_fwd"
ROT_INV = "rotation_inv"


@dataclass
class OpBudget:
    """Named structural counters. ``.fwd`` / ``.inv`` read and write the
    ``rotation_fwd`` / ``rotation_inv`` counters (the pipeline's
    ``stats.fwd += m``), other counters go through :meth:`add` /
    :meth:`get`."""
    counters: Dict[str, int] = field(default_factory=dict)

    def add(self, name: str, k: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(k)

    def get(self, name: str) -> int:
        return self.counters.get(name, 0)

    def reset(self) -> None:
        self.counters.clear()

    # legacy RotationStats surface -----------------------------------------
    @property
    def fwd(self) -> int:
        return self.get(ROT_FWD)

    @fwd.setter
    def fwd(self, v: int) -> None:
        self.counters[ROT_FWD] = int(v)

    @property
    def inv(self) -> int:
        return self.get(ROT_INV)

    @inv.setter
    def inv(self, v: int) -> None:
        self.counters[ROT_INV] = int(v)

    def counts(self) -> Dict[str, int]:
        """The rotation counters: forward and inverse passes, by message."""
        return {ROT_FWD: self.fwd, ROT_INV: self.inv}

    def expect(self, where: str,
               budget: Dict[str, int]) -> List[Violation]:
        """Judge the current counters against ``budget`` (exact match per
        named counter); returns one violation per blown counter."""
        out = []
        for name, want in budget.items():
            got = self.get(name)
            if got != want:
                out.append(Violation(
                    "op-budget", where,
                    f"counter {name!r}: {got} != budgeted {want}"))
        return out


def collective_bytes(records) -> Dict[str, int]:
    """Per-device bytes of the mesh's collective records, by
    ``<op>_fbytes`` (float payload) and ``<op>_ibytes`` (integer codes):
    an all-gather's result, a psum's or reduce-scatter's operand, as the
    reference's ``collective_bytes`` reads a jaxpr. A psum over several
    axes is one call, counted once; ``pmax`` is not counted (nor is it in
    the reference)."""
    out: Dict[str, int] = {}
    seen = set()
    for r in records:
        if r["op"] == "pmax" or r["call"] in seen:
            continue
        seen.add(r["call"])
        key = f"{r['op']}_{'f' if r['float'] else 'i'}bytes"
        moved = r["out_bytes"] if r["op"] == "all_gather" else r["in_bytes"]
        out[key] = out.get(key, 0) + int(moved)
    return out


def check_collective_bytes(records, where: str,
                           caps: Dict[str, int]) -> List[Violation]:
    """Judge the mesh's per-device collective payload
    (:func:`collective_bytes` of ``records``) against byte CAPS, keyed as
    a transport's ``WireBudget`` — upper bounds, not exact counts, because
    scalar side-channel rows may legitimately come and go. One violation
    per blown cap; a cap on a key the records never produce passes
    vacuously (0 bytes moved)."""
    rep = collective_bytes(records)
    out = []
    for key, cap in caps.items():
        got = rep.get(key, 0)
        if got > cap:
            out.append(Violation(
                "collective-bytes", where,
                f"{key}: {got} B moved exceeds budget {cap} B"))
    return out


def rotation_budget(s: int) -> Dict[str, int]:
    """One QuAFL round's contract: ``s + 1`` forward rotations (the s client
    encodes and the server's rotation; the downlink Enc(X_t) quantizes the
    cached rotated server) and ``s + 1`` inverse ones (the s new client
    states and the new server)."""
    return {ROT_FWD: s + 1, ROT_INV: s + 1}


def _one_round(alg, state, data, generator, walker=None):
    """Run one round of ``alg`` on a copy of ``state`` (under ``walker`` if
    given), the generator put back as it was after it; returns the
    pipeline counters it incremented, or None when the algorithm has no
    counted pipeline."""
    from repro_torch.fed.engine import clone_tree
    stats = getattr(getattr(alg, "pipeline", None), "stats", None)
    saved = None if stats is None else dict(stats.counters)
    g_state = generator.get_state() if generator is not None else None
    if stats is not None:
        stats.reset()
    try:
        copy = clone_tree(state)
        with walker if walker is not None else contextlib.nullcontext():
            alg.round(copy, data, generator)
        return None if stats is None else OpBudget(dict(stats.counters))
    finally:
        if stats is not None:
            stats.counters = saved
        if generator is not None:
            generator.set_state(g_state)


def measure_round_counters(alg, state, data, generator
                           ) -> Optional[OpBudget]:
    """Run one round of ``alg`` and return the pipeline counters it
    incremented, or None (running nothing) when the algorithm has no
    counted pipeline. Neither ``state`` nor ``generator`` changes."""
    if getattr(getattr(alg, "pipeline", None), "stats", None) is None:
        return None
    return _one_round(alg, state, data, generator)


def check_rotation_budget(alg, state, data, generator, where: str,
                          budget: Optional[Dict[str, int]] = None,
                          ) -> List[Violation]:
    """Run one round and audit the rotation-pass counters against the
    budget (default: :func:`rotation_budget` for the algorithm's ``s``).
    Algorithms without a counted pipeline pass vacuously."""
    measured = measure_round_counters(alg, state, data, generator)
    if measured is None:
        return []
    if budget is None:
        budget = rotation_budget(int(alg.fed.s))
    return measured.expect(where, budget)


def op_budget_report(alg, state, data, generator, mesh=None
                     ) -> Dict[str, int]:
    """Merged structural report of one round: the op-cost walker's op
    counts by aten op and kernel, ``ops_total``, the collective bytes of
    ``mesh``'s records (when given) and the pipeline's rotation counters
    (when present)."""
    from repro_torch.launch.hlocost import CostWalker
    walker = CostWalker(mesh, records=True, cross_check=False)
    measured = _one_round(alg, state, data, generator, walker)
    rep: Dict[str, int] = dict(Counter(r[0] for r in walker.records))
    rep["ops_total"] = len(walker.records)
    rep.update(collective_bytes(walker.coll_records))
    if measured is not None:
        rep.update(measured.counters)
    return rep
