"""The in-place audit: a chunk fed the state the previous chunk returned
copies nothing (port of ``repro.analysis.donation``).

The reference donates the state to its compiled chunk and audits the
executable's input-output aliasing, since XLA may silently copy instead.
The port's counterpart is the engine's own contract (``fed/engine.py``): a
captured chunk reads and writes its state in the graph's static buffers
and returns them, so the state a chunk returns, fed to the next chunk,
is loaded by copying nothing. A leaf replaced out of place between chunks
(by the caller or by the algorithm's ``begin``) is copied into the static
buffer at every chunk, one more pass over the state and, at scale, one
more generation of it held. The engine counts the leaves and bytes it
copies into each chunk that replays an existing program
(``RoundEngine.copies``); on the CPU the plain loop counts the leaves that
are not the previous chunk's own tensors, what a capture would copy.

:func:`donation_report` reads an engine after a run, :func:`audit_engine`
judges it, and :func:`audit_engine_chunk` runs a few chunks on a fresh
engine over the same algorithm (from a copy of the state, every
generator put back after them) and judges those.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.violation import Violation


def donation_report(engine, state=None) -> Dict[str, int]:
    """The steady-state chunks the engine ran, the (leaves, bytes) copied
    into each (``per_chunk``) and in all (0 when each was fed the state the
    previous one returned) and, given the state the last chunk returned
    on the card, how many of its tensor leaves are not storages of a
    captured graph's static state (0: it returned the graph's own
    buffers)."""
    from repro_torch.fed.engine import _tensor_leaves
    rep = {"steady_chunks": len(engine.copies),
           "per_chunk": [list(c) for c in engine.copies],
           "leaves_copied": sum(n for n, _ in engine.copies),
           "bytes_copied": sum(b for _, b in engine.copies)}
    static = engine.static_storages()
    if state is not None and static:
        rep["leaves_not_static"] = sum(
            x.untyped_storage().data_ptr() not in static
            for x in _tensor_leaves(state))
    return rep


def audit_engine(engine, where: str, state=None) -> List[Violation]:
    """Judge :func:`donation_report`: nothing copied in steady state, and
    the returned state the graph's static buffers."""
    rep = donation_report(engine, state)
    out = []
    if rep["leaves_copied"]:
        out.append(Violation(
            "in-place", where,
            f"{rep['leaves_copied']} state leaves ({rep['bytes_copied']} "
            f"bytes) copied into {rep['steady_chunks']} chunks fed the "
            f"state the previous chunk returned: a leaf is replaced out of "
            f"place between chunks"))
    if rep.get("leaves_not_static"):
        out.append(Violation(
            "in-place", where,
            f"{rep['leaves_not_static']} leaves of the returned state are "
            f"not the captured graph's static buffers"))
    return out


def audit_engine_chunk(engine, state, data, generator, length: int,
                       where: str, chunks: int = 3
                       ) -> Tuple[List[Violation], Dict[str, int]]:
    """Run ``chunks`` chunks of ``length`` rounds on a fresh engine over
    ``engine.alg`` (from a copy of ``state``, every generator put back
    after them), each fed the state the previous returned; returns the
    violations and the report. Neither the caller's state, its generator,
    the algorithm's own generators nor ``engine``'s cache moves."""
    from repro_torch.fed.engine import RoundEngine, clone_tree, kept
    fresh = RoundEngine(engine.alg, capture=engine.capture)
    with kept(fresh.generators_of(generator)):
        st = clone_tree(state)
        for _ in range(chunks):
            st, _ = fresh.run_chunk(st, data, generator, length)
    return audit_engine(fresh, where, st), donation_report(fresh, st)
