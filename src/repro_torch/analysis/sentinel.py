"""Recapture sentinel: one chunk program per (algorithm, codec, chunk
length) (port of ``repro.analysis.sentinel``).

The engine's speed rests on each chunk being captured ONCE as a CUDA graph
and replayed after that. A capture key that wobbles (a data tensor
reallocated every chunk, a chunk length that drifts) turns every chunk
into a new warm-up and capture. The sentinel pins this two ways:

* **fingerprints** — :meth:`RecompileSentinel.record` hashes a chunk's op
  log (``RoundEngine.traced_chunk``: every op's name and output dtypes, and
  the wire marks) under a tag; a second ``record`` with another
  fingerprint for the same tag is a violation (the program a capture would
  record changed mid-run).
* **the engine's programs** — :meth:`RecompileSentinel.check_engine` reads
  ``RoundEngine.chunk_programs()`` after a run: one program a chunk length
  (a captured graph on the card; a (length, data) key of the plain loop on
  the CPU, which keeps its data as a capture does).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

from repro_torch.analysis.violation import Violation


def fingerprint(trace) -> str:
    """Stable hash of an op log: the ops' names and output dtypes in order,
    and the wire marks."""
    h = hashlib.sha256()
    for op in trace.ops:
        h.update(f"{op.name}:{op.dtypes}:{op.sizes};".encode())
    for m in trace.marks:
        h.update(f"{m.key()};".encode())
    return h.hexdigest()[:16]


class RecompileSentinel:
    """One expected chunk program a tag; any second one is a violation."""

    def __init__(self):
        self._prints: Dict = {}
        self.violations: List[Violation] = []

    def record(self, tag, trace) -> None:
        """Pin ``tag`` to the fingerprint of ``trace``; a later ``record``
        for the same tag must match."""
        fp = fingerprint(trace)
        old = self._prints.setdefault(tag, fp)
        if old != fp:
            self.violations.append(Violation(
                "recompile", f"{tag}",
                f"the chunk's op log changed mid-run: fingerprint {old} -> "
                f"{fp} (a second program for this tag)"))

    def check_engine(self, tag, engine) -> List[Violation]:
        """After a run: every chunk length of ``engine`` made exactly one
        program."""
        out = []
        for length, n in sorted(engine.chunk_programs().items()):
            if n > 1:
                out.append(Violation(
                    "recompile", f"{tag}/chunk{length}",
                    f"{n} chunk programs of length {length} in one run (a "
                    f"capture key moved between chunks: data reallocated, "
                    f"or the chunk's inputs changed)"))
        self.violations.extend(out)
        return out

    def report(self) -> List[Violation]:
        return list(self.violations)
