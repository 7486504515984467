"""Divergence under ranks: replicated outputs must be the same on every
rank (port of ``repro.analysis.divergence``).

The reference proves it on the jaxpr: a value inside a ``shard_map`` that
may differ along a mesh axis must not leave through an output spec that
does not carry that axis, or device 0's copy is silently published as the
replicated state. The port runs one process a rank, so it checks the
values themselves after a step: for every output and every mesh axis its
spec does not name, the output's bytes must be the same on every rank
along that axis (a spec with no mesh axis: on every rank). Each rank
reduces its bytes to a small digest (:func:`digest`), the digests are
gathered over the axis's process group, and a rank that differs is a
violation.

On the local mesh, or an axis of one rank, there is nothing to compare
and the check is clean by construction.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.analysis.violation import Violation

# the digest: a position-weighted sum of the raw bytes in this many chunks
DIGEST_CHUNKS = 4


def digest(t: torch.Tensor) -> torch.Tensor:
    """(DIGEST_CHUNKS,) int64 on ``t``'s device: each chunk of ``t``'s raw
    bytes summed with weights by position (so a swap of two bytes moves
    it). Equal bytes give equal digests."""
    b = t.detach().reshape(-1).contiguous().view(torch.uint8)
    n = b.numel()
    per = -(-max(n, 1) // DIGEST_CHUNKS)
    w = torch.arange(per * DIGEST_CHUNKS, device=b.device) % 251 + 1
    x = torch.zeros(per * DIGEST_CHUNKS, dtype=torch.int64, device=b.device)
    x[:n] = b.to(torch.int64)
    return (x * w).reshape(DIGEST_CHUNKS, per).sum(1)


def spec_axes(spec) -> frozenset:
    """The mesh axis names a spec mentions: a spec is None (replicated), an
    axis name, or a tuple over the dimensions of names, tuples of names
    or None."""
    if spec is None:
        return frozenset()
    if isinstance(spec, str):
        return frozenset({spec})
    return frozenset(a for entry in spec for a in spec_axes(entry))


def _items(tree, specs):
    if isinstance(tree, dict):
        return [(str(k), tree[k], specs[k]) for k in tree]
    return [(str(i), t, s) for i, (t, s) in enumerate(zip(tree, specs))]


def check_divergence(outputs: Any, specs: Any, mesh, where: str
                     ) -> List[Violation]:
    """Hold every output to its spec over ``mesh``: along each mesh axis
    the spec does not name, the output's digest must be the same on every
    rank. ``outputs`` and ``specs`` are dicts with the same keys, or
    sequences in the same order. Every rank must call it (it gathers)."""
    out = []
    for name, t, spec in _items(outputs, specs):
        if not isinstance(t, torch.Tensor):
            continue
        carried = spec_axes(spec)
        dg = digest(t)
        for axis in mesh.axis_names:
            if axis in carried or mesh.group(axis) is None:
                continue
            everyone = mesh.all_gather(dg, axis)       # (ranks, chunks)
            differ = [r for r in range(everyone.shape[0])
                      if not torch.equal(everyone[r], everyone[0])]
            if differ:
                what = f"spec {spec!r}" if carried else "a replicated spec"
                out.append(Violation(
                    "spmd-divergence", where,
                    f"output {name!r} ({what}) differs along mesh axis "
                    f"{axis!r}: ranks {differ} hold other bytes than rank "
                    f"0 — rank 0's copy would be published as the "
                    f"replicated state"))
    return out
