"""Leaf-wise wire accounting of the mesh train step (port of
``repro.core.transport``).

The flat algorithms exchange one vector; on the mesh every parameter leaf
is its own message (each leaf flattens to its own vector, rotation blocks
never cross leaves), still a valid instance of the blockwise lattice
quantizer. The reference's ``tree_encode`` / ``tree_decode`` encode and
decode every leaf of a tree at once; the port's step
(:mod:`repro_torch.launch.steps`) encodes and decodes one leaf at a time
instead, with the batched codecs of :mod:`repro_torch.compression.codecs`,
so that a model at full width never holds every leaf's message at once.
"""
from __future__ import annotations

from typing import Any, Dict


def tree_bits(quant, tree: Dict[str, Any]) -> int:
    """Bits of one message of every leaf, each padded on its own (shapes
    only: meta tensors do)."""
    return int(sum(quant.message_bits(int(v.numel())) for v in tree.values()))
