"""Flatten a parameter dict to one fp32 vector and back (port of
``tree_flatten_vector`` / ``tree_unflatten_vector`` of ``repro.utils.tree``),
and the per-path seed of the LM inits (port of ``fold_in_str``).

The reference flattens a pytree, and JAX orders dict leaves by sorted key,
so the flat layout here is the same: for the MLP ``b1, b2, w1, w2``, each
leaf row-major.
"""
from __future__ import annotations

import zlib
from typing import Dict

import torch


def tree_size(tree: Dict[str, torch.Tensor]) -> int:
    return sum(int(v.numel()) for v in tree.values())


def tree_flatten_vector(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate the leaves, in sorted key order, into one flat fp32
    vector."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in sorted(tree)])


def tree_unflatten_vector(template: Dict[str, torch.Tensor],
                          vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`tree_flatten_vector` against ``template``. A
    leading batch axis on ``vec`` ((s, d) for s clients) carries over to
    every leaf ((s, *shape)). Leaves are views into ``vec``."""
    batch = tuple(vec.shape[:-1])
    out, off = {}, 0
    for k in sorted(template):
        leaf = template[k]
        n = int(leaf.numel())
        out[k] = vec[..., off:off + n].reshape(*batch, *leaf.shape)
        off += n
    if off != vec.shape[-1]:
        raise ValueError(f"vector of length {vec.shape[-1]} does not match "
                         f"the template's {off} parameters")
    return out


def fold_in_str(seed: int, s: str) -> int:
    """A seed for one parameter path, derived from the run's ``seed`` and the
    crc32 of ``s`` (the hash the reference folds into its key). Feed it to
    ``torch.Generator.manual_seed``; the draws differ from threefry's."""
    return ((int(seed) & 0xFFFFFFFF) << 31) | (zlib.crc32(s.encode())
                                               & 0x7FFFFFFF)
