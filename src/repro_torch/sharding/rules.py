"""Logical-axis -> mesh-axis sharding rules (port of
``repro.sharding.rules``), and the block of a leaf each rank holds.

A rule maps a logical axis name to a mesh axis (or a priority list of mesh
axes). :func:`pspec_for` applies the rules with a divisibility check: a
dimension that does not divide evenly by the mesh axis size is left
replicated, and a mesh axis is never assigned twice. A spec is a plain
tuple, one mesh axis name or ``None`` per leading dimension (trailing
``None`` dropped, as ``PartitionSpec`` prints), so this module imports no
mesh: anything with a ``shape`` mapping of axis name to size will do.

:func:`cut_block` takes the block of a full leaf that the rank at given mesh
coordinates holds; :func:`join_blocks` puts the blocks of every rank back
together.
"""
from __future__ import annotations

import itertools
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Rule = Union[None, str, Sequence[str]]
Spec = Tuple[Optional[str], ...]

# Tensor-parallel inside a replica; clients stacked over the data axis.
RULES_TP: Dict[str, Rule] = {
    "vocab": "model",
    "q_flat": "model",
    "kv_flat": "model",
    "mlp": "model",
    "expert_mlp": "model",
    "experts": None,
    "lora": None,
    "embed": None,
    "layers": None,
    "clients": "data",
    # activations / cache
    "batch": "data",
    "batch_local": None,   # per-client batch (client replicas own 'data')
    "kv_seq": "data",      # claimed only when 'data' is still free (batch=1)
    "kv_heads": "model",   # decode cache: kv heads over model when divisible
    "head_dim": "model",   # ...else head_dim (128 % 16 == 0 everywhere)
    "kv_lora": "model",    # MLA compressed cache dim
    "act_seq": None,
    "act_model": "model",
}

# Cohort mode for the giant architectures: one client per pod; parameters are
# additionally fully-sharded (FSDP) over the data axis on the embed dim.
RULES_FSDP: Dict[str, Rule] = dict(
    RULES_TP,
    embed="data",
    clients="pod",
    batch_local="data",    # the cohort's batch spreads over the data axis
)

# Expert-parallel variant: experts over the model axis, expert-FFN dim
# replicated.
RULES_EP: Dict[str, Rule] = dict(
    RULES_TP,
    experts="model",
    expert_mlp=None,
)


def rules_for_mode(mode: str) -> Dict[str, Rule]:
    return {"client_dp": RULES_TP, "cohort": RULES_FSDP, "ep": RULES_EP}[mode]


def pspec_for(shape, axes, rules: Dict[str, Rule], mesh) -> Spec:
    """The spec of one array, honoring divisibility and never assigning the
    same mesh axis twice. ``mesh`` is anything with a ``shape`` mapping."""
    used = set()
    out = []
    for dim, ax in zip(shape, axes):
        assign = None
        cands = rules.get(ax) if ax is not None else None
        if cands is not None:
            if isinstance(cands, str):
                cands = [cands]
            for cand in cands:
                if cand in used or cand not in mesh.shape:
                    continue
                if dim % mesh.shape[cand] == 0 and dim >= mesh.shape[cand]:
                    assign = cand
                    used.add(cand)
                    break
        out.append(assign)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_pspecs(shape_tree, axes_tree, rules, mesh) -> Dict[str, Spec]:
    """shape_tree: path -> tensor (meta will do); axes_tree: path -> axes."""
    return {k: pspec_for(tuple(v.shape), axes_tree[k], rules, mesh)
            for k, v in shape_tree.items()}


def block_shape(shape, spec: Spec, mesh_shape: Mapping[str, int]
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    out = list(shape)
    for i, ax in enumerate(spec):
        if ax is not None:
            out[i] //= mesh_shape[ax]
    return tuple(out)


def cut_block(x: torch.Tensor, spec: Spec, mesh_shape: Mapping[str, int],
              coords: Mapping[str, int]) -> torch.Tensor:
    """The block (a view) of the full leaf ``x`` that the rank at mesh
    ``coords`` holds: along each sharded dimension its coordinate's equal
    slice."""
    for i, ax in enumerate(spec):
        if ax is not None:
            n = x.shape[i] // mesh_shape[ax]
            x = x.narrow(i, coords[ax] * n, n)
    return x


def join_blocks(blocks: Mapping[Tuple[int, ...], torch.Tensor], spec: Spec,
                mesh_shape: Mapping[str, int]) -> torch.Tensor:
    """The full leaf from every rank's block: ``blocks`` maps each rank's
    mesh coordinates (a tuple in the order of ``mesh_shape``) to its block.
    Of the ranks that hold the same block (replicas along the axes the spec
    does not use) the first in row-major order is taken, as a replicated
    JAX array reads its first device's copy."""
    names = list(mesh_shape)
    full, done = None, set()
    for coords in itertools.product(*(range(n) for n in mesh_shape.values())):
        at = dict(zip(names, coords))
        place = tuple(at[ax] for ax in spec if ax is not None)
        if place in done:
            continue
        done.add(place)
        blk = blocks[coords]
        if full is None:
            full = blk.new_empty(tuple(
                s * (mesh_shape[ax] if ax is not None else 1)
                for s, ax in itertools.zip_longest(blk.shape, spec)))
        cut_block(full, spec, mesh_shape, at).copy_(blk)
    return full
