"""The device mesh of the mesh path (port of ``repro.launch.mesh`` and
``repro.utils.compat.make_mesh``) over ``torch.distributed``.

One process per mesh position: rank r sits at coordinates ``(data,
model)``, or ``(pod, data, model)``. :class:`Mesh` holds the axes' sizes
(``shape``, an ordered dict, as a JAX mesh's), this rank's coordinate on
each axis (:meth:`Mesh.axis_index`) and each axis's process group
(:meth:`Mesh.group`, from ``init_device_mesh``'s per-axis groups), and it
carries the collectives over a named axis that the mesh step uses, the
port's counterparts of ``jax.lax.psum``, ``pmax``, tiled ``psum_scatter``
and ``all_gather``.

A mesh made when no process group exists is the LOCAL instance: every axis
has size 1 and every collective is the identity, the same program as the
reference's single-device (1, 1) mesh. A mesh made over a process group
(``init_process_group`` first; ``torchrun`` sets its address, world size
and rank) runs every collective through it, a group of one rank included,
so an NCCL group of one on one card runs the NCCL code path.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

# the flat-tensor collectives, under their newer names where torch has them
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class Mesh:
    """A named mesh: ``shape`` (axis name -> size, in order), this rank's
    coordinates, and a process group per axis (none on the local mesh)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_type: str = None):
        self.shape = OrderedDict(zip(axes, (int(n) for n in shape)))
        self.device_mesh = None
        self._coords = {a: 0 for a in axes}
        self._groups = {}
        if device_type is not None:
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(
                device_type, tuple(self.shape.values()),
                mesh_dim_names=tuple(axes))
            self._coords = {a: self.device_mesh.get_local_rank(a)
                            for a in axes}
            self._groups = {a: self.device_mesh.get_group(a) for a in axes}

    def __repr__(self):
        kind = "local" if self.device_mesh is None else "distributed"
        return f"Mesh({dict(self.shape)}, {kind})"

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (0 on the local mesh)."""
        return self._coords[name]

    def coords(self):
        """This rank's coordinates, axis name -> index."""
        return dict(self._coords)

    def group(self, name: str):
        """The process group along ``name`` (None on the local mesh)."""
        return self._groups.get(name)

    # -- collectives over named axes ------------------------------------
    def _names(self, axes: Axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum of ``x`` over the ranks along each of ``axes``."""
        return self._all_reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Elementwise max of ``x`` over the ranks along ``axes``."""
        return self._all_reduce(x, axes, dist.ReduceOp.MAX)

    def _all_reduce(self, x, axes, op):
        for a in self._names(axes):
            g = self.group(a)
            if g is not None:
                x = x.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(x, op=op, group=g)
        return x

    def psum_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Tiled ``psum_scatter`` of a ``(1, d)`` row along its last
        dimension: the sum over ``axis``, this rank's ``d / n`` slice of
        it, ``(1, d / n)``."""
        n = self.shape[axis]
        g = self.group(axis)
        if g is None:
            return x
        flat = x.reshape(-1).contiguous()
        out = flat.new_empty(flat.numel() // n)
        _reduce_scatter(out, flat, group=g)
        return out.reshape(*x.shape[:-1], x.shape[-1] // n)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` of every rank along ``axis``, stacked in coordinate order:
        ``(n, *x.shape)``."""
        n = self.shape[axis]
        g = self.group(axis)
        if g is None:
            return x[None]
        flat = x.reshape(-1).contiguous()
        out = flat.new_empty(n * flat.numel())
        _all_gather(out, flat, group=g)
        return out.reshape(n, *x.shape)

    def all_gather_tiled(self, x: torch.Tensor, axis: str,
                         dim: int) -> torch.Tensor:
        """Tiled ``all_gather``: the blocks of every rank along ``axis``
        concatenated along ``dim``."""
        if self.group(axis) is None:
            return x
        parts = self.all_gather(x, axis)
        return torch.cat(parts.unbind(0), dim=dim)

    def gather_leaf(self, block: torch.Tensor, spec, skip: Axes = ()
                    ) -> torch.Tensor:
        """The full leaf from this rank's ``block``: a tiled all-gather
        along each sharded dimension of ``spec`` whose mesh axis is not in
        ``skip``."""
        skip = self._names(skip)
        for i, ax in enumerate(spec):
            if ax is not None and ax not in skip:
                block = self.all_gather_tiled(block, ax, i)
        return block


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = None) -> Mesh:
    """A mesh of ``shape`` named ``axes``. With a default process group
    (``torch.distributed`` initialised) the mesh spans its ranks, on
    ``device_type`` ('cuda' or 'cpu'; the group's backend decides when
    None), and ``shape`` must hold exactly its world size. Without one, the
    local mesh: every axis of size 1, or ``ValueError`` naming
    ``torchrun``."""
    size = math.prod(int(n) for n in shape)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if size != world:
            raise ValueError(f"mesh {tuple(shape)} holds {size} ranks but "
                             f"the process group has {world}")
        if device_type is None:
            device_type = ("cuda" if dist.get_backend() == "nccl"
                           else "cpu")
        return Mesh(shape, axes, device_type)
    if size != 1:
        raise ValueError(
            f"mesh {tuple(shape)} needs {size} ranks, one process each: "
            f"launch it with torchrun --nproc-per-node {size} (gloo on the "
            f"CPU, NCCL on cards), or initialise torch.distributed first")
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout: (16, 16) data×model, or (2, 16,
    16) pod×data×model; needs that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pods: int = 0) -> Mesh:
    """A small mesh over the ranks of the process group (the rank tests
    run (4, 2) and (2, 2, 2) under gloo)."""
    if pods:
        return make_mesh((pods, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
