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

An ABSTRACT mesh (:func:`make_abstract_mesh`, ``make_production_mesh(...,
abstract=True)``) is a shape, axes and the coordinates of one rank, with no
process group: the dry-run tools walk one rank's step on ``meta`` tensors
over the (16, 16) or (2, 16, 16) production layout without 256 processes.
Its collectives run every local op a mesh with groups runs (the copies, the
allocations, the concatenations) and skip only the transfer, so their
outputs have the right shapes; it refuses any tensor that is not on
``meta``.

Every collective of a mesh with groups, real or abstract, is recorded in
:attr:`Mesh.records` while recording is on (:meth:`Mesh.recording`; always
on an abstract mesh), one record a collective along one axis, a group of
one included (the reference's jaxpr counts a collective over an axis of
size 1 too; ``roofline`` skips them, as they move nothing): ``op`` (``psum``, ``pmax``,
``reduce_scatter``, ``all_gather``, the reference's jaxpr names), ``kind``
(``all-reduce``, ``reduce-scatter``, ``all-gather``, its HLO names),
``axis``, ``ranks``, ``dtype``, ``float``, ``in_bytes`` and ``out_bytes``
(one rank's operand and result) and ``call`` (the collective call it
belongs to: a psum over two axes is one call of two records).
``launch/roofline.collective_seconds`` and
``analysis/opbudget.check_collective_bytes`` read them. A wire recorder
(``analysis/provenance.py``) gets each record with its operand while it
listens, recording on or off.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from collections import OrderedDict
from typing import Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.analysis import provenance

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
        self.records = None
        self._calls = itertools.count()
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

    # -- collective records ---------------------------------------------
    @contextlib.contextmanager
    def recording(self):
        """Record every collective made inside; yields the record list."""
        saved, self.records = self.records, []
        try:
            yield self.records
        finally:
            self.records = saved

    def _record(self, op: str, kind: str, axis: str, x, out, call: int):
        if self.records is None and not provenance.RECORDERS:
            return
        record = {
            "op": op, "kind": kind, "axis": axis, "ranks": self.shape[axis],
            "dtype": str(x.dtype).replace("torch.", ""),
            "float": bool(x.is_floating_point()),
            "in_bytes": x.numel() * x.element_size(),
            "out_bytes": out.numel() * out.element_size(), "call": call}
        if self.records is not None:
            self.records.append(record)
        provenance.observe_collective(record, x)

    # -- the transfers (an abstract mesh skips them) ----------------------
    def _has_group(self, name: str) -> bool:
        return self.group(name) is not None

    def _all_reduce_op(self, x, op, name):
        dist.all_reduce(x, op=op, group=self.group(name))

    def _reduce_scatter_op(self, out, flat, name):
        _reduce_scatter(out, flat, group=self.group(name))

    def _all_gather_op(self, out, flat, name):
        _all_gather(out, flat, group=self.group(name))

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
        call = next(self._calls)
        name = "psum" if op == dist.ReduceOp.SUM else "pmax"
        for a in self._names(axes):
            if self._has_group(a):
                x = x.clone(memory_format=torch.contiguous_format)
                self._all_reduce_op(x, op, a)
                self._record(name, "all-reduce", a, x, x, call)
        return x

    def psum_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Tiled ``psum_scatter`` of a ``(1, d)`` row along its last
        dimension: the sum over ``axis``, this rank's ``d / n`` slice of
        it, ``(1, d / n)``."""
        n = self.shape[axis]
        if not self._has_group(axis):
            return x
        flat = x.reshape(-1).contiguous()
        out = flat.new_empty(flat.numel() // n)
        self._reduce_scatter_op(out, flat, axis)
        self._record("reduce_scatter", "reduce-scatter", axis, flat, out,
                     next(self._calls))
        return out.reshape(*x.shape[:-1], x.shape[-1] // n)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` of every rank along ``axis``, stacked in coordinate order:
        ``(n, *x.shape)``."""
        n = self.shape[axis]
        if not self._has_group(axis):
            return x[None]
        flat = x.reshape(-1).contiguous()
        out = flat.new_empty(n * flat.numel())
        self._all_gather_op(out, flat, axis)
        self._record("all_gather", "all-gather", axis, flat, out,
                     next(self._calls))
        return out.reshape(n, *x.shape)

    def all_gather_tiled(self, x: torch.Tensor, axis: str,
                         dim: int) -> torch.Tensor:
        """Tiled ``all_gather``: the blocks of every rank along ``axis``
        concatenated along ``dim``."""
        if not self._has_group(axis):
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


class AbstractMesh(Mesh):
    """A mesh of ``shape`` and ``axes`` seen from the rank at ``coords``,
    with no process group: every axis acts as if it had one, each
    collective runs its local ops on ``meta`` tensors and records itself,
    and the transfer is skipped (its output keeps its shape)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 coords=None):
        super().__init__(shape, axes)
        for a, i in dict(coords or {}).items():
            if a not in self.shape or not 0 <= int(i) < self.shape[a]:
                raise ValueError(f"coordinate {a}={i} outside the mesh "
                                 f"{dict(self.shape)}")
            self._coords[a] = int(i)
        self.records = []

    def __repr__(self):
        return f"AbstractMesh({dict(self.shape)}, at {self._coords})"

    @contextlib.contextmanager
    def recording(self):
        saved, self.records = self.records, []
        try:
            yield self.records
        finally:
            self.records = saved + self.records

    def _has_group(self, name: str) -> bool:
        return True

    @staticmethod
    def _meta(x):
        if x.device.type != "meta":
            raise ValueError(f"an abstract mesh takes meta tensors only; got "
                             f"one on {x.device}")

    def _all_reduce_op(self, x, op, name):
        self._meta(x)

    def _reduce_scatter_op(self, out, flat, name):
        self._meta(flat)

    def _all_gather_op(self, out, flat, name):
        self._meta(flat)


def make_abstract_mesh(shape: Sequence[int], axes: Sequence[str],
                       coords=None) -> AbstractMesh:
    """An abstract mesh of ``shape`` named ``axes`` at ``coords`` (axis ->
    index, 0 where not given): no process group, meta tensors only."""
    return AbstractMesh(shape, axes, coords)


def make_production_mesh(*, multi_pod: bool = False,
                         abstract: bool = False) -> Mesh:
    """The reference's production layout: (16, 16) data×model, or (2, 16,
    16) pod×data×model; needs that many ranks, or ``abstract=True`` for
    the abstract mesh of that layout seen from rank 0."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if abstract:
        return make_abstract_mesh(shape, axes)
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pods: int = 0) -> Mesh:
    """A small mesh over the ranks of the process group (the rank tests
    run (4, 2) and (2, 2, 2) under gloo)."""
    if pods:
        return make_mesh((pods, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
