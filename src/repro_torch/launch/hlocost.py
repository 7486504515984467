"""The op-cost walker of one step (port of ``repro.launch.hlocost``).

The reference parses XLA's post-optimization HLO text and multiplies each
while-loop body's cost by its trip count. The port runs eagerly, so the
walker is a ``TorchDispatchMode`` over one call of a step, on ``meta``
tensors (an abstract run, ``launch/dryrun.py``) or on real ones: every aten
op the step dispatches passes through it, every layer of its Python loops
included, so there are no trip counts to recover.

Per walk:
  * flops — 2·M·N·K for every ``mm``/``bmm``/``addmm``/``baddbmm`` (the
    einsums and linears lower to them), a convolution by its formula
    (``gemm_flops``), plus each kernel wrapper's own count
    (``kernels/build.costed``: flash attention 4·dh per visible (query,
    key) pair and head, the exchange's butterflies and roundings none;
    ``kernel_flops``);
  * bytes — the inputs read and outputs written by every op that is not a
    view, a reshape, an allocation or a metadata op (:data:`FREE_OPS`, the
    counterpart of the reference's ``_FREE_OPS``), each tensor once an op
    and a broadcast dimension once, the first argument of a copy or fill
    written only (:data:`WRITE_ONLY`);
    each kernel wrapper its own inputs and outputs, the ops inside it
    muted;
  * collectives — the mesh's records made during the walk
    (``launch/mesh.py``), by kind: ``{"bytes", "count"}``, ``bytes`` the
    results' (the convention ``roofline.RING_FACTOR`` scales);
  * ``peak_live_bytes`` — the most bytes of tensor storage alive at once:
    the arguments given to :meth:`CostWalker.track` and every storage an op
    creates, each released when it is freed;
  * records — ``(op, bytes, flops, where)`` an op, ``where`` the innermost
    line of the port that called it, for :func:`top_contributors`.

A cross-check runs under the same walk (``flop_counter``): the formulas
``FlopCounterMode`` counts with (``torch.utils.flop_counter.flop_registry``)
applied to the same ops, muted ones included, without a second dispatch
mode (which would double the walk's time); its total must equal the
walker's GEMM flops, the muted ops' included (``gemm_flops +
muted_gemm_flops``), and it equals a ``FlopCounterMode``'s total over the
same step (``tests/test_torch_tools.py``).
"""
from __future__ import annotations

import os
import sys
import weakref
from collections import Counter, defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

aten = torch.ops.aten

# ops whose results are allocations, reshapes or book-keeping, not memory
# traffic (views are caught by their schema, ``is_view``)
FREE_OPS = frozenset({
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size, aten.set_,
    aten.resize_, aten.detach_,
})

# ops that write their first argument without reading it
WRITE_ONLY = frozenset({aten.copy_, aten.fill_, aten.zero_})

_SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_FILES = {os.path.join(_SRC, "launch", "hlocost.py"),
               os.path.join(_SRC, "kernels", "build.py"),
               os.path.join(_SRC, "launch", "mesh.py")}


def _nbytes(t) -> int:
    """The bytes a tensor's elements span, a broadcast (stride-0) dimension
    once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def gemm_flops(func, args) -> float:
    """2·M·N·K of a matrix product; a convolution's 2·out·(C_in/groups)·
    kernel; 0 for any other op."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.addmm):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet is aten.convolution:
        x, w, groups = args[0], args[1], args[8]
        n_out = x.shape[0] * w.shape[0]
        for d in _conv_out(x, w, args):
            n_out *= d
        k = 1
        for d in w.shape[2:]:
            k *= d
        return 2.0 * n_out * (x.shape[1] // groups) * k
    return 0.0


def _conv_out(x, w, args):
    stride, padding, dilation = args[3], args[4], args[5]
    out = []
    for i, n in enumerate(x.shape[2:]):
        k = w.shape[2 + i]
        out.append((n + 2 * padding[i] - dilation[i] * (k - 1) - 1)
                   // stride[i] + 1)
    return out


def _where() -> str:
    """The innermost frame of the port outside the walker's own files."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_SRC) and fn not in _SKIP_FILES:
            rel = os.path.relpath(fn, _SRC)
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


class CostWalker(TorchDispatchMode):
    """``with CostWalker(mesh) as w: step(...)``, then :meth:`summary`.

    ``mesh`` (optional) is the mesh whose collective records count;
    ``records`` keeps the per-op records (:func:`top_contributors`);
    ``cross_check`` sums ``FlopCounterMode``'s formulas over the same
    ops."""

    def __init__(self, mesh=None, *, records: bool = False,
                 cross_check: bool = True):
        super().__init__()
        self.mesh = mesh
        self.keep_records = records
        self.records: List[tuple] = []
        self.flops = self.bytes = 0.0
        self.gemm_flops = self.kernel_flops = self.muted_gemm_flops = 0.0
        self.kernels: Counter = Counter()
        self.ops = 0
        self.live = self.peak = self.argument_bytes = 0
        self._live: Dict[int, int] = {}
        self.cross_check = cross_check
        self.registry_flops = 0.0
        self._mesh_from = 0
        self.coll_records: List[dict] = []

    # -- storages ---------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track_one(self, t) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` (the step's arguments) as alive;
        returns their bytes, each storage once."""
        n = sum(self._track_one(t) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor))
        self.argument_bytes += n
        return n

    # -- the walk -----------------------------------------------------------
    def __enter__(self):
        if self.mesh is not None and self.mesh.records is not None:
            self._mesh_from = len(self.mesh.records)
        build.LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        build.LISTENERS.remove(self)
        if self.mesh is not None and self.mesh.records is not None:
            self.coll_records = list(self.mesh.records[self._mesh_from:])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track_one(t)
        if (func.namespace != "aten" or func.is_view
                or func.overloadpacket in FREE_OPS):
            return out
        fl = gemm_flops(func, args)
        if self.cross_check and func.overloadpacket in flop_registry:
            self.registry_flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if build.muted():
            self.muted_gemm_flops += fl
            return out
        seen, moved = set(), 0
        if func.overloadpacket in WRITE_ONLY:
            seen.add(id(args[0]))           # written, not read
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                moved += _nbytes(t)
        moved += sum(_nbytes(t) for t in outs)
        self.ops += 1
        self.flops += fl
        self.gemm_flops += fl
        self.bytes += moved
        if self.keep_records:
            self.records.append((func.overloadpacket.__name__, float(moved),
                                 fl, _where()))
        return out

    def kernel(self, name: str, flops: float, moved: float) -> None:
        """One kernel wrapper's call (``kernels/build.costed``)."""
        self.kernels[name] += 1
        self.flops += flops
        self.kernel_flops += flops
        self.bytes += moved
        if self.keep_records:
            self.records.append((name, moved, flops, _where()))

    # -- results ------------------------------------------------------------
    def collectives(self) -> Dict[str, Dict[str, float]]:
        """kind -> {'bytes': the results' bytes, 'count': collectives}."""
        return collectives_of(self.coll_records)

    def flop_counter(self):
        return float(self.registry_flops) if self.cross_check else None

    def summary(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "gemm_flops": self.gemm_flops,
                "kernel_flops": self.kernel_flops,
                "muted_gemm_flops": self.muted_gemm_flops,
                "flop_counter": self.flop_counter(),
                "collectives": self.collectives(),
                "kernels": dict(self.kernels), "ops": self.ops,
                "peak_live_bytes": self.peak,
                "argument_bytes": self.argument_bytes}


def collectives_of(records) -> Dict[str, Dict[str, float]]:
    """The mesh's records by kind: {'bytes': Σ result bytes, 'count'}; a
    collective over a group of one moves nothing and is left out."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        if r["ranks"] <= 1:
            continue
        slot = out.setdefault(r["kind"], {"bytes": 0.0, "count": 0})
        slot["bytes"] += r["out_bytes"]
        slot["count"] += 1
    return out


def top_contributors(walker: CostWalker, k: int = 12) -> List[Dict]:
    """The top-k (op, where) pairs of a walk kept with ``records=True``,
    by bytes: ``{"bytes", "flops", "op", "where", "count"}``, ``count`` the
    calls folded in (the reference's trip-count multiplier)."""
    agg = defaultdict(lambda: [0.0, 0.0, 0])
    for op, moved, fl, where in walker.records:
        slot = agg[(op, where)]
        slot[0] += moved
        slot[1] += fl
        slot[2] += 1
    rows = [{"bytes": b, "flops": f, "op": op, "where": where, "count": n}
            for (op, where), (b, f, n) in agg.items()]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:k]
