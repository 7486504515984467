"""The op log of a round and its invariant checks (port of
``repro.analysis.jaxpr``).

The reference walks the closed jaxpr of a traced round. The port runs
eagerly, so it logs the round instead: :class:`RoundTrace` is a
``TorchDispatchMode`` over one call of ``device_round`` (``fed/engine.py``'s
``traced_round`` / ``traced_chunk``) that records every aten op the round
dispatches, with its output dtypes, whether it reads a value back to the
host, and, for a random op, whether it was given a generator. It is also a
wire recorder (``analysis/provenance.py``): it keeps the round's wire marks
and the mesh's collectives, and follows which storages derive from a
marked value (a may-taint over the ops it sees, the reference's
``WireTaintDomain`` on the real op stream).

The checks, each returning a list of
:class:`~repro_torch.analysis.violation.Violation` (empty = clean):

* :func:`check_host_syncs` (the reference's ``check_host_callbacks``): no
  op inside the round reads a value back to the host: ``.item()``,
  ``float()``, ``int()``, ``bool()`` of a tensor (``_local_scalar_dense``),
  a copy from the card to the CPU, or an op whose output shape depends on
  the data (``nonzero``, ``masked_select``, ``unique``, a boolean index,
  ...). Each breaks a chunk's CUDA-graph capture as a host callback breaks
  the reference's scan.
* :func:`check_wide_dtypes`: no float64 or complex128 output of more
  than one element. The port keeps a state's 0-d counters (the cumulative
  bits, exact as integers, and the simulated time; ``fed/api.counters0``)
  in fp64 on purpose where the reference adds host floats; a 0-d counter
  doubles no buffer. Any wider 64-bit value is a promotion.
* :func:`check_key_discipline`, in the port's terms: every random op takes
  an explicit generator. A draw from the global default generator is one
  that the engine's replay does not advance (the reference's keys are
  explicit by construction, and its rule is that one key feeds one
  derivation).

:func:`op_counts`, :func:`op_report` and :func:`analyze_round` (alias
``analyze_jaxpr``) give the op report the reference's ``op_report`` gives.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import provenance
from repro_torch.analysis.violation import Violation

# ops that read a value back to the host, or whose output shape depends on
# the data (the card must finish before the host can size the output)
SYNC_OPS = {
    "_local_scalar_dense": "a host read of a tensor value (.item(), "
                           "float(), int(), bool())",
    "item": "a host read of a tensor value (.item())",
    "equal": "a host read (torch.equal returns a Python bool)",
    "is_nonzero": "a host read (bool of a tensor)",
    "nonzero": "a data-dependent output shape (nonzero)",
    "argwhere": "a data-dependent output shape (argwhere)",
    "masked_select": "a data-dependent output shape (masked_select)",
    "unique": "a data-dependent output shape (unique)",
    "_unique": "a data-dependent output shape (unique)",
    "_unique2": "a data-dependent output shape (unique)",
    "unique_dim": "a data-dependent output shape (unique)",
    "unique_consecutive": "a data-dependent output shape "
                          "(unique_consecutive)",
    "bincount": "a data-dependent output shape (bincount)",
    "histc": "a host read of the range (histc)",
}
# ops with a boolean mask among their indices run a nonzero inside
_MASK_INDEXED = frozenset({"index", "index_put", "index_put_",
                           "_index_put_impl_"})

# the random ops of ATen; an overload without a generator argument, or
# given None, draws from the global default generator
RANDOM_OPS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "bernoulli_", "uniform", "uniform_", "normal",
    "normal_", "exponential", "exponential_", "poisson", "multinomial",
    "random", "random_", "cauchy", "cauchy_", "log_normal", "log_normal_",
    "geometric", "geometric_", "native_dropout", "_standard_gamma",
    "_sample_dirichlet", "binomial", "rrelu_with_noise", "_fused_dropout",
})

WIDE_DTYPES = (torch.float64, torch.complex128)


class OpRecord(NamedTuple):
    """One dispatched op: its name (the overload packet's), its outputs'
    dtypes and element counts, the host sync it makes (None: none),
    whether it drew from an explicit generator (None: not a random op),
    and the port line that called it."""
    name: str
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    sync: Optional[str]
    generator: Optional[bool]
    where: str


def _generator_given(func, args, kwargs) -> Optional[bool]:
    if func.overloadpacket.__name__ not in RANDOM_OPS:
        return None
    for i, arg in enumerate(func._schema.arguments):
        if arg.name == "generator":
            val = kwargs.get("generator",
                             args[i] if i < len(args) and not arg.kwarg_only
                             else None)
            return val is not None
    return False


def _sync_of(name: str, func, args, kwargs, outs) -> Optional[str]:
    if name in SYNC_OPS:
        return SYNC_OPS[name]
    if name == "repeat_interleave" and kwargs.get("output_size") is None \
            and isinstance(args[0], torch.Tensor) \
            and func._overloadname.startswith("Tensor"):
        return "a data-dependent output shape (repeat_interleave without " \
               "output_size)"
    if name in _MASK_INDEXED and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else ()
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in idx):
            return "a data-dependent output shape (a boolean-mask index)"
    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    if any(t.device.type == "cpu" for t in outs) and any(
            t.device.type not in ("cpu", "meta") for t in ins):
        return "a copy from the card to the host"
    return None


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class RoundTrace(TorchDispatchMode):
    """``with RoundTrace() as tr: alg.device_round(...)``, then ``tr.ops``,
    ``tr.marks`` and ``tr.collectives`` (``(record, marked)``: a mesh
    record and whether its operand derives from a marked value)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.marks: List[provenance.WireMark] = []
        self.collectives: List[Tuple[dict, bool]] = []
        self._tainted: set = set()

    # -- the wire recorder's side -----------------------------------------
    def __enter__(self):
        provenance.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        provenance.RECORDERS.remove(self)
        return out

    def _taint(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key is None or key in self._tainted:
            return
        self._tainted.add(key)
        weakref.finalize(t.untyped_storage(), self._tainted.discard, key)

    def tainted(self, t: torch.Tensor) -> bool:
        return _storage_key(t) in self._tainted

    def mark(self, x, record) -> None:
        self.marks.append(record)
        if isinstance(x, torch.Tensor):
            self._taint(x)

    def collective(self, record: dict, x) -> None:
        self.collectives.append((record, self.tainted(x)))

    def kernel(self, name: str, inputs, outputs) -> None:
        """A kernel wrapper's call: logged as one op, its outputs derive
        from its inputs."""
        self.ops.append(OpRecord(name, tuple(t.dtype for t in outputs),
                                 tuple(t.numel() for t in outputs), None,
                                 None, provenance._where()))
        self._flow(inputs, outputs)

    def _flow(self, inputs, outputs) -> None:
        if self._tainted and any(self.tainted(t) for t in inputs):
            for t in outputs:
                self._taint(t)

    # -- the op log ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        self.ops.append(OpRecord(
            name, tuple(t.dtype for t in outs),
            tuple(t.numel() for t in outs),
            _sync_of(name, func, args, kwargs, outs),
            _generator_given(func, args, kwargs),
            provenance._where()))
        self._flow([t for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)], outs)
        return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def check_host_syncs(trace: RoundTrace, where: str) -> List[Violation]:
    """No op of the round reads a value back to the host."""
    return [Violation("host-sync", where,
                      f"{op.name!r} at {op.where}: {op.sync} inside the "
                      f"round body breaks the chunk's capture")
            for op in trace.ops if op.sync is not None]


check_host_callbacks = check_host_syncs


def check_wide_dtypes(trace: RoundTrace, where: str) -> List[Violation]:
    """No float64 / complex128 value of more than one element in the
    round: the wire accounting and the kernels assume fp32 (the 0-d fp64
    counters are the port's by design); one report a dtype."""
    out, seen = [], set()
    for op in trace.ops:
        for dt, n in zip(op.dtypes, op.sizes):
            if dt in WIDE_DTYPES and n > 1 and dt not in seen:
                seen.add(dt)
                out.append(Violation(
                    "wide-dtype", where,
                    f"{str(dt).replace('torch.', '')} value produced by "
                    f"{op.name!r} at {op.where}: a 64-bit value in the "
                    f"round"))
    return out


def check_key_discipline(trace: RoundTrace, where: str) -> List[Violation]:
    """Every random op of the round draws from an explicit generator."""
    return [Violation("key-discipline", where,
                      f"random op {op.name!r} at {op.where} draws from the "
                      f"global default generator: a chunk's replay would "
                      f"not advance it")
            for op in trace.ops if op.generator is False]


# ---------------------------------------------------------------------------
# the op report (read by the op-budget audit)
# ---------------------------------------------------------------------------

# ops whose counts the report tracks by name: conversions and copies
TRACKED_OPS = ("_to_copy", "copy_", "clone")


def op_counts(trace: RoundTrace) -> Counter:
    """Counter of every op the round dispatched."""
    return Counter(op.name for op in trace.ops)


def op_report(trace: RoundTrace) -> Dict[str, int]:
    """The tracked subset of :func:`op_counts`, the collective bytes of the
    mesh's records (``analysis/opbudget.collective_bytes``) and the total
    op count."""
    from repro_torch.analysis.opbudget import collective_bytes
    c = op_counts(trace)
    rep = {k: c[k] for k in TRACKED_OPS if c[k]}
    rep.update(collective_bytes([r for r, _ in trace.collectives]))
    rep["ops_total"] = sum(c.values())
    return rep


def analyze_round(trace: RoundTrace, where: str
                  ) -> Tuple[List[Violation], Dict[str, int]]:
    """Every op-log check on one round (or chunk) and its op report."""
    viols = (check_host_syncs(trace, where)
             + check_wide_dtypes(trace, where)
             + check_key_discipline(trace, where))
    return viols, op_report(trace)


analyze_jaxpr = analyze_round
