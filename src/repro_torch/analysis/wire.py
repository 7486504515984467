"""Wire truth: a round's marked messages against the codecs' declared wire
formats (port of ``repro.analysis.wire``).

The reproduction's claim is its ``bits_up`` / ``bits_down`` accounting.
Every codec states its wire as data (``WireDecl``, ``compression/
codecs.py``) and every message site carries a ``wire_mark``
(``analysis/provenance.py``); the op log of a round
(``analysis/jaxpr.RoundTrace``) holds the marks it made and the mesh's
collectives, each with whether its operand derives from a marked value.
:func:`check_wire_truth` then

* checks each declaration against the codec: its parts sum to
  ``message_bits(d)``, and no payload charges under 16 bits a coordinate
  while declaring a 32-bit container;
* resolves every mark against its declaration: the part exists (an
  undeclared side row is uncharged traffic), its container has the
  declared width and kind (an fp32 value marked as 4-bit-charged codes is
  fp32 reaching the wire), and it carries the declared elements a message,
  rebuilt at the mark's own ``d`` for the per-leaf messages of a mesh;
* with a transport's ``WireBudget``, holds each collective class's bytes
  under its cap (``analysis/opbudget.check_collective_bytes`` over the
  mesh's records), and requires every gathered payload, and every float
  reduction on a transport that declares none, to derive from a marked
  value.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.violation import Violation

_GATHER_OPS = {"all_gather"}
_REDUCE_OPS = {"psum", "reduce_scatter"}

# operands at or below this footprint are scalar side traffic (hints,
# counters), never a model payload
_SCALAR_BYTES = 256


def collect_wire_facts(trace) -> Tuple[list, list]:
    """(marks, collectives) of a round's op log: the
    :class:`~repro_torch.analysis.provenance.WireMark` records and the
    ``(record, marked)`` pairs of the mesh's collectives."""
    return list(trace.marks), list(trace.collectives)


def _part(decl, name: str):
    for p in decl.parts:
        if p.part == name:
            return p
    return None


def _resolve_decl(mark, decl_up, decl_down, by_name: Dict):
    if mark.channel == "up":
        return decl_up
    if mark.channel == "down":
        return decl_down
    return by_name.get(mark.codec)


def _part_at_mark_dim(codec, part, mark):
    """The declared part rebuilt at the mark's own encode dimension (a mesh
    exchange encodes per leaf); the caller's declaration where the
    container would drift."""
    if not mark.d or codec is None \
            or not hasattr(codec, "wire_declaration"):
        return part
    try:
        rp = _part(codec.wire_declaration(mark.d), part.part)
    except (TypeError, ValueError):
        return part
    if rp is None or rp.container_bits != part.container_bits:
        return part
    return rp


def _leaf_elems_ok(codec, part, got_elems: int) -> bool:
    """A mesh leaf's codes count: accepted iff the codec's own declaration
    at that granularity gives exactly this count in the same container."""
    if codec is None or part.part != "codes":
        return False
    pack = max(int(getattr(codec, "pack", 1) or 1), 1)
    try:
        rp = _part(codec.wire_declaration(got_elems * pack), "codes")
    except (AttributeError, TypeError, ValueError):
        return False
    return (rp is not None and rp.elems == got_elems
            and rp.container_bits == part.container_bits)


def _check_declarations(where, pairs, d) -> List[Violation]:
    out = []
    for decl, codec in pairs:
        if decl is None:
            continue
        if codec is not None and d is not None:
            declared, charged = decl.message_bits, codec.message_bits(d)
            if declared != charged:
                out.append(Violation(
                    "wire_truth", where,
                    f"declaration drift for {decl.codec!r}: wire parts sum "
                    f"to {declared} bits but message_bits({d}) charges "
                    f"{charged}"))
        for p in decl.parts:
            if p.payload and p.elems and p.container_bits >= 32 \
                    and p.charged_bits / p.elems < 16:
                out.append(Violation(
                    "wire_truth", where,
                    f"{decl.codec!r} part {p.part!r} declares a "
                    f"{p.container_bits}-bit container but charges only "
                    f"{p.charged_bits / p.elems:.1f} bits/coord"))
    return out


def _check_mark(mark, decl, codec, where) -> List[Violation]:
    label = f"{mark.channel}/{mark.part} ({mark.codec}) at {mark.where}"
    if decl is None:
        return [Violation("wire_truth", where,
                          f"wire mark {label} matches no declaration — "
                          f"uncharged message traffic")]
    part = _part(decl, mark.part)
    if part is None:
        return [Violation("wire_truth", where,
                          f"{decl.codec!r} ships an undeclared part "
                          f"{mark.part!r} at {mark.where} — uncharged "
                          f"side-channel row")]
    out = []
    if mark.container_bits != part.container_bits:
        out.append(Violation(
            "wire_truth", where,
            f"{decl.codec!r} part {part.part!r} ships a "
            f"{mark.container_bits}-bit container at {mark.where}; the "
            f"declaration says {part.container_bits} (message charges "
            f"{part.charged_bits} bits)"))
    kind = "float" if mark.dtype.is_floating_point else "int"
    if kind != part.kind:
        tail = " — fp32 reaching the wire" if kind == "float" else ""
        out.append(Violation(
            "wire_truth", where,
            f"{decl.codec!r} part {part.part!r} ships {kind} "
            f"({str(mark.dtype).replace('torch.', '')}) at {mark.where}; "
            f"the declaration says {part.kind}{tail}"))
    expect = _part_at_mark_dim(codec, part, mark)
    if expect.elems and mark.elems != expect.elems \
            and not _leaf_elems_ok(codec, part, mark.elems):
        out.append(Violation(
            "wire_truth", where,
            f"{decl.codec!r} part {part.part!r} ships {mark.elems} "
            f"elements/message at {mark.where}; the declaration says "
            f"{expect.elems}"))
    return out


def _check_collectives(colls, where, budget) -> List[Violation]:
    from repro_torch.analysis.opbudget import check_collective_bytes
    out = check_collective_bytes([r for r, _ in colls], where, budget.caps)
    for r, marked in colls:
        if r["in_bytes"] <= _SCALAR_BYTES or marked:
            continue
        if r["op"] in _GATHER_OPS:
            out.append(Violation(
                "wire_truth", where,
                f"{r['op']} over {r['axis']!r} gathers a {r['in_bytes']}-"
                f"byte {r['dtype']} payload with no wire mark — undeclared "
                f"wire traffic"))
        elif (r["op"] in _REDUCE_OPS and r["float"]
              and not budget.float_reduce_ok):
            out.append(Violation(
                "wire_truth", where,
                f"{r['op']} over {r['axis']!r} reduces a {r['in_bytes']}-"
                f"byte {r['dtype']} payload on a transport that declares no "
                f"float reduction — wire leak"))
    return out


def check_wire_truth(trace, *, where: str, decl_up=None, decl_down=None,
                     codec_up=None, codec_down=None, d: Optional[int] = None,
                     budget=None) -> List[Violation]:
    """Audit one round's op log against its wire declarations.

    ``decl_up`` / ``decl_down`` are the per-direction ``WireDecl``s (built
    by the caller at the model dimension ``d``); ``codec_up`` /
    ``codec_down`` also arm the declaration checks; ``budget`` (a
    transport's ``WireBudget``) arms the collective checks."""
    out = _check_declarations(where, ((decl_up, codec_up),
                                      (decl_down, codec_down)), d)
    by_name: Dict = {}
    for decl in (decl_up, decl_down):
        if decl is not None:
            by_name.setdefault(decl.codec, decl)
    codec_of = {"up": codec_up, "down": codec_down}
    marks, colls = collect_wire_facts(trace)
    for mark in marks:
        decl = _resolve_decl(mark, decl_up, decl_down, by_name)
        codec = codec_of.get(mark.channel)
        if codec is None and decl is not None:
            codec = next((c for c in (codec_up, codec_down)
                          if c is not None
                          and getattr(c, "name", "") == decl.codec), None)
        out.extend(_check_mark(mark, decl, codec, where))
    if budget is not None:
        out.extend(_check_collectives(colls, where, budget))
    return out
