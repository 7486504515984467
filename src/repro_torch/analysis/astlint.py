"""AST rules over ``src/repro_torch/`` (port of ``repro.analysis.astlint``).

The op log sees what a round ran; these rules read what the source says:

  ``R001 host-call-in-round``  inside a ``device_round`` (and any function
      defined inside one): no ``np.random``, no ``time.*``, no
      ``datetime.now()`` / ``utcnow()``, no ``.item()``, ``.tolist()`` or
      ``.cpu()``, no ``print``. A host draw or clock is frozen into a
      captured chunk, and a host read syncs the card inside the capture.
      ``scan_rounds`` is not a round body: the adaptive walk reads
      ``quant_err`` on the host once a chunk, outside the capture.
  ``R002 unresolved-spec``  codec and participation spec strings
      (``uplink=...``, ``codec_up=...``, ``participation=...``, and the
      values of a ``{"fast": ..., "slow": ...}`` group map) resolve in the
      port's registries.
  ``R003 metrics-schema``  a ``metrics = {...}`` literal in ``round`` or
      ``device_round`` covers ``fed/api.METRIC_KEYS``.
  ``R004 unused-import``  no unused imports outside ``__init__.py``
      (``# noqa`` opts a line out).

:func:`lint_path` walks a tree; :func:`lint_source` checks one buffer.
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.violation import Violation

# R001 ----------------------------------------------------------------------

ROUND_BODIES = {"device_round"}
_HOST_CLOCKS = {("datetime", "now"), ("datetime", "utcnow")}
_HOST_RNG_ROOTS = {("np", "random"), ("numpy", "random")}
_HOST_READS = {"item", "tolist", "cpu"}


def _attr_chain(node) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        return []
    return parts[::-1]


def _host_call(node: ast.Call) -> Optional[str]:
    """What a call inside a round body does on the host, or None."""
    func = node.func
    if isinstance(func, ast.Name) and func.id == "print":
        return "print() inside a round body: a host call, frozen by capture"
    if not isinstance(func, ast.Attribute):
        return None
    chain = _attr_chain(func)
    if len(chain) >= 2 and chain[0] == "time":
        return (f"host clock `{'.'.join(chain)}()` inside a round body: "
                f"its value is frozen into a captured chunk")
    if len(chain) >= 2 and tuple(chain[-2:]) in _HOST_CLOCKS:
        return (f"host clock `{'.'.join(chain)}()` inside a round body: "
                f"its value is frozen into a captured chunk")
    if func.attr in _HOST_READS:
        return (f"host read `.{func.attr}()` inside a round body: it syncs "
                f"the card and breaks the chunk's capture")
    return None


def _check_round_bodies(tree: ast.AST, path: str) -> List[Violation]:
    out: List[Violation] = []

    def visit(node: ast.AST, inside: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside = inside or node.name in ROUND_BODIES
        elif inside:
            chain = (_attr_chain(node) if isinstance(node, ast.Attribute)
                     else [])
            if len(chain) >= 2 and tuple(chain[:2]) in _HOST_RNG_ROOTS:
                out.append(Violation(
                    "R001:host-call-in-round", f"{path}:{node.lineno}",
                    f"host RNG `{'.'.join(chain)}` inside a round body: "
                    f"draw from the round's generator"))
                return
            if isinstance(node, ast.Call):
                why = _host_call(node)
                if why is not None:
                    out.append(Violation("R001:host-call-in-round",
                                         f"{path}:{node.lineno}", why))
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(tree, False)
    return out


# R002 ----------------------------------------------------------------------

_CODEC_KWARGS = {"uplink", "downlink", "codec_up", "codec_down"}
_PART_KWARGS = {"participation"}


def _spec_name(spec: str) -> str:
    return spec.split(":", 1)[0].strip()


def _registry_names():
    from repro_torch.compression.codecs import registered_codecs
    from repro_torch.fed.population import registered_participations
    return set(registered_codecs()), set(registered_participations())


def _spec_strings(value: ast.AST):
    """Spec string literals in a value: a str constant, or the values of a
    per-client-group dict literal."""
    if isinstance(value, ast.Constant) and isinstance(value.value, str):
        yield value.value, value.lineno
    elif isinstance(value, ast.Dict):
        for v in value.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                yield v.value, v.lineno


def _check_spec_strings(tree: ast.AST, path: str) -> List[Violation]:
    codecs, parts = _registry_names()
    out: List[Violation] = []

    def judge(kwarg: str, spec: str, lineno: int) -> None:
        if not spec:
            return   # "" = the algorithm's default
        names = parts if kwarg in _PART_KWARGS else codecs
        if _spec_name(spec) not in names:
            kind = "participation" if kwarg in _PART_KWARGS else "codec"
            out.append(Violation(
                "R002:unresolved-spec", f"{path}:{lineno}",
                f"{kind} spec {spec!r} (kwarg {kwarg}=) does not resolve: "
                f"{_spec_name(spec)!r} not in {sorted(names)}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in _CODEC_KWARGS | _PART_KWARGS:
                    for spec, ln in _spec_strings(kw.value):
                        judge(kw.arg, spec, ln)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt = node.target
            if (isinstance(tgt, ast.Name)
                    and tgt.id in _CODEC_KWARGS | _PART_KWARGS):
                for spec, ln in _spec_strings(node.value):
                    judge(tgt.id, spec, ln)
    return out


# R003 ----------------------------------------------------------------------

def _check_metrics_schema(tree: ast.AST, path: str) -> List[Violation]:
    from repro_torch.fed.api import METRIC_KEYS
    out: List[Violation] = []
    # only the dict a round returns is schema-bound
    for fn in ast.walk(tree):
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name in ("round", "device_round")):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Dict)
                    and any(isinstance(t, ast.Name) and t.id == "metrics"
                            for t in node.targets)):
                continue
            keys = node.value.keys
            if any(k is None for k in keys):
                continue   # {**base, ...} extends a complete dict
            lit = {k.value for k in keys if isinstance(k, ast.Constant)}
            missing = [k for k in METRIC_KEYS if k not in lit]
            if missing:
                out.append(Violation(
                    "R003:metrics-schema", f"{path}:{node.lineno}",
                    f"metrics dict literal missing schema keys {missing} "
                    f"(METRIC_KEYS): normalize_metrics would default them"))
    return out


# R004 ----------------------------------------------------------------------

def _noqa_lines(source: str) -> Set[int]:
    return {i + 1 for i, line in enumerate(source.splitlines())
            if "# noqa" in line}


def _check_unused_imports(tree: ast.AST, source: str, path: str
                          ) -> List[Violation]:
    noqa = _noqa_lines(source)
    imported = []   # (local name, shown name, lineno)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imported.append(((a.asname or a.name).split(".")[0], a.name,
                                 node.lineno))
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            imported += [(a.asname or a.name, a.name, node.lineno)
                         for a in node.names if a.name != "*"]
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            if chain:
                used.add(chain[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)   # __all__ = ["name"] re-exports
    return [Violation("R004:unused-import", f"{path}:{lineno}",
                      f"`{shown}` imported but unused")
            for local, shown, lineno in imported
            if local not in used and lineno not in noqa]


# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<buffer>",
                rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """The rules on one source buffer. ``rules`` filters by rule id prefix
    (e.g. ``["R001"]``); by default every rule, R004 not on
    ``__init__.py``."""
    tree = ast.parse(source, filename=path)
    if rules is None:
        rules = ["R001", "R002", "R003"]
        if not path.replace(os.sep, "/").endswith("__init__.py"):
            rules.append("R004")
    out: List[Violation] = []
    if "R001" in rules:
        out += _check_round_bodies(tree, path)
    if "R002" in rules:
        out += _check_spec_strings(tree, path)
    if "R003" in rules:
        out += _check_metrics_schema(tree, path)
    if "R004" in rules:
        out += _check_unused_imports(tree, source, path)
    return out


def lint_path(root: str) -> List[Violation]:
    """Every ``*.py`` under ``root`` with the default rules."""
    out: List[Violation] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                src = f.read()
            try:
                out += lint_source(src, path)
            except SyntaxError as e:
                out.append(Violation("R000:syntax", f"{path}:{e.lineno}",
                                     str(e.msg)))
    return out
