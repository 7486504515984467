"""The ``name:key=val,key=val`` spec grammar shared by the codec and
participation registries."""
from __future__ import annotations

from typing import Any, Dict, Tuple


def parse_spec(spec: str, kind: str) -> Tuple[str, Dict[str, Any]]:
    """'name' or 'name:k=v,k=v' -> (name, {k: int or float v}); ``kind``
    names the registry in the error of a malformed spec."""
    name, _, tail = spec.partition(":")
    params: Dict[str, Any] = {}
    if tail:
        for item in tail.split(","):
            k, eq, v = item.partition("=")
            if not eq or not k:
                raise ValueError(f"malformed {kind} spec {spec!r} "
                                 f"(want name:key=val,key=val)")
            try:
                params[k.strip()] = int(v)
            except ValueError:
                params[k.strip()] = float(v)
    return name.strip(), params
