"""Lattice codecs and the codec spec grammar (port of the lattice part of
``repro.compression.codecs``).

``lattice`` ships word-aligned uint codes (8/16/32 bits per coordinate);
``lattice_packed`` packs ``8 // bits`` codes per byte, exactly ``bits`` bits
per coordinate on the wire. Both ride the rotated-space pipeline through
:meth:`LatticeCodec.wire`, and every algorithm's ``bits_up`` / ``bits_down``
come from :meth:`LatticeCodec.message_bits`.

Specs are strings, ``name`` or ``name:key=val,key=val``. The other codecs
of the reference (``scalar``, ``topk_ef``, ``identity``: ROADMAP Queue 1
item 9) and the grouped per-client codec (item 6) are not ported yet: their
specs raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

from repro_torch.compression.pipeline import LatticeWire
from repro_torch.compression.rotation import DEFAULT_BLOCK, pad_len

# registered in the reference, ported in a later slice
_NOT_PORTED = {
    "scalar": "ROADMAP Queue 1 item 9",
    "topk_ef": "ROADMAP Queue 1 item 9",
    "identity": "ROADMAP Queue 1 item 9",
}

# FedConfig.quantizer legacy names -> codec names
_LEGACY_QUANTIZER = {"lattice": "lattice", "qsgd": "scalar",
                     "none": "identity"}


def _storage_bits(bits: int) -> int:
    """Wire width of one unpacked lattice code: the uint dtype that holds
    2^bits levels."""
    return 8 if bits <= 8 else (16 if bits <= 16 else 32)


@dataclass(frozen=True)
class LatticeCodec:
    """Position-aware lattice quantizer as a codec; ``packed`` selects the
    sub-byte wire (bits in {1, 2, 4, 8})."""
    bits: int = 8
    block: int = DEFAULT_BLOCK
    safety: float = 8.0
    packed: bool = False
    name: str = "lattice"
    family: str = "lattice"

    def __post_init__(self):
        if self.packed and self.bits not in (1, 2, 4, 8):
            raise ValueError(
                f"lattice_packed needs bits in {{1, 2, 4, 8}} (whole codes "
                f"per byte); got bits={self.bits}")

    @property
    def pack(self) -> int:
        return (8 // self.bits) if self.packed else 1

    def wire(self) -> LatticeWire:
        """The pipeline's wire descriptor of this codec."""
        return LatticeWire(bits=self.bits, pack=self.pack)

    def message_bits(self, d: int) -> int:
        per = self.bits if self.packed else _storage_bits(self.bits)
        return pad_len(d, self.block) * per + 32  # + γ scalar


def _build_lattice(*, bits, block, safety, packed=False, **kw):
    if kw:
        raise ValueError(f"unknown codec parameter(s) {sorted(kw)} for "
                         f"{'lattice_packed' if packed else 'lattice'!r}")
    return LatticeCodec(bits=bits, block=block, safety=safety, packed=packed,
                        name="lattice_packed" if packed else "lattice")


def _build_lattice_packed(**kw):
    return _build_lattice(packed=True, **kw)


_CODECS: Dict[str, Any] = {
    "lattice": _build_lattice,
    "lattice_packed": _build_lattice_packed,
}


def _parse_spec(spec: str) -> Tuple[str, Dict[str, Any]]:
    """'name' or 'name:k=v,k=v' -> (name, {k: parsed_v})."""
    name, _, tail = spec.partition(":")
    params: Dict[str, Any] = {}
    if tail:
        for item in tail.split(","):
            k, eq, v = item.partition("=")
            if not eq or not k:
                raise ValueError(f"malformed codec spec {spec!r} "
                                 f"(want name:key=val,key=val)")
            try:
                params[k.strip()] = int(v)
            except ValueError:
                params[k.strip()] = float(v)
    return name.strip(), params


def make_codec(spec, *, bits: int = 8, block: int = DEFAULT_BLOCK,
               safety: float = 8.0) -> LatticeCodec:
    """Build a codec from a spec string (or pass a codec through); a
    ``bits=`` in the spec overrides the config value."""
    if isinstance(spec, LatticeCodec):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"codec spec must be a name string or codec "
                        f"instance; got {type(spec).__name__}")
    name, params = _parse_spec(spec)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"codec {name!r} is not ported yet "
                                  f"({_NOT_PORTED[name]})")
    if name not in _CODECS:
        raise ValueError(f"unknown codec {name!r}; choose from "
                         f"{sorted(_CODECS)}")
    bits = int(params.pop("bits", bits))
    safety = float(params.pop("safety", safety))
    block = int(params.pop("block", block))
    return _CODECS[name](bits=bits, block=block, safety=safety, **params)


def resolve_codec(spec, fed, *, direction: str) -> LatticeCodec:
    """An algorithm's per-direction codec. Precedence: explicit ``spec`` >
    ``fed.codec_up`` / ``fed.codec_down`` > the legacy ``fed.quantizer``
    map."""
    if isinstance(spec, dict):
        raise NotImplementedError("per-client group codecs are not ported "
                                  "yet (ROADMAP Queue 1 item 6)")
    if spec is None:
        spec = getattr(fed, f"codec_{direction}", "") or None
    if spec is None:
        spec = _LEGACY_QUANTIZER.get(fed.quantizer)
        if spec is None:
            raise ValueError(f"no codec mapping for quantizer "
                             f"{fed.quantizer!r}")
    return make_codec(spec, bits=fed.bits)


def is_lattice_family(codec) -> bool:
    """True when the rotated-space pipeline can carry this codec."""
    return getattr(codec, "family", "") == "lattice"
