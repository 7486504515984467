"""Codecs and the codec spec grammar (port of ``repro.compression.codecs``).

A codec is ``keys(generator, m, d) -> MessageKey``, ``encode(key, x, hint)
-> msg``, ``decode(key, msg, ref) -> x̂`` and ``message_bits(d)``, the wire
accounting every algorithm's ``bits_up`` / ``bits_down`` come from. Every
call is batched over a leading message axis (:mod:`.lattice`).

  ``lattice``         position-aware lattice quantizer, word-aligned uint
                      codes on the wire (8/16/32 bits per coordinate)
  ``lattice_packed``  the same math, ``8 // bits`` codes per byte: exactly
                      ``bits`` bits per coordinate on the wire
  ``scalar``          FedPAQ/QSGD norm-scaled stochastic rounding (not
                      position-aware: ``ref`` is ignored)
  ``identity``        fp32 pass-through (32 bits per coordinate)

The lattice codecs also ride the rotated-space pipeline through
:meth:`LatticeCodec.wire`. Specs are strings, ``name`` or
``name:key=val,key=val``. The reference's ``topk_ef`` (ROADMAP Queue 1 item
9) and grouped per-client codec (item 6) are not ported yet: their specs
raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.compression.lattice import (IdentityQuantizer, LatticeMsg,
                                             LatticeQuantizer, MessageKey,
                                             QSGDQuantizer)
from repro_torch.compression.pipeline import LatticeWire
from repro_torch.compression.rotation import DEFAULT_BLOCK, pad_len

# registered in the reference, ported in a later slice
_NOT_PORTED = {"topk_ef": "ROADMAP Queue 1 item 9"}

# FedConfig.quantizer legacy names -> codec names
_LEGACY_QUANTIZER = {"lattice": "lattice", "qsgd": "scalar",
                     "none": "identity"}


def _storage_bits(bits: int) -> int:
    """Wire width of one unpacked lattice code: the uint dtype that holds
    2^bits levels."""
    return 8 if bits <= 8 else (16 if bits <= 16 else 32)


@dataclass(frozen=True)
class IdentityCodec:
    """fp32 pass-through; the 'uncompressed' point of the design space."""
    name: str = "identity"
    bits: int = 32

    def keys(self, generator, m: int, d: int) -> MessageKey:
        return MessageKey()

    def encode(self, key, x2, hint=None) -> LatticeMsg:
        return IdentityQuantizer().encode(key, x2, hint)

    def decode(self, key, msg, ref2=None):
        return msg.codes

    def message_bits(self, d: int) -> int:
        return d * 32


@dataclass(frozen=True)
class ScalarCodec:
    """FedPAQ-style norm-scaled stochastic rounding (the paper's Figure-5
    'direct quantization' baseline). Not position-aware: ``ref`` is ignored
    and the error scales with ‖x‖."""
    bits: int = 8
    name: str = "scalar"

    def __post_init__(self):
        object.__setattr__(self, "quant", QSGDQuantizer(bits=self.bits))

    def _container(self):
        # signed storage of levels in [-(2^(b-1)-1), 2^(b-1)-1]
        return torch.int8 if self.bits <= 8 else (
            torch.int16 if self.bits <= 16 else torch.int32)

    def keys(self, generator, m: int, d: int) -> MessageKey:
        return self.quant.keys(generator, m, d)

    def encode(self, key, x2, hint=None) -> LatticeMsg:
        msg = self.quant.encode(key, x2, hint)
        return LatticeMsg(codes=msg.codes.to(self._container()),
                          gamma=msg.gamma)

    def decode(self, key, msg, ref2=None):
        return self.quant.decode(key, msg, ref2)

    def message_bits(self, d: int) -> int:
        return self.quant.message_bits(d)


@dataclass(frozen=True)
class LatticeCodec:
    """Position-aware lattice quantizer as a codec; ``packed`` selects the
    sub-byte wire (bits in {1, 2, 4, 8}), packed inside the encode kernel
    and unpacked inside the decode kernel."""
    bits: int = 8
    block: int = DEFAULT_BLOCK
    safety: float = 8.0
    backend: str = "cuda"
    packed: bool = False
    name: str = "lattice"
    family: str = "lattice"

    def __post_init__(self):
        if self.packed and self.bits not in (1, 2, 4, 8):
            raise ValueError(
                f"lattice_packed needs bits in {{1, 2, 4, 8}} (whole codes "
                f"per byte); got bits={self.bits}")
        object.__setattr__(self, "quant", LatticeQuantizer(
            bits=self.bits, block=self.block, safety=self.safety,
            backend=self.backend))

    @property
    def pack(self) -> int:
        return (8 // self.bits) if self.packed else 1

    def wire(self) -> LatticeWire:
        """The pipeline's wire descriptor of this codec."""
        return LatticeWire(bits=self.bits, pack=self.pack)

    def keys(self, generator, m: int, d: int) -> MessageKey:
        return self.quant.keys(generator, m, d)

    def encode(self, key, x2, hint) -> LatticeMsg:
        return self.quant.encode(key, x2, hint, pack=self.pack)

    def decode(self, key, msg, ref2):
        return self.quant.decode(key, msg, ref2, pack=self.pack)

    def message_bits(self, d: int) -> int:
        per = self.bits if self.packed else _storage_bits(self.bits)
        return pad_len(d, self.block) * per + 32  # + γ scalar


def _reject_extra(kw: Dict[str, Any], name: str):
    if kw:
        raise ValueError(f"unknown codec parameter(s) {sorted(kw)} for "
                         f"{name!r}")


def _build_lattice(*, bits, backend, block, safety, packed=False, **kw):
    _reject_extra(kw, "lattice_packed" if packed else "lattice")
    return LatticeCodec(bits=bits, block=block, safety=safety,
                        backend=backend, packed=packed,
                        name="lattice_packed" if packed else "lattice")


def _build_lattice_packed(**kw):
    return _build_lattice(packed=True, **kw)


def _build_scalar(*, bits, backend, block, safety, **kw):
    _reject_extra(kw, "scalar")
    return ScalarCodec(bits=bits)


def _build_identity(*, bits, backend, block, safety, **kw):
    _reject_extra(kw, "identity")
    return IdentityCodec()


_CODECS: Dict[str, Any] = {
    "lattice": _build_lattice,
    "lattice_packed": _build_lattice_packed,
    "scalar": _build_scalar,
    "identity": _build_identity,
}
_CODEC_TYPES = (LatticeCodec, ScalarCodec, IdentityCodec)


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


def make_codec(spec, *, bits: int = 8, backend: str = "cuda",
               block: int = DEFAULT_BLOCK, safety: float = 8.0):
    """Build a codec from a spec string (or pass a codec through); a
    ``bits=`` in the spec overrides the config value."""
    if isinstance(spec, _CODEC_TYPES):
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
    return _CODECS[name](bits=bits, backend=backend, block=block,
                         safety=safety, **params)


def resolve_codec(spec, fed, *, direction: str, default: str = None):
    """An algorithm's per-direction codec. Precedence: explicit ``spec`` >
    ``fed.codec_up`` / ``fed.codec_down`` > ``default`` > the legacy
    ``fed.quantizer`` map (lattice | qsgd→scalar | none→identity). The
    lattice codecs run on ``fed.kernel_backend``."""
    if isinstance(spec, dict):
        raise NotImplementedError("per-client group codecs are not ported "
                                  "yet (ROADMAP Queue 1 item 6)")
    if spec is None:
        spec = getattr(fed, f"codec_{direction}", "") or None
    if spec is None:
        spec = default or _LEGACY_QUANTIZER.get(fed.quantizer)
        if spec is None:
            raise ValueError(f"no codec mapping for quantizer "
                             f"{fed.quantizer!r}")
    return make_codec(spec, bits=fed.bits, backend=fed.kernel_backend)


def is_lattice_family(codec) -> bool:
    """True when the rotated-space pipeline can carry this codec."""
    return getattr(codec, "family", "") == "lattice"
