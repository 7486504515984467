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
``name:key=val,key=val``, codec instances, or (uplink only) a ``{"fast":
spec, "slow": spec}`` group map that :func:`resolve_codec` turns into a
:class:`GroupedLatticeCodec` with per-client bit budgets over the
clock's speed classes. Third-party codecs join through
:func:`register_codec`. The reference's ``topk_ef`` (ROADMAP Queue 1 item
9) is registered and raises until it is ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.compression.lattice import (IdentityQuantizer, LatticeMsg,
                                             LatticeQuantizer, MessageKey,
                                             QSGDQuantizer)
from repro_torch.compression.pipeline import LatticeWire
from repro_torch.compression.rotation import DEFAULT_BLOCK, pad_len
from repro_torch.utils.specs import parse_spec

# FedConfig.quantizer legacy names -> codec names
_LEGACY_QUANTIZER = {"lattice": "lattice", "qsgd": "scalar",
                     "none": "identity"}


@runtime_checkable
class Codec(Protocol):
    """Structural type of a registered compression codec."""

    def encode(self, key, x2, hint) -> Any:
        ...

    def decode(self, key, msg, ref2) -> Any:
        ...

    def message_bits(self, d: int) -> int:
        ...


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

    def wire(self, idx=None) -> LatticeWire:
        """The pipeline's wire descriptor of this codec (``idx``, the
        sampled clients, matters for grouped codecs only)."""
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


@dataclass(frozen=True)
class GroupedLatticeCodec:
    """Heterogeneous per-client bit budgets over the lattice exchange.

    ``bits_per_client`` gives each client its own bit-width; the
    rotated-space pipeline runs ONE batched exchange with per-message wrap
    moduli (``LatticeWire.levels``), so a round mixes b=8 fast clients with
    b=4 stragglers at no extra rotation pass. Uplink only (the downlink
    broadcast is one message).

    The codes ride the pipeline unpacked (int32, pack 1) at each message's
    own modulus 2^b_i, while each client is charged its group member's
    declared wire: ``wire_width_per_client[i]`` bits a coordinate (a
    ``lattice`` member its word-aligned storage, a ``lattice_packed`` member
    exactly its sub-byte width), plus γ and the message's levels entry.
    """
    bits_per_client: Tuple[int, ...]
    wire_width_per_client: Tuple[int, ...]   # bits/coord on the wire
    block: int = DEFAULT_BLOCK
    safety: float = 8.0
    backend: str = "cuda"
    name: str = "lattice_grouped"
    family: str = "lattice"
    packed: bool = False

    def __post_init__(self):
        if len(self.wire_width_per_client) != len(self.bits_per_client):
            raise ValueError("one wire width per client's bit-width")
        object.__setattr__(self, "bits", int(max(self.bits_per_client)))
        object.__setattr__(self, "quant", LatticeQuantizer(
            bits=self.bits, block=self.block, safety=self.safety,
            backend=self.backend))
        object.__setattr__(self, "_levels", {})
        object.__setattr__(self, "_bits", {})

    @property
    def pack(self) -> int:
        return 1

    def _levels_on(self, device) -> torch.Tensor:
        """(n,) fp32 wrap moduli 2^b_i, made once per device."""
        device = torch.device(device)
        if device not in self._levels:
            self._levels[device] = torch.tensor(
                [float(1 << int(b)) for b in self.bits_per_client],
                dtype=torch.float32, device=device)
        return self._levels[device]

    def wire(self, idx=None) -> LatticeWire:
        """Wire descriptor for the sampled client subset ``idx`` (a tensor
        of client ids); all clients when None."""
        if idx is None:
            return LatticeWire(bits=self.bits, pack=1,
                               levels=self._levels_on("cpu"))
        return LatticeWire(bits=self.bits, pack=1,
                           levels=self._levels_on(idx.device)[idx])

    def message_bits(self, d: int) -> int:
        # + γ + the message's wrap modulus (the levels row): the receiver
        # cannot snap a heterogeneous-width message without its modulus,
        # so the row is charged wire traffic
        return pad_len(d, self.block) * max(self.wire_width_per_client) + 64

    def message_bits_per_client(self, d: int) -> np.ndarray:
        dp = pad_len(d, self.block)
        return np.asarray([dp * int(w) + 64
                           for w in self.wire_width_per_client], np.int64)

    def _bits_on(self, device, d: int) -> torch.Tensor:
        """(n,) int64 per-client message bits, made once per (device, d)."""
        key = (torch.device(device), d)
        if key not in self._bits:
            self._bits[key] = torch.from_numpy(
                self.message_bits_per_client(d)).to(key[0])
        return self._bits[key]

    def bits_for(self, idx, d: int) -> int:
        """Total uplink bits of the sampled subset ``idx``, exact; nothing
        per round grows with the number of clients."""
        idx = torch.as_tensor(idx)
        return int(self._bits_on(idx.device, d)[idx].sum())

    # the per-message API encodes every message at the largest bit-width,
    # as the reference does: the grouped codec exists for the pipeline
    def keys(self, generator, m: int, d: int) -> MessageKey:
        return self.quant.keys(generator, m, d)

    def encode(self, key, x2, hint) -> LatticeMsg:
        return self.quant.encode(key, x2, hint)

    def decode(self, key, msg, ref2):
        return self.quant.decode(key, msg, ref2)


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


def _build_topk_ef(**kw):
    raise NotImplementedError("codec 'topk_ef' is not ported yet (ROADMAP "
                              "Queue 1 item 9)")


def _build_scalar(*, bits, backend, block, safety, **kw):
    _reject_extra(kw, "scalar")
    return ScalarCodec(bits=bits)


def _build_identity(*, bits, backend, block, safety, **kw):
    _reject_extra(kw, "identity")
    return IdentityCodec()


_CODECS: Dict[str, Any] = {
    "lattice": _build_lattice,
    "lattice_packed": _build_lattice_packed,
    "topk_ef": _build_topk_ef,
    "scalar": _build_scalar,
    "identity": _build_identity,
}


def registered_codecs() -> Tuple[str, ...]:
    """Names accepted by :func:`make_codec`, in registration order."""
    return tuple(_CODECS)


def register_codec(name: str, builder) -> None:
    """Register a custom codec. ``builder`` receives keyword arguments
    ``bits``, ``backend``, ``block``, ``safety`` plus any ``name:key=val``
    spec parameters, and must return a :class:`Codec`."""
    if name in _CODECS:
        raise ValueError(f"codec {name!r} already registered")
    _CODECS[name] = builder


def make_codec(spec, *, bits: int = 8, backend: str = "cuda",
               block: int = DEFAULT_BLOCK, safety: float = 8.0):
    """Build a codec from a spec string (or pass a codec through); a
    ``bits=`` in the spec overrides the config value."""
    if not isinstance(spec, str):
        if isinstance(spec, Codec):
            return spec
        raise TypeError(f"codec spec must be a name string or codec "
                        f"instance (group dicts resolve through "
                        f"resolve_codec); got {type(spec).__name__}")
    name, params = parse_spec(spec, "codec")
    if name not in _CODECS:
        raise ValueError(f"unknown codec {name!r}; choose from "
                         f"{sorted(_CODECS)}")
    bits = int(params.pop("bits", bits))
    safety = float(params.pop("safety", safety))
    block = int(params.pop("block", block))
    return _CODECS[name](bits=bits, backend=backend, block=block,
                         safety=safety, **params)


def _wire_width(codec: LatticeCodec) -> int:
    """A lattice member's declared bits a coordinate: its sub-byte width
    when packed, its uint storage otherwise."""
    return codec.bits if codec.packed else _storage_bits(codec.bits)


def _grouped(spec: Dict[str, Any], fed, backend: str, direction: str,
             slow_mask) -> GroupedLatticeCodec:
    """A ``{"fast": spec, "slow": spec}`` uplink over the straggler mask."""
    if direction != "up":
        raise ValueError("per-client group codecs apply to the uplink "
                         "only (the downlink is one broadcast message)")
    if slow_mask is None:
        raise ValueError("group codec specs need the algorithm's "
                         "client speed classes (slow_mask)")
    members = {g: make_codec(s, bits=fed.bits, backend=backend)
               for g, s in spec.items()}
    unknown = set(members) - {"fast", "slow"}
    if unknown:
        raise ValueError(f"unknown client groups {sorted(unknown)}; "
                         f"use 'fast' / 'slow'")
    fast = members.get("fast")
    slow = members.get("slow", fast)
    fast = fast if fast is not None else slow
    if not all(isinstance(c, LatticeCodec) for c in (fast, slow)):
        raise NotImplementedError(
            "per-client group codecs currently compose lattice-family "
            "members only")
    if (fast.safety, fast.block) != (slow.safety, slow.block):
        raise ValueError("group members must share safety/block (one "
                         "batched exchange, one γ derivation)")
    mask = [bool(m) for m in np.asarray(slow_mask)]
    return GroupedLatticeCodec(
        bits_per_client=tuple(int(slow.bits if m else fast.bits)
                              for m in mask),
        wire_width_per_client=tuple(_wire_width(slow if m else fast)
                                    for m in mask),
        block=fast.block, safety=fast.safety, backend=backend)


def resolve_codec(spec, fed, *, direction: str, default: str = None,
                  slow_mask=None):
    """An algorithm's per-direction codec. Precedence: explicit ``spec`` >
    ``fed.codec_up`` / ``fed.codec_down`` > ``default`` > the legacy
    ``fed.quantizer`` map (lattice | qsgd→scalar | none→identity). A dict
    spec ``{"fast": ..., "slow": ...}`` (uplink only) resolves each group
    and combines lattice-family members into a :class:`GroupedLatticeCodec`
    over ``slow_mask``, the per-client straggler mask of the clock's speed
    model. The lattice codecs run on ``fed.kernel_backend``."""
    backend = getattr(fed, "kernel_backend", "cuda")
    if spec is None:
        spec = getattr(fed, f"codec_{direction}", "") or None
    if spec is None:
        spec = default or _LEGACY_QUANTIZER.get(fed.quantizer)
        if spec is None:
            raise ValueError(f"no codec mapping for quantizer "
                             f"{fed.quantizer!r}")
    if isinstance(spec, dict):
        return _grouped(spec, fed, backend, direction, slow_mask)
    return make_codec(spec, bits=fed.bits, backend=backend)


def is_lattice_family(codec) -> bool:
    """True when the rotated-space pipeline can carry this codec."""
    return getattr(codec, "family", "") == "lattice"
