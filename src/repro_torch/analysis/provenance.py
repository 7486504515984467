"""Wire provenance marks at the message sites (port of
``repro.analysis.provenance``).

``wire_mark(x, channel=..., part=..., codec=...)`` names ``x`` as one part
of a wire message and returns ``x`` itself. While a recorder is active
(:class:`WireRecorder`, or the op log of a round,
``analysis/jaxpr.RoundTrace``) it appends a :class:`WireMark` to it: the
channel, the part, the codec, whether the leading axis is a message batch,
the encoded dimension ``d``, the container dtype and the shape. Otherwise
it does nothing at all.

The reference marks ``codes.astype(container)``, a cast XLA throws away;
in PyTorch a cast is a real pass over the codes on the device. So the
port's mark takes the container as metadata (``container=torch.uint8``
where the working codes are int32): it dispatches no aten op, reads no
value and cannot break a CUDA-graph capture. The port's codecs encode a
batch of messages at once, so their marks are ``batched=True``, as the
reference's vmapped marks are.

The mesh reports its collectives here too (:func:`observe_collective`),
and every kernel wrapper its launches (``kernels/build.costed``), so a
recorder can tell a gathered payload that derives from a marked value from
one that does not (``analysis/wire.py``).

This module imports nothing of the port: ``compression``, ``kernels`` and
``launch/mesh.py`` import it at load.
"""
from __future__ import annotations

import os
import sys
from typing import List, NamedTuple, Optional, Tuple

import torch

# part names a role inside one message; side-channel rows (charged at 32
# bits each by the codec declaration) are everything except the payload
PAYLOAD_PARTS = ("codes", "idx", "vals")
SIDE_PARTS = ("gamma", "levels", "scale")

# the recorders listening, innermost last
RECORDERS: list = []

_SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class WireMark(NamedTuple):
    """One mark: what it names, the container its values cross the wire
    in, the marked tensor's shape, and the port line that made it."""
    channel: str
    part: str
    codec: str
    batched: bool
    d: int
    dtype: torch.dtype
    shape: Tuple[int, ...]
    where: str

    @property
    def container_bits(self) -> int:
        return self.dtype.itemsize * 8

    @property
    def elems(self) -> int:
        """Wire elements a message: the leading axis is the message batch
        when ``batched``."""
        size = 1
        for n in self.shape:
            size *= n
        if self.batched and self.shape:
            return size // max(self.shape[0], 1)
        return size

    def key(self) -> tuple:
        """What the reference's mark says of the same site: (channel, part,
        codec, container bits, elements a message, batched, d)."""
        return (self.channel, self.part, self.codec, self.container_bits,
                self.elems, self.batched, self.d)


class WireRecorder:
    """``with WireRecorder() as rec: ...``; then ``rec.marks``."""

    def __init__(self):
        self.marks: List[WireMark] = []

    def mark(self, x, record: WireMark) -> None:
        self.marks.append(record)

    def collective(self, record: dict, x) -> None:
        pass

    def kernel(self, name: str, inputs, outputs) -> None:
        pass

    def __enter__(self):
        RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        RECORDERS.remove(self)
        return False


def _where() -> str:
    """The innermost frame of the port outside this module."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_SRC) and fn != __file__:
            return (f"{os.path.relpath(fn, _SRC)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


def wire_mark(x, *, channel: str, part: str, codec: str,
              batched: bool = False, d: int = 0,
              container: Optional[torch.dtype] = None):
    """Mark ``x`` as the ``part`` of a ``channel`` message of ``codec``;
    returns ``x``.

    channel: "up" | "down" (the pipeline's and the transports' lattice
      wire) or "msg" (a codec's own encode).
    part: "codes"/"idx"/"vals" payload, or a named side-channel row.
    batched: True when the leading axis of ``x`` is a message batch.
    d: the model or leaf dimension this message encodes (0 = unknown).
    container: the dtype the values cross the wire in, when it is not
      ``x.dtype`` (int32 working codes shipped in uint8).
    """
    if RECORDERS:
        record = WireMark(channel, part, codec, bool(batched), int(d),
                          container if container is not None else x.dtype,
                          tuple(x.shape), _where())
        for rec in tuple(RECORDERS):
            rec.mark(x, record)
    return x


def observe_wire(x, **kwargs) -> None:
    """Record a mark where the value itself is not passed on."""
    wire_mark(x, **kwargs)


def observe_collective(record: dict, x) -> None:
    """A collective of the mesh: its record and its operand ``x``."""
    for rec in tuple(RECORDERS):
        rec.collective(record, x)
