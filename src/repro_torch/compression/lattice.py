"""Per-message quantizers (port of ``repro.compression.lattice``).

``LatticeQuantizer`` is the position-aware lattice quantizer (Davies et al.,
Lemma 3.1): ``Enc(x)`` is the randomized-Hadamard rotation of x,
stochastically rounded at scale γ and wrapped mod 2^b; ``Dec(ref, msg)``
snaps each code to the representative nearest the rotated reference and
rotates back. γ comes from the encoder-local distance hint, floored at the
fp32 precision limit of the message itself. ``QSGDQuantizer`` is the
norm-scaled stochastic quantizer (not position-aware), ``IdentityQuantizer``
the fp32 pass-through.

The math runs on the exchange pipeline's backends: ``"cuda"`` (the
``fused_encode`` and ``fused_decode`` kernels) or ``"torch"`` (their plain
versions).

Two differences from the reference, both PyTorch idiom:

* **Batched.** Every call takes a leading message axis: x (m, d), hints
  (m,), codes (m, ·), γ (m,); one message is m=1. This replaces the
  reference's ``jax.vmap`` over messages, and a batch of m lattice messages
  is one kernel launch each way.
* **Explicit randomness.** The reference derives a message's randomness
  from a JAX key (``krot, krnd = split(key)``: signs from ``krot``, rounding
  noise from ``krnd``). Here a :class:`MessageKey` carries those draws as
  tensors, made from a ``torch.Generator`` by the quantizer's ``keys`` or
  handed in by a test from the reference's own draws. Decode reads only
  the signs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.compression.pipeline import (GAMMA_NORM_FLOOR, coord_bound,
                                              get_backend, wrap_gamma)
from repro_torch.compression.rotation import DEFAULT_BLOCK, pad_len, signs


class LatticeMsg(NamedTuple):
    codes: torch.Tensor    # (m, d_pad) int32, (m, d_pad // pack) uint8, ...
    gamma: torch.Tensor    # (m,) fp32 — transmitted scale (O(1) overhead)


class MessageKey(NamedTuple):
    """The randomness of a batch of m messages: rotation ``signs`` (m,
    d_pad) and rounding noise ``u`` (m, d_pad) for the lattice quantizer,
    ``u`` (m, d) for QSGD; fields a quantizer does not read are None."""
    signs: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None

    def to(self, device) -> MessageKey:
        return MessageKey(*(None if t is None else t.to(device)
                            for t in self))

    def row(self, i: int) -> MessageKey:
        """Message i's key as a batch of one."""
        return MessageKey(*(None if t is None else t[i:i + 1]
                            for t in self))


def _pad(x2, d_pad: int):
    x2 = x2.to(torch.float32)
    d = x2.shape[-1]
    if d == d_pad:
        return x2.contiguous()
    return torch.nn.functional.pad(x2, (0, d_pad - d))


@dataclass(frozen=True)
class LatticeQuantizer:
    bits: int = 8
    block: int = DEFAULT_BLOCK
    safety: float = 8.0    # head-room factor on the wrap window
    backend: str = "cuda"  # pipeline backend running the actual math

    @property
    def levels(self) -> int:
        return 1 << self.bits

    def _ops(self):
        return get_backend(self.backend)

    def gamma_for(self, dist_hint, d: int) -> torch.Tensor:
        """γ from the distance hint: the wrap window 2^b·γ must exceed twice
        the max rotated coordinate of x − ref."""
        return wrap_gamma(dist_hint, d, bits=self.bits, block=self.block,
                          safety=self.safety)

    def keys(self, generator: torch.Generator, m: int, d: int) -> MessageKey:
        """Fresh signs and rounding noise for m messages of length d."""
        d_pad = pad_len(d, self.block)
        sg = signs(generator, m * d_pad).reshape(m, d_pad)
        u = torch.rand((m, d_pad), generator=generator,
                       device=generator.device)
        return MessageKey(sg, u)

    def encode(self, key: MessageKey, x2, dist_hint, *,
               pack: int = 1) -> LatticeMsg:
        """x2: (m, d) fp32; dist_hint: (m,) or scalar upper estimates of
        ‖x − ref‖. ``pack > 1`` packs ``pack`` codes per byte inside the
        encode (the ``lattice_packed`` wire)."""
        m, d = x2.shape
        d_pad = pad_len(d, self.block)
        hint = torch.as_tensor(dist_hint, dtype=torch.float32,
                               device=x2.device)
        # fp32 precision floor: y/γ must keep sub-integer precision, so
        # γ ≥ max|rot(x)|·2^-18, estimated from the rotation-invariant norm
        gamma = torch.maximum(
            self.gamma_for(hint, d),
            coord_bound(torch.linalg.vector_norm(x2.to(torch.float32), dim=1),
                        d_pad) * GAMMA_NORM_FLOOR)
        codes = self._ops().encode(_pad(x2, d_pad), key.signs, key.u,
                                   gamma.contiguous(), bits=self.bits,
                                   block=self.block, want_rotated=False,
                                   pack=pack)
        return LatticeMsg(codes=codes, gamma=gamma)

    def decode(self, key: MessageKey, msg: LatticeMsg, ref2, *,
               pack: int = 1) -> torch.Tensor:
        """ref2: (1 or m, d) decoding references (the paper's y). Returns
        Q(x) (m, d) in one fused pass: rotate the reference, snap, rotate
        back."""
        d = ref2.shape[-1]
        d_pad = pad_len(d, self.block)
        return self._ops().decode(msg.codes, _pad(ref2, d_pad), key.signs,
                                  msg.gamma, bits=self.bits,
                                  block=self.block, pack=pack)[:, :d]

    def message_bits(self, d: int) -> int:
        return pad_len(d, self.block) * self.bits + 32  # + γ scalar


@dataclass(frozen=True)
class QSGDQuantizer:
    """Norm-scaled stochastic quantizer [Alistarh et al.]. Not
    position-aware: error ∝ ‖x‖ (the paper's Figure-5 baseline)."""
    bits: int = 8
    block: int = DEFAULT_BLOCK  # unused; uniform API

    @property
    def levels(self) -> int:
        return (1 << (self.bits - 1)) - 1  # signed levels

    def keys(self, generator: torch.Generator, m: int, d: int) -> MessageKey:
        return MessageKey(u=torch.rand((m, d), generator=generator,
                                       device=generator.device))

    def encode(self, key: MessageKey, x2, dist_hint=None) -> LatticeMsg:
        norm = torch.linalg.vector_norm(x2, dim=1) + 1e-12
        y = x2.abs() / norm[:, None] * self.levels
        q = torch.floor(y + key.u) * torch.sign(x2)
        return LatticeMsg(codes=q.to(torch.int32), gamma=norm)

    def decode(self, key: MessageKey, msg: LatticeMsg, ref2=None):
        return (msg.codes.to(torch.float32)
                * (msg.gamma / self.levels)[:, None])

    def message_bits(self, d: int) -> int:
        return d * self.bits + 32


@dataclass(frozen=True)
class IdentityQuantizer:
    bits: int = 32

    def keys(self, generator: torch.Generator, m: int, d: int) -> MessageKey:
        return MessageKey()

    def encode(self, key: MessageKey, x2, dist_hint=None) -> LatticeMsg:
        return LatticeMsg(codes=x2, gamma=torch.ones(
            x2.shape[0], dtype=torch.float32, device=x2.device))

    def decode(self, key: MessageKey, msg: LatticeMsg, ref2=None):
        return msg.codes

    def message_bits(self, d: int) -> int:
        return d * 32


def make_quantizer(name: str, bits: int, backend: str = "cuda"):
    if name == "lattice":
        return LatticeQuantizer(bits=bits, backend=backend)
    if name == "qsgd":
        return QSGDQuantizer(bits=bits)
    if name == "none":
        return IdentityQuantizer()
    raise ValueError(name)
