"""Rotated-space quantized exchange + backend registry (port of
``repro.compression.pipeline``).

**Backends** — the four primitive ops of the exchange (batched rotation,
fused rotate + stochastic round + wrap ``encode``, elementwise ``quantize``
of already-rotated coordinates, positional ``snap``) in two
implementations:

  * ``"torch"`` — the plain PyTorch versions, on any device,
  * ``"cuda"``  — the hand-written CUDA kernels of
    :mod:`repro_torch.kernels.exchange` (on CPU tensors their wrappers run
    the plain versions).

**Rotated-space exchange** (:meth:`ExchangePipeline.quafl_round`) — every
message of a round shares one rotation, so encode, decode and the
(s+1)-averaging all happen in rotated coordinates: ``s + 1`` forward and
``s + 1`` inverse rotation passes per round, counted in ``pipeline.stats``.
:meth:`ExchangePipeline.quafl_round_reference` composes the same exchange
message by message in original coordinates, as the equivalence oracle.

The round's randomness (signs, rounding noise) comes from a
``torch.Generator`` through :func:`round_randomness`, or is passed in as
tensors so a test can feed the reference's own draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.analysis.opbudget import OpBudget
from repro_torch.compression.rotation import DEFAULT_BLOCK, pad_len, signs
from repro_torch.kernels import exchange as kx

BACKENDS = ("torch", "cuda")


class LatticeWire(NamedTuple):
    """Per-direction wire of the lattice exchange: static ``bits``,
    ``pack = 8 // bits`` codes per byte for the packed wire (1 = unpacked),
    and optional per-message ``levels`` (an (m,) fp32 tensor of powers of
    two <= 2^bits)."""
    bits: int
    pack: int = 1
    levels: Any = None


# fp32 precision floor: y/γ must keep sub-integer precision, so γ stays
# above max|rot(x)|·2^-18, with max|rot(x)| estimated before the rotation
# from ‖x‖ (the encode needs γ before it rotates).
GAMMA_NORM_FLOOR = 2.0 ** -18


def coord_bound(norms, d_pad: int):
    """High-probability bound on the max rotated coordinate of a vector
    with the given l2 norm (subgaussian scale norm/sqrt(d_pad))."""
    return (norms.to(torch.float32) / float(np.sqrt(d_pad))
            * float(np.sqrt(2 * np.log(2 * d_pad + 1)) + 2.0))


def wrap_gamma(dist_hint, d: int, *, bits: int = None, levels=None,
               block: int = DEFAULT_BLOCK, safety: float = 8.0):
    """Per-message lattice scale from the encoder-local distance hint: the
    wrap window L·γ must exceed twice the max rotated coordinate of the
    difference. ``levels`` (per-message tensor) defaults to 2^bits."""
    if levels is None:
        levels = float(1 << bits)
    d_pad = pad_len(d, block)
    gamma = safety * 2.0 * coord_bound(dist_hint, d_pad) / levels
    return torch.clamp(gamma, min=1e-12)


class Backend(NamedTuple):
    """The four primitive ops; every op is batched over a message axis."""
    name: str
    rotate: Callable    # (x2, signs, *, block, inverse) -> y2
    encode: Callable    # (x2, signs, u2, gammas, *, bits, block,
                        #  want_rotated, pack, levels2) -> codes | (y, codes)
    quantize: Callable  # (y2, u2, gammas, *, bits, block, pack, levels2)
    snap: Callable      # (codes2, wrot2, gammas, *, bits, block, pack,
                        #  levels2) -> q2


_REGISTRY = {
    "torch": Backend("torch", kx.rotate_plain, kx.encode_plain,
                     kx.quantize_plain, kx.snap_plain),
    "cuda": Backend("cuda", kx.fused_rotate, kx.fused_encode,
                    kx.quantize_codes, kx.snap_codes),
}


def get_backend(name: str) -> Backend:
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel backend {name!r}; choose from "
                         f"{BACKENDS}")
    return _REGISTRY[name]


def round_randomness(generator: torch.Generator, s: int, d: int,
                     block: int = DEFAULT_BLOCK):
    """One round's shared randomness: the (d_pad,) sign diagonal, the (s,
    d_pad) uplink rounding noise and the (1, d_pad) downlink noise, all on
    the generator's device."""
    d_pad = pad_len(d, block)
    sg = signs(generator, d_pad)
    u_srv = torch.rand((1, d_pad), generator=generator,
                       device=generator.device)
    u_cl = torch.rand((s, d_pad), generator=generator,
                      device=generator.device)
    return sg, u_cl, u_srv


def _norms(x2):
    return torch.linalg.vector_norm(x2, dim=1)


@dataclass(eq=False)
class ExchangePipeline:
    """Rotated-space quantized-exchange engine over a selectable backend."""
    bits: int = 8
    block: int = DEFAULT_BLOCK
    backend: str = "cuda"
    safety: float = 8.0

    def __post_init__(self):
        self.ops = get_backend(self.backend)
        self.stats = OpBudget()

    # -- helpers ------------------------------------------------------------
    def _pad(self, x2):
        d = x2.shape[-1]
        d_pad = pad_len(d, self.block)
        x2 = x2.to(torch.float32)
        if d_pad == d:
            return x2.contiguous()
        return torch.nn.functional.pad(x2, (0, d_pad - d))

    def _wire(self, wire: LatticeWire) -> LatticeWire:
        return wire if wire is not None else LatticeWire(self.bits)

    def gammas(self, dist_hints, xnorms, d: int, wire: LatticeWire = None):
        """Wrap-window γ from the distance hint, floored at the fp32
        precision limit of the message's own rotated coordinates."""
        wire = self._wire(wire)
        base = wrap_gamma(dist_hints, d, bits=wire.bits, levels=wire.levels,
                          block=self.block, safety=self.safety)
        floor = coord_bound(xnorms, pad_len(d, self.block)) * GAMMA_NORM_FLOOR
        return torch.maximum(base, floor)

    # -- counted primitive ops (inputs (m, d) original / (m, d_pad) rotated)
    def rotate(self, x2, sg):
        self.stats.fwd += int(x2.shape[0])
        return self.ops.rotate(self._pad(x2), sg, block=self.block)

    def rotate_encode(self, x2, sg, u2, gammas, *, want_rotated=True,
                      wire: LatticeWire = None):
        wire = self._wire(wire)
        self.stats.fwd += int(x2.shape[0])
        return self.ops.encode(self._pad(x2), sg, u2, gammas, bits=wire.bits,
                               block=self.block, want_rotated=want_rotated,
                               pack=wire.pack, levels2=wire.levels)

    def quantize(self, y2_rot, u2, gammas, wire: LatticeWire = None):
        """Elementwise encode of already-rotated coordinates: no rotation
        pass, so no ``stats.fwd`` increment."""
        wire = self._wire(wire)
        return self.ops.quantize(y2_rot, u2, gammas, bits=wire.bits,
                                 block=self.block, pack=wire.pack,
                                 levels2=wire.levels)

    def snap(self, codes2, wrot2, gammas, wire: LatticeWire = None):
        wire = self._wire(wire)
        return self.ops.snap(codes2, wrot2, gammas, bits=wire.bits,
                             block=self.block, pack=wire.pack,
                             levels2=wire.levels)

    def unrotate(self, y2, sg, d: int):
        self.stats.inv += int(y2.shape[0])
        return self.ops.rotate(y2.contiguous(), sg, block=self.block,
                               inverse=True)[:, :d]

    def _randomness(self, generator, s, d, sg, u_cl, u_srv):
        if sg is None or u_cl is None or u_srv is None:
            if generator is None:
                raise ValueError("give a generator or all of signs, u_cl "
                                 "and u_srv")
            return round_randomness(generator, s, d, self.block)
        return sg, u_cl, u_srv

    # ------------------------------------------------------------------
    # one full QuAFL exchange, entirely in rotated coordinates
    # ------------------------------------------------------------------
    def quafl_round(self, server, Y, hints_up, *, generator=None,
                    signs=None, u_cl=None, u_srv=None, avg_mode="both",
                    up: LatticeWire = None, down: LatticeWire = None):
        """Quantized exchange + (s+1)-averaging of one server round.

        server: (d,) X_t; Y: (s, d) client models at poll time; hints_up:
        (s,) upper estimates of ‖Y^i − X_t‖. Returns (server_new (d,),
        clients_new (s, d), hint_srv, rel_err).
        """
        s, d = Y.shape
        up, down = self._wire(up), self._wire(down)
        sg, u_cl, u_srv = self._randomness(generator, s, d, signs, u_cl,
                                           u_srv)

        # uplink: fused rotate+encode of every client message; the rotated
        # coords come back too and serve as downlink decode references
        gam_up = self.gammas(hints_up, _norms(Y), d, up)
        Y_rot, codes_up = self.rotate_encode(Y, sg, u_cl, gam_up, wire=up)
        srv_rot = self.rotate(server[None], sg)
        QY_rot = self.snap(codes_up, srv_rot, gam_up, up)       # (s, d_pad)

        # downlink: Enc(X_t) quantizes the cached rotated server
        hint_srv = torch.max(_norms(QY_rot - srv_rot)) + 1e-8
        gam_dn = self.gammas(hint_srv[None], _norms(server[None]), d, down)
        codes_dn = self.quantize(srv_rot, u_srv, gam_dn, down)
        QX_rot = self.snap(codes_dn, Y_rot, gam_dn, down)       # (s, d_pad)

        # (s+1)-averaging in rotated coordinates; inverse-rotate only the
        # final states
        if avg_mode in ("both", "server_only"):
            srv_new_rot = (srv_rot[0] + torch.sum(QY_rot, 0)) / (s + 1)
        else:
            srv_new_rot = torch.mean(QY_rot, 0)
        if avg_mode in ("both", "client_only"):
            cl_new_rot = QX_rot / (s + 1) + s * Y_rot / (s + 1)
        else:
            cl_new_rot = QX_rot
        server_new = self.unrotate(srv_new_rot[None], sg, d)[0]
        clients_new = self.unrotate(cl_new_rot, sg, d)

        rel_err = torch.mean(_norms(QY_rot - Y_rot)
                             / (_norms(Y_rot) + 1e-9))
        return server_new, clients_new, hint_srv, rel_err

    # ------------------------------------------------------------------
    # equivalence oracle: per-message materialize-everything composition
    # ------------------------------------------------------------------
    def quafl_round_reference(self, server, Y, hints_up, *, generator=None,
                              signs=None, u_cl=None, u_srv=None,
                              avg_mode="both", up: LatticeWire = None,
                              down: LatticeWire = None):
        """The same exchange over the same randomness and γ, composed
        message by message in original coordinates with the plain
        versions."""
        s, d = Y.shape
        up, down = self._wire(up), self._wire(down)
        sg, u_cl, u_srv = self._randomness(generator, s, d, signs, u_cl,
                                           u_srv)

        def rot(x2):
            return kx.rotate_plain(x2, sg, block=self.block)

        def unrot(x2):
            return kx.rotate_plain(x2, sg, block=self.block, inverse=True)

        def enc(x2, u2, g, w):
            return kx.encode_plain(x2, sg, u2, g, bits=w.bits,
                                   block=self.block, pack=w.pack,
                                   levels2=w.levels)

        def snap(codes, ref, g, w):
            return kx.snap_plain(codes, ref, g, bits=w.bits,
                                 block=self.block, pack=w.pack,
                                 levels2=w.levels)

        gam_up = self.gammas(hints_up, _norms(Y), d, up)
        Yp = self._pad(Y)
        srvp = self._pad(server[None])
        QY = unrot(snap(enc(Yp, u_cl, gam_up, up), rot(srvp), gam_up, up))
        hint_srv = torch.max(_norms(QY - srvp)) + 1e-8
        gam_dn = self.gammas(hint_srv[None], _norms(server[None]), d, down)
        QX = unrot(snap(enc(srvp, u_srv, gam_dn, down), rot(Yp), gam_dn,
                        down))

        if avg_mode in ("both", "server_only"):
            srv_new = (srvp[0] + torch.sum(QY, 0)) / (s + 1)
        else:
            srv_new = torch.mean(QY, 0)
        if avg_mode in ("both", "client_only"):
            cl_new = QX / (s + 1) + s * Yp / (s + 1)
        else:
            cl_new = QX
        rel_err = torch.mean(_norms(QY - Yp) / (_norms(Yp) + 1e-9))
        return srv_new[:d], cl_new[:, :d], hint_srv, rel_err
