"""Rotated-space quantized exchange + backend registry (port of
``repro.compression.pipeline``).

**Backends** — the five primitive ops of the exchange (batched rotation,
fused rotate + stochastic round + wrap ``encode``, elementwise ``quantize``
of already-rotated coordinates, positional ``snap``, and the fully fused
``decode`` of the per-message codec API), and the two snaps of the
rotated-space round with the passes it runs around them (``uplink``: the
uplink snap, the server average and the error norms; ``average``: the
downlink snap and the clients' average, in place), in two implementations:

  * ``"torch"`` — the plain PyTorch versions, on any device,
  * ``"cuda"``  — the hand-written CUDA kernels of
    :mod:`repro_torch.kernels.exchange` (on CPU tensors their wrappers run
    the plain versions).

**Rotated-space exchange** (:meth:`ExchangePipeline.quafl_round`) — every
message of a round shares one rotation, so encode, decode and the
(s+1)-averaging all happen in rotated coordinates: ``s + 1`` forward and
``s + 1`` inverse rotation passes per round, counted in ``pipeline.stats``.
On the kernels the snapped rows never reach device memory: the uplink's
QY_i live only inside ``uplink``, which writes the server average and the
two statistics, and the downlink's QX_i only inside ``average``, which
writes the clients' average over their rotated rows. The round's peak
is at the encode's inputs and outputs (Y, the uplink noise, the rotated
rows and their codes).
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
from repro_torch.analysis.provenance import wire_mark
from repro_torch.compression.rotation import DEFAULT_BLOCK, pad_len, signs
from repro_torch.kernels import exchange as kx
from repro_torch.utils import spans

BACKENDS = ("torch", "cuda")


class LatticeWire(NamedTuple):
    """Per-direction wire of the lattice exchange: static ``bits``,
    ``pack = 8 // bits`` codes per byte for the packed wire (1 = unpacked),
    and optional per-message ``levels`` (an (m,) fp32 tensor of powers of
    two <= 2^bits)."""
    bits: int
    pack: int = 1
    levels: Any = None


def wire_container_dtype(wire: LatticeWire) -> torch.dtype:
    """The unsigned dtype one wire code ships in (packed wires hold
    ``pack`` codes a uint8 byte)."""
    if wire.pack > 1 or wire.bits <= 8:
        return torch.uint8
    return torch.uint16 if wire.bits <= 16 else torch.uint32


def observe_lattice_wire(codes, gammas, wire: LatticeWire, channel: str):
    """Record the wire form of a lattice message batch (the leading axis)
    for the wire-truth audit: the codes in their container, the γ row and
    the levels row of a heterogeneous wire. Metadata only: no op runs."""
    d = int(codes.shape[-1]) * max(int(wire.pack), 1)
    wire_mark(codes, channel=channel, part="codes", codec="wire",
              batched=True, d=d, container=wire_container_dtype(wire))
    wire_mark(gammas, channel=channel, part="gamma", codec="wire",
              batched=True, d=d)
    if wire.levels is not None:
        wire_mark(wire.levels, channel=channel, part="levels", codec="wire",
                  batched=True, d=d)


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
    """The five primitive ops and the round's two fused snaps; every op is
    batched over a message axis."""
    name: str
    rotate: Callable    # (x2, signs, *, block, inverse) -> y2
    encode: Callable    # (x2, signs, u2, gammas, *, bits, block,
                        #  want_rotated, pack, levels2) -> codes | (y, codes)
    quantize: Callable  # (y2, u2, gammas, *, bits, block, pack, levels2)
    snap: Callable      # (codes2, wrot2, gammas, *, bits, block, pack,
                        #  levels2) -> q2
    decode: Callable    # (codes2, ref2, signs, gammas, *, bits, block,
                        #  pack, levels2) -> x2 in original coordinates
    uplink: Callable    # (codes2, srv_rot, y_rot, gammas, *, bits, block,
                        #  pack, levels2, avg_mode) -> (srv_new, rel_err,
                        #  hint_srv)
    average: Callable   # (codes2, y_rot, gammas, *, bits, block, pack,
                        #  levels2, avg_mode) -> y_rot, averaged in place


_REGISTRY = {
    "torch": Backend("torch", kx.rotate_plain, kx.encode_plain,
                     kx.quantize_plain, kx.snap_plain, kx.decode_plain,
                     kx.uplink_plain, kx.average_plain),
    "cuda": Backend("cuda", kx.fused_rotate, kx.fused_encode,
                    kx.quantize_codes, kx.snap_codes, kx.fused_decode,
                    kx.uplink, kx.average),
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

    def uplink(self, codes2, srv_rot, y_rot, gammas,
               wire: LatticeWire = None, avg_mode: str = "both"):
        """The uplink snap against the rotated server with the server
        average and the round's statistics: (srv_new_rot, rel_err,
        hint_srv). No rotation pass."""
        wire = self._wire(wire)
        return self.ops.uplink(codes2, srv_rot, y_rot, gammas,
                               bits=wire.bits, block=self.block,
                               pack=wire.pack, levels2=wire.levels,
                               avg_mode=avg_mode)

    def average(self, codes2, y_rot, gammas, wire: LatticeWire = None,
                avg_mode: str = "both"):
        """The downlink snap against each rotated client row, averaged
        into ``y_rot`` in place. No rotation pass."""
        wire = self._wire(wire)
        return self.ops.average(codes2, y_rot, gammas, bits=wire.bits,
                                block=self.block, pack=wire.pack,
                                levels2=wire.levels, avg_mode=avg_mode)

    def unrotate(self, y2, sg, d: int):
        self.stats.inv += int(y2.shape[0])
        return self.ops.rotate(y2.contiguous(), sg, block=self.block,
                               inverse=True)[:, :d]

    def decode(self, codes2, ref2, sg, gammas, d: int,
               wire: LatticeWire = None):
        """Full fused Dec(ref, msg): rotate ref + snap + inverse rotate;
        (max(mc, mr), d) in original coordinates."""
        wire = self._wire(wire)
        m = max(codes2.shape[0], ref2.shape[0])
        self.stats.fwd += int(ref2.shape[0])
        self.stats.inv += m
        return self.ops.decode(codes2, self._pad(ref2), sg, gammas,
                               bits=wire.bits, block=self.block,
                               pack=wire.pack, levels2=wire.levels)[:, :d]

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

        Every (s, d_pad) temporary is dropped as soon as it is dead, and no
        snapped row is kept: the uplink snap (``uplink``) writes only the
        server average and the two statistics, the downlink snap
        (``average``) writes the clients' average over the rotated client
        rows (the server sum in row order, each division correctly
        rounded, the clients' average in its div, mul, div, add order). So
        a round holds at most Y, the uplink noise, the rotated rows and
        their codes (the encode's inputs and outputs), and an LM at full
        width fits. At llama3.2-1b's full width (74.2 GB of 80, held by
        ``chip_smoke.py --train-full``) the fit also relies on
        :func:`~repro_torch.compression.rotation.signs` allocating its fp32
        row before its int8 draw: in the other order the freed draw leaves
        a hole in front of the row, and the caching allocator's free space
        comes apart into pieces too small for a round's (s, d_pad) rows.
        """
        s, d = Y.shape
        up, down = self._wire(up), self._wire(down)
        with spans.span("exchange.draws", eager_only=True):
            sg, u_cl, u_srv = self._randomness(generator, s, d, signs, u_cl,
                                               u_srv)

        # uplink: fused rotate+encode of every client message; the rotated
        # coords come back too and serve as downlink decode references; the
        # snap against the rotated server sums the server average and the
        # norms of rel_err and hint_srv
        with spans.span("exchange.uplink", eager_only=True):
            gam_up = self.gammas(hints_up, _norms(Y), d, up)
            Y_rot, codes_up = self.rotate_encode(Y, sg, u_cl, gam_up,
                                                 wire=up)
            observe_lattice_wire(codes_up, gam_up, up, channel="up")
            del u_cl
            srv_rot = self.rotate(server[None], sg)
            srv_new_rot, rel_err, hint_srv = self.uplink(
                codes_up, srv_rot, Y_rot, gam_up, up, avg_mode)
            del codes_up

        # downlink: Enc(X_t) quantizes the cached rotated server
        with spans.span("exchange.downlink", eager_only=True):
            gam_dn = self.gammas(hint_srv[None], _norms(server[None]), d,
                                 down)
            codes_dn = self.quantize(srv_rot, u_srv, gam_dn, down)
            observe_lattice_wire(codes_dn, gam_dn, down, channel="down")
            del u_srv, srv_rot

        # the clients' (s+1)-averaging in rotated coordinates, over Y_rot;
        # inverse-rotate only the final states
        with spans.span("exchange.average", eager_only=True):
            cl_new_rot = self.average(codes_dn, Y_rot, gam_dn, down,
                                      avg_mode)
            del codes_dn, Y_rot
        with spans.span("exchange.unrotate", eager_only=True):
            server_new = self.unrotate(srv_new_rot[None], sg, d)[0]
            del srv_new_rot
            clients_new = self.unrotate(cl_new_rot, sg, d)
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
