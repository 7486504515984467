"""Transport protocol: HOW the uplink aggregate moves over the mesh (port of
``repro.compression.transports``).

A codec decides what one message looks like; a transport decides how the
client-sum collective of the shard-local exchange
(:mod:`repro_torch.core.exchange_local`) is carried over the process group
of the mesh's client axis. All three strategies compute the same
aggregate; they differ in which bytes cross the wire:

  ``shard_local``     decode/snap locally, all-reduce fp32 partial sums —
                      the faithful reading of Alg. 1 line 8 (legacy name
                      ``dequant_psum``)
  ``code_allgather``  all-gather the codec codes in their wire container
                      (uint8 at b <= 8, the sub-byte ``lattice_packed``
                      bytes) + decode every message locally
  ``reduce_scatter``  snap locally in rotated space, reduce-scatter the
                      snapped chunks over the client axis, then move the
                      reduced shards back as a scatter-resident compressed
                      downlink: each rank lattice-encodes its own reduced
                      shard (``quantize_codes``) at the downlink wire width
                      and the all-gather carries the codes plus a γ-shards
                      row instead of fp32; every rank snaps the gathered
                      codes against n·rot(X_t). The aggregate is
                      re-quantized at the downlink width (the per-client
                      lattices share no common grid), within the same
                      Lemma 3.1 wrap bound as the downlink encode.

Each transport exposes ``lattice_sum`` (rotated-space path) and
``generic_sum`` (per-message codec path); ``reduce_scatter`` also
``lattice_fused_sum`` (the shard-local exchange prefers it on a client axis
of the mesh). ``extra_bits_down`` reports the gathered side-channel rows
and the coded re-gather so that :mod:`repro_torch.launch.spmd`'s bits stay
honest, and ``wire_budget`` each collective class's byte cap for one leaf.
Select by name (``FedConfig.transport`` maps here through
:func:`transport_for_mode`), extend with :func:`register_transport`.

The collectives are :class:`repro_torch.launch.mesh.Mesh`'s over a named
axis; the rounding noise of the fused path's per-shard encode is passed in
(``u_rs``), drawn by the exchange or injected.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.analysis.provenance import wire_mark
from repro_torch.compression.rotation import pad_len
from repro_torch.kernels.exchange import block_geometry


class WireBudget(NamedTuple):
    """A transport's declared collective footprint for ONE exchanged leaf:
    ``caps`` upper-bounds each collective class (bytes; a zero cap asserts
    the class is absent) and ``float_reduce_ok`` states whether model-sized
    fp32 payloads may enter reduce-class collectives."""
    caps: Dict[str, int]
    float_reduce_ok: bool


# scalar side traffic per exchanged leaf (hint/qerr psums): a loose upper
# bound, far below any model payload
_SCALAR_SLACK = 256


def _leaf_dpad(codec, d: int) -> int:
    """Padded length of one exchanged leaf: the shard-local exchange pads
    leaves to 1024 then the pipeline pads to its block geometry."""
    d1 = d + (-d) % 1024
    blk = getattr(codec, "block", None)
    return pad_len(d1) if blk is None else pad_len(d1, blk)


def _lattice_pair(codec_up, codec_down) -> bool:
    return (getattr(codec_up, "family", "") == "lattice"
            and getattr(codec_down, "family", "") == "lattice")


def _decl_gather_bytes(decl, n: int) -> Tuple[int, int]:
    """(int_bytes, float_bytes) an all-gather of one declared message
    costs per rank (output = n stacked messages)."""
    ib = fb = 0
    for p in decl.parts:
        nbytes = n * p.elems * (p.container_bits // 8)
        if p.kind == "int":
            ib += nbytes
        else:
            fb += nbytes
    return ib, fb


def wire_container(wire) -> torch.dtype:
    """The dtype lattice codes cross the wire in: uint8 packed or at b <= 8,
    16 bits to b = 16, else 32."""
    if wire.pack > 1 or wire.bits <= 8:
        return torch.uint8
    return torch.int16 if wire.bits <= 16 else torch.int32


def _from_container(codes: torch.Tensor, wire) -> torch.Tensor:
    """Codes gathered in :func:`wire_container` back in the form the snap
    takes: packed bytes as they are, int32 otherwise (a 16-bit code is
    masked back to its unsigned value)."""
    if wire.pack > 1:
        return codes
    out = codes.to(torch.int32)
    return out & 0xFFFF if codes.dtype == torch.int16 else out


def gather_message(mesh, msg, axis: str, codec):
    """Every rank's one-row message along ``axis`` as one (n, ...) batch:
    each field gathered, lattice codes in their wire container."""
    wire = codec.wire() if hasattr(codec, "wire") else None
    fields = []
    for name, f in zip(msg._fields, msg):
        if wire is not None and name == "codes":
            f = _from_container(mesh.all_gather(
                f.to(wire_container(wire)), axis), wire)
        else:
            f = mesh.all_gather(f, axis)
        fields.append(f.flatten(0, 1))
    return type(msg)(*fields)


@runtime_checkable
class Transport(Protocol):
    """Structural type of a registered uplink-aggregation strategy."""

    def lattice_sum(self, pipe, wire, codes, gammas, srv_rot, qy_own, mesh,
                    client_axis, in_mesh):
        ...

    def generic_sum(self, quant, key, msg, srv, qy_own, mesh, client_axis,
                    in_mesh, n_slots):
        ...


def _psum_maybe(mesh, x, axis, in_mesh):
    return mesh.psum(x, axis) if in_mesh else x


def _shardable(d_pad: int, n: int, wire, block=None) -> bool:
    """Can a (1, d_pad) rotated vector be coded per reduce-scatter shard?
    Each shard must be its own valid block geometry (no repadding inside
    the collective) and, when the wire packs sub-byte, the shard's Hadamard
    sublane factor must still divide by ``pack``."""
    if n <= 1 or d_pad % n:
        return False
    d_sh = d_pad // n
    blk = {} if block is None else {"block": block}
    if pad_len(d_sh, **blk) != d_sh:
        return False
    _, _, r, _, _ = block_geometry(d_sh, **blk)
    return wire.pack == 1 or r % wire.pack == 0


def scatter_encode_gather(pipe, wire, vec_rot, ref_rot, gammas, u, n: int):
    """Single-process emulation of the scatter-resident coded
    redistribution: splits the summed ROTATED vector (1, d_pad) into the
    ``n`` shards a reduce-scatter leaves on each rank, quantizes every
    shard at the wire's width with the noise ``u`` (n, d_pad // n) (what
    the all-gather would move) and snaps the codes against the matching
    shards of ``ref_rot`` — the kernel calls of the distributed
    ``lattice_fused_sum``, minus the collectives. Returns ``(decoded (1,
    d_pad), codes (n, d_sh // pack))``."""
    d_pad = vec_rot.shape[-1]
    d_sh = d_pad // n
    shards = vec_rot.reshape(n, d_sh)
    gam_row = torch.as_tensor(gammas, dtype=torch.float32,
                              device=vec_rot.device).reshape(-1).expand(n)
    gam_row = gam_row.contiguous()
    codes = pipe.quantize(shards, u, gam_row, wire)
    dec = pipe.snap(codes, ref_rot.reshape(n, d_sh), gam_row, wire)
    return dec.reshape(1, d_pad), codes


@dataclass(frozen=True)
class ShardLocalPsum:
    """fp32 all-reduce of locally decoded/snapped messages."""
    name: str = "shard_local"

    def lattice_sum(self, pipe, wire, codes, gammas, srv_rot, qy_own, mesh,
                    client_axis, in_mesh):
        return _psum_maybe(mesh, qy_own, client_axis, in_mesh)

    def generic_sum(self, quant, key, msg, srv, qy_own, mesh, client_axis,
                    in_mesh, n_slots):
        return _psum_maybe(mesh, qy_own, client_axis, in_mesh)

    def extra_bits_down(self, codec_up, codec_down, d: int, n: int) -> int:
        """The psum reduction moves no extra redistribution payload."""
        return 0

    def wire_budget(self, codec_up, codec_down, d: int, n: int) -> WireBudget:
        """One fp32 all-reduce of the decoded partials; nothing gathered."""
        dp = _leaf_dpad(codec_up, d)
        return WireBudget(caps={
            "psum_fbytes": dp * 4 + _SCALAR_SLACK,
            "psum_ibytes": 0,
            "psum_scatter_fbytes": 0,
            "psum_scatter_ibytes": 0,
            "reduce_scatter_fbytes": 0,
            "reduce_scatter_ibytes": 0,
            "all_gather_fbytes": 0,
            "all_gather_ibytes": 0,
        }, float_reduce_ok=True)


@dataclass(frozen=True)
class CodeAllgather:
    """All-gather the codes along the client axis; decode locally. Moves
    ``codec.message_bits`` per client instead of d fp32 words."""
    name: str = "code_allgather"

    def lattice_sum(self, pipe, wire, codes, gammas, srv_rot, qy_own, mesh,
                    client_axis, in_mesh):
        if not in_mesh:
            return qy_own
        # the gathered operands ARE the wire, in their container form,
        # marked for the wire-truth audit
        d_leaf = int(codes.shape[-1]) * max(int(wire.pack), 1)
        codes_all = mesh.all_gather(
            wire_mark(codes[0].to(wire_container(wire)), channel="up",
                      part="codes", codec="wire", d=d_leaf), client_axis)
        gam_all = mesh.all_gather(
            wire_mark(gammas[0], channel="up", part="gamma", codec="wire",
                      d=d_leaf), client_axis)
        return torch.sum(pipe.snap(_from_container(codes_all, wire), srv_rot,
                                   gam_all, wire), 0, keepdim=True)

    def generic_sum(self, quant, key, msg, srv, qy_own, mesh, client_axis,
                    in_mesh, n_slots):
        if not in_mesh:
            return qy_own
        # gather every field of the message (codes, scales, indices, ...)
        # so any codec's wire format rides this transport
        msgs = gather_message(mesh, msg, client_axis, quant)
        qy_sum = torch.zeros_like(srv)
        for j in range(n_slots):
            m_j = type(msgs)(*(f[j:j + 1] for f in msgs))
            qy_sum = qy_sum + quant.decode(key, m_j, srv)
        return qy_sum

    def extra_bits_down(self, codec_up, codec_down, d: int, n: int) -> int:
        """The gathered per-client γ (and, for a grouped uplink, levels)
        f32 scalars are redistribution traffic: every rank receives every
        other client's rows; the other n-1 copies land here."""
        rows = 1
        wire = codec_up.wire() if hasattr(codec_up, "wire") else None
        if wire is not None and getattr(wire, "levels", None) is not None:
            rows += 1
        return rows * (n - 1) * 32

    def wire_budget(self, codec_up, codec_down, d: int, n: int) -> WireBudget:
        """Gathers exactly the declared uplink message (codes + side rows);
        reduce-class collectives carry scalars only."""
        decl = codec_up.wire_declaration(_leaf_dpad(codec_up, d))
        ib, fb = _decl_gather_bytes(decl, n)
        return WireBudget(caps={
            "psum_fbytes": _SCALAR_SLACK,
            "psum_ibytes": 0,
            "psum_scatter_fbytes": 0,
            "psum_scatter_ibytes": 0,
            "reduce_scatter_fbytes": 0,
            "reduce_scatter_ibytes": 0,
            "all_gather_fbytes": fb + _SCALAR_SLACK,
            "all_gather_ibytes": ib,
        }, float_reduce_ok=False)


@dataclass(frozen=True)
class ReduceScatterSum:
    """Reduce-scatter the snapped rotated chunks; coded shard re-gather.

    ``psum = reduce_scatter + all_gather``; carrying the sum as an explicit
    reduce-scatter leaves each rank its reduced shard, so the
    redistribution is encoded scatter-resident (see the module docstring).
    Falls back to the plain psum (exact, uncoded) when the chunk does not
    tile into valid per-shard block geometries (:func:`_shardable`) or
    outside the mesh.
    """
    name: str = "reduce_scatter"

    @staticmethod
    def _rs_ag(mesh, x, axis, n):
        d = x.shape[-1]
        if n <= 1 or d % n:
            return mesh.psum(x, axis)
        shard = mesh.psum_scatter(x, axis)
        return mesh.all_gather_tiled(shard, axis, x.dim() - 1)

    def lattice_sum(self, pipe, wire, codes, gammas, srv_rot, qy_own, mesh,
                    client_axis, in_mesh):
        if not in_mesh:
            return qy_own
        return self._rs_ag(mesh, qy_own, client_axis,
                           mesh.shape[client_axis])

    def lattice_fused_sum(self, pipe, wire, qy_own, srv_rot, gam_rs, u_rs,
                          mesh, client_axis):
        """Scatter-resident compressed redistribution of the client sum.

        ``gam_rs`` is the (1,) redistribution scale (the same on every rank:
        derived from psum'd hints); ``u_rs`` (1, d_pad / n) this rank's
        rounding noise. Returns the re-quantized (1, d_pad) rotated
        aggregate, identical on every rank (same gathered codes, same
        replicated reference)."""
        n = mesh.shape[client_axis]
        d_pad = qy_own.shape[-1]
        if not _shardable(d_pad, n, wire, pipe.block):
            return mesh.psum(qy_own, client_axis)
        d_sh = d_pad // n
        shard = mesh.psum_scatter(qy_own, client_axis)      # (1, d_sh)
        codes_sh = pipe.quantize(shard, u_rs, gam_rs, wire)
        # the wire: the codes in their container + the γ-shards row
        codes_all = mesh.all_gather(
            wire_mark(codes_sh[0].to(wire_container(wire)), channel="down",
                      part="codes", codec="wire", d=d_sh),
            client_axis)                                    # (n, d_sh/pack)
        gam_all = mesh.all_gather(
            wire_mark(gam_rs[0], channel="down", part="gamma", codec="wire",
                      d=d_sh), client_axis)                 # (n,) f32
        ref_sh = (float(n) * srv_rot).reshape(n, d_sh)
        qy_hat = pipe.snap(_from_container(codes_all, wire), ref_sh,
                           gam_all, wire)
        return qy_hat.reshape(1, d_pad)

    def generic_sum(self, quant, key, msg, srv, qy_own, mesh, client_axis,
                    in_mesh, n_slots):
        if not in_mesh:
            return qy_own
        return self._rs_ag(mesh, qy_own, client_axis, n_slots)

    def extra_bits_down(self, codec_up, codec_down, d: int, n: int) -> int:
        """The coded shard re-gather: every rank receives one
        downlink-width code message plus the n-1 other γ shards."""
        if not hasattr(codec_down, "wire"):
            return 0   # generic codec pair: plain rs+ag of fp32 partials
        blk = getattr(codec_down, "block", None)
        d_pad = pad_len(d) if blk is None else pad_len(d, blk)
        if not _shardable(d_pad, n, codec_down.wire(), blk):
            return 0   # exact-psum fallback: reduction traffic only
        return codec_down.message_bits(d) + (n - 1) * 32

    def wire_budget(self, codec_up, codec_down, d: int, n: int) -> WireBudget:
        """Fused path: one reduce-scatter of the fp32 partials + the coded
        shard re-gather at the downlink width."""
        dp = _leaf_dpad(codec_up, d)
        fused = (_lattice_pair(codec_up, codec_down)
                 and _shardable(dp, n, codec_down.wire(),
                                getattr(codec_down, "block", None)))
        if fused:
            codes = codec_down.wire_declaration(dp).part("codes")
            return WireBudget(caps={
                "psum_fbytes": _SCALAR_SLACK,
                "psum_ibytes": 0,
                "psum_scatter_fbytes": dp * 4,
                "psum_scatter_ibytes": 0,
                "reduce_scatter_fbytes": dp * 4,
                "reduce_scatter_ibytes": 0,
                # gathered: every rank ends with the full d_pad of codes
                # (n shards of d_sh) + the (n,) γ-shards row
                "all_gather_ibytes": codes.elems * (codes.container_bits
                                                    // 8),
                "all_gather_fbytes": n * 4 + _SCALAR_SLACK,
            }, float_reduce_ok=True)
        # generic pair / non-tiling geometry: rs+ag (or plain psum) of fp32
        return WireBudget(caps={
            "psum_fbytes": dp * 4 + _SCALAR_SLACK,
            "psum_ibytes": 0,
            "psum_scatter_fbytes": dp * 4,
            "psum_scatter_ibytes": 0,
            "reduce_scatter_fbytes": dp * 4,
            "reduce_scatter_ibytes": 0,
            "all_gather_fbytes": dp * 4 + _SCALAR_SLACK,
            "all_gather_ibytes": 0,
        }, float_reduce_ok=True)


_TRANSPORTS: Dict[str, object] = {
    "shard_local": ShardLocalPsum(),
    "code_allgather": CodeAllgather(),
    "reduce_scatter": ReduceScatterSum(),
}

# FedConfig.transport strings -> registry name of the client-sum strategy
# of the shard-local exchange. dequant_psum / code_allgather keep the
# whole-leaf composition of repro_torch.launch.steps; the shard_local*
# family runs repro_torch.core.exchange_local with the named strategy.
_MODE_MAP: Dict[str, str] = {
    "shard_local": "shard_local",
    "dequant_psum": "shard_local",
    "shard_local_codes": "code_allgather",
    "shard_local_rs": "reduce_scatter",
}


def registered_transports() -> Tuple[str, ...]:
    return tuple(_TRANSPORTS)


def register_transport(name: str, transport) -> None:
    if name in _TRANSPORTS:
        raise ValueError(f"transport {name!r} already registered")
    _TRANSPORTS[name] = transport


def make_transport(name: str):
    if name not in _TRANSPORTS:
        raise ValueError(f"unknown transport {name!r}; choose from "
                         f"{sorted(_TRANSPORTS)}")
    return _TRANSPORTS[name]


def transport_for_mode(fed_transport: str):
    """Map a ``FedConfig.transport`` string onto the shard-local exchange's
    client-sum strategy (``None`` = not a shard-local transport)."""
    name = _MODE_MAP.get(fed_transport)
    return make_transport(name) if name is not None else None
