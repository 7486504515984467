"""Shard-local quantized exchange (port of ``repro.core.exchange_local``).

The whole-leaf exchange rotates each parameter leaf in blocks that
straddle the ranks' blocks of it, so it needs the full leaf on every rank.
Blockwise rotation is valid for ANY partition into blocks, so here every
rank rotates, encodes and decodes only its LOCAL block of every leaf, as
the reference's ``shard_map`` body does, and the only collectives left are
the ones the algorithm requires:

  * the hint psums over the model axes (a scalar a leaf),
  * the client-sum of the server update, carried by a pluggable
    :class:`repro_torch.compression.transports` strategy (fp32 psum,
    all-gather of the codes, or the fused reduce-scatter with its
    scatter-resident coded re-gather),
  * the downlink hint's max over clients, and ``qerr``'s sums.

A rank's block is flattened row-major and padded to a multiple of 1024.
The randomness of a (round, leaf) is per model index ``mid`` (the rank's
position along the non-client axes, row-major): the rotation signs and the
downlink noise are the same on every client of a model index, so codes
stay decodable across clients, and the uplink noise (and the fused path's
per-shard noise) differs per client. The reference folds the leaf name and
then ``mid`` into its key, and the client index into the noise; here a
rank draws from two streams of its own (:class:`ExchangeStreams` of
``repro_torch.launch.steps``): ``model``, one generator per model index,
seeded alike on every client of it (signs, downlink noise, the generic
pair's keys), and ``rank``, one per (client, model index) (uplink noise,
the fused path's per-shard noise). Each round takes the next values of
each leaf from them, so a rank draws only its own blocks' randomness.
``draws`` injects them instead (a test feeds the reference's).

A lattice-family codec pair runs the rotated-space path through the
compression pipeline: 3 forward rotation passes a block (the fused
rotate+encode of Y, the server rotation that is the uplink decode
reference, the server's fused downlink encode, whose γ depends on the
decoded uplink), every snap and sum on rotated coordinates, and 2 inverse
rotations (the two new states). Any other codec pair runs the per-message
composition with the same collectives. The downlink Enc(X_t) is decoded
against the client's CURRENT model Y. ``qerr`` is summed over the model
axes and over the client axis.
"""
from __future__ import annotations

import torch

from repro_torch.compression.codecs import is_lattice_family
from repro_torch.compression.pipeline import ExchangePipeline, LatticeWire
from repro_torch.compression.rotation import pad_len, signs
from repro_torch.compression.transports import _shardable


def _pad1024(x: torch.Tensor):
    d = x.shape[0]
    pad = (-d) % 1024
    return (torch.nn.functional.pad(x, (0, pad)) if pad else x), d


def rs_gamma(pipe: ExchangePipeline, wire_dn: LatticeWire, h_sum, nrm_sum,
             d: int):
    """Redistribution scale of the scatter-resident coded downlink:
    ``h_sum``, the psum over clients of the per-client snap distances
    ‖QYᵢ − rot(X_t)‖, upper-bounds ‖Σᵢ QYᵢ − n·rot(X_t)‖ by the triangle
    inequality, so the aggregate meets the Lemma 3.1 wrap condition at this
    γ."""
    wire_rs = LatticeWire(bits=wire_dn.bits, pack=wire_dn.pack)
    return pipe.gammas(h_sum[None], nrm_sum[None], d, wire_rs), wire_rs


def make_shardlocal_exchange(quant_up, quant_down, mesh, client_axis: str,
                             n_slots: int, transport):
    """Returns ``exchange(server, clients, Ys, streams=None, draws=None)
    -> (server_new, clients_new, qerr)`` over this rank's blocks:
    ``server`` maps each leaf to its block, ``clients`` and ``Ys`` to (1,
    *block) (this rank's client slot). ``draws`` maps a leaf to its
    randomness on this rank: ``signs`` (d_pad,), ``u_up`` and ``u_dn`` (1,
    d_pad), ``u_rs`` (1, d_pad / n) on the fused reduce-scatter path, for a
    lattice pair; ``key_up`` and ``key_dn`` (one-row MessageKeys) for any
    other pair. Leaves not in ``draws`` draw from ``streams["model"]`` and
    ``streams["rank"]``.

    ``quant_up`` / ``quant_down`` are per-direction codecs; ``transport`` a
    :mod:`repro_torch.compression.transports` strategy carrying the uplink
    client-sum. The blocks arrive already cut by the leaves' specs (the
    reference takes the specs for its ``shard_map``)."""
    model_axes = tuple(a for a in mesh.axis_names if a != client_axis)
    client_in_mesh = client_axis in mesh.shape
    n_cl = mesh.shape[client_axis] if client_in_mesh else 1
    denom = n_slots + 1
    lattice_pair = (is_lattice_family(quant_up)
                    and is_lattice_family(quant_down))
    pipe = (ExchangePipeline(bits=quant_up.bits, block=quant_up.block,
                             safety=quant_up.safety,
                             backend=quant_up.backend)
            if lattice_pair else None)
    wire_up = quant_up.wire() if lattice_pair else None
    wire_dn = quant_down.wire() if lattice_pair else None
    fused_rs = getattr(transport, "lattice_fused_sum", None)

    def _psum_norm(sq):
        return torch.sqrt(mesh.psum(sq, model_axes))

    def _draw_lattice(streams, d: int):
        """One leaf's randomness on this rank, from its two streams."""
        d_pad = pad_len(d, pipe.block)
        g_model, g_rank = streams["model"], streams["rank"]
        r = {"signs": signs(g_model, d_pad),
             "u_dn": torch.rand((1, d_pad), generator=g_model,
                                device=g_model.device),
             "u_up": torch.rand((1, d_pad), generator=g_rank,
                                device=g_rank.device)}
        if (fused_rs is not None and client_in_mesh
                and _shardable(d_pad, n_cl, wire_dn, pipe.block)):
            r["u_rs"] = torch.rand((1, d_pad // n_cl), generator=g_rank,
                                   device=g_rank.device)
        return r

    def _draw_generic(streams, d: int):
        g = streams["model"]
        return {"key_up": quant_up.keys(g, 1, d),
                "key_dn": quant_down.keys(g, 1, d)}

    def _lattice_leaf(r, srv, y, cl_flat):
        """Rotated-space exchange of one local block: 3 forward + 2 inverse
        rotation passes with the block-shared signs (cl_flat only feeds the
        uplink hint; the downlink decodes against y)."""
        d = srv.shape[0]
        sg = r["signs"]
        # hints: ||Y - X^i|| over the model axes (client-local value)
        h_up = _psum_norm(torch.sum(torch.square(y - cl_flat))) + 1e-8
        gam_up = pipe.gammas(h_up[None], torch.linalg.vector_norm(y)[None],
                             d, wire_up)
        y_rot, codes = pipe.rotate_encode(y[None], sg, r["u_up"], gam_up,
                                          wire=wire_up)
        srv_rot = pipe.rotate(srv[None], sg)
        qy_own = pipe.snap(codes, srv_rot, gam_up, wire_up)      # rotated
        # per-client distance to the decode reference (feeds the downlink
        # hint and, summed over clients, the coded-redistribution scale)
        h_cl = _psum_norm(torch.sum(torch.square(qy_own - srv_rot)))
        if fused_rs is not None and client_in_mesh:
            h_rs = mesh.psum(h_cl, client_axis) + 1e-8
            nrm_rs = mesh.psum(
                _psum_norm(torch.sum(torch.square(qy_own))), client_axis)
            gam_rs, wire_rs = rs_gamma(pipe, wire_dn, h_rs, nrm_rs, d)
            qy_sum = fused_rs(pipe, wire_rs, qy_own, srv_rot, gam_rs,
                              r.get("u_rs"), mesh, client_axis)
        else:
            qy_sum = transport.lattice_sum(pipe, wire_up, codes, gam_up,
                                           srv_rot, qy_own, mesh,
                                           client_axis, client_in_mesh)
        del codes
        srv_new_rot = (srv_rot + qy_sum) / denom
        del qy_sum
        qerr = torch.sum(torch.square(qy_own[0] - y_rot[0])) / n_slots
        del qy_own, srv_rot

        # server -> client: encode once (the same on every client of this
        # model index), decode against the client's current model Y, all
        # in rotated space
        h_dn = mesh.pmax(h_cl, client_axis) if client_in_mesh else h_cl
        gam_dn = pipe.gammas(2.0 * h_dn[None] + 1e-8,
                             torch.linalg.vector_norm(srv)[None], d, wire_dn)
        codes_dn = pipe.rotate_encode(srv[None], sg, r["u_dn"], gam_dn,
                                      want_rotated=False, wire=wire_dn)
        qx_rot = pipe.snap(codes_dn, y_rot, gam_dn, wire_dn)
        del codes_dn
        cl_new_rot = qx_rot / denom + n_slots * y_rot / denom
        del qx_rot, y_rot
        srv_new = pipe.unrotate(srv_new_rot, sg, d)[0]
        cl_new = pipe.unrotate(cl_new_rot, sg, d)[0]
        return srv_new, cl_new, qerr

    def _generic_leaf(r, srv, y, cl_flat):
        """Per-message composition for codec pairs without a shared
        rotation structure (scalar / identity / top-k / mixed)."""
        h_up = _psum_norm(torch.sum(torch.square(y - cl_flat))) + 1e-8
        k_up = r["key_up"]
        msg = quant_up.encode(k_up, y[None], h_up[None])
        qy_own = quant_up.decode(k_up, msg, srv[None])[0]
        qy_sum = transport.generic_sum(quant_up, k_up, msg, srv[None],
                                       qy_own[None], mesh, client_axis,
                                       client_in_mesh, n_slots)[0]
        srv_new = (srv + qy_sum) / denom

        h_dn = _psum_norm(torch.sum(torch.square(qy_own - srv)))
        if client_in_mesh:
            h_dn = mesh.pmax(h_dn, client_axis)
        k_dn = r["key_dn"]
        msg_s = quant_down.encode(k_dn, srv[None], (2.0 * h_dn + 1e-8)[None])
        qx = quant_down.decode(k_dn, msg_s, cl_flat[None])[0]
        cl_new = qx / denom + n_slots * y / denom
        qerr = torch.sum(torch.square(qy_own - y)) / n_slots
        return srv_new, cl_new, qerr

    leaf_fn = _lattice_leaf if pipe is not None else _generic_leaf

    def exchange(server, clients, Ys, streams=None, draws=None):
        draws = draws or {}
        qerr = None
        server_new, clients_new = {}, {}
        for k in sorted(server):
            srv, _ = _pad1024(server[k].to(torch.float32).reshape(-1))
            y, dlen = _pad1024(Ys[k][0].to(torch.float32).reshape(-1))
            cl_flat, _ = _pad1024(clients[k][0].to(torch.float32)
                                  .reshape(-1))
            r = draws.get(k)
            if r is None:
                r = (_draw_lattice(streams, srv.shape[0]) if pipe is not None
                     else _draw_generic(streams, srv.shape[0]))
            srv_new, cl_new, qerr_k = leaf_fn(r, srv, y, cl_flat)
            del r, srv, y, cl_flat
            qerr = qerr_k if qerr is None else qerr + qerr_k
            shp = server[k].shape
            server_new[k] = srv_new[:dlen].reshape(shp).to(server[k].dtype)
            clients_new[k] = cl_new[:dlen].reshape((1,) + tuple(shp)).to(
                clients[k].dtype)
            del srv_new, cl_new
        # the leaves in the state's own order (the engine's capture
        # commits a round's outputs leaf by leaf in that order)
        server_new = {k: server_new[k] for k in server}
        clients_new = {k: clients_new[k] for k in server}
        qerr = mesh.psum(qerr, model_axes)
        # qerr differs per client slot (each rank quantizes its own Y^i):
        # the sum over clients, never one slot's value
        if client_in_mesh:
            qerr = mesh.psum(qerr, client_axis)
        return server_new, clients_new, qerr

    return exchange
