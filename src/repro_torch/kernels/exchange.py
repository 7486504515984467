"""Rotated-space lattice exchange: CUDA kernels and their plain versions
(port of ``repro.kernels.exchange``).

Four kernels port the reference's QuAFL round and a fifth,
``fused_decode``, the per-message codec API of the baselines. Two more,
``uplink`` and ``average``, have no reference kernel: they are the snap
with the fp32 passes the round runs around it (the server average and the
error norms of the uplink; the clients' average of the downlink), so the
rotated-space round never writes the snapped rows to device memory. Each
has a plain PyTorch version here (``*_plain``, any device) and a wrapper
(under the reference's name where it has one) that launches the CUDA kernel
of ``csrc/exchange.cu`` on a CUDA tensor, runs the plain version on a CPU
tensor, and raises on anything else. Every wrapper counts its launches in
:data:`LAUNCHES`.

Codes differ from the reference in dtype only: unpacked codes are int32
(the reference's uint32; every code is below 2^bits <= 2^16, so the values
are the same) and packed codes uint8 with the reference's layout, ``8 //
bits`` codes per byte along the r axis of each (r, c) Hadamard block.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from repro_torch.compression.rotation import (DEFAULT_BLOCK, _block_size,
                                              _factor, pad_len)
from repro_torch.kernels import build
from repro_torch.utils import spans

# Launches of each kernel since the last reset_launches(); a wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"fused_encode": 0, "fused_rotate": 0, "quantize_codes": 0,
            "snap_codes": 0, "fused_decode": 0, "uplink": 0, "average": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_geometry(d: int, block: int = DEFAULT_BLOCK):
    """(b, d_pad, r, c, nb) for a length-d vector under ``block``-blocking."""
    b = _block_size(d, block)
    d_pad = pad_len(d, block)
    r, c = _factor(b)
    return b, d_pad, r, c, d_pad // b


def _check_pack(pack: int, bits: int, r: int):
    if pack == 1:
        return
    if pack * bits != 8:
        raise ValueError(f"pack={pack} requires pack*bits == 8 "
                         f"(got bits={bits})")
    if r % pack:
        raise ValueError(f"pack={pack} does not divide the Hadamard "
                         f"sublane factor r={r}; vector too small to pack")


def _shifts(pack: int, bits: int, device) -> torch.Tensor:
    return (torch.arange(pack, dtype=torch.int32, device=device)
            * bits).reshape(1, 1, 1, pack, 1)


def pack_codes(codes2: torch.Tensor, *, bits: int,
               block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """(m, d_pad) codes -> (m, d_pad // (8//bits)) uint8, packed along the
    r axis of each (r, c) block — the ``lattice_packed`` wire layout."""
    pack = 8 // bits
    m, d_pad = codes2.shape
    _, _, r, c, nb = block_geometry(d_pad, block)
    _check_pack(pack, bits, r)
    x = codes2.to(torch.int32).reshape(m, nb, r // pack, pack, c)
    packed = (x << _shifts(pack, bits, x.device)).sum(dim=3)
    return packed.to(torch.uint8).reshape(m, d_pad // pack)


def unpack_codes(packed2: torch.Tensor, *, bits: int,
                 block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (m, d_pad//pack) uint8 -> (m, d_pad)
    int32."""
    pack = 8 // bits
    m, dp = packed2.shape
    d_pad = dp * pack
    _, _, r, c, nb = block_geometry(d_pad, block)
    _check_pack(pack, bits, r)
    x = packed2.to(torch.int32).reshape(m, nb, r // pack, 1, c)
    mask = (1 << bits) - 1
    return ((x >> _shifts(pack, bits, x.device)) & mask).reshape(m, d_pad)


@lru_cache(maxsize=64)
def _scale(b: int) -> float:
    """1/sqrt(b) rounded to fp32, the value both versions multiply by."""
    return float(np.float32(1.0 / np.sqrt(b)))


def _modulus(bits: int, levels2):
    """Wrap/snap modulus: the static 2^bits, or per-message (m, 1) rows."""
    if levels2 is None:
        return float(1 << bits)
    return levels2.to(torch.float32).reshape(-1, 1)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------

def _fwht(x: torch.Tensor) -> torch.Tensor:
    """Unscaled Sylvester transform along the last axis (a power of two),
    as radix-2 butterfly stages h = 1, 2, 4, ... — the CUDA kernel's stages
    in the kernel's order, so both round identically."""
    shape = x.shape
    b = shape[-1]
    rows = x.numel() // b
    h = 1
    while h < b:
        v = x.reshape(rows, b // (2 * h), 2, h)
        a, c = v[:, :, 0], v[:, :, 1]
        x = torch.stack((a + c, a - c), dim=2)
        h *= 2
    return x.reshape(shape)


def rotate_plain(x2, signs, *, block=DEFAULT_BLOCK, inverse=False):
    """Batched randomized-Hadamard rotation: (m, d_pad) -> (m, d_pad).
    Forward: signs, then H_b / sqrt(b) per block; inverse: H first.
    ``signs`` is one (d_pad,) row or (m, d_pad) rows, and broadcasts."""
    b = block_geometry(x2.shape[-1], block)[0]
    x = x2.to(torch.float32)
    if not inverse:
        x = x * signs
    y = _fwht(x.reshape(-1, b)).reshape(x.shape) * _scale(b)
    return y * signs if inverse else y


def _quantize(y2, u2, gammas, bits, levels2):
    g = gammas.to(torch.float32).reshape(-1, 1)
    lv = _modulus(bits, levels2)
    q = torch.floor(y2 / g + u2)
    return (q - lv * torch.floor(q / lv)).to(torch.int32)


def quantize_plain(y2, u2, gammas, *, bits=8, block=DEFAULT_BLOCK, pack=1,
                   levels2=None):
    """floor(y/γ + u) mod L of already-rotated coordinates (floored modulo,
    as ``jnp.mod``), packed when ``pack > 1``."""
    codes = _quantize(y2.to(torch.float32), u2, gammas, bits, levels2)
    return pack_codes(codes, bits=bits, block=block) if pack > 1 else codes


def encode_plain(x2, signs, u2, gammas, *, bits=8, block=DEFAULT_BLOCK,
                 want_rotated=False, pack=1, levels2=None):
    """Rotate + stochastic round + wrap; (rotated, codes) when
    ``want_rotated``."""
    y = rotate_plain(x2, signs, block=block)
    codes = quantize_plain(y, u2, gammas, bits=bits, block=block, pack=pack,
                           levels2=levels2)
    return (y, codes) if want_rotated else codes


def snap_plain(codes2, wrot2, gammas, *, bits=8, block=DEFAULT_BLOCK, pack=1,
               levels2=None):
    """Positional snap in rotated space: γ·(c + L·round((w/γ − c)/L)), round
    half to even; codes and references broadcast along the message axis."""
    if pack > 1:
        codes2 = unpack_codes(codes2, bits=bits, block=block)
    cc = codes2.to(torch.float32)
    g = gammas.to(torch.float32).reshape(-1, 1)
    lv = _modulus(bits, levels2)
    q = cc + lv * torch.round((wrot2 / g - cc) / lv)
    return q * g


# the (s+1)-averaging modes of a QuAFL round
AVG_MODES = ("both", "server_only", "client_only", "none")


def _avg_flags(avg_mode: str):
    """(the server average keeps the server's own share, the clients'
    average keeps theirs) of an averaging mode."""
    if avg_mode not in AVG_MODES:
        raise ValueError(f"avg_mode={avg_mode!r}; choose from {AVG_MODES}")
    return avg_mode in ("both", "server_only"), avg_mode in ("both",
                                                             "client_only")


def _row_norms(x2):
    return torch.linalg.vector_norm(x2, dim=1)


def _div(x, n: int):
    """x / n in place, correctly rounded on every device (the card divides
    by a host scalar as a product with its reciprocal), as the kernels'
    ``__fdiv_rn``."""
    return x.div_(torch.full((), float(n), dtype=x.dtype, device=x.device))


def uplink_plain(codes2, srv_rot, y_rot, gammas, *, bits=8,
                 block=DEFAULT_BLOCK, pack=1, levels2=None, avg_mode="both"):
    """The uplink of a rotated-space round: each of the s code rows snapped
    against the one rotated server row, QY_i; the server average (srv +
    Σ_i QY_i) / (s+1) (``both``, ``server_only``) or Σ_i QY_i / s, the rows
    summed in ascending order; rel_err = mean_i ‖QY_i − Y_i‖ / (‖Y_i‖ +
    1e-9) and hint_srv = max_i ‖QY_i − srv‖ + 1e-8. Returns (srv_new
    (d_pad,), rel_err, hint_srv)."""
    with_server, _ = _avg_flags(avg_mode)
    s = y_rot.shape[0]
    qy = snap_plain(codes2, srv_rot, gammas, bits=bits, block=block,
                    pack=pack, levels2=levels2)
    acc = torch.zeros_like(srv_rot[0])
    for row in qy:
        acc = acc + row
    srv_new = _div(srv_rot[0] + acc, s + 1) if with_server else _div(acc, s)
    rel_err = torch.mean(_row_norms(qy - y_rot)
                         / (_row_norms(y_rot) + 1e-9))
    hint_srv = torch.max(_row_norms(qy - srv_rot)) + 1e-8
    return srv_new, rel_err, hint_srv


def average_plain(codes2, y_rot, gammas, *, bits=8, block=DEFAULT_BLOCK,
                  pack=1, levels2=None, avg_mode="both"):
    """The downlink of a rotated-space round, in place: the one code row
    snapped against each of the s rows of ``y_rot``, QX_i, and ``y_rot``
    overwritten with QX_i / (s+1) + (s·Y_i) / (s+1) (``both``,
    ``client_only``) or QX_i. Returns ``y_rot``."""
    _, mix = _avg_flags(avg_mode)
    s = y_rot.shape[0]
    qx = snap_plain(codes2, y_rot, gammas, bits=bits, block=block, pack=pack,
                    levels2=levels2)
    if not mix:
        return y_rot.copy_(qx)
    return _div(y_rot.mul_(s), s + 1).add_(_div(qx, s + 1))


def decode_plain(codes2, ref2, signs, gammas, *, bits=8, block=DEFAULT_BLOCK,
                 pack=1, levels2=None):
    """Full Dec(ref, msg): rotate the reference, snap, inverse-rotate;
    (max(mc, mr), d_pad) in original coordinates. Codes, references and
    (m, d_pad) sign rows broadcast along the message axis."""
    w = rotate_plain(ref2, signs, block=block)
    q = snap_plain(codes2, w, gammas, bits=bits, block=block, pack=pack,
                   levels2=levels2)
    return rotate_plain(q, signs, block=block, inverse=True)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "exch_rotate": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "exch_encode": [_P, _P, _I, _P, _P, _I, _P, _I, _F, _P, _P, _P, _I, _I,
                    _I, _I, _I, _I, _F, _I, _P],
    "exch_quantize": [_P, _P, _P, _I, _P, _I, _F, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _P],
    "exch_snap": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _F, _P, _I, _I, _I,
                  _I, _I, _I, _P],
    "exch_decode": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _F, _P, _I,
                    _I, _I, _I, _I, _I, _F, _I, _P],
    "exch_uplink": [_P, _P, _P, _P, _P, _I, _P, _I, _F, _P, _P, _P, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _P],
    "exch_average": [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
}
# the largest block one CTA holds in shared memory (227 KB on Hopper)
_MAX_SHARED_BLOCK = 232_448 // 4
# fused_rotate, fused_encode and fused_decode split a Hadamard block across
# a cluster of CTAs, each holding a chunk of _CHUNK coordinates (8 a
# thread), at most _MAX_CLUSTER of them (the portable cluster size)
_CHUNK, _MAX_CLUSTER = 2048, 8
# snap_codes and quantize_codes: 8 coordinates or packed bytes a thread,
# _VEC_THREADS threads a CTA (kVecThreads in csrc/exchange.cu); a quantize
# launch that would start fewer than _FILL threads (half an H100's 270,336
# resident threads) takes 2 outputs a thread
_VEC_THREADS, _FILL = 256, 1 << 17
# uplink: at most one wave of CTAs (an H100's 132 SMs, 8 CTAs of 256 threads
# each), each striding over chunks of 8 · _VEC_THREADS coordinates
_WAVE_CTAS = 132 * 8


# the launchers take m and d_pad as C ints and round d_pad up to a CTA's
# span of coordinates (at most 8 · _VEC_THREADS) in int arithmetic
INT_MAX = 2**31 - 1
MAX_D_PAD = INT_MAX - 8 * _VEC_THREADS + 1


def check_launch_ints(m: int, d_pad: int) -> None:
    """Refuse a launch whose message count ``m`` or padded length
    ``d_pad`` the kernels' int arguments cannot hold (they would wrap);
    offsets over the whole (m, d_pad) tensor are 64-bit in the kernels."""
    if not 0 <= m <= INT_MAX:
        raise ValueError(f"m={m} messages: the exchange kernels take m as "
                         f"a C int, at most {INT_MAX}")
    if not 0 <= d_pad <= MAX_D_PAD:
        raise ValueError(f"d_pad={d_pad}: the exchange kernels take d_pad "
                         f"as a C int and round it up to a CTA's span, so "
                         f"it may be at most {MAX_D_PAD} (2**31 - "
                         f"{8 * _VEC_THREADS}) coordinates a message")


def library():
    """The built and loaded ``csrc/exchange.cu``."""
    return build.load("exchange", _SIGNATURES)


def _require(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _sign_stride(signs, m, d_pad):
    """One (d_pad,) sign row for every message (stride 0) or (m, d_pad)
    rows, one per message (stride d_pad)."""
    if signs.dim() == 1:
        _require(signs, "signs", torch.float32, (d_pad,))
        return 0
    _require(signs, "signs", torch.float32, (m, d_pad))
    return d_pad


def _row(t, name, m):
    """A per-message scalar row (γ or levels) of length 1 or m; returns its
    stride in the kernel (0 broadcasts the single value)."""
    if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D float32 row")
    if t.numel() not in (1, m):
        raise ValueError(f"{name}: {t.numel()} values for {m} messages")
    return 0 if t.numel() == 1 else 1


@lru_cache(maxsize=64)
def _geometry(d_pad, block, bits, pack):
    """(b, c) of a launch, validated; cached, as the wrappers' host time
    is most of a call at the main path's sizes."""
    b, dp, r, c, nb = block_geometry(d_pad, block)
    if dp != d_pad:
        raise ValueError(f"d_pad={d_pad} is not a multiple of its block {b}")
    if b > _MAX_SHARED_BLOCK:
        raise ValueError(f"block {b} exceeds one CTA's shared memory")
    if not 1 <= bits <= 16:
        raise ValueError(f"bits={bits} outside 1..16")
    _check_pack(pack, bits, r)
    return b, c


def cluster_size(b: int, r: int, pack: int) -> int:
    """CTAs in the cluster that holds one b-block in ``fused_rotate``
    (pack 1), ``fused_encode`` and ``fused_decode``: b / 2,048, at most 8,
    and at most r / pack, so that each CTA's chunk of the (r, c) block
    holds whole groups of ``pack`` rows (a packed byte never spans two
    CTAs); 1 for b <= 2,048."""
    return max(1, min(_MAX_CLUSTER, b // _CHUNK, r // pack))


def launch_geometry(m: int, d_pad: int, *, block=DEFAULT_BLOCK, pack=1):
    """The grid of a ``fused_rotate`` (pack 1), ``fused_encode`` or
    ``fused_decode`` launch on m messages: cluster size, CTAs, threads a CTA
    and coordinates a CTA."""
    b, _, r, _, nb = block_geometry(d_pad, block)
    cluster = cluster_size(b, r, pack)
    chunk = b // cluster
    return {"cluster": cluster, "ctas": m * nb * cluster,
            "threads": max(32, chunk // 8), "chunk": chunk}


@lru_cache(maxsize=64)
def _cluster(d_pad, block, pack):
    return launch_geometry(1, d_pad, block=block, pack=pack)["cluster"]


def snap_geometry(m: int, d_pad: int):
    """The grid of a ``snap_codes`` launch with m output rows: CTAs and
    threads a CTA, 8 coordinates a thread."""
    per_cta = 8 * _VEC_THREADS
    return {"ctas": m * -(-d_pad // per_cta), "threads": _VEC_THREADS}


@lru_cache(maxsize=64)
def quantize_geometry(m: int, d_pad: int, *, pack: int = 1):
    """The grid of a ``quantize_codes`` launch on m messages: outputs
    (codes, or packed bytes) a thread, 8, or 2 where 8 would start fewer
    than ``_FILL`` threads (a small launch is bound by each thread's
    latency); CTAs of 256 threads. Cached, as ``_geometry``."""
    per = d_pad // pack
    v = 8 if m * -(-per // 8) >= _FILL else 2
    return {"ctas": m * -(-per // (v * _VEC_THREADS)),
            "threads": _VEC_THREADS, "per_thread": v}


@build.costed(build.no_flops)
def fused_rotate(x2, signs, *, block=DEFAULT_BLOCK, inverse=False):
    """Batched randomized-Hadamard rotation (m, d_pad) -> (m, d_pad).

    Replaces ``repro/kernels/exchange.py`` · ``fused_rotate``
    (``_rotate_kernel``, two MXU matmuls per (r, c) block). Bound on the
    H100: bytes, 8 per coordinate (read x, write y); at the paths' 1-16
    messages, latency. Design: ``fused_encode``'s butterfly alone, a
    cluster of :func:`cluster_size` CTAs a block (2,048 coordinates a CTA,
    8 a thread; 16 CTAs for one message of two 16,384-blocks), so each
    coordinate crosses device memory once each way.
    """
    if build.on_meta(x2, signs):
        return torch.empty_like(x2)
    if build.on_cpu(x2, signs):
        return rotate_plain(x2, signs, block=block, inverse=inverse)
    m, d_pad = x2.shape
    check_launch_ints(m, d_pad)
    b, _ = _geometry(d_pad, block, 8, 1)
    cluster = _cluster(d_pad, block, 1)
    _require(x2, "x2", torch.float32, (m, d_pad))
    _require(signs, "signs", torch.float32, (d_pad,))
    out = torch.empty_like(x2)
    LAUNCHES["fused_rotate"] += 1
    build.check(library().exch_rotate(
        build.ptr(x2), build.ptr(signs), build.ptr(out), m, d_pad, b,
        int(inverse), _scale(b), cluster, build.stream()), "exch_rotate")
    return out


def _code_outputs(m, d_pad, pack, device):
    if pack == 1:
        return torch.empty((m, d_pad), dtype=torch.int32, device=device), None
    return None, torch.empty((m, d_pad // pack), dtype=torch.uint8,
                             device=device)


def _levels_args(levels2, bits, m):
    if levels2 is None:
        return None, 0, float(1 << bits)
    return levels2, _row(levels2, "levels2", m), 0.0


@build.costed(build.no_flops)
def fused_encode(x2, signs, u2, gammas, *, bits=8, block=DEFAULT_BLOCK,
                 want_rotated=False, pack=1, levels2=None):
    """Rotate + stochastic round + wrap in one pass; returns codes, or
    (rotated, codes) when ``want_rotated``. ``signs`` is one (d_pad,) row
    for every message or (m, d_pad) rows, one per message.

    Replaces ``repro/kernels/exchange.py`` · ``fused_encode``
    (``_encode_kernel``). Bound on the H100: bytes, 16 per coordinate with
    y kept (x, u, y, int32 codes); at the paths' 1-16 messages, latency.
    Design: a cluster of :func:`cluster_size` CTAs holds each block (2,048
    coordinates a CTA, 8 a thread), runs the butterfly in registers, across
    lanes, through shared memory and last across the cluster's shared
    memory, and keeps the rotated block on the SMs through the quantize and
    the packing, so y is written once (for the decode reference) and never
    read back.
    """
    if build.on_meta(x2, signs, u2, gammas, levels2):
        codes32, codes8 = _code_outputs(*x2.shape, pack, x2.device)
        codes = codes32 if pack == 1 else codes8
        return (torch.empty_like(x2), codes) if want_rotated else codes
    if build.on_cpu(x2, signs, u2, gammas, levels2):
        return encode_plain(x2, signs, u2, gammas, bits=bits, block=block,
                            want_rotated=want_rotated, pack=pack,
                            levels2=levels2)
    m, d_pad = x2.shape
    check_launch_ints(m, d_pad)
    b, c = _geometry(d_pad, block, bits, pack)
    cluster = _cluster(d_pad, block, pack)
    _require(x2, "x2", torch.float32, (m, d_pad))
    s_stride = _sign_stride(signs, m, d_pad)
    _require(u2, "u2", torch.float32, (m, d_pad))
    if gammas.numel() != m:
        raise ValueError(f"gammas: {gammas.numel()} values for {m} messages")
    g_stride = _row(gammas, "gammas", m)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, m)
    codes32, codes8 = _code_outputs(m, d_pad, pack, x2.device)
    y = torch.empty_like(x2) if want_rotated else None
    LAUNCHES["fused_encode"] += 1
    build.check(library().exch_encode(
        build.ptr(x2), build.ptr(signs), s_stride, build.ptr(u2),
        build.ptr(gammas), g_stride, build.ptr(lv), lv_stride, lv_default,
        build.ptr(codes32), build.ptr(codes8), build.ptr(y), m, d_pad, b, c,
        bits, pack, _scale(b), cluster, build.stream()), "exch_encode")
    codes = codes32 if pack == 1 else codes8
    return (y, codes) if want_rotated else codes


@build.costed(build.no_flops)
def quantize_codes(y2, u2, gammas, *, bits=8, block=DEFAULT_BLOCK, pack=1,
                   levels2=None):
    """Stochastic round + wrap of already-rotated coordinates.

    Replaces ``repro/kernels/exchange.py`` · ``quantize_codes``
    (``_quantize_kernel``). Bound on the H100: bytes, 12 per coordinate
    (y, u, int32 codes; 8 and a share of a byte packed). Design: a CTA of
    256 threads on one message row, 8 contiguous outputs a thread, γ and L
    read once a thread: y, u and int32 codes move 16 bytes at a time, and
    a thread's 8 packed bytes (8 columns of one packed row of an (r, c)
    block when c is a multiple of 8) are OR-ed from ``pack`` rows of 8
    floats and stored in one 8-byte store; byte by byte for c < 8. The
    arithmetic is ``fused_encode``'s, bit for bit. A launch too small to
    fill the card takes fewer outputs a thread (:func:`quantize_geometry`:
    two at the downlink's 1 × 32,768).
    """
    if build.on_meta(y2, u2, gammas, levels2):
        codes32, codes8 = _code_outputs(*y2.shape, pack, y2.device)
        return codes32 if pack == 1 else codes8
    if build.on_cpu(y2, u2, gammas, levels2):
        return quantize_plain(y2, u2, gammas, bits=bits, block=block,
                              pack=pack, levels2=levels2)
    m, d_pad = y2.shape
    return _launch_quantize(
        y2, u2, gammas, bits, block, pack, levels2,
        quantize_geometry(m, d_pad, pack=pack)["per_thread"])


def _launch_quantize(y2, u2, gammas, bits, block, pack, levels2,
                     per_thread):
    """The quantize kernel on CUDA tensors, ``per_thread`` (2 or 8)
    outputs a thread."""
    m, d_pad = y2.shape
    check_launch_ints(m, d_pad)
    b, c = _geometry(d_pad, block, bits, pack)
    _require(y2, "y2", torch.float32, (m, d_pad))
    _require(u2, "u2", torch.float32, (m, d_pad))
    g_stride = _row(gammas, "gammas", m)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, m)
    codes32, codes8 = _code_outputs(m, d_pad, pack, y2.device)
    LAUNCHES["quantize_codes"] += 1
    build.check(library().exch_quantize(
        build.ptr(y2), build.ptr(u2), build.ptr(gammas), g_stride,
        build.ptr(lv), lv_stride, lv_default, build.ptr(codes32),
        build.ptr(codes8), m, d_pad, b, c, bits, pack, per_thread,
        build.stream()), "exch_quantize")
    return codes32 if pack == 1 else codes8


@build.costed(build.no_flops)
def snap_codes(codes2, wrot2, gammas, *, bits=8, block=DEFAULT_BLOCK, pack=1,
               levels2=None):
    """Positional snap in rotated space, γ·(c + L·round((w/γ − c)/L)).

    ``codes2`` (mc, d_pad // pack) and ``wrot2`` (mw, d_pad) broadcast along
    the message axis (mc or mw may be 1); ``gammas`` and ``levels2`` hold 1
    or max(mc, mw) values. Replaces ``repro/kernels/exchange.py`` ·
    ``snap_codes`` (``_snap_kernel``). Bound on the H100: bytes, 8 per
    output coordinate (int32 code or packed byte share, fp32 output) plus
    the broadcast side read once. Design: a CTA of 256 threads on one
    message row, 8 contiguous coordinates a thread, γ and L read once a
    thread; codes, references and outputs move 16 bytes at a time, and a
    thread's packed codes (8 columns of one row of an (r, c) block when c
    is a multiple of 8) in one 8-byte load; byte by byte for c < 8.
    """
    if build.on_meta(codes2, wrot2, gammas, levels2):
        return wrot2.new_empty((max(codes2.shape[0], wrot2.shape[0]),
                                wrot2.shape[1]))
    if build.on_cpu(codes2, wrot2, gammas, levels2):
        return snap_plain(codes2, wrot2, gammas, bits=bits, block=block,
                          pack=pack, levels2=levels2)
    mc, d_padp = codes2.shape
    mw, d_pad = wrot2.shape
    m = max(mc, mw)
    if d_padp * pack != d_pad or min(mc, mw) not in (1, m):
        raise ValueError(f"codes {tuple(codes2.shape)} (pack={pack}) do not "
                         f"broadcast against refs {tuple(wrot2.shape)}")
    check_launch_ints(m, d_pad)
    b, c = _geometry(d_pad, block, bits, pack)
    _require(codes2, "codes2", torch.int32 if pack == 1 else torch.uint8,
             (mc, d_padp))
    _require(wrot2, "wrot2", torch.float32, (mw, d_pad))
    g_stride = _row(gammas, "gammas", m)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, m)
    out = torch.empty((m, d_pad), dtype=torch.float32, device=wrot2.device)
    c32, c8 = (codes2, None) if pack == 1 else (None, codes2)
    LAUNCHES["snap_codes"] += 1
    build.check(library().exch_snap(
        build.ptr(c32), build.ptr(c8), mc, build.ptr(wrot2), mw,
        build.ptr(gammas), g_stride, build.ptr(lv), lv_stride, lv_default,
        build.ptr(out), m, d_pad, b, c, bits, pack, build.stream()),
        "exch_snap")
    return out


@build.costed(build.no_flops)
def fused_decode(codes2, ref2, signs, gammas, *, bits=8, block=DEFAULT_BLOCK,
                 pack=1, levels2=None):
    """Full Dec(ref, msg) in one pass: rotate the reference, snap each code
    to the representative nearest it, inverse-rotate.

    ``codes2`` (mc, d_pad // pack) against references ``ref2`` (mr, d_pad)
    in original coordinates; either may be 1 and broadcasts. ``signs`` is
    one (d_pad,) row or (m, d_pad) rows, m = max(mc, mr); ``gammas`` and
    ``levels2`` hold 1 or m values. Returns (m, d_pad) fp32.

    Replaces ``repro/kernels/exchange.py`` · ``fused_decode``
    (``_decode_kernel``, four MXU matmuls per (r, c) block). Bound on the
    H100: bytes, 8 per output coordinate (int32 code or packed byte share,
    fp32 output) plus the broadcast side and the shared signs read once; at
    the paths' one message, latency. Design: a cluster of
    :func:`cluster_size` CTAs holds each (message, block) pair on the SMs
    from the reference's rotation through the snap to the inverse rotation,
    two butterflies as ``fused_encode``'s (each with its own exchange across
    the cluster), so neither the rotated reference nor the snapped point
    touches device memory.
    """
    if build.on_meta(codes2, ref2, signs, gammas, levels2):
        return ref2.new_empty((max(codes2.shape[0], ref2.shape[0]),
                               ref2.shape[1]))
    if build.on_cpu(codes2, ref2, signs, gammas, levels2):
        return decode_plain(codes2, ref2, signs, gammas, bits=bits,
                            block=block, pack=pack, levels2=levels2)
    mc, d_padp = codes2.shape
    mr, d_pad = ref2.shape
    m = max(mc, mr)
    if d_padp * pack != d_pad or min(mc, mr) not in (1, m):
        raise ValueError(f"codes {tuple(codes2.shape)} (pack={pack}) do not "
                         f"broadcast against refs {tuple(ref2.shape)}")
    check_launch_ints(m, d_pad)
    b, c = _geometry(d_pad, block, bits, pack)
    cluster = _cluster(d_pad, block, pack)
    _require(codes2, "codes2", torch.int32 if pack == 1 else torch.uint8,
             (mc, d_padp))
    _require(ref2, "ref2", torch.float32, (mr, d_pad))
    s_stride = _sign_stride(signs, m, d_pad)
    g_stride = _row(gammas, "gammas", m)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, m)
    out = torch.empty((m, d_pad), dtype=torch.float32, device=ref2.device)
    c32, c8 = (codes2, None) if pack == 1 else (None, codes2)
    LAUNCHES["fused_decode"] += 1
    build.check(library().exch_decode(
        build.ptr(c32), build.ptr(c8), mc, build.ptr(ref2), mr,
        build.ptr(signs), s_stride, build.ptr(gammas), g_stride, build.ptr(lv),
        lv_stride, lv_default, build.ptr(out), m, d_pad, b, c, bits, pack,
        _scale(b), cluster, build.stream()), "exch_decode")
    return out


def uplink_geometry(s: int, d_pad: int):
    """The grid of an ``uplink`` launch on s messages: coordinates a
    thread (8, or 1 where 8 would start fewer than ``_FILL`` threads: each
    thread takes all s messages in turn, so a small launch is bound by its
    latency), CTAs of 256 threads (one per chunk, at most one wave of
    ``_WAVE_CTAS``; shapes alone, so every launch of a shape sums in the
    same order), and the scratch floats (3·s partials a CTA)."""
    v = 8 if -(-d_pad // 8) >= _FILL else 1
    ctas = max(1, min(-(-d_pad // (v * _VEC_THREADS)), _WAVE_CTAS))
    return {"ctas": ctas, "threads": _VEC_THREADS, "per_thread": v,
            "scratch": 3 * s * ctas}


def average_geometry(m: int, d_pad: int):
    """The grid of an ``average`` launch on m messages: CTAs along the
    coordinates (8 · 256 a CTA) and along the messages, as few of the
    latter as fill one wave (each thread reads its codes once for the
    messages it takes), at least 1, at most m and 65,535."""
    chunks = -(-d_pad // (8 * _VEC_THREADS))
    rows = max(1, min(m, -(-_WAVE_CTAS // max(chunks, 1)), 65_535))
    return {"ctas": chunks * rows, "rows": rows, "threads": _VEC_THREADS}


def _code_rows(codes2, m, d_pad, pack):
    _require(codes2, "codes2", torch.int32 if pack == 1 else torch.uint8,
             (m, d_pad // pack))
    return (codes2, None) if pack == 1 else (None, codes2)


@build.costed(build.no_flops)
def uplink(codes2, srv_rot, y_rot, gammas, *, bits=8, block=DEFAULT_BLOCK,
           pack=1, levels2=None, avg_mode="both"):
    """The uplink of a rotated-space QuAFL round in one pass: the snap of
    the s code rows ``codes2`` (s, d_pad // pack) against the rotated
    server ``srv_rot`` (1, d_pad), the server average and the round's error
    norms against ``y_rot`` (s, d_pad) (:func:`uplink_plain`). ``gammas``
    and ``levels2`` hold 1 or s values. Returns (srv_new (d_pad,), rel_err,
    hint_srv), the last two 0-d, all on the device.

    Replaces no reference kernel: the snap ``snap_codes`` with the passes
    the round ran on its output (the server's sum, two differences, three
    norms). Bound on the H100: bytes, 8·s + 8 per coordinate (s codes, s
    rows of Y, the server in, the average out; packed codes a share of a
    byte). Design: ``snap_vec_kernel``'s 8 coordinates a thread (1 on a
    launch too small to fill the card), taken through all s messages, so
    the snapped rows stay in registers; each message's three sums of
    squares per warp, then per CTA into a scratch row (at most one wave of
    CTAs, :func:`uplink_geometry`), and a one-CTA finish sums the CTAs'
    partials in a fixed order (no atomics: a launch repeats bit for bit)
    into rel_err and hint_srv on the device, so nothing reads back to the
    host and a captured chunk still captures.
    """
    if build.on_meta(codes2, srv_rot, y_rot, gammas, levels2):
        return (srv_rot.new_empty((srv_rot.shape[-1],)),
                srv_rot.new_empty(()), srv_rot.new_empty(()))
    if build.on_cpu(codes2, srv_rot, y_rot, gammas, levels2):
        return uplink_plain(codes2, srv_rot, y_rot, gammas, bits=bits,
                            block=block, pack=pack, levels2=levels2,
                            avg_mode=avg_mode)
    with_server, _ = _avg_flags(avg_mode)
    s, d_pad = y_rot.shape
    if s < 1:
        raise ValueError("uplink: no message")
    check_launch_ints(s, d_pad)
    b, c = _geometry(d_pad, block, bits, pack)
    c32, c8 = _code_rows(codes2, s, d_pad, pack)
    _require(srv_rot, "srv_rot", torch.float32, (1, d_pad))
    _require(y_rot, "y_rot", torch.float32, (s, d_pad))
    g_stride = _row(gammas, "gammas", s)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, s)
    geo = uplink_geometry(s, d_pad)
    out = torch.empty((d_pad,), dtype=torch.float32, device=y_rot.device)
    scratch = torch.empty((geo["scratch"],), dtype=torch.float32,
                          device=y_rot.device)
    stats = torch.empty((2,), dtype=torch.float32, device=y_rot.device)
    LAUNCHES["uplink"] += 1
    spans.count("exchange.fused_average", 1)
    build.check(library().exch_uplink(
        build.ptr(c32), build.ptr(c8), build.ptr(srv_rot), build.ptr(y_rot),
        build.ptr(gammas), g_stride, build.ptr(lv), lv_stride, lv_default,
        build.ptr(out), build.ptr(scratch), build.ptr(stats), s, d_pad, b, c,
        bits, pack, int(with_server), geo["ctas"], geo["per_thread"],
        build.stream()), "exch_uplink")
    return out, stats[0], stats[1]


@build.costed(build.no_flops)
def average(codes2, y_rot, gammas, *, bits=8, block=DEFAULT_BLOCK, pack=1,
            levels2=None, avg_mode="both"):
    """The downlink of a rotated-space QuAFL round in one pass, in place:
    the one code row ``codes2`` (1, d_pad // pack) snapped against each
    row of ``y_rot`` (s, d_pad) and averaged into it
    (:func:`average_plain`). ``gammas`` and ``levels2`` hold 1 value.
    Returns ``y_rot``.

    Replaces no reference kernel: the snap ``snap_codes`` with the four
    in-place passes of the clients' average. Bound on the H100: bytes,
    8·s + 4 per coordinate (the code once, each row read and written).
    Design: ``snap_vec_kernel``'s 8 coordinates a thread; a thread reads
    its codes once for every message it takes (:func:`average_geometry`)
    and writes each row where it read it, dividing, multiplying and adding
    with one rounding each in the plain version's order.
    """
    if build.on_meta(codes2, y_rot, gammas, levels2):
        return y_rot
    if build.on_cpu(codes2, y_rot, gammas, levels2):
        return average_plain(codes2, y_rot, gammas, bits=bits, block=block,
                             pack=pack, levels2=levels2, avg_mode=avg_mode)
    _, mix = _avg_flags(avg_mode)
    m, d_pad = y_rot.shape
    check_launch_ints(m, d_pad)
    b, c = _geometry(d_pad, block, bits, pack)
    c32, c8 = _code_rows(codes2, 1, d_pad, pack)
    _require(y_rot, "y_rot", torch.float32, (m, d_pad))
    _row(gammas, "gammas", 1)          # one code row: one γ, one level
    lv, _, lv_default = _levels_args(levels2, bits, 1)
    LAUNCHES["average"] += 1
    build.check(library().exch_average(
        build.ptr(c32), build.ptr(c8), build.ptr(y_rot), build.ptr(gammas),
        build.ptr(lv), lv_default, m, d_pad, b, c, bits, pack, int(mix),
        average_geometry(m, d_pad)["rows"], build.stream()), "exch_average")
    return y_rot
