"""Rotated-space lattice exchange: CUDA kernels and their plain versions
(port of ``repro.kernels.exchange``).

Four kernels carry the QuAFL round. Each has a plain PyTorch version here
(``*_plain``, any device) and a wrapper under the reference's name that
launches the CUDA kernel of ``csrc/exchange.cu`` on a CUDA tensor, runs the
plain version on a CPU tensor, and raises on anything else. Every wrapper
counts its launches in :data:`LAUNCHES`.

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

# Launches of each kernel since the last reset_launches(); a wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"fused_encode": 0, "fused_rotate": 0, "quantize_codes": 0,
            "snap_codes": 0}


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
    Forward: signs, then H_b / sqrt(b) per block; inverse: H first."""
    m, d_pad = x2.shape
    b = block_geometry(d_pad, block)[0]
    x = x2.to(torch.float32)
    if not inverse:
        x = x * signs
    y = _fwht(x.reshape(m, d_pad // b, b)).reshape(m, d_pad) * _scale(b)
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


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "exch_rotate": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "exch_encode": [_P, _P, _P, _P, _I, _P, _I, _F, _P, _P, _P, _I, _I, _I,
                    _I, _I, _I, _F, _P],
    "exch_quantize": [_P, _P, _P, _I, _P, _I, _F, _P, _P, _I, _I, _I, _I,
                      _I, _I, _P],
    "exch_snap": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _F, _P, _I, _I, _I,
                  _I, _I, _I, _P],
}
# the largest block one CTA holds in shared memory (227 KB on Hopper)
_MAX_SHARED_BLOCK = 232_448 // 4


def library():
    """The built and loaded ``csrc/exchange.cu``."""
    return build.load("exchange", _SIGNATURES)


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    False when all lie on the current CUDA device, where the kernels launch;
    raises on any other device or a mix."""
    devices = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len(devices) == 1:
        (dev,) = devices
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"tensors on {dev}, but the kernels launch on "
                             f"the current device cuda:"
                             f"{torch.cuda.current_device()}")
        return False
    raise ValueError(f"exchange kernels take tensors all on the CPU or all "
                     f"on one CUDA device; got {sorted(map(str, devices))}")


def _require(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _check(rc: int, fn: str):
    if rc != 0:
        raise RuntimeError(f"{fn} failed: cudaError_t {rc}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def fused_rotate(x2, signs, *, block=DEFAULT_BLOCK, inverse=False):
    """Batched randomized-Hadamard rotation (m, d_pad) -> (m, d_pad).

    Replaces ``repro/kernels/exchange.py`` · ``fused_rotate``
    (``_rotate_kernel``, two MXU matmuls per (r, c) block). Bound on the
    H100: bytes, 8 per coordinate (read x, write y). Design: one CTA per
    (message, block) holds the block in shared memory through all log2(b)
    butterfly stages, so each coordinate crosses device memory once each
    way.
    """
    if _on_cpu(x2, signs):
        return rotate_plain(x2, signs, block=block, inverse=inverse)
    m, d_pad = x2.shape
    b, _ = _geometry(d_pad, block, 8, 1)
    _require(x2, "x2", torch.float32, (m, d_pad))
    _require(signs, "signs", torch.float32, (d_pad,))
    out = torch.empty_like(x2)
    LAUNCHES["fused_rotate"] += 1
    _check(library().exch_rotate(_ptr(x2), _ptr(signs), _ptr(out), m, d_pad, b,
                              int(inverse), _scale(b), _stream()),
           "exch_rotate")
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


def fused_encode(x2, signs, u2, gammas, *, bits=8, block=DEFAULT_BLOCK,
                 want_rotated=False, pack=1, levels2=None):
    """Rotate + stochastic round + wrap in one pass; returns codes, or
    (rotated, codes) when ``want_rotated``.

    Replaces ``repro/kernels/exchange.py`` · ``fused_encode``
    (``_encode_kernel``). Bound on the H100: bytes, 16 per coordinate with
    y kept (x, u, y, int32 codes). Design: the rotated block stays in shared
    memory from the butterfly to the quantize and the packing, so y is
    written once (for the decode reference) and never read back.
    """
    if _on_cpu(x2, signs, u2, gammas, levels2):
        return encode_plain(x2, signs, u2, gammas, bits=bits, block=block,
                            want_rotated=want_rotated, pack=pack,
                            levels2=levels2)
    m, d_pad = x2.shape
    b, c = _geometry(d_pad, block, bits, pack)
    _require(x2, "x2", torch.float32, (m, d_pad))
    _require(signs, "signs", torch.float32, (d_pad,))
    _require(u2, "u2", torch.float32, (m, d_pad))
    if gammas.numel() != m:
        raise ValueError(f"gammas: {gammas.numel()} values for {m} messages")
    g_stride = _row(gammas, "gammas", m)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, m)
    codes32, codes8 = _code_outputs(m, d_pad, pack, x2.device)
    y = torch.empty_like(x2) if want_rotated else None
    LAUNCHES["fused_encode"] += 1
    _check(library().exch_encode(
        _ptr(x2), _ptr(signs), _ptr(u2), _ptr(gammas), g_stride, _ptr(lv),
        lv_stride, lv_default, _ptr(codes32), _ptr(codes8), _ptr(y), m,
        d_pad, b, c, bits, pack, _scale(b), _stream()), "exch_encode")
    codes = codes32 if pack == 1 else codes8
    return (y, codes) if want_rotated else codes


def quantize_codes(y2, u2, gammas, *, bits=8, block=DEFAULT_BLOCK, pack=1,
                   levels2=None):
    """Stochastic round + wrap of already-rotated coordinates.

    Replaces ``repro/kernels/exchange.py`` · ``quantize_codes``
    (``_quantize_kernel``). Bound on the H100: bytes, 12 per coordinate
    (y, u, int32 codes). Design: one thread per output code or packed byte,
    consecutive threads on consecutive columns; the arithmetic is
    ``fused_encode``'s, bit for bit.
    """
    if _on_cpu(y2, u2, gammas, levels2):
        return quantize_plain(y2, u2, gammas, bits=bits, block=block,
                              pack=pack, levels2=levels2)
    m, d_pad = y2.shape
    b, c = _geometry(d_pad, block, bits, pack)
    _require(y2, "y2", torch.float32, (m, d_pad))
    _require(u2, "u2", torch.float32, (m, d_pad))
    g_stride = _row(gammas, "gammas", m)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, m)
    codes32, codes8 = _code_outputs(m, d_pad, pack, y2.device)
    LAUNCHES["quantize_codes"] += 1
    _check(library().exch_quantize(
        _ptr(y2), _ptr(u2), _ptr(gammas), g_stride, _ptr(lv), lv_stride,
        lv_default, _ptr(codes32), _ptr(codes8), m, d_pad, b, c, bits, pack,
        _stream()), "exch_quantize")
    return codes32 if pack == 1 else codes8


def snap_codes(codes2, wrot2, gammas, *, bits=8, block=DEFAULT_BLOCK, pack=1,
               levels2=None):
    """Positional snap in rotated space, γ·(c + L·round((w/γ − c)/L)).

    ``codes2`` (mc, d_pad // pack) and ``wrot2`` (mw, d_pad) broadcast along
    the message axis (mc or mw may be 1); ``gammas`` and ``levels2`` hold 1
    or max(mc, mw) values. Replaces ``repro/kernels/exchange.py`` ·
    ``snap_codes`` (``_snap_kernel``). Bound on the H100: bytes, 8 per
    output coordinate (int32 code or packed byte share, fp32 output) plus
    the broadcast side read once. Design: one thread per output
    coordinate, packed codes unpacked inline.
    """
    if _on_cpu(codes2, wrot2, gammas, levels2):
        return snap_plain(codes2, wrot2, gammas, bits=bits, block=block,
                          pack=pack, levels2=levels2)
    mc, d_padp = codes2.shape
    mw, d_pad = wrot2.shape
    m = max(mc, mw)
    if d_padp * pack != d_pad or min(mc, mw) not in (1, m):
        raise ValueError(f"codes {tuple(codes2.shape)} (pack={pack}) do not "
                         f"broadcast against refs {tuple(wrot2.shape)}")
    b, c = _geometry(d_pad, block, bits, pack)
    _require(codes2, "codes2", torch.int32 if pack == 1 else torch.uint8,
             (mc, d_padp))
    _require(wrot2, "wrot2", torch.float32, (mw, d_pad))
    g_stride = _row(gammas, "gammas", m)
    lv, lv_stride, lv_default = _levels_args(levels2, bits, m)
    out = torch.empty((m, d_pad), dtype=torch.float32, device=wrot2.device)
    c32, c8 = (codes2, None) if pack == 1 else (None, codes2)
    LAUNCHES["snap_codes"] += 1
    _check(library().exch_snap(
        _ptr(c32), _ptr(c8), mc, _ptr(wrot2), mw, _ptr(gammas), g_stride,
        _ptr(lv), lv_stride, lv_default, _ptr(out), m, d_pad, b, c, bits,
        pack, _stream()), "exch_snap")
    return out
