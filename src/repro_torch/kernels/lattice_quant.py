"""Single-vector lattice encode and decode: the CUDA kernels and their plain
versions (port of ``repro.kernels.lattice_quant``).

encode: codes = floor(y/γ + u) mod 2^b          (stochastic round + wrap)
decode: x̂    = γ·(codes + 2^b·round((w/γ − codes)/2^b))   (positional snap)

over one rotated vector of d coordinates, d % 1024 == 0 (the reference's
(8, 128) tiles), with one scalar γ: a Python number, or a 0-d or (1,)
float32 tensor on the vector's device, which the kernels read there (no host
sync). Codes are int32 (the reference's uint32; every code is below 2^16,
so the values are the same). ``lattice_encode`` and ``lattice_decode``
launch the kernels of ``csrc/lattice_quant.cu`` on CUDA tensors, run the
plain versions on CPU tensors, raise on anything else, and count their
launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.exchange import quantize_plain, snap_plain

TILE = 1024          # the reference's (8, 128) tile: d % TILE == 0
MAX_BITS = 16        # the range the exchange kernels take

# Launches since the last reset_launches(); a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"lattice_encode": 0, "lattice_decode": 0}

_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, ctypes.c_float, _P, ctypes.c_longlong, ctypes.c_float,
         ctypes.c_int, _P]
_SIGNATURES = {"lattice_encode_fwd": _ARGS, "lattice_decode_fwd": _ARGS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The built and loaded ``csrc/lattice_quant.cu``."""
    return build.load("lattice_quant", _SIGNATURES)


def _check(bits, gamma, *vectors) -> int:
    """Refuse what the reference's kernels do not take: vectors that are
    not 1-D of one length d and the dtype given, d % 1024, bits outside
    1..16, a γ tensor of more than one value. Returns d."""
    d = vectors[0][1].shape[0] if vectors[0][1].dim() == 1 else -1
    for name, t, dtype in vectors:
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != d:
            raise ValueError(f"{name}: expected a 1-D {dtype} vector of "
                             f"the first one's length, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if d % TILE:
        raise ValueError(f"d={d} is not a multiple of {TILE}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits={bits} outside 1..{MAX_BITS}")
    if isinstance(gamma, torch.Tensor) and (
            gamma.dtype != torch.float32 or gamma.numel() != 1
            or gamma.dim() > 1):
        raise ValueError(f"gamma: expected a number or a 0-d or (1,) "
                         f"float32 tensor, got {gamma.dtype} "
                         f"{tuple(gamma.shape)}")
    return d


def _gamma_row(gamma, device) -> torch.Tensor:
    """γ as the (1,) float32 row of the exchange's plain versions."""
    return torch.as_tensor(gamma, dtype=torch.float32,
                           device=device).reshape(1)


def lattice_encode_plain(y, u, gamma, *, bits=8):
    """floor(y/γ + u) mod 2^bits, floored modulo (``jnp.mod``); int32."""
    return quantize_plain(y[None], u[None], _gamma_row(gamma, y.device),
                          bits=bits)[0]


def lattice_decode_plain(codes, w, gamma, *, bits=8):
    """γ·(c + 2^bits·round((w/γ − c)/2^bits)), round half to even."""
    return snap_plain(codes[None], w[None], _gamma_row(gamma, w.device),
                      bits=bits)[0]


def _launch(fn, inputs: dict, gamma, out, bits):
    """One launch of ``fn`` on the two named input vectors: γ by pointer (a
    tensor, read on the device) or by value (a number, pointer null),
    float4 when every pointer is 16-byte aligned."""
    g = gamma if isinstance(gamma, torch.Tensor) else None
    for name, t in (*inputs.items(), ("gamma", g)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    a, b = inputs.values()
    vec = all(t.data_ptr() % 16 == 0 for t in (a, b, out))
    build.check(getattr(library(), fn)(
        build.ptr(a), build.ptr(b), build.ptr(g),
        0.0 if g is not None else float(gamma), build.ptr(out), out.numel(),
        float(1 << bits), int(vec), build.stream()), fn)
    return out


@build.costed(build.no_flops)
def lattice_encode(y, u, gamma, *, bits=8):
    """y: rotated coordinates (d,) fp32, d % 1024 == 0; u: U(0,1) noise
    (d,) fp32; γ a number or a one-value float32 tensor -> codes (d,) int32
    in [0, 2^bits).

    Replaces ``repro/kernels/lattice_quant.py`` · ``lattice_encode``
    (``_encode_kernel``, (rows, 128) VMEM tiles). Bound on the H100: bytes,
    12 per coordinate (y, u, int32 code). Design: one coalesced grid-stride
    pass, float4 loads where aligned, γ read on the device.
    """
    d = _check(bits, gamma, ("y", y, torch.float32),
               ("u", u, torch.float32))
    g = gamma if isinstance(gamma, torch.Tensor) else None
    if build.on_meta(y, u, g):
        return y.new_empty(d, dtype=torch.int32)
    if build.on_cpu(y, u, g):
        return lattice_encode_plain(y, u, gamma, bits=bits)
    out = torch.empty(d, dtype=torch.int32, device=y.device)
    _launch("lattice_encode_fwd", {"y": y, "u": u}, gamma, out, bits)
    LAUNCHES["lattice_encode"] += 1
    return out


@build.costed(build.no_flops)
def lattice_decode(codes, w, gamma, *, bits=8):
    """codes: (d,) int32; w: rotated reference (d,) fp32 -> the
    representative of each code nearest w, (d,) fp32.

    Replaces ``repro/kernels/lattice_quant.py`` · ``lattice_decode``
    (``_decode_kernel``). Bound on the H100: bytes, 12 per coordinate
    (int32 code, w, fp32 output). Design: ``lattice_encode``'s.
    """
    d = _check(bits, gamma, ("codes", codes, torch.int32),
               ("w", w, torch.float32))
    g = gamma if isinstance(gamma, torch.Tensor) else None
    if build.on_meta(codes, w, g):
        return w.new_empty(d)
    if build.on_cpu(codes, w, g):
        return lattice_decode_plain(codes, w, gamma, bits=bits)
    out = torch.empty(d, dtype=torch.float32, device=w.device)
    _launch("lattice_decode_fwd", {"codes": codes, "w": w}, gamma, out,
            bits)
    LAUNCHES["lattice_decode"] += 1
    return out
