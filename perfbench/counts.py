"""The benchmark's own count arithmetic: padded lengths, wire bits, the bytes
the exchange must move, model FLOPs, and the H100's published peaks.

A frozen copy of the rules the program's smoke script and dry-run tools
use, kept here so that no change to the program can move the yardstick.
Every function works from shapes alone.
"""
from __future__ import annotations

import math

# Hadamard block of the rotated-space exchange (128 x 128).
BLOCK = 16_384

# NVIDIA's data sheet, H100 SXM, dense rates; 3.35 TB/s unless the card's
# name matches an earlier row.
PEAK_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                    ("H200", 4.8e12), ("H100", 3.35e12))
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def peak_bytes_per_s(device_name: str) -> float:
    """The memory rate of the card whose name is ``device_name``."""
    for key, rate in PEAK_BYTES_PER_S:
        if key in device_name:
            return rate
    raise ValueError(f"no memory rate known for {device_name!r}")


def block_size(d: int, block: int = BLOCK) -> int:
    """The least power of two at or above min(d, block)."""
    b = 1
    while b < min(d, block):
        b <<= 1
    return b


def pad_len(d: int, block: int = BLOCK) -> int:
    b = block_size(d, block)
    return -(-d // b) * b


def lattice_bits(d: int, bits: int = 8) -> int:
    """Bits of one unpacked lattice message: a code a padded coordinate
    plus the fp32 scale gamma."""
    return pad_len(d) * bits + 32


def round_bits(d: int, s: int, bits: int = 8) -> tuple:
    """(bits up, bits down) of one QuAFL round: s uplink messages and one
    downlink broadcast."""
    return s * lattice_bits(d, bits), lattice_bits(d, bits)


def exchange_bytes(d: int, s: int) -> int:
    """Bytes one round's exchange kernels must move at (s, d_pad), inputs
    read once and outputs written once. Encode: x, u, y, int32 codes and
    the sign row (16 s + 4); rotations: the server forward and inverse and
    the clients' inverse, 8 a coordinate, and a sign row each (8 (2 + s) +
    12); quantize: y, u, codes (12); snaps: up s code rows against the
    server, down one code row against s rows (2 (8 s + 4))."""
    dp = pad_len(d)
    return ((16 * s + 4) + (8 * (2 + s) + 12) + 12 + 2 * (8 * s + 4)) * dp


def lm_flops_per_token(n_layers: int, d_model: int, matmul_params: int,
                       seq: int) -> float:
    """Training FLOPs a token: 6 per matmul parameter (the LM head
    included, the embedding lookup not) plus 12 L d T for attention."""
    return 6.0 * matmul_params + 12.0 * n_layers * d_model * seq


def mlp_flops_per_sample(n_params: int) -> float:
    """Training FLOPs a sample of the MLP: 6 per parameter."""
    return 6.0 * n_params


def lm_matmul_params(n_layers: int, d_model: int, n_heads: int,
                     n_kv_heads: int, head_dim: int, d_ff: int,
                     vocab: int) -> int:
    """Parameters that enter a matmul: q, k, v, o and the SwiGLU MLP in
    every layer, and the LM head."""
    attn = d_model * head_dim * (2 * n_heads + 2 * n_kv_heads)
    mlp = 3 * d_model * d_ff
    return n_layers * (attn + mlp) + d_model * vocab


def roofline_share(bytes_moved: float, seconds: float,
                   device_name: str) -> float:
    """The least time the bytes need over the time taken, in percent."""
    if seconds <= 0 or not math.isfinite(seconds):
        raise ValueError(f"no time to divide by: {seconds}")
    return 100.0 * bytes_moved / peak_bytes_per_s(device_name) / seconds
