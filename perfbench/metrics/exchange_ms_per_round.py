"""Device ms a round of the lattice exchange's kernels
(``kernels/csrc/exchange.cu``), from the traced window.

Family rule: a device operation belongs to the exchange when its symbol
holds the name of one of the exchange's five kernels."""
from __future__ import annotations

SYMBOLS = ("encode_cluster_kernel", "rotate_cluster_kernel",
           "snap_vec_kernel", "quantize_vec_kernel", "decode_cluster_kernel")


def member(name: str) -> bool:
    return any(s in name for s in SYMBOLS)


def seconds(ctx) -> float:
    return sum(b - a for n, a, b in ctx.kernels if member(n)) * 1e-6


def read(ctx):
    if not ctx.kernels:
        return None
    return seconds(ctx) * 1e3 / ctx.rounds
