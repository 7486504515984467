"""Device operations a round in the traced window: kernels (a captured
graph's nodes each count), memory copies and sets."""
from __future__ import annotations


def read(ctx):
    if not ctx.kernels:
        return None
    return len(ctx.kernels) / ctx.rounds
