"""The share of the traced window, in percent, in which no operation ran
on the card: one minus the union of the device operations' intervals
over the window's host seconds."""
from __future__ import annotations


def read(ctx):
    if not ctx.kernels:
        return None
    from perfbench.harness import busy_seconds
    return 100.0 * (1.0 - busy_seconds(ctx.kernels) / ctx.window_s)
