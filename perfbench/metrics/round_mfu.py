"""The traced rounds' share of the card's peak while the card works, in
percent: model FLOPs of their active local steps over the device's busy
seconds (the union of its operations' intervals) times the peak of the
configuration's compute precision. Host gaps, the profiler's among them,
are left out: the end-to-end ``mfu`` holds them. A kernel taken off the
path leaves its roofline silent, not this; it bounds every roofline's
claim."""
from __future__ import annotations

from perfbench.harness import busy_seconds


def read(ctx):
    busy = busy_seconds(ctx.kernels) if ctx.kernels else 0.0
    if ctx.model_flops <= 0 or busy <= 0:
        return None
    return 100.0 * ctx.model_flops / (busy * ctx.peak_flops)
