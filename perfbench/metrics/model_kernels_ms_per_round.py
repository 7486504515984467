"""Device ms a round of the model's matrix products and attention (the
local steps' forward and backward), from the traced window.

Family rule: not an exchange kernel, and the symbol names a GEMM or GEMV
(cuBLAS, cuBLASLt's nvjet, CUTLASS, xmma, split-K reduction) or an
attention kernel (flash, fmha, sdpa)."""
from __future__ import annotations

import re

from perfbench.metrics import exchange_ms_per_round as exchange

PATTERN = re.compile(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitkreduce|"
                     r"flash|fmha|sdpa|attention", re.IGNORECASE)


def member(name: str) -> bool:
    return not exchange.member(name) and bool(PATTERN.search(name))


def read(ctx):
    if not ctx.kernels:
        return None
    return (sum(b - a for n, a, b in ctx.kernels if member(n)) * 1e3 * 1e-6
            / ctx.rounds)
