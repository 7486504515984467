"""Device ms a round of every device operation that is neither a GEMM,
an attention kernel nor an exchange kernel: the round's flat fp32 passes
in ``core/quafl.py`` (averaging, copies, fills, norms) together with the
model's own non-GEMM work in the local steps (norms, activations, the
softmax and score arithmetic of plain attention, casts of the fp32
parameters, cross-entropy, autograd's copies), memory copies and sets.
The trace's kernel names do not tell the two apart.

Family rule: neither an exchange kernel nor a model kernel, so that the
three families partition the trace."""
from __future__ import annotations

from perfbench.metrics import exchange_ms_per_round as exchange
from perfbench.metrics import model_kernels_ms_per_round as model


def member(name: str) -> bool:
    return not exchange.member(name) and not model.member(name)


def read(ctx):
    if not ctx.kernels:
        return None
    return (sum(b - a for n, a, b in ctx.kernels if member(n)) * 1e3 * 1e-6
            / ctx.rounds)
