"""The exchange kernels' share of their byte bound, in percent: the bytes
the round's exchange must move (``counts.exchange_bytes``: inputs read
once, outputs written once) over the card's memory rate, against their
device time in the traced window."""
from __future__ import annotations

from perfbench import counts
from perfbench.metrics import exchange_ms_per_round as exchange


def read(ctx):
    s = exchange.seconds(ctx)
    if s <= 0:
        return None
    return counts.roofline_share(ctx.exchange_bytes_per_round * ctx.rounds,
                                 s, ctx.device_name)
