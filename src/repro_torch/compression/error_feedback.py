"""Error-feedback (EF14/EF21-style) compression (port of
``repro.compression.error_feedback``): the alternative the paper rejects
(§2.2). Quantized updates sent with a client-side error accumulator need
memory at the client and second-moment assumptions; the position-aware
lattice quantizer needs neither. Kept so that the trade-off runs.

Batched over a leading message axis, as every port codec: one residual row
per message.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.compression.lattice import (LatticeMsg, MessageKey,
                                             QSGDQuantizer)


class EFState(NamedTuple):
    error: torch.Tensor    # client-side residual memory (m, d)


@dataclass(frozen=True)
class ErrorFeedbackQSGD:
    """QSGD on (delta + carried error); the residual not sent is kept and
    added to the next message."""
    bits: int = 8

    def init(self, d: int, m: int = 1, device=None) -> EFState:
        return EFState(error=torch.zeros((m, d), dtype=torch.float32,
                                         device=device))

    def compress(self, key: MessageKey, delta2: torch.Tensor, state: EFState
                 ) -> Tuple[LatticeMsg, torch.Tensor, EFState]:
        """(message, value decoded at the server, new client state).

        QSGD is no contraction for few bits and large d (its variance bound
        ω = √d/levels can exceed 1), so the decoded value is scaled by the
        standard 1/(1+ω) to keep the EF recursion stable."""
        q = QSGDQuantizer(bits=self.bits)
        target = delta2 + state.error
        msg = q.encode(key, target)
        omega = np.sqrt(delta2.shape[-1]) / q.levels
        decoded = q.decode(key, msg) / (1.0 + omega)
        return msg, decoded, EFState(error=target - decoded)

    def message_bits(self, d: int) -> int:
        return QSGDQuantizer(bits=self.bits).message_bits(d)
