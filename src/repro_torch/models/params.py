"""Parameter initialisation (port of the ``normal`` and ``zeros`` inits of
``repro.models.params.Ctx``): weights ~ N(0, 1) / sqrt(fan_in), biases zero.
The draws come from a ``torch.Generator`` and differ from the reference's;
tests carry the reference's weights across with
:mod:`repro_torch.utils.interop`."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def normal_param(generator: torch.Generator, shape: Tuple[int, ...],
                 scale: float = None) -> torch.Tensor:
    """fp32 normal init scaled by 1/sqrt(fan_in), fan_in = shape[-2] (1 for
    vectors), on the generator's device."""
    if scale is None:
        fan_in = shape[-2] if len(shape) > 1 else 1
        scale = 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return x * float(scale)
