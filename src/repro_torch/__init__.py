"""PyTorch + CUDA port of :mod:`repro` for an NVIDIA H100.

The package mirrors ``src/repro/`` module by module (same paths, same
names where the role is the same) and imports neither ``jax`` nor
``repro``. Every entry point takes ``device=None`` and means the card by
that; tests pass ``"cpu"``, where each kernel wrapper runs its plain
PyTorch version.
"""
from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` when ``device`` is
    None, else ``device`` itself. There is no fallback: asking for the card
    on a machine without CUDA raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch versions")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is absent")
    return dev
