"""Federation configuration (port of ``FedConfig`` from
``repro.configs.base``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FedConfig:
    n_clients: int = 16            # n in the paper
    s: int = 16                    # sampled clients per round
    local_steps: int = 4           # K
    lr: float = 0.1                # eta (client SGD step)
    # paper App. A: 'Unless otherwise noted, we employ the unweighted version'
    weighted: bool = False         # eta_i = H_min / H_i dampening
    quantizer: str = "lattice"     # 'lattice' | 'qsgd' | 'none'
    bits: int = 8
    # per-direction codec specs (repro_torch.compression.codecs names, e.g.
    # 'lattice_packed:bits=4'); "" derives the scheme from `quantizer` +
    # `bits`
    codec_up: str = ""
    codec_down: str = ""
    # exchange backend (repro_torch.compression.pipeline):
    #  'cuda'  — the hand-written CUDA kernels (plain versions on CPU tensors)
    #  'torch' — the plain PyTorch versions on any device
    kernel_backend: str = "cuda"
    # client speed model (App. A timing experiments): step time ~ Exp(lam)
    slow_frac: float = 0.3
    lam_fast: float = 0.5
    lam_slow: float = 0.125
    swt: float = 10.0              # server waiting time between calls
    sit: float = 1.0               # server interaction time
    # participation spec ('uniform' is the only one ported); "" = uniform
    participation: str = ""
