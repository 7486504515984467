"""Configuration dataclasses (port of ``repro.configs.base``): the layer
schedule and model architecture of the LM zoo, and the federation knobs.
The port's model runs the dense decoders, so ``ModelConfig`` holds only the
fields they read; the MoE, Mamba and MLA blocks' configs and the reference's
long-context and frontend sizes come with the slice that ports those blocks
(ROADMAP Queue 1 item 12)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# attention kinds
ATTN_FULL = "full"
ATTN_SLIDING = "sliding"
ATTN_CHUNKED = "chunked"   # llama4-style local chunked attention
ATTN_MLA = "mla"           # deepseek multi-head latent attention
KIND_ATTN = "attn"
KIND_MAMBA = "mamba"


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period of the network."""
    kind: str = KIND_ATTN          # 'attn' | 'mamba'
    attn: str = ATTN_FULL          # attention flavour (if kind == 'attn')
    window: int = 0                # sliding-window / chunk size (0 = n/a)
    mlp: str = "dense"             # 'dense' | 'moe'
    use_rope: bool = True          # NoPE layers (llama4 global) set False
    rope_theta: float = 0.0        # per-layer override (0 = model default)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    source: str                    # citation for the numbers
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer layout: n_layers == len(prefix) + n_periods * len(schedule)
    schedule: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix: Tuple[LayerSpec, ...] = ()
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    qk_norm: bool = False
    nonparametric_ln: bool = False # OLMo-style LN without learnable affine
    tie_embeddings: bool = False
    encdec: bool = False
    frontend: str = ""             # '' | 'vision' | 'audio'
    dtype: str = "bfloat16"        # activation / compute dtype
    param_dtype: str = "float32"

    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.prefix)
        if body % len(self.schedule):
            raise ValueError(
                f"{self.name}: {self.n_layers} layers, prefix "
                f"{len(self.prefix)}, period {len(self.schedule)} does not "
                f"divide")
        return body // len(self.schedule)

    def replace(self, **kw) -> ModelConfig:
        return dataclasses.replace(self, **kw)


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
    # participation spec (repro_torch.fed.population: 'uniform',
    # 'gamma_straggler:strength=2', 'cyclic:period=8,phase_groups=4');
    # "" = uniform
    participation: str = ""
