"""Configuration dataclasses (port of ``repro.configs.base``): the layer
schedule and model architecture of the LM zoo, the MoE, Mamba and MLA
blocks' configs, and the federation knobs. ``ModelConfig`` holds the
fields the port's models read, the encoder stack and the frontend's
length included, and the long-context variant (``long_500k_ok``,
``long_ctx_window``, ``long_500k_note``, :meth:`ModelConfig.with_long_variant`).
``ShapeConfig`` holds the fields the mesh steps read, and :data:`SHAPES` the
four input shapes the dry-run tools take."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

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
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0           # defaults to d_ff_expert * n_shared if 0
    router_aux_coef: float = 0.01
    impl: str = "ragged"           # 'ragged' (grouped product) | 'dense'
    capacity_factor: float = 1.25  # only for the dense impl


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256               # SSD chunk length
    ngroups: int = 1


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


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
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    qk_norm: bool = False
    nonparametric_ln: bool = False # OLMo-style LN without learnable affine
    tie_embeddings: bool = False
    # encoder-decoder
    encdec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub ('' | 'vision' | 'audio'): its embeddings come
    # in the batch ('frontend'), shaped by launch/specs.input_specs
    frontend: str = ""
    n_frontend_tokens: int = 0     # image/audio tokens prepended to the text
    # long-context support
    long_500k_ok: bool = False
    long_ctx_window: int = 0       # >0: sliding-window variant used for long_500k
    long_500k_note: str = ""
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

    def with_long_variant(self) -> ModelConfig:
        """Sliding-window variant used only for the long_500k shape: every
        full-attention layer of the schedule and the prefix becomes a
        sliding one of ``long_ctx_window``."""
        if self.long_ctx_window <= 0:
            return self

        def slide(specs):
            return tuple(
                dataclasses.replace(s, attn=ATTN_SLIDING,
                                    window=self.long_ctx_window)
                if s.kind == KIND_ATTN and s.attn == ATTN_FULL else s
                for s in specs)
        return self.replace(schedule=slide(self.schedule),
                            prefix=slide(self.prefix))


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
    # aggregation transport on the mesh:
    #  'dequant_psum'  — faithful: decode locally then all-reduce fp32
    #  'code_allgather'— beyond-paper: all-gather packed codes, decode after
    #  'shard_local' / 'shard_local_codes' / 'shard_local_rs' — the whole
    #  exchange on each rank's blocks (repro_torch.core.exchange_local),
    #  client sum carried by the named repro_torch.compression.transports
    #  strategy (fp32 psum / packed-code all-gather / fused reduce_scatter
    #  with the scatter-resident coded re-gather)
    transport: str = "dequant_psum"


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the mesh steps: ``kind`` 'train', 'prefill' or
    'decode', ``seq_len`` and ``global_batch``."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}
