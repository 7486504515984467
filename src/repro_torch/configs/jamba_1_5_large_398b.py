"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on
every other layer. Period of 8 layers with one attention layer (index 3).
[arXiv:2403.19887]
"""
from repro_torch.configs.base import (ATTN_FULL, KIND_MAMBA, LayerSpec,
                                      MambaConfig, ModelConfig, MoEConfig)

_M_D = LayerSpec(kind=KIND_MAMBA, mlp="dense")
_M_E = LayerSpec(kind=KIND_MAMBA, mlp="moe")
_A_E = LayerSpec(kind="attn", attn=ATTN_FULL, mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        arch_type="hybrid",
        source="arXiv:2403.19887",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24_576, vocab_size=65_536,
        # 1 attention : 7 mamba per period; MoE every other layer
        schedule=(_M_D, _M_E, _M_D, _A_E, _M_D, _M_E, _M_D, _M_E),
        mamba=MambaConfig(d_state=128, expand=2, head_dim=64,
                          conv_width=4, chunk=256),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24_576),
        long_500k_ok=True,
        long_500k_note="7/8 of layers are Mamba (constant state); the 9 "
                       "attention layers decode against the cache "
                       "(linear per decoded token).",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        schedule=(LayerSpec(kind=KIND_MAMBA, mlp="dense"),
                  LayerSpec(kind="attn", attn=ATTN_FULL, mlp="moe")),
        mamba=MambaConfig(d_state=16, expand=2, head_dim=32,
                          conv_width=4, chunk=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        param_dtype="float32", dtype="float32",
    )
