"""llama4-scout-17b-a16e [moe] — MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
(+1 shared expert). iRoPE layout: 3 chunked-local-attention layers (8192
chunk) then 1 global NoPE layer. [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import (ATTN_CHUNKED, ATTN_FULL, LayerSpec,
                                      ModelConfig, MoEConfig)

_LOCAL = LayerSpec(attn=ATTN_CHUNKED, window=8192, mlp="moe")
_GLOBAL = LayerSpec(attn=ATTN_FULL, mlp="moe", use_rope=False)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        arch_type="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202_048,
        schedule=(_LOCAL, _LOCAL, _LOCAL, _GLOBAL),
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                      n_shared=1, d_ff_shared=8192),
        rope_theta=500_000.0,
        long_500k_ok=True,
        long_500k_note="3/4 of layers are 8192-chunked local attention "
                       "(iRoPE); global NoPE layers decode against the full "
                       "cache (linear per decoded token).",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        schedule=(LayerSpec(attn=ATTN_CHUNKED, window=64, mlp="moe"),
                  LayerSpec(attn=ATTN_FULL, mlp="moe", use_rope=False)),
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=256,
                      n_shared=1, d_ff_shared=256),
        param_dtype="float32", dtype="float32",
    )
