"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
[hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import (ATTN_FULL, ATTN_SLIDING, LayerSpec,
                                      ModelConfig)

# gemma3 dual RoPE: local layers theta=10k, global layers theta=1M
_LOCAL = LayerSpec(attn=ATTN_SLIDING, window=1024, rope_theta=10_000.0)
_GLOBAL = LayerSpec(attn=ATTN_FULL, rope_theta=1_000_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        arch_type="dense",
        source="hf:google/gemma-3-1b-pt",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=15_360, vocab_size=262_144,
        schedule=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        long_500k_ok=True,
        long_500k_note="5/6 of layers are 1024-window local; global layers "
                       "keep the full cache (decode linear per token).",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        schedule=(LayerSpec(attn=ATTN_SLIDING, window=64), _GLOBAL),
        param_dtype="float32", dtype="float32",
    )
