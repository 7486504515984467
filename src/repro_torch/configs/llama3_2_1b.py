"""llama3.2-1b [dense] — small llama3.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B]
"""
from repro_torch.configs.base import ATTN_FULL, LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        arch_type="dense",
        source="hf:meta-llama/Llama-3.2-1B",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab_size=128_256,
        schedule=(LayerSpec(attn=ATTN_FULL),),
        tie_embeddings=True,
        rope_theta=500_000.0,
        long_500k_ok=True,
        long_ctx_window=8192,
        long_500k_note="run with the explicit sliding-window variant "
                       "(window 8192); the source model is full-attention.",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512,
        param_dtype="float32", dtype="float32",
    )
