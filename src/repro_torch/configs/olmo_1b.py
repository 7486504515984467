"""olmo-1b [dense] — non-parametric LayerNorm.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304. [arXiv:2402.00838]
"""
from repro_torch.configs.base import ATTN_FULL, LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        arch_type="dense",
        source="arXiv:2402.00838",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab_size=50_304,
        schedule=(LayerSpec(attn=ATTN_FULL),),
        nonparametric_ln=True,
        tie_embeddings=True,
        long_500k_ok=True,
        long_ctx_window=8192,
        long_500k_note="run with the explicit sliding-window variant "
                       "(window 8192); the source model is full-attention.",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        param_dtype="float32", dtype="float32",
    )
