"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000. [arXiv:2408.00118]
"""
from repro_torch.configs.base import (ATTN_FULL, ATTN_SLIDING, LayerSpec,
                                      ModelConfig)

_LOCAL = LayerSpec(attn=ATTN_SLIDING, window=4096)
_GLOBAL = LayerSpec(attn=ATTN_FULL)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        arch_type="dense",
        source="arXiv:2408.00118",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab_size=256_000,
        schedule=(_LOCAL, _GLOBAL),
        logit_softcap=30.0, attn_softcap=50.0,
        tie_embeddings=True,
        long_500k_ok=True,
        long_500k_note="half the layers are 4096-window local; global layers "
                       "keep the full cache (decode linear per token).",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        schedule=(LayerSpec(attn=ATTN_SLIDING, window=64), _GLOBAL),
        param_dtype="float32", dtype="float32",
    )
