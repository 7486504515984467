"""llava-next-34b [vlm] — anyres tiling; language backbone only.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The vision tower +
projector are a stub: ``launch/specs.input_specs`` supplies projected
patch embeddings (anyres: 5 tiles x 576 patches = 2880 image tokens),
prepended to the text. [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ATTN_FULL, LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        arch_type="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20_480, vocab_size=64_000,
        schedule=(LayerSpec(attn=ATTN_FULL),),
        frontend="vision",
        n_frontend_tokens=2880,  # anyres: 4 tiles + base, 576 patches each
        rope_theta=5_000_000.0,
        long_500k_ok=False,
        long_500k_note="skipped: pure full-attention VLM backbone "
                       "(see DESIGN.md).",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, n_frontend_tokens=16,
        param_dtype="float32", dtype="float32",
    )
