"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12L(enc)+12L(dec) d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206. The
speech frontend (mel-spectrogram + conv feature extractor) is a stub:
``launch/specs.input_specs`` supplies frame embeddings. [arXiv:2308.11596]
"""
from repro_torch.configs.base import ATTN_FULL, LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        arch_type="audio",
        source="arXiv:2308.11596",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=256_206,
        schedule=(LayerSpec(attn=ATTN_FULL),),
        encdec=True, n_enc_layers=12,
        frontend="audio",
        long_500k_ok=False,
        long_500k_note="skipped: enc-dec speech model; a 500k-token decode is "
                       "outside the model's operating regime (see DESIGN.md).",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, n_enc_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512,
        param_dtype="float32", dtype="float32",
    )
