"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060]
"""
from repro_torch.configs.base import (KIND_MAMBA, LayerSpec, MambaConfig,
                                      ModelConfig)

_MAMBA = LayerSpec(kind=KIND_MAMBA, mlp="none")


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        arch_type="ssm",
        source="arXiv:2405.21060",
        n_layers=48, d_model=1024, n_heads=32, n_kv_heads=0, head_dim=64,
        d_ff=0, vocab_size=50_280,
        schedule=(_MAMBA,),
        mamba=MambaConfig(d_state=128, expand=2, head_dim=64,
                          conv_width=4, chunk=256),
        tie_embeddings=True,
        long_500k_ok=True,
        long_500k_note="attention-free; decode carries a constant-size SSM "
                       "state, no KV cache.",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, vocab_size=512,
        mamba=MambaConfig(d_state=16, expand=2, head_dim=64,
                          conv_width=4, chunk=32),
        param_dtype="float32", dtype="float32",
    )
