"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400. First layer is a dense
MLP (d_ff=12288), the rest are MoE. [arXiv:2405.04434]
"""
from repro_torch.configs.base import (ATTN_MLA, LayerSpec, MLAConfig,
                                      ModelConfig, MoEConfig)

_MLA_DENSE = LayerSpec(attn=ATTN_MLA, mlp="dense")
_MLA_MOE = LayerSpec(attn=ATTN_MLA, mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        source="arXiv:2405.04434",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=12_288, vocab_size=102_400,
        prefix=(_MLA_DENSE,),
        schedule=(_MLA_MOE,),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                      n_shared=2, d_ff_shared=3072),
        long_500k_ok=False,
        long_500k_note="skipped: pure full MLA attention, no sliding-window "
                       "variant in the source model (see DESIGN.md).",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        prefix=(_MLA_DENSE,), schedule=(_MLA_MOE,),
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared=1, d_ff_shared=64),
        param_dtype="float32", dtype="float32",
    )
