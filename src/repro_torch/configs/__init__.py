"""Architecture registry (port of ``repro.configs``).

Each ported architecture lives in its own module exposing ``config()`` (the
exact published numbers) and ``reduced()`` (a 2-layer, narrow member of the
same family for the CPU tests): the reference's whole LM zoo, dense, MoE,
MLA, Mamba2, hybrid, encoder-decoder (seamless-m4t-medium) and a vision
frontend (llava-next-34b).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    ATTN_CHUNKED, ATTN_FULL, ATTN_MLA, ATTN_SLIDING, KIND_ATTN, KIND_MAMBA,
    FedConfig, LayerSpec, MambaConfig, MLAConfig, ModelConfig, MoEConfig,
    ShapeConfig, SHAPES,
)

# arch id -> module name
_ARCHS: Dict[str, str] = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "gemma2-2b": "gemma2_2b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-370m": "mamba2_370m",
    "llava-next-34b": "llava_next_34b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "gemma3-12b": "gemma3_12b",
    "olmo-1b": "olmo_1b",
    "llama3.2-1b": "llama3_2_1b",
}


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
