"""Architecture registry of the port: ``get_config('<arch-id>')`` returns the
exact published config, ``get_smoke('<arch-id>')`` the reduced same-family
smoke config. Every architecture of the reference is listed, in its
order: the dense family, the MoE family, the recurrent families Griffin
(recurrentgemma-2b) and Mamba2 (mamba2-2.7b), the VLM
(llama-3.2-vision-11b) and the encoder (hubert-xlarge)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, GriffinConfig,
                                      Mamba2Config, MoEConfig,
                                      ParallelConfig, QuantPolicy, VLMConfig)
from repro_torch.core.swis import QuantConfig

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "dbrx-132b": "dbrx_132b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "mistral-large-123b": "mistral_large_123b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "smollm-135m": "smollm_135m",
    "deepseek-7b": "deepseek_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "ArchConfig", "GriffinConfig", "Mamba2Config",
           "MoEConfig", "ParallelConfig", "QuantConfig", "QuantPolicy",
           "VLMConfig", "get_config", "get_smoke"]


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE
