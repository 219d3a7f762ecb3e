"""Architecture configs the port serves (port of ``repro.configs``).

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_smoke_config(arch_id)`` the reduced same-family config for CPU tests.
Every architecture of the JAX package is ported: the dense, MoE, SSM
(mamba2), hybrid (jamba), audio (encoder) and vlm (vision-prefix)
families.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ("internlm2_1_8b", "gemma3_1b", "starcoder2_3b", "mistral_large_123b",
            "qwen3_moe_235b_a22b", "dbrx_132b", "hubert_xlarge", "phi_3_vision_4_2b",
            "mamba2_2_7b", "jamba_1_5_large_398b")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"arch {arch_id!r} is not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG
