"""The dense, MoE, SSM (Mamba-2) and hybrid (Jamba) decoders on the serving
path, and the audio encoder and vision-prefix decoder on the prefill path
(port of ``repro.models``)."""

from .config import ModelConfig
from .lm import make_prefill_step
from .moe import apply_moe, init_moe
from .paged import (init_paged_caches, paged_decode_step, paged_prefill_chunk,
                    reset_slot_state)
from .ssm import decode_mamba_block, init_mamba, init_ssm_cache, mamba_block
from .transformer import build_layout, cached_stack, forward, init_params, layer_site_keys

__all__ = [
    "ModelConfig",
    "apply_moe",
    "build_layout",
    "cached_stack",
    "decode_mamba_block",
    "forward",
    "init_mamba",
    "init_moe",
    "init_params",
    "init_paged_caches",
    "init_ssm_cache",
    "make_prefill_step",
    "mamba_block",
    "paged_decode_step",
    "paged_prefill_chunk",
    "layer_site_keys",
    "reset_slot_state",
]
