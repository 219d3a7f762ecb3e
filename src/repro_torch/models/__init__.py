"""The dense decoder on the serving path (port of ``repro.models``)."""

from .config import ModelConfig
from .paged import (init_paged_caches, paged_decode_step, paged_prefill_chunk,
                    reset_slot_state)
from .transformer import build_layout, cached_stack, forward, init_params, layer_site_keys

__all__ = [
    "ModelConfig",
    "build_layout",
    "cached_stack",
    "forward",
    "init_params",
    "init_paged_caches",
    "paged_decode_step",
    "paged_prefill_chunk",
    "layer_site_keys",
    "reset_slot_state",
]
