"""The dense decoder on the serving path (port of ``repro.models``)."""

from .config import ModelConfig
from .paged import (init_paged_caches, paged_decode_step, paged_prefill_chunk,
                    reset_slot_state)
from .transformer import build_layout, cached_stack, init_params

__all__ = [
    "ModelConfig",
    "build_layout",
    "cached_stack",
    "init_params",
    "init_paged_caches",
    "paged_decode_step",
    "paged_prefill_chunk",
    "reset_slot_state",
]
