"""Task heads (port of the prefill part of ``repro.models.lm``).

:func:`make_prefill_step` returns the full-sequence forward of one batch,
dispatched on the config's frontend as in the JAX package: frame
embeddings for the audio encoder, patch embeddings in front of text
tokens for the vision-prefix decoder, tokens otherwise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .config import ModelConfig
from .transformer import forward

Params = Dict[str, Any]


def make_prefill_step(cfg: ModelConfig) -> Callable[[Params, Dict[str, torch.Tensor]],
                                                    torch.Tensor]:
    """``prefill_step(params, batch) -> logits (B, T, V)``; ``batch`` holds
    ``"frames"`` (B, T, d) for ``frontend="audio_frames"``, ``"tokens"``
    (B, T - P) and ``"patches"`` (B, P, d) for ``"vision_patches"``, and
    ``"tokens"`` (B, T) otherwise."""
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if cfg.frontend == "audio_frames":
            return forward(params, cfg, embeds=batch["frames"])
        if cfg.frontend == "vision_patches":
            return forward(params, cfg, tokens=batch["tokens"], embeds=batch["patches"])
        return forward(params, cfg, tokens=batch["tokens"])

    return prefill_step
