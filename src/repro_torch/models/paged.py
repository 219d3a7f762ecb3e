"""Paged-KV decode: block-table attention + chunked prefill for serving
(port of ``repro.models.paged``, float KV only).

KV lives in fixed-size blocks, one pool pair per attention layer shaped
``(num_blocks, block_len, Hkv, D)``; each request maps its logical
positions onto physical blocks through its row of the block table.
Writes are masked: idle slots and padding tokens write into the reserved
scratch block 0, which no table row references for a live position.

The pools are updated in place (``index_put_``) to avoid copying every
pool on every step; the functions still return the caches, so callers
read like the JAX package's functional versions.  The attention itself
stays plain torch ops (the JAX package has no Pallas kernel here
either): q is scaled in its own dtype, both einsums accumulate in fp32,
masked scores are ``NEG_INF`` (keys after the query, and on a local layer
keys a window or more behind it), and the probabilities stay fp32 unless
``cfg.attn_p_bf16``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..core.sparse_linear import apply_linear
from .attention import NEG_INF, _grouped, _project_qkv
from .config import ModelConfig
from .layers import embed
from .transformer import cached_stack, layer_slots

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

__all__ = [
    "check_paged",
    "init_paged_caches",
    "paged_decode_step",
    "paged_prefill_chunk",
    "reset_slot_state",
]


def check_paged(cfg: ModelConfig) -> None:
    """The paged path embeds token ids and attends causally: it refuses a
    config that takes embeddings through a frontend (``audio_frames``,
    ``vision_patches``) or attends both ways.  Those run their prefill
    forward through ``models.make_prefill_step``."""
    if cfg.frontend != "none" or not cfg.causal:
        raise ValueError(
            f"{cfg.name}: the paged serving path takes token ids and attends causally; "
            f"frontend {cfg.frontend!r} / causal={cfg.causal} runs through "
            f"models.make_prefill_step")


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_len: int,
                      device=None) -> List[Cache]:
    """One ``{"k", "v"}`` pool pair per layer; ``num_blocks`` includes the
    scratch block 0.  Under an axis env the pools hold this rank's KV heads
    (KV / M).  (The JAX package's ``batch`` argument sizes SSM state,
    which the dense family has none of.)"""
    from .pjit_utils import axis_env
    check_paged(cfg)
    env = axis_env()
    heads = cfg.num_kv_heads // (env.model_size if env is not None else 1)
    shape = (num_blocks, block_len, heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
            for _ in layer_slots(cfg)]


def _write_kv(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
              phys: torch.Tensor, off: torch.Tensor) -> Cache:
    """Scatter N new (head, dim) vectors into the pools at (phys, off), in
    place."""
    cache["k"].index_put_((phys, off), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((phys, off), v_new.to(cache["v"].dtype))
    return cache


def _gather_kv(cache: Cache, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-table gather -> (B, W*block_len, Hkv, D) contiguous views."""
    k = cache["k"][table]                       # (B, W, BL, H, D)
    b, w, bl, h, d = k.shape
    return k.reshape(b, w * bl, h, d), cache["v"][table].reshape(b, w * bl, h, d)


def _scale(cfg: ModelConfig, dtype: torch.dtype) -> float:
    """``head_dim ** -0.5`` rounded to ``dtype`` first, as the JAX package
    scales q by ``jnp.asarray(scale, q.dtype)``; a Python float keeps the
    multiply free of a host-to-device copy."""
    return torch.tensor(cfg.head_dim ** -0.5, dtype=dtype).item()


def _paged_attention(p: Params, x: torch.Tensor, cache: Cache,
                     positions: torch.Tensor, table: torch.Tensor,
                     write_mask: torch.Tensor, cfg: ModelConfig, *, is_global: bool,
                     block_len: int) -> Tuple[torch.Tensor, Cache]:
    """x: (B, T, d); positions, write_mask: (B, T); table: (B, W).  A local
    layer (``is_global`` False, ``cfg.window`` > 0) also masks the keys
    ``window`` or more positions behind the query (its pool stays
    full-length, as in the JAX package)."""
    b, t, _ = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    # positions past the table only occur on masked (padding) writes
    blk = (positions // block_len).clamp(max=table.shape[1] - 1)
    phys = torch.where(write_mask, torch.gather(table, 1, blk), 0).reshape(b * t)
    off = torch.where(write_mask, positions % block_len, 0).reshape(b * t)
    cache = _write_kv(cache, k_new.reshape(b * t, -1, cfg.head_dim),
                      v_new.reshape(b * t, -1, cfg.head_dim), phys, off)

    k, v = _gather_kv(cache, table)
    qg = _grouped(q, cfg)                                     # (B,Hkv,G,T,D)
    s = torch.einsum("bhgqd,bkhd->bhgqk", (qg * _scale(cfg, qg.dtype)).float(),
                     k.float())
    j = torch.arange(k.shape[1], device=x.device)
    valid = j[None, None, :] <= positions[:, :, None]         # (B, T, L)
    if not is_global and cfg.window > 0:
        valid = valid & (positions[:, :, None] - j[None, None, :] < cfg.window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    if cfg.attn_p_bf16:
        pr = pr.to(v.dtype).float()
    o = torch.einsum("bhgqk,bkhd->bhgqd", pr, v.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(b, t, -1).to(x.dtype)
    return apply_linear(p["wo"], o, cfg.sparsity, gather="row"), cache


def paged_decode_step(params: Params, caches: List[Cache], tokens: torch.Tensor,
                      positions: torch.Tensor, table: torch.Tensor,
                      active: torch.Tensor, cfg: ModelConfig, block_len: int
                      ) -> Tuple[torch.Tensor, List[Cache]]:
    """Batched single-token decode against block tables.

    tokens (B, 1); positions (B,) per-slot index of the new token; table
    (B, W); active (B,) bool.  Inactive slots write to the scratch block
    and their logits are garbage the scheduler discards."""
    x = embed(params["embed"], tokens)
    pos2 = positions.long()[:, None]
    wmask = active[:, None]

    def mixer(slot, lp, lc, h):
        return _paged_attention(lp["mixer"], h, lc, pos2, table.long(), wmask,
                                cfg, is_global=slot.mixer == "attn", block_len=block_len)

    return cached_stack(params, caches, x, cfg, mixer)


def paged_prefill_chunk(params: Params, caches: List[Cache], tokens: torch.Tensor,
                        pos0: int, table: torch.Tensor, n_valid: int,
                        cfg: ModelConfig, block_len: int
                        ) -> Tuple[torch.Tensor, List[Cache]]:
    """One prefill chunk for one request: tokens (1, C) enter the pools in
    one forward (in-chunk causality through the position mask); returns
    logits for every chunk position.  (The JAX package's ``slot_idx``
    addresses SSM state, which the dense family has none of.)"""
    c = tokens.shape[1]
    x = embed(params["embed"], tokens)
    ar = torch.arange(c, device=tokens.device)
    positions = (pos0 + ar)[None, :]
    wmask = (ar < n_valid)[None, :]

    def mixer(slot, lp, lc, h):
        return _paged_attention(lp["mixer"], h, lc, positions, table.long(), wmask,
                                cfg, is_global=slot.mixer == "attn", block_len=block_len)

    return cached_stack(params, caches, x, cfg, mixer)


def reset_slot_state(caches: List[Cache], slot_index: int) -> List[Cache]:
    """Zero one slot's per-request recurrent state.  Attention pools are
    block-addressed and need no reset (freed blocks are rewritten before
    they are read again), so for the dense family this returns the caches
    unchanged."""
    return caches
