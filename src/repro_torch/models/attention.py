"""Attention projections: GQA + RoPE (port of the parts of
``repro.models.attention`` the paged serving path uses)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.sparse_linear import apply_linear, init_linear
from .config import ModelConfig
from .layers import apply_rope

Params = Dict[str, Any]
NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, sp, dt = cfg.d_model, cfg.sparsity, cfg.torch_dtype
    return {
        "wq": init_linear(gen, d, cfg.attn_dim, sp, dt, device=device),
        "wk": init_linear(gen, d, cfg.kv_dim, sp, dt, device=device),
        "wv": init_linear(gen, d, cfg.kv_dim, sp, dt, device=device),
        "wo": init_linear(gen, cfg.attn_dim, d, sp, dt,
                          scale=cfg.attn_dim ** -0.5, device=device),
    }


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, t, _ = x.shape
    sp = cfg.sparsity
    q = apply_linear(p["wq"], x, sp).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = apply_linear(p["wk"], x, sp).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = apply_linear(p["wv"], x, sp).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, T, H, D) -> (B, Hkv, G, T, D) without materializing repeats."""
    b, t, h, d = q.shape
    g = h // cfg.num_kv_heads
    return q.reshape(b, t, cfg.num_kv_heads, g, d).permute(0, 2, 3, 1, 4)
