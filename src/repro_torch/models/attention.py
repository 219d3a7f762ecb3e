"""Attention: GQA + RoPE projections, the chunked online-softmax full
attention and the full-sequence attention sub-layer (port of the parts of
``repro.models.attention`` the serving path uses: the paged path's
projections, and ``attention_block`` for ``transformer.forward``, which
calibration runs).  ``attention_block`` routes through the dispatch
engine (``kernels.dispatch.attention``): the hand-written
``flash_attention`` kernel on the cuda backend, :func:`chunked_attention`
otherwise.  Only global attention is ported (the dense family has no
local layers)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.sparse_linear import apply_linear, init_linear
from .config import ModelConfig
from .layers import apply_rope

Params = Dict[str, Any]
NEG_INF = -1e30
ATTN_CHUNK = 1024    # KV chunk of the online softmax (the JAX config's default)


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


def chunked_attention(q, k, v, q_offset: int = 0, p_bf16: bool = False) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks of ``ATTN_CHUNK`` keys
    in plain torch (the forward of the JAX package's ``_attn_fwd_impl``;
    the port serves, so it keeps no log-sum-exp for a backward).
    q (B, Hkv, G, Tq, D) holds queries at positions ``q_offset + i``; k, v
    (B, Tk, Hkv, D) -> (B, Hkv, G, Tq, D) in q's dtype."""
    b, hkv, g, tq, d = q.shape
    tk = k.shape[1]
    chunk = min(ATTN_CHUNK, tk)
    if tk % chunk:
        raise ValueError(f"chunked attention: Tk={tk} is not a multiple of chunk={chunk}")
    # q is scaled in its own dtype (the scale rounded to it), as the JAX
    # package multiplies by jnp.asarray(scale, q.dtype); fp32 accumulation
    qf = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).float()
    q_pos = q_offset + torch.arange(tq, device=q.device)
    m = torch.full((b, hkv, g, tq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, tq, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, tq, d), device=q.device)
    for j in range(tk // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk].transpose(1, 2).float()    # (B,Hkv,C,D)
        vj = v[:, j * chunk:(j + 1) * chunk].transpose(1, 2).float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kj)
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if p_bf16:
            p = p.to(torch.bfloat16).float()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (global, causal) attention sub-layer for a prefill/forward.
    x: (B, T, d)."""
    from ..kernels.dispatch import attention as engine_attention   # local: avoid a cycle

    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = engine_attention(_grouped(q, cfg), k, v, p_bf16=cfg.attn_p_bf16)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, t, cfg.attn_dim).to(x.dtype)
    return apply_linear(p["wo"], o, cfg.sparsity)
