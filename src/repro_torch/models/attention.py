"""Attention: GQA + RoPE projections, the chunked online-softmax full
attention and the full-sequence attention sub-layer (port of the parts of
``repro.models.attention`` the serving path uses: the paged path's
projections, and ``attention_block`` for ``transformer.forward``, which
calibration and ``lm.make_prefill_step`` run; causal, or not for an
encoder).  ``attention_block`` routes a global layer, or a local
one whose window covers the sequence, through the dispatch engine
(``kernels.dispatch.attention``): the hand-written ``flash_attention``
kernel on the cuda backend, :func:`chunked_attention` otherwise; a local
layer (gemma3's sliding window) whose window is shorter than the
sequence runs the banded :func:`local_attention`, plain torch as in the
JAX package (which has no kernel for it)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.sparse_linear import apply_linear, init_linear
from .config import ModelConfig
from .layers import apply_rope, rope_cos_sin

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
    """Column-parallel q / k / v: under an axis env each rank's projections
    give its own heads (H / M query, KV / M KV heads), so the head counts
    come from the widths."""
    b, t, _ = x.shape
    sp = cfg.sparsity
    q = apply_linear(p["wq"], x, sp, gather="col").reshape(b, t, -1, cfg.head_dim)
    k = apply_linear(p["wk"], x, sp, gather="col").reshape(b, t, -1, cfg.head_dim)
    v = apply_linear(p["wv"], x, sp, gather="col").reshape(b, t, -1, cfg.head_dim)
    cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, cos_sin)
    k = apply_rope(k, positions, cfg.rope_theta, cos_sin)
    return q, k, v


def _grouped(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, T, H, D) -> (B, Hkv, G, T, D) without materializing repeats (H
    and Hkv a rank's own under an axis env: G is the config's)."""
    b, t, h, d = q.shape
    g = cfg.num_heads // cfg.num_kv_heads
    return q.reshape(b, t, h // g, g, d).permute(0, 2, 3, 1, 4)


def chunked_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                      p_bf16: bool = False) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``ATTN_CHUNK`` keys in
    plain torch, causal or not (the forward of the JAX package's
    ``_attn_fwd_impl``; the port serves, so it keeps no log-sum-exp for a
    backward).
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
        if causal:
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


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                    p_bf16: bool = False) -> torch.Tensor:
    """Banded causal attention: position t attends to (t - window, t] (the
    JAX package's ``local_attention``).  q (B, Hkv, G, T, D); k, v (B, T,
    Hkv, D) -> (B, Hkv, G, T, D) in fp32.

    Q-chunked: chunk i of ``cq = min(window, T)`` queries scores the
    ``window + cq`` keys of a left-padded KV that end at its last query,
    so the cost is O(T * window).  Scores in fp32 from q scaled in its own
    dtype, masked to the band (and to keys at position >= 0) at
    ``NEG_INF``, a plain softmax, probabilities fp32 unless ``p_bf16``."""
    b, hkv, g, t, d = q.shape
    cq = min(window, t)
    if t % cq:
        raise ValueError(f"local attention: T={t} is not a multiple of the query "
                         f"chunk {cq}")
    span = window + cq
    qs = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).float()
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, window, 0)).float()
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, window, 0))
    out = []
    for i in range(t // cq):
        ks = kp[:, i * cq:i * cq + span]
        vs = vp[:, i * cq:i * cq + span]
        s = torch.einsum("bhgqd,bkhd->bhgqk", qs[:, :, :, i * cq:(i + 1) * cq], ks)
        q_pos = i * cq + torch.arange(cq, device=q.device)
        k_pos = i * cq - window + torch.arange(span, device=q.device)
        delta = q_pos[:, None] - k_pos[None, :]
        mask = (delta >= 0) & (delta < window) & (k_pos[None, :] >= 0)
        s = torch.where(mask, s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        if p_bf16:
            pr = pr.to(vs.dtype)
        out.append(torch.einsum("bhgqk,bkhd->bhgqd", pr.float(), vs.float()))
    return torch.cat(out, dim=3)


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *, is_global: bool = True,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention sub-layer for a prefill/forward, causal unless the config
    is an encoder's (``cfg.causal``).  x: (B, T, d).  The JAX package's
    branch: a global layer, or a window that is off or covers the
    sequence, goes to the dispatch engine (flash_attention on the cuda
    backend); a local layer with a shorter window to
    :func:`local_attention` (causal, as in the JAX package)."""
    from ..kernels.dispatch import attention as engine_attention   # local: avoid a cycle

    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if is_global or cfg.window <= 0 or cfg.window >= t:
        o = engine_attention(_grouped(q, cfg), k, v, causal=cfg.causal,
                             p_bf16=cfg.attn_p_bf16)
    else:
        o = local_attention(_grouped(q, cfg), k, v, window=cfg.window,
                            p_bf16=cfg.attn_p_bf16)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, t, -1).to(x.dtype)
    return apply_linear(p["wo"], o, cfg.sparsity, gather="row")
