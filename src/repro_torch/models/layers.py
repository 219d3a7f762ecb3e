"""Shared layers: RMSNorm, RoPE, embeddings, the N:M-sparsifiable MLP
(port of ``repro.models.layers``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core.sparse_linear import (SparsityConfig, apply_gate_up, apply_linear,
                                  init_linear)
from ..kernels import epilogue as epilib

Params = Dict[str, Any]

_RMS_EPS = 1e-6


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + 1e-6) * (1 + gamma)`` in fp32, cast back
    (gamma is initialised to zeros, hence the ``1 +``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + _RMS_EPS)) * (1.0 + gamma.float())).to(x.dtype)


def init_rms_norm(d: int, device=None) -> Params:
    return {"gamma": torch.zeros((d,), dtype=torch.float32, device=device)}


#: rope_frequencies by (head_dim, theta, device): every layer asks again
_ROPE_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    key = (head_dim, theta, torch.device(device or "cpu"))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        # a plain tensor (not an inference tensor): usable in and out of
        # inference mode
        with torch.inference_mode(False), torch.no_grad():
            freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                                  device=key[2]) / head_dim))
        _ROPE_FREQS[key] = freqs
    return freqs


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rotation of :func:`apply_rope` at ``positions``: ``(cos, sin)``,
    each (..., T, 1, D/2) fp32, shared by the q and k of one layer."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs             # (..., T, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               cos_sin: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """x: (..., T, H, D); positions broadcastable to (..., T).  Split
    halves (not interleaved), rotated in fp32, cast back.  ``cos_sin`` is
    :func:`rope_cos_sin` at these positions, when the caller has it."""
    cos, sin = cos_sin or rope_cos_sin(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, d: int, ff: int, act: str, sp: SparsityConfig,
             dtype, device=None) -> Params:
    p = {"w_in": init_linear(gen, d, ff, sp, dtype, device=device)}
    if act == "swiglu":
        p["w_gate"] = init_linear(gen, d, ff, sp, dtype, device=device)
    p["w_out"] = init_linear(gen, ff, d, sp, dtype, scale=ff ** -0.5, device=device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, act: str, sp: SparsityConfig) -> torch.Tensor:
    from ..kernels import dispatch

    # Will w_out contract narrow (int8 | e4m3) rows against a calibrated
    # static scale on a kernel?  Then the producing kernel requantizes in
    # its flush (the gate-up dual, or the gelu MLP's single w_in) and w_out
    # takes the narrow rows as they are (one function decides for both
    # sides, so they cannot disagree).
    rq = dispatch.requant_plan(p["w_out"], x.shape[:-1], sp,
                               shard=dispatch.shard_spec_from_env("row"))
    requant, rq_scale = rq if rq is not None else (None, None)
    if act == "swiglu":
        # gate and up contract the same activation tile: one dual dispatch
        h = apply_gate_up(p["w_gate"], p["w_in"], x, sp, gather="col",
                          epilogue=epilib.make(act="silu_mul", requant=requant,
                                               requant_scale=rq_scale))
    else:
        h = apply_linear(p["w_in"], x, sp, gather="col",
                         epilogue=epilib.make(act="gelu", requant=requant,
                                              requant_scale=rq_scale))
    # rows that arrive narrow come out of w_out in fp32: back to the
    # residual stream's dtype
    return apply_linear(p["w_out"], h, sp, gather="row").to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   device=None) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
            * d ** -0.5).to(dtype)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]
