"""Mamba-2 (SSD, state-space duality) block: the chunked full-sequence scan
and the O(1) single-token decode step (port of ``repro.models.ssm``).
ngroups = 1 (B and C are shared across heads).

``wz``, ``wx`` and ``w_out`` are ``SparseLinear``s and run through the
dispatch engine (``apply_linear``: a CUDA kernel of their layout and class
on the card); ``wB``, ``wC`` and ``wdt`` are plain (d, ·) matrices and stay
plain matmuls, as in the JAX package.  The JAX package has no Pallas
kernel for the SSM itself, and neither has the port: the causal conv, the
scan and the recurrence are torch ops.

Dtypes are the JAX package's: the conv's sums and its silu run in fp32 and
the result is cast to the model dtype; ``softplus(dt_raw + dt_bias)`` runs
in fp32; the recurrent state is fp32, ``(B, nh, ds, hd)``; the gate
``y * silu(z)`` is in the model dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.sparse_linear import apply_linear, init_linear
from .config import ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

__all__ = ["init_mamba", "mamba_block", "init_ssm_cache", "decode_mamba_block"]


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Random weights from ``gen`` (on ``device``), in the layout
    ``cfg.sparsity`` names; the fp32 leaves ``dt_bias``, ``A_log`` and
    ``D`` start at the JAX package's constants."""
    d, di, g, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    sp, dt = cfg.sparsity, cfg.torch_dtype

    def plain(rows: int, cols: int, scale: float) -> torch.Tensor:
        return (torch.randn((rows, cols), generator=gen, dtype=torch.float32, device=device)
                * scale).to(dt)

    return {
        "wz": init_linear(gen, d, di, sp, dt, device=device),
        "wx": init_linear(gen, d, di, sp, dt, device=device),
        "wB": plain(d, g, d ** -0.5),
        "wC": plain(d, g, d ** -0.5),
        "wdt": plain(d, nh, d ** -0.5),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=device),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "conv_w": plain(cfg.ssm_conv, di + 2 * g, cfg.ssm_conv ** -0.5),
        "w_out": init_linear(gen, di, d, sp, dt, scale=di ** -0.5, device=device),
    }


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as shifted adds in fp32, then silu, cast back.
    xbc: (B, T, C); conv_w: (W, C).  The W - 1 rows in front of the
    sequence are ``history`` (B, W - 1, C), zeros when it is None."""
    w, t = conv_w.shape[0], xbc.shape[1]
    if history is None:
        history = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[2]))
    pad = torch.cat([history.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(w):
        out = out + pad[:, i:i + t].float() * conv_w[i].float()
    return F.silu(out).to(xbc.dtype)


def _ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: the intra-chunk quadratic term plus the inter-chunk
    state scan.  x (B, T, nh, hd); dt (B, T, nh) softplus'd; A (nh,) <= 0;
    Bm, Cm (B, T, ds).  Returns (y (B, T, nh, hd) fp32, the final state
    (B, nh, ds, hd)).

    The JAX package's three-operand ``y_intra`` einsum is contracted
    pairwise here (scores x decay first, then x xdt over ``j``), so no
    (B, nc, Q, Q, nh, hd) tensor is made; its ``lax.scan`` over the chunk
    states is a Python loop over the chunks."""
    b, t, nh, hd = x.shape
    ds = Bm.shape[-1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the scan chunk {chunk}")
    nc = t // chunk
    xc = x.reshape(b, nc, chunk, nh, hd).float()
    dtc = dt.reshape(b, nc, chunk, nh)
    Bc = Bm.reshape(b, nc, chunk, ds).float()
    Cc = Cm.reshape(b, nc, chunk, ds).float()

    cum = torch.cumsum(dtc * A, dim=2)                        # (B,nc,Q,nh), decreasing
    seg_end = cum[:, :, -1:, :]                               # (B,nc,1,nh)

    # intra-chunk: y_i += sum_{j<=i} C_i.B_j * exp(cum_i - cum_j) * dt_j * x_j
    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)          # (B,nc,Q,Q)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,Q,Q,nh)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None], torch.exp(li), 0.0)
    xdt = xc * dtc[..., None]                                 # (B,nc,Q,nh,hd)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, xdt)

    # each chunk's outgoing state: S_c = sum_j exp(seg_end - cum_j) dt_j B_j x_j
    S = torch.einsum("bcjs,bcjhp->bchsp", Bc, xdt * torch.exp(seg_end - cum)[..., None])

    # the running state entering each chunk: h_c = exp(seg_end_{c-1}) h_{c-1} + S_{c-1}
    seg = torch.exp(seg_end[:, :, 0, :])                      # (B,nc,nh)
    h = h0 if h0 is not None else x.new_zeros((b, nh, ds, hd), dtype=torch.float32)
    runs = []
    for c in range(nc):
        runs.append(h)
        h = h * seg[:, c, :, None, None] + S[:, c]
    s_run = torch.stack(runs, dim=1)                          # (B,nc,nh,ds,hd)

    # inter-chunk: y_i += (C_i . h_c) * exp(cum_i)
    y = y + torch.einsum("bcis,bchsp->bcihp", Cc, s_run) * torch.exp(cum)[..., None]
    return y.reshape(b, t, nh, hd), h


def _in_proj(p: Params, x: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The input projections over every row of x (B, T, d): z and the
    conv's input [x | B | C] (B, T, d_inner + 2 ds), model dtype, and
    dt_raw (B, T, nh)."""
    sp = cfg.sparsity
    z = apply_linear(p["wz"], x, sp, gather="col").to(x.dtype)
    xin = apply_linear(p["wx"], x, sp, gather="col").to(x.dtype)
    Bm = x @ p["wB"].to(x.dtype)
    Cm = x @ p["wC"].to(x.dtype)
    dt_raw = x @ p["wdt"].to(x.dtype)
    return z, torch.cat([xin, Bm, Cm], dim=-1), dt_raw


def _split(xbc: torch.Tensor, cfg: ModelConfig):
    di, g = cfg.d_inner, cfg.ssm_state
    return xbc[..., :di], xbc[..., di:di + g], xbc[..., di + g:]


def _dt(p: Params, dt_raw: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt_raw.float() + p["dt_bias"])


def _out(p: Params, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    """The D skip, the gate and ``w_out``: y, xh (..., nh, hd) fp32; z
    (..., d_inner) model dtype."""
    y = y + xh * p["D"][:, None]
    y = y.reshape(z.shape).to(z.dtype) * F.silu(z)
    return apply_linear(p["w_out"], y, cfg.sparsity, gather="row").to(z.dtype)


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, chunk: int = 128
                ) -> torch.Tensor:
    """Full-sequence forward. x: (B, T, d) -> (B, T, d); T a multiple of
    ``min(chunk, T)``."""
    b, t, _ = x.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _in_proj(p, x, cfg)
    xin, Bm, Cm = _split(_causal_conv(xbc, p["conv_w"]), cfg)
    xh = xin.reshape(b, t, nh, hd)
    y, _ = _ssd_scan(xh, _dt(p, dt_raw), -torch.exp(p["A_log"]), Bm, Cm, chunk)
    return _out(p, y, xh.float(), z, cfg)


# ------------------------------------------------------------------ decode
def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> Cache:
    """The per-request recurrent state: the conv's last W - 1 inputs
    (batch, W - 1, d_inner + 2 ds) in the model dtype and the SSM state
    (batch, nh, ds, hd) fp32."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=cfg.torch_dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }


def decode_mamba_block(p: Params, x: torch.Tensor, cache: Cache, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Cache]:
    """Single-token step. x: (B, 1, d) -> ((B, 1, d), the advanced cache)."""
    b = x.shape[0]
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _in_proj(p, x, cfg)
    hist = torch.cat([cache["conv"], xbc], dim=1)                     # (B, W, C)
    conv = torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float())
    xin, Bm, Cm = _split(F.silu(conv).to(x.dtype), cfg)
    dt = _dt(p, dt_raw[:, 0])                                         # (B, nh)
    a = torch.exp(dt * -torch.exp(p["A_log"]))
    xh = xin.reshape(b, nh, hd).float()
    upd = Bm.float()[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]
    state = cache["state"] * a[:, :, None, None] + upd                # (B, nh, ds, hd)
    y = torch.einsum("bs,bhsp->bhp", Cm.float(), state)
    return _out(p, y, xh, z[:, 0], cfg)[:, None], {"conv": hist[:, 1:], "state": state}
