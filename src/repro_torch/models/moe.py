"""Mixture-of-Experts, single device (port of ``repro.models.moe``).

The experts of a layer stay stacked: every expert linear is one leaf
whose tensors carry a leading ``E`` dim (``{"w": (E, K, O)}``, or the
compressed / gather layouts and their quantization scales the same way),
beside an fp32 ``router`` (d, E).  Routing is the JAX package's: fp32
router logits, top-k experts per token, softmax over the k gates, and
per expert a capacity of ``_capacity(T)`` tokens (top-C by combine
weight; tokens over capacity are dropped).  The experts run one after
another, in E order, each adding its weighted output into an accumulator
in the token dtype, as the JAX package's ``lax.scan`` over the stack does.

Expert execution (``cfg.moe_expert_path``):

- ``"gather"`` (the default): the capacity winners' rows are gathered
  into a dense (C, d) tile and run through the expert FFN.
- ``"spgemm"``: no gather.  Every row of the full token set that the
  expert does not take is zeroed, and the FFN runs on all T rows with
  ``ActivationSpec("zeros")``: the gate-up dual contracts the masked rows
  (it never skips, ``ACT_MASK_ONLY_DUAL``), and ``w_out`` plans its
  layout's masked kernel (``ACT_SKIP``), which skips the dead (row block,
  K step) tiles; an expert no token picked skips every one of them.  The
  FFN is row-independent and the combine is the same scatter-add, so the
  two paths agree bitwise on fp32.

Ties: ``lax.top_k`` breaks ties by the lowest index, and the capacity
selection runs over scores in which every token the expert does not take
is ``-inf`` (selected, when the capacity exceeds the routed tokens, in
index order).  ``torch.topk`` promises no order among ties, so both
selections here are a stable descending sort, sliced.

The sharded MoE (``_moe_shardmap``, experts sharded over the model axis)
waits for the port's sharding slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..core.sparse_linear import apply_gate_up, apply_linear, convert_layout, init_linear
from ..kernels.actsparse import ActivationSpec
from .config import ModelConfig

Params = Dict[str, Any]

__all__ = ["init_moe", "apply_moe"]


def _stack(gen: torch.Generator, cfg: ModelConfig, kin: int, kout: int, scale: float,
           device) -> Params:
    """One expert linear per expert, in the layout ``cfg.sparsity`` names,
    stacked along a leading E dim: ``init_linear``'s draws, made for the
    whole stack at once (the gather layout draws per expert)."""
    sp = cfg.sparsity
    if sp.mode == "gather" and sp.is_sparse:
        leaves = [init_linear(gen, kin, kout, sp, cfg.torch_dtype, scale=scale, device=device)
                  for _ in range(cfg.num_experts)]
        return {k: torch.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
    w = (torch.randn((cfg.num_experts, kin, kout), generator=gen, dtype=torch.float32,
                     device=device) * scale).to(cfg.torch_dtype)
    if sp.mode == "compressed" and sp.is_sparse:
        return convert_layout({"w": w}, sp, "compressed")
    return {"w": w}


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Random router (fp32) and expert stacks from ``gen``."""
    d, ff = cfg.d_model, cfg.d_ff
    p = {"router": torch.randn((d, cfg.num_experts), generator=gen, dtype=torch.float32,
                               device=device) * d ** -0.5,
         "w_in": _stack(gen, cfg, d, ff, d ** -0.5, device)}
    if cfg.act == "swiglu":
        p["w_gate"] = _stack(gen, cfg, d, ff, d ** -0.5, device)
    p["w_out"] = _stack(gen, cfg, ff, d, ff ** -0.5, device)
    return p


def _experts(experts: Params, n: int) -> list:
    """The first ``n`` experts' slices of the stacked leaves, one dict of
    views each (0-dim leaves, a calibrated scalar ``act_scale`` or a
    calibration tag, are shared by the stack)."""
    cols = {name: {k: v.unbind(0)[:n] if isinstance(v, torch.Tensor) and v.ndim else None
                   for k, v in leaf.items()}
            for name, leaf in experts.items()}
    return [{name: {k: v if cols[name][k] is None else cols[name][k][e]
                    for k, v in leaf.items()}
             for name, leaf in experts.items()}
            for e in range(n)]


def _ffn_epilogue(w_out: Params, rows: int, cfg: ModelConfig):
    """The gate-up's (or the gelu w_in's) epilogue for ``rows`` rows into
    ``w_out``: its static scale lets the producing kernel requantize in
    its flush (as in layers.apply_mlp).  One decision serves every expert
    of a stack: their ``w_out`` leaves share layout, shape and the scalar
    ``act_scale``."""
    from ..kernels import dispatch
    from ..kernels import epilogue as epilib

    rq = dispatch.requant_plan(w_out, (rows,), cfg.sparsity)
    requant, rq_scale = rq if rq is not None else (None, None)
    return epilib.make(act="silu_mul" if cfg.act == "swiglu" else "gelu", requant=requant,
                       requant_scale=rq_scale)


def _expert_ffn(wp: Params, x: torch.Tensor, cfg: ModelConfig, epilogue,
                activation: ActivationSpec = None, local: bool = False) -> torch.Tensor:
    """One expert's FFN on x (rows, d); ``epilogue`` is
    :func:`_ffn_epilogue`'s for these rows."""
    sp = cfg.sparsity
    if cfg.act == "swiglu":
        h = apply_gate_up(wp["w_gate"], wp["w_in"], x, sp, epilogue=epilogue,
                          activation=activation, local=local)
    else:
        h = apply_linear(wp["w_in"], x, sp, epilogue=epilogue, activation=activation,
                         local=local)
    # the FFN is row-wise: rows zeroed on the way in stay zero in h, so the
    # "zeros" class carries through to w_out (whose kernel skips them);
    # narrow rows come out of w_out in fp32, back to the token dtype
    return apply_linear(wp["w_out"], h, sp, activation=activation, local=local).to(x.dtype)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, ties to the lowest
    index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router: torch.Tensor, xf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xf: (T, d) -> combine weights (T, E), zero where a token is not routed."""
    logits = xf.float() @ router.float()                  # (T, E)
    gates, ids = _top_k(logits, cfg.top_k)
    gates = torch.exp(gates - gates.amax(dim=-1, keepdim=True))
    gates = gates / gates.sum(dim=-1, keepdim=True)       # jax.nn.softmax
    return torch.zeros_like(logits).scatter(-1, ids, gates)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity for one routed token set (the JAX package's:
    a decode step's B tokens never drop, a prefill chunk may)."""
    c = int(math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.moe_capacity_factor))
    return min(tokens, max(8, c))


def _moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig, n_local: int) -> torch.Tensor:
    """Experts stacked (n_local, ...).  x: (B, T, d) -> (B, T, d)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    weights = _route(p["router"], xf, cfg)               # (T, E)
    cap = _capacity(b * t, cfg)
    experts = {k: v for k, v in p.items() if k != "router"}
    spgemm = cfg.moe_expert_path == "spgemm"
    # every expert's capacity selection at once, row e of each (E, ...)
    # tensor being what expert e alone would select
    w_t = weights[:, :n_local].T                         # (E, T) combine weights
    score = torch.where(w_t > 0, w_t, float("-inf"))
    top_w, top_idx = _top_k(score, cap)                  # (E, cap) capacity winners
    kept = torch.where(top_w > 0, top_w, 0.0)
    kept_x = kept[:, :, None].to(xf.dtype)
    if spgemm:
        # the winners keep their rows, every other row is zeroed: the
        # FFN's routing holes become activation sparsity
        routed = torch.zeros(w_t.shape, dtype=torch.bool, device=w_t.device)
        routed.scatter_(1, top_idx, kept > 0)
        routed = routed[:, :, None].to(xf.dtype)
    acc = torch.zeros_like(xf)
    ws = _experts(experts, n_local)
    epilogue = _ffn_epilogue(ws[0]["w_out"], b * t if spgemm else cap, cfg)
    for e, wp in enumerate(ws):
        if spgemm:
            y_e = _expert_ffn(wp, xf * routed[e], cfg, epilogue,
                              activation=ActivationSpec("zeros"))[top_idx[e]]
        else:
            y_e = _expert_ffn(wp, xf[top_idx[e]], cfg, epilogue)   # (cap, d)
        acc.index_add_(0, top_idx[e], y_e * kept_x[e])
    return acc.reshape(b, t, d)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE FFN on one device (the JAX package's path without a mesh)."""
    return _moe_local(p, x, cfg, cfg.num_experts)
