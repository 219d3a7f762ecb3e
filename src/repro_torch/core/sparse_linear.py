"""SparseLinear: the N:M sparse projection, dense, compressed and gather
layouts.

The port's copy of ``repro.core.sparse_linear`` for the serving layouts
ported so far:

  dense        {"w": (K, O)}                          y = x @ w
  compressed   {"values": (K*n/4, O),                 y = x @ dec(values, meta)
                "meta_packed": (K*n/16, O) uint8}
  gather       {"values": (K*n/4, O),                 y = gather(x, idx) @ values
                "gather_idx": (K*n/4,) int32}

The gather layout is lane-aligned N:M: every output channel shares one
in-block index per compressed row, so the activation's kept columns are
gathered once and the product contracts over K*n/4 (n/4 of the dense
FLOPs).  All route through the dispatch engine (``kernels.dispatch``): a
CUDA kernel where the plan allows, the torch reference formulation
otherwise.  Any layout may be quantized (``convert_layout(...,
quantize="int8")``, see ``core.quantize``): its value leaf holds the
narrow dtype and a ``"scale"`` leaf rides beside it.  The masked (SR-STE)
and rowwise layouts wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from . import nm

__all__ = [
    "SparsityConfig",
    "init_linear",
    "apply_linear",
    "apply_gate_up",
    "convert_layout",
    "map_linear_leaves",
    "is_linear_leaf",
    "gather_hint",
    "COLUMN_PARALLEL",
    "ROW_PARALLEL",
]

COLUMN_PARALLEL = {"wq", "wk", "wv", "w_in", "w_gate", "wz", "wx", "wdt"}
ROW_PARALLEL = {"wo", "w_out"}


def gather_hint(names: Sequence[str]) -> Optional[str]:
    """Use-site parallelism hint ("col" | "row" | None) for a param path:
    the dispatch report's and ``launch.shardings``' view of the hint each
    model call site passes ``apply_linear``.  MoE expert stacks have none."""
    names = tuple(names)
    if "experts" in names:
        return None
    for nm_ in reversed(names):
        if nm_ in COLUMN_PARALLEL:
            return "col"
        if nm_ in ROW_PARALLEL:
            return "row"
    return None


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Sparsity spec for one (family of) projection(s)."""

    n: int = 4
    m: int = 4
    mode: str = "dense"          # dense | masked | compressed | gather | rowwise

    @property
    def is_sparse(self) -> bool:
        return self.mode != "dense" and self.n < self.m


def _compressed(w: torch.Tensor, cfg: SparsityConfig) -> Dict[str, torch.Tensor]:
    """(..., K, O) -> values (..., K*n/m, O) and meta_packed (..., K*n/(4m),
    O).  A stack of matrices converts as one (E*K, O) matrix: its M-blocks
    and its packed meta rows never straddle two matrices, so each slice is
    the conversion of its own matrix."""
    lead, (k, o) = w.shape[:-2], w.shape[-2:]
    pruned, _ = nm.prune_nm(w.reshape(-1, o), cfg.n, cfg.m)
    c = nm.compress_nm(pruned, cfg.n, cfg.m)
    return {"values": c.values.reshape(lead + (k * cfg.n // cfg.m, o)),
            "meta_packed": nm.pack_meta(c.meta).reshape(lead + (-1, o))}


def _gathered(w: torch.Tensor, cfg: SparsityConfig) -> Dict[str, torch.Tensor]:
    """Lane-aligned conversion of one (K, O) matrix: each M-block keeps the
    n in-block rows with the largest |w| summed over all O channels (sums
    in ``w``'s dtype; stable sort, so equal blocks keep the lower rows),
    kept set ascending, as the JAX package's ``convert_layout``."""
    k, o = w.shape
    blocks = w.abs().reshape(k // cfg.m, cfg.m, o).sum(dim=-1)          # (K/m, m)
    order = torch.argsort(-blocks, dim=1, stable=True)[:, :cfg.n]
    idx = torch.sort(order, dim=1).values.reshape(-1).to(torch.int32)   # (K_c,)
    blk = torch.arange(idx.shape[0], device=w.device) // cfg.n * cfg.m
    return {"values": w[blk + idx.long()], "gather_idx": idx}


def init_linear(gen: torch.Generator, k: int, o: int, cfg: SparsityConfig,
                dtype=torch.bfloat16, scale: Optional[float] = None,
                device=None) -> Dict[str, Any]:
    """Random parameters for one linear, in the layout ``cfg.mode`` asks
    for.  ``gen`` must live on ``device`` (a CUDA generator for CUDA).  The
    gather layout draws its (K_c, O) values directly, beside the JAX
    package's deterministic spread of kept indices."""
    if scale is None:
        scale = k ** -0.5
    if cfg.mode == "gather" and cfg.is_sparse:
        kc = k * cfg.n // cfg.m
        base = torch.arange(kc, dtype=torch.int32, device=device) % cfg.m
        idx = torch.sort(base.reshape(-1, cfg.n), dim=1).values.reshape(kc)
        vals = torch.randn((kc, o), generator=gen, dtype=torch.float32, device=device) * scale
        return {"values": vals.to(dtype), "gather_idx": idx}
    w = (torch.randn((k, o), generator=gen, dtype=torch.float32, device=device)
         * scale).to(dtype)
    if cfg.mode == "dense" or not cfg.is_sparse:
        return {"w": w}
    if cfg.mode == "compressed":
        return _compressed(w, cfg)
    raise NotImplementedError(f"{cfg.mode!r} layouts are not ported yet")


def apply_linear(params: Dict[str, Any], x: torch.Tensor, cfg: SparsityConfig,
                 gather: Optional[str] = None, epilogue=None, activation=None,
                 local: bool = False) -> torch.Tensor:
    """``y = epilogue(x @ W)`` with the layout's lowering.
    x: (..., K) -> (..., O).  ``activation`` (a
    ``kernels.actsparse.ActivationSpec``) opts into the activation-sparsity
    class: ``x`` is masked on every route and a kernel skips its dead
    tiles; ``local`` marks a call inside a sharded body.  ``gather`` is the
    use site's parallelism hint ("col" | "row" | None): under an installed
    axis env it becomes the site's ``ShardSpec`` and the engine runs the
    sharded class (``params`` and ``x`` are then this rank's shard; a
    "row" site all-reduces its partials, a "col" site's output stays
    local)."""
    from ..kernels.dispatch import shard_spec_from_env, sparse_matmul   # local: avoid cycle
    shard = shard_spec_from_env(gather) if gather is not None and not local else None
    return sparse_matmul(x, params, cfg, shard=shard, epilogue=epilogue,
                         activation=activation, local=local)


def apply_gate_up(params_g: Dict[str, Any], params_u: Dict[str, Any],
                  x: torch.Tensor, cfg: SparsityConfig, gather: Optional[str] = None,
                  epilogue=None, activation=None, local: bool = False) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu)`` as one engine dispatch (``gather``,
    ``activation`` and ``local`` as for :func:`apply_linear`)."""
    from ..kernels.dispatch import gate_up_matmul, shard_spec_from_env   # local: avoid cycle
    if epilogue is not None and (epilogue.spec.act != "silu_mul"
                                 or epilogue.spec.bias):
        raise ValueError(f"apply_gate_up epilogue must sit on the silu_mul "
                         f"lattice point, got {epilogue.spec.point!r}")
    shard = shard_spec_from_env(gather) if gather is not None and not local else None
    return gate_up_matmul(x, params_g, params_u, cfg, shard=shard, epilogue=epilogue,
                          activation=activation, local=local)


def convert_layout(params: Dict[str, Any], cfg: SparsityConfig,
                   target_mode: str = "compressed",
                   quantize: Optional[str] = None) -> Dict[str, Any]:
    """Offline conversion: dense weights -> serving layout (``compressed``
    or ``gather``).  Leaves already in a serving layout pass through;
    stacked ``(..., K, O)`` dense leaves convert per trailing matrix.

    ``quantize="int8"`` (or ``"fp8"``) then quantizes the layout's float
    operand per output channel (``core.quantize.quantize_linear``), after
    pruning and compression, so the scales are those of the kept values."""
    qdtype = None
    if quantize is not None:
        from .quantize import canonical_qdtype
        qdtype = canonical_qdtype(quantize)   # raises on unknown targets

    def _q(layout: Dict[str, Any]) -> Dict[str, Any]:
        if qdtype is None:
            return layout
        from .quantize import quantize_linear
        return quantize_linear(layout, qdtype)

    if "w" not in params or "scale" in params:
        return _q(params)
    w = params["w"]
    if not cfg.is_sparse or target_mode == "dense":
        return _q({"w": w})
    convert = {"compressed": _compressed, "gather": _gathered}.get(target_mode)
    if convert is None:
        raise NotImplementedError(f"{target_mode!r} layouts are not ported yet")
    if w.ndim > 2 and target_mode == "gather":   # the vote sums per matrix
        lead = w.shape[:-2]
        mats = [convert(m_, cfg) for m_ in w.reshape((-1,) + w.shape[-2:])]
        return _q({k: torch.stack([m_[k] for m_ in mats]).reshape(lead + mats[0][k].shape)
                   for k in mats[0]})
    return _q(convert(w, cfg))


# keys a linear layout may carry beside its structural ones (``calib_id``
# only while a calibration forward runs)
_AUX_KEYS = {"scale", "act_scale", "calib_id"}


def is_linear_leaf(tree: Any) -> bool:
    """One flat SparseLinear layout dict (dense ``{"w"}``, compressed or
    gather, each possibly with its quantization scales): the structural
    test every tree walk shares."""
    return isinstance(tree, dict) and (
        "meta_packed" in tree or "gather_idx" in tree or set(tree) - _AUX_KEYS == {"w"})


def map_linear_leaves(tree, fn: Callable[[Dict[str, Any]], Dict[str, Any]]):
    """Rebuild a params tree with ``fn`` applied to every SparseLinear
    leaf dict (port of ``repro.core.quantize.map_linear_leaves``)."""
    if isinstance(tree, dict):
        if is_linear_leaf(tree):
            return fn(tree)
        return {k: map_linear_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_linear_leaves(v, fn) for v in tree]
    if isinstance(tree, tuple):
        return tuple(map_linear_leaves(v, fn) for v in tree)
    return tree
