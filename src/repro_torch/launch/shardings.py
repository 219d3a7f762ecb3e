"""Tensor-parallel parameter slicing over the model axis (port of the
serving part of ``repro.launch.shardings``).

Each rank holds exactly what the JAX package's ``shard_map`` body reads
(``repro.kernels.dispatch._shard_param_specs``), so the dispatch engine's
kernels run on the rank's own shard:

- column-parallel linears (``COLUMN_PARALLEL``: wq, wk, wv, w_in, w_gate)
  keep the rows and take their slice of the out features: ``w`` /
  ``values`` / ``meta_packed`` and the per-channel ``scale`` on O, the
  ``gather_idx`` whole;
- row-parallel linears (``ROW_PARALLEL``: wo, w_out) take their slice of
  the contraction: ``w`` / ``values`` / ``meta_packed`` and ``gather_idx``
  on K, the ``scale`` whole;
- the static ``act_scale``, the embedding, the unembedding and the norms
  stay replicated.

Rank r's slice of an axis is its r-th contiguous part, so the heads of
wq / wk / wv and the rows of wo line up: rank r serves query heads
``[r H/M, (r+1) H/M)`` and KV heads ``[r KV/M, (r+1) KV/M)``.  What this
slice leaves to later work refuses here: the SSM and hybrid families
(their Mamba heads over the model axis), the MoE family (``_moe_shardmap``),
KV heads that do not divide the model axis (the JAX package replicates
wk / wv then), and any slicing that would split an N:M metadata byte or
a gather block.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..core.sparse_linear import COLUMN_PARALLEL, ROW_PARALLEL, gather_hint, is_linear_leaf
from ..models.pjit_utils import MODEL_AXIS, AxisEnv

__all__ = ["shard_param_specs", "shard_leaf", "shard_params", "check_config",
           "COLUMN_PARALLEL", "ROW_PARALLEL"]

Spec = Tuple[Optional[str], ...]


def shard_param_specs(mode: str, ke_axis: Optional[str], o_axis: Optional[str],
                      params: Dict[str, Any]) -> Dict[str, Spec]:
    """Per-leaf specs, as tuples of axis names (or None) over the leaf's
    dims, for one linear layout whose contraction is sliced on
    ``ke_axis`` and out features on ``o_axis``: the JAX package's
    ``_shard_param_specs`` (``PartitionSpec`` entries)."""
    if mode not in ("dense", "masked", "compressed", "gather"):
        raise ValueError(f"no shard specs for mode {mode!r}")

    def spec_for(key: str) -> Spec:
        if key in ("w", "values", "meta_packed"):
            return (ke_axis, o_axis)
        if key == "gather_idx":
            return (ke_axis,)
        if key == "scale":
            return (o_axis,)
        return ()   # act_scale and any other scalar-ish leaf
    return {k: spec_for(k) for k in params}


def _mode(leaf: Dict[str, Any]) -> str:
    if "w" in leaf:
        return "dense"
    return "compressed" if "meta_packed" in leaf else "gather"


def shard_leaf(leaf: Dict[str, Any], hint: str, env: AxisEnv, n: int = 4
               ) -> Dict[str, Any]:
    """This rank's part of one linear leaf at a ``"col"`` or ``"row"`` site
    (``n``: the layout's N of N:4, for the gather block check)."""
    m, r = env.model_size, env.model_rank
    axes = {"col": (None, MODEL_AXIS), "row": (MODEL_AXIS, None)}[hint]
    mode = _mode(leaf)
    specs = shard_param_specs(mode, *axes, leaf)
    if hint == "row" and mode == "gather":
        kc = leaf["values"].shape[-2]
        if kc % m or (kc // m) % n:
            raise ValueError(f"gather row slice: K_c={kc} over {m} ranks splits an N:4 "
                             f"block (n={n})")
    out = {}
    for key, value in leaf.items():
        spec = specs[key]
        if not isinstance(value, torch.Tensor) or MODEL_AXIS not in spec:
            out[key] = value
            continue
        dim = value.ndim - len(spec) + spec.index(MODEL_AXIS)
        size = value.shape[dim]
        if size % m:
            raise ValueError(f"{key} {tuple(value.shape)}: dim {dim} ({size}) does not "
                             f"divide over {m} ranks")
        out[key] = value.narrow(dim, r * (size // m), size // m).contiguous()
    return out


def check_config(cfg, model_size: int) -> None:
    """The configurations this slice shards: dense token models whose query
    and KV heads divide the model axis."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: the sharded SSM (Mamba heads over the model axis) "
                         f"is not ported; see ROADMAP.md Queue 1 item 12")
    if cfg.family == "moe" or cfg.num_experts > 0:
        raise ValueError(f"{cfg.name}: the sharded MoE (experts over the model axis) is "
                         f"not ported; see ROADMAP.md Queue 1 item 12")
    if cfg.num_heads % model_size or cfg.num_kv_heads % model_size:
        raise ValueError(f"{cfg.name}: {cfg.num_heads} query / {cfg.num_kv_heads} KV heads "
                         f"do not divide over a model axis of {model_size} (the JAX "
                         f"package replicates wk / wv then; not ported, see ROADMAP.md "
                         f"Queue 1 item 12)")


def shard_params(params: Any, cfg, env: AxisEnv) -> Any:
    """The params tree with every hinted linear leaf cut to this rank's
    shard; everything else (embed, unembed, norms) as it is."""
    check_config(cfg, env.model_size)
    n = cfg.sparsity.n if cfg.sparsity.is_sparse else 4

    def walk(tree, names: Sequence[str]):
        if is_linear_leaf(tree):
            hint = gather_hint(names)
            return tree if hint is None else shard_leaf(tree, hint, env, n)
        if isinstance(tree, dict):
            return {k: walk(v, tuple(names) + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, tuple(names) + (f"[{i}]",)) for i, v in enumerate(tree))
        return tree
    return walk(params, ())
