"""``ServingSpec`` + ``prepare``: the one offline-prep entry point (port of
``repro.serving.spec`` for the dense and MoE families, and the audio and
vlm families' prefill, in the dense, compressed and gather layouts,
float, int8 or fp8).

```python
prepared = repro_torch.serving.prepare(params, ServingSpec(layout="gather",
                                                           sparsity=(2, 4),
                                                           qdtype="int8"))
```

moves the params to the device, converts every linear leaf to the spec's
layout, quantizes it (``qdtype``), and with ``static_scales`` calibrates
one activation scale per linear site on a representative batch
(``calib_tokens``), and with ``mesh=(1, M)`` cuts the tree to this
rank's tensor-parallel shard (``launch.shardings``; every rank of an
initialised ``torch.distributed`` group of M calls ``prepare``).
:func:`prepare_from_artifact` stands a model up from a conversion artifact
instead.  Serving runs on the card: ``device=None`` means ``"cuda"``, and
without a CUDA device ``prepare`` raises rather than drop to the CPU;
tests pass ``device="cpu"``.  KV-cache quantization, a data axis and
autotuning are not ported yet: a spec or a manifest asking for one raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

_LAYOUTS = ("dense", "compressed", "gather")
_ADMISSION = ("reserve", "optimistic")
_BACKENDS = ("auto", "cuda", "torch")

__all__ = ["ServingSpec", "Prepared", "prepare", "prepare_from_artifact",
           "resolve_device", "config_from_manifest", "spec_from_manifest"]


def resolve_device(device=None) -> torch.device:
    """The serving device: CUDA unless the caller names another.  Raises
    when CUDA is asked for (explicitly or by default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch serves on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """Frozen description of how a model serves.

    Offline-prep axes: ``layout`` (``dense | compressed | gather``), ``sparsity``
    (``(n, m)`` or None for dense 4:4), ``qdtype`` (weight quantization:
    ``"int8"``, ``"fp8"`` (float8_e4m3fn) or None; the cuda tier runs the
    class's kernels, int8 or e4m3 activations quantized per row or against
    static scales), ``static_scales`` (calibrate static activation scales
    at prepare time; needs ``qdtype``), ``backend`` (dispatch engine:
    ``auto | cuda | torch``), ``mesh`` (``(data, model)``: tensor
    parallelism over M ranks; ``data`` must be 1).
    Engine axes: ``slots``, ``max_len``, ``block_len``, ``kv_blocks``,
    ``admission``, ``prefill_chunk``, as in the JAX package.
    """

    layout: str = "dense"
    sparsity: Optional[Tuple[int, int]] = None
    qdtype: Optional[str] = None
    static_scales: bool = False
    mesh: Optional[Tuple[int, int]] = None
    backend: str = "auto"
    slots: int = 4
    max_len: int = 64
    block_len: int = 8
    kv_blocks: Optional[int] = None
    admission: str = "reserve"
    prefill_chunk: int = 8

    def __post_init__(self):
        if self.layout not in _LAYOUTS:
            raise ValueError(f"layout {self.layout!r} not in {_LAYOUTS}")
        if self.admission not in _ADMISSION:
            raise ValueError(f"admission {self.admission!r} not in {_ADMISSION}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {_BACKENDS}")
        if self.qdtype is not None:
            from ..core.quantize import canonical_qdtype
            canonical_qdtype(self.qdtype)      # raises on unknown targets
        if self.static_scales and self.qdtype is None:
            raise ValueError("static_scales requires qdtype ('int8' | 'fp8')")
        if self.mesh is not None:
            from ..launch.mesh import check_mesh
            object.__setattr__(self, "mesh", check_mesh(self.mesh))   # refuses data > 1
        if self.sparsity is not None:
            n, m = self.sparsity
            if not (0 < n <= m):
                raise ValueError(f"sparsity {self.sparsity} needs 0 < n <= m")
        if self.block_len <= 0 or self.prefill_chunk <= 0 or self.slots <= 0:
            raise ValueError("block_len, prefill_chunk, slots must be positive")
        if self.max_len < self.block_len:
            raise ValueError("max_len must cover at least one block")

    @property
    def sparsity_config(self):
        from ..core.sparse_linear import SparsityConfig
        if self.sparsity is None:
            return SparsityConfig(mode=self.layout)
        n, m = self.sparsity
        return SparsityConfig(n=n, m=m, mode=self.layout)

    @property
    def table_width(self) -> int:
        return math.ceil(self.max_len / self.block_len)

    def default_kv_blocks(self) -> int:
        """Budget that can hold every slot at max_len (never evicts)."""
        return self.slots * self.table_width

    def apply_to(self, cfg):
        """Model config with this spec's sparsity/layout installed."""
        return cfg.with_sparsity(self.sparsity_config)


@dataclasses.dataclass
class Prepared:
    """Output of :func:`prepare`: serving-ready params + runtime context."""

    params: Any
    spec: ServingSpec
    device: torch.device
    cfg: Any = None               # ModelConfig, when preparing a full model
    sp_cfg: Any = None            # SparsityConfig actually in effect
    dispatch: Any = None          # kernels.dispatch.DispatchConfig
    calibrated_sites: int = 0     # static act scales: sites calibrated
    axis_env: Any = None          # models.pjit_utils.AxisEnv (None off-mesh)

    @contextlib.contextmanager
    def activate(self):
        """Install the mesh's axis env (if any) and the spec's dispatch
        backend for a serving loop, whose plans are memoized
        (``dispatch.plan_cache``)."""
        from ..kernels import dispatch as kdispatch
        from ..models.pjit_utils import use_axis_env
        with use_axis_env(self.axis_env), kdispatch.use_dispatch(backend=self.spec.backend), \
                kdispatch.plan_cache():
            yield self

    def dispatch_report(self, batches: Optional[Tuple[int, ...]] = None):
        """Engine-decision lines for this tree (see
        :func:`repro_torch.kernels.dispatch.dispatch_report`)."""
        from ..kernels import dispatch as kdispatch
        if batches is None:
            batches = (self.spec.slots, self.spec.prefill_chunk)
        with self.activate():
            return kdispatch.dispatch_report(self.params, batches, self.sp_cfg,
                                             dispatch=self.dispatch)


def _to_device(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def prepare(params, spec: ServingSpec, *, cfg=None, calib_tokens=None,
            device=None) -> Prepared:
    """Prepare a params tree for serving under ``spec``: move it to the
    device (CUDA unless ``device`` says otherwise), then

    1. **layout conversion**: a dense ``{"w"}`` leaf becomes
       ``spec.layout`` (:func:`repro_torch.core.sparse_linear.convert_layout`);
       leaves already in a serving layout pass through;
    2. **weight quantization**: ``spec.qdtype`` quantizes the layout's
       float operand with per-channel scales (idempotent, so an
       artifact's int8 leaves pass through);
    3. **activation-scale calibration**: ``spec.static_scales`` runs one
       :func:`repro_torch.models.forward` over ``calib_tokens`` (needs
       ``cfg``) under the spec's backend and attaches a static
       ``act_scale`` to every quantized leaf, so decode skips the per-row
       absmax pass.  A tree whose quantized leaves all carry one already
       (a calibrated artifact) is counted, not calibrated again.  Under a
       mesh it runs unsharded, as in the JAX package, once on rank 0, and
       rank 0's scales are broadcast to the other ranks;
    4. **mesh placement**: ``spec.mesh = (1, M)`` (needs ``cfg``) cuts
       every hinted linear to this rank's shard
       (:func:`repro_torch.launch.shardings.shard_params`) and records the
       axis env that :meth:`Prepared.activate` installs.  ``(1, 1)`` is
       the single placement: no env, served as ``mesh=None``.

    ``params`` may be a full model tree (pass ``cfg``) or a bare layout
    leaf / small tree with ``cfg=None``."""
    from ..core.quantize import has_static_scales, is_quantized
    from ..core.sparse_linear import convert_layout, map_linear_leaves
    from ..kernels import dispatch as kdispatch

    dev = resolve_device(device)
    sp_cfg = cfg.sparsity if cfg is not None else spec.sparsity_config
    env = None
    if spec.mesh is not None and spec.mesh[1] > 1:   # (1, 1) is the single placement
        if cfg is None:
            raise ValueError("mesh placement needs cfg= (the shard rules follow the config)")
        from ..launch.mesh import make_axis_env
        from ..launch.shardings import check_config
        env = make_axis_env(spec.mesh)
        check_config(cfg, env.model_size)     # refuse before any work
    params = map_linear_leaves(
        _to_device(params, dev),
        lambda leaf: convert_layout(leaf, sp_cfg, spec.layout, quantize=spec.qdtype))
    dcfg = kdispatch.DispatchConfig(backend=spec.backend)

    calibrated = 0
    if spec.static_scales:
        leaves = []
        map_linear_leaves(params, lambda leaf: leaves.append(leaf) or leaf)
        quantized = [leaf for leaf in leaves if is_quantized(leaf)]
        if quantized and all(has_static_scales(leaf) for leaf in quantized):
            calibrated = _count_sites(params, cfg)
        else:
            if cfg is None or calib_tokens is None:
                raise ValueError("static_scales needs cfg= and calib_tokens= at prepare() "
                                 "time (one representative prefill batch)")
            if cfg.frontend != "none":
                # the JAX package's prepare calibrates over calib_tokens alone
                raise ValueError(f"static_scales calibrates over calib_tokens; a "
                                 f"frontend={cfg.frontend!r} model takes embeddings, "
                                 f"which prepare() has no calibration batch for")
            from ..core.quantize import _calibrate_activation_scales
            from ..models import forward, layer_site_keys
            tokens = calib_tokens.to(dev)

            def batch_fn(p):
                with kdispatch.use_dispatch(backend=spec.backend):
                    return forward(p, cfg, tokens)

            if env is None or env.model_rank == 0:
                params, calibrated = _calibrate_activation_scales(
                    params, batch_fn, layer_keys=layer_site_keys(cfg))
            if env is not None and env.model_size > 1:
                params, calibrated = _broadcast_scales(params, calibrated, env, dev)
    if env is not None:
        from ..launch.shardings import shard_params
        params = shard_params(params, cfg, env)
    return Prepared(params=params, spec=spec, device=dev, cfg=cfg, sp_cfg=sp_cfg,
                    dispatch=dcfg, calibrated_sites=calibrated, axis_env=env)


def _broadcast_scales(params, calibrated: int, env, dev):
    """Rank 0's static ``act_scale`` leaves (and its site count) onto every
    rank: one broadcast of a vector with one entry per quantized leaf, in
    the tree's order (NaN: no scale)."""
    import torch.distributed as dist
    from ..core.quantize import ACT_SCALE_KEY, is_quantized
    from ..core.sparse_linear import map_linear_leaves

    leaves = []
    map_linear_leaves(params, lambda leaf: leaves.append(leaf) or leaf)
    quantized = [leaf for leaf in leaves if is_quantized(leaf)]
    vec = torch.tensor([float(calibrated)] + [
        leaf[ACT_SCALE_KEY].item() if ACT_SCALE_KEY in leaf else math.nan
        for leaf in quantized], dtype=torch.float32, device=dev)
    dist.broadcast(vec, src=0, group=env.group)
    values = iter(vec[1:].tolist())

    def _attach(leaf):
        if not is_quantized(leaf):
            return leaf
        v = next(values)
        if math.isnan(v):
            return leaf
        return {**leaf, ACT_SCALE_KEY: torch.tensor(v, dtype=torch.float32, device=dev)}
    return map_linear_leaves(params, _attach), int(vec[0].item())


def _count_sites(params, cfg) -> int:
    """Calibrated sites of a tree that carries its ``act_scale`` leaves (an
    artifact's): the JAX package's unit, one per (slot, leaf path)."""
    from ..core.quantize import _map_with_path, _site_key, has_static_scales

    keys = set()
    layer_keys = None
    if cfg is not None:
        from ..models import layer_site_keys
        layer_keys = layer_site_keys(cfg)

    def _seen(path, leaf):
        if has_static_scales(leaf):
            keys.add(_site_key(path, layer_keys))
        return leaf

    _map_with_path(params, _seen)
    return len(keys)


# manifest spec keys of the JAX package that the port does not have yet,
# with the only value it accepts for each (the JAX default)
_UNPORTED_SPEC_KEYS = {"kv_qdtype": None, "autotune": False}


def config_from_manifest(manifest: Dict[str, Any]):
    """The model config an artifact (or audit) manifest names: its
    ``config`` block's arch, smoke flag and field overrides (the JAX
    package's ``analysis.budget.config_from_manifest``)."""
    from ..configs import get_config, get_smoke_config

    mc = manifest["config"]
    cfg = get_smoke_config(mc["arch"]) if mc.get("smoke", True) else get_config(mc["arch"])
    if mc.get("overrides"):
        cfg = dataclasses.replace(cfg, **mc["overrides"])
    return cfg


def spec_from_manifest(manifest: Dict[str, Any]) -> ServingSpec:
    """The :class:`ServingSpec` of a manifest's ``spec`` block.  Keys the
    port has no axis for yet are accepted at their defaults and refused
    otherwise."""
    d = dict(manifest["spec"])
    for key, default in _UNPORTED_SPEC_KEYS.items():
        value = d.pop(key, default)
        if value != default:
            raise NotImplementedError(
                f"manifest spec {key}={value!r} is not ported yet "
                f"(repro_torch serves only {key}={default!r})")
    for key in ("sparsity", "mesh"):
        if d.get(key) is not None:
            d[key] = tuple(d[key])
    return ServingSpec(**d)


def prepare_from_artifact(path, *, backend: Optional[str] = None,
                          device=None) -> Prepared:
    """Load a conversion artifact (``python -m repro.launch.convert``)
    and stand it up for serving.

    The manifest is the recipe: the model config rebuilds from its
    ``config`` block, the :class:`ServingSpec` from its ``spec`` block,
    and the params come back already pruned, compressed and quantized,
    so :func:`prepare` runs as an idempotent pass (artifact-borne
    ``act_scale`` leaves satisfy ``static_scales`` without calibration
    data).  The artifact's
    stacked ``stages`` tree is unstacked into the port's per-layer list
    (:func:`repro_torch.interop.params_from_numpy`).  ``backend``
    overrides the spec's dispatch backend; ``device`` is as for
    :func:`prepare`."""
    from ..checkpoint import load_artifact
    from ..interop import params_from_numpy

    params, manifest = load_artifact(path)
    cfg = config_from_manifest(manifest)
    spec = spec_from_manifest(manifest)
    if backend is not None:
        spec = dataclasses.replace(spec, backend=backend)
    cfg = spec.apply_to(cfg)
    return prepare(params_from_numpy(params), spec, cfg=cfg, device=device)
