"""``ServingSpec`` + ``prepare``: the one offline-prep entry point (port of
``repro.serving.spec`` for the float dense and compressed layouts).

```python
prepared = repro_torch.serving.prepare(params, ServingSpec(layout="compressed",
                                                           sparsity=(2, 4)))
```

moves the params to the device and converts every linear leaf to the
spec's layout.  Serving runs on the card: ``device=None`` means
``"cuda"``, and without a CUDA device ``prepare`` raises rather than
drop to the CPU; tests pass ``device="cpu"``.  Quantization, static
scales and mesh placement are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

_LAYOUTS = ("dense", "compressed")
_ADMISSION = ("reserve", "optimistic")
_BACKENDS = ("auto", "cuda", "torch")

__all__ = ["ServingSpec", "Prepared", "prepare", "resolve_device"]


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

    Offline-prep axes: ``layout`` (``dense | compressed``), ``sparsity``
    (``(n, m)`` or None for dense 4:4), ``backend`` (dispatch engine:
    ``auto | cuda | torch``).  Engine axes: ``slots``, ``max_len``,
    ``block_len``, ``kv_blocks``, ``admission``, ``prefill_chunk``, as in
    the JAX package.
    """

    layout: str = "dense"
    sparsity: Optional[Tuple[int, int]] = None
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

    @contextlib.contextmanager
    def activate(self):
        """Install the spec's dispatch backend for a serving loop."""
        from ..kernels import dispatch as kdispatch
        with kdispatch.use_dispatch(backend=self.spec.backend):
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


def prepare(params, spec: ServingSpec, *, cfg=None, device=None) -> Prepared:
    """Prepare a params tree for serving under ``spec``: move it to the
    device (CUDA unless ``device`` says otherwise), then convert every
    dense linear leaf to ``spec.layout``
    (:func:`repro_torch.core.sparse_linear.convert_layout`); leaves
    already in a serving layout pass through.

    ``params`` may be a full model tree (pass ``cfg``) or a bare layout
    leaf / small tree with ``cfg=None``."""
    from ..core.sparse_linear import convert_layout, map_linear_leaves
    from ..kernels import dispatch as kdispatch

    dev = resolve_device(device)
    sp_cfg = cfg.sparsity if cfg is not None else spec.sparsity_config
    params = map_linear_leaves(_to_device(params, dev),
                               lambda leaf: convert_layout(leaf, sp_cfg, spec.layout))
    return Prepared(params=params, spec=spec, device=dev, cfg=cfg, sp_cfg=sp_cfg,
                    dispatch=kdispatch.DispatchConfig(backend=spec.backend))
