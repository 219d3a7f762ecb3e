"""Mesh-context plumbing so model code is mesh-agnostic (port of
``repro.models.pjit_utils``).

The launcher (or ``Prepared.activate``) installs an :class:`AxisEnv`:
the axis sizes of the ``(data, model)`` mesh, this process's index on the
model axis and the model axis's ``torch.distributed`` process group.
Model code and the dispatch engine read it through :func:`axis_env`; with
none installed (one device, the CPU tests) everything takes the
single-device path.

There is no GSPMD in torch: every rank holds its own shard of the weights
(``launch.shardings``) and the dispatch engine runs the collectives
itself, so :func:`constrain` is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["AxisEnv", "axis_env", "use_axis_env", "constrain", "COLLECTIVES",
           "reset_collectives", "BATCH_AXIS", "MODEL_AXIS"]

_state = threading.local()

#: the mesh's axis names (the JAX package's ``batch_axes`` / ``model_axis``)
BATCH_AXIS = "data"
MODEL_AXIS = "model"

#: what the model axis's collectives cost this process: calls, bytes
#: reduced, and the host's wall seconds inside them (gloo returns when the
#: reduction is done; NCCL when it is enqueued)
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_collectives() -> None:
    COLLECTIVES.update(calls=0, bytes=0, seconds=0.0)


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """One rank's view of the mesh.  ``shape`` maps axis names to sizes
    (``{"data": 1, "model": M}``; it plays the JAX mesh's ``.shape``, the
    only part of a mesh the dispatch engine's plans read), ``model_rank``
    is this rank's index on the model axis and ``group`` the model axis's
    process group (``None``: the default group)."""

    shape: Dict[str, int]
    model_rank: int = 0
    group: Any = None

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    def physical(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "batch":
            return BATCH_AXIS
        if logical == "model":
            return MODEL_AXIS
        raise ValueError(f"unknown logical axis {logical!r}")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of ``t`` over the model axis (``sum`` or
        ``max``); returns ``t``.  Only ``all_reduce`` and ``broadcast``
        run on the serving path: gloo takes both on CUDA tensors, so ranks
        that share one card can use it."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.group)
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += t.numel() * t.element_size()
        return t


def axis_env() -> Optional[AxisEnv]:
    return getattr(_state, "env", None)


@contextlib.contextmanager
def use_axis_env(env: Optional[AxisEnv]):
    prev = getattr(_state, "env", None)
    _state.env = env
    try:
        yield
    finally:
        _state.env = prev


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """The JAX package's sharding constraint: the identity here (each rank
    already holds exactly its shard)."""
    return x
