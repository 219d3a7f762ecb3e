"""Kernel registry: the dispatch table behind the unified sparse-GEMM engine.

The port's copy of ``repro.kernels.registry``.  Every kernel registers a
:class:`KernelEntry` saying which execution mode it implements, which
backends run it, and, through ``fit_blocks``, which (shape, N:M, dtype)
problems it can tile.  ``select`` returns the first fitting entry, or
``None``: use the torch reference formulation.

Backends
--------
``cuda``   the hand-written Hopper kernels.  Handed CPU tensors, their
           wrappers run the kernels' plain versions, the counterpart of
           the JAX package's ``interpret`` backend.
``torch``  no kernel at all: the plain torch reference tier (the JAX
           package's ``jnp``).

An entry may carry a ``supported(backend, device)`` predicate for what
its (shape, dtype) fit cannot see: the fp8 entries run on a CUDA device
only where its tensor cores contract e4m3 (:func:`supports_fp8`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .reasons import dtype_name

__all__ = [
    "KernelEntry",
    "register",
    "entries",
    "select",
    "local_dims",
    "detect_backend",
    "resolve_backend",
    "largest_fitting_block",
    "fp8_native_dot",
    "supports_fp8",
    "dtype_name",
    "KERNEL_BACKENDS",
    "REFERENCE_BACKEND",
]

Blocks = Tuple[int, int, int]  # (block_b, block_ke, block_o)

KERNEL_BACKENDS = ("cuda",)
REFERENCE_BACKEND = "torch"
_ENV_BACKEND = "REPRO_KERNEL_BACKEND"


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One kernel the engine can dispatch to.

    ``fit_blocks(b, ke, o, n, m, dtype) -> Blocks | None``;
    ``run(x2d, params, cfg, blocks, epilogue=None)`` executes it;
    ``run_dual(x2d, params_g, params_u, cfg, blocks)`` is the fused
    gate-up variant (entries without one decline dual plans).
    ``quantized`` entries take quantized leaves (their ``fit_blocks``
    accepts only their storage dtype) and quantize the activations
    themselves.  ``supported(backend, device) -> bool``, when set, vetoes
    the entry on hardware that cannot run it.  ``activation_skip`` marks
    entries whose run adapter carries a masked (block-skip) kernel for the
    activation-sparsity class: on a single-GEMM kernel decision with an
    ``activation`` axis the engine passes the adapter the activation spec
    and it runs the masked kernel on ``actsparse.block_maps``.
    """

    name: str
    mode: str                      # dense | compressed | gather | attention
    fit_blocks: Callable[..., Optional[Blocks]]
    run: Callable[..., torch.Tensor]
    backends: Tuple[str, ...] = KERNEL_BACKENDS
    run_dual: Optional[Callable[..., torch.Tensor]] = None
    quantized: bool = False
    supported: Optional[Callable[[str, Optional[torch.device]], bool]] = None
    activation_skip: bool = False
    run_quantized: Optional[Callable[..., torch.Tensor]] = None


_REGISTRY: Dict[str, List[KernelEntry]] = {}


def register(entry: KernelEntry) -> KernelEntry:
    """Add a kernel to the dispatch table (idempotent per name)."""
    lst = _REGISTRY.setdefault(entry.mode, [])
    lst[:] = [e for e in lst if e.name != entry.name]
    lst.append(entry)
    return entry


def entries(mode: Optional[str] = None) -> List[KernelEntry]:
    if mode is None:
        return [e for lst in _REGISTRY.values() for e in lst]
    return list(_REGISTRY.get(mode, []))


def local_dims(dims: Sequence[int], shards: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """Per-shard problem dims, or ``None`` when a shard count does not
    evenly divide its dim."""
    out = []
    for d, s in zip(dims, shards):
        if s <= 0 or d % s != 0:
            return None
        out.append(d // s)
    return tuple(out)


def select(mode: str, *, b: int, ke: int, o: int, n: int, m: int, dtype,
           backend: str, device=None, shards: Tuple[int, int, int] = (1, 1, 1)
           ) -> Optional[Tuple[KernelEntry, Blocks]]:
    """The first registered kernel whose constraints fit, with its
    blocks, or ``None`` (the caller falls back to the torch reference).
    ``device`` is where the operands live (for ``supported``).  ``shards``
    is the mesh's slicing of (b, ke, o): blocks are fitted against the
    per-shard local problem, the one each rank's kernel runs."""
    if backend not in KERNEL_BACKENDS:
        return None
    loc = local_dims((b, ke, o), shards)
    if loc is None:
        return None
    b, ke, o = loc
    for entry in _REGISTRY.get(mode, []):
        if backend not in entry.backends:
            continue
        if entry.supported is not None and not entry.supported(backend, device):
            continue
        blocks = entry.fit_blocks(b, ke, o, n, m, dtype)
        if blocks is not None:
            return entry, blocks
    return None


def detect_backend(device=None) -> str:
    """``cuda`` when the operands live on a CUDA device, else ``torch``;
    ``REPRO_KERNEL_BACKEND=cuda|torch`` overrides."""
    env = os.environ.get(_ENV_BACKEND, "").strip().lower()
    if env in KERNEL_BACKENDS + (REFERENCE_BACKEND,):
        return env
    if device is not None and torch.device(device).type == "cuda":
        return "cuda"
    return REFERENCE_BACKEND


def resolve_backend(requested: str = "auto", device=None) -> str:
    """Map a user/config backend string to a concrete backend."""
    if requested in KERNEL_BACKENDS + (REFERENCE_BACKEND,):
        return requested
    if requested != "auto":
        raise ValueError(f"unknown kernel backend {requested!r}")
    return detect_backend(device)


_ENV_FP8 = "REPRO_FP8_NATIVE"


def fp8_native_dot(device=None) -> bool:
    """Does this CUDA device contract e4m3 x e4m3 on its tensor cores?
    The fp8 ``mma`` instruction exists from compute capability 8.9 (Ada,
    Hopper) on.  ``REPRO_FP8_NATIVE=1|0`` overrides the probe (tests)."""
    env = os.environ.get(_ENV_FP8, "").strip().lower()
    if env in ("1", "true", "yes"):
        return True
    if env in ("0", "false", "no"):
        return False
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) >= (8, 9)


def supports_fp8(backend: str, device=None) -> bool:
    """Can ``backend`` run the ``*_fp8`` entries on operands on ``device``?
    The one fp8 capability predicate, the fp8 entries' ``supported``
    (the JAX package's ``supports_fp8``).  CPU operands always can: the
    wrappers run their plain versions there; a CUDA device needs
    :func:`fp8_native_dot`."""
    if backend != "cuda" or device is None or torch.device(device).type != "cuda":
        return True
    return fp8_native_dot(device)


def largest_fitting_block(dim: int, cap: int, multiple_of: int = 1) -> Optional[int]:
    """Largest divisor of ``dim`` that is <= cap and % multiple_of == 0."""
    for c in range(min(cap, dim), 0, -1):
        if dim % c == 0 and c % multiple_of == 0:
            return c
    return None
