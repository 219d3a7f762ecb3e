"""Dynamic activation sparsity: masks + per-block skip maps (port of
``repro.kernels.actsparse``).

The engine's activation axis.  Static N:M weight sparsity is a layout,
fixed at prepare time; activation sparsity is dynamic (top-k or threshold
zeros, MoE routing holes) and rides the activations as an
:class:`ActivationSpec`, realized in two steps that keep every route's
numerics the same:

1. **Mask** (always): :func:`apply_mask` zeroes the dropped entries of
   ``x``.  Every route (the torch tier, a kernel) contracts the SAME
   masked operand, so declining the skip never changes numerics.
2. **Skip** (a kernel decision on an entry with a masked variant): the
   run adapter computes :func:`block_maps`, a per-(row block, K step)
   liveness map from one blockwise absmax pass, and hands it to the
   masked kernel (``tile_gemm_masked``, ``nm_spmm_masked``,
   ``nm_spmm_gather_bk_masked``), which walks only the live steps of each
   row block.  Dead tiles contribute exact zeros to the accumulator, so
   the output is bitwise the unmasked kernel's on the same masked ``x``.

The maps are made at the kernel's own blocks: ``block_rows(B)`` rows and
one K step (64 activation columns; ``256 / n`` for the gather kernels,
whose step is 64 compressed rows).  ``kmap`` is the TPU kernel's
re-addressing of dead steps to the last live one, which lets Pallas
elide their copies; the Hopper kernels branch on ``kmask`` alone, and
``kmap`` is computed (bitwise the JAX package's) so that the kernels'
signatures stay the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ActivationSpec", "apply_mask", "block_maps"]


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    """How the use site wants its activations sparsified (or already is).

    ``kind``:
      * ``"topk"``      keep the ``k`` largest-|x| entries per row (ties
                        at the k-th magnitude are all kept)
      * ``"threshold"`` zero entries with ``|x| <= threshold``
      * ``"zeros"``     ``x`` is already sparse (MoE routing holes): the
                        mask pass is the identity and only the block maps
                        run
    """

    kind: str
    k: Optional[int] = None
    threshold: float = 0.0

    def __post_init__(self):
        if self.kind not in ("topk", "threshold", "zeros"):
            raise ValueError(f"unknown activation-sparsity kind {self.kind!r}")
        if self.kind == "topk" and (self.k is None or self.k <= 0):
            raise ValueError("topk activation sparsity needs k > 0")

    @property
    def point(self) -> str:
        """Canonical string for decisions and ``describe()``."""
        if self.kind == "topk":
            return f"top{self.k}"
        if self.kind == "threshold":
            return f"thr{self.threshold:g}"
        return "zeros"


def apply_mask(x: torch.Tensor, spec: ActivationSpec) -> torch.Tensor:
    """The induced mask, applied to ``x`` (identity for ``"zeros"``).
    Magnitudes compare in fp32, as the JAX package's do."""
    if spec.kind == "zeros":
        return x
    mag = x.float().abs()
    if spec.kind == "threshold":
        keep = mag > spec.threshold
    else:   # topk: the row's k-th largest magnitude is the keep boundary
        k = min(spec.k, x.shape[-1])
        kth = torch.topk(mag, k, dim=-1).values[..., -1:]
        keep = mag >= kth
    return torch.where(keep, x, torch.zeros_like(x))


def block_maps(x2: torch.Tensor, block_b: int, block_ke: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row block, K step) skip maps for a masked ``(B, K)`` operand.

    Returns ``(kmap, kmask)``, both ``(ceil(B / block_b), K / block_ke)``
    int32: ``kmask[i, s]`` is 1 iff block (i, s) holds a nonzero entry;
    ``kmap[i, s]`` is the running max of the live steps' indices (the step
    a TPU kernel would load for (i, s)).  Rows past B (the ragged last row
    block of the Hopper kernels) count as zeros; where the JAX package
    defines the maps (B divisible by ``block_b``) they are bitwise its.
    Works on narrow operands too (int8 / e4m3 rows quantized from zeros
    are zero)."""
    b, ke = x2.shape
    if ke % block_ke != 0:
        raise ValueError(f"block_maps: K={ke} is not a multiple of the K step {block_ke}")
    nb, nk = -(-b // block_b), ke // block_ke
    # |x| of float rows in their own dtype (exact; the test is only > 0),
    # of int8 / e4m3 codes through fp32, as the JAX package does for all
    mag = x2.abs() if x2.is_floating_point() and x2.element_size() > 1 else x2.float().abs()
    rows = block_b
    if nb == 1:
        rows = b                        # one (ragged) row block: nothing to pad
    elif nb * block_b != b:
        mag = F.pad(mag, (0, 0, 0, nb * block_b - b))
    live = mag.reshape(nb, rows, nk, block_ke).amax(dim=(1, 3)) > 0
    kmask = live.to(torch.int32)
    steps = torch.arange(nk, dtype=torch.int32, device=x2.device).expand(nb, nk)
    kmap = torch.cummax(torch.where(live, steps, 0), dim=1).values
    return kmap, kmask
