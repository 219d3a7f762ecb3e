"""Public wrapper of the K-major gather (port of
``repro.kernels.nm_spmm_gather.ops``): standard ``(B, K_eff)`` activations
in, ``(B, O)`` out, through :func:`.kernel.nm_spmm_gather` on ``x.T``."""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import nm_spmm_gather

__all__ = ["nm_spmm_gather_op"]


def nm_spmm_gather_op(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, *, n: int,
                      block_b: Optional[int] = None) -> torch.Tensor:
    """``gather(x, idx) @ values`` as ``nm_spmm_gather(x.T, ...).T``, fp32
    out, as the JAX package's op (two transposes through device memory;
    the bk kernels avoid them)."""
    y_t = nm_spmm_gather(x.t().contiguous(), values, idx.reshape(-1, 1), n, block_b=block_b)
    return y_t.t()
