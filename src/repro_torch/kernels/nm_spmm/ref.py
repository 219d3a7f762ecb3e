"""Plain PyTorch versions of the nm_spmm kernels: decompress the N:4
weight, then the tile_gemm formulation (fp32 accumulation, epilogue in
fp32, one cast)."""

from __future__ import annotations

from typing import Optional

import torch

from ...core import nm
from ..epilogue import EpilogueSpec
from ..tile_gemm.ref import tile_gemm_dual_ref, tile_gemm_ref


def dense_weight(values: torch.Tensor, meta_packed: torch.Tensor, n: int) -> torch.Tensor:
    """The dense ``(K_eff, O)`` weight the kernel expands tile by tile."""
    return nm.decompress(values, nm.unpack_meta(meta_packed), n, 4)


def nm_spmm_ref(x: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                n: int, *, epilogue: Optional[EpilogueSpec] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return tile_gemm_ref(x, dense_weight(values, meta_packed, n),
                         epilogue=epilogue, bias=bias)


def nm_spmm_dual_ref(x: torch.Tensor, values_g: torch.Tensor, meta_g: torch.Tensor,
                     values_u: torch.Tensor, meta_u: torch.Tensor,
                     n: int) -> torch.Tensor:
    return tile_gemm_dual_ref(x, dense_weight(values_g, meta_g, n),
                              dense_weight(values_u, meta_u, n))
