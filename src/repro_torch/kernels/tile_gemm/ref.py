"""Plain PyTorch versions of the tile_gemm kernels, in the kernels' own
formulation: fp32 accumulation, the epilogue in fp32, one cast to the
activation dtype.  (The torch dispatch tier's gate-up rounds g and u to
the activation dtype before silu*mul; the dual kernel does not.)"""

from __future__ import annotations

from typing import Optional

import torch

from ..epilogue import EpilogueSpec, flush_tile

_SILU_MUL = EpilogueSpec(act="silu_mul")


def tile_gemm_ref(x: torch.Tensor, w: torch.Tensor, *,
                  epilogue: Optional[EpilogueSpec] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    acc = x.float() @ w.float()
    return flush_tile(acc, epilogue or EpilogueSpec(), x.dtype, bias=bias)


def tile_gemm_dual_ref(x: torch.Tensor, w_g: torch.Tensor,
                       w_u: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return flush_tile(xf @ w_g.float(), _SILU_MUL, x.dtype,
                      acc2_32=xf @ w_u.float())
