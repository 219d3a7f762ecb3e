"""Dense tile GEMM on Hopper: ``tile_gemm`` and the fused gate-up
``tile_gemm_dual`` (CUDA source: ``kernels/csrc/gemm.cu``).

Replaces ``repro/kernels/tile_gemm/kernel.py::tile_gemm`` (:82) and
``::tile_gemm_dual`` (:382).  On CUDA tensors each wrapper launches its
kernel or raises; on CPU tensors it returns the plain version from
``ref.py`` (the counterpart of the JAX package's interpret mode).  Each
wrapper counts its launches in a plain integer attribute, ``.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..epilogue import EpilogueSpec
from .ref import tile_gemm_dual_ref, tile_gemm_ref

__all__ = ["tile_gemm", "tile_gemm_dual", "ACT_CODES"]

#: epilogue activation -> the C interface's act argument
ACT_CODES = {None: 0, "silu": 1, "gelu": 2}


def check_single_epilogue(kernel: str, epi: EpilogueSpec,
                          bias: Optional[torch.Tensor], o: int) -> None:
    if epi.requant is not None or epi.act == "silu_mul":
        raise ValueError(f"{kernel}: epilogue {epi.point!r} is not a "
                         f"single-GEMM float lattice point")
    if epi.bias != (bias is not None):
        raise ValueError(f"{kernel}: bias operand must match the epilogue spec")
    if bias is not None and bias.numel() != o:
        raise ValueError(f"{kernel}: bias must be ({o},), got {tuple(bias.shape)}")


def tile_gemm(x: torch.Tensor, w: torch.Tensor, *,
              epilogue: Optional[EpilogueSpec] = None,
              bias: Optional[torch.Tensor] = None,
              block_b: Optional[int] = None) -> torch.Tensor:
    """``Y (B, O) = epilogue(X (B, K) @ W (K, O))`` in X's dtype."""
    epi = epilogue or EpilogueSpec()
    b, k = x.shape
    k2, o = w.shape
    if k != k2:
        raise ValueError(f"tile_gemm: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    check_single_epilogue("tile_gemm", epi, bias, o)
    if x.device.type == "cpu":
        return tile_gemm_ref(x, w, epilogue=epi, bias=bias)
    bb = block_b or _build.block_rows(b)
    bias32 = None if bias is None else bias.float().contiguous()
    extra = () if bias32 is None else (bias32,)
    _build.check_operands("tile_gemm", x, w, *extra, block_b=bb)
    if w.dtype != x.dtype:
        raise ValueError(f"tile_gemm: w is {w.dtype}, x is {x.dtype}")
    _build.check_tiles("tile_gemm", k, o)
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_tile_gemm(x.data_ptr(), w.data_ptr(),
                              None if bias32 is None else bias32.data_ptr(),
                              y.data_ptr(), b, k, o, ACT_CODES[epi.act], bb,
                              _build.stream_of(x))
    tile_gemm.launches += 1
    _build.check(rc, "tile_gemm", lib)
    return y


tile_gemm.launches = 0


def tile_gemm_dual(x: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor, *,
                   block_b: Optional[int] = None) -> torch.Tensor:
    """Fused gate-up: ``silu(X @ Wg) * (X @ Wu)`` from one read of each X
    tile, two fp32 accumulators, silu*mul in fp32, one cast."""
    b, k = x.shape
    k2, o = w_g.shape
    if k != k2 or w_u.shape != w_g.shape:
        raise ValueError(f"tile_gemm_dual: x {tuple(x.shape)}, w_g "
                         f"{tuple(w_g.shape)}, w_u {tuple(w_u.shape)}")
    if x.device.type == "cpu":
        return tile_gemm_dual_ref(x, w_g, w_u)
    bb = block_b or _build.block_rows(b)
    _build.check_operands("tile_gemm_dual", x, w_g, w_u, block_b=bb)
    if w_g.dtype != x.dtype or w_u.dtype != x.dtype:
        raise ValueError("tile_gemm_dual: weights must share x's dtype")
    _build.check_tiles("tile_gemm_dual", k, o)
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_tile_gemm_dual(x.data_ptr(), w_g.data_ptr(), w_u.data_ptr(),
                                   y.data_ptr(), b, k, o, bb, _build.stream_of(x))
    tile_gemm_dual.launches += 1
    _build.check(rc, "tile_gemm_dual", lib)
    return y


tile_gemm_dual.launches = 0
