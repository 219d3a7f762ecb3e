"""Plain PyTorch versions of the nm_spmm kernels: decompress the N:4
weight, then the tile_gemm formulation (fp32 accumulation, epilogue in
fp32, one cast; for int8 or e4m3 values the quantized accumulator and
flush of ``tile_gemm/ref.py``).  The masked versions zero the tiles
``kmask`` marks dead first (``tile_gemm/ref.py::zero_dead_tiles``).  ``*_int8_ref`` and ``*_fp8_ref`` name the
same functions."""

from __future__ import annotations

from typing import Optional

import torch

from ...core import nm
from ..epilogue import EpilogueSpec
from ..tile_gemm.ref import (tile_gemm_dual_quantized_ref, tile_gemm_dual_ref,
                             tile_gemm_quantized_ref, tile_gemm_ref, with_requant,
                             zero_dead_tiles)


def dense_weight(values: torch.Tensor, meta_packed: torch.Tensor, n: int) -> torch.Tensor:
    """The dense ``(K_eff, O)`` weight the kernel expands tile by tile."""
    return nm.decompress(values, nm.unpack_meta(meta_packed), n, 4)


def nm_spmm_ref(x: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                n: int, *, epilogue: Optional[EpilogueSpec] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return tile_gemm_ref(x, dense_weight(values, meta_packed, n),
                         epilogue=epilogue, bias=bias, out_dtype=out_dtype)


def nm_spmm_dual_ref(x: torch.Tensor, values_g: torch.Tensor, meta_g: torch.Tensor,
                     values_u: torch.Tensor, meta_u: torch.Tensor,
                     n: int) -> torch.Tensor:
    return tile_gemm_dual_ref(x, dense_weight(values_g, meta_g, n),
                              dense_weight(values_u, meta_u, n))


def nm_spmm_quantized_ref(x_q: torch.Tensor, values: torch.Tensor,
                          meta_packed: torch.Tensor, x_scale: Optional[torch.Tensor],
                          w_scale: Optional[torch.Tensor], n: int, *,
                          epilogue: Optional[EpilogueSpec] = None,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.float32,
                          requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    return tile_gemm_quantized_ref(x_q, dense_weight(values, meta_packed, n), x_scale,
                                   w_scale, epilogue=epilogue, bias=bias,
                                   out_dtype=out_dtype, requant_scale=requant_scale)


def nm_spmm_quantized_requant_ref(x_q: torch.Tensor, values: torch.Tensor,
                                  meta_packed: torch.Tensor, x_scale: torch.Tensor,
                                  w_scale: torch.Tensor, n: int, requant_scale: torch.Tensor,
                                  *, epilogue: Optional[EpilogueSpec] = None,
                                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The single-GEMM requantize: the codes of the operands' class."""
    return nm_spmm_quantized_ref(x_q, values, meta_packed, x_scale, w_scale, n,
                                 epilogue=with_requant(epilogue, x_q.dtype), bias=bias,
                                 requant_scale=requant_scale)


def nm_spmm_dual_quantized_ref(x_q: torch.Tensor, values_g: torch.Tensor,
                               meta_g: torch.Tensor, values_u: torch.Tensor,
                               meta_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                               wg_scale: torch.Tensor, wu_scale: torch.Tensor, *,
                               out_dtype: torch.dtype = torch.float32,
                               requant_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    return tile_gemm_dual_quantized_ref(x_q, dense_weight(values_g, meta_g, n),
                                        dense_weight(values_u, meta_u, n), x_scale,
                                        wg_scale, wu_scale, out_dtype=out_dtype,
                                        requant_scale=requant_scale)


nm_spmm_int8_ref = nm_spmm_fp8_ref = nm_spmm_quantized_ref
nm_spmm_int8_requant_ref = nm_spmm_fp8_requant_ref = nm_spmm_quantized_requant_ref
nm_spmm_dual_int8_ref = nm_spmm_dual_fp8_ref = nm_spmm_dual_quantized_ref


def nm_spmm_masked_ref(x: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                       kmap: torch.Tensor, kmask: torch.Tensor, n: int, *, block_b: int,
                       block_k: int = 64, epilogue: Optional[EpilogueSpec] = None,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return nm_spmm_ref(zero_dead_tiles(x, kmask, block_b, block_k), values, meta_packed, n,
                       epilogue=epilogue, bias=bias)


def nm_spmm_masked_quantized_ref(x_q: torch.Tensor, values: torch.Tensor,
                                 meta_packed: torch.Tensor, kmap: torch.Tensor,
                                 kmask: torch.Tensor, n: int,
                                 x_scale: Optional[torch.Tensor] = None,
                                 w_scale: Optional[torch.Tensor] = None, *, block_b: int,
                                 block_k: int = 64,
                                 epilogue: Optional[EpilogueSpec] = None,
                                 bias: Optional[torch.Tensor] = None,
                                 out_dtype: torch.dtype = torch.float32,
                                 requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    return nm_spmm_quantized_ref(zero_dead_tiles(x_q, kmask, block_b, block_k), values,
                                 meta_packed, x_scale, w_scale, n, epilogue=epilogue, bias=bias,
                                 out_dtype=out_dtype, requant_scale=requant_scale)


nm_spmm_masked_int8_ref = nm_spmm_masked_fp8_ref = nm_spmm_masked_quantized_ref
