"""Plain PyTorch versions of the lane-aligned gather kernels: gather X's
kept columns (``x[:, (c // n) * 4 + idx[c]]`` for every compressed row c),
then the tile_gemm formulation over the reduced K_c (fp32 accumulation,
epilogue in fp32, one cast; for int8 or e4m3 operands the class's
accumulator of ``tile_gemm/ref.py``).

The quantized flush multiplies the weight scale BEFORE the activation
scale, ``float(acc) * w_scale * x_scale``, as the JAX package's gather
kernels do (``nm_spmm_gather/kernel.py:315-317``; the tile and N:M
kernels multiply ``x_scale`` first), so the scaled int8 outputs are
bitwise the reference's.  Activations are quantized over their full
K_eff row before the gather (the codes are gathered, not the floats).
``*_int8_ref`` and ``*_fp8_ref`` name the same functions.  The masked
versions zero the tiles ``kmask`` marks dead first, at the kernels' K
step of 64 compressed rows, ``256 / n`` activation columns.

The K-major forms (K11, ``nm_spmm_gather_t*``) take ``x_t (K_eff, B)`` and
return ``Y_t (O, B)``: the same gather of the kept rows of ``x_t``, the
same accumulators, dequantized ``acc * w_scale (O, 1) * x_scale (1, B)``
(the JAX package's ``_gather_q_kernel`` order), or the raw accumulator
with no scales; the float form casts its fp32 sums to ``out_dtype``."""

from __future__ import annotations

from typing import Optional

import torch

from ..epilogue import EpilogueSpec, flush_tile
from ..reasons import dtype_name
from ..tile_gemm.ref import (quantized_accumulate, tile_gemm_ref, with_requant,
                             zero_dead_tiles)

_SILU_MUL = EpilogueSpec(act="silu_mul")


def gather_columns(x: torch.Tensor, idx: torch.Tensor, n: int, m: int = 4) -> torch.Tensor:
    """``x (B, K_eff)`` -> ``(B, K_c)``: column c is X column ``(c // n) * m
    + idx[c]``, the kept candidate of compressed row c's M-block.  One-byte
    dtypes are gathered through their byte view (no float8 kernel needed)."""
    cols = torch.arange(idx.shape[0], device=idx.device) // n * m + idx.long()
    if x.element_size() == 1 and x.dtype != torch.int8:
        return x.view(torch.uint8).index_select(-1, cols).view(x.dtype)
    return x.index_select(-1, cols)


def dequant_ws_first(acc: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """``float(acc) * w_scale (1, O) * x_scale (B, 1)``, left to right."""
    return acc.float() * w_scale * x_scale


def nm_spmm_gather_ref(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, n: int, *,
                       epilogue: Optional[EpilogueSpec] = None,
                       bias: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return tile_gemm_ref(gather_columns(x, idx, n), values, epilogue=epilogue, bias=bias,
                         out_dtype=out_dtype)


def nm_spmm_gather_dual_ref(x: torch.Tensor, values_g: torch.Tensor, idx_g: torch.Tensor,
                            values_u: torch.Tensor, idx_u: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Gate and up gather X through their own index streams."""
    acc_g = gather_columns(x, idx_g, n).float() @ values_g.float()
    acc_u = gather_columns(x, idx_u, n).float() @ values_u.float()
    return flush_tile(acc_g, _SILU_MUL, x.dtype, acc2_32=acc_u)


def nm_spmm_gather_quantized_ref(x_q: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                                 x_scale: Optional[torch.Tensor],
                                 w_scale: Optional[torch.Tensor], n: int, *,
                                 epilogue: Optional[EpilogueSpec] = None,
                                 bias: Optional[torch.Tensor] = None,
                                 out_dtype: torch.dtype = torch.float32,
                                 requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    acc = quantized_accumulate(gather_columns(x_q, idx, n), values)
    if x_scale is None:
        return acc
    return flush_tile(dequant_ws_first(acc, x_scale, w_scale), epilogue or EpilogueSpec(),
                      out_dtype, bias=bias, rq_scale=requant_scale)


def nm_spmm_gather_quantized_requant_ref(x_q: torch.Tensor, values: torch.Tensor,
                                         idx: torch.Tensor, x_scale: torch.Tensor,
                                         w_scale: torch.Tensor, n: int,
                                         requant_scale: torch.Tensor, *,
                                         epilogue: Optional[EpilogueSpec] = None,
                                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The single-GEMM requantize: the codes of the operands' class."""
    return nm_spmm_gather_quantized_ref(x_q, values, idx, x_scale, w_scale, n,
                                        epilogue=with_requant(epilogue, x_q.dtype), bias=bias,
                                        requant_scale=requant_scale)


def nm_spmm_gather_dual_quantized_ref(x_q: torch.Tensor, values_g: torch.Tensor,
                                      idx_g: torch.Tensor, values_u: torch.Tensor,
                                      idx_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                                      wg_scale: torch.Tensor, wu_scale: torch.Tensor, *,
                                      out_dtype: torch.dtype = torch.float32,
                                      requant_scale: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """With ``requant_scale`` the flush ends in the ``requant:<dtype>``
    lattice point of the operands' class and the result is of that
    narrow dtype."""
    spec = _SILU_MUL if requant_scale is None else EpilogueSpec(
        act="silu_mul", requant=dtype_name(x_q.dtype))
    acc_g = quantized_accumulate(gather_columns(x_q, idx_g, n), values_g)
    acc_u = quantized_accumulate(gather_columns(x_q, idx_u, n), values_u)
    return flush_tile(dequant_ws_first(acc_g, x_scale, wg_scale), spec, out_dtype,
                      acc2_32=dequant_ws_first(acc_u, x_scale, wu_scale),
                      rq_scale=requant_scale)


nm_spmm_gather_int8_ref = nm_spmm_gather_fp8_ref = nm_spmm_gather_quantized_ref
nm_spmm_gather_int8_requant_ref = nm_spmm_gather_fp8_requant_ref = \
    nm_spmm_gather_quantized_requant_ref
nm_spmm_gather_dual_int8_ref = nm_spmm_gather_dual_fp8_ref = nm_spmm_gather_dual_quantized_ref


def nm_spmm_gather_masked_ref(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                              kmap: torch.Tensor, kmask: torch.Tensor, n: int, *,
                              block_b: int, epilogue: Optional[EpilogueSpec] = None,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return nm_spmm_gather_ref(zero_dead_tiles(x, kmask, block_b, 256 // n), values, idx, n,
                              epilogue=epilogue, bias=bias)


def nm_spmm_gather_masked_quantized_ref(x_q: torch.Tensor, values: torch.Tensor,
                                        idx: torch.Tensor, kmap: torch.Tensor,
                                        kmask: torch.Tensor, n: int,
                                        x_scale: Optional[torch.Tensor] = None,
                                        w_scale: Optional[torch.Tensor] = None, *,
                                        block_b: int,
                                        epilogue: Optional[EpilogueSpec] = None,
                                        bias: Optional[torch.Tensor] = None,
                                        out_dtype: torch.dtype = torch.float32,
                                        requant_scale: Optional[torch.Tensor] = None
                                        ) -> torch.Tensor:
    return nm_spmm_gather_quantized_ref(zero_dead_tiles(x_q, kmask, block_b, 256 // n), values,
                                        idx, x_scale, w_scale, n, epilogue=epilogue, bias=bias,
                                        out_dtype=out_dtype, requant_scale=requant_scale)


nm_spmm_gather_masked_int8_ref = nm_spmm_gather_masked_fp8_ref = \
    nm_spmm_gather_masked_quantized_ref


def nm_spmm_gather_t_ref(x_t: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, n: int,
                         *, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K11, float: ``Y_t (O, B) = values^T @ gather(x_t)`` in fp32, one cast."""
    x_g = gather_columns(x_t.t(), idx.reshape(-1), n)                  # (B, K_c)
    return (x_g.float() @ values.float()).t().to(out_dtype)


def nm_spmm_gather_t_quantized_ref(x_t: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                                   x_scale: Optional[torch.Tensor],
                                   w_scale: Optional[torch.Tensor], n: int, *,
                                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K11, int8 or e4m3: the class's raw (O, B) accumulator with no
    scales, else ``float(acc) * w_scale (O, 1) * x_scale (1, B)`` in
    ``out_dtype``."""
    acc = quantized_accumulate(gather_columns(x_t.t(), idx.reshape(-1), n), values).t()
    if x_scale is None:
        return acc
    return (acc.float() * w_scale * x_scale).to(out_dtype)

