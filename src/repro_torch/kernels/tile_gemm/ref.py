"""Plain PyTorch versions of the tile_gemm kernels, in the kernels' own
formulation: fp32 accumulation, the epilogue in fp32, one cast to the
activation dtype.  (The torch dispatch tier's gate-up rounds g and u to
the activation dtype before silu*mul; the dual kernel does not.)

The quantized versions serve both classes, the accumulator chosen by the
operands' dtype (:func:`quantized_accumulate`).  int8 x int8 is
contracted exactly: in float64, where every partial sum (|acc| <= 127^2 *
K < 2^53) is an integer, then cast to int32 (``torch.matmul`` takes no
integer tensors on CUDA, so the card and the CPU share this
formulation).  e4m3 x e4m3 is ``x_q.float() @ w_q.float()`` in fp32:
every product of two e4m3 values is exact in fp32, so only the sums'
order can differ from the kernel's.  The flush then runs the JAX
kernels' order: ``float(acc) * x_scale * w_scale`` left to right in
fp32, the epilogue (the ``requant:<dtype>`` point included, on the duals
and the singles), one cast.  ``*_int8_ref`` and ``*_fp8_ref`` name the same functions.

The masked versions (K10) contract X with the tiles ``kmask`` marks dead
zeroed (:func:`zero_dead_tiles`), then run the unmasked version: what the
kernels compute when they skip those tiles.  ``kmap`` only re-addresses
copies on the TPU and does not enter the result."""

from __future__ import annotations

from typing import Optional

import torch

from ..epilogue import EpilogueSpec, flush_tile
from ..reasons import dtype_name

_SILU_MUL = EpilogueSpec(act="silu_mul")


def tile_gemm_ref(x: torch.Tensor, w: torch.Tensor, *,
                  epilogue: Optional[EpilogueSpec] = None,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out_dtype`` (default x's) is the one cast of the flush: fp32
    keeps the raw sums a row-parallel shard all-reduces."""
    acc = x.float() @ w.float()
    return flush_tile(acc, epilogue or EpilogueSpec(), out_dtype or x.dtype, bias=bias)


def tile_gemm_dual_ref(x: torch.Tensor, w_g: torch.Tensor,
                       w_u: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return flush_tile(xf @ w_g.float(), _SILU_MUL, x.dtype,
                      acc2_32=xf @ w_u.float())


def int8_accumulate(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator of ``x_q (B, K) @ w_q (K, O)``, int8."""
    return (x_q.double() @ w_q.double()).to(torch.int32)


def quantized_accumulate(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The raw accumulator of one quantized class: exact int32 for int8,
    fp32 for float8_e4m3fn."""
    if x_q.dtype != w_q.dtype:
        raise ValueError(f"operands of two classes: {x_q.dtype} and {w_q.dtype}")
    if x_q.dtype == torch.int8:
        return int8_accumulate(x_q, w_q)
    return x_q.float() @ w_q.float()


def dequant_acc(acc: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``float(acc) * x_scale (B, 1) * w_scale (1, O)``, left to right."""
    return acc.float() * x_scale * w_scale


def tile_gemm_quantized_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                            x_scale: Optional[torch.Tensor] = None,
                            w_scale: Optional[torch.Tensor] = None, *,
                            epilogue: Optional[EpilogueSpec] = None,
                            bias: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.float32,
                            requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """With an ``epilogue`` on a ``requant:<dtype>`` point, ``requant_scale``
    is the consumer's scale and the result is of that narrow dtype."""
    acc = quantized_accumulate(x_q, w_q)
    if x_scale is None:
        return acc
    return flush_tile(dequant_acc(acc, x_scale, w_scale), epilogue or EpilogueSpec(),
                      out_dtype, bias=bias, rq_scale=requant_scale)


def with_requant(epilogue: Optional[EpilogueSpec], dtype: torch.dtype) -> EpilogueSpec:
    """``epilogue`` (bias, act) extended with the ``requant:<dtype>`` point
    of the operands' class."""
    epi = epilogue or EpilogueSpec()
    return EpilogueSpec(act=epi.act, bias=epi.bias, requant=dtype_name(dtype))


def tile_gemm_quantized_requant_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                                    requant_scale: torch.Tensor, *,
                                    epilogue: Optional[EpilogueSpec] = None,
                                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The single-GEMM requantize (``tile_gemm_int8_requant`` /
    ``tile_gemm_fp8_requant``): the codes of the operands' class."""
    return tile_gemm_quantized_ref(x_q, w_q, x_scale, w_scale,
                                   epilogue=with_requant(epilogue, x_q.dtype), bias=bias,
                                   requant_scale=requant_scale)


def tile_gemm_dual_quantized_ref(x_q: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                                 x_scale: torch.Tensor, wg_scale: torch.Tensor,
                                 wu_scale: torch.Tensor, *,
                                 out_dtype: torch.dtype = torch.float32,
                                 requant_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """With ``requant_scale`` the flush ends in the ``requant:<dtype>``
    lattice point of the operands' class and the result is of that
    narrow dtype."""
    spec = _SILU_MUL if requant_scale is None else EpilogueSpec(
        act="silu_mul", requant=dtype_name(x_q.dtype))
    return flush_tile(dequant_acc(quantized_accumulate(x_q, w_g), x_scale, wg_scale),
                      spec, out_dtype,
                      acc2_32=dequant_acc(quantized_accumulate(x_q, w_u), x_scale, wu_scale),
                      rq_scale=requant_scale)


tile_gemm_int8_ref = tile_gemm_fp8_ref = tile_gemm_quantized_ref
tile_gemm_int8_requant_ref = tile_gemm_fp8_requant_ref = tile_gemm_quantized_requant_ref
tile_gemm_dual_int8_ref = tile_gemm_dual_fp8_ref = tile_gemm_dual_quantized_ref


def zero_dead_tiles(x: torch.Tensor, kmask: torch.Tensor, block_b: int,
                    block_k: int) -> torch.Tensor:
    """``x (B, K)`` with every (row block, K step) tile that ``kmask``
    (``(ceil(B / block_b), K / block_k)``) marks dead set to zero.  One-byte
    float types are masked through their byte view (+0 is the zero byte)."""
    b, k = x.shape
    live = kmask.bool().repeat_interleave(block_b, 0)[:b].repeat_interleave(block_k, 1)
    if x.element_size() == 1 and x.dtype != torch.int8:
        return torch.where(live, x.view(torch.uint8), 0).view(x.dtype)
    return torch.where(live, x, torch.zeros((), dtype=x.dtype, device=x.device))


def tile_gemm_masked_ref(x: torch.Tensor, w: torch.Tensor, kmap: torch.Tensor,
                         kmask: torch.Tensor, *, block_b: int, block_k: int = 64,
                         epilogue: Optional[EpilogueSpec] = None,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return tile_gemm_ref(zero_dead_tiles(x, kmask, block_b, block_k), w,
                         epilogue=epilogue, bias=bias)


def tile_gemm_masked_quantized_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                                   kmap: torch.Tensor, kmask: torch.Tensor,
                                   x_scale: Optional[torch.Tensor] = None,
                                   w_scale: Optional[torch.Tensor] = None, *,
                                   block_b: int, block_k: int = 64,
                                   epilogue: Optional[EpilogueSpec] = None,
                                   bias: Optional[torch.Tensor] = None,
                                   out_dtype: torch.dtype = torch.float32,
                                   requant_scale: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    return tile_gemm_quantized_ref(zero_dead_tiles(x_q, kmask, block_b, block_k), w_q,
                                   x_scale, w_scale, epilogue=epilogue, bias=bias,
                                   out_dtype=out_dtype, requant_scale=requant_scale)


tile_gemm_masked_int8_ref = tile_gemm_masked_fp8_ref = tile_gemm_masked_quantized_ref
