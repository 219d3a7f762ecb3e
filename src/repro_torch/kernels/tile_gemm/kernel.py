"""Dense tile GEMM on Hopper: ``tile_gemm`` and the fused gate-up
``tile_gemm_dual`` (CUDA source: ``kernels/csrc/gemm.cu``), and their
int8 twins ``tile_gemm_int8`` and ``tile_gemm_dual_int8``
(``kernels/csrc/gemm_int8.cu``), and ``tile_gemm_dual_int8_requant``,
the int8 dual whose flush requantizes its output to int8 against the
next linear's static activation scale.

Replaces ``repro/kernels/tile_gemm/kernel.py::tile_gemm`` (:82),
``::tile_gemm_dual`` (:382, float and int8 branches, the int8 one with
the ``requant:int8`` flush of ``repro/kernels/epilogue.py::flush_tile``)
and ``::tile_gemm_int8`` (:448).  On CUDA tensors each wrapper launches its
kernel or raises; on CPU tensors it returns the plain version from
``ref.py`` (the counterpart of the JAX package's interpret mode).  Each
wrapper counts its launches in a plain integer attribute, ``.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..epilogue import EpilogueSpec
from .ref import (tile_gemm_dual_int8_ref, tile_gemm_dual_ref, tile_gemm_int8_ref,
                  tile_gemm_ref)

__all__ = ["tile_gemm", "tile_gemm_dual", "tile_gemm_int8", "tile_gemm_dual_int8",
           "tile_gemm_dual_int8_requant", "ACT_CODES"]

#: epilogue activation -> the C interface's act argument
ACT_CODES = {None: 0, "silu": 1, "gelu": 2}


def check_single_epilogue(kernel: str, epi: EpilogueSpec,
                          bias: Optional[torch.Tensor], o: int) -> None:
    if epi.requant is not None:
        raise NotImplementedError(f"{kernel}: epilogue {epi.point!r}: the single-GEMM "
                                  f"requantize is not ported yet (only the int8 duals "
                                  f"fuse it)")
    if epi.act == "silu_mul":
        raise ValueError(f"{kernel}: epilogue {epi.point!r} is not a "
                         f"single-GEMM lattice point")
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


def check_scales(kernel: str, b: int, o: int, x_scale: Optional[torch.Tensor],
                 *w_scales: Optional[torch.Tensor]) -> bool:
    """The int8 kernels' scale operands: ``x_scale (B, 1)`` and each
    ``w_scale (1, O)``, float32, all given or none (raw mode: returns True)."""
    given = [s is not None for s in (x_scale, *w_scales)]
    if not any(given):
        return True
    if not all(given):
        raise ValueError(f"{kernel}: pass every scale or none")
    if tuple(x_scale.shape) != (b, 1) or any(tuple(w.shape) != (1, o) for w in w_scales):
        raise ValueError(f"{kernel}: scales must be x ({b}, 1) and w (1, {o}), got "
                         f"{tuple(x_scale.shape)} and "
                         f"{[tuple(w.shape) for w in w_scales]}")
    if any(s.dtype != torch.float32 for s in (x_scale, *w_scales)):
        raise ValueError(f"{kernel}: scales must be float32")
    return False


def tile_gemm_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                   x_scale: Optional[torch.Tensor] = None,
                   w_scale: Optional[torch.Tensor] = None, *,
                   epilogue: Optional[EpilogueSpec] = None,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32,
                   block_b: Optional[int] = None) -> torch.Tensor:
    """``Y = epilogue(float(Xq @ Wq) * x_scale * w_scale)`` in ``out_dtype``:
    int8 x int8 contracted into an exact int32 accumulator, dequantized
    once at the flush.  ``x_q (B, K)`` and ``w_q (K, O)`` int8,
    ``x_scale (B, 1)`` and ``w_scale (1, O)`` float32.  With no scales
    it returns the raw int32 accumulator (and takes no epilogue)."""
    epi = epilogue or EpilogueSpec()
    b, k = x_q.shape
    k2, o = w_q.shape
    if k != k2:
        raise ValueError(f"tile_gemm_int8: x {tuple(x_q.shape)} vs w {tuple(w_q.shape)}")
    raw = check_scales("tile_gemm_int8", b, o, x_scale, w_scale)
    if raw and not epi.is_identity:
        raise ValueError("tile_gemm_int8: the raw accumulator takes no epilogue")
    check_single_epilogue("tile_gemm_int8", epi, bias, o)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"tile_gemm_int8: operands must be int8, got {x_q.dtype} "
                         f"and {w_q.dtype}")
    if x_q.device.type == "cpu":
        return tile_gemm_int8_ref(x_q, w_q, x_scale, w_scale, epilogue=epi, bias=bias,
                                  out_dtype=out_dtype)
    bb = block_b or _build.block_rows(b)
    kind = _build.out_kind("tile_gemm_int8", out_dtype, raw)
    bias32 = None if bias is None else bias.float().contiguous()
    extra = [t for t in (x_scale, w_scale, bias32) if t is not None]
    _build.check_operands("tile_gemm_int8", x_q, w_q, *extra, block_b=bb,
                          x_dtype=torch.int8)
    _build.check_tiles("tile_gemm_int8", k, o)
    y = torch.empty((b, o), dtype=torch.int32 if raw else out_dtype, device=x_q.device)
    lib = _build.library("gemm_int8.cu")
    with torch.cuda.device(x_q.device):
        rc = lib.vg_tile_gemm_int8(
            x_q.data_ptr(), w_q.data_ptr(), _ptr(x_scale), _ptr(w_scale), _ptr(bias32),
            y.data_ptr(), b, k, o, ACT_CODES[epi.act], kind, bb, _build.stream_of(x_q))
    tile_gemm_int8.launches += 1
    _build.check(rc, "tile_gemm_int8", lib)
    return y


tile_gemm_int8.launches = 0


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_requant_scale(kernel: str, rq: torch.Tensor) -> None:
    """The requantizing duals' scale operand: the consumer's static
    activation scale, one float32 value (it stays on the device)."""
    if rq.numel() != 1 or rq.dtype != torch.float32:
        raise ValueError(f"{kernel}: requant_scale must be one float32 value, got "
                         f"{rq.dtype} {tuple(rq.shape)}")


def _tile_gemm_dual_int8(wrapper, x_q, w_g, w_u, x_scale, wg_scale, wu_scale, out_dtype,
                         block_b, requant_scale):
    """The shared body of the two int8 dense duals: checks, the plain
    version on CPU tensors, else one launch counted on ``wrapper`` (int8
    output when ``requant_scale`` is given)."""
    kernel = wrapper.__name__
    b, k = x_q.shape
    k2, o = w_g.shape
    if k != k2 or w_u.shape != w_g.shape:
        raise ValueError(f"{kernel}: x {tuple(x_q.shape)}, w_g "
                         f"{tuple(w_g.shape)}, w_u {tuple(w_u.shape)}")
    if check_scales(kernel, b, o, x_scale, wg_scale, wu_scale):
        raise ValueError(f"{kernel}: the dual kernel needs its three scales")
    if any(t.dtype != torch.int8 for t in (x_q, w_g, w_u)):
        raise ValueError(f"{kernel}: operands must be int8")
    if requant_scale is not None:
        check_requant_scale(kernel, requant_scale)
    if x_q.device.type == "cpu":
        return tile_gemm_dual_int8_ref(x_q, w_g, w_u, x_scale, wg_scale, wu_scale,
                                       out_dtype=out_dtype, requant_scale=requant_scale)
    bb = block_b or _build.block_rows(b)
    if requant_scale is None:
        kind, rq = _build.out_kind(kernel, out_dtype, False), ()
    else:
        kind, rq, out_dtype = _build.OUT_REQUANT, (requant_scale,), torch.int8
    _build.check_operands(kernel, x_q, w_g, w_u, x_scale, wg_scale, wu_scale, *rq,
                          block_b=bb, x_dtype=torch.int8)
    _build.check_tiles(kernel, k, o)
    y = torch.empty((b, o), dtype=out_dtype, device=x_q.device)
    lib = _build.library("gemm_int8.cu")
    with torch.cuda.device(x_q.device):
        rc = lib.vg_tile_gemm_dual_int8(
            x_q.data_ptr(), w_g.data_ptr(), w_u.data_ptr(), x_scale.data_ptr(),
            wg_scale.data_ptr(), wu_scale.data_ptr(), _ptr(requant_scale), y.data_ptr(),
            b, k, o, kind, bb, _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


def tile_gemm_dual_int8(x_q: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                        x_scale: torch.Tensor, wg_scale: torch.Tensor,
                        wu_scale: torch.Tensor, *, out_dtype: torch.dtype = torch.float32,
                        block_b: Optional[int] = None) -> torch.Tensor:
    """Fused int8 gate-up: ``silu(deq(Xq @ Wg)) * deq(Xq @ Wu)`` from one
    read of each X tile, two int32 accumulators, each dequantized with
    ``x_scale * w*_scale`` at the flush, silu*mul in fp32, one cast."""
    return _tile_gemm_dual_int8(tile_gemm_dual_int8, x_q, w_g, w_u, x_scale, wg_scale,
                                wu_scale, out_dtype, block_b, None)


tile_gemm_dual_int8.launches = 0


def tile_gemm_dual_int8_requant(x_q: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                                x_scale: torch.Tensor, wg_scale: torch.Tensor,
                                wu_scale: torch.Tensor, requant_scale: torch.Tensor, *,
                                block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_gemm_dual_int8` whose flush then requantizes:
    ``int8(round(clip(silu(g) * u / requant_scale, +-127)))`` against the
    consuming linear's static scale (a one-element float32 tensor on the
    device), so the consumer contracts the rows as they are."""
    return _tile_gemm_dual_int8(tile_gemm_dual_int8_requant, x_q, w_g, w_u, x_scale,
                                wg_scale, wu_scale, torch.int8, block_b, requant_scale)


tile_gemm_dual_int8_requant.launches = 0


def tile_gemm_dual(x: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                   x_scale: Optional[torch.Tensor] = None,
                   wg_scale: Optional[torch.Tensor] = None,
                   wu_scale: Optional[torch.Tensor] = None, *,
                   out_dtype: torch.dtype = torch.float32,
                   block_b: Optional[int] = None) -> torch.Tensor:
    """Fused gate-up: ``silu(X @ Wg) * (X @ Wu)`` from one read of each X
    tile, two fp32 accumulators, silu*mul in fp32, one cast to X's dtype.
    Given the three scales, the int8 branch: :func:`tile_gemm_dual_int8`
    (``out_dtype`` is that branch's output dtype)."""
    if x_scale is not None or wg_scale is not None or wu_scale is not None:
        return tile_gemm_dual_int8(x, w_g, w_u, x_scale, wg_scale, wu_scale,
                                   out_dtype=out_dtype, block_b=block_b)
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
