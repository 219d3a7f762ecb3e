"""Lane-aligned N:4 GEMM on Hopper, in the natural (B, K) layout:
``nm_spmm_gather_bk`` and the fused gate-up ``nm_spmm_gather_dual_bk``
(CUDA source: ``kernels/csrc/gemm.cu``); their int8 twins
``nm_spmm_gather_bk_int8`` and ``nm_spmm_gather_dual_bk_int8``
(``kernels/csrc/gemm_int8.cu``) and fp8 (e4m3) twins
``nm_spmm_gather_bk_fp8`` and ``nm_spmm_gather_dual_bk_fp8``
(``kernels/csrc/gemm_fp8.cu``); and ``nm_spmm_gather_dual_bk_int8_requant``
/ ``nm_spmm_gather_dual_bk_fp8_requant``, the quantized duals whose flush
requantizes to the class's narrow dtype against the next linear's static
activation scale, and the singles with that flush,
``nm_spmm_gather_bk_int8_requant`` / ``nm_spmm_gather_bk_fp8_requant``.
K10: ``nm_spmm_gather_bk_masked`` and its int8 and fp8 twins, with the
activation-sparsity block skip (K steps of 64 compressed rows, ``256 /
n`` activation columns).  K11: ``nm_spmm_gather``, ``nm_spmm_gather_int8``
and ``nm_spmm_gather_fp8``, the same product in the K-major layout,
``Y_t (O, B)`` from ``x_t (K_eff, B)``, scaled or (quantized) the raw
accumulator the sharded row-parallel path all-reduces.

``Y (B, O) = gather(X (B, K_eff), idx) (B, K_c) @ values (K_c, O)`` with
``K_c = K_eff * n / 4``: every output channel shares one in-block index
per compressed row (``idx (K_c,)`` int32), so the kernel loads X's kept
columns, ``(c // n) * 4 + idx[c]``, straight into its X tile and
contracts a plain dense values tile: n/4 of the dense weight bytes and
FLOPs, no on-chip expansion.  The duals gather X twice, once through
each weight's own index stream, from one activation read.

``nm_spmm_gather_bk`` (float) at n in {1, 2} runs the two bodies K1 runs
over its dense weight, with the X side gathered, chosen by :func:`plan`
from ``(B, K_eff, O, n)``: at few rows the stream of ``csrc/nm_spmm_sp.cuh``
(the step's X span by cp.async, a select pass into the X tile, split-K
over a cluster), from 256 rows a gather pass (``gemm.cu``) writing the
compact X into a scratch the wrapper allocates, then the TMA + wgmma body
of ``csrc/tile_gemm_sm90.cuh`` over it.  ``nm_spmm_gather_dual_bk``
(float) at n in {1, 2} runs the dual forms of those, chosen by
:func:`dual_plan`: the stream landing one X span a step and selecting it
twice, and from 256 rows one gather pass writing both compact X's, then
the dual wgmma body.  Every other kernel here runs the shared bodies of
``gemm.cu`` / ``gemm_int8.cu`` / ``gemm_fp8.cu``.

Replaces ``repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_bk``
(:324, float and scaled-quantized, with the epilogue),
``::nm_spmm_gather_dual_bk`` (:566, float, int8 and fp8),
``::nm_spmm_gather_bk_masked`` (:445) and the K-major ``::nm_spmm_gather``
(:87), ``::nm_spmm_gather_int8`` (:211) and ``::nm_spmm_gather_fp8`` (:243), the quantized ones each with the
``requant:<dtype>`` flush of ``repro/kernels/epilogue.py::flush_tile``.  The quantized flush keeps
the gather kernels' order, ``acc * w_scale * x_scale``.  CUDA tensors
launch the kernel or raise; CPU tensors take the plain version from
``ref.py``.  Launch counts live in ``.launches`` on each wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..epilogue import EpilogueSpec
from ..reasons import dtype_name
from ..tile_gemm.kernel import (ACT_CODES, BODY_CODES, WGMMA_MIN_ROWS, _ptr, check_maps,
                                check_requant_scale, check_scales, check_single_epilogue,
                                float_out, quantized_out, requant_spec, stream_plan)
from ..tile_gemm.kernel import dual_plan as tile_dual_plan
from ..tile_gemm.kernel import plan as tile_plan
from .ref import (nm_spmm_gather_dual_quantized_ref, nm_spmm_gather_dual_ref,
                  nm_spmm_gather_masked_quantized_ref, nm_spmm_gather_masked_ref,
                  nm_spmm_gather_quantized_ref, nm_spmm_gather_ref,
                  nm_spmm_gather_t_quantized_ref, nm_spmm_gather_t_ref)

__all__ = ["nm_spmm_gather_bk", "plan", "dual_plan", "DUAL_SHARED_MAX_KC",
           "nm_spmm_gather_dual_bk", "nm_spmm_gather_bk_int8",
           "nm_spmm_gather_bk_int8_requant", "nm_spmm_gather_dual_bk_int8",
           "nm_spmm_gather_dual_bk_int8_requant", "nm_spmm_gather_bk_fp8",
           "nm_spmm_gather_bk_fp8_requant", "nm_spmm_gather_dual_bk_fp8",
           "nm_spmm_gather_dual_bk_fp8_requant", "nm_spmm_gather_bk_masked",
           "nm_spmm_gather_bk_masked_int8", "nm_spmm_gather_bk_masked_fp8",
           "nm_spmm_gather", "nm_spmm_gather_int8", "nm_spmm_gather_fp8"]

_N = (1, 2, 4)
#: K9 at 1:4 keeps the shared body at 64-row tiles below 64 rows where K_c
#: is at most this (internlm2-1.8b's gate-up, K_c = 512: eight K steps)
DUAL_SHARED_MAX_KC = 512

def plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_bk``'s (float) body, tile and split for ``gather(X
    (b, ke), idx) @ values (ke * n / 4, o)``.  n in {1, 2}: ``wgmma`` from
    ``WGMMA_MIN_ROWS`` rows, a gather pass into a (b, K_c) scratch then K1's
    wgmma body (``csrc/tile_gemm_sm90.cuh``) with the tile K1's own
    :func:`~repro_torch.kernels.tile_gemm.kernel.plan` picks for (b, K_c,
    o); below, ``stream`` (``csrc/nm_spmm_sp.cuh`` over the values with
    the gathered X): ``tile_gemm.kernel.stream_plan`` over the K_c = ke * n
    / 4 contraction.  n = 4, and n = 1 at 64-row tiles below 256 rows
    (where the stream lost to it on an H100 at internlm2-1.8b's sites),
    keep ``shared`` (gemm.cu's body, the form the port ran first), split 1.
    Returns ``{"body", "rows", "cols", "split"}``; ``rows`` is what the C
    interface takes as ``bm``."""
    rows = _build.block_rows(b)
    kc = ke * n // 4
    if n not in (1, 2) or (n == 1 and rows == _build.BLOCK_ROWS[1] and b < WGMMA_MIN_ROWS):
        return {"body": "shared", "rows": rows, "cols": _build.BLOCK_O, "split": 1}
    if b >= WGMMA_MIN_ROWS:
        return tile_plan(b, kc, o)
    return stream_plan(b, kc, o)


def dual_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_dual_bk``'s (float) body, tile and split for
    ``silu(gather(X (b, ke), idx_g) @ values_g) * (gather(X, idx_u) @
    values_u)``, both values ``(ke * n / 4, o)``.  n in {1, 2}: the body
    ``tile_gemm.kernel.dual_plan`` picks for ``(b, K_c, o)``: ``wgmma`` (one
    gather pass writing both compact X's into a (b, 2 K_c) scratch, then
    the dual wgmma body with two X tiles a stage) or ``stream``
    (``csrc/nm_spmm_sp.cuh``'s dual form: one X span a step, selected
    twice), with its tile and split over K_c.  ``shared`` (gemm.cu's body,
    the form the port ran first; split 1) at n = 4, and at 1:4 where that
    plan takes ``wgmma`` below 64 rows and K_c is at most
    ``DUAL_SHARED_MAX_KC``: at internlm2-1.8b's gate-up (K_c = 512) the
    gather pass and the dual wgmma body lost to the shared body there on
    an H100, and won at 64 rows and at phi-3-vision's K_c = 768
    (``chip_smoke.py``'s dual sweep phase; PERF.md §6).  Returns
    ``{"body", "rows", "cols", "split"}``."""
    rows, kc = _build.block_rows(b), ke * n // 4
    p = tile_dual_plan(b, kc, o) if n in (1, 2) else None
    if p is None or (n == 1 and p["body"] == "wgmma" and b < _build.BLOCK_ROWS[1]
                     and kc <= DUAL_SHARED_MAX_KC):
        return {"body": "shared", "rows": rows, "cols": _build.BLOCK_O, "split": 1}
    return p


def _check_gather(kernel: str, ke: int, values: torch.Tensor, idx: torch.Tensor,
                  n: int) -> int:
    """K_c = K_eff * n / 4 values rows and one int32 index per row."""
    if n not in _N:
        raise ValueError(f"{kernel}: n must be one of {_N} (M=4), got {n}")
    kc, o = values.shape
    if ke * n != kc * 4:
        raise ValueError(f"{kernel}: K_eff={ke} with n={n} needs K_c={ke * n // 4}, "
                         f"values are {tuple(values.shape)}")
    if tuple(idx.shape) != (kc,) or idx.dtype != torch.int32:
        raise ValueError(f"{kernel}: idx must be int32 ({kc},), got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    return o


def _check_pair(kernel: str, values_g, idx_g, values_u, idx_u) -> None:
    if values_u.shape != values_g.shape or idx_u.shape != idx_g.shape \
            or idx_u.dtype != idx_g.dtype:
        raise ValueError(f"{kernel}: gate and up layouts must match")


def nm_spmm_gather_bk(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, n: int, *,
                      epilogue: Optional[EpilogueSpec] = None,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      block_b: Optional[int] = None) -> torch.Tensor:
    """``epilogue(gather(X, idx) @ values)`` in X's dtype (or
    ``out_dtype=torch.float32``, the sums a row-parallel shard
    all-reduces), M = 4.  ``block_b`` is the dispatch plan's row block
    (checked); the body, its tile and its K split are :func:`plan`'s."""
    epi = epilogue or EpilogueSpec()
    b, ke = x.shape
    o = _check_gather("nm_spmm_gather_bk", ke, values, idx, n)
    check_single_epilogue("nm_spmm_gather_bk", epi, bias, o)
    out_dtype, out_f32 = float_out("nm_spmm_gather_bk", x, out_dtype)
    if x.device.type == "cpu":
        return nm_spmm_gather_ref(x, values, idx, n, epilogue=epi, bias=bias,
                                  out_dtype=out_dtype)
    bb = block_b or _build.block_rows(b)
    bias32 = None if bias is None else bias.float().contiguous()
    _build.check_operands("nm_spmm_gather_bk", x, values, idx,
                          *(() if bias32 is None else (bias32,)), block_b=bb)
    if values.dtype != x.dtype:
        raise ValueError("nm_spmm_gather_bk: values must share x's dtype")
    _build.check_tiles("nm_spmm_gather_bk", values.shape[0], o)
    y = torch.empty((b, o), dtype=out_dtype, device=x.device)
    p = plan(b, ke, o, n)
    # the wgmma plan's gather pass writes the compact X here
    xg = (torch.empty((b, values.shape[0]), dtype=x.dtype, device=x.device)
          if p["body"] == "wgmma" else None)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm_gather_bk(x.data_ptr(), values.data_ptr(), idx.data_ptr(),
                                      _ptr(bias32), y.data_ptr(), b, ke, o, n,
                                      ACT_CODES[epi.act], out_f32, p["rows"],
                                      BODY_CODES[p["body"]], p["cols"], p["split"], _ptr(xg),
                                      _build.stream_of(x))
    nm_spmm_gather_bk.launches += 1
    _build.check(rc, "nm_spmm_gather_bk", lib)
    return y


nm_spmm_gather_bk.launches = 0


def nm_spmm_gather_bk_masked(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                             kmap: torch.Tensor, kmask: torch.Tensor, n: int, *,
                             epilogue: Optional[EpilogueSpec] = None,
                             bias: Optional[torch.Tensor] = None,
                             block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_bk` with the activation-sparsity block skip:
    only the (row block, K step) tiles ``kmask`` marks live are gathered
    and multiplied, a K step being 64 compressed rows (``256 / n``
    activation columns).  ``kmap`` / ``kmask``: ``actsparse.block_maps``
    over the masked X at ``block_b`` rows and ``256 / n`` columns; the
    CUDA body ignores ``kmap``.  Bitwise itself with every tile live on
    the same masked X (dead tiles add exact zeros); within bf16 rounding of
    :func:`nm_spmm_gather_bk`, whose own bodies (n in {1, 2}) sum in
    another order (bitwise it at n = 4)."""
    epi = epilogue or EpilogueSpec()
    b, ke = x.shape
    o = _check_gather("nm_spmm_gather_bk_masked", ke, values, idx, n)
    check_single_epilogue("nm_spmm_gather_bk_masked", epi, bias, o)
    bb = block_b or _build.block_rows(b)
    check_maps("nm_spmm_gather_bk_masked", kmap, kmask, b, values.shape[0], bb, 256 // n)
    if x.device.type == "cpu":
        return nm_spmm_gather_masked_ref(x, values, idx, kmap, kmask, n, block_b=bb,
                                         epilogue=epi, bias=bias)
    bias32 = None if bias is None else bias.float().contiguous()
    _build.check_operands("nm_spmm_gather_bk_masked", x, values, idx, kmask,
                          *(() if bias32 is None else (bias32,)), block_b=bb)
    if values.dtype != x.dtype:
        raise ValueError("nm_spmm_gather_bk_masked: values must share x's dtype")
    _build.check_tiles("nm_spmm_gather_bk_masked", values.shape[0], o)
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm_gather_bk_masked(x.data_ptr(), values.data_ptr(), idx.data_ptr(),
                                             kmask.data_ptr(), _ptr(bias32), y.data_ptr(), b,
                                             ke, o, n, ACT_CODES[epi.act], bb,
                                             _build.stream_of(x))
    nm_spmm_gather_bk_masked.launches += 1
    _build.check(rc, "nm_spmm_gather_bk_masked", lib)
    return y


nm_spmm_gather_bk_masked.launches = 0


def nm_spmm_gather_dual_bk(x: torch.Tensor, values_g: torch.Tensor, idx_g: torch.Tensor,
                           values_u: torch.Tensor, idx_u: torch.Tensor, n: int, *,
                           block_b: Optional[int] = None) -> torch.Tensor:
    """Fused gate-up over two gather weights sharing one X read:
    ``silu(gather(X, idx_g) @ values_g) * (gather(X, idx_u) @ values_u)``
    in X's dtype.  ``block_b`` is the dispatch plan's row block (checked);
    the body, its tile and its K split are :func:`dual_plan`'s."""
    b, ke = x.shape
    o = _check_gather("nm_spmm_gather_dual_bk", ke, values_g, idx_g, n)
    _check_pair("nm_spmm_gather_dual_bk", values_g, idx_g, values_u, idx_u)
    if x.device.type == "cpu":
        return nm_spmm_gather_dual_ref(x, values_g, idx_g, values_u, idx_u, n)
    bb = block_b or _build.block_rows(b)
    _build.check_operands("nm_spmm_gather_dual_bk", x, values_g, idx_g, values_u, idx_u,
                          block_b=bb)
    if values_g.dtype != x.dtype or values_u.dtype != x.dtype:
        raise ValueError("nm_spmm_gather_dual_bk: values must share x's dtype")
    _build.check_tiles("nm_spmm_gather_dual_bk", values_g.shape[0], o)
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    p = dual_plan(b, ke, o, n)
    # the wgmma plan's gather pass writes both compact X's here
    xg = (torch.empty((b, 2 * values_g.shape[0]), dtype=x.dtype, device=x.device)
          if p["body"] == "wgmma" else None)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm_gather_dual_bk(x.data_ptr(), values_g.data_ptr(), idx_g.data_ptr(),
                                           values_u.data_ptr(), idx_u.data_ptr(),
                                           y.data_ptr(), b, ke, o, n, p["rows"],
                                           BODY_CODES[p["body"]], p["cols"], p["split"],
                                           _ptr(xg), _build.stream_of(x))
    nm_spmm_gather_dual_bk.launches += 1
    _build.check(rc, "nm_spmm_gather_dual_bk", lib)
    return y


nm_spmm_gather_dual_bk.launches = 0


def _check_storage(kernel: str, storage: torch.dtype, *tensors: torch.Tensor) -> None:
    if any(t.dtype != storage for t in tensors):
        raise ValueError(f"{kernel}: activations and values must be "
                         f"{dtype_name(storage)}, got {[str(t.dtype) for t in tensors]}")


def _gather_quantized(wrapper, storage, x_q, values, idx, x_scale, w_scale, n, epilogue,
                      bias, out_dtype, block_b, maps=None, requant_scale=None):
    """The shared body of the int8 and fp8 gather single GEMMs, masked when
    ``maps = (kmap, kmask)`` is given, requantizing against
    ``requant_scale`` when given: checks, the plain version on CPU
    tensors, else one launch counted on ``wrapper``."""
    kernel = wrapper.__name__
    source = _build.QUANT_CLASSES[storage][0]
    epi = requant_spec(kernel, epilogue, storage, requant_scale)
    b, ke = x_q.shape
    o = _check_gather(kernel, ke, values, idx, n)
    raw = check_scales(kernel, b, o, x_scale, w_scale)
    if raw and not epi.is_identity:
        raise ValueError(f"{kernel}: the raw accumulator takes no epilogue")
    check_single_epilogue(kernel, epi, bias, o, requant_scale)
    _check_storage(kernel, storage, x_q, values)
    bb = block_b or _build.block_rows(b)
    if maps is not None:
        check_maps(kernel, *maps, b, values.shape[0], bb, 256 // n)
    if x_q.device.type == "cpu":
        if maps is not None:
            return nm_spmm_gather_masked_quantized_ref(x_q, values, idx, *maps, n, x_scale,
                                                       w_scale, block_b=bb, epilogue=epi,
                                                       bias=bias, out_dtype=out_dtype,
                                                       requant_scale=requant_scale)
        return nm_spmm_gather_quantized_ref(x_q, values, idx, x_scale, w_scale, n,
                                            epilogue=epi, bias=bias, out_dtype=out_dtype,
                                            requant_scale=requant_scale)
    kind, y_dtype = quantized_out(kernel, epi, storage, out_dtype, raw)
    bias32 = None if bias is None else bias.float().contiguous()
    kmask = () if maps is None else (maps[1],)
    extra = [t for t in (*kmask, x_scale, w_scale, bias32, requant_scale) if t is not None]
    _build.check_operands(kernel, x_q, values, idx, *extra, block_b=bb, x_dtype=storage)
    _build.check_tiles(kernel, values.shape[0], o)
    y = torch.empty((b, o), dtype=y_dtype, device=x_q.device)
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_{kernel.removesuffix('_requant')}")(
            x_q.data_ptr(), values.data_ptr(), idx.data_ptr(), *(t.data_ptr() for t in kmask),
            _ptr(x_scale), _ptr(w_scale), _ptr(bias32), _ptr(requant_scale), y.data_ptr(), b,
            ke, o, n, ACT_CODES[epi.act], kind, bb, _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


def nm_spmm_gather_bk_int8(x_q: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                           x_scale: Optional[torch.Tensor], w_scale: Optional[torch.Tensor],
                           n: int, *, epilogue: Optional[EpilogueSpec] = None,
                           bias: Optional[torch.Tensor] = None,
                           out_dtype: torch.dtype = torch.float32,
                           block_b: Optional[int] = None) -> torch.Tensor:
    """``epilogue(float(gather(Xq, idx) @ values) * w_scale * x_scale)``:
    the int8 codes of the kept columns gathered on chip, contracted into
    an exact int32 accumulator, dequantized once at the flush.  With no
    scales it returns the raw int32 accumulator."""
    return _gather_quantized(nm_spmm_gather_bk_int8, torch.int8, x_q, values, idx, x_scale,
                             w_scale, n, epilogue, bias, out_dtype, block_b)


nm_spmm_gather_bk_int8.launches = 0


def nm_spmm_gather_bk_fp8(x_q: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                          x_scale: Optional[torch.Tensor], w_scale: Optional[torch.Tensor],
                          n: int, *, epilogue: Optional[EpilogueSpec] = None,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.float32,
                          block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_bk_int8`'s contract over float8_e4m3fn
    activations and values: an fp32 accumulator, dequantized once at the
    flush; with no scales the raw fp32 accumulator."""
    return _gather_quantized(nm_spmm_gather_bk_fp8, torch.float8_e4m3fn, x_q, values, idx,
                             x_scale, w_scale, n, epilogue, bias, out_dtype, block_b)


nm_spmm_gather_bk_fp8.launches = 0


def nm_spmm_gather_bk_int8_requant(x_q: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                                   x_scale: torch.Tensor, w_scale: torch.Tensor, n: int,
                                   requant_scale: torch.Tensor, *,
                                   epilogue: Optional[EpilogueSpec] = None,
                                   bias: Optional[torch.Tensor] = None,
                                   block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_bk_int8` whose flush then requantizes (the
    single-GEMM ``requant:int8`` point): int8 codes of ``act(acc * w_scale *
    x_scale + bias) / requant_scale``, rounded half to even and clipped to
    +-127, against the consuming linear's static scale."""
    return _gather_quantized(nm_spmm_gather_bk_int8_requant, torch.int8, x_q, values, idx,
                             x_scale, w_scale, n, epilogue, bias, torch.int8, block_b,
                             requant_scale=requant_scale)


nm_spmm_gather_bk_int8_requant.launches = 0


def nm_spmm_gather_bk_fp8_requant(x_q: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                                  x_scale: torch.Tensor, w_scale: torch.Tensor, n: int,
                                  requant_scale: torch.Tensor, *,
                                  epilogue: Optional[EpilogueSpec] = None,
                                  bias: Optional[torch.Tensor] = None,
                                  block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_bk_fp8` whose flush then requantizes: e4m3
    codes clipped to +-448 (round to nearest even)."""
    return _gather_quantized(nm_spmm_gather_bk_fp8_requant, torch.float8_e4m3fn, x_q, values,
                             idx, x_scale, w_scale, n, epilogue, bias, torch.float8_e4m3fn,
                             block_b, requant_scale=requant_scale)


nm_spmm_gather_bk_fp8_requant.launches = 0


def nm_spmm_gather_bk_masked_int8(x_q: torch.Tensor, values: torch.Tensor,
                                  idx: torch.Tensor, kmap: torch.Tensor, kmask: torch.Tensor,
                                  n: int, x_scale: Optional[torch.Tensor] = None,
                                  w_scale: Optional[torch.Tensor] = None, *,
                                  epilogue: Optional[EpilogueSpec] = None,
                                  bias: Optional[torch.Tensor] = None,
                                  out_dtype: torch.dtype = torch.float32,
                                  block_b: Optional[int] = None,
                                  requant_scale: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """:func:`nm_spmm_gather_bk_int8` with the block skip of
    :func:`nm_spmm_gather_bk_masked` (maps over the int8 rows; the CUDA
    body ignores ``kmap``).  Bitwise :func:`nm_spmm_gather_bk_int8` on the
    same rows; with ``requant_scale`` the flush requantizes as
    :func:`nm_spmm_gather_bk_int8_requant`'s."""
    return _gather_quantized(nm_spmm_gather_bk_masked_int8, torch.int8, x_q, values, idx,
                             x_scale, w_scale, n, epilogue, bias, out_dtype, block_b,
                             maps=(kmap, kmask), requant_scale=requant_scale)


nm_spmm_gather_bk_masked_int8.launches = 0


def nm_spmm_gather_bk_masked_fp8(x_q: torch.Tensor, values: torch.Tensor,
                                 idx: torch.Tensor, kmap: torch.Tensor, kmask: torch.Tensor,
                                 n: int, x_scale: Optional[torch.Tensor] = None,
                                 w_scale: Optional[torch.Tensor] = None, *,
                                 epilogue: Optional[EpilogueSpec] = None,
                                 bias: Optional[torch.Tensor] = None,
                                 out_dtype: torch.dtype = torch.float32,
                                 block_b: Optional[int] = None,
                                 requant_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """:func:`nm_spmm_gather_bk_fp8` with the block skip of
    :func:`nm_spmm_gather_bk_masked` (maps over the e4m3 rows; the CUDA
    body ignores ``kmap``).  Bitwise :func:`nm_spmm_gather_bk_fp8` on the
    same rows; with ``requant_scale`` the flush requantizes as
    :func:`nm_spmm_gather_bk_fp8_requant`'s."""
    return _gather_quantized(nm_spmm_gather_bk_masked_fp8, torch.float8_e4m3fn, x_q, values,
                             idx, x_scale, w_scale, n, epilogue, bias, out_dtype, block_b,
                             maps=(kmap, kmask), requant_scale=requant_scale)


nm_spmm_gather_bk_masked_fp8.launches = 0


def _gather_dual_quantized(wrapper, storage, x_q, values_g, idx_g, values_u, idx_u, n,
                           x_scale, wg_scale, wu_scale, out_dtype, block_b, requant_scale):
    """The shared body of the quantized gather duals (int8 and fp8, each
    with and without the requantizing flush): checks, the plain version on
    CPU tensors, else one launch counted on ``wrapper`` (output of the
    class's narrow dtype when ``requant_scale`` is given)."""
    kernel = wrapper.__name__
    source, suffix, _ = _build.QUANT_CLASSES[storage]
    b, ke = x_q.shape
    o = _check_gather(kernel, ke, values_g, idx_g, n)
    _check_pair(kernel, values_g, idx_g, values_u, idx_u)
    if check_scales(kernel, b, o, x_scale, wg_scale, wu_scale):
        raise ValueError(f"{kernel}: the dual kernel needs its three scales")
    _check_storage(kernel, storage, x_q, values_g, values_u)
    if requant_scale is not None:
        check_requant_scale(kernel, requant_scale)
    if x_q.device.type == "cpu":
        return nm_spmm_gather_dual_quantized_ref(
            x_q, values_g, idx_g, values_u, idx_u, n, x_scale, wg_scale, wu_scale,
            out_dtype=out_dtype, requant_scale=requant_scale)
    bb = block_b or _build.block_rows(b)
    if requant_scale is None:
        kind, rq = _build.out_kind(kernel, out_dtype, False), ()
    else:
        kind, rq, out_dtype = _build.OUT_REQUANT, (requant_scale,), storage
    _build.check_operands(kernel, x_q, values_g, idx_g, values_u, idx_u, x_scale, wg_scale,
                          wu_scale, *rq, block_b=bb, x_dtype=storage)
    _build.check_tiles(kernel, values_g.shape[0], o)
    y = torch.empty((b, o), dtype=out_dtype, device=x_q.device)
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_nm_spmm_gather_dual_bk_{suffix}")(
            x_q.data_ptr(), values_g.data_ptr(), idx_g.data_ptr(), values_u.data_ptr(),
            idx_u.data_ptr(), x_scale.data_ptr(), wg_scale.data_ptr(), wu_scale.data_ptr(),
            _ptr(requant_scale), y.data_ptr(), b, ke, o, n, kind, bb, _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


def nm_spmm_gather_dual_bk_int8(x_q: torch.Tensor, values_g: torch.Tensor,
                                idx_g: torch.Tensor, values_u: torch.Tensor,
                                idx_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                                wg_scale: torch.Tensor, wu_scale: torch.Tensor, *,
                                out_dtype: torch.dtype = torch.float32,
                                block_b: Optional[int] = None) -> torch.Tensor:
    """Fused int8 gate-up over two gather weights sharing one X read:
    ``silu(deq(gather(Xq, idx_g) @ g)) * deq(gather(Xq, idx_u) @ u)``."""
    return _gather_dual_quantized(nm_spmm_gather_dual_bk_int8, torch.int8, x_q, values_g,
                                  idx_g, values_u, idx_u, n, x_scale, wg_scale, wu_scale,
                                  out_dtype, block_b, None)


nm_spmm_gather_dual_bk_int8.launches = 0


def nm_spmm_gather_dual_bk_int8_requant(x_q: torch.Tensor, values_g: torch.Tensor,
                                        idx_g: torch.Tensor, values_u: torch.Tensor,
                                        idx_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                                        wg_scale: torch.Tensor, wu_scale: torch.Tensor,
                                        requant_scale: torch.Tensor, *,
                                        block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_dual_bk_int8` whose flush then requantizes to
    int8 against the consuming linear's static scale (a one-element
    float32 tensor on the device)."""
    return _gather_dual_quantized(nm_spmm_gather_dual_bk_int8_requant, torch.int8, x_q,
                                  values_g, idx_g, values_u, idx_u, n, x_scale, wg_scale,
                                  wu_scale, torch.int8, block_b, requant_scale)


nm_spmm_gather_dual_bk_int8_requant.launches = 0


def nm_spmm_gather_dual_bk_fp8(x_q: torch.Tensor, values_g: torch.Tensor,
                               idx_g: torch.Tensor, values_u: torch.Tensor,
                               idx_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                               wg_scale: torch.Tensor, wu_scale: torch.Tensor, *,
                               out_dtype: torch.dtype = torch.float32,
                               block_b: Optional[int] = None) -> torch.Tensor:
    """Fused fp8 gate-up over two float8_e4m3fn gather weights sharing one
    X read, two fp32 accumulators."""
    return _gather_dual_quantized(nm_spmm_gather_dual_bk_fp8, torch.float8_e4m3fn, x_q,
                                  values_g, idx_g, values_u, idx_u, n, x_scale, wg_scale,
                                  wu_scale, out_dtype, block_b, None)


nm_spmm_gather_dual_bk_fp8.launches = 0


def nm_spmm_gather_dual_bk_fp8_requant(x_q: torch.Tensor, values_g: torch.Tensor,
                                       idx_g: torch.Tensor, values_u: torch.Tensor,
                                       idx_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                                       wg_scale: torch.Tensor, wu_scale: torch.Tensor,
                                       requant_scale: torch.Tensor, *,
                                       block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_dual_bk_fp8` whose flush then requantizes to
    e4m3 (clip to +-448, round to nearest even) against the consuming
    linear's static scale."""
    return _gather_dual_quantized(nm_spmm_gather_dual_bk_fp8_requant, torch.float8_e4m3fn,
                                  x_q, values_g, idx_g, values_u, idx_u, n, x_scale, wg_scale,
                                  wu_scale, torch.float8_e4m3fn, block_b, requant_scale)


nm_spmm_gather_dual_bk_fp8_requant.launches = 0


# --- K11: the K-major layout.  x_t (K_eff, B) with the batch contiguous, Y_t
# (O, B); B a multiple of 16 (16-byte loads of the batch).  The sharded
# row-parallel path hands the kernel xq.t() and takes y_t.t() back, as the
# JAX package's _partial_nm_gather_q does.

KMAJOR_B = 16


def _check_kmajor(kernel: str, x_t: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                  n: int) -> tuple:
    """``(idx as (K_c,), O)``: ``idx`` may come as the JAX kernels' (K_c, 1)."""
    ke, b = x_t.shape
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx.reshape(-1)
    o = _check_gather(kernel, ke, values, idx, n)
    if b % KMAJOR_B:
        raise ValueError(f"{kernel}: B={b} must be a multiple of {KMAJOR_B} (pad the batch)")
    return idx, o


def nm_spmm_gather(x_t: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, n: int, *,
                   out_dtype: torch.dtype = torch.float32,
                   block_b: Optional[int] = None) -> torch.Tensor:
    """``Y_t (O, B) = gather(x_t, idx)^T-contract values``, fp32 sums stored
    as ``out_dtype`` (fp32 or x_t's bf16), M = 4.  ``idx``: (K_c,) or (K_c,
    1) int32 in-block indices."""
    idx, o = _check_kmajor("nm_spmm_gather", x_t, values, idx, n)
    ke, b = x_t.shape
    if x_t.device.type == "cpu":
        return nm_spmm_gather_t_ref(x_t, values, idx, n, out_dtype=out_dtype)
    if out_dtype not in (x_t.dtype, torch.float32):
        raise ValueError(f"nm_spmm_gather: the kernel stores {x_t.dtype} or float32")
    bb = block_b or _build.block_rows(b)
    _build.check_operands("nm_spmm_gather", x_t, values, idx, block_b=bb)
    if values.dtype != x_t.dtype:
        raise ValueError("nm_spmm_gather: values must share x_t's dtype")
    _build.check_tiles("nm_spmm_gather", values.shape[0], o)
    y_t = torch.empty((o, b), dtype=out_dtype, device=x_t.device)
    lib = _build.library()
    with torch.cuda.device(x_t.device):
        rc = lib.vg_nm_spmm_gather(x_t.data_ptr(), values.data_ptr(), idx.data_ptr(),
                                   y_t.data_ptr(), b, ke, o, n,
                                   int(out_dtype == torch.float32), bb, _build.stream_of(x_t))
    nm_spmm_gather.launches += 1
    _build.check(rc, "nm_spmm_gather", lib)
    return y_t


nm_spmm_gather.launches = 0


def _gather_t_quantized(wrapper, storage, x_t, values, idx, x_scale, w_scale, n, out_dtype,
                        block_b):
    """The shared body of the int8 and fp8 K-major gathers: checks, the plain
    version on CPU tensors, else one launch counted on ``wrapper``.  Scales
    ``x_scale (1, B)`` and ``w_scale (O, 1)``, or neither (the raw
    accumulator)."""
    kernel = wrapper.__name__
    source = _build.QUANT_CLASSES[storage][0]
    idx, o = _check_kmajor(kernel, x_t, values, idx, n)
    ke, b = x_t.shape
    if (x_scale is None) != (w_scale is None):
        raise ValueError(f"{kernel}: pass both scales or neither")
    raw = x_scale is None
    if not raw and (tuple(x_scale.shape) != (1, b) or tuple(w_scale.shape) != (o, 1)
                    or x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32):
        raise ValueError(f"{kernel}: scales must be float32 x (1, {b}) and w ({o}, 1), got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)} and {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    _check_storage(kernel, storage, x_t, values)
    if x_t.device.type == "cpu":
        return nm_spmm_gather_t_quantized_ref(x_t, values, idx, x_scale, w_scale, n,
                                              out_dtype=out_dtype)
    kind = _build.out_kind(kernel, out_dtype, raw)
    y_dtype = _build.QUANT_CLASSES[storage][2] if raw else out_dtype
    bb = block_b or _build.block_rows(b)
    extra = () if raw else (x_scale, w_scale)
    _build.check_operands(kernel, x_t, values, idx, *extra, block_b=bb, x_dtype=storage)
    _build.check_tiles(kernel, values.shape[0], o)
    y_t = torch.empty((o, b), dtype=y_dtype, device=x_t.device)
    lib = _build.library(source)
    with torch.cuda.device(x_t.device):
        rc = getattr(lib, f"vg_{kernel}")(
            x_t.data_ptr(), values.data_ptr(), idx.data_ptr(), _ptr(x_scale), _ptr(w_scale),
            y_t.data_ptr(), b, ke, o, n, kind, bb, _build.stream_of(x_t))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y_t


def nm_spmm_gather_int8(x_t: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                        x_scale: Optional[torch.Tensor], w_scale: Optional[torch.Tensor],
                        n: int, *, out_dtype: torch.dtype = torch.float32,
                        block_b: Optional[int] = None) -> torch.Tensor:
    """``Y_t (O, B) = float(gather(x_t, idx)^T-contract values) * w_scale (O,
    1) * x_scale (1, B)``: int8 codes into an exact int32 accumulator,
    dequantized once at the flush; with no scales the raw int32 (O, B)
    accumulator."""
    return _gather_t_quantized(nm_spmm_gather_int8, torch.int8, x_t, values, idx, x_scale,
                               w_scale, n, out_dtype, block_b)


nm_spmm_gather_int8.launches = 0


def nm_spmm_gather_fp8(x_t: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                       x_scale: Optional[torch.Tensor], w_scale: Optional[torch.Tensor],
                       n: int, *, out_dtype: torch.dtype = torch.float32,
                       block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_int8`'s contract over float8_e4m3fn codes: an
    fp32 accumulator, the raw fp32 (O, B) one with no scales."""
    return _gather_t_quantized(nm_spmm_gather_fp8, torch.float8_e4m3fn, x_t, values, idx,
                               x_scale, w_scale, n, out_dtype, block_b)


nm_spmm_gather_fp8.launches = 0
