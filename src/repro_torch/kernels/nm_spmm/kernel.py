"""N:4 structured-sparse GEMM on Hopper: ``nm_spmm`` and the fused gate-up
``nm_spmm_dual`` (CUDA source: ``kernels/csrc/gemm.cu``); their int8
twins ``nm_spmm_int8`` and ``nm_spmm_dual_int8``
(``kernels/csrc/gemm_int8.cu``) and fp8 (e4m3) twins ``nm_spmm_fp8`` and
``nm_spmm_dual_fp8`` (``kernels/csrc/gemm_fp8.cu``); and
``nm_spmm_dual_int8_requant`` / ``nm_spmm_dual_fp8_requant``, the
quantized duals whose flush requantizes to the class's narrow dtype
against the next linear's static activation scale, and the single GEMMs
with that flush, ``nm_spmm_int8_requant`` / ``nm_spmm_fp8_requant``.  K10:
``nm_spmm_masked`` and its int8 and fp8 twins ``nm_spmm_masked_int8`` /
``nm_spmm_masked_fp8``, with the activation-sparsity block skip.

``Y (B, O) = X (B, K_eff) @ dec(values (K_c, O), meta_packed (K_c/4, O))``
with ``K_eff = K_c * 4 / n``.  The dense weight never exists in device
memory, so weight traffic is n/4 of dense plus 2 bits per kept value.
``nm_spmm`` at n in {1, 2} feeds the compressed tile to the sparse tensor
cores (``csrc/nm_spmm_sp.cuh``; 1:4 as 2:4 with a +0), its K loop split
across the blocks of a cluster by :func:`split_k`; every other kernel here
expands each values tile into the dense tile in shared memory.

Replaces ``repro/kernels/nm_spmm/kernel.py::nm_spmm`` (:125),
``::nm_spmm_dual`` (:437, float, int8 and fp8 branches), ``::nm_spmm_int8``
(:506) and ``::nm_spmm_fp8`` (:543, ``_nm_spmm_quantized`` :187), and
``::nm_spmm_masked`` (:305, float and scaled-quantized), the quantized
ones each with the ``requant:<dtype>`` flush of
``repro/kernels/epilogue.py::flush_tile``.  CUDA tensors launch the kernel or raise; CPU
tensors take the plain version from ``ref.py``.  Launch counts live in
``.launches`` on each wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..epilogue import EpilogueSpec
from ..tile_gemm.kernel import (ACT_CODES, _ptr, check_maps, check_requant_scale, float_out,
                                check_scales, check_single_epilogue, quantized_out,
                                requant_spec)
from ..reasons import dtype_name
from .ref import (nm_spmm_dual_quantized_ref, nm_spmm_dual_ref,
                  nm_spmm_masked_quantized_ref, nm_spmm_masked_ref, nm_spmm_quantized_ref,
                  nm_spmm_ref)

__all__ = ["nm_spmm", "split_k", "nm_spmm_dual", "nm_spmm_int8", "nm_spmm_int8_requant",
           "nm_spmm_dual_int8", "nm_spmm_dual_int8_requant", "nm_spmm_fp8",
           "nm_spmm_fp8_requant", "nm_spmm_dual_fp8", "nm_spmm_dual_fp8_requant",
           "nm_spmm_masked", "nm_spmm_masked_int8", "nm_spmm_masked_fp8"]

_N = (1, 2, 4)
#: streaming multiprocessors of the H100 the split is planned for
SMS = 132
#: blocks of the sparse body that share an SM (its ring and inbox take
#: ~34 KB of shared memory at decode, 64 registers a thread)
BLOCKS_PER_SM = 2
#: the sparse body's largest cluster (a portable cluster size)
MAX_SPLIT = 8


def split_k(b: int, k: int, o: int, n: int) -> int:
    """Blocks of one cluster that share the K loop of an output tile in
    ``nm_spmm``'s sparse body (n in {1, 2}; n = 4 runs the shared body,
    split 1): the largest power of two up to ``MAX_SPLIT`` and K / 64
    steps with (O / 64 tiles) x (row tiles) x split <= ``BLOCKS_PER_SM``
    x ``SMS``, so a decode launch fills the card (internlm2-1.8b at B = 8:
    q, o and w_out 32 x 8, k and v 16 x 8); 1 once the row tiles fill it
    (4,000 prefill rows).  Block r takes K steps [r * steps // split,
    (r + 1) * steps // split)."""
    if n not in (1, 2):
        return 1
    tiles = (o // _build.BLOCK_O) * -(-b // _build.block_rows(b))
    steps = k // _build.BLOCK_K
    split = 1
    while 2 * split <= min(MAX_SPLIT, steps) and 2 * split * tiles <= BLOCKS_PER_SM * SMS:
        split *= 2
    return split


def _check_compressed(kernel: str, ke: int, values: torch.Tensor,
                      meta_packed: torch.Tensor, n: int) -> int:
    if n not in _N:
        raise ValueError(f"{kernel}: n must be one of {_N} (M=4), got {n}")
    kc, o = values.shape
    if ke * n != kc * 4:
        raise ValueError(f"{kernel}: K_eff={ke} with n={n} needs K_c={ke * n // 4}, "
                         f"values are {tuple(values.shape)}")
    if tuple(meta_packed.shape) != (kc // 4, o) or meta_packed.dtype != torch.uint8:
        raise ValueError(f"{kernel}: meta_packed must be uint8 ({kc // 4}, {o}), got "
                         f"{meta_packed.dtype} {tuple(meta_packed.shape)}")
    return o


def _check_cuda(kernel: str, x, values_list, metas, bb, ke, o, extra=()):
    _build.check_operands(kernel, x, *values_list, *metas, *extra, block_b=bb)
    if any(v.dtype != x.dtype for v in values_list):
        raise ValueError(f"{kernel}: values must share x's dtype")
    _build.check_tiles(kernel, ke, o)


def nm_spmm(x: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
            n: int, *, epilogue: Optional[EpilogueSpec] = None,
            bias: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None,
            block_b: Optional[int] = None) -> torch.Tensor:
    """``epilogue(X @ dec(values, meta_packed))`` in X's dtype (or
    ``out_dtype=torch.float32``), M = 4."""
    epi = epilogue or EpilogueSpec()
    b, ke = x.shape
    o = _check_compressed("nm_spmm", ke, values, meta_packed, n)
    check_single_epilogue("nm_spmm", epi, bias, o)
    out_dtype, out_f32 = float_out("nm_spmm", x, out_dtype)
    if x.device.type == "cpu":
        return nm_spmm_ref(x, values, meta_packed, n, epilogue=epi, bias=bias,
                           out_dtype=out_dtype)
    bb = block_b or _build.block_rows(b)
    bias32 = None if bias is None else bias.float().contiguous()
    _check_cuda("nm_spmm", x, (values,), (meta_packed,), bb, ke, o,
                () if bias32 is None else (bias32,))
    y = torch.empty((b, o), dtype=out_dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm(x.data_ptr(), values.data_ptr(), meta_packed.data_ptr(),
                            None if bias32 is None else bias32.data_ptr(),
                            y.data_ptr(), b, ke, o, n, ACT_CODES[epi.act], out_f32, bb,
                            split_k(b, ke, o, n), _build.stream_of(x))
    nm_spmm.launches += 1
    _build.check(rc, "nm_spmm", lib)
    return y


nm_spmm.launches = 0


def nm_spmm_masked(x: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                   kmap: torch.Tensor, kmask: torch.Tensor, n: int, *,
                   epilogue: Optional[EpilogueSpec] = None,
                   bias: Optional[torch.Tensor] = None,
                   block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm` with the activation-sparsity block skip (the
    sparse-activation x N:M-weight SpGEMM): only the (row block, 64-column
    K step) tiles ``kmask`` marks live are loaded, expanded and
    multiplied.  ``kmap`` / ``kmask``: ``actsparse.block_maps`` over the
    masked X at ``block_b`` rows and 64 columns; the CUDA body ignores
    ``kmap``.  Bitwise :func:`nm_spmm` on the same masked X."""
    epi = epilogue or EpilogueSpec()
    b, ke = x.shape
    o = _check_compressed("nm_spmm_masked", ke, values, meta_packed, n)
    check_single_epilogue("nm_spmm_masked", epi, bias, o)
    bb = block_b or _build.block_rows(b)
    check_maps("nm_spmm_masked", kmap, kmask, b, ke, bb)
    if x.device.type == "cpu":
        return nm_spmm_masked_ref(x, values, meta_packed, kmap, kmask, n, block_b=bb,
                                  epilogue=epi, bias=bias)
    bias32 = None if bias is None else bias.float().contiguous()
    _check_cuda("nm_spmm_masked", x, (values,), (meta_packed,), bb, ke, o,
                (kmask,) + (() if bias32 is None else (bias32,)))
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm_masked(x.data_ptr(), values.data_ptr(), meta_packed.data_ptr(),
                                   kmask.data_ptr(), _ptr(bias32), y.data_ptr(), b, ke, o, n,
                                   ACT_CODES[epi.act], bb, _build.stream_of(x))
    nm_spmm_masked.launches += 1
    _build.check(rc, "nm_spmm_masked", lib)
    return y


nm_spmm_masked.launches = 0


def _check_storage(kernel: str, storage: torch.dtype, *tensors: torch.Tensor) -> None:
    if any(t.dtype != storage for t in tensors):
        raise ValueError(f"{kernel}: activations and values must be "
                         f"{dtype_name(storage)}, got {[str(t.dtype) for t in tensors]}")


def _nm_spmm_quantized(wrapper, storage, x_q, values, meta_packed, x_scale, w_scale, n,
                       epilogue, bias, out_dtype, block_b, maps=None, requant_scale=None):
    """The shared body of the int8 and fp8 N:M single GEMMs, masked when
    ``maps = (kmap, kmask)`` is given, requantizing against
    ``requant_scale`` when given: checks, the plain version on CPU
    tensors, else one launch counted on ``wrapper``."""
    kernel = wrapper.__name__
    source = _build.QUANT_CLASSES[storage][0]
    epi = requant_spec(kernel, epilogue, storage, requant_scale)
    b, ke = x_q.shape
    o = _check_compressed(kernel, ke, values, meta_packed, n)
    raw = check_scales(kernel, b, o, x_scale, w_scale)
    if raw and not epi.is_identity:
        raise ValueError(f"{kernel}: the raw accumulator takes no epilogue")
    check_single_epilogue(kernel, epi, bias, o, requant_scale)
    _check_storage(kernel, storage, x_q, values)
    bb = block_b or _build.block_rows(b)
    if maps is not None:
        check_maps(kernel, *maps, b, ke, bb)
    if x_q.device.type == "cpu":
        if maps is not None:
            return nm_spmm_masked_quantized_ref(x_q, values, meta_packed, *maps, n, x_scale,
                                                w_scale, block_b=bb, epilogue=epi, bias=bias,
                                                out_dtype=out_dtype,
                                                requant_scale=requant_scale)
        return nm_spmm_quantized_ref(x_q, values, meta_packed, x_scale, w_scale, n,
                                     epilogue=epi, bias=bias, out_dtype=out_dtype,
                                     requant_scale=requant_scale)
    kind, y_dtype = quantized_out(kernel, epi, storage, out_dtype, raw)
    bias32 = None if bias is None else bias.float().contiguous()
    kmask = () if maps is None else (maps[1],)
    extra = [t for t in (*kmask, x_scale, w_scale, bias32, requant_scale) if t is not None]
    _build.check_operands(kernel, x_q, values, meta_packed, *extra, block_b=bb,
                          x_dtype=storage)
    _build.check_tiles(kernel, ke, o)
    y = torch.empty((b, o), dtype=y_dtype, device=x_q.device)
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_{kernel.removesuffix('_requant')}")(
            x_q.data_ptr(), values.data_ptr(), meta_packed.data_ptr(),
            *(t.data_ptr() for t in kmask), _ptr(x_scale), _ptr(w_scale), _ptr(bias32),
            _ptr(requant_scale), y.data_ptr(), b, ke, o, n, ACT_CODES[epi.act], kind, bb,
            _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


def nm_spmm_int8(x_q: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                 x_scale: Optional[torch.Tensor], w_scale: Optional[torch.Tensor],
                 n: int, *, epilogue: Optional[EpilogueSpec] = None,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.float32,
                 block_b: Optional[int] = None) -> torch.Tensor:
    """``epilogue(float(Xq @ dec(values, meta)) * x_scale * w_scale)``: int8
    values expanded on chip, contracted into an exact int32 accumulator,
    dequantized once at the flush.  With no scales it returns the raw
    int32 accumulator."""
    return _nm_spmm_quantized(nm_spmm_int8, torch.int8, x_q, values, meta_packed, x_scale,
                              w_scale, n, epilogue, bias, out_dtype, block_b)


nm_spmm_int8.launches = 0


def nm_spmm_fp8(x_q: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                x_scale: Optional[torch.Tensor], w_scale: Optional[torch.Tensor],
                n: int, *, epilogue: Optional[EpilogueSpec] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32,
                block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_int8`'s contract over float8_e4m3fn activations and
    values: an fp32 accumulator, dequantized once at the flush; with no
    scales the raw fp32 accumulator."""
    return _nm_spmm_quantized(nm_spmm_fp8, torch.float8_e4m3fn, x_q, values, meta_packed,
                              x_scale, w_scale, n, epilogue, bias, out_dtype, block_b)


nm_spmm_fp8.launches = 0


def nm_spmm_int8_requant(x_q: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                         x_scale: torch.Tensor, w_scale: torch.Tensor, n: int,
                         requant_scale: torch.Tensor, *,
                         epilogue: Optional[EpilogueSpec] = None,
                         bias: Optional[torch.Tensor] = None,
                         block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_int8` whose flush then requantizes (the single-GEMM
    ``requant:int8`` point): int8 codes of ``act(deq(acc) + bias) /
    requant_scale``, rounded half to even and clipped to +-127, against the
    consuming linear's static scale."""
    return _nm_spmm_quantized(nm_spmm_int8_requant, torch.int8, x_q, values, meta_packed,
                              x_scale, w_scale, n, epilogue, bias, torch.int8, block_b,
                              requant_scale=requant_scale)


nm_spmm_int8_requant.launches = 0


def nm_spmm_fp8_requant(x_q: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                        x_scale: torch.Tensor, w_scale: torch.Tensor, n: int,
                        requant_scale: torch.Tensor, *,
                        epilogue: Optional[EpilogueSpec] = None,
                        bias: Optional[torch.Tensor] = None,
                        block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_fp8` whose flush then requantizes: e4m3 codes of
    ``act(deq(acc) + bias) / requant_scale`` clipped to +-448 (round to
    nearest even)."""
    return _nm_spmm_quantized(nm_spmm_fp8_requant, torch.float8_e4m3fn, x_q, values,
                              meta_packed, x_scale, w_scale, n, epilogue, bias,
                              torch.float8_e4m3fn, block_b, requant_scale=requant_scale)


nm_spmm_fp8_requant.launches = 0


def nm_spmm_masked_int8(x_q: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                        kmap: torch.Tensor, kmask: torch.Tensor, n: int,
                        x_scale: Optional[torch.Tensor] = None,
                        w_scale: Optional[torch.Tensor] = None, *,
                        epilogue: Optional[EpilogueSpec] = None,
                        bias: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.float32,
                        block_b: Optional[int] = None,
                        requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`nm_spmm_int8` with the block skip of :func:`nm_spmm_masked`
    (maps over the int8 rows; the CUDA body ignores ``kmap``).  Bitwise
    :func:`nm_spmm_int8` on the same rows; with ``requant_scale`` the flush requantizes as
    :func:`nm_spmm_int8_requant`'s."""
    return _nm_spmm_quantized(nm_spmm_masked_int8, torch.int8, x_q, values, meta_packed,
                              x_scale, w_scale, n, epilogue, bias, out_dtype, block_b,
                              maps=(kmap, kmask),
                              requant_scale=requant_scale)


nm_spmm_masked_int8.launches = 0


def nm_spmm_masked_fp8(x_q: torch.Tensor, values: torch.Tensor, meta_packed: torch.Tensor,
                       kmap: torch.Tensor, kmask: torch.Tensor, n: int,
                       x_scale: Optional[torch.Tensor] = None,
                       w_scale: Optional[torch.Tensor] = None, *,
                       epilogue: Optional[EpilogueSpec] = None,
                       bias: Optional[torch.Tensor] = None,
                       out_dtype: torch.dtype = torch.float32,
                       block_b: Optional[int] = None,
                       requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`nm_spmm_fp8` with the block skip of :func:`nm_spmm_masked`
    (maps over the e4m3 rows; the CUDA body ignores ``kmap``).  Bitwise
    :func:`nm_spmm_fp8` on the same rows; with ``requant_scale`` the flush requantizes as
    :func:`nm_spmm_fp8_requant`'s."""
    return _nm_spmm_quantized(nm_spmm_masked_fp8, torch.float8_e4m3fn, x_q, values,
                              meta_packed, x_scale, w_scale, n, epilogue, bias, out_dtype,
                              block_b, maps=(kmap, kmask),
                              requant_scale=requant_scale)


nm_spmm_masked_fp8.launches = 0


def _nm_spmm_dual_quantized(wrapper, storage, x_q, values_g, meta_g, values_u, meta_u, n,
                            x_scale, wg_scale, wu_scale, out_dtype, block_b, requant_scale):
    """The shared body of the quantized N:M duals (int8 and fp8, each with
    and without the requantizing flush): checks, the plain version on CPU
    tensors, else one launch counted on ``wrapper`` (output of the class's
    narrow dtype when ``requant_scale`` is given)."""
    kernel = wrapper.__name__
    source, suffix, _ = _build.QUANT_CLASSES[storage]
    b, ke = x_q.shape
    o = _check_compressed(kernel, ke, values_g, meta_g, n)
    if values_u.shape != values_g.shape or meta_u.shape != meta_g.shape:
        raise ValueError(f"{kernel}: gate and up layouts must match")
    if check_scales(kernel, b, o, x_scale, wg_scale, wu_scale):
        raise ValueError(f"{kernel}: the dual kernel needs its three scales")
    _check_storage(kernel, storage, x_q, values_g, values_u)
    if requant_scale is not None:
        check_requant_scale(kernel, requant_scale)
    if x_q.device.type == "cpu":
        return nm_spmm_dual_quantized_ref(x_q, values_g, meta_g, values_u, meta_u, n,
                                          x_scale, wg_scale, wu_scale, out_dtype=out_dtype,
                                          requant_scale=requant_scale)
    bb = block_b or _build.block_rows(b)
    if requant_scale is None:
        kind, rq = _build.out_kind(kernel, out_dtype, False), ()
    else:
        kind, rq, out_dtype = _build.OUT_REQUANT, (requant_scale,), storage
    _build.check_operands(kernel, x_q, values_g, meta_g, values_u, meta_u, x_scale,
                          wg_scale, wu_scale, *rq, block_b=bb, x_dtype=storage)
    _build.check_tiles(kernel, ke, o)
    y = torch.empty((b, o), dtype=out_dtype, device=x_q.device)
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_nm_spmm_dual_{suffix}")(
            x_q.data_ptr(), values_g.data_ptr(), meta_g.data_ptr(), values_u.data_ptr(),
            meta_u.data_ptr(), x_scale.data_ptr(), wg_scale.data_ptr(), wu_scale.data_ptr(),
            _ptr(requant_scale), y.data_ptr(), b, ke, o, n, kind, bb, _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


def nm_spmm_dual_int8(x_q: torch.Tensor, values_g: torch.Tensor, meta_g: torch.Tensor,
                      values_u: torch.Tensor, meta_u: torch.Tensor, n: int,
                      x_scale: torch.Tensor, wg_scale: torch.Tensor, wu_scale: torch.Tensor,
                      *, out_dtype: torch.dtype = torch.float32,
                      block_b: Optional[int] = None) -> torch.Tensor:
    """Fused int8 gate-up over two compressed weights sharing one X read:
    ``silu(deq(Xq @ dec(g))) * deq(Xq @ dec(u))``."""
    return _nm_spmm_dual_quantized(nm_spmm_dual_int8, torch.int8, x_q, values_g, meta_g,
                                   values_u, meta_u, n, x_scale, wg_scale, wu_scale,
                                   out_dtype, block_b, None)


nm_spmm_dual_int8.launches = 0


def nm_spmm_dual_int8_requant(x_q: torch.Tensor, values_g: torch.Tensor,
                              meta_g: torch.Tensor, values_u: torch.Tensor,
                              meta_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                              wg_scale: torch.Tensor, wu_scale: torch.Tensor,
                              requant_scale: torch.Tensor, *,
                              block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_dual_int8` whose flush then requantizes to int8
    against the consuming linear's static scale (a one-element float32
    tensor on the device)."""
    return _nm_spmm_dual_quantized(nm_spmm_dual_int8_requant, torch.int8, x_q, values_g,
                                   meta_g, values_u, meta_u, n, x_scale, wg_scale, wu_scale,
                                   torch.int8, block_b, requant_scale)


nm_spmm_dual_int8_requant.launches = 0


def nm_spmm_dual_fp8(x_q: torch.Tensor, values_g: torch.Tensor, meta_g: torch.Tensor,
                     values_u: torch.Tensor, meta_u: torch.Tensor, n: int,
                     x_scale: torch.Tensor, wg_scale: torch.Tensor, wu_scale: torch.Tensor,
                     *, out_dtype: torch.dtype = torch.float32,
                     block_b: Optional[int] = None) -> torch.Tensor:
    """Fused fp8 gate-up over two compressed float8_e4m3fn weights sharing
    one X read, two fp32 accumulators."""
    return _nm_spmm_dual_quantized(nm_spmm_dual_fp8, torch.float8_e4m3fn, x_q, values_g,
                                   meta_g, values_u, meta_u, n, x_scale, wg_scale, wu_scale,
                                   out_dtype, block_b, None)


nm_spmm_dual_fp8.launches = 0


def nm_spmm_dual_fp8_requant(x_q: torch.Tensor, values_g: torch.Tensor,
                             meta_g: torch.Tensor, values_u: torch.Tensor,
                             meta_u: torch.Tensor, n: int, x_scale: torch.Tensor,
                             wg_scale: torch.Tensor, wu_scale: torch.Tensor,
                             requant_scale: torch.Tensor, *,
                             block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_dual_fp8` whose flush then requantizes to e4m3
    (clip to +-448, round to nearest even) against the consuming linear's
    static scale."""
    return _nm_spmm_dual_quantized(nm_spmm_dual_fp8_requant, torch.float8_e4m3fn, x_q,
                                   values_g, meta_g, values_u, meta_u, n, x_scale, wg_scale,
                                   wu_scale, torch.float8_e4m3fn, block_b, requant_scale)


nm_spmm_dual_fp8_requant.launches = 0


def nm_spmm_dual(x: torch.Tensor, values_g: torch.Tensor, meta_g: torch.Tensor,
                 values_u: torch.Tensor, meta_u: torch.Tensor, n: int,
                 x_scale: Optional[torch.Tensor] = None,
                 wg_scale: Optional[torch.Tensor] = None,
                 wu_scale: Optional[torch.Tensor] = None, *,
                 out_dtype: torch.dtype = torch.float32,
                 block_b: Optional[int] = None) -> torch.Tensor:
    """Fused gate-up over two compressed weights sharing one X read:
    ``silu(X @ dec(g)) * (X @ dec(u))`` in X's dtype.  Given the three
    scales, the quantized branch of X's class: :func:`nm_spmm_dual_fp8`
    for float8_e4m3fn, else :func:`nm_spmm_dual_int8` (``out_dtype`` is
    that branch's output dtype)."""
    if x_scale is not None or wg_scale is not None or wu_scale is not None:
        fn = nm_spmm_dual_fp8 if x.dtype == torch.float8_e4m3fn else nm_spmm_dual_int8
        return fn(x, values_g, meta_g, values_u, meta_u, n, x_scale, wg_scale, wu_scale,
                  out_dtype=out_dtype, block_b=block_b)
    b, ke = x.shape
    o = _check_compressed("nm_spmm_dual", ke, values_g, meta_g, n)
    if values_u.shape != values_g.shape or meta_u.shape != meta_g.shape:
        raise ValueError("nm_spmm_dual: gate and up layouts must match")
    if x.device.type == "cpu":
        return nm_spmm_dual_ref(x, values_g, meta_g, values_u, meta_u, n)
    bb = block_b or _build.block_rows(b)
    _check_cuda("nm_spmm_dual", x, (values_g, values_u), (meta_g, meta_u), bb, ke, o)
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm_dual(x.data_ptr(), values_g.data_ptr(), meta_g.data_ptr(),
                                 values_u.data_ptr(), meta_u.data_ptr(), y.data_ptr(),
                                 b, ke, o, n, bb, _build.stream_of(x))
    nm_spmm_dual.launches += 1
    _build.check(rc, "nm_spmm_dual", lib)
    return y


nm_spmm_dual.launches = 0
