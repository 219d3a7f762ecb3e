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
across the blocks of a cluster by :func:`split_k`; so does the bf16
``nm_spmm_masked`` at n in {1, 2}, walking only the live steps of each
block's span (the same split: bitwise ``nm_spmm`` on the same masked X),
and ``nm_spmm_dual`` (float) in that header's dual form (both weights'
values and meta tiles a stage, two accumulators, one silu(g) * u flush)
where :func:`dual_plan` picks it; so do ``nm_spmm_fp8`` and
``nm_spmm_fp8_requant`` at n in {1, 2} (``csrc/nm_spmm_sp_fp8.cuh``, the
e4m3 m16n8k64 form) where :func:`fp8_plan` picks it, ``nm_spmm_masked_fp8``
there too, walking the live steps of each block's span (bitwise
``nm_spmm_fp8`` on the same masked X), and ``nm_spmm_dual_fp8`` and ``nm_spmm_dual_fp8_requant`` in that header's
dual form where :func:`fp8_dual_plan` picks it; ``nm_spmm_int8`` and
``nm_spmm_int8_requant`` at n in {1, 2} run that header's s8 form (m16n8k64
s8 -> s32, int32 partials), as :func:`int8_plan` picks, ``nm_spmm_masked_int8``
there too, walking the live steps of each block's span (bitwise
``nm_spmm_int8`` on the same masked X), and
``nm_spmm_dual_int8`` and ``nm_spmm_dual_int8_requant`` its s8 dual form
where :func:`int8_dual_plan` picks it; every other kernel here expands
each values tile into the dense tile in shared memory.

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
from ..tile_gemm.kernel import (ACT_CODES, BLOCKS_PER_SM, BODY_CODES, DUAL_STREAM_MIN_SPLIT,
                                FP8_SHARED_TILES, FP8_STREAM16_BLOCKS_PER_SM, MAX_SPLIT, SMS,
                                _ptr, check_maps, check_requant_scale, check_scales,
                                check_single_epilogue, cluster_split, float_out, quantized_out,
                                requant_spec, stream_plan)
from ..reasons import dtype_name
from .ref import (nm_spmm_dual_quantized_ref, nm_spmm_dual_ref,
                  nm_spmm_masked_quantized_ref, nm_spmm_masked_ref, nm_spmm_quantized_ref,
                  nm_spmm_ref)

__all__ = ["nm_spmm", "split_k", "dual_plan", "fp8_plan", "int8_plan", "fp8_dual_plan",
           "int8_dual_plan",
           "FP8_DUAL_STREAM16_TILES", "DUAL_1OF4_SHARED_MAX_ROWS", "INT8_DUAL_STREAM16_MAX_ROWS",
           "nm_spmm_dual", "nm_spmm_int8",
           "nm_spmm_int8_requant", "nm_spmm_dual_int8", "nm_spmm_dual_int8_requant",
           "nm_spmm_fp8", "nm_spmm_fp8_requant", "nm_spmm_dual_fp8",
           "nm_spmm_dual_fp8_requant", "nm_spmm_masked", "nm_spmm_masked_int8",
           "nm_spmm_masked_fp8"]

_N = (1, 2, 4)
#: past decode rows the fp8 dual runs its 16-row stream while the launch has
#: at most this many tiles (two an SM)
FP8_DUAL_STREAM16_TILES = 2 * SMS
#: the int8 compressed dual runs its 16-row stream up to this many rows, by
#: n (2:4 two row tiles, 1:4 three), its 64-row one above
INT8_DUAL_STREAM16_MAX_ROWS = {1: 48, 2: 32}
#: the float compressed dual at 1:4 keeps the shared body up to this many
#: rows where its 64-row launch cannot split K (see :func:`dual_plan`)
DUAL_1OF4_SHARED_MAX_ROWS = 255


def split_k(b: int, k: int, o: int, n: int) -> int:
    """Blocks of one cluster that share the K loop of an output tile in
    the sparse bodies of ``nm_spmm`` and ``nm_spmm_fp8`` (n in {1, 2}; n
    = 4 runs the shared body, split 1): the largest power of two up to
    ``MAX_SPLIT`` and K / 64 steps with (O / 64 tiles) x (row tiles) x
    split <= ``BLOCKS_PER_SM`` x ``SMS``, so a decode launch fills the
    card (internlm2-1.8b at B = 8: q, o and w_out 32 x 8, k and v 16 x 8);
    1 once the row tiles fill it (4,000 prefill rows).  Block r takes K
    steps [r * steps // split, (r + 1) * steps // split)."""
    if n not in (1, 2):
        return 1
    tiles = (o // _build.BLOCK_O) * -(-b // _build.block_rows(b))
    return cluster_split(tiles, k // _build.BLOCK_K)


def dual_plan(b: int, k: int, o: int, n: int) -> dict:
    """``nm_spmm_dual``'s (float) body, tile and split for ``silu(X (b, k) @
    dec(g)) * (X @ dec(u))``, both compressed weights ``(k * n / 4, o)``.

    n in {1, 2}: ``stream`` (``csrc/nm_spmm_sp.cuh``'s compressed dual: both
    weights' values and meta tiles a stage, two accumulators, one silu(g) *
    u flush), the K loop split over a cluster by ``cluster_split`` at
    ``BLOCKS_PER_SM`` blocks an SM: 16-row tiles up to 16 rows
    (:func:`~repro_torch.kernels.tile_gemm.kernel.stream_plan`'s;
    internlm2-1.8b's gate-up at B = 8 is 128 tiles, split 2; qwen3-moe's
    expert gate-up (4096, 1536) 24 tiles, split 8), 64-row tiles above
    (internlm2-1.8b's 17-64 rows: split 2; qwen3-moe's: split 8).  Else
    ``shared`` (gemm.cu's body, the form the port ran first), split 1: at n
    = 4, and at 1:4 up to ``DUAL_1OF4_SHARED_MAX_ROWS`` rows where the
    64-row launch cannot split K (internlm2-1.8b's and phi-3-vision's
    gate-up at 65-255 rows).  On an H100 (``chip_smoke.py``'s kernel phase
    and dual sweep phase, 17-256 rows at those two pairs and qwen3-moe's;
    PERF.md §6) the stream beat the shared body by 1.10-6.8x at every
    shape where the plan picks it (internlm2-1.8b 2:4 at B = 8: 18.4
    against 47.8 µs); 1:4 unsplit lost to it at 128 rows (internlm2 77.0
    against 62.7 µs, phi-3 113.7 against 91.3; development runs agreed at
    96 and 192) and won again at 256 (120.7 against 132.2, 177.5 against
    197.8).  The 64-row tiles at two blocks an SM beat K1's one by up to
    1.36x (internlm2 2:4 at 64 rows: 28.7 against 36.9) and beat 16-row
    tiles past 16 rows everywhere but qwen3-moe's 1:4 at 17 rows (19.6
    against 18.8).  Returns ``{"body", "rows", "cols", "split"}``; ``rows``
    is what the C interface takes as ``bm``."""
    if n in (1, 2):
        if b <= _build.BLOCK_ROWS[0]:
            return stream_plan(b, k, o)
        rows = _build.BLOCK_ROWS[1]
        split = cluster_split((o // _build.BLOCK_O) * -(-b // rows), k // _build.BLOCK_K)
        if not (n == 1 and split == 1 and b <= DUAL_1OF4_SHARED_MAX_ROWS):
            return {"body": "stream", "rows": rows, "cols": _build.BLOCK_O, "split": split}
    return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O, "split": 1}


def fp8_plan(b: int, k: int, o: int, n: int) -> dict:
    """``nm_spmm_fp8``'s body and K split: ``sparse`` (``csrc/
    nm_spmm_sp_fp8.cuh``, n in {1, 2}) at decode rows (up to 16) and
    wherever the shared body's O / 64 x row-tile blocks stay under
    ``FP8_SHARED_TILES``, split by :func:`split_k`; else ``shared``
    (gemm_fp8.cu's body, the form the port ran first), split 1.
    ``nm_spmm_masked_fp8`` takes the same plan (its sparse body in
    ``MASKED`` form)."""
    bm = _build.block_rows(b)
    tiles = (o // _build.BLOCK_O) * -(-b // bm)
    if n in (1, 2) and (bm == _build.BLOCK_ROWS[0] or tiles < FP8_SHARED_TILES):
        return {"body": "sparse", "split": split_k(b, k, o, n)}
    return {"body": "shared", "split": 1}


def int8_plan(b: int, k: int, o: int, n: int) -> dict:
    """``nm_spmm_int8``'s (and ``_requant``'s) body and K split: at n in
    {1, 2} ``sparse`` (the s8 form of ``csrc/nm_spmm_sp_fp8.cuh``'s
    stream) over ``block_rows(b)``-row tiles, split by :func:`split_k`; at
    n = 4 ``shared`` (gemm_int8.cu's body, the form the port ran first),
    split 1.  Unlike :func:`fp8_plan` the stream keeps its 64-row launches
    however wide: on an H100, 700 W (``chip_smoke.py``'s int8 and requant
    phases, PERF.md §6) it beat gemm_int8.cu's body at every timed shape,
    internlm2-1.8b's w_out (8192, 2048) 2:4 at B = 8 / 64 / 256 12.1 / 21.9
    / 56.0 µs against 136.6 / 131.2 / 128.7, gemma3-1b's gelu w_in (1152,
    6912) 8.7 / 17.0 / 32.9 against 22.5 / 27.6 / 66.1 (108 tiles at 64
    rows, where ``fp8_plan`` keeps e4m3 on the shared body); a development
    sweep on the same card found it faster at 512-4,000 rows too.  The
    int32 sums are exact in any order, so either body gives the plain
    version's bits.  ``nm_spmm_masked_int8`` takes the same plan (its
    sparse body in ``MASKED`` form, over its maps' row block): on the same
    card (``tools/int8_body_sweep.py --kernels nmask``) it beat the first
    body at every swept launch with a live step, qwen3-moe's expert w_out
    (1536, 4096) 2:4 at B = 8 and ~0.4 live 6.91 against 13.37 µs, at 64
    rows 10.84 against 19.47; a launch with no live step costs it 3.8-4.1 µs
    at 16 rows against the first body's 2.2-3.2."""
    if n in (1, 2):
        return {"body": "sparse", "split": split_k(b, k, o, n)}
    return {"body": "shared", "split": 1}


def fp8_dual_plan(b: int, k: int, o: int, n: int) -> dict:
    """``nm_spmm_dual_fp8``'s (and ``_requant``'s) body, tile and split for
    ``silu(Xq (b, k) @ dec(g)) * (Xq @ dec(u))``, both compressed weights
    ``(k * n / 4, o)``.  n in {1, 2}: ``sparse`` (``csrc/
    nm_spmm_sp_fp8.cuh``'s dual stream: both weights' tiles a stage, two
    accumulators, one flush) over 64-channel tiles of 16 rows at decode
    rows (up to 16) and while the launch has at most
    ``FP8_DUAL_STREAM16_TILES`` of them, the K loop split over a cluster by
    ``cluster_split`` over K / 64 steps at ``FP8_STREAM16_BLOCKS_PER_SM``
    blocks an SM (internlm2-1.8b's gate-up at B = 8: 128 tiles, split 2);
    else over 64-row tiles where that split (two blocks an SM) is
    ``DUAL_STREAM_MIN_SPLIT`` or more (qwen3-moe's expert gate-up (4096,
    1536) at 64 rows).  Else ``shared`` (gemm_fp8.cu's body, the form the
    port ran first), split 1: at n = 4, at internlm2-1.8b's gate-up (2048,
    8192) from 33 rows and at qwen3-moe's from 256, where on an H100 the
    dual streams lost to it (2:4 at 64 rows: 85.8 / 79.4 us over 64 / 16-row
    tiles against 62.0; 1:4 at 33 rows: 53.7 over 16-row tiles against
    47.4; ``chip_smoke.py``'s fp8 sweep phase and PR 24's development
    timings, PERF.md §6).  Returns ``{"body", "rows", "cols", "split"}``;
    ``rows`` is what the C interface takes as ``bm``."""
    if n in (1, 2):
        steps = k // _build.BLOCK_K
        t16 = (o // _build.BLOCK_O) * -(-b // _build.BLOCK_ROWS[0])
        if b <= _build.BLOCK_ROWS[0] or t16 <= FP8_DUAL_STREAM16_TILES:
            return {"body": "sparse", "rows": _build.BLOCK_ROWS[0], "cols": _build.BLOCK_O,
                    "split": cluster_split(t16, steps, FP8_STREAM16_BLOCKS_PER_SM)}
        split = cluster_split((o // _build.BLOCK_O) * -(-b // _build.BLOCK_ROWS[1]), steps)
        if split >= DUAL_STREAM_MIN_SPLIT:
            return {"body": "sparse", "rows": _build.BLOCK_ROWS[1], "cols": _build.BLOCK_O,
                    "split": split}
    return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O, "split": 1}


def int8_dual_plan(b: int, k: int, o: int, n: int) -> dict:
    """``nm_spmm_dual_int8``'s (and ``_requant``'s) body, tile and split for
    ``silu(deq(Xq (b, k) @ dec(g))) * deq(Xq @ dec(u))``, both compressed
    int8 weights ``(k * n / 4, o)``.  n in {1, 2}: ``sparse`` (the s8 form of
    ``csrc/nm_spmm_sp_fp8.cuh``'s dual stream: both weights' tiles a stage,
    ``mma.sp`` m16n8k64 s8 -> s32 into two int32 accumulator sets, both
    partial planes summed in rank order, gemm_int8.cu's ``DualFlushI8``) at
    every row count: over 64-channel tiles of 16 rows up to
    ``INT8_DUAL_STREAM16_MAX_ROWS[n]`` rows (32 at 2:4, 48 at 1:4), split by ``cluster_split`` at
    ``BLOCKS_PER_SM`` blocks an SM at 2:4 and ``FP8_STREAM16_BLOCKS_PER_SM``
    at 1:4 (internlm2-1.8b's gate-up (2048, 8192) at B = 8: 128 tiles, split
    2; qwen3-moe's expert (4096, 1536): 24 tiles, split 8); above, over
    64-row tiles split at ``BLOCKS_PER_SM``.  On an H100, 700 W
    (``tools/int8_body_sweep.py``, PERF.md §6) the stream beat gemm_int8.cu's
    first body at every swept shape, 1-256 rows at both pairs, n in {1, 2}:
    internlm2-1.8b 2:4 at 8 / 64 / 256 rows 15.8 / 29.3 / 70.2 µs against
    50.6 / 66.2 / 190.6, qwen3-moe's expert 10.0 / 17.4 / 46.7 against
    98.1 / 123.2 / 123.1.  Three 16-row blocks an SM lost to two at the
    expert's 2:4 over 17-32 rows (18.3-21.2 against 14.9 µs, a split of 8
    against 4) and won at its 1:4 (11.5 against 13.9); the 64-row tiles beat
    the 16-row ones from 33 rows at 2:4 and from 49 at 1:4, where the
    16-row ones won over 33-48 rows (internlm2-1.8b 26.4-27.6 against
    28.1-28.2 µs, the expert 15.5-15.8 against 16.4-16.5) but for one row
    count no path runs, 65 (internlm2-1.8b 37.7 against 42.1, the expert
    23.7 against 25.0).  n = 4
    keeps ``shared`` (gemm_int8.cu's body, the form the port ran first) at
    ``block_rows(b)`` rows, split 1.  The int32 sums are exact in any order
    and the flush repeats the first body's fp32 operations: every body gives
    the same bits, requantized codes included.  Returns ``{"body", "rows",
    "cols", "split"}``; ``rows`` is what the C interface takes as ``bm``."""
    if n not in (1, 2):
        return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O,
                "split": 1}
    rows16, rows64 = _build.BLOCK_ROWS
    steps, cols = k // _build.BLOCK_K, o // _build.BLOCK_O
    if b <= INT8_DUAL_STREAM16_MAX_ROWS[n]:
        per_sm = FP8_STREAM16_BLOCKS_PER_SM if n == 1 else BLOCKS_PER_SM
        return {"body": "sparse", "rows": rows16, "cols": _build.BLOCK_O,
                "split": cluster_split(cols * -(-b // rows16), steps, per_sm)}
    return {"body": "sparse", "rows": rows64, "cols": _build.BLOCK_O,
            "split": cluster_split(cols * -(-b // rows64), steps)}


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
    K step) tiles ``kmask`` marks live are loaded and multiplied.  ``kmap``
    / ``kmask``: ``actsparse.block_maps`` over the masked X at ``block_b``
    rows and 64 columns; the CUDA bodies ignore ``kmap``.  n in {1, 2}: the
    sparse stream of :func:`nm_spmm` at its split (:func:`split_k`), each
    block walking the live steps of its span; n = 4: the shared body, which
    expands each live values tile.  Bitwise :func:`nm_spmm` on the same
    masked X at the same ``block_b``."""
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
                                   ACT_CODES[epi.act], bb, split_k(b, ke, o, n),
                                   _build.stream_of(x))
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
    # both classes' singles, masked or not, run the body of their plans
    # (sparse: K split over a cluster; the masked ones walk each span's
    # live steps over their maps' row block)
    p = (fp8_plan if storage == torch.float8_e4m3fn else int8_plan)(b, ke, o, n)
    plan = (int(p["body"] == "sparse"), p["split"])
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_{kernel.removesuffix('_requant')}")(
            x_q.data_ptr(), values.data_ptr(), meta_packed.data_ptr(),
            *(t.data_ptr() for t in kmask), _ptr(x_scale), _ptr(w_scale), _ptr(bias32),
            _ptr(requant_scale), y.data_ptr(), b, ke, o, n, ACT_CODES[epi.act], kind, bb,
            *plan, _build.stream_of(x_q))
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
    values contracted into an exact int32 accumulator, dequantized once at
    the flush.  With no scales it returns the raw int32 accumulator.  The
    body and split are :func:`int8_plan`'s (the s8 sparse stream at n in
    {1, 2}, the shared body, which expands each values tile on chip, at n =
    4); either gives the same bits."""
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
    (maps over the int8 rows at ``block_b`` rows; the CUDA bodies ignore
    ``kmap``).  The body and split are :func:`int8_plan`'s, as
    :func:`nm_spmm_int8` takes them: at n in {1, 2} the s8 sparse stream at
    :func:`split_k`'s split, each block walking the live steps of its span;
    at n = 4 the shared body, split 1.  Either way bitwise
    :func:`nm_spmm_int8` on the same masked rows; with ``requant_scale`` the
    flush requantizes, bitwise :func:`nm_spmm_int8_requant`'s codes."""
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
    (maps over the e4m3 rows at ``block_b`` rows; the CUDA bodies ignore
    ``kmap``).  The body and split are :func:`fp8_plan`'s, as
    :func:`nm_spmm_fp8` takes them: where it says ``sparse`` (n in {1, 2},
    decode rows and launches narrower than ``FP8_SHARED_TILES``) the e4m3
    sparse stream at :func:`split_k`'s split, each block walking the live
    steps of its span; else the shared body, split 1.  Either way bitwise
    :func:`nm_spmm_fp8` on the same masked rows at the same ``block_b``.
    With ``requant_scale`` the flush requantizes, bitwise
    :func:`nm_spmm_fp8_requant`'s codes."""
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
    # both classes run the body of their plans (block_b only checked)
    p = (fp8_dual_plan if storage == torch.float8_e4m3fn else int8_dual_plan)(b, ke, o, n)
    bb, plan = p["rows"], (int(p["body"] == "sparse"), p["split"])
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_nm_spmm_dual_{suffix}")(
            x_q.data_ptr(), values_g.data_ptr(), meta_g.data_ptr(), values_u.data_ptr(),
            meta_u.data_ptr(), x_scale.data_ptr(), wg_scale.data_ptr(), wu_scale.data_ptr(),
            _ptr(requant_scale), y.data_ptr(), b, ke, o, n, kind, bb, *plan,
            _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


def nm_spmm_dual_int8(x_q: torch.Tensor, values_g: torch.Tensor, meta_g: torch.Tensor,
                      values_u: torch.Tensor, meta_u: torch.Tensor, n: int,
                      x_scale: torch.Tensor, wg_scale: torch.Tensor, wu_scale: torch.Tensor,
                      *, out_dtype: torch.dtype = torch.float32,
                      block_b: Optional[int] = None) -> torch.Tensor:
    """Fused int8 gate-up over two compressed weights sharing one X read:
    ``silu(deq(Xq @ dec(g))) * deq(Xq @ dec(u))``.  ``block_b`` is the
    dispatch plan's row block (checked); the body, its tile and its K split
    are :func:`int8_dual_plan`'s; every body gives the same bits."""
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
    one X read, two fp32 accumulators.  ``block_b`` is the dispatch plan's
    row block (checked); the body, its tile and its K split are
    :func:`fp8_dual_plan`'s."""
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
    ``silu(X @ dec(g)) * (X @ dec(u))`` in X's dtype.  ``block_b`` is the
    dispatch plan's row block (checked); the body, its tile and its K split
    are :func:`dual_plan`'s.  Given the three scales, the quantized branch
    of X's class: :func:`nm_spmm_dual_fp8` for float8_e4m3fn, else
    :func:`nm_spmm_dual_int8` (``out_dtype`` is that branch's output
    dtype)."""
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
    p = dual_plan(b, ke, o, n)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm_dual(x.data_ptr(), values_g.data_ptr(), meta_g.data_ptr(),
                                 values_u.data_ptr(), meta_u.data_ptr(), y.data_ptr(),
                                 b, ke, o, n, p["rows"], BODY_CODES[p["body"]], p["split"],
                                 _build.stream_of(x))
    nm_spmm_dual.launches += 1
    _build.check(rc, "nm_spmm_dual", lib)
    return y


nm_spmm_dual.launches = 0
