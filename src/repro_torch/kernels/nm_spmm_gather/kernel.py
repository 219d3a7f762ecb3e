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
the dual wgmma body.  ``nm_spmm_gather_bk_fp8`` and ``_requant`` at n in
{1, 2} run the e4m3 forms of K8's two, chosen by :func:`fp8_plan`: the
e4m3 stream of ``csrc/nm_spmm_sp_fp8.cuh`` with a byte select pass, and an
e4m3 gather pass (``gemm_fp8.cu``) in front of ``csrc/
tile_gemm_sm90_fp8.cuh``'s wgmma body.  ``nm_spmm_gather_dual_bk_fp8`` and
``_requant`` (K9 fp8) at n in {1, 2} run that e4m3 stream's dual form (one
X span a step selected twice, both dense values tiles, two accumulators)
where :func:`fp8_dual_plan` picks it.  ``nm_spmm_gather_bk_masked`` (bf16)
at 2:4 runs K8's stream with the activation-sparsity skip (each block
walking the live steps of its span) wherever K8 streams, as
:func:`masked_plan` picks; its int8 and fp8 twins at n in {1, 2} run K8
int8's s8 and K8 fp8's e4m3 streams so, at their maps' row block, as
:func:`masked_int8_plan` and :func:`masked_fp8_plan` pick.
``nm_spmm_gather_fp8`` (K11) at n in {1, 2} runs that e4m3 stream with a
K-major X stage (the step's selected x_t rows, then a byte transpose
pass), chosen by :func:`kmajor_fp8_plan`,
and ``nm_spmm_gather_int8`` (K11 int8) its s8 form, chosen by
:func:`kmajor_int8_plan`.  The int8 twins run the s8 forms of the e4m3
streams: ``nm_spmm_gather_bk_int8`` and ``_requant`` K8's, chosen by
:func:`int8_plan`, and ``nm_spmm_gather_dual_bk_int8`` and ``_requant``
K9's gathered dual, chosen by :func:`int8_dual_plan`.  Every other kernel
here runs the shared bodies of ``gemm.cu`` / ``gemm_int8.cu`` /
``gemm_fp8.cu``.

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
from ..tile_gemm.kernel import (ACT_CODES, BODY_CODES, FP8_STREAM16_BLOCKS_PER_SM,
                                FP8_WGMMA_COLS, SMS, WGMMA_MIN_ROWS, WGMMA_ROWS, _ptr,
                                check_maps, check_requant_scale, check_scales,
                                check_single_epilogue, cluster_split, float_out,
                                quantized_out, requant_spec, stream_plan)
from ..tile_gemm.kernel import dual_plan as tile_dual_plan
from ..tile_gemm.kernel import fp8_dual_plan as tile_fp8_dual_plan
from ..tile_gemm.kernel import fp8_plan as tile_fp8_plan
from ..tile_gemm.kernel import int8_plan as tile_int8_plan
from ..tile_gemm.kernel import masked_int8_plan as tile_masked_int8_plan
from ..tile_gemm.kernel import plan as tile_plan
from .ref import (nm_spmm_gather_dual_quantized_ref, nm_spmm_gather_dual_ref,
                  nm_spmm_gather_masked_quantized_ref, nm_spmm_gather_masked_ref,
                  nm_spmm_gather_quantized_ref, nm_spmm_gather_ref,
                  nm_spmm_gather_t_quantized_ref, nm_spmm_gather_t_ref)

__all__ = ["nm_spmm_gather_bk", "plan", "dual_plan", "fp8_plan", "int8_plan", "kmajor_fp8_plan",
           "kmajor_int8_plan",
           "masked_plan", "masked_int8_plan", "masked_fp8_plan", "fp8_dual_plan",
           "int8_dual_plan",
           "DUAL_SHARED_MAX_KC", "FP8_STREAM16_MAX_ROWS", "KMAJOR_STREAM64_MIN_STEPS",
           "INT8_KMAJOR_STREAM16_MAX_STEPS",
           "KMAJOR_STREAM_MAX_ROWS", "FP8_MASKED_STREAM64_MIN_KC",
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
#: K8 fp8 runs its 16-row stream over several row tiles up to this many rows
#: (four row tiles)
FP8_STREAM16_MAX_ROWS = 64
#: K11 fp8's 64-row stream takes a launch past the 16-row one's width where
#: each block of its split walks this many 64-deep steps or more
KMAJOR_STREAM64_MIN_STEPS = 8
#: K11 fp8 streams up to this many rows (the shared body above); K11 int8
#: runs its 16-row stream up to this many rows
KMAJOR_STREAM_MAX_ROWS = 256
#: K11 int8's 16-row stream takes a launch while each block of its split
#: walks at most this many 64-deep steps (its 64-row stream the others)
INT8_KMAJOR_STREAM16_MAX_STEPS = 8
#: the masked fp8 gather runs its 64-row stream at 17-64 rows where K_c is at
#: least this (internlm2-1.8b's w_out); else the shared body
FP8_MASKED_STREAM64_MIN_KC = 2048

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


def masked_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_bk_masked``'s (bf16) body, tile and split: at 2:4,
    :func:`plan`'s ``stream`` wherever K8 streams (below ``WGMMA_MIN_ROWS``
    rows), the masked form of that stream at its tile and split (each block
    walks the live steps of its span: bitwise K8 on the same masked X);
    elsewhere ``shared`` (gemm.cu's masked body, the form the port ran
    first) at ``block_rows(b)`` rows, split 1: from ``WGMMA_MIN_ROWS`` rows
    (K8's wgmma body), at n = 4, and at 1:4, where K8's 16-row stream lost to
    the shared body at qwen3-moe's expert w_out on an H100, unmasked and
    masked (PERF.md §6).  Returns ``{"body", "rows", "cols", "split"}``;
    ``rows`` is the maps' row block."""
    p = plan(b, ke, o, n)
    if n == 2 and p["body"] == "stream":
        return p
    return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O, "split": 1}


def masked_int8_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_bk_masked_int8``'s (and its requantizing form's)
    body, tile and split.  n in {1, 2}: ``stream`` (K8 int8's s8 gathered
    stream of ``csrc/nm_spmm_sp_fp8.cuh`` in ``MASKED`` form: each block
    walks the live steps of its span, a dead step's index slice and X span
    neither loaded nor selected) at ``tile_gemm.kernel.masked_int8_plan(b,
    K_c, o)``, whose rows are ``block_rows(b)``, the row block of the maps
    dispatch builds and the masked stream reads at ``blockIdx.y``: K8
    int8's :func:`int8_plan` wherever its tile is that row block (qwen3-moe's
    expert w_out (1536, 4096) 2:4 at B = 8: 64 tiles of 16 rows, split 4),
    else the 64-row stream (the expert's w_out at B = 64: split 4, where K8
    int8 takes 16-row tiles unsplit).  The int32 sums are exact in any
    order, so every tile and split is bitwise ``nm_spmm_gather_bk_int8``
    (and its requantized codes) on the same masked X.  n = 4 keeps
    ``shared`` (gemm_int8.cu's masked body, the form the port ran first) at
    ``block_rows(b)`` rows, split 1.  Returns ``{"body", "rows", "cols",
    "split"}``; ``rows`` is the maps' row block."""
    if n in (1, 2):
        return tile_masked_int8_plan(b, ke * n // 4, o)
    return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O, "split": 1}


def masked_fp8_plan(b: int, ke: int, o: int, n: int, requant: bool = False) -> dict:
    """``nm_spmm_gather_bk_masked_fp8``'s body, tile and split (``requant``:
    its requantizing form's).  n in {1, 2}, wherever :func:`fp8_plan`
    (``requant`` as there) streams: ``stream`` (K8 fp8's e4m3 gathered
    stream of ``csrc/nm_spmm_sp_fp8.cuh`` in ``MASKED`` form: each block
    walks the live steps of its span) over ``block_rows(b)`` rows, the row
    block of the maps the masked stream reads at ``blockIdx.y``, at
    :func:`fp8_plan`'s split.  Up to 16 rows that is :func:`fp8_plan`'s
    plan (qwen3-moe's expert w_out (1536, 4096) 2:4 at B = 8: 64 tiles of
    16 rows, split 4); at 17-64 rows, where :func:`fp8_plan` takes 16-row
    tiles against the maps' 64 rows, the 64-row stream at that same split
    where K_c is at least ``FP8_MASKED_STREAM64_MIN_KC``: the split's spans,
    and so each output's e4m3 sums in their order, are K8 fp8's either way,
    so bitwise ``nm_spmm_gather_bk_fp8`` (and its requantized codes) on the
    same masked X.  On an H100, 700 W (``tools/int8_body_sweep.py --kernels
    gmask8``, PERF.md §6) that 64-row stream beat the shared body at every
    swept point of internlm2-1.8b's w_out (K_c 4,096 / 2,048) at 17-64 rows
    and 0 / 0.4 / 1 live (at 64 rows 2:4, 0.4 live 28.5 against 38.5 µs),
    but lost at 5 of the 18 points of qwen3-moe's expert w_out (K_c 768 /
    384; at 64 rows 2:4 all live 25.7 against 23.1): the shared body there.
    Everywhere else ``shared`` (gemm_fp8.cu's masked body, the form the
    port ran first) at ``block_rows(b)`` rows, split 1: where
    :func:`fp8_plan` takes its wgmma body (there is no masked one) and at n
    = 4.  Returns ``{"body", "rows", "cols", "split"}``; ``rows`` is the
    maps' row block."""
    rows = _build.block_rows(b)
    p = fp8_plan(b, ke, o, n, requant=requant)
    if n in (1, 2) and p["body"] == "stream" and (
            p["rows"] == rows or ke * n // 4 >= FP8_MASKED_STREAM64_MIN_KC):
        return {**p, "rows": rows}
    return {"body": "shared", "rows": rows, "cols": _build.BLOCK_O, "split": 1}


def fp8_dual_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_dual_bk_fp8``'s and ``_requant``'s body, tile and
    split for ``silu(gather(Xq (b, ke), idx_g) @ values_g) * (gather(Xq,
    idx_u) @ values_u)``, both e4m3 values ``(ke * n / 4, o)``.  n in {1,
    2}: ``stream`` (``csrc/nm_spmm_sp_fp8.cuh``'s gathered dual: one X span
    a step selected twice, both dense values tiles, two accumulators, split-K
    over a cluster) wherever ``tile_gemm.kernel.fp8_dual_plan(b, K_c, o,
    requant=True)`` streams the dense e4m3 dual: 16-row tiles at
    ``FP8_STREAM16_BLOCKS_PER_SM`` blocks an SM while the launch has at most
    ``FP8_STREAM16_BLOCKS_PER_SM`` x ``SMS`` tiles (internlm2-1.8b's gate-up
    up to 48 rows, 128 tiles split 2 at B = 8; qwen3-moe's expert gate-up up
    to 264 rows, 24 tiles split 8 at B = 8).  On an H100 the stream beat the
    shared body at every swept shape below that width and tied or lost past
    it (``chip_smoke.py``'s fp8 sweep phase; PERF.md §6); there is no
    two-X form of the e4m3 dual wgmma body, so both forms, the bf16 / fp32
    and the requantized, take this one plan.  Everywhere else ``shared``
    (gemm_fp8.cu's body, the form the port ran first) at ``block_rows(b)``
    rows, split 1; n = 4 keeps ``shared``.  Returns ``{"body", "rows",
    "cols", "split"}``; ``rows`` is what the C interface takes as ``bm``."""
    if n in (1, 2):
        p = tile_fp8_dual_plan(b, ke * n // 4, o, requant=True)
        if p["body"] == "stream":
            return p
    return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O, "split": 1}


def int8_dual_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_dual_bk_int8``'s and ``_requant``'s body, tile and
    split for ``silu(deq(gather(Xq (b, ke), idx_g) @ values_g)) *
    deq(gather(Xq, idx_u) @ values_u)``, both int8 values ``(ke * n / 4,
    o)``.  n in {1, 2}: ``stream`` (the s8 form of
    ``csrc/nm_spmm_sp_fp8.cuh``'s gathered dual: one X span a step selected
    twice, both dense values tiles, two ``mma.sync`` m16n8k32 s8 -> s32 a
    step a weight into two int32 accumulator sets, split-K over a cluster,
    gemm_int8.cu's ``DualFlushI8T<true>``, ws first) at every row count,
    over 64-channel tiles of 16 rows, the K_c loop split by
    ``cluster_split`` at ``FP8_STREAM16_BLOCKS_PER_SM`` blocks an SM
    (internlm2-1.8b's gate-up (2048, 8192) at B = 8: 128 tiles, split 2;
    qwen3-moe's expert (4096, 1536): 24 tiles, split 8): :func:`fp8_dual_plan`'s
    tile and split up to its 396 tiles, and past them too, where K9 fp8 takes
    its shared body.  On an H100, 700 W (``tools/int8_body_sweep.py``,
    PERF.md §6) the stream beat gemm_int8.cu's first
    body at every swept shape, 1-256 rows at both pairs, n in {1, 2}, but
    one no path runs (internlm2-1.8b 1:4 at 192 rows: 46.9 against 43.7
    µs): internlm2-1.8b 2:4 at 8 / 64 / 256 rows 13.4 / 25.8 / 95.2 against
    22.2 / 39.4 / 106.9, the expert 2:4 8.7 / 15.0 / 39.2 against 39.9 /
    70.5 / 70.1.  Three blocks an SM beat two at the expert's 2:4 over 17-32
    rows (10.1 against 12.6 µs, a split of 8 against 4) and lost at its 1:4
    (11.1 against 8.9), which no path runs.  There is no 64-row form.  n = 4
    keeps ``shared`` (gemm_int8.cu's body, the form the port ran first) at
    ``block_rows(b)`` rows, split 1.  The int32 sums are exact in any order
    and the flush repeats the first body's fp32 operations: every body
    gives the same bits, requantized codes included.  Returns ``{"body",
    "rows", "cols", "split"}``; ``rows`` is what the C interface takes as
    ``bm``."""
    if n not in (1, 2):
        return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O,
                "split": 1}
    rows16 = _build.BLOCK_ROWS[0]
    tiles = (o // _build.BLOCK_O) * -(-b // rows16)
    return {"body": "stream", "rows": rows16, "cols": _build.BLOCK_O,
            "split": cluster_split(tiles, ke * n // 4 // _build.BLOCK_K,
                                   FP8_STREAM16_BLOCKS_PER_SM)}


def fp8_plan(b: int, ke: int, o: int, n: int, requant: bool = False) -> dict:
    """``nm_spmm_gather_bk_fp8``'s (and ``_requant``'s) body, tile and split
    for ``gather(Xq (b, ke), idx) @ values (ke * n / 4, o)``, e4m3, over the
    compressed contraction K_c = ke * n / 4.  n in {1, 2}: ``stream``
    (``csrc/nm_spmm_sp_fp8.cuh`` over the values with a byte select pass
    over the step's X span) over 64-channel tiles of 16 rows up to
    ``FP8_STREAM16_MAX_ROWS`` rows while the launch has at most
    ``FP8_STREAM16_BLOCKS_PER_SM`` x ``SMS`` tiles (always for ``requant``),
    the K loop split by ``cluster_split`` at that many blocks an SM
    (internlm2-1.8b's decode sites: split 8); ``wgmma`` (the e4m3 gather pass
    into a (b, K_c) scratch, then ``csrc/tile_gemm_sm90_fp8.cuh``) above.  On
    an H100 the 16-row stream beat the wgmma body and the 64-row stream up to
    64 rows at internlm2-1.8b's q, k / v and at 1:4 (2:4 q at 64 rows: 11.9
    against 15.1 / 14.7 us), came within 8% at w_out (34.5 against 32.0) and
    lost past 432 tiles (gemma3-1b's w_in at 64 rows: 17.5 against 13.5);
    the wgmma body won from 128 rows (PR 24's development timings, PERF.md
    §6).  ``requant`` (e4m3 codes out) never takes ``wgmma`` (its 128-deep
    e4m3 sums move codes by more than one step, see
    ``tile_gemm.kernel.fp8_plan``): above 64 rows it takes
    ``tile_gemm.kernel.fp8_plan(b, K_c, o, requant=True)``, the 64-row
    stream, or ``shared`` (gemm_fp8.cu's body, the form the port ran first;
    split 1) at launches of ``FP8_SHARED_TILES`` tiles or more: gemma3-1b's
    w_in (1152, 6912) from 65 rows (at 128 rows 22.0 us against the
    streams' 29.1 / 31.4).  n = 4 keeps ``shared``.  Returns ``{"body",
    "rows", "cols", "split"}``; ``rows`` is what the C interface takes as
    ``bm``."""
    if n not in (1, 2):
        return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O,
                "split": 1}
    kc = ke * n // 4
    tiles = (o // _build.BLOCK_O) * -(-b // _build.BLOCK_ROWS[0])
    if b <= FP8_STREAM16_MAX_ROWS and (requant or tiles <= FP8_STREAM16_BLOCKS_PER_SM * SMS):
        return {"body": "stream", "rows": _build.BLOCK_ROWS[0], "cols": _build.BLOCK_O,
                "split": cluster_split(tiles, kc // _build.BLOCK_K, FP8_STREAM16_BLOCKS_PER_SM)}
    if requant:
        return tile_fp8_plan(b, kc, o, requant=True)
    return {"body": "wgmma", "rows": WGMMA_ROWS, "cols": FP8_WGMMA_COLS, "split": 1}


def int8_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_bk_int8``'s (and ``_requant``'s) body, tile and
    split for ``gather(Xq (b, ke), idx) @ values (ke * n / 4, o)``, int8,
    over the compressed contraction K_c = ke * n / 4.  n in {1, 2}:
    ``stream`` (the s8 form of ``csrc/nm_spmm_sp_fp8.cuh``'s gathered
    stream: the step's X span, the byte select pass, two ``mma.sync``
    m16n8k32 s8 -> s32 a step, int32 partials) at every row count, with
    ``tile_gemm.kernel.int8_plan(b, K_c, o)``'s tile and split: K8 fp8's
    16-row tiles at ``FP8_STREAM16_BLOCKS_PER_SM`` blocks an SM up to 16
    rows, and up to 64 while a block walks at most
    ``INT8_STREAM16_MAX_STEPS`` steps of its split; 64-row tiles at two
    blocks an SM above (hubert-xlarge's 4,000 prefill rows).  On an H100,
    700 W (``tools/int8_body_sweep.py``, PERF.md §6) it beat gemm_int8.cu's
    first body at every swept 2:4 shape of internlm2-1.8b, gemma3-1b's w_in
    and hubert-xlarge, 8-4,000 rows (internlm2-1.8b's w_out at 8 / 64 /
    4,000 rows 9.8 / 18.3 / 512 µs against 44.1 / 66.3 / 732; hubert's
    (5120, 1280) at 4,000 rows 216 against 290), and at 1:4 up to 1,024
    rows; at 4,000 rows the 1:4 stream is 0-5% slower than the shared body
    (internlm2-1.8b's q: 140.6 against 133.4), which no path runs.  n = 4
    keeps ``shared`` (gemm_int8.cu's body, the form the port ran first) at
    ``block_rows(b)`` rows, split 1.  The int32 sums are exact in any order:
    every body gives the plain version's bits.  Returns ``{"body", "rows",
    "cols", "split"}``; ``rows`` is what the C interface takes as ``bm``."""
    if n not in (1, 2):
        return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O,
                "split": 1}
    return tile_int8_plan(b, ke * n // 4, o)


def kmajor_fp8_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_fp8``'s (K11 fp8) body, tile and split for ``Y_t (o,
    b) = gather(x_t (ke, b), idx)^T-contract values (ke * n / 4, o)``, e4m3,
    over the compressed contraction K_c = ke * n / 4.  n in {1, 2} up to
    ``KMAJOR_STREAM_MAX_ROWS`` rows: ``stream`` (``csrc/nm_spmm_sp_fp8.cuh``
    over the values with the K-major X stage: the step's selected x_t rows
    landed by cp.async, a byte transpose pass into the X tile) over
    64-channel tiles of 16 rows, the K loop split by ``cluster_split`` at
    ``FP8_STREAM16_BLOCKS_PER_SM`` blocks an SM (internlm2-1.8b's two
    row-parallel sites on a (1, 2) mesh at B = 32: 2 x 32 tiles, split 4);
    past ``FP8_STREAM16_BLOCKS_PER_SM`` x ``SMS`` tiles, over 64-row tiles at
    ``cluster_split``'s split where each block still walks
    ``KMAJOR_STREAM64_MIN_STEPS`` steps or more (at B = 256 they beat the
    16-row tiles at internlm2-1.8b's local w_out, K_c 1,024 / 2,048, and
    lost to them at wo, K_c 256 / 512; both beat the shared body).
    ``shared`` (gemm_fp8.cu's body, the form the port ran first; split 1)
    above ``KMAJOR_STREAM_MAX_ROWS`` rows, where it beat both streams at
    internlm2-1.8b's two local sites at 1,024 rows, and at n = 4
    (development timings of each body alone on an H100).  Returns ``{"body", "rows",
    "cols", "split"}``; ``rows`` is what the C interface takes as ``bm``."""
    rows16, rows64 = _build.BLOCK_ROWS
    if n not in (1, 2) or b > KMAJOR_STREAM_MAX_ROWS:
        return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O,
                "split": 1}
    steps = ke * n // 4 // _build.BLOCK_K
    tiles = (o // _build.BLOCK_O) * -(-b // rows16)
    split = cluster_split((o // _build.BLOCK_O) * -(-b // rows64), steps)
    if tiles > FP8_STREAM16_BLOCKS_PER_SM * SMS and \
            steps // split >= KMAJOR_STREAM64_MIN_STEPS:
        return {"body": "stream", "rows": rows64, "cols": _build.BLOCK_O, "split": split}
    return {"body": "stream", "rows": rows16, "cols": _build.BLOCK_O,
            "split": cluster_split(tiles, steps, FP8_STREAM16_BLOCKS_PER_SM)}


def kmajor_int8_plan(b: int, ke: int, o: int, n: int) -> dict:
    """``nm_spmm_gather_int8``'s (K11 int8) body, tile and split for ``Y_t
    (o, b) = gather(x_t (ke, b), idx)^T-contract values (ke * n / 4, o)``,
    int8, over the compressed contraction K_c = ke * n / 4.  n in {1, 2}:
    ``stream`` (the s8 form of ``csrc/nm_spmm_sp_fp8.cuh``'s K-major stream:
    the step's selected x_t rows landed by cp.async, the byte transpose
    pass, two ``mma.sync`` m16n8k32 s8 -> s32 a step, int32 partials, the
    ws-first flush into (O, B)) at every row count: over 64-channel tiles of
    16 rows, split by ``cluster_split`` at ``FP8_STREAM16_BLOCKS_PER_SM``
    blocks an SM, up to ``KMAJOR_STREAM_MAX_ROWS`` rows while a block of
    that split walks at most ``INT8_KMAJOR_STREAM16_MAX_STEPS`` 64-deep
    steps (internlm2-1.8b's two row-parallel sites on a (1, 2) mesh at B =
    32: 2 x 32 tiles, split 4); else over 64-row tiles split at
    ``BLOCKS_PER_SM``.  On an H100, 700 W (``tools/int8_body_sweep.py``,
    PERF.md §6) the stream beat gemm_int8.cu's first body at every swept
    shape, 32-1,024 rows at both local sites, n in {1, 2} (wo + w_out 2:4 at
    B = 32: 5.6 + 9.4 µs against 14.5 + 47.4), and this rule picked the
    fastest tile at every one of them (or one within 1%): the 16-row tiles
    lost where a block walks 16 or more steps (w_out 2:4 at 64 / 128 rows:
    13.4 / 21.1 against 11.4 / 16.1) and won where it walks 8 or fewer (wo
    2:4 at 256 rows: 9.7 against 10.8).  n = 4 keeps ``shared``
    (gemm_int8.cu's body, the form the port ran first) at ``block_rows(b)``
    rows, split 1.  The int32 sums are exact in any order: every body gives
    the plain version's bits, raw and scaled.  Returns ``{"body", "rows",
    "cols", "split"}``; ``rows`` is what the C interface takes as ``bm``."""
    if n not in (1, 2):
        return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O,
                "split": 1}
    rows16, rows64 = _build.BLOCK_ROWS
    steps, cols = ke * n // 4 // _build.BLOCK_K, o // _build.BLOCK_O
    split = cluster_split(cols * -(-b // rows16), steps, FP8_STREAM16_BLOCKS_PER_SM)
    if b <= KMAJOR_STREAM_MAX_ROWS and steps // split <= INT8_KMAJOR_STREAM16_MAX_STEPS:
        return {"body": "stream", "rows": rows16, "cols": _build.BLOCK_O, "split": split}
    return {"body": "stream", "rows": rows64, "cols": _build.BLOCK_O,
            "split": cluster_split(cols * -(-b // rows64), steps)}


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
    CUDA bodies ignore ``kmap``.  The body and split are
    :func:`masked_plan`'s, whose row block must be ``block_b`` (a CUDA
    launch refuses another): wherever K8 streams, K8's stream at K8's tile
    and split, each block walking the live steps of its span, so bitwise
    :func:`nm_spmm_gather_bk` on the same masked X (dead tiles add exact
    zeros); elsewhere the shared body, bitwise itself with every tile live,
    and :func:`nm_spmm_gather_bk` where that keeps the shared body too (n =
    4, n = 1 at 64-row tiles), within bf16 rounding of its own bodies (1:4
    up to 16 rows, the wgmma body from ``WGMMA_MIN_ROWS`` rows)."""
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
    p = masked_plan(b, ke, o, n)
    if bb != p["rows"]:
        raise ValueError(f"nm_spmm_gather_bk_masked: maps at {bb} rows, the plan's row "
                         f"block is {p['rows']}")
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_nm_spmm_gather_bk_masked(x.data_ptr(), values.data_ptr(), idx.data_ptr(),
                                             kmask.data_ptr(), _ptr(bias32), y.data_ptr(), b,
                                             ke, o, n, ACT_CODES[epi.act], bb,
                                             BODY_CODES[p["body"]], p["split"],
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
    # the singles run the body of their plans (block_b only checked; the fp8
    # wgmma plan's gather pass writes the compact X into a scratch); the
    # masked ones at their maps' row block, which must be the plan's
    if storage == torch.float8_e4m3fn and maps is None:
        p = fp8_plan(b, ke, o, n, requant=requant_scale is not None)
        xg = (torch.empty((b, values.shape[0]), dtype=storage, device=x_q.device)
              if p["body"] == "wgmma" else None)
        bb, plan = p["rows"], (BODY_CODES[p["body"]], p["cols"], p["split"], _ptr(xg))
    elif maps is None:
        p = int8_plan(b, ke, o, n)
        bb, plan = p["rows"], (BODY_CODES[p["body"]], p["split"])
    else:
        p = (masked_fp8_plan(b, ke, o, n, requant=requant_scale is not None)
             if storage == torch.float8_e4m3fn else masked_int8_plan(b, ke, o, n))
        if bb != p["rows"]:
            raise ValueError(f"{kernel}: maps at {bb} rows, the plan's row block is "
                             f"{p['rows']}")
        plan = (BODY_CODES[p["body"]], p["split"])
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_{kernel.removesuffix('_requant')}")(
            x_q.data_ptr(), values.data_ptr(), idx.data_ptr(), *(t.data_ptr() for t in kmask),
            _ptr(x_scale), _ptr(w_scale), _ptr(bias32), _ptr(requant_scale), y.data_ptr(), b,
            ke, o, n, ACT_CODES[epi.act], kind, bb, *plan, _build.stream_of(x_q))
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
    scales it returns the raw int32 accumulator.  The body, its tile and
    its K split are :func:`int8_plan`'s (``block_b`` only checked); every
    body gives the same bits."""
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
    flush; with no scales the raw fp32 accumulator.  ``block_b`` is the
    dispatch plan's row block (checked); the body, its tile and its K split
    are :func:`fp8_plan`'s."""
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
    :func:`nm_spmm_gather_bk_masked` (maps over the int8 rows at
    ``block_b`` rows and ``256 / n`` columns; the CUDA bodies ignore
    ``kmap``).  The body and split are :func:`masked_int8_plan`'s, whose
    row block must be ``block_b`` (a CUDA launch refuses another): at n in
    {1, 2} K8 int8's s8 gathered stream, each block walking the live steps
    of its span; at n = 4 the shared body, split 1.  Either way bitwise
    :func:`nm_spmm_gather_bk_int8` on the same masked rows; with
    ``requant_scale`` the flush requantizes, bitwise
    :func:`nm_spmm_gather_bk_int8_requant`'s codes."""
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
    :func:`nm_spmm_gather_bk_masked` (maps over the e4m3 rows at
    ``block_b`` rows and ``256 / n`` columns; the CUDA bodies ignore
    ``kmap``).  The body and split are :func:`masked_fp8_plan`'s, whose row
    block must be ``block_b`` (a CUDA launch refuses another): wherever
    :func:`fp8_plan` streams, K8 fp8's e4m3 gathered stream at its split,
    each block walking the live steps of its span, bitwise
    :func:`nm_spmm_gather_bk_fp8` on the same masked rows (with
    ``requant_scale``: bitwise :func:`nm_spmm_gather_bk_fp8_requant`'s
    codes); elsewhere (n = 4, :func:`fp8_plan`'s wgmma rows) the shared
    body, split 1, bitwise itself with every tile live, and
    :func:`nm_spmm_gather_bk_fp8` where that keeps the shared body too (n =
    4), else within the fp8 class's limit of it (its wgmma body sums in
    another order)."""
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
    # both classes run the body of their plans (block_b only checked)
    p = (fp8_dual_plan if storage == torch.float8_e4m3fn else int8_dual_plan)(b, ke, o, n)
    bb, plan = p["rows"], (BODY_CODES[p["body"]], p["split"])
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_nm_spmm_gather_dual_bk_{suffix}")(
            x_q.data_ptr(), values_g.data_ptr(), idx_g.data_ptr(), values_u.data_ptr(),
            idx_u.data_ptr(), x_scale.data_ptr(), wg_scale.data_ptr(), wu_scale.data_ptr(),
            _ptr(requant_scale), y.data_ptr(), b, ke, o, n, kind, bb, *plan,
            _build.stream_of(x_q))
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
    ``silu(deq(gather(Xq, idx_g) @ g)) * deq(gather(Xq, idx_u) @ u)``.  The
    body, its tile and its K split are :func:`int8_dual_plan`'s (``block_b``
    only checked); every body gives the same bits."""
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
    X read, two fp32 accumulators, flushed in the gather order (acc * ws *
    xs).  ``block_b`` is the dispatch plan's row block (checked); the body,
    its tile and its K split are :func:`fp8_dual_plan`'s."""
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
    linear's static scale; the body, its tile and its K split are
    :func:`fp8_dual_plan`'s, as :func:`nm_spmm_gather_dual_bk_fp8` takes them."""
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
    # both classes run the body of their plans (block_b only checked)
    p = (kmajor_fp8_plan if storage == torch.float8_e4m3fn else kmajor_int8_plan)(b, ke, o, n)
    bb, plan = p["rows"], (BODY_CODES[p["body"]], p["split"])
    lib = _build.library(source)
    with torch.cuda.device(x_t.device):
        rc = getattr(lib, f"vg_{kernel}")(
            x_t.data_ptr(), values.data_ptr(), idx.data_ptr(), _ptr(x_scale), _ptr(w_scale),
            y_t.data_ptr(), b, ke, o, n, kind, bb, *plan, _build.stream_of(x_t))
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
    accumulator.  The body, its tile and its K split are
    :func:`kmajor_int8_plan`'s (``block_b`` only checked); every body gives
    the same bits."""
    return _gather_t_quantized(nm_spmm_gather_int8, torch.int8, x_t, values, idx, x_scale,
                               w_scale, n, out_dtype, block_b)


nm_spmm_gather_int8.launches = 0


def nm_spmm_gather_fp8(x_t: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                       x_scale: Optional[torch.Tensor], w_scale: Optional[torch.Tensor],
                       n: int, *, out_dtype: torch.dtype = torch.float32,
                       block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`nm_spmm_gather_int8`'s contract over float8_e4m3fn codes: an
    fp32 accumulator, the raw fp32 (O, B) one with no scales, flushed
    ``acc * w_scale * x_scale``.  ``block_b`` is the dispatch plan's row
    block (checked); the body, its tile and its K split are
    :func:`kmajor_fp8_plan`'s."""
    return _gather_t_quantized(nm_spmm_gather_fp8, torch.float8_e4m3fn, x_t, values, idx,
                               x_scale, w_scale, n, out_dtype, block_b)


nm_spmm_gather_fp8.launches = 0
