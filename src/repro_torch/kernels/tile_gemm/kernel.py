"""Dense tile GEMM on Hopper: ``tile_gemm`` and the fused gate-up
``tile_gemm_dual`` (CUDA source: ``kernels/csrc/gemm.cu``); their int8
twins ``tile_gemm_int8`` and ``tile_gemm_dual_int8``
(``kernels/csrc/gemm_int8.cu``) and fp8 (e4m3) twins ``tile_gemm_fp8``
and ``tile_gemm_dual_fp8`` (``kernels/csrc/gemm_fp8.cu``); and
``tile_gemm_dual_int8_requant`` / ``tile_gemm_dual_fp8_requant``, the
quantized duals whose flush requantizes their output to the class's
narrow dtype against the next linear's static activation scale, and
``tile_gemm_int8_requant`` / ``tile_gemm_fp8_requant``, the single GEMMs
with that flush (K0's remainder: the gelu MLP's ``w_in``).  K10:
``tile_gemm_masked`` and its int8 and fp8 twins, ``tile_gemm_masked_int8``
and ``tile_gemm_masked_fp8``, the single GEMMs with the activation-sparsity
block skip (one source each, the same kernel bodies with ``MASKED``; the
bf16 one below ``WGMMA_MIN_ROWS`` rows K1's stream in ``MASKED`` form, as
:func:`masked_plan` picks, the fp8 one ``tile_gemm_fp8``'s e4m3 stream
in ``MASKED`` form wherever :func:`fp8_plan` streams, as
:func:`masked_fp8_plan` picks, and the int8 one ``tile_gemm_int8``'s s8
stream in ``MASKED`` form at its maps' row block, as
:func:`masked_int8_plan` picks).

``tile_gemm`` (bf16) runs one of two bodies of its own, chosen by
:func:`plan` from ``(B, K, O)``: at few rows (decode, the engine's prefill
chunks) the streaming body of ``csrc/nm_spmm_sp.cuh`` over the dense
weight, its K loop split over a cluster; from the calibration forward's
256 rows up the warp-specialised TMA + wgmma body of
``csrc/tile_gemm_sm90.cuh``.  ``tile_gemm_dual`` (bf16) runs the dual
forms of the same two, chosen by :func:`dual_plan`: both weights' tiles
in each stage, two accumulators, one silu_mul flush.  ``tile_gemm_fp8`` and
``tile_gemm_fp8_requant`` run the e4m3 forms of the same two, chosen by
:func:`fp8_plan`: ``csrc/nm_spmm_sp_fp8.cuh``'s stream over the dense
weight and ``csrc/tile_gemm_sm90_fp8.cuh``'s wgmma body, whose weight tile
is transposed on chip.  ``tile_gemm_dual_fp8`` and
``tile_gemm_dual_fp8_requant`` run the dual forms of those two, chosen by
:func:`fp8_dual_plan` (the wgmma one never for the requantized codes).
``tile_gemm_int8`` and ``tile_gemm_int8_requant`` run the s8 form of that
dense stream, chosen by :func:`int8_plan`, and ``tile_gemm_dual_int8`` and
``tile_gemm_dual_int8_requant`` its s8 dual form, chosen by
:func:`int8_dual_plan`.
Every other kernel here runs the shared bodies of ``gemm.cu`` /
``gemm_int8.cu`` / ``gemm_fp8.cu`` (the masked ones where their plans
leave the stream).

Replaces ``repro/kernels/tile_gemm/kernel.py::tile_gemm`` (:82),
``::tile_gemm_dual`` (:382, float, int8 and fp8 branches), ``::tile_gemm_int8``
(:448) and ``::tile_gemm_fp8`` (:482), and ``::tile_gemm_masked`` (:252,
float and scaled-quantized), the quantized ones each with the
``requant:<dtype>`` flush of ``repro/kernels/epilogue.py::flush_tile``
(:162, ``requant_rows`` :143).  On CUDA tensors each wrapper launches its
kernel or raises; on CPU tensors it returns the plain version from
``ref.py`` (the counterpart of the JAX package's interpret mode).  Each
wrapper counts its launches in a plain integer attribute, ``.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..epilogue import EpilogueSpec
from ..reasons import dtype_name
from .ref import (tile_gemm_dual_quantized_ref, tile_gemm_dual_ref,
                  tile_gemm_masked_quantized_ref, tile_gemm_masked_ref,
                  tile_gemm_quantized_ref, tile_gemm_ref, with_requant)

__all__ = ["tile_gemm", "plan", "fp8_plan", "int8_plan", "dual_plan", "fp8_dual_plan",
           "int8_dual_plan", "cluster_split",
           "stream_plan", "masked_plan", "masked_fp8_plan", "masked_int8_plan", "BODY_CODES",
           "WGMMA_MIN_ROWS", "WIDE_MIN_ROWS", "WIDE_MIN_COLS",
           "FP8_WGMMA_COLS", "DUAL_WGMMA_COLS", "DUAL_STREAM_MIN_SPLIT", "FP8_SHARED_TILES",
           "FP8_STREAM16_BLOCKS_PER_SM", "FP8_DUAL_WGMMA_COLS", "INT8_STREAM16_MAX_STEPS",
           "INT8_DENSE_DUAL_STREAM16_MAX_ROWS",
           "tile_gemm_dual", "tile_gemm_int8", "tile_gemm_int8_requant", "tile_gemm_dual_int8",
           "tile_gemm_dual_int8_requant", "tile_gemm_fp8", "tile_gemm_fp8_requant",
           "tile_gemm_dual_fp8", "tile_gemm_dual_fp8_requant", "tile_gemm_masked",
           "tile_gemm_masked_int8", "tile_gemm_masked_fp8", "ACT_CODES"]

#: epilogue activation -> the C interface's act argument
ACT_CODES = {None: 0, "silu": 1, "gelu": 2}

#: streaming multiprocessors of the H100 the plans are made for
SMS = 132
#: blocks of a streaming body (csrc/nm_spmm_sp.cuh, csrc/nm_spmm_sp_fp8.cuh)
#: that share an SM (rings and inbox ~34-90 KB of shared memory)
BLOCKS_PER_SM = 2
#: the streaming bodies' largest cluster (a portable cluster size)
MAX_SPLIT = 8
#: rows of the wgmma body's tile (csrc/tile_gemm_sm90.cuh)
WGMMA_ROWS = 128
#: channels of the wgmma body's tile
WGMMA_COLS = (128, 256)
#: the fewest rows the wgmma body takes: from the calibration forward's 8 x
#: 32 up it beat the streaming body at every internlm2-1.8b site on an H100
#: (one 128 x 128 tile an SM outruns four 64-row streaming blocks)
WGMMA_MIN_ROWS = 256
#: the fewest rows and channels for the 128 x 256 tile: on an H100 it beat
#: 128 x 128 at hubert-xlarge's (1280, 5120) site and phi-3-vision's (8192,
#: 3072), tied at phi-3's other two (half the tiles: a round less of the
#: body's fixed cost), and lost at hubert's two O = 1280 sites and at 256
#: rows (16-32 wide tiles leave most SMs idle)
WIDE_MIN_ROWS = 1024
WIDE_MIN_COLS = 3072
#: channels of the e4m3 wgmma body's tile (csrc/tile_gemm_sm90_fp8.cuh): its
#: second, promoting accumulator leaves no registers for 256
FP8_WGMMA_COLS = 128
#: channels of the dual wgmma body's output tile: each consumer warpgroup
#: holds a 64 x 128 accumulator of each weight, K1's 128 x 256 tile's registers
DUAL_WGMMA_COLS = 128
#: below ``WGMMA_MIN_ROWS`` the dual plans keep a 64-row stream only where
#: :func:`stream_plan` splits its K loop this many ways or more: on an H100
#: (``chip_smoke.py``'s dual sweep phase) it beat the dual wgmma body at
#: qwen3-moe's expert gate-up (4096, 1536) at 17-64 rows (split 4) and lost
#: to it unsplit at internlm2-1.8b's and phi-3-vision's gate-up
DUAL_STREAM_MIN_SPLIT = 4
#: the e4m3 streams' 16-row tiles (csrc/nm_spmm_sp_fp8.cuh: ~45-67 KB a
#: block) that share an SM when a plan runs them over several row tiles
FP8_STREAM16_BLOCKS_PER_SM = 3
#: channels of each weight in the e4m3 dual wgmma body's output tile
#: (csrc/tile_gemm_sm90_fp8.cuh, DUAL): 128 of each would need 384
#: registers a consumer thread
FP8_DUAL_WGMMA_COLS = 64
#: the s8 streams keep 16-row tiles past 16 rows (up to 64) while a block
#: of their split walks at most this many 64-deep steps: on an H100 they won
#: at 18 steps (gemma3-1b's w_in) and lost at 32 (internlm2-1.8b's w_out at
#: 33-64 rows)
INT8_STREAM16_MAX_STEPS = 24
#: the dense int8 dual runs its 16-row stream up to this many rows (three
#: row tiles), its 64-row one above
INT8_DENSE_DUAL_STREAM16_MAX_ROWS = 48
#: the planners' bodies -> the C interface's ``body`` argument
BODY_CODES = {"shared": 0, "stream": 1, "wgmma": 2}
#: the shared body's launch width (O / 64 tiles x row tiles) from which the
#: e4m3 singles stay on it above 16 rows: on an H100 the streaming bodies
#: (nm_spmm_fp8's sparse one, tile_gemm_fp8's dense one) won at
#: internlm2-1.8b's 64-row chunks (16-32 tiles) and lost at 256 rows (64-128
#: tiles) and at gemma3-1b's 64-row w_in (108 tiles)
FP8_SHARED_TILES = 64


def cluster_split(tiles: int, steps: int, per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks of one cluster that share the K loop (``steps`` 64-deep
    steps) of an output tile, when the launch has ``tiles`` output tiles:
    the largest power of two up to ``MAX_SPLIT`` and ``steps`` with tiles
    x split <= ``per_sm`` x ``SMS``.  Block r takes steps [r * steps //
    split, (r + 1) * steps // split)."""
    split = 1
    while 2 * split <= min(MAX_SPLIT, steps) and 2 * split * tiles <= per_sm * SMS:
        split *= 2
    return split


def plan(b: int, k: int, o: int) -> dict:
    """K1's body, tile and split for ``X (b, k) @ W (k, o)``.

    ``wgmma`` (``csrc/tile_gemm_sm90.cuh``), from ``WGMMA_MIN_ROWS`` rows
    (the calibration forward, hubert-xlarge's 4,000 prefill rows,
    phi-3-vision's 1,024): a persistent, warp-specialised wgmma GEMM over
    128-row tiles of 128 channels, or of 256 from ``WIDE_MIN_ROWS`` rows and
    ``WIDE_MIN_COLS`` channels; split 1.  ``stream`` (``csrc/nm_spmm_sp.cuh`` over the
    dense weight), below: 64-channel tiles of ``block_rows(b)`` rows (16 at
    decode, 64 above), the K loop split over a cluster by
    :func:`cluster_split` so a launch fills the card: two blocks an SM at
    decode (internlm2-1.8b at B = 8: q, o and w_out 32 x 8 blocks, k and v
    16 x 8), one at the 64-row tile (its deeper split was slower on an
    H100).  Returns ``{"body", "rows", "cols", "split"}``; ``rows`` is what
    the C interface takes as ``bm``."""
    if b >= WGMMA_MIN_ROWS:
        cols = WGMMA_COLS[b >= WIDE_MIN_ROWS and o >= WIDE_MIN_COLS]
        return {"body": "wgmma", "rows": WGMMA_ROWS, "cols": cols, "split": 1}
    return stream_plan(b, k, o)


def masked_plan(b: int, k: int, o: int) -> dict:
    """``tile_gemm_masked``'s (bf16) body, tile and split: :func:`plan`'s
    ``stream`` wherever K1 streams (below ``WGMMA_MIN_ROWS`` rows), the
    masked form of that stream at its tile and split (each block walks
    the live steps of its span: bitwise K1 on the same masked X); from
    ``WGMMA_MIN_ROWS`` rows, where K1 runs its wgmma body, ``shared``
    (gemm.cu's masked body, the form the port ran first) at
    ``block_rows(b)`` rows, split 1.  Returns ``{"body", "rows", "cols",
    "split"}``; ``rows`` is the maps' row block."""
    p = plan(b, k, o)
    if p["body"] == "stream":
        return p
    return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O, "split": 1}


def stream_plan(b: int, k: int, o: int) -> dict:
    """A streaming body's tile and split for ``b`` rows against a ``(k,
    o)`` weight (``k`` the contraction): 64-channel tiles of
    ``block_rows(b)`` rows, the K loop split over a cluster by
    :func:`cluster_split`, two blocks an SM at 16 rows, one at 64."""
    rows = _build.block_rows(b)
    tiles = (o // _build.BLOCK_O) * -(-b // rows)
    return {"body": "stream", "rows": rows, "cols": _build.BLOCK_O,
            "split": cluster_split(tiles, k // _build.BLOCK_K, 2 if rows == 16 else 1)}


def fp8_plan(b: int, k: int, o: int, requant: bool = False) -> dict:
    """``tile_gemm_fp8``'s body, tile and split for ``Xq (b, k) @ Wq (k,
    o)``, as :func:`plan` picks K1's: ``wgmma`` (``csrc/
    tile_gemm_sm90_fp8.cuh``) from ``WGMMA_MIN_ROWS`` rows, 128 x 128
    tiles, split 1; below, ``stream`` (``csrc/nm_spmm_sp_fp8.cuh`` over the
    dense weight) with :func:`stream_plan`'s tile and split, or ``shared``
    (gemm_fp8.cu's body, the form the port ran first; split 1) where its
    64-row launch is ``FP8_SHARED_TILES`` tiles wide or more.  ``requant``
    (``tile_gemm_fp8_requant``, e4m3 codes out) never takes ``wgmma``: its
    tensor cores' e4m3 sums are ~1e-4 of max|Y| off the plain version's
    fp32 sums on an H100 (the ``mma.sync`` bodies ~1e-7), which moves
    codes near zero by more than the one e4m3 step the requant gate
    allows.  Returns ``{"body", "rows", "cols", "split"}``."""
    if b >= WGMMA_MIN_ROWS and not requant:
        return {"body": "wgmma", "rows": WGMMA_ROWS, "cols": FP8_WGMMA_COLS, "split": 1}
    p = stream_plan(b, k, o)
    if p["rows"] == _build.BLOCK_ROWS[1] and \
            (o // _build.BLOCK_O) * -(-b // p["rows"]) >= FP8_SHARED_TILES:
        return {**p, "body": "shared", "split": 1}
    return p


def int8_plan(b: int, k: int, o: int) -> dict:
    """``tile_gemm_int8``'s (and ``_requant``'s) body, tile and split for
    ``Xq (b, k) @ Wq (k, o)`` (K8 int8's over its K_c): ``stream`` (the s8
    form of ``csrc/nm_spmm_sp_fp8.cuh``'s dense stream, two ``mma.sync``
    m16n8k32 s8 -> s32 a step, int32 partials summed in rank order) at
    every row count, over 64-channel tiles of 16 rows, the K loop split by
    :func:`cluster_split` at ``FP8_STREAM16_BLOCKS_PER_SM`` blocks an SM,
    up to 16 rows, and up to 64 while a block of that split walks at most
    ``INT8_STREAM16_MAX_STEPS`` 64-deep steps; else over 64-row tiles split
    at ``BLOCKS_PER_SM`` blocks an SM.  On an H100, 700 W
    (``tools/int8_body_sweep.py``, PERF.md §6) it beat gemm_int8.cu's
    first body at every swept shape, 8-4,000 rows at internlm2-1.8b's sites
    and gemma3-1b's w_in: w_out (8192, 2048) at 8 / 64 / 256 / 4,000 rows
    10.8 / 19.3 / 49.3 / 470 µs against 81.0 / 101.1 / 99.5 / 1,352; the
    16-row tiles won where a block walks few steps (gemma3-1b's w_in at
    17-64 rows, 18 steps: 10.7-14.1 against the 64-row tiles' 13.1-15.2)
    and lost where it walks many (w_out at 64 rows, 64 steps: 28.5 against
    19.3); the 64-row tiles at two blocks an SM beat one (w_out at 256
    rows 49.3 against 82.0).  The int32 sums are exact in any order, so
    every body gives the plain version's bits and the requantized codes
    need no plan of their own.  ``tile_gemm_masked_int8`` takes this plan
    where its rows are the maps' row block (:func:`masked_int8_plan`).
    Returns ``{"body", "rows", "cols", "split"}``."""
    rows16, rows64 = _build.BLOCK_ROWS
    steps, cols = k // _build.BLOCK_K, o // _build.BLOCK_O
    split = cluster_split(cols * -(-b // rows16), steps, FP8_STREAM16_BLOCKS_PER_SM)
    if b <= rows16 or (b <= rows64 and steps // split <= INT8_STREAM16_MAX_STEPS):
        return {"body": "stream", "rows": rows16, "cols": _build.BLOCK_O, "split": split}
    return {"body": "stream", "rows": rows64, "cols": _build.BLOCK_O,
            "split": cluster_split(cols * -(-b // rows64), steps)}


def int8_dual_plan(b: int, k: int, o: int) -> dict:
    """``tile_gemm_dual_int8``'s (and ``_requant``'s) body, tile and split
    for ``silu(deq(Xq (b, k) @ Wg)) * deq(Xq @ Wu)``, both int8 weights
    ``(k, o)``: ``stream`` (the s8 form of ``csrc/nm_spmm_sp_fp8.cuh``'s
    dense DUAL stream: both weights' tiles a stage, two ``mma.sync``
    m16n8k32 s8 -> s32 a step a weight into two int32 accumulator sets, both
    partial planes summed in rank order, gemm_int8.cu's
    ``DualFlushI8T<false>``) at every row count: over 64-channel tiles of 16
    rows up to ``INT8_DENSE_DUAL_STREAM16_MAX_ROWS`` rows, the K loop split
    by :func:`cluster_split` at ``FP8_STREAM16_BLOCKS_PER_SM`` blocks an SM
    (internlm2-1.8b's gate-up (2048, 8192) at B = 8: 128 tiles, split 2;
    qwen3-moe's expert (4096, 1536): 24 tiles, split 8); above, over 64-row
    tiles split at ``BLOCKS_PER_SM``.  On an H100, 700 W
    (``tools/int8_body_sweep.py``, PERF.md §6) the stream
    beat gemm_int8.cu's first body at every swept shape, 1-256 rows at both
    pairs: internlm2-1.8b at 8 / 64 / 256 rows 18.2 / 26.6 / 56.5 µs against
    33.6 / 46.4 / 149.8, the expert 9.5 / 16.0 / 40.5 against 61.6 / 81.8 /
    81.8.  The 16-row tiles beat the 64-row ones over 17-33 rows at
    internlm2-1.8b (23.0-26.1 against 24.3-26.6 µs) and 17-48 at the expert
    (11.7-15.1 against 15.8), and lost at internlm2-1.8b's 48 rows (27.5
    against 26.6) and at 64 at both; three 16-row blocks an SM beat two at
    the expert over 17-48 rows (11.7 against 14.1 at 17), two 64-row blocks
    an SM beat one there from 65 rows (23.4 against 36.3).  The int32 sums
    are exact in any order and the flush repeats the first body's fp32
    operations: every body gives the same bits, requantized codes included.
    Returns ``{"body", "rows", "cols", "split"}``; ``rows`` is what the C
    interface takes as ``bm``."""
    rows16, rows64 = _build.BLOCK_ROWS
    steps, cols = k // _build.BLOCK_K, o // _build.BLOCK_O
    if b <= INT8_DENSE_DUAL_STREAM16_MAX_ROWS:
        return {"body": "stream", "rows": rows16, "cols": _build.BLOCK_O,
                "split": cluster_split(cols * -(-b // rows16), steps,
                                       FP8_STREAM16_BLOCKS_PER_SM)}
    return {"body": "stream", "rows": rows64, "cols": _build.BLOCK_O,
            "split": cluster_split(cols * -(-b // rows64), steps)}


def masked_int8_plan(b: int, k: int, o: int) -> dict:
    """``tile_gemm_masked_int8``'s (and its requantizing form's) body, tile
    and split: ``stream`` (the s8 form of ``csrc/nm_spmm_sp_fp8.cuh``'s
    dense stream in ``MASKED`` form: each block walks the live steps of
    its span) over ``block_rows(b)``-row tiles, the row block of the maps
    dispatch builds, which the masked stream reads at ``blockIdx.y``.
    That is :func:`int8_plan`'s plan wherever its rows are
    ``block_rows(b)`` (up to 16 rows; from 65; at 17-64 where a 16-row
    block would walk more than ``INT8_STREAM16_MAX_STEPS`` steps); else
    (17-64 rows over few steps, qwen3-moe's expert w_out at 64 rows: 24
    steps) the 64-row stream, the K loop split by :func:`cluster_split` at
    ``BLOCKS_PER_SM`` blocks an SM, as :func:`int8_plan` splits its 64-row
    tiles.  On an H100, 700 W (``tools/int8_body_sweep.py --kernels
    tmask``, PERF.md §6) it beat gemm_int8.cu's first body at every swept
    launch with a live step, 1-256 rows at the expert's w_out and
    internlm2-1.8b's: the expert at B = 8 and ~0.4 live 6.27 against 10.91
    µs, at 64 rows 10.53 against 18.98, internlm2-1.8b's at 64 rows 15.37
    against 63.14; a launch with no live step costs it 3.7-4.1 µs at 16
    rows and 6.7-8.4 at 64 against the first body's 2.1-3.2 / 4.2-7.6 (the
    split's finish, PERF.md §7).  16-row tiles would be faster at 17-64
    rows (8.99 against 10.53 at the expert's 64 rows), but the maps are
    dispatch's, at ``block_rows(b)`` rows.  The int32 sums are exact in any
    order, so every tile and split is bitwise ``tile_gemm_int8`` (and
    ``tile_gemm_int8_requant``'s codes) on the same masked X.  Returns
    ``{"body", "rows", "cols", "split"}``; ``rows`` is the maps' row
    block."""
    p = int8_plan(b, k, o)
    rows = _build.block_rows(b)
    if p["rows"] == rows:
        return p
    per_sm = FP8_STREAM16_BLOCKS_PER_SM if rows == _build.BLOCK_ROWS[0] else BLOCKS_PER_SM
    return {"body": "stream", "rows": rows, "cols": _build.BLOCK_O,
            "split": cluster_split((o // _build.BLOCK_O) * -(-b // rows), k // _build.BLOCK_K,
                                   per_sm)}


def masked_fp8_plan(b: int, k: int, o: int, requant: bool = False) -> dict:
    """``tile_gemm_masked_fp8``'s body, tile and split: :func:`fp8_plan`'s
    ``stream`` (``requant`` as there) wherever ``tile_gemm_fp8`` streams, in
    ``MASKED`` form at its tile and split (each block walks the live steps
    of its span: bitwise ``tile_gemm_fp8`` and its requantized codes on the
    same masked X); else ``shared`` (gemm_fp8.cu's masked body, the form
    the port ran first) at ``block_rows(b)`` rows, split 1: from
    ``WGMMA_MIN_ROWS`` rows (``wgmma``) and at 64-row launches of
    ``FP8_SHARED_TILES`` tiles or more.  Returns ``{"body", "rows", "cols",
    "split"}``; ``rows`` is the maps' row block."""
    p = fp8_plan(b, k, o, requant)
    if p["body"] == "stream":
        return p
    return {"body": "shared", "rows": _build.block_rows(b), "cols": _build.BLOCK_O, "split": 1}


def dual_plan(b: int, k: int, o: int) -> dict:
    """``tile_gemm_dual``'s (float) body, tile and split for ``silu(X (b,
    k) @ Wg) * (X @ Wu)``, both weights ``(k, o)``: ``wgmma`` (``csrc/
    tile_gemm_sm90.cuh``'s dual form: both weights' tiles in one stage,
    two accumulators, the silu_mul flush in registers) from
    ``WGMMA_MIN_ROWS`` rows, and at 64-row tiles (17-255 rows) where
    :func:`stream_plan` splits K fewer than ``DUAL_STREAM_MIN_SPLIT`` ways;
    128 x 128 output tiles, split 1.  Else ``stream`` (``csrc/
    nm_spmm_sp.cuh``'s dual form over both dense weights) with
    :func:`stream_plan`'s tile and split: every decode launch (16-row
    tiles; internlm2-1.8b's gate-up at B = 8: 128 tiles, split 2, two
    blocks an SM).  On an H100 (``chip_smoke.py``'s dual sweep phase,
    17-128 rows; PERF.md §6) the plan's body was the fastest of the three
    at every swept shape; at qwen3-moe's expert gate-up at 128 rows the
    stream's split 2 and the wgmma body come within a few percent of each
    other, in either order from run to run.  Returns ``{"body", "rows",
    "cols", "split"}``; ``rows`` is what the C interface takes as
    ``bm``."""
    p = stream_plan(b, k, o)
    if b >= WGMMA_MIN_ROWS or \
            (p["rows"] == _build.BLOCK_ROWS[1] and p["split"] < DUAL_STREAM_MIN_SPLIT):
        return {"body": "wgmma", "rows": WGMMA_ROWS, "cols": DUAL_WGMMA_COLS, "split": 1}
    return p


def fp8_dual_plan(b: int, k: int, o: int, requant: bool = False) -> dict:
    """``tile_gemm_dual_fp8``'s (and ``_requant``'s) body, tile and split for
    ``silu(Xq (b, k) @ Wg) * (Xq @ Wu)``, both e4m3 weights ``(k, o)``.

    ``stream`` (``csrc/nm_spmm_sp_fp8.cuh``'s dual stream over both dense
    weights, N = 4) over 64-channel tiles of 16 rows, the K loop split by
    :func:`cluster_split` at ``FP8_STREAM16_BLOCKS_PER_SM`` blocks an SM: up
    to 16 rows (internlm2-1.8b's gate-up at B = 8: 128 tiles, split 2;
    qwen3-moe's expert gate-up: 24 tiles, split 8), and below
    ``WGMMA_MIN_ROWS`` where it splits K ``DUAL_STREAM_MIN_SPLIT`` ways or
    more (qwen3-moe at 17-64 rows).  ``wgmma`` (``csrc/
    tile_gemm_sm90_fp8.cuh``'s dual form: 128 rows x ``FP8_DUAL_WGMMA_COLS``
    channels of each weight, split 1) otherwise: internlm2-1.8b from 17
    rows, where one 128-row tile a channel tile beat both streams and the
    shared body on an H100, qwen3-moe from 65 (development timings of each body
    at 8-256 rows; ``chip_smoke.py``'s fp8 sweep phase re-times the bodies
    at 17-128 rows every run).  ``requant`` (e4m3 codes out) never takes
    ``wgmma`` (its 128-deep e4m3 sums move codes by more than one step, see
    :func:`fp8_plan`): where the plan would, it takes the 16-row stream while
    its launch has at most ``FP8_STREAM16_BLOCKS_PER_SM`` x ``SMS`` tiles,
    then ``shared`` (gemm_fp8.cu's body, the form the port ran first; split
    1): internlm2-1.8b's gate-up from 49 rows and qwen3-moe's from 265 (the
    shared body beat the 16-row stream at internlm2-1.8b from 64 rows, and
    came close to the 64-row one).  Returns ``{"body", "rows", "cols",
    "split"}``; ``rows`` is what the C interface takes as ``bm``."""
    rows16 = _build.BLOCK_ROWS[0]
    tiles = (o // _build.BLOCK_O) * -(-b // rows16)
    split = cluster_split(tiles, k // _build.BLOCK_K, FP8_STREAM16_BLOCKS_PER_SM)
    stream = {"body": "stream", "rows": rows16, "cols": _build.BLOCK_O, "split": split}
    if b <= rows16 or (b < WGMMA_MIN_ROWS and split >= DUAL_STREAM_MIN_SPLIT):
        return stream
    if not requant:
        return {"body": "wgmma", "rows": WGMMA_ROWS, "cols": FP8_DUAL_WGMMA_COLS, "split": 1}
    if tiles <= FP8_STREAM16_BLOCKS_PER_SM * SMS:
        return stream
    return {"body": "shared", "rows": _build.BLOCK_ROWS[1], "cols": _build.BLOCK_O, "split": 1}


def check_single_epilogue(kernel: str, epi: EpilogueSpec,
                          bias: Optional[torch.Tensor], o: int,
                          requant_scale: Optional[torch.Tensor] = None) -> None:
    """A single GEMM's lattice point: ``(+ bias) -> (silu | gelu) ->
    (requant:<dtype>)``, the requantize with the consumer's scale
    (:func:`check_requant_scale`) exactly when the point asks for it."""
    if epi.act == "silu_mul":
        raise ValueError(f"{kernel}: epilogue {epi.point!r} is not a "
                         f"single-GEMM lattice point")
    if (epi.requant is not None) != (requant_scale is not None):
        raise ValueError(f"{kernel}: epilogue {epi.point!r} takes the consumer's scale "
                         f"(requant_scale) exactly when it requantizes; the quantized "
                         f"*_requant and masked kernels requantize")
    if requant_scale is not None:
        check_requant_scale(kernel, requant_scale)
    if epi.bias != (bias is not None):
        raise ValueError(f"{kernel}: bias operand must match the epilogue spec")
    if bias is not None and bias.numel() != o:
        raise ValueError(f"{kernel}: bias must be ({o},), got {tuple(bias.shape)}")


def float_out(kernel: str, x: torch.Tensor, out_dtype: Optional[torch.dtype]):
    """The float kernels store X's dtype (bf16) or fp32: ``(dtype, out_f32
    flag of the C interface)``."""
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"{kernel}: the kernel stores {x.dtype} or float32, not {out_dtype}")
    return out_dtype, int(out_dtype == torch.float32)


def tile_gemm(x: torch.Tensor, w: torch.Tensor, *,
              epilogue: Optional[EpilogueSpec] = None,
              bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None,
              block_b: Optional[int] = None) -> torch.Tensor:
    """``Y (B, O) = epilogue(X (B, K) @ W (K, O))`` in X's dtype, or in
    ``out_dtype=torch.float32`` (the sums a row-parallel shard all-reduces).
    ``block_b`` is the dispatch plan's row block (checked); the body, its
    tile and its K split are :func:`plan`'s."""
    epi = epilogue or EpilogueSpec()
    b, k = x.shape
    k2, o = w.shape
    if k != k2:
        raise ValueError(f"tile_gemm: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    check_single_epilogue("tile_gemm", epi, bias, o)
    out_dtype, out_f32 = float_out("tile_gemm", x, out_dtype)
    if x.device.type == "cpu":
        return tile_gemm_ref(x, w, epilogue=epi, bias=bias, out_dtype=out_dtype)
    bb = block_b or _build.block_rows(b)
    bias32 = None if bias is None else bias.float().contiguous()
    extra = () if bias32 is None else (bias32,)
    _build.check_operands("tile_gemm", x, w, *extra, block_b=bb)
    if w.dtype != x.dtype:
        raise ValueError(f"tile_gemm: w is {w.dtype}, x is {x.dtype}")
    _build.check_tiles("tile_gemm", k, o)
    y = torch.empty((b, o), dtype=out_dtype, device=x.device)
    p = plan(b, k, o)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_tile_gemm(x.data_ptr(), w.data_ptr(),
                              None if bias32 is None else bias32.data_ptr(),
                              y.data_ptr(), b, k, o, ACT_CODES[epi.act], out_f32, p["rows"],
                              p["cols"], p["split"], _build.stream_of(x))
    tile_gemm.launches += 1
    _build.check(rc, "tile_gemm", lib)
    return y


tile_gemm.launches = 0


def check_maps(kernel: str, kmap: torch.Tensor, kmask: torch.Tensor, b: int, k: int,
               block_b: int, step_cols: int = _build.BLOCK_K) -> None:
    """The masked kernels' skip maps: ``block_maps`` at the kernel's own
    blocks, ``(ceil(B / block_b), k / 64)`` int32 (``k`` the contraction
    the weight rows run over; ``step_cols`` the activation columns of one
    K step).  Maps made at any other block are refused, not re-blocked."""
    want = (-(-b // block_b), k // _build.BLOCK_K)
    for name, t in (("kmap", kmap), ("kmask", kmask)):
        if tuple(t.shape) != want or t.dtype != torch.int32:
            raise ValueError(
                f"{kernel}: {name} must be int32 {want}, block_maps at the kernel's blocks "
                f"({block_b} rows, {step_cols} activation columns per K step); got "
                f"{t.dtype} {tuple(t.shape)}")


def tile_gemm_masked(x: torch.Tensor, w: torch.Tensor, kmap: torch.Tensor,
                     kmask: torch.Tensor, *, epilogue: Optional[EpilogueSpec] = None,
                     bias: Optional[torch.Tensor] = None,
                     block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_gemm` with the activation-sparsity block skip: only the
    (row block, K step) tiles ``kmask`` marks live are loaded and
    multiplied.  ``kmap`` / ``kmask`` are ``actsparse.block_maps`` over the
    masked X at ``block_b`` rows (``block_rows(B)`` by default) and 64
    columns; the CUDA bodies branch on ``kmask`` alone and ignore ``kmap``
    (the TPU kernel's copy re-addressing), which they take so that the
    signature stays the JAX package's.  The body and split are
    :func:`masked_plan`'s: below ``WGMMA_MIN_ROWS`` rows K1's stream at K1's
    split, each block walking the live steps of its span, so bitwise
    :func:`tile_gemm` on the same masked X (dead tiles add exact zeros);
    from ``WGMMA_MIN_ROWS`` rows the shared body, bitwise itself with every
    tile live and within bf16 rounding of :func:`tile_gemm`, whose wgmma
    body sums in another order."""
    epi = epilogue or EpilogueSpec()
    b, k = x.shape
    k2, o = w.shape
    if k != k2:
        raise ValueError(f"tile_gemm_masked: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    check_single_epilogue("tile_gemm_masked", epi, bias, o)
    bb = block_b or _build.block_rows(b)
    check_maps("tile_gemm_masked", kmap, kmask, b, k, bb)
    if x.device.type == "cpu":
        return tile_gemm_masked_ref(x, w, kmap, kmask, block_b=bb, epilogue=epi, bias=bias)
    bias32 = None if bias is None else bias.float().contiguous()
    extra = () if bias32 is None else (bias32,)
    _build.check_operands("tile_gemm_masked", x, w, kmask, *extra, block_b=bb)
    if w.dtype != x.dtype:
        raise ValueError(f"tile_gemm_masked: w is {w.dtype}, x is {x.dtype}")
    _build.check_tiles("tile_gemm_masked", k, o)
    y = torch.empty((b, o), dtype=x.dtype, device=x.device)
    p = masked_plan(b, k, o)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_tile_gemm_masked(x.data_ptr(), w.data_ptr(), kmask.data_ptr(),
                                     _ptr(bias32), y.data_ptr(), b, k, o, ACT_CODES[epi.act],
                                     bb, BODY_CODES[p["body"]], p["split"],
                                     _build.stream_of(x))
    tile_gemm_masked.launches += 1
    _build.check(rc, "tile_gemm_masked", lib)
    return y


tile_gemm_masked.launches = 0


def check_scales(kernel: str, b: int, o: int, x_scale: Optional[torch.Tensor],
                 *w_scales: Optional[torch.Tensor]) -> bool:
    """The quantized kernels' scale operands: ``x_scale (B, 1)`` and each
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


def requant_spec(kernel: str, epi: Optional[EpilogueSpec], storage: torch.dtype,
                 requant_scale: Optional[torch.Tensor]) -> EpilogueSpec:
    """The lattice point a quantized single GEMM runs: ``epi`` as given,
    or, with ``requant_scale``, ``epi`` extended with the class's own
    ``requant:<dtype>`` (the kernels store int8 or e4m3 codes of their
    own class only)."""
    epi = epi or EpilogueSpec()
    if requant_scale is None:
        return epi
    own = dtype_name(storage)
    if epi.requant is not None and dtype_name(epi.requant) != own:
        raise ValueError(f"{kernel}: epilogue {epi.point!r}: a {own} kernel requantizes "
                         f"to {own} only")
    return with_requant(epi, storage)


def quantized_out(kernel: str, epi: EpilogueSpec, storage: torch.dtype,
                  out_dtype: torch.dtype, raw: bool) -> tuple:
    """``(out_kind, dtype of the output)`` of one quantized launch: the
    class's raw accumulator, its narrow codes (requant), or the scaled
    bf16 / fp32 rows."""
    if raw:
        return _build.OUT_RAW, _build.QUANT_CLASSES[storage][2]
    if epi.requant is not None:
        return _build.OUT_REQUANT, storage
    return _build.out_kind(kernel, out_dtype, False), out_dtype


def _tile_gemm_quantized(wrapper, storage, x_q, w_q, x_scale, w_scale, epilogue, bias,
                         out_dtype, block_b, maps=None, requant_scale=None):
    """The shared body of the int8 and fp8 single GEMMs (the JAX package's
    ``_tile_gemm_quantized``), masked when ``maps = (kmap, kmask)`` is
    given, requantizing against ``requant_scale`` when given: checks, the
    plain version on CPU tensors, else one launch of the class's kernel
    counted on ``wrapper``."""
    kernel = wrapper.__name__
    source = _build.QUANT_CLASSES[storage][0]
    epi = requant_spec(kernel, epilogue, storage, requant_scale)
    b, k = x_q.shape
    k2, o = w_q.shape
    if k != k2:
        raise ValueError(f"{kernel}: x {tuple(x_q.shape)} vs w {tuple(w_q.shape)}")
    raw = check_scales(kernel, b, o, x_scale, w_scale)
    if raw and not epi.is_identity:
        raise ValueError(f"{kernel}: the raw accumulator takes no epilogue")
    check_single_epilogue(kernel, epi, bias, o, requant_scale)
    if x_q.dtype != storage or w_q.dtype != storage:
        raise ValueError(f"{kernel}: operands must be {dtype_name(storage)}, got "
                         f"{x_q.dtype} and {w_q.dtype}")
    bb = block_b or _build.block_rows(b)
    if maps is not None:
        check_maps(kernel, *maps, b, k, bb)
    if x_q.device.type == "cpu":
        if maps is not None:
            return tile_gemm_masked_quantized_ref(x_q, w_q, *maps, x_scale, w_scale,
                                                  block_b=bb, epilogue=epi, bias=bias,
                                                  out_dtype=out_dtype,
                                                  requant_scale=requant_scale)
        return tile_gemm_quantized_ref(x_q, w_q, x_scale, w_scale, epilogue=epi, bias=bias,
                                       out_dtype=out_dtype, requant_scale=requant_scale)
    kind, y_dtype = quantized_out(kernel, epi, storage, out_dtype, raw)
    bias32 = None if bias is None else bias.float().contiguous()
    kmask = () if maps is None else (maps[1],)
    extra = [t for t in (*kmask, x_scale, w_scale, bias32, requant_scale) if t is not None]
    _build.check_operands(kernel, x_q, w_q, *extra, block_b=bb, x_dtype=storage)
    _build.check_tiles(kernel, k, o)
    # the singles run the body of their plans (the masked ones at their
    # maps' row block, which must be the plan's)
    if storage == torch.float8_e4m3fn and maps is None:
        p = fp8_plan(b, k, o, requant=requant_scale is not None)
        bb, plan_args = p["rows"], (BODY_CODES[p["body"]], p["cols"], p["split"])
    elif maps is None:
        p = int8_plan(b, k, o)
        bb, plan_args = p["rows"], (BODY_CODES[p["body"]], p["split"])
    else:
        p = (masked_fp8_plan(b, k, o, requant=requant_scale is not None)
             if storage == torch.float8_e4m3fn else masked_int8_plan(b, k, o))
        if bb != p["rows"]:
            raise ValueError(f"{kernel}: maps at {bb} rows, the plan's row block is "
                             f"{p['rows']}")
        plan_args = (BODY_CODES[p["body"]], p["split"])
    y = torch.empty((b, o), dtype=y_dtype, device=x_q.device)
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_{kernel.removesuffix('_requant')}")(
            x_q.data_ptr(), w_q.data_ptr(), *(t.data_ptr() for t in kmask), _ptr(x_scale),
            _ptr(w_scale), _ptr(bias32), _ptr(requant_scale), y.data_ptr(), b, k, o,
            ACT_CODES[epi.act], kind, bb, *plan_args, _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


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
    it returns the raw int32 accumulator (and takes no epilogue).  The
    body, its tile and its K split are :func:`int8_plan`'s (``block_b``
    only checked); every body gives the same bits."""
    return _tile_gemm_quantized(tile_gemm_int8, torch.int8, x_q, w_q, x_scale, w_scale,
                                epilogue, bias, out_dtype, block_b)


tile_gemm_int8.launches = 0


def tile_gemm_fp8(x_q: torch.Tensor, w_q: torch.Tensor,
                  x_scale: Optional[torch.Tensor] = None,
                  w_scale: Optional[torch.Tensor] = None, *,
                  epilogue: Optional[EpilogueSpec] = None,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32,
                  block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_gemm_int8`'s contract over float8_e4m3fn operands: the
    e4m3 x e4m3 products summed into an fp32 accumulator, dequantized once
    at the flush.  With no scales it returns the raw fp32 accumulator.
    ``block_b`` is the dispatch plan's row block (checked); the body, its
    tile and its K split are :func:`fp8_plan`'s."""
    return _tile_gemm_quantized(tile_gemm_fp8, torch.float8_e4m3fn, x_q, w_q, x_scale,
                                w_scale, epilogue, bias, out_dtype, block_b)


tile_gemm_fp8.launches = 0


def tile_gemm_int8_requant(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                           w_scale: torch.Tensor, requant_scale: torch.Tensor, *,
                           epilogue: Optional[EpilogueSpec] = None,
                           bias: Optional[torch.Tensor] = None,
                           block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_gemm_int8` whose flush then requantizes (K0's
    ``requant:int8`` point on a single GEMM, the gelu MLP's ``w_in``):
    ``int8(round(clip(act(deq(Xq @ Wq) + bias) / requant_scale, +-127)))``
    against the consuming linear's static scale (a one-element float32
    tensor on the device), so the consumer contracts the rows as they are.
    ``epilogue`` gives the bias and the activation; its requant point, if
    named, must be ``int8``."""
    return _tile_gemm_quantized(tile_gemm_int8_requant, torch.int8, x_q, w_q, x_scale,
                                w_scale, epilogue, bias, torch.int8, block_b,
                                requant_scale=requant_scale)


tile_gemm_int8_requant.launches = 0


def tile_gemm_fp8_requant(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                          w_scale: torch.Tensor, requant_scale: torch.Tensor, *,
                          epilogue: Optional[EpilogueSpec] = None,
                          bias: Optional[torch.Tensor] = None,
                          block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_gemm_fp8` whose flush then requantizes:
    ``e4m3(clip(act(deq(Xq @ Wq) + bias) / requant_scale, +-448))`` (round
    to nearest even) against the consuming linear's static scale."""
    return _tile_gemm_quantized(tile_gemm_fp8_requant, torch.float8_e4m3fn, x_q, w_q,
                                x_scale, w_scale, epilogue, bias, torch.float8_e4m3fn,
                                block_b, requant_scale=requant_scale)


tile_gemm_fp8_requant.launches = 0


def tile_gemm_masked_int8(x_q: torch.Tensor, w_q: torch.Tensor, kmap: torch.Tensor,
                          kmask: torch.Tensor, x_scale: Optional[torch.Tensor] = None,
                          w_scale: Optional[torch.Tensor] = None, *,
                          epilogue: Optional[EpilogueSpec] = None,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.float32,
                          block_b: Optional[int] = None,
                          requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`tile_gemm_int8` with the activation-sparsity block skip of
    :func:`tile_gemm_masked` (maps over the int8 rows at ``block_b`` rows;
    the CUDA bodies ignore ``kmap``).  The body and split are
    :func:`masked_int8_plan`'s, whose row block must be ``block_b`` (a
    CUDA launch refuses another): ``tile_gemm_int8``'s s8 dense stream,
    each block walking the live steps of its span, bitwise
    :func:`tile_gemm_int8` on the same masked rows.  With
    ``requant_scale`` the flush requantizes as
    :func:`tile_gemm_int8_requant`'s (int8 codes out, bitwise its codes),
    as the JAX package's masked kernels take ``requant_scale``."""
    return _tile_gemm_quantized(tile_gemm_masked_int8, torch.int8, x_q, w_q, x_scale, w_scale,
                                epilogue, bias, out_dtype, block_b, maps=(kmap, kmask),
                                requant_scale=requant_scale)


tile_gemm_masked_int8.launches = 0


def tile_gemm_masked_fp8(x_q: torch.Tensor, w_q: torch.Tensor, kmap: torch.Tensor,
                         kmask: torch.Tensor, x_scale: Optional[torch.Tensor] = None,
                         w_scale: Optional[torch.Tensor] = None, *,
                         epilogue: Optional[EpilogueSpec] = None,
                         bias: Optional[torch.Tensor] = None,
                         out_dtype: torch.dtype = torch.float32,
                         block_b: Optional[int] = None,
                         requant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`tile_gemm_fp8` with the activation-sparsity block skip of
    :func:`tile_gemm_masked` (maps over the e4m3 rows at ``block_b`` rows;
    the CUDA bodies ignore ``kmap``).  The body and split are
    :func:`masked_fp8_plan`'s, whose row block must be ``block_b`` (a CUDA
    launch refuses another): wherever :func:`tile_gemm_fp8` streams (decode
    rows, 64-row launches narrower than ``FP8_SHARED_TILES``) its e4m3
    stream at its tile and split, each block walking the live steps of its
    span, so bitwise :func:`tile_gemm_fp8` on the same masked rows, and with
    ``requant_scale`` bitwise :func:`tile_gemm_fp8_requant`'s codes; where
    :func:`tile_gemm_fp8` keeps the shared body, the same body, bitwise it
    too; from ``WGMMA_MIN_ROWS`` rows (its wgmma body) the shared body,
    bitwise itself with every tile live and within 1e-2 of
    :func:`tile_gemm_fp8`.  ``requant_scale`` as for
    :func:`tile_gemm_masked_int8`."""
    return _tile_gemm_quantized(tile_gemm_masked_fp8, torch.float8_e4m3fn, x_q, w_q, x_scale,
                                w_scale, epilogue, bias, out_dtype, block_b, maps=(kmap, kmask),
                                requant_scale=requant_scale)


tile_gemm_masked_fp8.launches = 0


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_requant_scale(kernel: str, rq: torch.Tensor) -> None:
    """The requantizing kernels' scale operand: the consumer's static
    activation scale, one float32 value (it stays on the device)."""
    if rq.numel() != 1 or rq.dtype != torch.float32:
        raise ValueError(f"{kernel}: requant_scale must be one float32 value, got "
                         f"{rq.dtype} {tuple(rq.shape)}")


def _tile_gemm_dual_quantized(wrapper, storage, x_q, w_g, w_u, x_scale, wg_scale, wu_scale,
                              out_dtype, block_b, requant_scale):
    """The shared body of the quantized dense duals (int8 and fp8, each
    with and without the requantizing flush): checks, the plain version on
    CPU tensors, else one launch counted on ``wrapper`` (output of the
    class's narrow dtype when ``requant_scale`` is given)."""
    kernel = wrapper.__name__
    source, suffix, _ = _build.QUANT_CLASSES[storage]
    b, k = x_q.shape
    k2, o = w_g.shape
    if k != k2 or w_u.shape != w_g.shape:
        raise ValueError(f"{kernel}: x {tuple(x_q.shape)}, w_g "
                         f"{tuple(w_g.shape)}, w_u {tuple(w_u.shape)}")
    if check_scales(kernel, b, o, x_scale, wg_scale, wu_scale):
        raise ValueError(f"{kernel}: the dual kernel needs its three scales")
    if any(t.dtype != storage for t in (x_q, w_g, w_u)):
        raise ValueError(f"{kernel}: operands must be {dtype_name(storage)}")
    if requant_scale is not None:
        check_requant_scale(kernel, requant_scale)
    if x_q.device.type == "cpu":
        return tile_gemm_dual_quantized_ref(x_q, w_g, w_u, x_scale, wg_scale, wu_scale,
                                            out_dtype=out_dtype,
                                            requant_scale=requant_scale)
    bb = block_b or _build.block_rows(b)
    if requant_scale is None:
        kind, rq = _build.out_kind(kernel, out_dtype, False), ()
    else:
        kind, rq, out_dtype = _build.OUT_REQUANT, (requant_scale,), storage
    _build.check_operands(kernel, x_q, w_g, w_u, x_scale, wg_scale, wu_scale, *rq,
                          block_b=bb, x_dtype=storage)
    _build.check_tiles(kernel, k, o)
    y = torch.empty((b, o), dtype=out_dtype, device=x_q.device)
    # both classes run the body of their plans (block_b only checked); the
    # int8 entry takes no bn (its bodies' tiles are 64 channels wide)
    if storage == torch.float8_e4m3fn:
        p = fp8_dual_plan(b, k, o, requant=requant_scale is not None)
        bb, plan_args = p["rows"], (BODY_CODES[p["body"]], p["cols"], p["split"])
    else:
        p = int8_dual_plan(b, k, o)
        bb, plan_args = p["rows"], (BODY_CODES[p["body"]], p["split"])
    lib = _build.library(source)
    with torch.cuda.device(x_q.device):
        rc = getattr(lib, f"vg_tile_gemm_dual_{suffix}")(
            x_q.data_ptr(), w_g.data_ptr(), w_u.data_ptr(), x_scale.data_ptr(),
            wg_scale.data_ptr(), wu_scale.data_ptr(), _ptr(requant_scale), y.data_ptr(),
            b, k, o, kind, bb, *plan_args, _build.stream_of(x_q))
    wrapper.launches += 1
    _build.check(rc, kernel, lib)
    return y


def tile_gemm_dual_int8(x_q: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                        x_scale: torch.Tensor, wg_scale: torch.Tensor,
                        wu_scale: torch.Tensor, *, out_dtype: torch.dtype = torch.float32,
                        block_b: Optional[int] = None) -> torch.Tensor:
    """Fused int8 gate-up: ``silu(deq(Xq @ Wg)) * deq(Xq @ Wu)`` from one
    read of each X tile, two int32 accumulators, each dequantized with
    ``x_scale * w*_scale`` at the flush, silu*mul in fp32, one cast.
    ``block_b`` is the dispatch plan's row block (checked); the body, its
    tile and its K split are :func:`int8_dual_plan`'s; every body gives the
    same bits."""
    return _tile_gemm_dual_quantized(tile_gemm_dual_int8, torch.int8, x_q, w_g, w_u,
                                     x_scale, wg_scale, wu_scale, out_dtype, block_b, None)


tile_gemm_dual_int8.launches = 0


def tile_gemm_dual_int8_requant(x_q: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                                x_scale: torch.Tensor, wg_scale: torch.Tensor,
                                wu_scale: torch.Tensor, requant_scale: torch.Tensor, *,
                                block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_gemm_dual_int8` whose flush then requantizes:
    ``int8(round(clip(silu(g) * u / requant_scale, +-127)))`` against the
    consuming linear's static scale (a one-element float32 tensor on the
    device), so the consumer contracts the rows as they are."""
    return _tile_gemm_dual_quantized(tile_gemm_dual_int8_requant, torch.int8, x_q, w_g, w_u,
                                     x_scale, wg_scale, wu_scale, torch.int8, block_b,
                                     requant_scale)


tile_gemm_dual_int8_requant.launches = 0


def tile_gemm_dual_fp8(x_q: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                       x_scale: torch.Tensor, wg_scale: torch.Tensor,
                       wu_scale: torch.Tensor, *, out_dtype: torch.dtype = torch.float32,
                       block_b: Optional[int] = None) -> torch.Tensor:
    """Fused fp8 gate-up: :func:`tile_gemm_dual_int8` over float8_e4m3fn
    operands, two fp32 accumulators.  ``block_b`` is the dispatch plan's row
    block (checked); the body, its tile and its K split are
    :func:`fp8_dual_plan`'s."""
    return _tile_gemm_dual_quantized(tile_gemm_dual_fp8, torch.float8_e4m3fn, x_q, w_g, w_u,
                                     x_scale, wg_scale, wu_scale, out_dtype, block_b, None)


tile_gemm_dual_fp8.launches = 0


def tile_gemm_dual_fp8_requant(x_q: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                               x_scale: torch.Tensor, wg_scale: torch.Tensor,
                               wu_scale: torch.Tensor, requant_scale: torch.Tensor, *,
                               block_b: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_gemm_dual_fp8` whose flush then requantizes:
    ``e4m3(clip(silu(g) * u / requant_scale, +-448))`` (round to nearest
    even) against the consuming linear's static scale."""
    return _tile_gemm_dual_quantized(tile_gemm_dual_fp8_requant, torch.float8_e4m3fn, x_q,
                                     w_g, w_u, x_scale, wg_scale, wu_scale,
                                     torch.float8_e4m3fn, block_b, requant_scale)


tile_gemm_dual_fp8_requant.launches = 0


def tile_gemm_dual(x: torch.Tensor, w_g: torch.Tensor, w_u: torch.Tensor,
                   x_scale: Optional[torch.Tensor] = None,
                   wg_scale: Optional[torch.Tensor] = None,
                   wu_scale: Optional[torch.Tensor] = None, *,
                   out_dtype: torch.dtype = torch.float32,
                   block_b: Optional[int] = None) -> torch.Tensor:
    """Fused gate-up: ``silu(X @ Wg) * (X @ Wu)`` from one read of each X
    tile, two fp32 accumulators, silu*mul in fp32, one cast to X's dtype.
    ``block_b`` is the dispatch plan's row block (checked); the body, its
    tile and its K split are :func:`dual_plan`'s.
    Given the three scales, the quantized branch of X's class:
    :func:`tile_gemm_dual_fp8` for float8_e4m3fn, else
    :func:`tile_gemm_dual_int8` (``out_dtype`` is that branch's output
    dtype)."""
    if x_scale is not None or wg_scale is not None or wu_scale is not None:
        fn = tile_gemm_dual_fp8 if x.dtype == torch.float8_e4m3fn else tile_gemm_dual_int8
        return fn(x, w_g, w_u, x_scale, wg_scale, wu_scale, out_dtype=out_dtype,
                  block_b=block_b)
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
    p = dual_plan(b, k, o)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.vg_tile_gemm_dual(x.data_ptr(), w_g.data_ptr(), w_u.data_ptr(),
                                   y.data_ptr(), b, k, o, p["rows"], BODY_CODES[p["body"]],
                                   p["cols"], p["split"], _build.stream_of(x))
    tile_gemm_dual.launches += 1
    _build.check(rc, "tile_gemm_dual", lib)
    return y


tile_gemm_dual.launches = 0
