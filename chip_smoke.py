"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on a miss:

1. build   — nvcc builds the port's CUDA kernels from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, started together); no
             unmasked instantiation of the two streams' kernels may hold
             static shared memory (ptxas's count; kmask.cuh's bitmask is
             the masked ones' only).
   probe   — the operand layouts of the three sparse tensor-core
             instructions, bf16 m16n8k32, e4m3 m16n8k64 and s8 m16n8k64
             (``kernels/mma_sp_probe.py``, exact small-integer products):
             each must be the one its sparse body (nm_spmm, nm_spmm_fp8,
             nm_spmm_int8) assumes.
2. kernels — each of tile_gemm, tile_gemm_dual, nm_spmm, nm_spmm_dual
             against its plain PyTorch version at the main path's
             shapes (B in {8, 64}; (K, O) of internlm2-1.8b's projections;
             n in {1, 2}), bf16, tolerance 1e-2 of max|plain| (the two
             sum in different orders).  One JSON line per shape with the
             kernel's, the plain version's and torch.matmul's times
             (CUDA-graph replays between CUDA events, weights rotated
             through > 100 MB so L2 is cold as in a real decode step) and
             the bandwidth bound; nm_spmm's, tile_gemm's, tile_gemm_dual's
             and nm_spmm_dual's also with the first body's (``earlier_ms``:
             gemm.cu's shared body, timed in turns with the current body
             through the same wrapper, see ``earlier_kernels``), nm_spmm's
             K split and the others' plan (body, tile, split); both duals
             must give the same bits on a second launch.
   int8    — tile_gemm_int8, nm_spmm_int8 (n in {1, 2}) and the int8
             duals, on int8 weights quantized per channel and bf16
             activations quantized per row, at the same (K, O) and B in
             {8, 64, 256} (256: the calibration forward's 8 x 32 rows,
             several row blocks per launch): the raw
             int32 accumulator and the scaled bf16 output of the single
             kernels must be BITWISE the plain versions' (the int32
             accumulator is exact and the flush repeats the same fp32
             ops), the duals within 1e-2 of max|plain| (silu's exp).
             Timed the same way; the library column is torch._int_mm
             (cuBLASLt int8 -> int32, no scales) on the same operands,
             N:M weights decompressed, B = 8 padded to 32 rows (it takes
             more than 16).  nm_spmm_int8 at n in {1, 2} (the body
             nm_spmm/kernel.py::int8_plan picks, printed) is also timed in
             turns with gemm_int8.cu's first body (``earlier_ms``) and its
             raw accumulator must be the same bits on a second launch; so is
             nm_spmm_dual_int8 at n in {1, 2} and tile_gemm_dual_int8 (the
             bodies nm_spmm/kernel.py::int8_dual_plan and tile_gemm/
             kernel.py::int8_dual_plan pick, printed), whose bf16 outputs
             must also be BITWISE their first bodies'.  The dense and the
             compressed int8 dual and their requant forms also run at
             qwen3-moe's expert gate-up (K, O) = (4096, 1536), 2:4, B in
             {8, 64}.
   requant — the requantizing int8 duals (tile_gemm_dual_int8_requant,
             nm_spmm_dual_int8_requant, n in {1, 2}) at the gate-up
             shape, B in {8, 64, 256}, against a calibrated-like scale: int8
             codes equal to the plain version's except |delta| <= 1 on at
             most REQUANT_SHARE of them (the kernel's silu may differ by
             an ulp, which moves a code sitting on a rounding boundary);
             both requant duals' codes BITWISE their first bodies' (the
             int32 sums are exact and DualFlushI8T repeats the first body's
             fp32 operations), timed in turns with them.
   fp8     — tile_gemm_fp8, nm_spmm_fp8 (n in {1, 2}), their duals and the
             requantizing fp8 duals, on e4m3 weights quantized per channel
             and bf16 activations quantized per row to e4m3, at the int8
             phase's shapes and B: the raw fp32 accumulator, the scaled
             bf16 outputs and the duals within 1e-2 of max|plain| (the
             sums run in another order; every e4m3 product is exact in
             fp32), the requantized e4m3 codes equal except one e4m3 step
             on at most REQUANT_SHARE of them.  The library column is
             torch._scaled_mm (cuBLASLt fp8, row-wise scales, bf16 out, B
             padded to 16, W column-major, made outside the timed region).
             nm_spmm_fp8 at n in {1, 2} and tile_gemm_fp8 (the bodies
             nm_spmm/kernel.py::fp8_plan and tile_gemm/kernel.py::fp8_plan
             pick, printed) are also timed in turns with gemm_fp8.cu's
             shared body (``earlier_ms``) and their raw accumulators must be
             the same bits on a second launch; so are both fp8 duals and
             their requant forms (the bodies nm_spmm/kernel.py::
             fp8_dual_plan and tile_gemm/kernel.py::fp8_dual_plan pick,
             printed), on their outputs.
   gather  — the lane-aligned gather kernels (K8 nm_spmm_gather_bk, K9
             nm_spmm_gather_dual_bk) in bf16, int8 and fp8, with the
             quantized duals' requantizing flush, at the same (K, O), n in
             {1, 2}, B in {8, 64, 256}, on weights voted by
             convert_layout(..., "gather"): bf16 and fp8 within 1e-2 of
             max|plain|, int8 raw accumulators and scaled singles BITWISE
             (the flush multiplies ws before xs, as the plain version),
             int8 duals within 1e-2, requantized codes as above.  The
             library column is torch.matmul / torch._int_mm /
             torch._scaled_mm on the PRE-GATHERED X (the gather runs
             outside the timed region; the duals: two calls, gate and up).
             The bf16 K8 and K9 (the bodies nm_spmm_gather/kernel.py::plan
             and ::dual_plan pick, printed) are also timed in turns with
             gemm.cu's shared body (``earlier_ms``) and must be the same
             bits on a second launch; so must K9 int8 and its requant form
             (the body nm_spmm_gather/kernel.py::int8_dual_plan picks,
             printed), timed in turns with gemm_int8.cu's first body, whose
             bf16 output and codes they must give BITWISE.
   sweep   — each body of the two float duals alone (the shared body,
             the stream at stream_plan's split, the wgmma body), at the
             64-row launches where the dual plans switch bodies (B in
             {17, 33, 48, 64, 128}) on the gate-up pairs of internlm2-1.8b,
             phi-3-vision and qwen3-moe's experts, K9 at n in {2, 1}; and
             the float compressed nm_spmm_dual at n in {2, 1} (the shared
             body, the stream over 16-row and over 64-row tiles at two
             blocks an SM, the 64-row one also at one; B also 256): each
             within 1e-2 of max|plain|, one line per shape naming the
             plan's body beside every body's time.
   masked  — the K10 masked kernels (tile_gemm_masked, nm_spmm_masked,
             nm_spmm_gather_bk_masked, each in bf16, int8 and fp8) at the
             MoE expert shapes ((K, O) = (1536, 4096) and (4096, 1536)), B
             in {8, 64}, n in {1, 2}, with 0%, ~40% and 100% of the row
             block's K steps live: BITWISE their unmasked kernels on the
             same masked X (where the unmasked kernel runs a body of its
             own and sums in another order -- K1's and tile_gemm_fp8's
             wgmma bodies from 256 rows, K8 bf16 and e4m3 where their
             bodies are not the masked plans' -- BITWISE themselves with
             every tile live, within 1e-2 of the unmasked kernel; the bf16
             nm_spmm_masked, nm_spmm_masked_fp8, the bf16
             tile_gemm_masked below 256 rows, tile_gemm_masked_fp8
             wherever tile_gemm_fp8 streams, nm_spmm_masked_int8,
             tile_gemm_masked_int8, nm_spmm_gather_bk_masked_int8 and
             nm_spmm_gather_bk_masked_fp8 wherever its plan streams run
             their twins' streams at their twins' splits, bitwise the
             twin; every one is timed in turns with its first body,
             ``earlier_ms``; the three int8 ones also bitwise their first
             bodies, in bf16, fp32, the raw int32 and the codes, each
             quantized launch's plan printed),
             within the class's limit of
             their plain versions (int8 bitwise); timed beside the unmasked kernel, the
             plain version and the library call on the same masked X, the
             bound counting the live tiles only.
             The quantized ones also run the requant:<dtype> flush (gelu)
             at ~40% live, bitwise the unmasked *_requant kernel's codes
             (tile_gemm_masked_fp8 included: tile_gemm_fp8_requant never
             takes the wgmma body, so the two share a body at every point).
   requant — K0's remainder, the six single GEMMs with the requant:<dtype>
   singles   flush (tile_gemm / nm_spmm / nm_spmm_gather_bk x int8 / fp8
             ``*_requant``) at gemma3-1b's gelu w_in shape (K, O) = (1152,
             6912), dense, compressed 2:4 and 1:4 and gather 2:4, B in {8,
             64, 256}: codes equal to the plain version's but one code / one
             e4m3 step on at most REQUANT_SHARE of them (gelu's tanhf may
             differ by an ulp).  Timed beside the unfused path the port ran
             before (the same kernel storing bf16, then the static quantize
             pass) and the library call on the same operands;
             nm_spmm_fp8_requant, tile_gemm_fp8_requant,
             nm_spmm_gather_bk_fp8_requant and nm_spmm_int8_requant also
             beside their first body (``earlier_ms``).
   attn    — flash_attention against its plain version at the
             calibration forward's shape (8 x 32 tokens) and at prefill
             shapes (T = 512, 2048), bf16: 16 query heads over 8 KV heads of
             head dim 128 (internlm2-1.8b), then 4 over 1 of 256 (gemma3-1b),
             each output row within ATTN_TOL of its own
             max|plain| (a late row averages ~T keys and is ~20x smaller
             than row 0, so one limit scaled by the whole output's max
             would not see a fault confined to far rows); the library
             column is F.scaled_dot_product_attention (enable_gqa).
             Then the encoder and vision-prefix shapes: 16 over 16 heads of
             80, non-causal (hubert-xlarge), at B x T = 8 x 500 and 2 x
             1500 (10 s and 30 s clips at 50 frames a second, both ragged),
             and 32 over 32 heads of 96, causal (phi-3-vision), at 2 x 512
             and 1 x 2048, under the same row limit; SDPA with is_causal
             to match.  Every shape is also timed on the first body
             (``earlier_ms``, flash_attention_wmma.cu, in turns).
3. serving — full-width internlm2-1.8b (random bf16 weights from a
             seeded torch.Generator on the card) served by the port's
             Engine in the dense, 2:4 and 1:4 compressed and 2:4 and 1:4
             gather layouts (cut from 24 to 2 layers to stay within the
             time limit; each run prints its depth), each float, int8
             (w8a8), int8 with static activation scales, fp8 (e4m3
             weights and activations) and fp8 with static scales (25
             runs); then full-width qwen3-moe-235b-a22b (128 experts
             top-8, cut to 2 layers) on the gather expert path (dense
             bf16) and on the spgemm path (dense, compressed 2:4, gather
             2:4 x bf16, int8 with static scales, fp8): every spgemm w_out
             plans its layout's masked kernel (ACT_SKIP), every expert
             gate-up ACT_MASK_ONLY_DUAL, and the profiled decode step
             reports the share of w_out tiles skipped.  The bf16
             compressed runs print nm_spmm_dual's plans (and on the
             spgemm path nm_spmm_masked's), the spgemm dense bf16, dense
             fp8 and 2:4 fp8 runs tile_gemm_masked's, tile_gemm_masked_fp8's
             and nm_spmm_masked_fp8's, the spgemm static int8 2:4 and
             dense runs nm_spmm_masked_int8's and tile_gemm_masked_int8's,
             the int8 compressed runs
             nm_spmm_int8's (int8_plan per site) and nm_spmm_dual_int8's
             (int8_dual_plan; the spgemm static int8 2:4 run at the expert's
             gate-up), and the serving phase
             ends with the device busy time of the decode steps that run
             them (internlm2-1.8b 2:4 and 1:4 in bf16 and int8, static int8
             2:4, qwen3-moe spgemm bf16 2:4, dense bf16, dense fp8 and 2:4
             fp8, static int8 2:4, the gather layouts).  Each decode
             profile's device trace must hold the launches the wrappers
             counted in one step, less one a step or 5% (traced once
             more if not).  All runs: a
             seeded trace of 16 requests (the MoE runs: its first 8),
             prompts of 128-256 tokens, 32 new tokens, 8 slots, prefill
             chunks of 64, max_len 512.  Every linear site must
             plan a cuda kernel (one of its layout and class, with act-scales=static
             for the static layouts) and every kernel of the layout must
             launch (counts are zeroed just before each run and read
             just after); no kernel of another class may launch.  The
             static runs calibrate in prepare (one forward over 8 x 32
             seeded tokens, counted as its own run: flash_attention must
             launch there, once per layer) and calibrate the same params
             and tokens again on the torch tier (plain versions and
             chunked attention, on the card): every leaf's act_scale
             within CALIB_TOL of the torch tier's.  Then a decode step is
             instrumented: no per-row quantize pass, every wq/wk/wv/wo
             and gate-up site (every expert's) quantizing against its static
             scale, every w_out fed the int8 / e4m3 rows its gate-up dual
             requantized.
             Then full-width gemma3-1b, all 26 layers (local/global
             attention, window 512, a gelu MLP, head_dim 256, tied
             embeddings), 7 runs: bf16 dense, then static int8 and static
             fp8 in each of dense, compressed 2:4 and gather 2:4, on the
             seeded trace with every 4th prompt 576-768 tokens long and
             max_len 1024 (decode passes the window; the trace is printed):
             every w_out's requant decision fused, so every w_in launches
             its layout's ``*_requant`` single and no quantize pass runs
             before a w_out; 18 calibrated sites; flash_attention (D = 256)
             26 times per calibration; the decode step profiled at
             position 600.  Then starcoder2-3b at full width, cut to 2
             layers, static int8 compressed 2:4 (the gelu MLP, no window,
             head_dim 128).
             Then mamba2-2.7b (ssm) at full width and all 64 layers
             (d_model 2560, d_inner 5120, 80 SSM heads of 64, ssm_state
             128, conv 4, vocab 50280), bf16 compressed 2:4 and static int8
             gather 2:4, on the trace's first 8 requests: every site (wz,
             wx, w_out) on its layout's single kernel, no dual and no
             flash_attention (the static run's calibration forward runs the
             chunked SSD scan on the card; 3 calibrated sites); besides the
             decode profile, one 64-token prefill chunk profiled (launches
             per token).  The tiers' rounding grows through a deep Mamba
             stack past any end-to-end tolerance (0.185 / 0.193 at 64
             layers against the torch tier's own one-ulp sensitivity
             0.377 / 0.248), so the bf16 run prints its full-depth gap and
             holds the end-to-end gate on its first SSM_GATED_DEPTH layers;
             the static run (against a torch tier that quantizes its
             activations against the same scales) and jamba's print theirs
             (SSM_GATED_DEPTH gives the readings).  Every layer of every
             such run is held teacher-forced: over one prefill chunk and a
             decode step every layer of the cuda tier takes the torch
             tier's inputs (the decode the torch tier's caches), and its
             mixer's and FFN's outputs must be within TIER_TOL /
             STATIC_TIER_TOL of the torch tier's on every row
             (``layer_tier_check``).  The bf16 run also holds
             ``models.forward`` (the chunked scan, two 128-token chunks) on
             one 256-token prompt against four 64-token
             ``paged_prefill_chunk`` calls: the last position's logits
             within TIER_TOL on the first SSM_GATED_DEPTH layers, every
             layer's mixer within TIER_TOL at full depth, teacher-forced
             (the full-depth logits printed).  Before
             the serving phase, both kernels of these runs (K2 bf16 2:4, K8
             int8 2:4) are held against their plain versions at mamba2's
             two site shapes and 1 / 8 / 64 / 256 rows.  Then
             jamba-1.5-large's hybrid layout (one super-block: 3 Mamba +
             MLP, 4 Mamba + MoE, 1 attention + MLP; 16 experts top-2,
             head_dim 128, ssm_state 128, ssm_head_dim 64) at reduced
             widths (d_model 1024, 8 heads over 1 KV head, d_ff 3072: each
             cut printed), bf16 compressed 2:4 on the gather expert path,
             the first 8 requests.  A line then gathers the SSM and hybrid
             runs' tokens/s, p50 / p99, decode step wall / busy / idle
             share / launches and prefill launches per token.
   prefill — the encoder / vision-prefix path through
             ``models.make_prefill_step`` at full width: hubert-xlarge, all
             48 layers (non-causal, head_dim 80, gelu), on 8 x 500 seeded
             frame embeddings, in 5 runs (bf16 dense, bf16 compressed 2:4,
             bf16 gather 2:4, int8 w8a8 (dynamic) gather 2:4, fp8 dense);
             phi-3-vision-4.2b, all 32 layers (causal, head_dim 96, swiglu),
             on 2 x (256 seeded patch embeddings + 256 seeded text
             tokens), in 2 runs (bf16 dense, bf16 gather 2:4).  Every
             linear site plans a cuda kernel of its layout and class;
             flash_attention launches once per layer per forward (48 at
             hubert's D = 80, 32 at phi-3's D = 96); no kernel of
             another class launches; the logits are finite, of shape (B,
             T, V), and within TIER_TOL / INT8_TIER_TOL / FP8_TIER_TOL
             (scaled) of the torch tier's on the same params (the share of
             positions whose argmax agrees is printed).  Printed per run:
             weight GB, forward latency (median of 3, CUDA events), frames
             or tokens per second, launches per forward and the device's
             busy share of one profiled forward; hubert's bf16 dense and
             2:4 runs also the latency and busy share of the same forward on
             the first flash_attention, tile_gemm and nm_spmm bodies
             (``earlier``).  The prefill shapes of tile_gemm, nm_spmm,
             tile_gemm_fp8, nm_spmm_gather_bk, tile_gemm_dual and
             nm_spmm_gather_dual_bk are timed in turns with their first
             bodies too, each with its plan; the two duals must give the
             same bits on a second launch.
   k11     — the K-major gather K11 (nm_spmm_gather bf16 in / fp32 out,
             nm_spmm_gather_int8 and _fp8, each raw and scaled) at the
             row-parallel sites' local shapes of a (1, 2) mesh of
             internlm2-1.8b (wo: K_eff 1024, w_out: 4096; O 2048), n in
             {2, 1}, B in {32, 256}, x_t (K_eff, B) -> Y_t (O, B), against
             the plain versions: int8 raw and scaled BITWISE, bf16 and fp8
             within 1e-2 of max|plain|; timed beside the plain version and
             the library call on the pre-gathered row-major X; int8 and fp8
             (the bodies nm_spmm_gather/kernel.py::kmajor_int8_plan /
             ::kmajor_fp8_plan pick, printed) also in turns with
             gemm_int8.cu's / gemm_fp8.cu's shared body (``earlier_ms``),
             the same bits on a second launch.
   sharded — tensor-parallel serving, ServingSpec(mesh=(1, 2)): two ranks
             spawned once (rank r on cuda:(r % device_count); gloo when
             they share the card, NCCL when each has its own), full-width
             internlm2-1.8b cut to 4 of 24 layers, the trace's first 8
             requests, in bf16 dense, bf16 gather 2:4, int8 gather 2:4
             (dynamic and static) and fp8 gather 1:4, then int8 gather 2:4
             at all 24 layers.  Every site plans its layout's kernel with
             shard_map; each rank launches exactly (column sites + row
             sites) x layers x model calls kernels, every row-parallel
             quantized gather site on K11 (raw partials, all-reduced in
             int32 / fp32) and no other kernel; the ranks' token streams
             are equal (the Engine checks); rank 0's prefill / decode
             logits within the tier tolerance of the same model served
             unsharded on the card.  Printed per run and rank: tokens/s,
             p50 / p99, one decode step's wall, device busy / idle and
             launches (hand-written vs other), collectives per step and
             their host wall, weights per rank.
4. tiers   — one prefill chunk + one decode step under the cuda and the
             torch backends on the same params (gemma3: 9 chunks, the last
             one's logits compared, and a decode at position 576, past
             the window); logits must agree to
             3e-2 of max|torch| (bf16 rounding differs between tiers) for
             the float layouts, to INT8_TIER_TOL / STATIC_TIER_TOL for the
             int8 ones and FP8_TIER_TOL for the fp8 ones (the cuda tier
             quantizes the activations, the torch tier dequantizes the
             weights only and contracts bf16 activations).  On an MoE
             model the rows whose experts differ between the tiers (a
             near-tied route, or a capacity drop) are counted and left out
             of the gate; the spgemm path's bf16 logits are compared with
             the gather path's (printed, not gated).

It then prints the kernels JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository beside it, it exits non-zero and prints no result.
TF32 is off for every fp32 product here (the plain versions' fp32
matmuls run in full fp32).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12               # H100 SXM dense int8 tensor-core peak
FP8_OPS = 1979e12                # H100 SXM dense fp8 tensor-core peak
TOL = 1e-2                       # kernel vs plain, scaled by max|plain|
TIER_TOL = 3e-2                  # cuda tier vs torch tier logits, scaled
# w8a8 cuda tier vs the weight-only torch tier (bf16 activations): the
# activation codes add one int8 rounding per site; 0.056 at most was
# measured on an H100 over 24 layers, so 0.1 leaves room without hiding
# a wrong kernel (a wrong product gives errors of order 1)
INT8_TIER_TOL = 0.1
# static scales quantize every row against one per-tensor step fixed at
# calibration (absmax over 8 x 32 tokens / 127), coarser than a row's own:
# more rounding error than the dynamic path (0.071-0.118 measured on an
# H100 over 24 layers), still far below a wrong product's order-1 errors
STATIC_TIER_TOL = 0.15
# fp8 cuda tier (e4m3 activations at every site) vs the weight-only torch
# tier: an e4m3 code carries ~2^-4 relative rounding per activation, where
# int8's per-row step is ~1/127 of the row's max.  A CPU run at the smoke
# config (2 layers) measured 0.061-0.086 dynamic and 0.035-0.116 static
# (int8 there: 0.018-0.039 / 0.036-0.099, which became 0.035-0.056 /
# 0.064-0.118 on an H100 over 24 layers, up to 1.9x), so up to ~0.21 is
# expected here; the JAX package bounds one fp8 linear at 5e-2 of its
# dequantize reference.  Fixed before the first chip run; a wrong product
# gives errors of order 1.
FP8_TIER_TOL = 0.3
REQUANT_SHARE = 1e-3             # requantized duals: share of codes off by one
ATTN_TOL = 2e-2                  # flash_attention vs plain, per row, scaled (bf16)
# static act_scale of the cuda tier (w8a8 kernels, flash_attention) against
# the torch tier's (weights dequantized, bf16 activations, chunked
# attention), relative: the tiers' activations differ by the int8
# rounding of every site's input, as their logits do (INT8_TIER_TOL); a
# wrong kernel or site mapping moves a scale by far more
CALIB_TOL = 0.1
SOURCES = {"float": "src/repro_torch/kernels/csrc/gemm.cu",
           "nm_spmm": "src/repro_torch/kernels/csrc/nm_spmm_sp.cuh",
           # the float compressed dual's and the bf16 masked single's stream
           # (their shared bodies, gemm.cu, where the plan keeps them)
           "nm_spmm_dual": "src/repro_torch/kernels/csrc/nm_spmm_sp.cuh",
           "nm_spmm_masked": "src/repro_torch/kernels/csrc/nm_spmm_sp.cuh",
           # the bf16 tile_gemm_masked's stream below 256 rows (K1's, MASKED;
           # the shared body, gemm.cu, from 256) and nm_spmm_masked_fp8's
           # (nm_spmm_fp8's, MASKED; gemm_fp8.cu's shared body where fp8_plan
           # keeps it)
           "tile_gemm_masked": "src/repro_torch/kernels/csrc/nm_spmm_sp.cuh",
           "nm_spmm_masked_fp8": "src/repro_torch/kernels/csrc/nm_spmm_sp_fp8.cuh",
           # tile_gemm_masked_fp8's (tile_gemm_fp8's dense stream, MASKED) and
           # the int8 singles' (the s8 forms of nm_spmm_fp8's sparse stream, of
           # tile_gemm_fp8's dense one, of K8 fp8's gathered one and of K11
           # fp8's K-major one), the int8 gate-up duals' (the s8 forms of the
           # fp8 compressed, dense and gathered DUAL streams); each
           # gemm_fp8.cu's / gemm_int8.cu's shared body where its plan keeps it;
           # the masked int8 singles' (the s8 sparse and dense streams, MASKED)
           # and the 8-bit masked gathers' (K8 int8's s8 and K8 fp8's e4m3
           # gathered streams, MASKED)
           **{name: "src/repro_torch/kernels/csrc/nm_spmm_sp_fp8.cuh"
              for name in ("tile_gemm_masked_fp8", "nm_spmm_masked_int8",
                           "nm_spmm_gather_bk_masked_int8", "nm_spmm_gather_bk_masked_fp8",
                           "tile_gemm_masked_int8", "nm_spmm_int8", "nm_spmm_int8_requant",
                           "tile_gemm_int8", "tile_gemm_int8_requant",
                           "nm_spmm_gather_bk_int8", "nm_spmm_gather_bk_int8_requant",
                           "nm_spmm_dual_int8", "nm_spmm_dual_int8_requant",
                           "nm_spmm_gather_int8", "tile_gemm_dual_int8",
                           "tile_gemm_dual_int8_requant", "nm_spmm_gather_dual_bk_int8",
                           "nm_spmm_gather_dual_bk_int8_requant")},
           # the bf16 nm_spmm_gather_bk_masked's stream where K8 streams (K8's,
           # MASKED; gemm.cu's shared body elsewhere)
           "nm_spmm_gather_bk_masked": "src/repro_torch/kernels/csrc/nm_spmm_sp.cuh",
           "tile_gemm": "src/repro_torch/kernels/csrc/tile_gemm_sm90.cuh",
           "nm_spmm_fp8": "src/repro_torch/kernels/csrc/nm_spmm_sp_fp8.cuh",
           "tile_gemm_fp8": "src/repro_torch/kernels/csrc/tile_gemm_sm90_fp8.cuh",
           "nm_spmm_gather_bk": "src/repro_torch/kernels/csrc/nm_spmm_sp.cuh",
           "tile_gemm_dual": "src/repro_torch/kernels/csrc/tile_gemm_sm90.cuh",
           "nm_spmm_gather_dual_bk": "src/repro_torch/kernels/csrc/nm_spmm_sp.cuh",
           # the fp8 compressed dual's, K8 fp8's, the dense fp8 dual's, K9 fp8's
           # and K11 fp8's few-row bodies (K8's gather pass: gemm_fp8.cu; the
           # many-row bodies: tile_gemm_sm90_fp8.cuh; K9 fp8 past its stream:
           # gemm_fp8.cu's shared body)
           **{name: "src/repro_torch/kernels/csrc/nm_spmm_sp_fp8.cuh"
              for name in ("nm_spmm_dual_fp8", "nm_spmm_dual_fp8_requant",
                           "nm_spmm_gather_bk_fp8", "tile_gemm_dual_fp8",
                           "tile_gemm_dual_fp8_requant", "nm_spmm_gather_fp8",
                           "nm_spmm_gather_dual_bk_fp8", "nm_spmm_gather_dual_bk_fp8_requant")},
           "int8": "src/repro_torch/kernels/csrc/gemm_int8.cu",
           "fp8": "src/repro_torch/kernels/csrc/gemm_fp8.cu",
           "attention": "src/repro_torch/kernels/csrc/flash_attention.cu"}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:79",
    # the int8 dual with the requant:int8 flush (epilogue.py:143, :162)
    "tile_gemm_dual_int8_requant": "src/repro/kernels/tile_gemm/kernel.py:382",
    "nm_spmm_dual_int8_requant": "src/repro/kernels/nm_spmm/kernel.py:437",
    "tile_gemm": "src/repro/kernels/tile_gemm/kernel.py:82",
    "tile_gemm_dual": "src/repro/kernels/tile_gemm/kernel.py:382",
    "nm_spmm": "src/repro/kernels/nm_spmm/kernel.py:125",
    "nm_spmm_dual": "src/repro/kernels/nm_spmm/kernel.py:437",
    "tile_gemm_int8": "src/repro/kernels/tile_gemm/kernel.py:448",
    "tile_gemm_dual_int8": "src/repro/kernels/tile_gemm/kernel.py:382",
    "nm_spmm_int8": "src/repro/kernels/nm_spmm/kernel.py:506",
    "nm_spmm_dual_int8": "src/repro/kernels/nm_spmm/kernel.py:437",
    "tile_gemm_fp8": "src/repro/kernels/tile_gemm/kernel.py:482",
    "tile_gemm_dual_fp8": "src/repro/kernels/tile_gemm/kernel.py:382",
    "nm_spmm_fp8": "src/repro/kernels/nm_spmm/kernel.py:543",
    "nm_spmm_dual_fp8": "src/repro/kernels/nm_spmm/kernel.py:437",
    # the fp8 dual with the requant:float8_e4m3fn flush (epilogue.py:143, :162)
    "tile_gemm_dual_fp8_requant": "src/repro/kernels/tile_gemm/kernel.py:382",
    "nm_spmm_dual_fp8_requant": "src/repro/kernels/nm_spmm/kernel.py:437",
    # the lane-aligned gather pair (bk layout), each class; the quantized
    # duals' requant flush is epilogue.py:143, :162 inside :566
    **{f"nm_spmm_gather_bk{q}": "src/repro/kernels/nm_spmm_gather/kernel.py:324"
       for q in ("", "_int8", "_fp8")},
    **{f"nm_spmm_gather_dual_bk{q}": "src/repro/kernels/nm_spmm_gather/kernel.py:566"
       for q in ("", "_int8", "_fp8", "_int8_requant", "_fp8_requant")},
    # K0's remainder: the single quantized GEMMs with the requant:<dtype>
    # flush (epilogue.py:143, :162 inside _tile_gemm_quantized :133,
    # _nm_spmm_quantized :187 and nm_spmm_gather_bk)
    "tile_gemm_int8_requant": "src/repro/kernels/tile_gemm/kernel.py:448",
    "tile_gemm_fp8_requant": "src/repro/kernels/tile_gemm/kernel.py:482",
    "nm_spmm_int8_requant": "src/repro/kernels/nm_spmm/kernel.py:506",
    "nm_spmm_fp8_requant": "src/repro/kernels/nm_spmm/kernel.py:543",
    **{f"nm_spmm_gather_bk_{q}_requant": "src/repro/kernels/nm_spmm_gather/kernel.py:324"
       for q in ("int8", "fp8")},
    # flash_attention at gemma3's head_dim 256 (the same wrapper and source)
    "flash_attention_d256": "src/repro/kernels/flash_attention/kernel.py:79",
    # its causal=False branch at hubert-xlarge's head_dim 80, and head_dim
    # 96 (phi-3-vision, causal)
    "flash_attention_d80_noncausal": "src/repro/kernels/flash_attention/kernel.py:79",
    "flash_attention_d96": "src/repro/kernels/flash_attention/kernel.py:79",
    # K10, the activation-sparsity (block-skip) singles, float and quantized
    **{f"tile_gemm_masked{q}": "src/repro/kernels/tile_gemm/kernel.py:252"
       for q in ("", "_int8", "_fp8")},
    **{f"nm_spmm_masked{q}": "src/repro/kernels/nm_spmm/kernel.py:305"
       for q in ("", "_int8", "_fp8")},
    **{f"nm_spmm_gather_bk_masked{q}": "src/repro/kernels/nm_spmm_gather/kernel.py:445"
       for q in ("", "_int8", "_fp8")},
    # K11, the K-major gather (float; int8 and fp8 scaled or raw, the raw
    # partials of every row-parallel quantized gather site under a mesh)
    "nm_spmm_gather": "src/repro/kernels/nm_spmm_gather/kernel.py:87",
    "nm_spmm_gather_int8": "src/repro/kernels/nm_spmm_gather/kernel.py:211",
    "nm_spmm_gather_fp8": "src/repro/kernels/nm_spmm_gather/kernel.py:243",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (want.abs().max() + 1e-6)).item()


def row_scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of a row (last dim) over that row's own max|want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().amax(-1) / (want.abs().amax(-1) + 1e-6)).max().item()


def time_ms(fn, operands, calls: int = 24, replays: int = 5) -> float:
    """Device ms per call: ``calls`` calls, cycling through ``operands`` so
    the weights come from device memory and not L2, are captured into one
    CUDA graph and replayed between CUDA events.  (Timed eagerly, every
    one of these calls is shorter than its Python launch path, so events
    around an eager loop would time the host.)"""
    calls = max(calls, len(operands))
    for ops in operands[:2]:
        fn(*ops)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*operands[i % len(operands)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(128e6 / nbytes))


def bound_ms(nbytes: int, flops: int, peak: float = BF16_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 2
def recorder(rows, card_line):
    """``record(...)``: one JSON row per (kernel, shape), failing the run
    when the kernel is off its plain version by more than ``tol`` of
    max|plain|, or, with ``exact``, not bitwise equal to it (``tol=None``:
    the caller has gated the result itself)."""
    def record(kernel, b, k, o, n, got, want, t_k, t_p, t_l, nbytes, flops,
               peak=BF16_FLOPS, exact=False, tol=TOL, **extra):
        e = scaled_err(got, want)
        bmsv, by = bound_ms(nbytes, flops, peak)
        row = {"kernel": kernel, "B": b, "K": k, "O": o, "n": n,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "scaled_err": e, "kernel_ms": t_k, "plain_ms": t_p, "library_ms": t_l,
               "bound_ms": bmsv, "bound_by": by, "card": card_line, **extra}
        if exact:
            row["bitwise"] = bool(torch.equal(got, want))
        rows.append(row)
        log(json.dumps(row))
        if exact and not row["bitwise"]:
            fail(f"{kernel} B={b} K={k} O={o} n={n}: not bitwise equal to its "
                 f"plain version (max abs error {row['max_abs_err']:.3e})")
        if tol is not None and not (e <= tol):
            fail(f"{kernel} B={b} K={k} O={o} n={n}: error {e:.3e} > {tol}")
    return record


class _EarlierLib:
    """A loaded library whose named entry points are swapped for others."""

    def __init__(self, lib, **swaps):
        self._lib, self._swaps = lib, swaps

    def __getattr__(self, name):
        return self._swaps[name] if name in self._swaps else getattr(self._lib, name)


@contextlib.contextmanager
def earlier_kernels():
    """Inside, the flash_attention, nm_spmm, tile_gemm, nm_spmm_fp8,
    tile_gemm_fp8 (and _requant), nm_spmm_gather_bk, tile_gemm_dual,
    nm_spmm_gather_dual_bk, nm_spmm_dual_fp8 (and _requant),
    nm_spmm_gather_bk_fp8 (and _requant), tile_gemm_dual_fp8 (and _requant),
    nm_spmm_gather_fp8, nm_spmm_dual (float), nm_spmm_masked (bf16),
    tile_gemm_masked (bf16), nm_spmm_masked_fp8, nm_spmm_gather_bk_masked
    (bf16), nm_spmm_gather_dual_bk_fp8 (and _requant), tile_gemm_masked_fp8,
    nm_spmm_int8, tile_gemm_int8, nm_spmm_gather_bk_int8, nm_spmm_dual_int8,
    tile_gemm_dual_int8, nm_spmm_gather_dual_bk_int8 (each and _requant),
    nm_spmm_gather_int8, nm_spmm_masked_int8, tile_gemm_masked_int8,
    nm_spmm_gather_bk_masked_int8 and nm_spmm_gather_bk_masked_fp8
    wrappers launch the port's
    first bodies (``flash_attention_wmma.cu``;
    the shared bodies of gemm.cu, gemm_int8.cu and gemm_fp8.cu at every n
    and row count,
    ``vg_nm_spmm_tiled``, ``vg_tile_gemm_tiled``, ``vg_nm_spmm_fp8_tiled``,
    ``vg_tile_gemm_fp8_tiled``, ``vg_nm_spmm_gather_bk_tiled``,
    ``vg_tile_gemm_dual_tiled``, ``vg_nm_spmm_gather_dual_bk_tiled``,
    ``vg_nm_spmm_dual_fp8_tiled``, ``vg_nm_spmm_gather_bk_fp8_tiled``,
    ``vg_tile_gemm_dual_fp8_tiled``, ``vg_nm_spmm_gather_fp8_tiled``,
    ``vg_nm_spmm_dual_tiled``, ``vg_nm_spmm_masked_tiled``, and
    ``vg_tile_gemm_masked`` / ``vg_nm_spmm_masked_fp8`` /
    ``vg_nm_spmm_gather_bk_masked`` / ``vg_nm_spmm_gather_dual_bk_fp8`` /
    ``vg_tile_gemm_masked_fp8`` / ``vg_nm_spmm_int8`` / ``vg_tile_gemm_int8``
    / ``vg_nm_spmm_gather_bk_int8`` / ``vg_nm_spmm_dual_int8`` /
    ``vg_nm_spmm_gather_int8`` / ``vg_tile_gemm_dual_int8`` /
    ``vg_nm_spmm_gather_dual_bk_int8`` / ``vg_nm_spmm_masked_int8`` /
    ``vg_tile_gemm_masked_int8`` / ``vg_nm_spmm_gather_bk_masked_int8`` /
    ``vg_nm_spmm_gather_bk_masked_fp8`` at body 0, split 1, at the row block the
    first form took: 16 up to 16 rows, else 64; the masked ones at their
    maps' row block) instead of the current
    ones: the ``earlier_ms`` yardstick, through the same wrappers and
    checks."""
    from repro_torch.kernels import _build

    gemm = _build.library("gemm.cu")
    int8 = _build.library("gemm_int8.cu")
    fp8 = _build.library("gemm_fp8.cu")
    flash = _build.library("flash_attention.cu")
    wmma = _build.library("flash_attention_wmma.cu")

    def nm_spmm_tiled(*args):     # the shared body takes no split (args[-2])
        return gemm.vg_nm_spmm_tiled(*args[:-2], args[-1])

    def tile_gemm_tiled(*args):   # (.., bm, bn, split, stream): the plan's tile dropped
        return gemm.vg_tile_gemm_tiled(*args[:9], 16 if args[9] == 16 else 64, args[-1])

    def nm_spmm_fp8_tiled(*args):   # no plan (body, split: args[-3], args[-2])
        return fp8.vg_nm_spmm_fp8_tiled(*args[:-3], args[-1])

    def tile_gemm_fp8_tiled(*args):   # (.., bm, body, bn, split, stream): the plan dropped
        return fp8.vg_tile_gemm_fp8_tiled(*args[:12], 16 if args[12] == 16 else 64, args[-1])

    def nm_spmm_gather_bk_tiled(*args):   # (.., bm, body, bn, split, stream): likewise
        return gemm.vg_nm_spmm_gather_bk_tiled(*args[:11], 16 if args[11] == 16 else 64,
                                               args[-1])

    def tile_gemm_dual_tiled(*args):   # (.., o, bm, body, bn, split, stream): likewise
        return gemm.vg_tile_gemm_dual_tiled(*args[:7], 16 if args[7] == 16 else 64, args[-1])

    def nm_spmm_gather_dual_bk_tiled(*args):   # (.., n, bm, body, bn, split, scratch, stream)
        return gemm.vg_nm_spmm_gather_dual_bk_tiled(*args[:10], 16 if args[10] == 16 else 64,
                                                    args[-1])

    # the fp8 dual's and K8 fp8's plans run 16-row tiles past 16 rows: the
    # first form's row block is block_rows(b) (b: args[10] / args[8])
    def nm_spmm_dual_fp8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return fp8.vg_nm_spmm_dual_fp8_tiled(*args[:15], _build.block_rows(args[10]),
                                             args[-1])

    def nm_spmm_gather_bk_fp8_tiled(*args):   # (.., bm, body, bn, split, scratch, stream)
        return fp8.vg_nm_spmm_gather_bk_fp8_tiled(*args[:14], _build.block_rows(args[8]),
                                                  args[-1])

    # the dense fp8 dual's and K11 fp8's plans likewise (b: args[8] / args[6])
    def tile_gemm_dual_fp8_tiled(*args):   # (.., out_kind, bm, body, bn, split, stream)
        return fp8.vg_tile_gemm_dual_fp8_tiled(*args[:12], _build.block_rows(args[8]),
                                               args[-1])

    def nm_spmm_gather_fp8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return fp8.vg_nm_spmm_gather_fp8_tiled(*args[:11], _build.block_rows(args[6]),
                                               args[-1])

    # the float compressed dual's plan runs 16-row tiles at decode and 64-row
    # ones past it (b: args[6]); the masked single keeps its maps' row block
    def nm_spmm_dual_tiled(*args):   # (.., n, bm, body, split, stream)
        return gemm.vg_nm_spmm_dual_tiled(*args[:10], _build.block_rows(args[6]), args[-1])

    def nm_spmm_masked_tiled(*args):   # (.., act, bm, split, stream): the split dropped
        return gemm.vg_nm_spmm_masked_tiled(*args[:12], args[-1])

    # the bf16 tile_gemm_masked and nm_spmm_masked_fp8 reach their shared
    # bodies through their own entries: (.., bm, body, split, stream) with
    # body 0, split 1, at the maps' row block
    def tile_gemm_masked_tiled(*args):
        return gemm.vg_tile_gemm_masked(*args[:-3], 0, 1, args[-1])

    def nm_spmm_masked_fp8_tiled(*args):
        return fp8.vg_nm_spmm_masked_fp8(*args[:-3], 0, 1, args[-1])

    def nm_spmm_gather_bk_masked_tiled(*args):
        return gemm.vg_nm_spmm_gather_bk_masked(*args[:-3], 0, 1, args[-1])

    # tile_gemm_masked_fp8 and nm_spmm_int8 likewise: (.., bm, body, split,
    # stream) with body 0, split 1 (nm_spmm_int8's bm is block_rows(b))
    def tile_gemm_masked_fp8_tiled(*args):
        return fp8.vg_tile_gemm_masked_fp8(*args[:-3], 0, 1, args[-1])

    def nm_spmm_int8_tiled(*args):
        return int8.vg_nm_spmm_int8(*args[:-3], 0, 1, args[-1])

    # the masked int8 singles likewise, at their maps' row block (the plans')
    def nm_spmm_masked_int8_tiled(*args):
        return int8.vg_nm_spmm_masked_int8(*args[:-3], 0, 1, args[-1])

    def tile_gemm_masked_int8_tiled(*args):
        return int8.vg_tile_gemm_masked_int8(*args[:-3], 0, 1, args[-1])

    # the 8-bit masked gathers likewise, at their maps' row block (the plans')
    def nm_spmm_gather_bk_masked_int8_tiled(*args):
        return int8.vg_nm_spmm_gather_bk_masked_int8(*args[:-3], 0, 1, args[-1])

    def nm_spmm_gather_bk_masked_fp8_tiled(*args):
        return fp8.vg_nm_spmm_gather_bk_masked_fp8(*args[:-3], 0, 1, args[-1])

    # tile_gemm_int8 and K8 int8 likewise, at the first form's row block (K8
    # int8's plan runs 16-row tiles past 16 rows; b: args[7] / args[8])
    def tile_gemm_int8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return int8.vg_tile_gemm_int8(*args[:12], _build.block_rows(args[7]), 0, 1, args[-1])

    def nm_spmm_gather_bk_int8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return int8.vg_nm_spmm_gather_bk_int8(*args[:14], _build.block_rows(args[8]), 0, 1,
                                              args[-1])

    # the int8 compressed dual and K11 int8 likewise (their plans run 16-row
    # tiles past 16 rows; b: args[10] / args[6])
    def nm_spmm_dual_int8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return int8.vg_nm_spmm_dual_int8(*args[:15], _build.block_rows(args[10]), 0, 1,
                                         args[-1])

    def nm_spmm_gather_int8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return int8.vg_nm_spmm_gather_int8(*args[:11], _build.block_rows(args[6]), 0, 1,
                                           args[-1])

    # the dense int8 dual and K9 int8 likewise (b: args[8] / args[10])
    def tile_gemm_dual_int8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return int8.vg_tile_gemm_dual_int8(*args[:12], _build.block_rows(args[8]), 0, 1,
                                           args[-1])

    def nm_spmm_gather_dual_bk_int8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return int8.vg_nm_spmm_gather_dual_bk_int8(*args[:15], _build.block_rows(args[10]), 0,
                                                   1, args[-1])

    # K9 fp8 reaches its shared body through its own entry, at the row block
    # the first form took (its plan runs 16-row tiles past 16 rows; b: args[10])
    def nm_spmm_gather_dual_bk_fp8_tiled(*args):   # (.., out_kind, bm, body, split, stream)
        return fp8.vg_nm_spmm_gather_dual_bk_fp8(*args[:15], _build.block_rows(args[10]), 0, 1,
                                                 args[-1])
    saved = dict(_build._libs)
    _build._libs["gemm.cu"] = _EarlierLib(gemm, vg_nm_spmm=nm_spmm_tiled,
                                          vg_tile_gemm=tile_gemm_tiled,
                                          vg_nm_spmm_gather_bk=nm_spmm_gather_bk_tiled,
                                          vg_tile_gemm_dual=tile_gemm_dual_tiled,
                                          vg_nm_spmm_gather_dual_bk=nm_spmm_gather_dual_bk_tiled,
                                          vg_nm_spmm_dual=nm_spmm_dual_tiled,
                                          vg_nm_spmm_masked=nm_spmm_masked_tiled,
                                          vg_tile_gemm_masked=tile_gemm_masked_tiled,
                                          vg_nm_spmm_gather_bk_masked=nm_spmm_gather_bk_masked_tiled)
    _build._libs["gemm_fp8.cu"] = _EarlierLib(fp8, vg_nm_spmm_fp8=nm_spmm_fp8_tiled,
                                              vg_tile_gemm_fp8=tile_gemm_fp8_tiled,
                                              vg_nm_spmm_dual_fp8=nm_spmm_dual_fp8_tiled,
                                              vg_nm_spmm_gather_bk_fp8=nm_spmm_gather_bk_fp8_tiled,
                                              vg_tile_gemm_dual_fp8=tile_gemm_dual_fp8_tiled,
                                              vg_nm_spmm_gather_fp8=nm_spmm_gather_fp8_tiled,
                                              vg_nm_spmm_masked_fp8=nm_spmm_masked_fp8_tiled,
                                              vg_tile_gemm_masked_fp8=tile_gemm_masked_fp8_tiled,
                                              vg_nm_spmm_gather_dual_bk_fp8=(
                                                  nm_spmm_gather_dual_bk_fp8_tiled),
                                              vg_nm_spmm_gather_bk_masked_fp8=(
                                                  nm_spmm_gather_bk_masked_fp8_tiled))
    _build._libs["gemm_int8.cu"] = _EarlierLib(
        int8, vg_nm_spmm_int8=nm_spmm_int8_tiled, vg_tile_gemm_int8=tile_gemm_int8_tiled,
        vg_nm_spmm_gather_bk_int8=nm_spmm_gather_bk_int8_tiled,
        vg_nm_spmm_dual_int8=nm_spmm_dual_int8_tiled,
        vg_nm_spmm_gather_int8=nm_spmm_gather_int8_tiled,
        vg_tile_gemm_dual_int8=tile_gemm_dual_int8_tiled,
        vg_nm_spmm_gather_dual_bk_int8=nm_spmm_gather_dual_bk_int8_tiled,
        vg_nm_spmm_masked_int8=nm_spmm_masked_int8_tiled,
        vg_tile_gemm_masked_int8=tile_gemm_masked_int8_tiled,
        vg_nm_spmm_gather_bk_masked_int8=nm_spmm_gather_bk_masked_int8_tiled)
    _build._libs["flash_attention.cu"] = _EarlierLib(
        flash, vg_flash_attention=wmma.vg_flash_attention_wmma)
    try:
        yield
    finally:
        _build._libs.clear()
        _build._libs.update(saved)


def in_turns(fn, operands, **kw) -> tuple:
    """(current, earlier) device ms of ``fn`` (a call of a wrapper that
    ``earlier_kernels`` swaps), timed earlier, current, current, earlier
    and averaged per body."""
    with earlier_kernels():
        e1 = time_ms(fn, operands, **kw)
    c = time_ms(fn, operands, **kw) + time_ms(fn, operands, **kw)
    with earlier_kernels():
        e2 = time_ms(fn, operands, **kw)
    return c / 2, (e1 + e2) / 2


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def kernel_phase(cfg, gen, card_line: str):
    from repro_torch.core import nm
    from repro_torch.kernels.nm_spmm.kernel import dual_plan as nm_dual_plan
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm, nm_spmm_dual, split_k
    from repro_torch.kernels.tile_gemm.kernel import dual_plan, plan, tile_gemm, tile_gemm_dual
    from repro_torch.kernels.epilogue import EpilogueSpec
    from repro_torch.kernels.nm_spmm.ref import (dense_weight, nm_spmm_dual_ref,
                                                 nm_spmm_ref)
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_ref, tile_gemm_ref

    dev = "cuda"
    d, ff = cfg.d_model, cfg.d_ff
    singles = [(d, cfg.attn_dim), (d, cfg.kv_dim), (ff, d)]
    rows = []

    record = recorder(rows, card_line)

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    for b in (8, 64):
        for k, o in singles:
            x = rand((b, k))
            ws = [rand((k, o), k ** -0.5) for _ in range(copies_for(2 * k * o))]
            y = tile_gemm(x, ws[0])
            torch.cuda.synchronize()
            ops = [(x, w) for w in ws]
            t_now, t_earlier = in_turns(tile_gemm, ops)
            record("tile_gemm", b, k, o, 4, y, tile_gemm_ref(x, ws[0]),
                   t_now, time_ms(tile_gemm_ref, ops),
                   time_ms(torch.matmul, ops),
                   2 * (b * k + k * o + b * o), 2 * b * k * o,
                   earlier_ms=t_earlier, plan=plan(b, k, o))
            for n in (1, 2):
                comp = []
                for i in range(copies_for(k * o * n // 2)):
                    w = ws[i] if i < len(ws) else rand((k, o), k ** -0.5)
                    c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
                    comp.append((x, c.values, nm.pack_meta(c.meta), n))
                y = nm_spmm(*comp[0])
                torch.cuda.synchronize()
                kc = k * n // 4
                dense_ops = [(x, dense_weight(v, m, n_))
                             for _, v, m, n_ in comp[:copies_for(2 * k * o)]]
                t_now, t_earlier = in_turns(nm_spmm, comp)
                record("nm_spmm", b, k, o, n, y, nm_spmm_ref(*comp[0]),
                       t_now, time_ms(nm_spmm_ref, comp),
                       time_ms(torch.matmul, dense_ops),
                       2 * (b * k + kc * o + b * o) + kc * o // 4, 2 * b * kc * o,
                       earlier_ms=t_earlier, split=split_k(b, k, o, n))
        # the gate-up pair at (d, ff)
        k, o = d, ff
        x = rand((b, k))
        pairs = [(rand((k, o), k ** -0.5), rand((k, o), k ** -0.5))
                 for _ in range(copies_for(4 * k * o))]
        ops = [(x, g, u) for g, u in pairs]
        y = tile_gemm_dual(*ops[0])
        again = tile_gemm_dual(*ops[0])
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            fail(f"tile_gemm_dual B={b} K={k} O={o}: not the same bits on a second launch")
        cats = [(x, torch.cat([g, u], dim=1)) for g, u in pairs[:2]]
        t_now, t_earlier = in_turns(tile_gemm_dual, ops)
        record("tile_gemm_dual", b, k, o, 4, y, tile_gemm_dual_ref(*ops[0]),
               t_now, time_ms(tile_gemm_dual_ref, ops),
               time_ms(torch.matmul, cats),
               2 * (b * k + 2 * k * o + b * o), 4 * b * k * o,
               earlier_ms=t_earlier, plan=dual_plan(b, k, o))
        for n in (1, 2):
            comp = []
            for i in range(copies_for(k * o * n)):
                g, u = (pairs[i] if i < len(pairs)
                        else (rand((k, o), k ** -0.5), rand((k, o), k ** -0.5)))
                cg = nm.compress_nm(nm.prune_nm(g, n, 4)[0], n, 4)
                cu = nm.compress_nm(nm.prune_nm(u, n, 4)[0], n, 4)
                comp.append((x, cg.values, nm.pack_meta(cg.meta), cu.values,
                             nm.pack_meta(cu.meta), n))
            y = nm_spmm_dual(*comp[0])
            again = nm_spmm_dual(*comp[0])
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                fail(f"nm_spmm_dual B={b} K={k} O={o} n={n}: not the same bits on a second "
                     f"launch")
            kc = k * n // 4
            cats = [(x, torch.cat([dense_weight(vg, mg, n_), dense_weight(vu, mu, n_)], 1))
                    for _, vg, mg, vu, mu, n_ in comp[:2]]
            t_now, t_earlier = in_turns(nm_spmm_dual, comp)
            record("nm_spmm_dual", b, k, o, n, y, nm_spmm_dual_ref(*comp[0]),
                   t_now, time_ms(nm_spmm_dual_ref, comp),
                   time_ms(torch.matmul, cats),
                   2 * (b * k + 2 * kc * o + b * o) + 2 * kc * o // 4, 4 * b * kc * o,
                   earlier_ms=t_earlier, plan=nm_dual_plan(b, k, o, n))

    # the flush's other lattice points (bias, silu, gelu) at one shape
    k, o = d, cfg.attn_dim
    x, w = rand((8, k)), rand((k, o), k ** -0.5)
    bias = torch.randn(o, generator=gen, device=dev)
    c = nm.compress_nm(nm.prune_nm(w, 2, 4)[0], 2, 4)
    pm = nm.pack_meta(c.meta)
    for act in ("silu", "gelu"):
        spec = EpilogueSpec(act=act, bias=True)
        for name, got, want in (
                ("tile_gemm", tile_gemm(x, w, epilogue=spec, bias=bias),
                 tile_gemm_ref(x, w, epilogue=spec, bias=bias)),
                ("nm_spmm", nm_spmm(x, c.values, pm, 2, epilogue=spec, bias=bias),
                 nm_spmm_ref(x, c.values, pm, 2, epilogue=spec, bias=bias))):
            e = scaled_err(got, want)
            log(f"epilogue {spec.point} {name}: scaled error {e:.3e}")
            if not (e <= TOL):
                fail(f"{name} epilogue {spec.point}: error {e:.3e} > {TOL}")
    torch.cuda.synchronize()
    return rows


def int_mm_padded(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The library yardstick of the int8 kernels: torch._int_mm (cuBLASLt
    int8 x int8 -> int32), whose A must have more than 16 rows: decode
    batches are zero-padded to 32 rows."""
    if x_q.shape[0] <= 16:
        x_q = torch.cat([x_q, x_q.new_zeros((32 - x_q.shape[0], x_q.shape[1]))])
    return torch._int_mm(x_q, w_q)


def int_mm_layout():
    """The layout of B that torch._int_mm takes on this build: row-major,
    else column-major (cuBLASLt's own int8 layout); checked against the
    exact product."""
    a = torch.randint(-127, 128, (32, 64), dtype=torch.int8, device="cuda")
    b = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device="cuda")
    want = (a.double() @ b.double()).to(torch.int32)
    for name, lay in (("row-major", lambda t: t.contiguous()),
                      ("column-major", lambda t: t.t().contiguous().t())):
        try:
            ok = torch.equal(torch._int_mm(a, lay(b)), want)
        except RuntimeError as e:
            log(f"torch._int_mm with a {name} B: {str(e).splitlines()[0]}")
            continue
        if ok:
            return name, lay
    fail("torch._int_mm takes neither layout of B")


FP8 = torch.float8_e4m3fn


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor's byte view (cat, pad and transpose copies run on
    bytes: no float8 kernel is needed for them)."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def column_major(t: torch.Tensor) -> torch.Tensor:
    return as_bytes(t).t().contiguous().t().view(t.dtype)


def pad_rows(t: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """``t`` with rows appended up to ``rows`` (zeros; ``value`` for scales)."""
    pad = rows - t.shape[0]
    if pad <= 0:
        return t
    extra = torch.full((pad,) + tuple(t.shape[1:]), value, dtype=as_bytes(t).dtype,
                       device=t.device)
    return torch.cat([as_bytes(t), extra]).view(t.dtype)


def scaled_mm(x_q, w_cm, x_scale, w_scale):
    """The library yardstick of the fp8 kernels: torch._scaled_mm (cuBLASLt
    e4m3 x e4m3, row-wise scales, bf16 out).  Its A needs a multiple of 16
    rows and its B column-major: both are made outside the timed region."""
    return torch._scaled_mm(x_q, w_cm, scale_a=x_scale, scale_b=w_scale,
                            out_dtype=torch.bfloat16)


def e4m3_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|difference| of two e4m3 tensors in steps of the format (codes of
    one sign are ordered by their low 7 bits; +0 and -0 are both 0)."""
    def ordinal(t):
        b = t.view(torch.uint8).int()
        return torch.where(b >= 128, -(b - 128), b)
    return (ordinal(got) - ordinal(want)).abs()


def quantized_kernel_phase(cfg, moe_cfg, gen, card_line, rows, qdtype):
    """The int8 or the fp8 kernels against their plain versions, timed
    beside them and beside the class's library call; int8 also times the
    dense and the compressed int8 dual at ``moe_cfg``'s expert gate-up, B in
    {8, 64}."""
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    from repro_torch.kernels.nm_spmm import kernel as nk
    from repro_torch.kernels.nm_spmm import ref as nr
    from repro_torch.kernels.nm_spmm.ref import dense_weight
    from repro_torch.kernels.tile_gemm import kernel as tk
    from repro_torch.kernels.tile_gemm import ref as tr

    dev, bf16 = "cuda", torch.bfloat16
    fp8 = qdtype == FP8
    sfx = "fp8" if fp8 else "int8"
    qmax = 448.0 if fp8 else 127.0
    d, ff = cfg.d_model, cfg.d_ff
    record = recorder(rows, card_line)
    if fp8:
        lay = column_major
        log("library yardstick: torch._scaled_mm, row-wise scales, B padded to 16 rows")
    else:
        lay_name, lay = int_mm_layout()
        log(f"library yardstick: torch._int_mm with a {lay_name} B")

    def leaf(k, o, n):
        """One quantized weight as serving prepares it, with its (1, O)
        scale and the dense matrix the library call contracts."""
        w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
        if n == 4:
            lf = quantize_linear({"w": w}, qdtype)
            dense = lf["w"]
        else:
            c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
            lf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)},
                                 qdtype)
            dense = dense_weight(lf["values"], lf["meta_packed"], n)
        return {**lf, "ws": lf["scale"].reshape(1, -1), "dense": lay(dense)}

    def single(n, ref=False):
        """(x_q, x_scale, leaf) -> the scaled bf16 output; x_scale None: raw."""
        if n == 4:
            f = getattr(tr if ref else tk, f"tile_gemm_{sfx}{'_ref' if ref else ''}")
            return lambda xq, xs, lf: f(xq, lf["w"], xs, None if xs is None else lf["ws"],
                                        out_dtype=bf16)
        f = getattr(nr if ref else nk, f"nm_spmm_{sfx}{'_ref' if ref else ''}")
        return lambda xq, xs, lf: f(xq, lf["values"], lf["meta_packed"], xs,
                                    None if xs is None else lf["ws"], n, out_dtype=bf16)

    def dual(n, ref=False, requant=False, out_dtype=bf16):
        """(x_q, x_scale, g, u[, rq]) -> the dual's output: bf16, or with
        ``requant`` the narrow codes against rq."""
        tail = "_requant" if requant and not ref else ""
        if n == 4:
            f = getattr(tr if ref else tk, f"tile_gemm_dual_{sfx}{tail}{'_ref' if ref else ''}")
            lead = lambda xq, g, u: (xq, g["w"], u["w"])   # noqa: E731
        else:
            f = getattr(nr if ref else nk, f"nm_spmm_dual_{sfx}{tail}{'_ref' if ref else ''}")
            lead = lambda xq, g, u: (xq, g["values"], g["meta_packed"], u["values"],  # noqa: E731
                                     u["meta_packed"], n)
        if requant and ref:
            return lambda xq, xs, g, u, rq: f(*lead(xq, g, u), xs, g["ws"], u["ws"],
                                              requant_scale=rq)
        if requant:
            return lambda xq, xs, g, u, rq: f(*lead(xq, g, u), xs, g["ws"], u["ws"], rq)
        return lambda xq, xs, g, u: f(*lead(xq, g, u), xs, g["ws"], u["ws"],
                                      out_dtype=out_dtype)

    def library(xq, xs, lfs, cat=False):
        """The library call's operands: one weight each (or the gate-up
        pair's two, side by side)."""
        def dense(lf):
            if not cat:
                return lf["dense"]
            g, u = lf
            return lay(torch.cat([as_bytes(g["dense"]), as_bytes(u["dense"])], dim=1)
                       .view(qdtype))
        if not fp8:
            return int_mm_padded, [(xq, dense(lf)) for lf in lfs]
        xq16, xs16 = pad_rows(xq, -(-xq.shape[0] // 16) * 16), \
            pad_rows(xs, -(-xs.shape[0] // 16) * 16, 1.0)
        return scaled_mm, [(xq16, dense(lf), xs16,
                            torch.cat([lf[0]["ws"], lf[1]["ws"]], 1) if cat else lf["ws"])
                           for lf in lfs]

    def wbytes(k, o, n):
        kc = k * n // 4
        return kc * o + (kc * o // 4 if n < 4 else 0) + 4 * o   # values + meta + scale

    names = {4: (f"tile_gemm_{sfx}", f"tile_gemm_dual_{sfx}", f"tile_gemm_dual_{sfx}_requant"),
             2: (f"nm_spmm_{sfx}", f"nm_spmm_dual_{sfx}", f"nm_spmm_dual_{sfx}_requant"),
             1: (f"nm_spmm_{sfx}", f"nm_spmm_dual_{sfx}", f"nm_spmm_dual_{sfx}_requant")}

    def gate_up(b, n, k, o):
        """The gate-up pair at (k, o): the dual and its requant form against
        their plain versions, timed beside them and the library call."""
        xq, xs = quantize_rows(torch.randn((b, k), generator=gen, device=dev).to(bf16), qdtype)
        pairs = [(leaf(k, o, n), leaf(k, o, n))
                 for _ in range(copies_for(2 * wbytes(k, o, n)))]
        run, ref = dual(n), dual(n, ref=True)
        ops = [(xq, xs, g, u) for g, u in pairs]
        lib_fn, lib_ops = library(xq, xs, pairs[:2], cat=True)
        kc = k * n // 4

        def timed(f, ops_, name, requant=False):
            """The redesigned duals' own bodies (the fp8 duals and their
            requant forms, the compressed and dense int8 duals and their
            requant forms) in turns with the first one, the same bits on a
            second launch; an int8 dual's output (bf16 or codes) also bitwise
            the first body's."""
            got, again = f(*ops_[0]), f(*ops_[0])
            torch.cuda.synchronize()
            if not torch.equal(as_bytes(got), as_bytes(again)):
                fail(f"{name} B={b} K={k} O={o} n={n}: not the same bits on a second "
                     f"launch")
            extra = {}
            if not fp8:
                with earlier_kernels():
                    first = f(*ops_[0])
                torch.cuda.synchronize()
                if got.dtype != first.dtype or not torch.equal(got, first):
                    d = (got.float() - first.float()).abs().max().item()
                    fail(f"{name} B={b} K={k} O={o} n={n}: not bitwise its first body "
                         f"(max abs difference {d:.3e})")
                extra["first_body_bitwise"] = True
            t, earlier = in_turns(f, ops_)
            plan = ((tk.int8_dual_plan(b, k, o) if n == 4 else nk.int8_dual_plan(b, k, o, n))
                    if not fp8 else tk.fp8_dual_plan(b, k, o, requant) if n == 4
                    else nk.fp8_dual_plan(b, k, o, n))
            return t, {"earlier_ms": earlier, "plan": plan, **extra}
        t_run, extra = timed(run, ops, names[n][1])
        record(names[n][1], b, k, o, n, run(*ops[0]), ref(*ops[0]),
               t_run, time_ms(ref, ops), time_ms(lib_fn, lib_ops),
               b * k + 4 * b + 2 * wbytes(k, o, n) + 2 * b * o, 4 * b * kc * o,
               peak=FP8_OPS if fp8 else INT8_OPS, **extra)
        # the same pair with the requant:<dtype> flush, against the scale a
        # calibration on these rows would give w_out: absmax / qmax
        rq = dual(n, ref=True, out_dtype=torch.float32)(*ops[0]).abs().amax() / qmax
        run_q, ref_q = dual(n, requant=True), dual(n, ref=True, requant=True)
        ops_q = [op + (rq,) for op in ops]
        got, want = run_q(*ops_q[0]), ref_q(*ops_q[0])
        torch.cuda.synchronize()
        if got.dtype != qdtype or want.dtype != qdtype:
            fail(f"{names[n][2]} B={b}: codes of {got.dtype} / {want.dtype}, not {qdtype}")
        delta = e4m3_steps(got, want) if fp8 else (got.int() - want.int()).abs()
        share = (delta == 1).float().mean().item()
        if delta.max().item() > 1 or share > REQUANT_SHARE:
            fail(f"{names[n][2]} B={b} n={n}: codes off by up to {delta.max().item()} "
                 f"step(s) on {share:.2e} of the elements (> 1 or > {REQUANT_SHARE})")
        t_run, extra = timed(run_q, ops_q, names[n][2], requant=True)
        record(names[n][2], b, k, o, n, got, want, t_run,
               time_ms(ref_q, ops_q), time_ms(lib_fn, lib_ops),
               b * k + 4 * b + 2 * wbytes(k, o, n) + b * o + 4, 4 * b * kc * o,
               peak=FP8_OPS if fp8 else INT8_OPS, tol=None if fp8 else TOL,
               off_by_one_share=share, **extra)
        del pairs, ops, ops_q, lib_ops
    for b in (8, 64, 256):
        for n in (4, 2, 1):
            for k, o in ((d, cfg.attn_dim), (d, cfg.kv_dim), (ff, d)):
                xq, xs = quantize_rows(torch.randn((b, k), generator=gen, device=dev).to(bf16),
                                       qdtype)
                lfs = [leaf(k, o, n) for _ in range(copies_for(wbytes(k, o, n)))]
                run, ref = single(n), single(n, ref=True)
                raw, raw_ref = run(xq, None, lfs[0]), ref(xq, None, lfs[0])
                torch.cuda.synchronize()
                raw_err = scaled_err(raw, raw_ref)
                # int8: the exact int32 accumulator; fp8: fp32 sums in another order
                if raw.dtype != raw_ref.dtype or (not fp8 and not torch.equal(raw, raw_ref)) \
                        or not raw_err <= TOL:
                    fail(f"{names[n][0]} B={b} K={k} O={o} n={n}: raw accumulator off its "
                         f"plain version ({raw.dtype}, scaled error {raw_err:.3e})")
                ops = [(xq, xs, lf) for lf in lfs]
                lib_fn, lib_ops = library(xq, xs, lfs)
                kc = k * n // 4
                # the redesigned bodies, beside the first one
                t_run, earlier = in_turns(run, ops)
                extra = {"earlier_ms": earlier,
                         "plan": ((tk.fp8_plan if fp8 else tk.int8_plan)(b, k, o) if n == 4
                                  else (nk.fp8_plan if fp8 else nk.int8_plan)(b, k, o, n))}
                again = run(xq, None, lfs[0])
                torch.cuda.synchronize()
                if not torch.equal(raw, again):
                    fail(f"{names[n][0]} B={b} K={k} O={o} n={n}: the raw accumulator "
                         f"is not the same bits on a second launch")
                record(names[n][0], b, k, o, n, run(*ops[0]), ref(*ops[0]),
                       t_run, time_ms(ref, ops), time_ms(lib_fn, lib_ops),
                       b * k + 4 * b + wbytes(k, o, n) + 2 * b * o, 2 * b * kc * o,
                       peak=FP8_OPS if fp8 else INT8_OPS, exact=not fp8,
                       raw_scaled_err=raw_err, **extra)
                del lfs, ops, lib_ops
            # the gate-up pair at (d, ff)
            gate_up(b, n, d, ff)
        torch.cuda.empty_cache()
    # int8: the dense and the compressed dual at qwen3-moe's expert gate-up
    # (K, O) = (d_model, d_ff), which the spgemm path launches once an expert
    # and layer
    for b in (() if fp8 else (8, 64)):
        for n in (4, 2):
            gate_up(b, n, moe_cfg.d_model, moe_cfg.d_ff)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def gather_kernel_phase(cfg, gen, card_line, rows, qdtype=None):
    """K8 / K9, the lane-aligned gather kernels of one class (bf16 for
    ``qdtype=None``, int8, e4m3), against their plain versions at the
    projection shapes, n in {1, 2}, B in {8, 64, 256}, weights voted from
    random dense ones by ``convert_layout(..., "gather")``.  Timed beside
    the plain version and the class's library call on the PRE-GATHERED X
    (the gather runs outside the timed region: no library GEMM gathers):
    torch.matmul, torch._int_mm, torch._scaled_mm; for the duals the two
    library calls (gate, up) on their own gathered X.  The redesigned bodies
    (every class's K8 and K9, and the 8-bit K9's requantizing form) must
    give the same bits on a second launch and are timed in turns with their
    first bodies (``earlier_ms``), their plans beside them; int8 K9's
    output (bf16 and codes) must also be its first body's bit for bit.  Bound: values +
    index (+ scales) + x (B, K_eff) + output bytes over 3.35 TB/s."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr

    dev, bf16 = "cuda", torch.bfloat16
    fp8, int8 = qdtype == FP8, qdtype == torch.int8
    sfx = "_fp8" if fp8 else "_int8" if int8 else ""
    esz = 2 if qdtype is None else 1
    peak = BF16_FLOPS if qdtype is None else FP8_OPS if fp8 else INT8_OPS
    qmax = 448.0 if fp8 else 127.0
    d, ff = cfg.d_model, cfg.d_ff
    record = recorder(rows, card_line)
    lay = column_major if fp8 else int_mm_layout()[1] if int8 else None

    def leaf(k, o, n):
        w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
        lf = convert_layout({"w": w if qdtype else w.to(bf16)},
                            SparsityConfig(n=n, m=4, mode="gather"), "gather",
                            quantize=qdtype)
        if qdtype is not None:
            lf["ws"] = lf["scale"].reshape(1, -1)
            lf["lib"] = lay(lf["values"])
        return lf

    def wbytes(k, o, n):      # values + index (+ scale)
        kc = k * n // 4
        return esz * kc * o + 4 * kc + (4 * o if qdtype is not None else 0)

    def single(n, ref=False):
        if qdtype is None:
            f = gr.nm_spmm_gather_ref if ref else gk.nm_spmm_gather_bk
            return lambda x, xs, lf: f(x, lf["values"], lf["gather_idx"], n)
        f = gr.nm_spmm_gather_quantized_ref if ref else getattr(gk, f"nm_spmm_gather_bk{sfx}")
        return lambda x, xs, lf: f(x, lf["values"], lf["gather_idx"], xs,
                                   None if xs is None else lf["ws"], n, out_dtype=bf16)

    def dual(n, ref=False, requant=False):
        if qdtype is None:
            f = gr.nm_spmm_gather_dual_ref if ref else gk.nm_spmm_gather_dual_bk
            return lambda x, xs, g, u: f(x, g["values"], g["gather_idx"], u["values"],
                                         u["gather_idx"], n)
        if ref:
            f = gr.nm_spmm_gather_dual_quantized_ref
        else:
            f = getattr(gk, f"nm_spmm_gather_dual_bk{sfx}{'_requant' if requant else ''}")

        def run(x, xs, g, u, rq=None):
            args = (x, g["values"], g["gather_idx"], u["values"], u["gather_idx"], n, xs,
                    g["ws"], u["ws"])
            if requant:
                return f(*args, requant_scale=rq) if ref else f(*args, rq)
            return f(*args, out_dtype=bf16)
        return run

    def lib_single(x, xs, lf, n):
        """The library call and its operands on the pre-gathered X."""
        xg = gr.gather_columns(x, lf["gather_idx"], n)
        if qdtype is None:
            return torch.matmul, (xg, lf["values"])
        if int8:
            return int_mm_padded, (xg, lf["lib"])
        rows16 = -(-xg.shape[0] // 16) * 16
        return scaled_mm, (pad_rows(xg, rows16), lf["lib"], pad_rows(xs, rows16, 1.0),
                           lf["ws"])

    def library(x, xs, lfs, n):
        fn, _ = lib_single(x, xs, lfs[0], n)
        return fn, [lib_single(x, xs, lf, n)[1] for lf in lfs]

    def library_pair(x, xs, pairs, n):
        """Gate and up: two library calls, each on its own gathered X."""
        fn, _ = lib_single(x, xs, pairs[0][0], n)
        ops = [lib_single(x, xs, g, n)[1] + lib_single(x, xs, u, n)[1] for g, u in pairs]
        half = len(ops[0]) // 2
        return (lambda *a: (fn(*a[:half]), fn(*a[half:]))), ops

    for b in (8, 64, 256):
        for n in (2, 1):
            for k, o in ((d, cfg.attn_dim), (d, cfg.kv_dim), (ff, d)):
                x = torch.randn((b, k), generator=gen, device=dev).to(bf16)
                x, xs = (x, None) if qdtype is None else quantize_rows(x, qdtype)
                lfs = [leaf(k, o, n) for _ in range(copies_for(wbytes(k, o, n)))]
                run, ref = single(n), single(n, ref=True)
                if qdtype is not None:
                    raw, raw_ref = run(x, None, lfs[0]), ref(x, None, lfs[0])
                    torch.cuda.synchronize()
                    raw_err = scaled_err(raw, raw_ref)
                    if raw.dtype != raw_ref.dtype or (int8 and not torch.equal(raw, raw_ref)) \
                            or not raw_err <= TOL:
                        fail(f"nm_spmm_gather_bk{sfx} B={b} K={k} O={o} n={n}: raw "
                             f"accumulator off its plain version (scaled error {raw_err:.3e})")
                ops = [(x, xs, lf) for lf in lfs]
                lib_fn, lib_ops = library(x, xs, lfs, n)
                kc = k * n // 4
                xbytes = esz * b * k + (4 * b if qdtype is not None else 0)
                # the redesigned bodies (every class), beside the first one
                got = run(*ops[0])
                again = run(*ops[0])
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"nm_spmm_gather_bk{sfx} B={b} K={k} O={o} n={n}: not the same "
                         f"bits on a second launch")
                t_run, earlier = in_turns(run, ops)
                extra = {"earlier_ms": earlier,
                         "plan": (gk.fp8_plan if fp8 else gk.int8_plan if int8
                                  else gk.plan)(b, k, o, n)}
                record(f"nm_spmm_gather_bk{sfx}", b, k, o, n, run(*ops[0]), ref(*ops[0]),
                       t_run, time_ms(ref, ops), time_ms(lib_fn, lib_ops),
                       xbytes + wbytes(k, o, n) + 2 * b * o, 2 * b * kc * o, peak=peak,
                       exact=int8, library="pre-gathered X", **extra)
                del lfs, ops, lib_ops
            # the gate-up pair at (d, ff), two index streams
            k, o = d, ff
            x = torch.randn((b, k), generator=gen, device=dev).to(bf16)
            x, xs = (x, None) if qdtype is None else quantize_rows(x, qdtype)
            pairs = [(leaf(k, o, n), leaf(k, o, n))
                     for _ in range(copies_for(2 * wbytes(k, o, n)))]
            run, ref = dual(n), dual(n, ref=True)
            ops = [(x, xs, g, u) for g, u in pairs]
            lib_fn, lib_ops = library_pair(x, xs, pairs, n)
            kc = k * n // 4
            xbytes = esz * b * k + (4 * b if qdtype is not None else 0)
            plan = (gk.fp8_dual_plan if fp8 else gk.int8_dual_plan if int8
                    else gk.dual_plan)(b, k, o, n)

            def timed(f, ops_, name):
                """The redesigned dual (every class; the requant forms of the
                8-bit ones) in turns with its first body, the same bits on a
                second launch; int8's output (bf16 or codes) also bitwise
                the first body's."""
                got, again = f(*ops_[0]), f(*ops_[0])
                torch.cuda.synchronize()
                if not torch.equal(as_bytes(got), as_bytes(again)):
                    fail(f"{name} B={b} K={k} O={o} n={n}: not the same bits on a second "
                         f"launch")
                extra = {}
                if int8:
                    with earlier_kernels():
                        first = f(*ops_[0])
                    torch.cuda.synchronize()
                    if got.dtype != first.dtype or not torch.equal(got, first):
                        dd = (got.float() - first.float()).abs().max().item()
                        fail(f"{name} B={b} K={k} O={o} n={n}: not bitwise its first body "
                             f"(max abs difference {dd:.3e})")
                    extra["first_body_bitwise"] = True
                t, extra["earlier_ms"] = in_turns(f, ops_)
                return t, {**extra, "plan": plan}
            t_run, extra = timed(run, ops, f"nm_spmm_gather_dual_bk{sfx}")
            record(f"nm_spmm_gather_dual_bk{sfx}", b, k, o, n, run(*ops[0]), ref(*ops[0]),
                   t_run, time_ms(ref, ops), time_ms(lib_fn, lib_ops),
                   xbytes + 2 * wbytes(k, o, n) + 2 * b * o, 4 * b * kc * o, peak=peak,
                   library="two calls (gate, up) on pre-gathered X", **extra)
            if qdtype is not None:
                # the requant:<dtype> flush, against the scale a calibration on
                # these rows would give w_out: absmax / qmax
                rq = dual(n, ref=True)(*ops[0]).float().abs().amax() / qmax
                run_q, ref_q = dual(n, requant=True), dual(n, ref=True, requant=True)
                ops_q = [op + (rq,) for op in ops]
                got, want = run_q(*ops_q[0]), ref_q(*ops_q[0])
                torch.cuda.synchronize()
                name = f"nm_spmm_gather_dual_bk{sfx}_requant"
                if got.dtype != qdtype or want.dtype != qdtype:
                    fail(f"{name} B={b}: codes of {got.dtype} / {want.dtype}, not {qdtype}")
                t_q, extra = timed(run_q, ops_q, name)
                delta = e4m3_steps(got, want) if fp8 else (got.int() - want.int()).abs()
                share = (delta == 1).float().mean().item()
                if delta.max().item() > 1 or share > REQUANT_SHARE:
                    fail(f"{name} B={b} n={n}: codes off by up to {delta.max().item()} "
                         f"step(s) on {share:.2e} of the elements (> 1 or > {REQUANT_SHARE})")
                record(name, b, k, o, n, got, want, t_q,
                       time_ms(ref_q, ops_q), time_ms(lib_fn, lib_ops),
                       xbytes + 2 * wbytes(k, o, n) + b * o + 4, 4 * b * kc * o, peak=peak,
                       tol=None if fp8 else TOL, off_by_one_share=share,
                       library="two calls (gate, up) on pre-gathered X", **extra)
                del ops_q
            del pairs, ops, lib_ops
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


# the dual plans' boundary: 64-row launches (17-255 rows), where
# tile_gemm/kernel.py::dual_plan and nm_spmm_gather/kernel.py::dual_plan
# choose between the three bodies by the stream's K split (and K9 at 1:4 by
# K_c)
DUAL_SWEEP_ROWS = (17, 33, 48, 64, 128)
# nm_spmm/kernel.py::dual_plan's boundary: its 16- and 64-row streams against
# the shared body, past decode rows and at the calibration forward's 256
NM_DUAL_SWEEP_ROWS = DUAL_SWEEP_ROWS + (256,)


def dual_sweep_phase(shapes, gen, card_line):
    """Each body of the three float duals alone, through the C interface:
    the shared body (the first form), the stream at ``stream_plan``'s split
    and the wgmma body, at the gate-up pairs ``shapes`` ((K, O):
    internlm2-1.8b, phi-3-vision, qwen3-moe's experts), B in
    DUAL_SWEEP_ROWS, K9 at n in {2, 1}; the compressed nm_spmm_dual at n in
    {2, 1}: the shared body and the stream over 16-row tiles and over
    64-row ones (split at two blocks an SM, and the 64-row one also at one,
    K1's), B in NM_DUAL_SWEEP_ROWS.
    Every body must be within TOL of max|plain|; one JSON line per shape
    names the body the plan picks and every body's time (CUDA-graph
    replays, weights rotated as in the kernel phase)."""
    from repro_torch.core import nm
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels import _build
    from repro_torch.kernels.nm_spmm.kernel import dual_plan as nm_dual_plan
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_ref
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather.ref import nm_spmm_gather_dual_ref
    from repro_torch.kernels.tile_gemm.kernel import (BODY_CODES, cluster_split, dual_plan,
                                                      stream_plan)
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_ref

    dev, bf16 = "cuda", torch.bfloat16
    lib = _build.library()

    def call(name, body, bm, bn, split, n=None):
        def f(x, *w):
            b = x.shape[0]
            o = w[0].shape[1]
            y = torch.empty((b, o), dtype=bf16, device=dev)
            ptrs = [t.data_ptr() for t in (x, *w)]
            if n is None:
                rc = lib.vg_tile_gemm_dual(*ptrs, y.data_ptr(), b, x.shape[1], o, bm,
                                           BODY_CODES[body], bn, split, _build.stream_of(x))
            else:
                xg = (torch.empty((b, 2 * w[0].shape[0]), dtype=bf16, device=dev)
                      if body == "wgmma" else None)
                rc = lib.vg_nm_spmm_gather_dual_bk(*ptrs, y.data_ptr(), b, x.shape[1], o, n, bm,
                                                   BODY_CODES[body], bn, split,
                                                   None if xg is None else xg.data_ptr(),
                                                   _build.stream_of(x))
            _build.check(rc, name, lib)
            return y
        return f

    def sweep(name, weights, plain, plan_of, kc, n=None):
        k = weights[0][0].shape[0] if n is None else kc * 4 // n
        o = weights[0][0].shape[1]
        for b in DUAL_SWEEP_ROWS:
            x = torch.randn((b, k), generator=gen, device=dev).to(bf16)
            ops = [(x, *w) for w in weights]
            want = plain(*ops[0])
            ms = {}
            for body, (bm, bn, split) in (("shared", (64, 64, 1)),
                                          ("stream", (64, 64, stream_plan(b, kc, o)["split"])),
                                          ("wgmma", (128, 128, 1))):
                f = call(name, body, bm, bn, split, n)
                e = scaled_err(f(*ops[0]), want)
                if not (e <= TOL):
                    fail(f"{name} {body} body B={b} K={k} O={o} n={n}: error {e:.3e} > {TOL}")
                ms[body] = time_ms(f, ops)
            log(json.dumps({"sweep": name, "B": b, "K": k, "O": o, "n": n or 4,
                            "plan": plan_of(b, k, o)["body"], "ms": ms,
                            "stream_split": stream_plan(b, kc, o)["split"], "card": card_line}))

    def nm_dual_call(body, bm, split):
        def f(x, vg, mg, vu, mu, n):
            b, o = x.shape[0], vg.shape[1]
            y = torch.empty((b, o), dtype=bf16, device=dev)
            rc = lib.vg_nm_spmm_dual(x.data_ptr(), vg.data_ptr(), mg.data_ptr(), vu.data_ptr(),
                                     mu.data_ptr(), y.data_ptr(), b, x.shape[1], o, n, bm,
                                     BODY_CODES[body], split, _build.stream_of(x))
            _build.check(rc, "nm_spmm_dual", lib)
            return y
        return f

    def nm_dual_sweep(weights, k, o, n):
        steps = k // _build.BLOCK_K
        for b in NM_DUAL_SWEEP_ROWS:
            x = torch.randn((b, k), generator=gen, device=dev).to(bf16)
            ops = [(x, *w, n) for w in weights]
            want = nm_spmm_dual_ref(*ops[0])
            ms, splits = {}, {}
            for tag, body, bm, per_sm in (("shared", "shared", 64, None),
                                          ("stream16", "stream", 16, 2),
                                          ("stream64_1", "stream", 64, 1),
                                          ("stream64", "stream", 64, 2)):
                split = 1 if per_sm is None else cluster_split(
                    (o // _build.BLOCK_O) * -(-b // bm), steps, per_sm)
                f = nm_dual_call(body, bm, split)
                e = scaled_err(f(*ops[0]), want)
                if not (e <= TOL):
                    fail(f"nm_spmm_dual {tag} body B={b} K={k} O={o} n={n}: error {e:.3e} > {TOL}")
                ms[tag], splits[tag] = time_ms(f, ops), split
            p = nm_dual_plan(b, k, o, n)
            log(json.dumps({"sweep": "nm_spmm_dual", "B": b, "K": k, "O": o, "n": n,
                            "plan": p["body"] + (str(p["rows"]) if p["body"] == "stream" else ""),
                            "ms": ms, "splits": splits, "card": card_line}))

    for k, o in shapes:
        pairs = [tuple((torch.randn((k, o), generator=gen, device=dev) * k ** -0.5).to(bf16)
                       for _ in range(2)) for _ in range(copies_for(4 * k * o))]
        for n in (2, 1):
            comp = []
            for pair in pairs[:copies_for(k * o * n)]:
                cs = [nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4) for w in pair]
                comp.append((cs[0].values, nm.pack_meta(cs[0].meta), cs[1].values,
                             nm.pack_meta(cs[1].meta)))
            nm_dual_sweep(comp, k, o, n)
            del comp
        sweep("tile_gemm_dual", pairs, tile_gemm_dual_ref, dual_plan, k)
        for n in (2, 1):
            kc = k * n // 4
            leaves = [tuple(convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"),
                                           "gather") for w in pair) for pair in pairs]
            weights = [(g["values"], g["gather_idx"], u["values"], u["gather_idx"])
                       for g, u in leaves]
            sweep("nm_spmm_gather_dual_bk", weights,
                  lambda *a, n=n: nm_spmm_gather_dual_ref(*a, n),
                  lambda b_, k_, o_, n=n: gk.dual_plan(b_, k_, o_, n), kc, n)
            del leaves, weights
        del pairs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


# the fp8 plans' boundary: 64-row launches (17-255 rows), where
# nm_spmm/kernel.py::fp8_dual_plan, nm_spmm_gather/kernel.py::fp8_plan and
# tile_gemm/kernel.py::fp8_dual_plan choose between the shared body and
# their own
FP8_SWEEP_ROWS = (17, 33, 64, 128)


def fp8_sweep_phase(cfg, moe_cfg, gen, card_line):
    """Each body of the redesigned fp8 kernels alone, through the C
    interface, at FP8_SWEEP_ROWS, n in {2, 1}: nm_spmm_dual_fp8's shared
    body and its sparse dual stream over 64-row tiles (cluster_split's
    split) and over 16-row ones (split at FP8_STREAM16_BLOCKS_PER_SM) at the
    gate-up pairs of internlm2-1.8b and qwen3-moe's experts; K8 fp8's
    shared body, its stream over 16-row tiles and the gather pass + wgmma
    body at internlm2-1.8b's q and w_out; tile_gemm_dual_fp8's shared body,
    its dense dual stream over 16-row tiles (split at
    FP8_STREAM16_BLOCKS_PER_SM) and over 64-row ones (cluster_split's)
    and its dual wgmma body at the same two gate-up pairs; K9 fp8's shared
    body and its gathered dual stream over 16-row tiles (split at
    FP8_STREAM16_BLOCKS_PER_SM) at the same two pairs and also at 256 rows,
    the expert's also at B = 8 (the decode launch of qwen3-moe's spgemm
    gather path).  Every body
    within TOL of max|plain|; one JSON line per shape names the plan's body
    and tile rows and every body's time (CUDA-graph replays, weights
    rotated as in the kernel phase)."""
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels import _build
    from repro_torch.kernels.nm_spmm import kernel as nk
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_dual_quantized_ref
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather.ref import (nm_spmm_gather_dual_quantized_ref,
                                                         nm_spmm_gather_quantized_ref)
    from repro_torch.kernels.tile_gemm import kernel as tk
    from repro_torch.kernels.tile_gemm.kernel import (BODY_CODES, FP8_STREAM16_BLOCKS_PER_SM,
                                                      cluster_split)
    from repro_torch.kernels.tile_gemm.ref import tile_gemm_dual_quantized_ref

    dev, bf16 = "cuda", torch.bfloat16
    lib = _build.library("gemm_fp8.cu")

    def dual_call(n, body, bm, split):
        def f(x, xs, g, u):
            b, k = x.shape
            o = g["values"].shape[1]
            y = torch.empty((b, o), dtype=bf16, device=dev)
            rc = lib.vg_nm_spmm_dual_fp8(
                x.data_ptr(), g["values"].data_ptr(), g["meta_packed"].data_ptr(),
                u["values"].data_ptr(), u["meta_packed"].data_ptr(), xs.data_ptr(),
                g["ws"].data_ptr(), u["ws"].data_ptr(), None, y.data_ptr(), b, k, o, n, 0, bm,
                body, split, _build.stream_of(x))
            _build.check(rc, "nm_spmm_dual_fp8", lib)
            return y
        return f

    def dense_dual_call(body, bm, bn, split):
        def f(x, xs, g, u):
            b, k = x.shape
            o = g["w"].shape[1]
            y = torch.empty((b, o), dtype=bf16, device=dev)
            rc = lib.vg_tile_gemm_dual_fp8(
                x.data_ptr(), g["w"].data_ptr(), u["w"].data_ptr(), xs.data_ptr(),
                g["ws"].data_ptr(), u["ws"].data_ptr(), None, y.data_ptr(), b, k, o, 0, bm,
                BODY_CODES[body], bn, split, _build.stream_of(x))
            _build.check(rc, "tile_gemm_dual_fp8", lib)
            return y
        return f

    def gather_call(n, body, bm, bn, split):
        def f(x, xs, lf):
            b, k = x.shape
            kc, o = lf["values"].shape
            y = torch.empty((b, o), dtype=bf16, device=dev)
            xg = torch.empty((b, kc), dtype=FP8, device=dev) if body == "wgmma" else None
            rc = lib.vg_nm_spmm_gather_bk_fp8(
                x.data_ptr(), lf["values"].data_ptr(), lf["gather_idx"].data_ptr(),
                xs.data_ptr(), lf["ws"].data_ptr(), None, None, y.data_ptr(), b, k, o, n, 0, 0,
                bm, BODY_CODES[body], bn, split, None if xg is None else xg.data_ptr(),
                _build.stream_of(x))
            _build.check(rc, "nm_spmm_gather_bk_fp8", lib)
            return y
        return f

    def gather_dual_call(n, body, bm, split):
        def f(x, xs, g, u):
            b, k = x.shape
            o = g["values"].shape[1]
            y = torch.empty((b, o), dtype=bf16, device=dev)
            rc = lib.vg_nm_spmm_gather_dual_bk_fp8(
                x.data_ptr(), g["values"].data_ptr(), g["gather_idx"].data_ptr(),
                u["values"].data_ptr(), u["gather_idx"].data_ptr(), xs.data_ptr(),
                g["ws"].data_ptr(), u["ws"].data_ptr(), None, y.data_ptr(), b, k, o, n, 0, bm,
                BODY_CODES[body], split, _build.stream_of(x))
            _build.check(rc, "nm_spmm_gather_dual_bk_fp8", lib)
            return y
        return f

    def compressed(k, o, n):
        w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
        c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
        lf = quantize_linear({"values": c.values, "meta_packed": nm.pack_meta(c.meta)}, FP8)
        return {**lf, "ws": lf["scale"].reshape(1, -1)}

    def dense(k, o):
        lf = quantize_linear({"w": torch.randn((k, o), generator=gen, device=dev) * k ** -0.5},
                             FP8)
        return {**lf, "ws": lf["scale"].reshape(1, -1)}

    def gathered(k, o, n):
        w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
        lf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                            quantize=FP8)
        return {**lf, "ws": lf["scale"].reshape(1, -1)}

    def sweep(name, k, o, n, weights, want_of, bodies, plan_of, rows=FP8_SWEEP_ROWS):
        for b in rows:
            x, xs = quantize_rows(torch.randn((b, k), generator=gen, device=dev).to(bf16), FP8)
            ops = [(x, xs, *w) for w in weights]
            want = want_of(*ops[0])
            ms = {}
            for body, f in bodies(b):
                e = scaled_err(f(*ops[0]), want)
                if not (e <= TOL):
                    fail(f"{name} {body} body B={b} K={k} O={o} n={n}: error {e:.3e} > {TOL}")
                ms[body] = time_ms(f, ops)
            p = plan_of(b)
            log(json.dumps({"sweep": name, "B": b, "K": k, "O": o, "n": n,
                            "plan": f"{p['body']}{p['rows']}", "ms": ms, "card": card_line}))

    for k, o in ((cfg.d_model, cfg.d_ff), (moe_cfg.d_model, moe_cfg.d_ff)):
        for n in (2, 1):
            pairs = [(compressed(k, o, n), compressed(k, o, n))
                     for _ in range(copies_for(2 * (k * n // 4) * o * 5 // 4))]

            def dual_bodies(b, k=k, o=o, n=n):
                split = cluster_split((o // 64) * -(-b // 64), k // 64)
                split16 = cluster_split((o // 64) * -(-b // 16), k // 64,
                                        FP8_STREAM16_BLOCKS_PER_SM)
                return [("shared64", dual_call(n, 0, 64, 1)),
                        ("sparse64", dual_call(n, 1, 64, split)),
                        ("sparse16", dual_call(n, 1, 16, split16))]
            sweep("nm_spmm_dual_fp8", k, o, n, pairs,
                  lambda x, xs, g, u, n=n: nm_spmm_dual_quantized_ref(
                      x, g["values"], g["meta_packed"], u["values"], u["meta_packed"], n, xs,
                      g["ws"], u["ws"], out_dtype=bf16),
                  dual_bodies, lambda b, k=k, o=o, n=n: nk.fp8_dual_plan(b, k, o, n))
            del pairs
        pairs = [(dense(k, o), dense(k, o)) for _ in range(copies_for(2 * k * o))]

        def dense_dual_bodies(b, k=k, o=o):
            split = cluster_split((o // 64) * -(-b // 64), k // 64)
            split16 = cluster_split((o // 64) * -(-b // 16), k // 64,
                                    FP8_STREAM16_BLOCKS_PER_SM)
            return [("shared64", dense_dual_call("shared", 64, 64, 1)),
                    ("stream64", dense_dual_call("stream", 64, 64, split)),
                    ("stream16", dense_dual_call("stream", 16, 64, split16)),
                    ("wgmma128", dense_dual_call("wgmma", 128, 64, 1))]
        sweep("tile_gemm_dual_fp8", k, o, 4, pairs,
              lambda x, xs, g, u: tile_gemm_dual_quantized_ref(
                  x, g["w"], u["w"], xs, g["ws"], u["ws"], out_dtype=bf16),
              dense_dual_bodies, lambda b, k=k, o=o: tk.fp8_dual_plan(b, k, o))
        del pairs
    for k, o in ((cfg.d_model, cfg.attn_dim), (cfg.d_ff, cfg.d_model)):
        for n in (2, 1):
            kc = k * n // 4
            leaves = [(gathered(k, o, n),) for _ in range(copies_for(kc * o + 4 * kc))]

            def gather_bodies(b, kc=kc, o=o, n=n):
                split16 = cluster_split((o // 64) * -(-b // 16), kc // 64,
                                        FP8_STREAM16_BLOCKS_PER_SM)
                return [("shared64", gather_call(n, "shared", 64, 64, 1)),
                        ("stream16", gather_call(n, "stream", 16, 64, split16)),
                        ("wgmma128", gather_call(n, "wgmma", 128, 128, 1))]
            sweep("nm_spmm_gather_bk_fp8", k, o, n, leaves,
                  lambda x, xs, lf, n=n: nm_spmm_gather_quantized_ref(
                      x, lf["values"], lf["gather_idx"], xs, lf["ws"], n, out_dtype=bf16),
                  gather_bodies, lambda b, k=k, o=o, n=n: gk.fp8_plan(b, k, o, n))
            del leaves
    for k, o, rows in ((cfg.d_model, cfg.d_ff, FP8_SWEEP_ROWS + (256,)),
                       (moe_cfg.d_model, moe_cfg.d_ff, (8,) + FP8_SWEEP_ROWS + (256,))):
        for n in (2, 1):
            kc = k * n // 4
            pairs = [(gathered(k, o, n), gathered(k, o, n))
                     for _ in range(copies_for(2 * (kc * o + 4 * kc)))]

            def gather_dual_bodies(b, kc=kc, o=o, n=n):
                split16 = cluster_split((o // 64) * -(-b // 16), kc // 64,
                                        FP8_STREAM16_BLOCKS_PER_SM)
                return [(f"shared{_build.block_rows(b)}",
                         gather_dual_call(n, "shared", _build.block_rows(b), 1)),
                        ("stream16", gather_dual_call(n, "stream", 16, split16))]
            sweep("nm_spmm_gather_dual_bk_fp8", k, o, n, pairs,
                  lambda x, xs, g, u, n=n: nm_spmm_gather_dual_quantized_ref(
                      x, g["values"], g["gather_idx"], u["values"], u["gather_idx"], n, xs,
                      g["ws"], u["ws"], out_dtype=bf16),
                  gather_dual_bodies, lambda b, k=k, o=o, n=n: gk.fp8_dual_plan(b, k, o, n),
                  rows=rows)
            del pairs
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


# K11, the K-major gather, at the row-parallel sites' local shapes on a (1,
# 2) mesh of internlm2-1.8b: wo (K_eff = attn_dim / 2) and w_out (d_ff / 2),
# O = d_model; B = 32 (a decode batch of 8 padded to the raw partials' 32
# rows) and 256 (prefill chunks)
K11_BATCHES = (32, 256)
K11_MESH = 2


def kmajor_kernel_phase(cfg, gen, card_line, rows):
    """K11 (nm_spmm_gather, _int8, _fp8: x_t (K_eff, B) -> Y_t (O, B)) in
    every form: bf16 in / fp32 out, int8 and e4m3 raw (the accumulator a
    row-parallel rank all-reduces) and scaled, n in {2, 1}, against the
    plain versions: int8 raw and scaled BITWISE, bf16 and e4m3 within TOL
    of max|plain|.  Timed (CUDA-graph replays, cold L2) beside the plain
    version and the class's library call on the PRE-GATHERED, row-major X
    (torch.matmul / torch._int_mm / torch._scaled_mm; the gather and the
    transposes run outside the timed region).  Bound: the kept rows of
    x_t + values + index (+ scales) + output bytes over 3.35 TB/s.  The
    int8 and e4m3 forms (the bodies ``kmajor_int8_plan`` /
    ``kmajor_fp8_plan`` pick, printed) are also timed in turns with their
    first bodies (``earlier_ms``) and must give the same bits on a second
    launch.  The two transposes a row site runs around the raw form (the
    codes in, the accumulator out) are timed apart, the same way."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr

    dev, bf16 = "cuda", torch.bfloat16
    record = recorder(rows, card_line)
    int8_lay = int_mm_layout()[1]
    d = cfg.d_model
    shapes = ((cfg.attn_dim // K11_MESH, d), (cfg.d_ff // K11_MESH, d))
    for qdtype in (None, torch.int8, FP8):
        fp8, int8 = qdtype == FP8, qdtype == torch.int8
        sfx = "_fp8" if fp8 else "_int8" if int8 else ""
        esz = 2 if qdtype is None else 1
        peak = BF16_FLOPS if qdtype is None else FP8_OPS if fp8 else INT8_OPS
        fn = getattr(gk, f"nm_spmm_gather{sfx}")
        for b in K11_BATCHES:
            for n in (2, 1):
                for k, o in shapes:
                    kc = k * n // 4
                    wbytes = esz * kc * o + 4 * kc + (4 * o if qdtype is not None else 0)

                    def leaf():
                        w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
                        lf = convert_layout({"w": w if qdtype else w.to(bf16)},
                                            SparsityConfig(n=n, m=4, mode="gather"), "gather",
                                            quantize=qdtype)
                        lf["idx"] = lf["gather_idx"].reshape(-1, 1)
                        if qdtype is not None:
                            lf["ws"] = lf["scale"].reshape(-1, 1)
                            lf["lib_w"] = (column_major(lf["values"]) if fp8
                                           else int8_lay(lf["values"]))
                            lf["lib_ws"] = lf["scale"].reshape(1, -1)
                        return lf
                    lfs = [leaf() for _ in range(copies_for(wbytes))]
                    x = torch.randn((b, k), generator=gen, device=dev).to(bf16)
                    if qdtype is None:
                        xq, xs = x, None
                    else:
                        xq, xs = quantize_rows(x, qdtype)
                    x_t = as_bytes(xq).t().contiguous().view(xq.dtype)
                    xs_t = None if xs is None else xs.reshape(1, -1)
                    # the library's operands: X gathered, row-major (B, K_c)
                    lib = []
                    for lf in lfs:
                        xg = gr.gather_columns(xq, lf["gather_idx"], n)
                        lib.append((xg, lf["values"]) if qdtype is None else
                                   (xg, lf["lib_w"]) if int8 else
                                   (xg, lf["lib_w"], xs, lf["lib_ws"]))
                    lib_fn = torch.matmul if qdtype is None else int_mm_padded if int8 \
                        else scaled_mm
                    forms = (("", False),) if qdtype is None else (("_raw", True), ("", False))
                    for tag, raw in forms:
                        if qdtype is None:
                            run = lambda xt, lf: fn(xt, lf["values"], lf["idx"], n)
                            ref = lambda xt, lf: gr.nm_spmm_gather_t_ref(
                                xt, lf["values"], lf["idx"], n)
                        elif raw:
                            run = lambda xt, lf: fn(xt, lf["values"], lf["idx"], None, None, n)
                            ref = lambda xt, lf: gr.nm_spmm_gather_t_quantized_ref(
                                xt, lf["values"], lf["idx"], None, None, n)
                        else:
                            run = lambda xt, lf: fn(xt, lf["values"], lf["idx"], xs_t,
                                                    lf["ws"], n)
                            ref = lambda xt, lf: gr.nm_spmm_gather_t_quantized_ref(
                                xt, lf["values"], lf["idx"], xs_t, lf["ws"], n)
                        ops = [(x_t, lf) for lf in lfs]
                        got, want = run(*ops[0]), ref(*ops[0])
                        torch.cuda.synchronize()
                        if got.dtype != want.dtype or got.shape != (o, b):
                            fail(f"nm_spmm_gather{sfx}{tag} B={b} K={k} n={n}: "
                                 f"{got.dtype} {tuple(got.shape)} vs {want.dtype}")
                        # the kc kept rows of x_t, values, index, the scales of a
                        # scaled form, fp32 / int32 out
                        scales = 4 * (b + o) if qdtype is not None and not raw else 0
                        nbytes = esz * b * kc + esz * kc * o + 4 * kc + scales + 4 * b * o
                        extra = {}
                        if qdtype is not None:   # the redesigned body, beside the first one
                            again = run(*ops[0])
                            torch.cuda.synchronize()
                            if not torch.equal(got, again):
                                fail(f"nm_spmm_gather{sfx}{tag} B={b} K={k} n={n}: not the "
                                     f"same bits on a second launch")
                            t_run, extra["earlier_ms"] = in_turns(run, ops)
                            extra["plan"] = (gk.kmajor_fp8_plan if fp8
                                             else gk.kmajor_int8_plan)(b, k, o, n)
                        else:
                            t_run = time_ms(run, ops)
                        record(f"nm_spmm_gather{sfx}{tag}", b, k, o, n, got, want,
                               t_run, time_ms(ref, ops), time_ms(lib_fn, lib),
                               nbytes, 2 * b * kc * o, peak=peak,
                               exact=int8, library="pre-gathered, row-major X", **extra)
                        if raw and n == 2:
                            # the row site's two transposes around K11
                            # (dispatch._partial_nm_gather_q, _run_sharded):
                            # the padded codes in, the accumulator out
                            row = {"kernel": f"nm_spmm_gather{sfx}_transposes", "B": b,
                                   "K": k, "O": o, "n": n,
                                   "in_ms": time_ms(lambda t: t.t().contiguous(), [(xq,)]),
                                   "out_ms": time_ms(lambda t: t.t().contiguous(), [(got,)]),
                                   "card": card_line}
                            rows.append(row)
                            log(json.dumps(row))
                    del lfs, lib
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


# K0's remainder at gemma3-1b's gelu w_in, (K, O) = (d_model, d_ff): the
# single GEMMs with the requant:<dtype> flush.  Gather 1:4 contracts K * n /
# 4 = 288 rows there, not a multiple of the kernels' 64, and is left out.
REQUANT_LAYOUTS = (("dense", 4), ("compressed", 2), ("compressed", 1), ("gather", 2))
# (kernel module, wrapper base name) of each layout
LAYOUT_MODULES = {"dense": ("tile_gemm", "tile_gemm"), "compressed": ("nm_spmm", "nm_spmm"),
                  "gather": ("nm_spmm_gather", "nm_spmm_gather_bk")}


def requant_single_phase(cfg, gen, card_line, rows, qdtype):
    """The six ``*_requant`` singles of one class (int8 or e4m3) at the
    gelu w_in shape, B in {8, 64, 256}, act gelu, against the scale a
    calibration on these rows would give w_out (absmax / qmax): int8 codes
    equal to the plain version's, e4m3 codes but one step on at most
    REQUANT_SHARE of them.  Timed in turns with the first body
    (``earlier_ms``, the plan printed), beside the plain version, the unfused
    path the port ran before the single-GEMM requantize (the same kernel
    storing bf16 rows, then ``quantize_rows_static`` against the same
    scale) and the class's library call on the same operands
    (torch._int_mm / torch._scaled_mm on the dense or decompressed weight,
    the gather's on the pre-gathered X).  Bound: x codes and scales, the
    weight bytes, the scale and one byte per output."""
    from repro_torch.core.quantize import quantize_rows, quantize_rows_static
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.epilogue import EpilogueSpec
    from repro_torch.kernels.nm_spmm.ref import dense_weight
    from repro_torch.kernels.nm_spmm_gather.ref import gather_columns

    dev, bf16 = "cuda", torch.bfloat16
    fp8 = qdtype == FP8
    cls, qmax = ("fp8", 448.0) if fp8 else ("int8", 127.0)
    lay = column_major if fp8 else int_mm_layout()[1]
    k, o = cfg.d_model, cfg.d_ff
    gelu = EpilogueSpec(act="gelu")
    record = recorder(rows, card_line)
    for layout, n in REQUANT_LAYOUTS:
        modname, base = LAYOUT_MODULES[layout]
        km = importlib.import_module(f"repro_torch.kernels.{modname}.kernel")
        rm = importlib.import_module(f"repro_torch.kernels.{modname}.ref")
        fn, single = getattr(km, f"{base}_{cls}_requant"), getattr(km, f"{base}_{cls}")
        ref = getattr(rm, f"{modname}_{cls}_requant_ref")
        nn = () if layout == "dense" else (n,)
        mode = "gather" if layout == "gather" else "compressed"

        def leaf():
            w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
            lf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode=mode),
                                layout if n < 4 else "dense", quantize=qdtype)
            lf["ws"] = lf["scale"].reshape(1, -1)
            if layout == "dense":
                lf["ops"], dense = (lf["w"],), lf["w"]
            elif layout == "compressed":
                lf["ops"] = (lf["values"], lf["meta_packed"])
                dense = dense_weight(lf["values"], lf["meta_packed"], n)
            else:
                lf["ops"], dense = (lf["values"], lf["gather_idx"]), lf["values"]
            lf["lib"] = lay(dense)
            return lf

        kc = k * n // 4
        wb = kc * o + (kc * o // 4 if layout == "compressed" else
                       4 * kc if layout == "gather" else 0) + 4 * o
        lfs = [leaf() for _ in range(copies_for(wb))]
        name = f"{base}_{cls}_requant"
        for b in (8, 64, 256):
            xq, xs = quantize_rows(torch.randn((b, k), generator=gen, device=dev).to(bf16),
                                   qdtype)
            y = single(xq, *lfs[0]["ops"], xs, lfs[0]["ws"], *nn, epilogue=gelu)
            rq = (y.float().abs().amax() / qmax).reshape(())

            def run(xq_, xs_, lf, rq_=rq):
                return fn(xq_, *lf["ops"], xs_, lf["ws"], *nn, rq_, epilogue=gelu)

            def plain(xq_, xs_, lf, rq_=rq):
                return ref(xq_, *lf["ops"], xs_, lf["ws"], *nn, rq_, epilogue=gelu)

            def unfused(xq_, xs_, lf, rq_=rq):
                h = single(xq_, *lf["ops"], xs_, lf["ws"], *nn, epilogue=gelu, out_dtype=bf16)
                return quantize_rows_static(h, rq_, qdtype)[0]

            before = fn.launches
            got, want = run(xq, xs, lfs[0]), plain(xq, xs, lfs[0])
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                fail(f"{name}: the wrapper did not count its launch")
            if got.dtype != qdtype or want.dtype != qdtype:
                fail(f"{name} B={b}: codes of {got.dtype} / {want.dtype}, not {qdtype}")
            delta = e4m3_steps(got, want) if fp8 else (got.int() - want.int()).abs()
            share = (delta == 1).float().mean().item()
            if delta.max().item() > 1 or share > REQUANT_SHARE:
                fail(f"{name} B={b} n={n}: codes off by up to {delta.max().item()} step(s) "
                     f"on {share:.2e} of the elements (> 1 or > {REQUANT_SHARE})")
            # the int8 singles' bodies (the s8 streams, the first body) sum
            # exactly: their codes are the plain version's
            if not fp8 and delta.max().item() != 0:
                fail(f"{name} B={b} n={n}: codes off by up to {delta.max().item()} code(s) "
                     f"on {share:.2e} of the elements (not 0)")
            ops = [(xq, xs, lf) for lf in lfs]
            if layout == "gather":
                xl = [gather_columns(xq, lf["gather_idx"], n) for lf in lfs]
            else:
                xl = [xq] * len(lfs)
            if fp8:
                r16 = -(-b // 16) * 16
                lib_fn = scaled_mm
                lib_ops = [(pad_rows(x_, r16), lf["lib"], pad_rows(xs, r16, 1.0), lf["ws"])
                           for x_, lf in zip(xl, lfs)]
            else:
                lib_fn, lib_ops = int_mm_padded, [(x_, lf["lib"]) for x_, lf in zip(xl, lfs)]
            # the redesigned bodies (every one now), beside the first one
            t_run, earlier = in_turns(run, ops)
            dims = (b, k, o) if layout == "dense" else (b, k, o, n)
            plan = (km.fp8_plan(*dims, **({} if layout == "compressed" else {"requant": True}))
                    if fp8 else km.int8_plan(*dims))
            extra = {"earlier_ms": earlier, "plan": plan}
            record(name, b, k, o, n, got, want, t_run, time_ms(plain, ops),
                   time_ms(lib_fn, lib_ops), b * k + 4 * b + wb + b * o + 4, 2 * b * kc * o,
                   peak=FP8_OPS if fp8 else INT8_OPS, tol=None, off_by_one_share=share,
                   unfused_ms=time_ms(unfused, ops), act="gelu",
                   library="pre-gathered X" if layout == "gather" else "same operands",
                   **extra)
            del ops, lib_ops, xl
        del lfs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


# the qwen3-moe expert shapes of the K10 phase: w_out (K = d_ff, O = d_model)
# and the gate-up's (d_model, d_ff); live shares of the (row block, K step)
# tiles: none (launch + flush), about 40%, all (the MASKED flag's overhead)
MASKED_SHAPES = ((1536, 4096), (4096, 1536))
LIVE_SHARES = (0.0, 0.4, 1.0)
MASKED_LAYOUTS = (("dense", 4), ("compressed", 2), ("compressed", 1), ("gather", 2),
                  ("gather", 1))
MASKED_NAMES = {"dense": "tile_gemm_masked", "compressed": "nm_spmm_masked",
                "gather": "nm_spmm_gather_bk_masked"}


def masked_kernel_phase(gen, card_line, rows, qdtype=None):
    """K10, the masked kernels of one class (bf16 for ``qdtype=None``, int8,
    e4m3), at the MoE expert shapes, B in {8, 64}, n in {1, 2}, with
    LIVE_SHARES of the K steps live in the row block (whole 64-column
    steps, or 256 / n columns for gather, zeroed in X).  Each output must
    be BITWISE the unmasked kernel's on the same masked X (where the
    unmasked kernel runs a body of its own that sums in another order:
    bitwise the masked kernel with every tile live, and within TOL of the
    unmasked one) and within the class's limit of the plain version (int8
    bitwise).  The bf16 nm_spmm_masked, nm_spmm_masked_fp8, the bf16
    tile_gemm_masked, tile_gemm_masked_fp8, the bf16
    nm_spmm_gather_bk_masked, nm_spmm_masked_int8, tile_gemm_masked_int8,
    nm_spmm_gather_bk_masked_int8 and nm_spmm_gather_bk_masked_fp8 run their
    twins' streams at their twins' splits (K2's, nm_spmm_fp8's, K1's below
    256 rows, tile_gemm_fp8's where it streams, K8's where it streams,
    nm_spmm_int8's, tile_gemm_int8's, K8 int8's at the maps' row block, K8
    fp8's where masked_fp8_plan streams) and are held bitwise to the twin;
    every one is timed in turns with its first (shared) body
    (``earlier_ms``); the three int8 ones are held bitwise to their first
    bodies too (bf16, fp32, the raw int32, and at ~40% live the codes),
    each quantized row printing its plan.  Timed beside the
    unmasked kernel, the plain version and the class's library call on the
    same masked X (torch.matmul / torch._int_mm / torch._scaled_mm on the
    dense or decompressed weight, the gather's on the pre-gathered X);
    the bound counts the live tiles only: X's live tiles, the weight rows
    of the live steps, the scales, the map and the output, and 2 * rows *
    64 * O operations per live tile.  The quantized ones also run the
    requant:<dtype> flush (gelu) at about 40% live, bitwise the unmasked
    ``*_requant`` kernel's codes on the same rows."""
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_linear, quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels import _build
    from repro_torch.kernels.actsparse import block_maps
    from repro_torch.kernels.epilogue import EpilogueSpec
    from repro_torch.kernels.nm_spmm import kernel as nk
    from repro_torch.kernels.nm_spmm.ref import dense_weight
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather.ref import gather_columns
    from repro_torch.kernels.tile_gemm import kernel as tk

    dev, bf16 = "cuda", torch.bfloat16
    fp8, int8 = qdtype == FP8, qdtype == torch.int8
    sfx = "_fp8" if fp8 else "_int8" if int8 else ""
    esz = 2 if qdtype is None else 1
    peak = BF16_FLOPS if qdtype is None else FP8_OPS if fp8 else INT8_OPS
    lay = column_major if fp8 else int_mm_layout()[1] if int8 else None
    mods = {"dense": tk, "compressed": nk, "gather": gk}
    record = recorder(rows, card_line)

    def leaf(layout, k, o, n):
        w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
        w = w if qdtype else w.to(bf16)
        if layout == "gather":
            lf = convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                                quantize=qdtype)
            dense = lf["values"]
        elif layout == "compressed":
            c = nm.compress_nm(nm.prune_nm(w, n, 4)[0], n, 4)
            lf = {"values": c.values, "meta_packed": nm.pack_meta(c.meta)}
            lf = quantize_linear(lf, qdtype) if qdtype else lf
            dense = dense_weight(lf["values"], lf["meta_packed"], n)
        else:
            lf = quantize_linear({"w": w}, qdtype) if qdtype else {"w": w}
            dense = lf["w"]
        if qdtype is not None:
            lf["ws"] = lf["scale"].reshape(1, -1)
        lf["lib"] = lay(dense) if lay else dense
        return lf

    def ops_of(layout, lf):
        return ((lf["w"],) if layout == "dense" else
                (lf["values"], lf["meta_packed"] if layout == "compressed" else lf["gather_idx"]))

    def wbytes(layout, k, o, n):
        kc = k * n // 4
        extra = kc * o // 4 if layout == "compressed" else 4 * kc if layout == "gather" else 0
        return esz * kc * o + extra + (4 * o if qdtype is not None else 0)

    def call(fn, layout, n, x, xs, lf, maps=()):
        """One wrapper call, masked (with maps) or not, bf16 out."""
        scales = () if qdtype is None else (xs, lf["ws"])
        nn = () if layout == "dense" else (n,)
        kw = {} if qdtype is None else {"out_dtype": bf16}
        tail = (*maps, *nn, *scales) if maps else (*scales, *nn)
        return fn(x, *ops_of(layout, lf), *tail, **kw)

    def library(layout, n, x, xs, lf):
        xl = gather_columns(x, lf["gather_idx"], n) if layout == "gather" else x
        if qdtype is None:
            return torch.matmul, (xl, lf["lib"])
        if int8:
            return int_mm_padded, (xl, lf["lib"])
        rows16 = -(-xl.shape[0] // 16) * 16
        return scaled_mm, (pad_rows(xl, rows16), lf["lib"], pad_rows(xs, rows16, 1.0), lf["ws"])

    def held_to_first_body(x, xs, lf, maps, bb):
        """A masked int8 kernel on its s8 stream: bf16, fp32 and the raw
        int32, each bitwise its first body (``earlier_kernels``), its
        unmasked twin and its plain version on the same masked rows."""
        nn = () if layout == "dense" else (n,)
        w_ops = ops_of(layout, lf)
        blocks = {"block_b": bb, **({} if layout == "gather" else {"block_k": 64})}
        for scales, kw in (((xs, lf["ws"]), {"out_dtype": bf16}),
                           ((xs, lf["ws"]), {"out_dtype": torch.float32}), ((None, None), {})):
            got = masked_fn(x, *w_ops, *maps, *nn, *scales, **kw)
            with earlier_kernels():
                first = masked_fn(x, *w_ops, *maps, *nn, *scales, **kw)
            twin = plain_fn(x, *w_ops, *scales, *nn, **kw)
            want = ref_fn(x, *w_ops, *maps, *nn, *scales, **blocks, **kw)
            torch.cuda.synchronize()
            for what, other in (("first body", first), ("unmasked twin", twin),
                                ("plain version", want)):
                if not torch.equal(got, other):
                    fail(f"{base}{sfx} B={b} K={k} O={o} n={n} {got.dtype}: not bitwise its "
                         f"{what} ({scaled_err(got, other):.3e})")

    for layout, n in MASKED_LAYOUTS:
        mod = mods[layout]
        base = MASKED_NAMES[layout]
        ref_mod, base_plain = LAYOUT_MODULES[layout]
        masked_fn = getattr(mod, f"{base}{sfx}")
        plain_fn = getattr(mod, f"{base_plain}{sfx}")
        def own_body_at(b, k, o, requant=False):
            """Whether the unmasked kernel sums in another order than the
            masked one: K1 and tile_gemm_fp8 where they run their wgmma
            bodies (from 256 rows), the bf16 K8 where its plan's body is not
            masked_plan's (its wgmma body from 256 rows, its 1:4 stream up
            to 16 rows), and K8 fp8 where its plan streams and
            masked_fp8_plan keeps the shared body (the expert's w_out at
            17-64 rows).  The bf16 nm_spmm_masked, nm_spmm_masked_fp8, the
            bf16 tile_gemm_masked below 256 rows, tile_gemm_masked_fp8
            wherever tile_gemm_fp8 streams, the bf16 nm_spmm_gather_bk_masked
            at 2:4 below 256 rows, nm_spmm_masked_int8 (n in {1, 2}),
            tile_gemm_masked_int8, nm_spmm_gather_bk_masked_int8 (n in {1,
            2}) and nm_spmm_gather_bk_masked_fp8 wherever masked_fp8_plan
            streams run their twins' streams at their twins' splits: bitwise
            the twin."""
            if layout == "dense" and qdtype is None:
                return tk.plan(b, k, o)["body"] == "wgmma"
            if layout == "gather" and qdtype is None:
                return gk.plan(b, k, o, n)["body"] != gk.masked_plan(b, k, o, n)["body"]
            if layout == "gather" and fp8:
                return (gk.fp8_plan(b, k, o, n, requant=requant)["body"]
                        != gk.masked_fp8_plan(b, k, o, n, requant=requant)["body"])
            if layout == "dense" and fp8:
                return (tk.fp8_plan(b, k, o, requant=requant)["body"]
                        != tk.masked_fp8_plan(b, k, o, requant=requant)["body"])
            return False
        ref_fn = getattr(importlib.import_module(f"repro_torch.kernels.{ref_mod}.ref"),
                         f"{ref_mod}_masked{'_quantized' if qdtype else ''}_ref")
        ref_kw = {**({} if layout == "gather" else {"block_k": 64}),
                  **({} if qdtype is None else {"out_dtype": bf16})}
        step = 256 // n if layout == "gather" else 64
        for k, o in MASKED_SHAPES:
            lfs = [leaf(layout, k, o, n) for _ in range(copies_for(wbytes(layout, k, o, n)))]
            for b in (8, 64):
                bb = _build.block_rows(b)
                own_body = own_body_at(b, k, o)
                nk_ = k // step
                x_full = torch.randn((b, k), generator=gen, device=dev).to(bf16)
                unmasked_ms = plain_ms = library_ms = None
                for share in LIVE_SHARES:
                    live = torch.zeros(nk_, dtype=torch.bool, device=dev)
                    pick = torch.randperm(nk_, generator=gen, device=dev)[:round(share * nk_)]
                    live[pick] = True
                    x = x_full * live.repeat_interleave(step).to(bf16)
                    xs = None
                    if qdtype is not None:
                        x, xs = quantize_rows(x, qdtype)
                    maps = block_maps(x, bb, step)
                    got = call(masked_fn, layout, n, x, xs, lfs[0], maps)
                    full = call(plain_fn, layout, n, x, xs, lfs[0])
                    if own_body:
                        # the unmasked kernel sums in its own order: the masked
                        # kernel is held to itself with every tile live
                        same = call(masked_fn, layout, n, x, xs, lfs[0],
                                    (maps[0], torch.ones_like(maps[1])))
                    torch.cuda.synchronize()
                    if own_body and not scaled_err(got, full) <= TOL:
                        fail(f"{base} B={b} K={k} O={o} n={n} live={share}: off its unmasked "
                             f"kernel by {scaled_err(got, full):.3e} > {TOL}")
                    if not torch.equal(got, same if own_body else full):
                        fail(f"{base}{sfx} B={b} K={k} O={o} n={n} live={share}: not bitwise "
                             f"its {'all-live self' if own_body else 'unmasked kernel'} "
                             f"({scaled_err(got, same if own_body else full):.3e})")
                    def plain(x_, xs_, lf_, maps=maps, bb=bb):
                        """The plain version of the masked kernel, on the card."""
                        return ref_fn(x_, *ops_of(layout, lf_), *maps,
                                      *(() if layout == "dense" else (n,)),
                                      *(() if qdtype is None else (xs_, lf_["ws"])),
                                      block_b=bb, **ref_kw)

                    want = plain(x, xs, lfs[0])
                    ops = [(x, xs, lf) for lf in lfs]
                    extra = {}
                    masked_call = (lambda x_, xs_, lf_, maps=maps: call(
                        masked_fn, layout, n, x_, xs_, lf_, maps))
                    # the redesigned stream, in turns with its first (shared) body
                    t_m, extra["earlier_ms"] = in_turns(masked_call, ops)
                    if layout == "gather" and qdtype is not None:
                        extra["plan"] = (gk.masked_int8_plan(b, k, o, n) if int8
                                         else gk.masked_fp8_plan(b, k, o, n))
                    if int8:
                        if layout != "gather":
                            extra["plan"] = (tk.masked_int8_plan(b, k, o) if layout == "dense"
                                             else {**nk.int8_plan(b, k, o, n), "rows": bb})
                        held_to_first_body(x, xs, lfs[0], maps, bb)
                    if unmasked_ms is None:   # neither depends on the live share
                        unmasked_ms = time_ms(lambda x_, xs_, lf_: call(
                            plain_fn, layout, n, x_, xs_, lf_), ops)
                        plain_ms = time_ms(plain, ops)
                        lib_fn, _ = library(layout, n, x, xs, lfs[0])
                        library_ms = time_ms(lib_fn, [library(layout, n, x, xs, lf)[1]
                                                      for lf in lfs])
                    n_live = int(maps[1].sum().item())
                    live_rows = n_live * min(b, bb)
                    kc_live = n_live * 64              # weight rows of the live steps
                    wb = wbytes(layout, k, o, n) * n_live // max(nk_, 1)
                    nbytes = (esz * live_rows * step + wb + 4 * maps[1].numel()
                              + (4 * b if qdtype is not None else 0) + 2 * b * o)
                    record(f"{base}{sfx}", b, k, o, n, got, want, t_m, plain_ms, library_ms,
                           nbytes, 2 * live_rows * 64 * o if kc_live else 0, peak=peak,
                           exact=int8, live_share=n_live / nk_, unmasked_ms=unmasked_ms,
                           bitwise_unmasked=not own_body, bitwise_all_live_self=own_body,
                           library="same masked X"
                           + (", pre-gathered" if layout == "gather" else ""), **extra)
                    if qdtype is not None and 0 < share < 1:
                        # the requant:<dtype> flush (gelu) on the masked kernel: the
                        # codes of the unmasked *_requant kernel on the same rows
                        rq = (full.float().abs().amax() / (448.0 if fp8 else 127.0)).reshape(())
                        nn = () if layout == "dense" else (n,)
                        gelu = EpilogueSpec(act="gelu")
                        codes = masked_fn(x, *ops_of(layout, lfs[0]), *maps, *nn, xs,
                                          lfs[0]["ws"], epilogue=gelu, requant_scale=rq)
                        unmasked = getattr(mod, f"{base_plain}{sfx}_requant")(
                            x, *ops_of(layout, lfs[0]), xs, lfs[0]["ws"], *nn, rq,
                            epilogue=gelu)
                        own_codes = own_body_at(b, k, o, requant=True)
                        same = masked_fn(x, *ops_of(layout, lfs[0]), maps[0],
                                         torch.ones_like(maps[1]), *nn, xs, lfs[0]["ws"],
                                         epilogue=gelu, requant_scale=rq) if own_codes \
                            else unmasked
                        if int8:   # the first body's codes too
                            with earlier_kernels():
                                first = masked_fn(x, *ops_of(layout, lfs[0]), *maps, *nn, xs,
                                                  lfs[0]["ws"], epilogue=gelu, requant_scale=rq)
                            torch.cuda.synchronize()
                            if not torch.equal(codes, first):
                                fail(f"{base}{sfx} B={b} K={k} O={o} n={n}: the requantized "
                                     f"codes are not bitwise the first body's")
                        torch.cuda.synchronize()
                        if codes.dtype != qdtype or not torch.equal(as_bytes(codes),
                                                                    as_bytes(same)):
                            fail(f"{base}{sfx} B={b} K={k} O={o} n={n}: the requantizing "
                                 f"flush is not bitwise the "
                                 f"{'all-live codes of the masked' if own_codes else 'unmasked'}"
                                 f" requant kernel's")
                        if own_codes:   # its own body's codes: one e4m3 step apart at most
                            delta = e4m3_steps(codes, unmasked)
                            step_share = (delta == 1).float().mean().item()
                            if delta.max().item() > 1 or step_share > REQUANT_SHARE:
                                fail(f"{base}{sfx} B={b} K={k} O={o} n={n}: requantized codes "
                                     f"off the unmasked kernel's by up to "
                                     f"{delta.max().item()} step(s) on {step_share:.2e} of "
                                     f"them (> 1 or > {REQUANT_SHARE})")
            del lfs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


ATTN_SHAPES = ((8, 32), (1, 512), (1, 2048))    # (B, T): calibration, then prefill
# hubert-xlarge: 10 s and 30 s clips at 50 frames a second (both ragged);
# phi-3-vision: its prefill batch (256 patches + 256 tokens), then 2048
HUBERT_ATTN_SHAPES = ((8, 500), (2, 1500))
PHI3_ATTN_SHAPES = ((2, 512), (1, 2048))


def attention_phase(cfg, gen, card_line, rows, shapes=ATTN_SHAPES):
    """flash_attention against its plain version at ``cfg``'s heads,
    head_dim and causal flag (internlm2-1.8b: 16 over 8 of 128; gemma3-1b:
    4 over 1 of 256; hubert-xlarge: 16 over 16 of 80, non-causal;
    phi-3-vision: 32 over 32 of 96), timed beside it and beside
    F.scaled_dot_product_attention on the same (GQA) inputs.  q, k and v
    are views of (B, T, H, D) projections, as the model passes them.
    Bound: q, k, v and o moved once; 4 * D flops per (query, key) pair the
    run scores (causal: at or below the diagonal; not causal: all T^2)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    hq, hkv, d, causal = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.causal

    def kernel(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    def plain(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    for b, t in shapes:
        nbytes = 2 * b * t * d * (2 * hq + 2 * hkv)
        flops = 4 * d * hq * b * (t * (t + 1) // 2 if causal else t * t)
        ops = [tuple(torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
                     .transpose(1, 2) for h in (hq, hkv, hkv))
               for _ in range(copies_for(nbytes))]
        before = flash_attention.launches
        got = kernel(*ops[0])
        torch.cuda.synchronize()
        if flash_attention.launches != before + 1:
            fail("flash_attention: the wrapper did not count its launch")
        want = plain(*ops[0])
        if got.shape != want.shape or not torch.isfinite(got.float()).all():
            fail(f"flash_attention B={b} T={t} D={d}: shape {tuple(got.shape)} or non-finite")
        e = row_scaled_err(got, want)
        bmsv, by = bound_ms(nbytes, flops)
        t_now, t_earlier = in_turns(kernel, ops)
        row = {"kernel": "flash_attention", "B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d,
               "causal": causal,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "scaled_err": scaled_err(got, want), "row_scaled_err": e,
               "kernel_ms": t_now, "earlier_ms": t_earlier,
               "plain_ms": time_ms(plain, ops), "library_ms": time_ms(sdpa, ops),
               "bound_ms": bmsv, "bound_by": by, "card": card_line}
        rows.append(row)
        log(json.dumps(row))
        if not (e <= ATTN_TOL):
            fail(f"flash_attention B={b} T={t} D={d} causal={causal}: a row's error "
                 f"{e:.3e} > {ATTN_TOL} of its own max")
        del ops
    torch.cuda.synchronize()


def quantize_pass(width: int, dtype, rows: int = 8) -> dict:
    """What the activation quantize pass (plain torch, ``quantize_rows``,
    run once per quantized linear site and step) costs on the card for one
    class: kernel launches and device ms of one call at decode width."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.quantize import quantize_rows

    x = torch.randn((rows, width), device="cuda").bfloat16()
    quantize_rows(x, dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        quantize_rows(x, dtype)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return {"launches_per_call": sum(e.count for e in kern),
            "device_ms_per_call": sum(e.self_device_time_total for e in kern) / 1e3,
            "kernels": sorted({e.key[:60] for e in kern})}


# --------------------------------------------------------------- phase 3
CLASSES = ((None, False), ("int8", False), ("int8", True), ("fp8", False), ("fp8", True))
# (layout, sparsity, qdtype, static, depth): internlm2-1.8b's 25 runs, cut
# from 24 layers to 2 so that the MoE runs fit the time limit (full width;
# their kernels are held at full width in the kernel phases)
LAYOUTS = tuple((layout, sparsity, qdtype, static, 2)
                for qdtype, static in CLASSES
                for layout, sparsity in (("dense", None), ("compressed", (2, 4)),
                                         ("compressed", (1, 4)), ("gather", (2, 4)),
                                         ("gather", (1, 4))))
# qwen3-moe-235b-a22b at full width, cut to 2 of its 94 layers: the gather
# expert path (the MoE default) in dense bf16, and the spgemm path (the
# masked K10 kernels on every expert's w_out) in dense / compressed 2:4 /
# gather 2:4 x bf16 / int8 with static scales / fp8 dynamic:
# (expert path, layout, sparsity, qdtype, static)
MOE_ARCH, MOE_DEPTH = "qwen3_moe_235b_a22b", 2
# ... serving the first 8 of the seeded trace's 16 requests: a decode step
# issues 8,000-12,000 launches from Python, so the whole trace would take
# the MoE runs alone past the time limit (PERF.md section 4)
MOE_REQUESTS = 8
MOE_RUNS = (("gather", "dense", None, None, False),) + tuple(
    ("spgemm", layout, sparsity, qdtype, static)
    for qdtype, static in ((None, False), ("int8", True), ("fp8", False))
    for layout, sparsity in (("dense", None), ("compressed", (2, 4)), ("gather", (2, 4))))
# gemma3-1b at full width and all 26 layers (local/global attention, a gelu
# MLP, head_dim 256, tied embeddings): bf16 dense, then static int8 and
# static fp8 in each of dense, compressed 2:4 and gather 2:4.  Gather 1:4 is
# left out: K * n / 4 = 288 for d_model 1152 is not a multiple of 64, so its
# q/k/v sites would plan no-kernel-fits.  (layout, sparsity, qdtype, static,
# depth)
GEMMA_ARCH = "gemma3_1b"
GEMMA_RUNS = (("dense", None, None, False, 26),) + tuple(
    (layout, sparsity, qdtype, True, 26) for qdtype in ("int8", "fp8")
    for layout, sparsity in (("dense", None), ("compressed", (2, 4)), ("gather", (2, 4))))
# gemma3's trace: the seeded 16 requests with 4 of them (every 4th) given
# prompts of 576-768 tokens and max_len 1024, so decode positions pass the
# 512 window and the paged steps' local band really masks keys; its tier
# check prefills 9 chunks of 64 and decodes at position 576 (past the
# window), and its profiled decode step runs at position 600
LONG_PROMPTS = (576, 640, 704, 768)
GEMMA_SERVE = dict(max_len=1024, long_prompts=True, tier_chunks=9, profile_pos=600)
# starcoder2-3b at full width, cut to 2 of its 30 layers: the gelu MLP with
# no window, at head_dim 128, static int8 compressed 2:4
STARCODER_ARCH = "starcoder2_3b"
STARCODER_RUNS = (("compressed", (2, 4), "int8", True, 2),)
# mamba2-2.7b (ssm: 64 Mamba-2 layers, no attention, no MLP) at full width
# and depth: bf16 compressed 2:4 and static int8 gather 2:4, on the seeded
# trace's first MOE_REQUESTS requests (a prefill chunk walks its state
# recurrence token by token); the bf16 run also holds its paged prefill
# against the full-sequence forward on one CONSISTENCY_PROMPT-token prompt.
# (layout, sparsity, qdtype, static, depth)
MAMBA_ARCH = "mamba2_2_7b"
MAMBA_RUNS = (("compressed", (2, 4), None, False, 64), ("gather", (2, 4), "int8", True, 64))
CONSISTENCY_PROMPT = 256
# The depth of a bf16 Mamba model's end-to-end tier and consistency gates.
# The tiers' rounding grows through the stack, the torch tier's own
# one-ulp sensitivity (``layer_tier_check``) about twice as fast (an H100
# 80GB HBM3 at 700 W): mamba2-2.7b's cuda vs torch tier logits 0.028 /
# 0.024 (prefill / decode) at 8 layers, 0.049 / 0.043 at 16, 0.185 /
# 0.193 at 64 (one-ulp 0.064 / 0.039 at 8, 0.377 / 0.248 at 64); forward
# vs paged 0.019 at 8, 0.047 at 16, 0.136 at 64.  So its 64 layers print
# their gaps, and every layer is held teacher-forced.  Printed only: the
# static int8 run (0.95 / 0.66 off the fake-quantized torch tier at 8
# layers: the tiers' rounding flips codes of w_out's input, one static
# step 1.65 wide where most values are a few units) and jamba's 8 layers
# (0.046 / 0.016 on the rows both tiers route alike, one-ulp 0.091 /
# 0.024: 14% of rows re-route, and the Mamba state carries their gap into
# every later row).  A whole number of jamba's 8-layer blocks.
SSM_GATED_DEPTH = 8
# jamba-1.5-large's hybrid layout -- one super-block: 3 Mamba + MLP, 4 Mamba +
# MoE, 1 attention + MLP layers; 16 experts top-2, head_dim 128, ssm_state 128,
# ssm_head_dim 64 as published -- at reduced widths: its four MoE layers of
# 16 x 3 x 8192 x 24576 bf16 weights alone are 77 GB, past one card.
# bf16 compressed 2:4 on the gather expert path, the first MOE_REQUESTS
# requests.  (layout, sparsity, qdtype, static)
JAMBA_ARCH = "jamba_1_5_large_398b"
JAMBA_CUTS = dict(num_layers=8, d_model=1024, num_heads=8, num_kv_heads=1, d_ff=3072)
JAMBA_RUNS = (("compressed", (2, 4), None, False),)
# the prefill path (models.make_prefill_step) at full width and depth:
# hubert-xlarge on 8 x 500 frame embeddings (10 s clips at 50 frames a
# second) and phi-3-vision-4.2b on 2 x (256 patch embeddings + 256 text
# tokens); (layout, sparsity, qdtype, depth), depth None = the config's
HUBERT_ARCH, HUBERT_BATCH = "hubert_xlarge", (8, 500)
HUBERT_RUNS = (("dense", None, None, None), ("compressed", (2, 4), None, None),
               ("gather", (2, 4), None, None), ("gather", (2, 4), "int8", None),
               ("dense", None, "fp8", None))
PHI3_ARCH, PHI3_BATCH = "phi_3_vision_4_2b", (2, 256)   # (B, text tokens)
PHI3_RUNS = (("dense", None, None, None), ("gather", (2, 4), None, None))
PREFILL_REPEATS = 3             # forwards timed; the median is reported
KINDS = {"dense": "tile_gemm", "compressed": "nm_spmm", "gather": "nm_spmm_gather"}
# the kernels each class runs while serving (decode and prefill)
LAYOUT_KERNELS = {("dense", None, False): ("tile_gemm", "tile_gemm_dual"),
                  ("compressed", None, False): ("nm_spmm", "nm_spmm_dual"),
                  ("gather", None, False): ("nm_spmm_gather_bk", "nm_spmm_gather_dual_bk")}
for _q in ("int8", "fp8"):
    LAYOUT_KERNELS.update({
        ("dense", _q, False): (f"tile_gemm_{_q}", f"tile_gemm_dual_{_q}"),
        ("compressed", _q, False): (f"nm_spmm_{_q}", f"nm_spmm_dual_{_q}"),
        ("gather", _q, False): (f"nm_spmm_gather_bk_{_q}", f"nm_spmm_gather_dual_bk_{_q}"),
        ("dense", _q, True): (f"tile_gemm_{_q}", f"tile_gemm_dual_{_q}_requant"),
        ("compressed", _q, True): (f"nm_spmm_{_q}", f"nm_spmm_dual_{_q}_requant"),
        ("gather", _q, True): (f"nm_spmm_gather_bk_{_q}",
                               f"nm_spmm_gather_dual_bk_{_q}_requant")})
QDTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
CALIB_TOKENS = 32                # per slot: (slots, min(max_len, 32)), as the launcher


def masked_kernel(layout, qdtype):
    return f"{MASKED_NAMES[layout]}{'_' + qdtype if qdtype else ''}"


def expected_kernels(layout, qdtype, static, moe_path=None, calibration=False,
                     act="swiglu", family="dense"):
    """The kernels a run launches: its layout's single and dual (the
    requantizing dual with static scales; dynamic scales and
    flash_attention in a calibration forward), and on the spgemm expert
    path the masked single every expert's w_out runs.  A gelu MLP has no
    dual: its w_in is a single GEMM, with static scales the layout's
    requantizing single (``*_requant``).  An ssm model (mamba2: no
    attention, no MLP) runs the layout's single alone, on wz, wx and
    w_out."""
    if family == "ssm":
        return LAYOUT_KERNELS[layout, qdtype, False][:1]
    if act == "gelu":
        single = LAYOUT_KERNELS[layout, qdtype, False][0]
        out = (single,) + ((f"{single}_requant",) if static and not calibration else ())
        return out + (("flash_attention",) if calibration else ())
    single, dual = LAYOUT_KERNELS[layout, qdtype, static and not calibration]
    out = (single, dual) + (("flash_attention",) if calibration else ())
    if moe_path == "spgemm":
        out += (masked_kernel(layout, qdtype),)
    return out


def check_launches(tag, counts, expected):
    """Every expected kernel launched; no other kernel did."""
    for name in expected:
        if counts[name] == 0:
            fail(f"[{tag}] kernel {name} never launched on the main path")
    strays = {name: c for name, c in counts.items() if c and name not in expected}
    if strays:
        fail(f"[{tag}] kernels of another class launched: {strays}")


def count_leaves(tree, key) -> int:
    if isinstance(tree, dict):
        return int(key in tree and "scale" in tree) + sum(
            count_leaves(v, key) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_leaves(v, key) for v in tree)
    return 0


def quantized_sites(tree, cfg):
    """The calibration sites of a prepared tree, counted from the tree: the
    JAX package's unit, one per (slot, leaf path) of a quantized leaf (an
    MoE layer's expert stack is one leaf)."""
    from repro_torch.core.quantize import _map_with_path, _site_key, is_quantized
    from repro_torch.models import layer_site_keys

    keys, layer_keys = set(), layer_site_keys(cfg)
    _map_with_path(tree, lambda path, leaf: keys.add(_site_key(path, layer_keys))
                   if is_quantized(leaf) else None)
    return len(keys)


# mamba2-2.7b's rows: the tier check's decode (1), the serving decode
# slots (8), a prefill chunk (64), the calibration and consistency forwards
# (8 x 32 and 1 x 256)
SSM_KERNEL_ROWS = (1, 8, 64, 256)


def ssm_kernel_phase(cfg, gen, card_line, rows):
    """The kernels mamba2-2.7b's serving runs launch, at its two site
    shapes (wz / wx: d_model -> d_inner, w_out: d_inner -> d_model) and the
    rows its path gives them (SSM_KERNEL_ROWS), against their plain
    versions: K2 ``nm_spmm`` (bf16 2:4) within TOL, K8 int8
    ``nm_spmm_gather_bk_int8`` (int8 gather 2:4, x quantized against one
    static scale as the static run does) bitwise.  Timed beside the plain
    version and the library call (torch.matmul on the decompressed weight;
    torch._int_mm on the pre-gathered X), plan printed."""
    from repro_torch.core import nm
    from repro_torch.core.quantize import quantize_rows_static
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm, split_k
    from repro_torch.kernels.nm_spmm.ref import dense_weight, nm_spmm_ref
    from repro_torch.kernels.nm_spmm_gather import kernel as gk
    from repro_torch.kernels.nm_spmm_gather import ref as gr

    dev, bf16, n = "cuda", torch.bfloat16, 2
    record = recorder(rows, card_line)
    lay = int_mm_layout()[1]

    def run(*a):
        return gk.nm_spmm_gather_bk_int8(*a, out_dtype=bf16)

    def ref(*a):
        return gr.nm_spmm_gather_quantized_ref(*a, out_dtype=bf16)

    for k, o in ((cfg.d_model, cfg.d_inner), (cfg.d_inner, cfg.d_model)):
        kc = k * n // 4
        ws = [torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
              for _ in range(copies_for(k * o))]
        comp = [nm.compress_nm(nm.prune_nm(w.to(bf16), n, 4)[0], n, 4) for w in ws]
        comp = [(c.values, nm.pack_meta(c.meta)) for c in comp]
        gat = [convert_layout({"w": w}, SparsityConfig(n=n, m=4, mode="gather"), "gather",
                              quantize="int8") for w in ws]
        del ws
        for b in SSM_KERNEL_ROWS:
            x = torch.randn((b, k), generator=gen, device=dev).to(bf16)
            ops = [(x, v, m, n) for v, m in comp]
            record("nm_spmm", b, k, o, n, nm_spmm(*ops[0]), nm_spmm_ref(*ops[0]),
                   time_ms(nm_spmm, ops), time_ms(nm_spmm_ref, ops),
                   time_ms(torch.matmul, [(x, dense_weight(v, m, n)) for v, m in comp[:2]]),
                   2 * (b * k + kc * o + b * o) + kc * o // 4, 2 * b * kc * o,
                   split=split_k(b, k, o, n), path=cfg.name)
            xq, xs = quantize_rows_static(x, x.float().abs().amax() / 127)
            ops = [(xq, lf["values"], lf["gather_idx"], xs, lf["scale"].reshape(1, -1), n)
                   for lf in gat]
            lib = [(gr.gather_columns(xq, lf["gather_idx"], n), lay(lf["values"]))
                   for lf in gat[:2]]
            record("nm_spmm_gather_bk_int8", b, k, o, n, run(*ops[0]), ref(*ops[0]),
                   time_ms(run, ops), time_ms(ref, ops), time_ms(int_mm_padded, lib),
                   b * k + 4 * b + kc * o + 4 * kc + 4 * o + 2 * b * o, 2 * b * kc * o,
                   peak=INT8_OPS, exact=True, plan=gk.int8_plan(b, k, o, n),
                   library="pre-gathered X", path=cfg.name)


def calibration_sites(cfg) -> int:
    """The JAX package's count of calibration sites: one per (stage, slot)
    key and quantized leaf -- an attention mixer's wq, wk, wv, wo, a Mamba
    mixer's wz, wx, w_out, a swiglu FFN's w_gate, w_in, w_out and a gelu
    FFN's w_in, w_out (an MoE layer's expert stacks sharing one scale
    each)."""
    from repro_torch.models import build_layout

    ffn = {"none": 0, "mlp": 3 if cfg.act == "swiglu" else 2,
           "moe": 3 if cfg.act == "swiglu" else 2}
    return sum((3 if sl.mixer == "mamba" else 4) + ffn[sl.ffn]
               for st in build_layout(cfg) for sl in st.slots)


def long_trace(trace, vocab_size):
    """``trace`` with every 4th request's prompt replaced by one of
    LONG_PROMPTS' lengths, seeded tokens."""
    import dataclasses

    gen = torch.Generator().manual_seed(4)
    lengths = iter(LONG_PROMPTS)
    return [dataclasses.replace(r, prompt=tuple(torch.randint(
        1, vocab_size, (next(lengths),), generator=gen).tolist())) if i % 4 == 3 else r
        for i, r in enumerate(trace)]


def redesigned_plans(cfg, layout, sparsity, qdtype, rows, mesh=1) -> dict:
    """The body, tile and split the plans give the kernels the last slices
    redesigned, where a run launches them: the float nm_spmm_dual on a bf16
    compressed swiglu model (an MoE's expert gate-up) and, on the spgemm
    expert path, the masked single of every expert w_out where it runs its
    twin's stream (bf16 nm_spmm_masked at K2's split, bf16 tile_gemm_masked
    at K1's plan, nm_spmm_masked_fp8 at nm_spmm_fp8's); tile_gemm_dual_fp8
    (and _requant) on a dense fp8 swiglu model, K9 fp8
    (nm_spmm_gather_dual_bk_fp8 and _requant) on an fp8 gather swiglu model
    (an MoE's expert gate-up), the bf16 nm_spmm_gather_bk_masked at K8's
    plan on the spgemm gather path's w_out, K11 fp8 (nm_spmm_gather_fp8) on
    a sharded fp8 gather model's two row-parallel sites (their local K),
    tile_gemm_masked_fp8 on the spgemm path's dense fp8 w_out, the int8
    singles, nm_spmm_int8, tile_gemm_int8 and nm_spmm_gather_bk_int8 (and
    their _requant forms), at every site an int8 compressed, dense or
    gather model runs them, the int8 gate-up duals nm_spmm_dual_int8,
    tile_gemm_dual_int8 and K9 int8 nm_spmm_gather_dual_bk_int8 (and their
    _requant forms) on an int8 compressed, dense or gather swiglu model (an
    MoE's expert gate-up), nm_spmm_masked_int8, tile_gemm_masked_int8 and
    nm_spmm_gather_bk_masked_int8 on the spgemm path's int8 2:4, dense and
    gather w_out, nm_spmm_gather_bk_masked_fp8 on its fp8 gather w_out, and
    K11 int8
    (nm_spmm_gather_int8) on a sharded int8 gather model's two row-parallel
    sites, at each of ``rows``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.nm_spmm.kernel import dual_plan as nm_dual_plan
    from repro_torch.kernels.nm_spmm.kernel import fp8_plan as nm_fp8_plan
    from repro_torch.kernels.nm_spmm.kernel import int8_dual_plan, int8_plan, split_k
    from repro_torch.kernels.nm_spmm_gather.kernel import int8_plan as gather_int8_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import fp8_dual_plan as gather_fp8_dual_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import (
        int8_dual_plan as gather_int8_dual_plan)
    from repro_torch.kernels.nm_spmm_gather.kernel import kmajor_fp8_plan, kmajor_int8_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import masked_fp8_plan as gather_masked_fp8
    from repro_torch.kernels.nm_spmm_gather.kernel import masked_int8_plan as gather_masked_int8
    from repro_torch.kernels.nm_spmm_gather.kernel import masked_plan as gather_masked_plan
    from repro_torch.kernels.tile_gemm.kernel import (fp8_dual_plan, masked_fp8_plan,
                                                      masked_int8_plan, masked_plan)
    from repro_torch.kernels.tile_gemm.kernel import int8_dual_plan as tile_int8_dual_plan
    from repro_torch.kernels.tile_gemm.kernel import int8_plan as tile_int8_plan

    if cfg.family == "ssm":
        return ssm_plans(cfg, layout, sparsity, qdtype, rows)
    spgemm = bool(cfg.num_experts) and cfg.moe_expert_path == "spgemm" and mesh == 1
    k, o = cfg.d_ff, cfg.d_model                # an expert's w_out
    if spgemm and layout == "dense" and qdtype is None:
        return {"tile_gemm_masked": {f"B={b} K={k} O={o}": masked_plan(b, k, o)
                                     for b in rows[:2]}}
    if spgemm and layout == "gather" and qdtype is None:
        n = sparsity[0]
        return {"nm_spmm_gather_bk_masked": {
            f"B={b} K={k} O={o}": gather_masked_plan(b, k, o, n) for b in rows[:2]}}
    if layout == "gather" and qdtype == "fp8" and mesh == 1 and cfg.act == "swiglu":
        n = sparsity[0]
        # one plan for both forms (bf16 / fp32 and the requantized codes)
        out = {"nm_spmm_gather_dual_bk_fp8": {
            f"B={b} K={cfg.d_model} O={cfg.d_ff}": gather_fp8_dual_plan(b, cfg.d_model,
                                                                         cfg.d_ff, n)
            for b in rows}}
        if spgemm:
            out["nm_spmm_gather_bk_masked_fp8"] = {
                f"B={b} K={k} O={o}": gather_masked_fp8(b, k, o, n) for b in rows[:2]}
        return out
    if spgemm and layout == "dense" and qdtype == "fp8":
        return {"tile_gemm_masked_fp8": {f"B={b} K={k} O={o}": masked_fp8_plan(b, k, o)
                                         for b in rows[:2]}}
    if qdtype == "int8" and layout == "gather" and mesh > 1:
        n = sparsity[0]
        return {"nm_spmm_gather_int8": {
            f"B={b} K={k} O={cfg.d_model}": kmajor_int8_plan(b, k, cfg.d_model, n)
            for b in rows for k in (cfg.attn_dim // mesh, cfg.d_ff // mesh)}}
    if qdtype == "int8" and mesh == 1:
        # the attention sites, and the MLP's where no expert (masked) runs
        # it: a gelu MLP's w_in (the _requant form on static scales) and
        # every w_out (a swiglu gate-up is the dual)
        sites = [(cfg.d_model, cfg.attn_dim), (cfg.d_model, cfg.kv_dim),
                 (cfg.attn_dim, cfg.d_model)]
        if not cfg.num_experts:
            sites += [(cfg.d_ff, cfg.d_model)] + \
                ([(cfg.d_model, cfg.d_ff)] if cfg.act == "gelu" else [])
        name, plan_of = {"compressed": ("nm_spmm_int8", lambda b, k, o: int8_plan(
                             b, k, o, sparsity[0])),
                         "dense": ("tile_gemm_int8", tile_int8_plan),
                         "gather": ("nm_spmm_gather_bk_int8", lambda b, k, o: gather_int8_plan(
                             b, k, o, sparsity[0]))}[layout]
        out = {name: {f"B={b} K={k} O={o}": plan_of(b, k, o) for b in rows for k, o in sites}}
        if cfg.act == "swiglu":
            # the gate-up dual (an MoE's expert gate-up), one plan for both forms
            dual_name, dual_of = {
                "compressed": ("nm_spmm_dual_int8", lambda b, k, o: int8_dual_plan(
                    b, k, o, sparsity[0])),
                "dense": ("tile_gemm_dual_int8", tile_int8_dual_plan),
                "gather": ("nm_spmm_gather_dual_bk_int8", lambda b, k, o: gather_int8_dual_plan(
                    b, k, o, sparsity[0]))}[layout]
            out[dual_name] = {f"B={b} K={cfg.d_model} O={cfg.d_ff}": dual_of(b, cfg.d_model,
                                                                            cfg.d_ff)
                              for b in rows}
        if spgemm and layout == "dense":
            out["tile_gemm_masked_int8"] = {f"B={b} K={k} O={o}": masked_int8_plan(b, k, o)
                                            for b in rows[:2]}
        if spgemm and layout == "gather":
            out["nm_spmm_gather_bk_masked_int8"] = {
                f"B={b} K={k} O={o}": gather_masked_int8(b, k, o, sparsity[0])
                for b in rows[:2]}
        if spgemm and layout == "compressed":
            out["nm_spmm_masked_int8"] = {
                f"B={b} K={k} O={o}": {**int8_plan(b, k, o, sparsity[0]),
                                       "rows": _build.block_rows(b)} for b in rows[:2]}
        return out
    if spgemm and layout == "compressed" and qdtype == "fp8":
        n = sparsity[0]
        return {"nm_spmm_masked_fp8": {
            f"B={b} K={k} O={o}": {**nm_fp8_plan(b, k, o, n), "rows": _build.block_rows(b)}
            for b in rows[:2]}}
    if qdtype is None and layout == "compressed" and mesh == 1 and cfg.act == "swiglu":
        n = sparsity[0]
        out = {"nm_spmm_dual": {f"B={b}": nm_dual_plan(b, cfg.d_model, cfg.d_ff, n)
                                for b in rows}}
        if spgemm:
            out["nm_spmm_masked"] = {
                f"B={b} K={k} O={o}": {"body": "stream", "rows": _build.block_rows(b),
                                       "split": split_k(b, k, o, n)} for b in rows[:2]}
        return out
    if qdtype != "fp8":
        return {}
    if layout == "dense" and mesh == 1 and cfg.act == "swiglu" and not cfg.num_experts:
        return {name: {f"B={b}": fp8_dual_plan(b, cfg.d_model, cfg.d_ff, requant)
                       for b in rows}
                for name, requant in (("tile_gemm_dual_fp8", False),
                                      ("tile_gemm_dual_fp8_requant", True))}
    if layout == "gather" and mesh > 1:
        n = sparsity[0]
        return {"nm_spmm_gather_fp8": {
            f"B={b} K={k} O={cfg.d_model}": kmajor_fp8_plan(b, k, cfg.d_model, n)
            for b in rows for k in (cfg.attn_dim // mesh, cfg.d_ff // mesh)}}
    return {}


def ssm_plans(cfg, layout, sparsity, qdtype, rows) -> dict:
    """A Mamba model's single kernel at its two site shapes, wz / wx (d_model
    -> d_inner) and w_out (d_inner -> d_model), at each of ``rows``: K2's
    split (bf16 compressed), K8's plan (bf16 gather), ``int8_plan`` (int8
    compressed or gather)."""
    from repro_torch.kernels.nm_spmm.kernel import int8_plan, split_k
    from repro_torch.kernels.nm_spmm_gather.kernel import int8_plan as gather_int8_plan
    from repro_torch.kernels.nm_spmm_gather.kernel import plan as gather_plan

    n = sparsity[0] if sparsity else 4
    plans = {("compressed", None): ("nm_spmm", lambda b, k, o: {"split": split_k(b, k, o, n)}),
             ("gather", None): ("nm_spmm_gather_bk", lambda b, k, o: gather_plan(b, k, o, n)),
             ("compressed", "int8"): ("nm_spmm_int8", lambda b, k, o: int8_plan(b, k, o, n)),
             ("gather", "int8"): ("nm_spmm_gather_bk_int8",
                                  lambda b, k, o: gather_int8_plan(b, k, o, n))}
    if (layout, qdtype) not in plans:
        return {}
    name, plan_of = plans[layout, qdtype]
    sites = ((cfg.d_model, cfg.d_inner), (cfg.d_inner, cfg.d_model))
    return {name: {f"B={b} K={k} O={o}": plan_of(b, k, o) for b in rows for k, o in sites}}


def serve_layout(base_cfg, layout, sparsity, qdtype, static, depth=None, moe_path=None,
                 max_len=512, long_prompts=False, tier_chunks=1, profile_pos=255,
                 requests=None, cuts=None, consistency=False):
    """Serve ``base_cfg`` (at ``depth`` layers, with the widths in ``cuts``
    replaced) in one layout and class through the port's Engine, with
    every check and measurement of the serving phase; ``requests`` cuts the
    trace to its first requests (an MoE run: MOE_REQUESTS), ``consistency``
    also holds the paged prefill against the full-sequence forward
    (``consistency_check``)."""
    import dataclasses

    from repro_torch import kernels, serving
    from repro_torch.models import init_params
    from repro_torch.models.transformer import layer_slots

    family = base_cfg.family
    tag = (f"{base_cfg.name}/" if base_cfg.act == "gelu" or family in ("ssm", "hybrid")
           else "") + \
        (f"moe-{moe_path}/" if moe_path else "") + \
        ("gather-" if layout == "gather" else "") + \
        (f"{sparsity[0]}:{sparsity[1]}" if sparsity else "dense") + \
        (f"/{qdtype}" if qdtype else "") + ("/static" if static else "")
    spec = serving.ServingSpec(layout=layout, sparsity=sparsity, qdtype=qdtype,
                               static_scales=static, slots=8, max_len=max_len, block_len=8,
                               prefill_chunk=64)
    # the JAX package's way to pick the expert path: a field of the config
    cfg = spec.apply_to(dataclasses.replace(
        base_cfg, **{"num_layers": depth or base_cfg.num_layers, **(cuts or {})},
        **({"moe_expert_path": moe_path} if moe_path else {})))
    mamba = family in ("ssm", "hybrid")
    log(f"[{tag}] depth: {cfg.num_layers} layers (d_model {cfg.d_model}, d_ff {cfg.d_ff}"
        + (f", {cfg.num_experts} experts top-{cfg.top_k}, {moe_path} path" if moe_path else "")
        + (f", window {cfg.window} on {cfg.local_global_period - 1} of every "
           f"{cfg.local_global_period} layers" if cfg.window else "")
        + (f", d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, "
           f"ssm_state {cfg.ssm_state}, conv {cfg.ssm_conv}" if mamba else "")
        + f", head_dim {cfg.head_dim}, {cfg.act})")
    if cuts:
        log(f"[{tag}] cut from the published config ({base_cfg.name}): " + ", ".join(
            f"{k} {getattr(base_cfg, k)} -> {v}" for k, v in cuts.items()))
    act = cfg.act
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calib_tokens = None
    if static:
        calib_tokens = torch.randint(
            1, cfg.vocab_size, (spec.slots, min(spec.max_len, CALIB_TOKENS)),
            generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    with torch.inference_mode():
        params = init_params(gen, cfg, device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        prepared = serving.prepare(params, spec, cfg=cfg, calib_tokens=calib_tokens)
        torch.cuda.synchronize()
        calib_counts = kernels.launch_counts()
        calib_check = None
        if static:
            calib_check = calibration_tiers(params, spec, cfg, calib_tokens, prepared, tag)
    del params
    weights_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[{tag}] init + prepare {time.perf_counter() - t0:.1f}s, "
        f"{weights_gb:.2f} GB allocated")
    calib = None
    if static:
        log(f"[{tag}] calibration launches: {json.dumps(calib_counts)}")
        check_launches(f"{tag} calibration", calib_counts,
                       expected_kernels(layout, qdtype, static, moe_path, calibration=True,
                                        act=act, family=family))
        attn_layers = sum(slot.mixer != "mamba" for slot in layer_slots(cfg))
        if calib_counts["flash_attention"] != attn_layers:
            fail(f"[{tag}] flash_attention launched {calib_counts['flash_attention']} "
                 f"times in calibration, not once per attention layer ({attn_layers})")
        # the JAX package's unit: one site per stacked leaf, counted from the
        # tree; every quantized leaf of every layer carries its scale
        leaves = count_leaves(prepared.params, "act_scale")
        quantized = count_leaves(prepared.params, "scale")
        sites = quantized_sites(prepared.params, cfg)
        # internlm2-1.8b and qwen3-moe 7, gemma3-1b's 3 keys x 6 leaves (no
        # w_gate) 18, mamba2's wz, wx, w_out 3
        want_sites = calibration_sites(cfg)
        calib = {"calibrated_sites": prepared.calibrated_sites, "sites_in_tree": sites,
                 "expected_sites": want_sites,
                 "leaves_with_act_scale": leaves, "quantized_leaves": quantized,
                 "launches": calib_counts, "torch_tier": calib_check}
        if prepared.calibrated_sites != sites or sites != want_sites or leaves != quantized:
            fail(f"[{tag}] calibration: {json.dumps(calib)}")
    elif any(calib_counts.values()):
        fail(f"[{tag}] prepare launched kernels without calibrating: {calib_counts}")
    report = prepared.dispatch_report()
    log(f"[{tag}] dispatch engine plan:")
    for line in report:
        log(line)
    want = f"{KINDS[layout]}{'_' + qdtype if qdtype else ''}[cuda]"
    off = [line for line in report if want not in line
           or (static and "act-scales=static" not in line)]
    if off:
        fail(f"[{tag}] {len(off)} linear site(s) off the {want} kernels"
             f"{' with static scales' if static else ''}: {off[0]}")
    moe_plan = moe_plans(prepared, cfg, spec, tag) if moe_path == "spgemm" else None
    rq_plan = requant_plans(prepared, cfg, spec, tag) if static and act == "gelu" else None
    # decode, a prefill chunk, the calibration forward's rows
    kernel_plans = redesigned_plans(cfg, layout, sparsity, qdtype,
                                    (spec.slots, spec.prefill_chunk, spec.slots * CALIB_TOKENS))
    if kernel_plans:
        log(f"[{tag}] the redesigned kernels' plans: {json.dumps(kernel_plans)}")

    t_plan = time.perf_counter()
    engine = serving.Engine(prepared)
    warm = serving.make_poisson_trace(seed=1, num_requests=2, vocab_size=cfg.vocab_size,
                                      prompt_mix=((64, 1.0),), new_mix=((2, 1.0),))
    engine.run(warm)
    trace = serving.make_poisson_trace(
        seed=0, num_requests=16, rate=1.0, vocab_size=cfg.vocab_size,
        prompt_mix=((128, 1.0), (192, 1.0), (256, 1.0)), new_mix=((32, 1.0),))
    if moe_path or requests:
        trace = trace[:requests or MOE_REQUESTS]
    if long_prompts:
        trace = long_trace(trace, cfg.vocab_size)
        log(f"[{tag}] trace: prompt lengths {[len(r.prompt) for r in trace]}, "
            f"{trace[0].max_new_tokens} new tokens each, max_len {spec.max_len}")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rep = engine.run(trace)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[{tag}] served {rep.describe()}")
    log(f"[{tag}] launches: {json.dumps(counts)}")
    check_launches(tag, counts, expected_kernels(layout, qdtype, static, moe_path, act=act,
                                                 family=family))
    if rep.completed != len(trace):
        fail(f"[{tag}] {rep.completed}/{len(trace)} requests completed")
    for s in rep.stats:
        if len(s.tokens) != 32 or not all(0 <= t < cfg.vocab_size for t in s.tokens):
            fail(f"[{tag}] request {s.rid} produced {s.tokens}")
    result = {"layout": tag, "arch": cfg.name, "num_layers": cfg.num_layers,
              "max_len": spec.max_len, "tokens_per_s": rep.tokens_per_s,
              "p50_latency_s": rep.p50_latency_s, "p99_latency_s": rep.p99_latency_s,
              "wall_s": rep.wall_s, "model_calls": rep.model_calls,
              "prefill_chunks": rep.prefill_chunks, "decode_calls": rep.decode_calls,
              "weights_gb": weights_gb, "launches": counts}
    if calib is not None:
        result["calibration"] = calib
    if moe_plan is not None:
        result["moe_plans"] = moe_plan
    if rq_plan is not None:
        result["requant_plans"] = rq_plan
    if kernel_plans:
        result["kernel_plans"] = kernel_plans
    log(json.dumps(result))
    t_serve = time.perf_counter()
    # an MoE decode step is long (hundreds of ms): one profiled step is enough
    result["decode_profile"] = profile_decode(prepared, cfg, spec, tag, static,
                                              steps=1 if moe_path else 3,
                                              moe=moe_path is not None,
                                              skip=moe_path == "spgemm", position=profile_pos,
                                              unfused=static and act == "gelu")
    if mamba:
        result["prefill_profile"] = profile_prefill(prepared, cfg, spec, tag)
    t_prof = time.perf_counter()
    tol = {None: TIER_TOL, "int8": STATIC_TIER_TOL if static else INT8_TIER_TOL,
           "fp8": FP8_TIER_TOL}[qdtype]
    # a model with Mamba layers: the end-to-end gate only where the tiers'
    # rounding leaves it room (SSM_GATED_DEPTH), every layer teacher-forced;
    # on static scales the torch tier quantizes its activations against
    # the same scales (the scheme's own error is the layer check's to print)
    deep = mamba and cfg.num_layers > SSM_GATED_DEPTH
    tiers = tier_check(prepared, cfg, spec, tag, tol, chunks=tier_chunks, gate=not mamba,
                       fake_quant=mamba and static)
    if deep:
        tiers["gated_depth"] = tier_check(*depth_cut(prepared, cfg, SSM_GATED_DEPTH), spec,
                                          f"{tag} first {SSM_GATED_DEPTH} layers", tol,
                                          gate=not static, fake_quant=static)
    if mamba:
        tiers["layers"] = layer_tier_check(prepared, cfg, spec, tag, tol)
    if moe_path == "spgemm" and qdtype is None and layout == "dense":
        tiers["spgemm_vs_gather"] = expert_path_gap(prepared, cfg, spec, tag)
    if consistency:
        tiers["forward_vs_paged"] = consistency_check(prepared, cfg, spec, tag,
                                                      min(cfg.num_layers, SSM_GATED_DEPTH))
    log(f"[{tag}] seconds: prepare and checks {t_plan - t0:.1f}, serving "
        f"{t_serve - t_plan:.1f}, profile {t_prof - t_serve:.1f}, tiers "
        f"{time.perf_counter() - t_prof:.1f}")
    return result, tiers


def moe_plans(prepared, cfg, spec, tag) -> dict:
    """The spgemm expert path's plans at the decode and prefill widths:
    every expert w_out on its layout's masked kernel (ACT_SKIP), every
    expert gate-up dual mask-only (ACT_MASK_ONLY_DUAL)."""
    from repro_torch.core import quantize
    from repro_torch.kernels import dispatch

    out = {}
    with prepared.activate():
        for names, leaf in dispatch.iter_linear_items(prepared.params):
            if "experts" not in names or names[-1] not in ("w_out", "w_gate"):
                continue
            mode = dispatch._mode_of(leaf, cfg.sparsity)
            ke = dispatch.input_features(leaf, cfg.sparsity)
            _, o = dispatch._problem_dims(mode, leaf, ke)
            dual = names[-1] == "w_gate"
            for b in (spec.slots, spec.prefill_chunk):
                d = dispatch.plan(dispatch.GemmProblem(
                    mode, b=b, ke=ke, o=o, n=cfg.sparsity.n, m=cfg.sparsity.m,
                    dtype=quantize.quant_dtype(leaf) or cfg.torch_dtype,
                    epilogue="silu_mul" if dual else None, dual=dual, activation="zeros",
                    device=leaf["values" if "values" in leaf else "w"].device,
                    static_scales=quantize.has_static_scales(leaf)))
                want = (dispatch.ReasonCode.ACT_MASK_ONLY_DUAL if dual
                        else dispatch.ReasonCode.ACT_SKIP)
                if d.activation_reason is not want or not d.uses_kernel:
                    fail(f"[{tag}] expert {names[-1]} at B={b}: {dispatch.describe(d)}")
                out.setdefault(names[-1], set()).add(dispatch.describe(d))
    res = {k: sorted(v) for k, v in out.items()}
    log(f"[{tag}] expert plans: {json.dumps(res)}")
    return res


def requant_plans(prepared, cfg, spec, tag) -> dict:
    """A gelu MLP on static scales: every layer's w_out decides
    REQUANT_FUSED at the decode and prefill widths, so its w_in (the
    producer) plans the requant:<dtype> flush, ``*_requant`` on the card."""
    from repro_torch.kernels import dispatch

    codes = {}
    with prepared.activate():
        for layer in prepared.params["layers"]:
            for b in (spec.slots, spec.prefill_chunk):
                _, code = dispatch.requant_decision(layer["ffn"]["w_out"], (b,), cfg.sparsity,
                                                    dispatch=prepared.dispatch)
                codes[code.value] = codes.get(code.value, 0) + 1
    log(f"[{tag}] w_out requant decisions: {json.dumps(codes)}")
    if set(codes) != {dispatch.ReasonCode.REQUANT_FUSED.value}:
        fail(f"[{tag}] a gelu w_in does not requantize: {codes}")
    return codes


def calibration_tiers(params, spec, cfg, calib_tokens, prepared, tag) -> dict:
    """Calibrate ``params`` on the same tokens again, on the torch tier (on
    the card: plain versions, no kernel launches) and hold every leaf's
    act_scale from the cuda tier against it, within CALIB_TOL relative."""
    import dataclasses

    from repro_torch import kernels, serving
    from repro_torch.kernels.dispatch import iter_linear_items

    kernels.reset_launch_counts()
    ref = serving.prepare(params, dataclasses.replace(spec, backend="torch"), cfg=cfg,
                          calib_tokens=calib_tokens)
    torch.cuda.synchronize()
    if any(kernels.launch_counts().values()) or ref.calibrated_sites != prepared.calibrated_sites:
        fail(f"[{tag}] torch-tier calibration: {ref.calibrated_sites} sites, launches "
             f"{kernels.launch_counts()}")
    got = dict(iter_linear_items(prepared.params))
    want = dict(iter_linear_items(ref.params))
    if got.keys() != want.keys():
        fail(f"[{tag}] the tiers' prepared trees differ in their linear leaves")
    sites = {}
    for names, leaf in want.items():
        a, b = got[names].get("act_scale"), leaf.get("act_scale")
        if a is None or b is None:
            fail(f"[{tag}] {'/'.join(names)}: act_scale {a} (cuda) / {b} (torch)")
        rel = abs(a.item() - b.item()) / b.item()
        site = "/".join(n for n in names if not n.startswith("["))
        prev = sites.get(site, {"leaves": 0, "max_rel": 0.0})
        sites[site] = {"leaves": prev["leaves"] + 1, "max_rel": max(prev["max_rel"], rel),
                       "cuda": a.item(), "torch": b.item()}
    res = {"max_rel": max(v["max_rel"] for v in sites.values()), "tolerance": CALIB_TOL,
           "sites": sites}
    log(f"[{tag}] act_scale, cuda vs torch tier: {json.dumps(res)}")
    if not res["max_rel"] <= CALIB_TOL:
        fail(f"[{tag}] a static act_scale is {res['max_rel']:.3e} off the torch tier's "
             f"(> {CALIB_TOL})")
    return res


class CallCounter:
    """Counts calls to module-level functions while active, by name, and
    the dtype and width of the activations each ``sparse_matmul`` gets."""

    def __init__(self, targets):
        self.targets, self.calls, self.fed = targets, {}, []

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, real in self.saved:
            def wrapped(*a, _real=real, _name=name, **k):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                if _name == "sparse_matmul":
                    self.fed.append((a[0].dtype, a[0].shape[-1]))
                return _real(*a, **k)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def check_static_sites(cfg, tag, step, narrow_dtype) -> dict:
    """One decode step on static scales: no per-row quantize pass; wq, wk,
    wv, wo (a Mamba layer's wz, wx and w_out) and the gate-up pair (one
    shared quantize; one per expert in an MoE layer) quantize against their
    static scales; every FFN w_out (every expert's) contracts the narrow
    rows (int8 or e4m3) as they came out of the gate-up dual's requantizing
    flush."""
    from repro_torch.core import quantize
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import layer_slots

    with CallCounter([(quantize, "quantize_rows"), (quantize, "quantize_rows_static"),
                      (dispatch, "sparse_matmul")]) as cc:
        step()
    torch.cuda.synchronize()
    slots = layer_slots(cfg)
    # gate-up / w_out pairs, and the mixers' own static sites
    pairs = sum(0 if sl.ffn == "none" else cfg.num_experts if sl.ffn == "moe" else 1
                for sl in slots)
    mixer_sites = sum(3 if sl.mixer == "mamba" else 4 for sl in slots)
    narrow = [k for dt, k in cc.fed if dt == narrow_dtype]
    res = {"dynamic_quantize_calls": cc.calls.get("quantize_rows", 0),
           "static_quantize_calls": cc.calls.get("quantize_rows_static", 0),
           "w_out_fed_narrow": len(narrow),
           "static_sites": cc.calls.get("quantize_rows_static", 0) + len(narrow)}
    log(f"[{tag}] static sites of one decode step: {json.dumps(res)}")
    if (res["dynamic_quantize_calls"] or res["static_quantize_calls"] != mixer_sites + pairs
            or len(narrow) != pairs or set(narrow) != ({cfg.d_ff} if pairs else set())):
        fail(f"[{tag}] decode step not on static scales throughout: {json.dumps(res)}")
    return res


def skipped_tiles(step) -> dict:
    """The masked kernels' skip in one step: the share of (row block, K
    step) tiles their maps mark dead, over every w_out launch (read back
    once, after the step)."""
    from repro_torch.kernels import dispatch

    real, seen = dispatch.block_maps, []

    def spy(x2, block_b, block_ke):
        maps = real(x2, block_b, block_ke)
        seen.append(maps[1].sum())
        seen.append(maps[1].numel())
        return maps

    dispatch.block_maps = spy
    try:
        step()
    finally:
        dispatch.block_maps = real
    live = torch.stack(seen[0::2]).sum().item() if seen else 0
    total = sum(seen[1::2])
    return {"masked_launches": len(seen) // 2, "tiles": total,
            "skipped_share": 1 - live / total if total else None}


def device_profile(step, steps: int, activities) -> tuple:
    """``steps`` calls of ``step`` under torch.profiler: (the profiler, the
    device-side events, host wall ms per step)."""
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    return prof, kern, wall_ms


# the port's GEMM and attention kernels in a device trace, by their
# __global__ names (a wrapper's gather pass, gather_columns*, is a second
# kernel of the same call and not matched)
PORT_KERNEL = re.compile(r"(?:^|[\s:])(?:nm_spmm_sp_kernel|nm_spmm_sp_fp8_kernel|gemm_kernel|"
                         r"gemm_int8_kernel|gemm_fp8_kernel|tile_gemm_wgmma_kernel|"
                         r"tile_gemm_fp8_wgmma_kernel|flash_attention_kernel)[<(]")


TRACE_DROP = 0.05               # decode traces: share of counted launches missing


def counted_step(step) -> int:
    """One call of ``step``: the launches the port's wrappers counted in it."""
    from repro_torch import kernels

    before = sum(kernels.launch_counts().values())
    step()
    torch.cuda.synchronize()
    return sum(kernels.launch_counts().values()) - before


def checked_profile(step, steps: int, activities, per_step: int, tag: str) -> tuple:
    """``device_profile``, held to the launch counters: the trace must hold
    the launches a step of the port's kernels that the wrappers counted
    over one step, less at most one a step or TRACE_DROP of them, whichever
    is more (an H100's traces have held 518-519 of a MoE step's 520 and 11
    of a 12-launch step's 12, a launch or two dropped; a corrupt one held
    210 of 256 w_out calls).  A trace short of that is taken once more; a
    second short one fails the phase."""
    for attempt in (1, 2):
        prof, kern, wall_ms = device_profile(step, steps, activities)
        seen = sum(e.count for e in kern if PORT_KERNEL.search(e.key)) / steps
        if seen < per_step:
            log(f"[{tag}] the device trace holds {seen:.2f} of the step's {per_step} counted "
                f"kernel launches")
        if seen >= per_step - max(1, per_step * TRACE_DROP):
            return prof, kern, wall_ms
        if attempt == 1:
            log(f"[{tag}] tracing again")
    fail(f"[{tag}] the device trace lost kernel events twice: {seen:.0f} of {per_step} "
         f"counted launches a step")


def profile_decode(prepared, cfg, spec, tag, static=False, steps: int = 3, moe=False,
                   skip=False, position: int = 255, unfused=False):
    """Where a decode step's time goes: ``steps`` batched decode steps (all
    slots active at ``position``, seeded random tokens) under
    torch.profiler; device time by kernel, and the device's busy share of
    the steps' wall time, from a trace held to the launch counters
    (``checked_profile``).  With ``static``, the warm-up step is
    instrumented (``check_static_sites``); with ``skip`` (the spgemm expert
    path) the share of w_out tiles its masked kernels skip is reported
    (``skipped_tiles``); an ``moe`` step is profiled on the device alone.
    With ``unfused`` (a gelu MLP on static scales) the same step is also
    profiled with the single-GEMM requantize declined
    (``dispatch.requant_plan`` returning None): every w_in then stores bf16
    rows and every w_out quantizes them itself, as the port did before;
    its launches and device time are reported beside the fused step's."""
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import dispatch
    from repro_torch.models import init_paged_caches, paged_decode_step

    dev = "cuda"
    b, w = spec.slots, spec.table_width
    caches = init_paged_caches(cfg, b * w + 1, spec.block_len, b, device=dev)
    table = torch.arange(1, b * w + 1, device=dev).reshape(b, w)
    tokens = torch.randint(1, cfg.vocab_size, (b, 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    positions = torch.full((b,), position, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)

    def step():
        return paged_decode_step(prepared.params, caches, tokens, positions, table,
                                 active, cfg, spec.block_len)

    sites = skipped = None
    # an MoE step's host ops are too many for the profiler to tabulate in
    # good time: its profile records the device alone
    activities = [ProfilerActivity.CUDA] + ([] if moe else [ProfilerActivity.CPU])
    with torch.inference_mode(), prepared.activate():
        per_step = counted_step(step)
        if static:
            sites = check_static_sites(cfg, tag, step, QDTYPES[spec.qdtype])
        if skip:
            skipped = skipped_tiles(step)
            log(f"[{tag}] w_out tiles of one decode step (B={b}): {json.dumps(skipped)}")
        prof, kern, wall_ms = checked_profile(step, steps, activities, per_step, tag)
        if unfused:
            real = dispatch.requant_plan
            dispatch.requant_plan = lambda *a, **k: None
            try:
                per_step_u = counted_step(step)
                _, kern_u, wall_u = checked_profile(step, steps, [ProfilerActivity.CUDA],
                                                    per_step_u, f"{tag} unfused")
            finally:
                dispatch.requant_plan = real
    # None, not 0, when the profiler recorded no device activity at all
    busy_ms = (sum(e.self_device_time_total for e in kern) / 1e3 / steps
               if kern else None)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    res = {"layout": tag, "position": position, "step_wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
           "launches_per_step": sum(e.count for e in kern) / steps,
           "top_kernels": [{"name": e.key[:90], "ms_per_step":
                            e.self_device_time_total / 1e3 / steps,
                            "calls_per_step": e.count / steps} for e in top]}
    host = [e for e in prof.key_averages() if e not in kern]
    res["top_host_ops"] = [] if moe else [
        {"name": e.key[:60], "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / steps,
         "calls_per_step": e.count / steps}
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]]
    if unfused:
        res["unfused"] = {"launches_per_step": sum(e.count for e in kern_u) / steps,
                          "device_busy_ms": sum(e.self_device_time_total for e in kern_u)
                          / 1e3 / steps, "step_wall_ms_device_only_profile": wall_u}
        log(f"[{tag}] decode step, requant fused vs unfused (w_out quantizing itself): "
            f"{res['launches_per_step']:.0f} vs {res['unfused']['launches_per_step']:.0f} "
            f"launches, {busy_ms} vs {res['unfused']['device_busy_ms']} device ms")
    if sites is not None:
        res["static_sites"] = sites
    if skipped is not None:
        res["w_out_tiles"] = skipped
    log(json.dumps(res))
    return res


def profile_prefill(prepared, cfg, spec, tag) -> dict:
    """Where a prefill chunk's time goes on a model with Mamba layers (each
    walks its state recurrence token by token): one chunk of
    ``spec.prefill_chunk`` seeded tokens into slot 0 under torch.profiler,
    the device alone, its trace held to the launch counters
    (``checked_profile``): launches per chunk and per token, device busy
    ms, the chunk's wall ms and the device's idle share."""
    from torch.profiler import ProfilerActivity

    from repro_torch.models import init_paged_caches, paged_prefill_chunk

    dev, c = "cuda", spec.prefill_chunk
    caches = init_paged_caches(cfg, spec.table_width + 1, spec.block_len, spec.slots,
                               device=dev)
    table = torch.arange(1, spec.table_width + 1, device=dev)[None, :]
    tokens = torch.randint(1, cfg.vocab_size, (1, c), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))

    def step():
        return paged_prefill_chunk(prepared.params, caches, tokens, 0, table, c, cfg,
                                   spec.block_len, slot_idx=0)

    with torch.inference_mode(), prepared.activate():
        per_step = counted_step(step)
        _, kern, wall_ms = checked_profile(step, 1, [ProfilerActivity.CUDA], per_step,
                                           f"{tag} prefill")
    launches = sum(e.count for e in kern)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    res = {"layout": tag, "chunk_tokens": c, "chunk_wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
           "launches_per_chunk": launches, "launches_per_token": launches / c,
           "port_kernel_launches_per_chunk": per_step,
           "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                            "calls": e.count}
                           for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]]}
    log(f"[{tag}] prefill chunk profile: {json.dumps(res)}")
    return res


# --------------------------------------------------------------- phase 4
def kept_experts(weights: torch.Tensor, cap: int) -> torch.Tensor:
    """The (T, E) mask of the experts that take each token: routed to it
    (``weights > 0``) and among its ``cap`` capacity winners, ties to the
    lower token (``models.moe._moe_local``'s selection)."""
    score = torch.where(weights > 0, weights, float("-inf"))
    top_w, top_idx = torch.sort(score, dim=0, descending=True, stable=True)
    kept = torch.zeros_like(weights, dtype=torch.bool)
    return kept.scatter(0, top_idx[:cap], top_w[:cap] > 0)


def chunk_and_step(prepared, cfg, spec, backend, chunks: int = 1):
    """``chunks`` prefill chunks of seeded tokens and one decode step (at
    position ``chunks * C``) under ``backend``: (the last chunk's logits
    (C, V), decode logits (1, V), routing), where routing is, for an MoE
    model, each MoE call's (T, E) mask of the experts that take every
    token (``kept_experts`` of ``models.moe._route``'s weights), in call
    order."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import init_paged_caches, moe, paged_decode_step, paged_prefill_chunk

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    c = spec.prefill_chunk
    # the chunk, then the token the decode step is fed (the same in both
    # tiers, whatever each tier's argmax)
    tokens = torch.randint(1, cfg.vocab_size, (1, chunks * c + 1), generator=gen, device=dev)
    table = torch.arange(1, spec.table_width + 1, device=dev)[None, :]
    real, routes = moe._route, []

    def spy(*args):
        weights = real(*args)
        routes.append(kept_experts(weights, moe._capacity(weights.shape[0], cfg)))
        return weights

    moe._route = spy
    try:
        with torch.inference_mode(), dispatch.use_dispatch(backend=backend):
            caches = init_paged_caches(cfg, spec.table_width + 1, spec.block_len, 1,
                                       device=dev)
            for i in range(chunks):
                lp, caches = paged_prefill_chunk(prepared.params, caches,
                                                 tokens[:, i * c:(i + 1) * c], i * c, table, c,
                                                 cfg, spec.block_len, slot_idx=0)
            ld, _ = paged_decode_step(prepared.params, caches, tokens[:, chunks * c:],
                                      torch.tensor([chunks * c], device=dev), table,
                                      torch.tensor([True], device=dev), cfg,
                                      spec.block_len)
    finally:
        moe._route = real
    return lp[0].float(), ld[0].float(), routes


def tier_check(prepared, cfg, spec, tag, tol, chunks: int = 1, gate: bool = True,
               fake_quant: bool = False):
    """The cuda tier's logits against the torch tier's, over ``chunks``
    prefill chunks (the last one's logits are compared) and a decode step
    (measured and printed, and with ``gate`` held to ``tol``); with
    ``fake_quant`` the torch tier quantizes its activations against the
    static scales (``fake_quantized_activations``).
    An MoE tier may route a near-tied token to another expert, or keep it
    over an expert's capacity where the other tier drops it: the rows
    (prefill tokens, then the decode token) whose set of experts taking
    them differs in any layer are counted and left out of the gate."""
    c = spec.prefill_chunk
    pc, dc, rc = chunk_and_step(prepared, cfg, spec, "cuda", chunks)
    with fake_quantized_activations() if fake_quant else contextlib.nullcontext():
        pt, dt, rt = chunk_and_step(prepared, cfg, spec, "torch", chunks)
    if not (torch.isfinite(pc).all() and torch.isfinite(dc).all()):
        fail(f"[{tag}] non-finite logits on the cuda tier")
    if pc.shape != (c, cfg.vocab_size) or dc.shape != (1, cfg.vocab_size):
        fail(f"[{tag}] logits shapes {tuple(pc.shape)} {tuple(dc.shape)}")
    same = torch.ones(c + 1, dtype=torch.bool, device=pc.device)
    if rc:   # MoE calls: each prefill chunk's per MoE layer, then the decode step's
        from repro_torch.models.transformer import layer_slots
        n_l = sum(slot.ffn == "moe" for slot in layer_slots(cfg))
        if len(rc) != len(rt) or len(rc) != (chunks + 1) * n_l:
            fail(f"[{tag}] {len(rc)} / {len(rt)} MoE calls in the tiers' runs")
        for a, b in zip(rc[-2 * n_l:-n_l], rt[-2 * n_l:-n_l]):
            same[:c] &= (a == b).all(-1)
        for a, b in zip(rc[-n_l:], rt[-n_l:]):
            same[c:] &= (a == b).all(-1)
    keep_p, keep_d = same[:c], same[c:]
    # None: every row of that call re-routed, nothing left to gate
    e_p = scaled_err(pc[keep_p], pt[keep_p]) if keep_p.any() else None
    e_d = scaled_err(dc[keep_d], dt[keep_d]) if keep_d.any() else None
    agree = (torch.cat([pc, dc]).argmax(-1) == torch.cat([pt, dt]).argmax(-1))
    res = {"layout": tag, "prefill_scaled_err": e_p, "decode_scaled_err": e_d,
           "tolerance": tol, "greedy_agreement": agree.float().mean().item(),
           "positions": agree.numel(), "prefill_positions": [(chunks - 1) * c, chunks * c - 1],
           "decode_position": chunks * c}
    if rc:
        res["rerouted_row_share"] = 1 - same.float().mean().item()
        res["rows_gated"] = int(same.sum().item())
    res["gated"] = gate
    if fake_quant:
        res["reference"] = "torch tier, activations quantized against the static scales"
    log(json.dumps(res))
    if gate and not all(e is None or e <= tol for e in (e_p, e_d)):
        fail(f"[{tag}] cuda vs torch tier logits differ: {e_p} / {e_d} > {tol}")
    return res


def traced_layers(run, force=None) -> tuple:
    """``run()`` with every layer call of the model recorded, in call order:
    (its input, its mixer's output fp32 -- the Mamba mixer's or the
    attention's, before the residual add rounds it into the stream -- and,
    where the layer has one, its FFN's input and output fp32, else None).
    With ``force``, the i-th layer call takes the input and the FFN input
    of ``force(i)`` (a record of another run) instead (teacher forcing).
    Returns (run's result, the records)."""
    from repro_torch.models import transformer

    real, mlp, moe = transformer._layer, transformer.apply_mlp, transformer.apply_moe
    seen = []

    def layer(lp, slot, x, cfg, mixer):
        want = force(len(seen)) if force is not None else None
        if want is not None:
            x = want[0].to(x.dtype)
        rec = [x, None, None, None]

        def recorded(lp_, h):
            o, aux = mixer(lp_, h)
            rec[1] = o.float()
            return o, aux

        def ffn(fn):
            def run_ffn(p, h, *a):
                if want is not None:
                    h = want[2].to(h.dtype)
                rec[2] = h
                out = fn(p, h, *a)
                rec[3] = out.float()
                return out
            return run_ffn

        transformer.apply_mlp, transformer.apply_moe = ffn(mlp), ffn(moe)
        try:
            out = real(lp, slot, x, cfg, recorded)
        finally:
            transformer.apply_mlp, transformer.apply_moe = mlp, moe
        seen.append(tuple(rec))
        return out

    transformer._layer = layer
    try:
        result = run()
    finally:
        transformer._layer = real
    return result, seen


@contextlib.contextmanager
def fake_quantized_activations():
    """While active, every linear whose leaf carries a static act_scale
    contracts its float activation quantized against that scale and
    dequantized: the torch tier (which dequantizes the weights only) then
    computes what the static int8 / fp8 kernels compute, up to rounding."""
    from repro_torch.core import quantize
    from repro_torch.kernels import dispatch

    real = dispatch.sparse_matmul

    def fake_quantized(x, params, *a, **k):
        if quantize.has_static_scales(params) and x.dtype in (torch.bfloat16, torch.float32):
            q, xs = quantize.quantize_rows_static(x.reshape(-1, x.shape[-1]),
                                                  params["act_scale"],
                                                  quantize.quant_dtype(params))
            x = (q.float() * xs).reshape(x.shape).to(x.dtype)
        return real(x, params, *a, **k)

    dispatch.sparse_matmul = fake_quantized
    try:
        yield
    finally:
        dispatch.sparse_matmul = real


def depth_cut(prepared, cfg, depth: int) -> tuple:
    """(prepared, cfg) cut to their first ``depth`` layers: the same
    weights, fewer of them."""
    import dataclasses

    return (dataclasses.replace(prepared, params={**prepared.params,
                                                  "layers": prepared.params["layers"][:depth]}),
            dataclasses.replace(cfg, num_layers=depth))


def layer_tier_check(prepared, cfg, spec, tag, tol) -> dict:
    """The tiers layer by layer, teacher-forced: one prefill chunk and one
    decode step of seeded tokens, first on the torch tier, then on the cuda
    tier with every layer taking the torch tier's input to that layer and
    the decode step starting from the caches the torch tier's prefill left.
    Each layer's mixer output (before the residual add, whose bf16 rounding
    of a stream up to 43 times the mixer's size is no kernel's) and FFN
    output (its input forced too, so an MoE routes alike) must be within
    ``tol`` of the torch tier's on every row, each row (every prefill
    position, the decode token) scaled by its own max.  On static scales the
    torch tier runs with its activations quantized against them
    (``fake_quantized_activations``), so the gate holds the static path
    and not the scheme's quantization error; one per-tensor step is there
    the unit of a flipped code, so the prefill rows are scaled by their
    max over the chunk (a row of small values spans few steps).  The
    scheme's own error is printed
    (``static_quantization_err``: the cuda tier against the plain torch
    tier).  ``ulp_sensitivity``: the reference tier's own logits moved by
    one bf16 ulp on 1% of the embedding table's entries, the floor of any
    end-to-end comparison at this depth."""
    import dataclasses

    from repro_torch.kernels import dispatch
    from repro_torch.models import init_paged_caches, paged_decode_step, paged_prefill_chunk

    dev, c = "cuda", spec.prefill_chunk
    tokens = torch.randint(1, cfg.vocab_size, (1, c + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    table = torch.arange(1, spec.table_width + 1, device=dev)[None, :]

    def copied(caches):
        return [{k: v.clone() for k, v in cache.items()} for cache in caches]

    def tier(backend, want=None, start=None):
        """(prefill layer records, decode layer records, the caches the
        prefill left) on ``backend``; with ``want`` (the torch tier's
        records) teacher-forced, the decode from ``start``."""
        with torch.inference_mode(), dispatch.use_dispatch(backend=backend):
            caches = init_paged_caches(cfg, spec.table_width + 1, spec.block_len, 1, device=dev)
            _, pre = traced_layers(
                lambda: paged_prefill_chunk(prepared.params, caches, tokens[:, :c], 0, table,
                                            c, cfg, spec.block_len, slot_idx=0),
                force=want and (lambda i: want[0][i]))
            left = copied(caches)
            _, dec = traced_layers(
                lambda: paged_decode_step(prepared.params, caches if start is None
                                          else copied(start), tokens[:, c:],
                                          torch.tensor([c], device=dev), table,
                                          torch.tensor([True], device=dev), cfg,
                                          spec.block_len),
                force=want and (lambda i: want[1][i]))
        return pre, dec, left

    def layer_errs(want_pre, want_dec, left):
        """Per layer: the worst prefill row's scaled error, the decode row's."""
        got_pre, got_dec, _ = tier("cuda", want=(want_pre, want_dec), start=left)
        if not len(got_pre) == len(want_pre) == len(got_dec) == len(want_dec) == n_l:
            fail(f"[{tag}] {len(got_pre)} / {len(want_pre)} / {len(got_dec)} / "
                 f"{len(want_dec)} layer calls in the tiers' runs")
        pre_err = scaled_err if static else row_scaled_err

        def err(f, g, w):       # the layer's mixer and FFN (if any), the worse
            return max(f(g[k], w[k]) for k in (1, 3) if w[k] is not None)

        return ([err(pre_err, g, w) for g, w in zip(got_pre, want_pre)],
                [err(row_scaled_err, g, w) for g, w in zip(got_dec, want_dec)])

    n_l, static = cfg.num_layers, spec.static_scales

    def reference_tier():
        return fake_quantized_activations() if static else contextlib.nullcontext()

    with reference_tier():
        reference = tier("torch")
    pre, dec = layer_errs(*reference)
    plain = layer_errs(*tier("torch")) if static else None
    embed = prepared.params["embed"]
    nudged = torch.rand(embed.shape, generator=torch.Generator(device=embed.device).manual_seed(7),
                        device=embed.device) < 0.01
    bumped = torch.where(nudged, (embed.float() * (1 + 2.0 ** -7)).to(embed.dtype), embed)
    with reference_tier():
        pt, dt, _ = chunk_and_step(prepared, cfg, spec, "torch")
        pn, dn, _ = chunk_and_step(dataclasses.replace(
            prepared, params={**prepared.params, "embed": bumped}), cfg, spec, "torch")
    worst = max(range(n_l), key=lambda i: max(pre[i], dec[i]))
    res = {"layout": tag, "tolerance": tol, "layers": n_l,
           "prefill_rows_scaled_by": "the chunk's max" if static else "their own max",
           "prefill_max_scaled_err": max(pre), "decode_max_scaled_err": max(dec),
           "prefill_median_scaled_err": sorted(pre)[n_l // 2],
           "decode_median_scaled_err": sorted(dec)[n_l // 2], "worst_layer": worst,
           "ulp_sensitivity": {"prefill_scaled_err": scaled_err(pn, pt),
                               "decode_scaled_err": scaled_err(dn, dt)}}
    if static:
        res["reference"] = "torch tier, activations quantized against the static scales"
        res["static_quantization_err"] = {"prefill_max_scaled_err": max(plain[0]),
                                          "decode_max_scaled_err": max(plain[1])}
    log(f"[{tag}] tiers layer by layer (teacher-forced): {json.dumps(res)}")
    if not max(max(pre), max(dec)) <= tol:
        fail(f"[{tag}] layer {worst} differs between the tiers: "
             f"{max(pre):.3e} (prefill) / {max(dec):.3e} (decode) > {tol}")
    return res


def consistency_check(prepared, cfg, spec, tag, gated_depth: int) -> dict:
    """The paged prefill against the full-sequence forward on one seeded
    CONSISTENCY_PROMPT-token prompt, cuda tier: ``models.forward`` (a Mamba
    layer's chunked SSD scan, 128-token chunks) against CONSISTENCY_PROMPT /
    prefill_chunk ``paged_prefill_chunk`` calls (each chunk's recurrence
    one scan chunk from the cached state).  The last position's logits
    must be within TIER_TOL of the forward's, scaled (the JAX package's
    ``test_decode_consistency`` limit), on the model cut to its first
    ``gated_depth`` layers; at full depth they are printed, and every layer
    of every chunk, teacher-forced (it takes the forward's inputs to that
    layer at the chunk's rows), must have its mixer's (and FFN's) output
    within TIER_TOL of the forward's on every row, each scaled by its own
    max."""
    from repro_torch.models import forward, init_paged_caches, paged_prefill_chunk

    dev, c, n_l = "cuda", spec.prefill_chunk, cfg.num_layers
    chunks = CONSISTENCY_PROMPT // c
    tokens = torch.randint(1, cfg.vocab_size, (1, CONSISTENCY_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    table = torch.arange(1, spec.table_width + 1, device=dev)[None, :]

    def paged(prep, cf):
        caches = init_paged_caches(cf, spec.table_width + 1, spec.block_len, 1, device=dev)
        for i in range(chunks):
            lp, caches = paged_prefill_chunk(prep.params, caches,
                                             tokens[:, i * c:(i + 1) * c], i * c, table, c,
                                             cf, spec.block_len, slot_idx=0)
        return lp[0, -1].float()

    def rows(i, t):
        return None if t is None else t[:, i // n_l * c:(i // n_l + 1) * c]

    cut_prep, cut_cfg = depth_cut(prepared, cfg, gated_depth)
    with torch.inference_mode(), prepared.activate():
        full, fwd = traced_layers(lambda: forward(prepared.params, cfg, tokens)[0, -1].float())
        last = paged(prepared, cfg)
        _, pag = traced_layers(lambda: paged(prepared, cfg),
                               force=lambda i: [rows(i, t) for t in fwd[i % n_l]])
        cut_full = forward(cut_prep.params, cut_cfg, tokens)[0, -1].float()
        cut_last = paged(cut_prep, cut_cfg)
    if not all(torch.isfinite(t).all() for t in (full, last, cut_full, cut_last)):
        fail(f"[{tag}] non-finite logits in the forward / paged consistency check")
    errs = [max(row_scaled_err(got[k], rows(i, fwd[i % n_l][k])) for k in (1, 3)
                if got[k] is not None) for i, got in enumerate(pag)]
    res = {"layout": tag, "prompt": CONSISTENCY_PROMPT, "paged_chunks": chunks,
           "tolerance": TIER_TOL, "layer_row_max_scaled_err": max(errs),
           "worst_layer": errs.index(max(errs)) % n_l,
           "gated_depth": gated_depth, "scaled_err_at_gated_depth": scaled_err(cut_last, cut_full),
           "same_argmax_at_gated_depth": bool(cut_last.argmax() == cut_full.argmax()),
           "scaled_err_at_full_depth": scaled_err(last, full),
           "same_argmax_at_full_depth": bool(last.argmax() == full.argmax())}
    log(f"[{tag}] forward (chunked scan) vs paged prefill: {json.dumps(res)}")
    if (len(errs) != chunks * n_l or not max(errs) <= TIER_TOL
            or not res["scaled_err_at_gated_depth"] <= TIER_TOL):
        fail(f"[{tag}] forward and paged prefill disagree: {json.dumps(res)}")
    return res


def expert_path_gap(prepared, cfg, spec, tag) -> dict:
    """The spgemm path's logits against the gather path's on the same
    params, cuda tier (expected 0: every kernel is row-independent; not
    gated)."""
    import dataclasses

    sp = chunk_and_step(prepared, cfg, spec, "cuda")
    ga = chunk_and_step(prepared, dataclasses.replace(cfg, moe_expert_path="gather"), spec,
                        "cuda")
    res = {"layout": tag, "prefill_max_abs_gap": (sp[0] - ga[0]).abs().max().item(),
           "decode_max_abs_gap": (sp[1] - ga[1]).abs().max().item(),
           "bitwise": bool(torch.equal(sp[0], ga[0]) and torch.equal(sp[1], ga[1]))}
    log(f"[{tag}] spgemm vs gather expert path, cuda tier: {json.dumps(res)}")
    return res


# --------------------------------------------------------------- prefill
def prefill_batch(cfg, b: int, t: int) -> dict:
    """One seeded prefill batch on the card: frame embeddings (B, T, d) for
    the audio encoder, or ``num_patches`` patch embeddings (at the
    embedding table's scale, d**-0.5) and T text tokens for the
    vision-prefix decoder."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    d, dt = cfg.d_model, cfg.torch_dtype
    if cfg.frontend == "audio_frames":
        return {"frames": torch.randn((b, t, d), generator=gen, device="cuda").to(dt)}
    return {"patches": (torch.randn((b, cfg.num_patches, d), generator=gen, device="cuda")
                        * d ** -0.5).to(dt),
            "tokens": torch.randint(1, cfg.vocab_size, (b, t), generator=gen, device="cuda")}


DUAL_BASES = {"dense": "tile_gemm_dual", "compressed": "nm_spmm_dual",
              "gather": "nm_spmm_gather_dual_bk"}


def prefill_gemm_sites(cfg):
    """(K, O, site) of each distinct GEMM a prefill layer runs: the q / k /
    v / o projections and w_out as singles, w_in as the gelu single or the
    gate-up dual."""
    d, ff = cfg.d_model, cfg.d_ff
    singles = dict.fromkeys(((d, cfg.attn_dim), (d, cfg.kv_dim), (cfg.attn_dim, d), (ff, d)))
    sites = [(k, o, "single") for k, o in singles]
    return sites + [(d, ff, "gelu" if cfg.act == "gelu" else "dual")]


def prefill_kernel_phase(base_cfg, prefill_runs, batch_shape, gen, card_line, rows):
    """Every GEMM kernel of the prefill runs, at that path's rows (B x T
    positions, ragged against the 64-row tiles for hubert's 4000) and
    widths, against its plain version on the same operands: each layout
    and class a run in ``prefill_runs`` takes, on each site of
    ``prefill_gemm_sites`` (the gelu w_in with its gelu flush, as the
    model calls it).  Held at TOL of max|plain|; int8 also holds its raw
    int32 accumulator bitwise, and its scaled bf16 output bitwise where no
    gelu flush runs (at the gelu site ``bitwise`` is recorded, not gated:
    the kernel's tanhf and torch's may round apart).  Timed beside the
    plain version and the class's library call on the dense or
    decompressed weight (the gather's on the pre-gathered X; a dual's as
    two calls, gate and up).  Bound: x (codes and row scales), the weight
    bytes (values + meta or index + scales) and the bf16 output moved
    once, 2 * rows * K_eff * O operations per product."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.sparse_linear import SparsityConfig, convert_layout
    from repro_torch.kernels.epilogue import EpilogueSpec
    from repro_torch.kernels.nm_spmm.ref import dense_weight
    from repro_torch.kernels.nm_spmm_gather.ref import gather_columns

    dev, bf16 = "cuda", torch.bfloat16
    b, t_in = batch_shape
    m = b * (t_in + base_cfg.num_patches)
    gelu = EpilogueSpec(act="gelu")
    record = recorder(rows, card_line)
    for layout, sparsity, qname, _ in prefill_runs:
        qdtype = QDTYPES.get(qname)
        fp8, int8 = qdtype == FP8, qdtype == torch.int8
        n = sparsity[0] if sparsity else 4
        esz = 1 if qdtype is not None else 2
        peak = BF16_FLOPS if qdtype is None else FP8_OPS if fp8 else INT8_OPS
        lay = column_major if fp8 else int_mm_layout()[1] if int8 else None
        modname, base = LAYOUT_MODULES[layout]
        km = importlib.import_module(f"repro_torch.kernels.{modname}.kernel")
        rm = importlib.import_module(f"repro_torch.kernels.{modname}.ref")
        sfx = f"_{qname}" if qname else ""
        nn = () if layout == "dense" else (n,)
        mode = "gather" if layout == "gather" else "compressed"

        def leaf(k, o):
            w = torch.randn((k, o), generator=gen, device=dev) * k ** -0.5
            lf = convert_layout({"w": w if qdtype else w.to(bf16)},
                                SparsityConfig(n=n, m=4, mode=mode),
                                layout if n < 4 else "dense", quantize=qdtype)
            if layout == "dense":
                lf["ops"], dense = (lf["w"],), lf["w"]
            elif layout == "compressed":
                lf["ops"] = (lf["values"], lf["meta_packed"])
                dense = dense_weight(lf["values"], lf["meta_packed"], n)
            else:
                lf["ops"], dense = (lf["values"], lf["gather_idx"]), lf["values"]
            lf["scales"] = () if qdtype is None else (lf["scale"].reshape(1, -1),)
            lf["lib"] = lay(dense) if lay else dense
            return lf

        def wbytes(k, o):     # values + meta or index (+ scale)
            kc = k * n // 4
            extra = kc * o // 4 if layout == "compressed" else 4 * kc if layout == "gather" else 0
            return esz * kc * o + extra + (4 * o if qdtype is not None else 0)

        def lib_call(x, xs, lf):
            """The library call and its operands for one weight."""
            xl = gather_columns(x, lf["gather_idx"], n) if layout == "gather" else x
            if qdtype is None:
                return torch.matmul, (xl, lf["lib"])
            if int8:
                return int_mm_padded, (xl, lf["lib"])
            r16 = -(-m // 16) * 16
            return scaled_mm, (pad_rows(xl, r16), lf["lib"], pad_rows(xs, r16, 1.0),
                               lf["scales"][0])

        for k, o, site in prefill_gemm_sites(base_cfg):
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            x, xs = (x, None) if qdtype is None else quantize_rows(x, qdtype)
            xsc = () if qdtype is None else (xs,)
            kw = {} if qdtype is None else {"out_dtype": bf16}
            kc = k * n // 4
            xbytes = esz * m * k + (4 * m if qdtype is not None else 0)
            if site == "dual":
                name = f"{DUAL_BASES[layout]}{sfx}"
                fn = getattr(km, name)
                ref = getattr(rm, f"{modname}_dual{sfx}_ref")
                pairs = [(leaf(k, o), leaf(k, o)) for _ in range(copies_for(2 * wbytes(k, o)))]

                def call(f, x_, g, u):
                    return f(x_, *g["ops"], *u["ops"], *nn, *xsc, *g["scales"], *u["scales"],
                             **kw)
                ops = [(x, g, u) for g, u in pairs]
                lib_fn = lib_call(x, xs, pairs[0][0])[0]
                lib_ops = [lib_call(x, xs, g)[1] + lib_call(x, xs, u)[1] for g, u in pairs]
                half = len(lib_ops[0]) // 2
                nbytes, flops = xbytes + 2 * wbytes(k, o) + 2 * m * o, 4 * m * kc * o
                library = "two calls (gate, up)"

                def lib(*a, f=lib_fn, h=half):
                    return f(*a[:h]), f(*a[h:])
            else:
                name = f"{base}{sfx}"
                fn = getattr(km, name)
                ref = getattr(rm, f"{modname}{sfx}_ref")
                epi = {"epilogue": gelu} if site == "gelu" else {}
                lfs = [leaf(k, o) for _ in range(copies_for(wbytes(k, o)))]

                def call(f, x_, lf, epi=epi):
                    return f(x_, *lf["ops"], *xsc, *lf["scales"], *nn, **epi, **kw)
                if qdtype is not None:
                    # the raw accumulator: int8 exact, e4m3 fp32 sums in another order
                    lf0 = lfs[0]
                    raw = fn(x, *lf0["ops"], None, None, *nn)
                    raw_ref = ref(x, *lf0["ops"], None, None, *nn)
                    torch.cuda.synchronize()
                    raw_err = scaled_err(raw, raw_ref)
                    if raw.dtype != raw_ref.dtype or (int8 and not torch.equal(raw, raw_ref)) \
                            or not raw_err <= TOL:
                        fail(f"{name} B={m} K={k} O={o} n={n}: raw accumulator off its "
                             f"plain version ({raw.dtype}, scaled error {raw_err:.3e})")
                ops = [(x, lf) for lf in lfs]
                lib, lib_ops = lib_call(x, xs, lfs[0])[0], [lib_call(x, xs, lf)[1] for lf in lfs]
                nbytes, flops = xbytes + wbytes(k, o) + 2 * m * o, 2 * m * kc * o
                library = "pre-gathered X" if layout == "gather" else "same operands"

            def run(*a, f=fn, c=call):
                return c(f, *a)

            def plain(*a, f=ref, c=call):
                return c(f, *a)
            before = fn.launches
            got = run(*ops[0])
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                fail(f"{name}: the wrapper did not count its launch")
            want = plain(*ops[0])
            extra = {"bitwise": bool(torch.equal(got, want))} if int8 and site == "gelu" else {}
            if name in ("nm_spmm", "tile_gemm", "tile_gemm_fp8", "nm_spmm_gather_bk",
                        "tile_gemm_dual", "nm_spmm_gather_dual_bk", "nm_spmm_gather_bk_int8"):
                # the redesigned bodies, beside the first
                if site == "dual":
                    again = run(*ops[0])
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        fail(f"{name} B={m} K={k} O={o}: not the same bits on a second launch")
                t_run, extra["earlier_ms"] = in_turns(run, ops, calls=8)
                if name == "tile_gemm_fp8":
                    extra["plan"] = km.fp8_plan(m, k, o)
                elif name == "nm_spmm_gather_bk":
                    extra["plan"] = km.plan(m, k, o, n)
                elif name == "nm_spmm_gather_bk_int8":
                    extra["plan"] = km.int8_plan(m, k, o, n)
                elif name == "tile_gemm_dual":
                    extra["plan"] = km.dual_plan(m, k, o)
                elif name == "nm_spmm_gather_dual_bk":
                    extra["plan"] = km.dual_plan(m, k, o, n)
            else:
                t_run = time_ms(run, ops, calls=8)
            record(name, m, k, o, n, got, want, t_run,
                   time_ms(plain, ops, calls=8), time_ms(lib, lib_ops, calls=8), nbytes, flops,
                   peak=peak, exact=int8 and site != "gelu", prefill=base_cfg.name,
                   site=site, library=library + (", no gelu" if site == "gelu" else ""), **extra)
            del ops, lib_ops
            torch.cuda.empty_cache()
    torch.cuda.synchronize()


def prefill_run(base_cfg, layout, sparsity, qdtype, depth, batch_shape, card_line,
                earlier=False):
    """One forward of the prefill path (``models.make_prefill_step``) at
    full width: prepare (layout conversion, weight quantization; no static
    scales: the JAX package calibrates only over tokens), the dispatch
    plan (every linear site on a cuda kernel of its layout and class), one
    counted forward (counts zeroed just before and read just after: the
    layout's kernels and flash_attention once per layer, nothing else),
    the latency (median of PREFILL_REPEATS, CUDA events), one profiled
    forward (device busy vs wall) and the torch tier's logits on the same
    params (scaled error, argmax agreement; the torch tier's chunked
    attention takes the config's causal flag, so a kernel run with the
    other branch would miss the limit by far: row 0 of a causal run sees
    one key, of a non-causal run all of them).  With ``earlier``, the
    latency and busy share again with the first flash_attention and
    nm_spmm / tile_gemm bodies swapped in (``earlier_kernels``), after the
    counts are read, the latencies of the two timed in turns."""
    import dataclasses

    from torch.profiler import ProfilerActivity

    from repro_torch import kernels, serving
    from repro_torch.kernels import dispatch
    from repro_torch.models import init_params, make_prefill_step

    tag = (f"{base_cfg.name}/" + ("gather-" if layout == "gather" else "")
           + (f"{sparsity[0]}:{sparsity[1]}" if sparsity else "dense")
           + (f"/{qdtype}" if qdtype else ""))
    spec = serving.ServingSpec(layout=layout, sparsity=sparsity, qdtype=qdtype)
    cfg = spec.apply_to(dataclasses.replace(base_cfg,
                                            num_layers=depth or base_cfg.num_layers))
    b, t_in = batch_shape
    seq = t_in + cfg.num_patches
    log(f"[{tag}] depth: {cfg.num_layers} layers (d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"{cfg.num_heads} heads of {cfg.head_dim}, {cfg.act}, "
        f"{'causal' if cfg.causal else 'non-causal'}, frontend {cfg.frontend}); batch "
        f"{b} x {seq}" + (f" ({cfg.num_patches} patches + {t_in} tokens)"
                         if cfg.num_patches else " frames"))
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        prepared = serving.prepare(params, spec, cfg=cfg)
        del params
        torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    report = prepared.dispatch_report(batches=(b * seq,))
    log(f"[{tag}] init + prepare {time.perf_counter() - t0:.1f}s, {weights_gb:.2f} GB "
        f"allocated; dispatch engine plan at {b * seq} rows:")
    for line in report:
        log(line)
    want = f"{KINDS[layout]}{'_' + qdtype if qdtype else ''}[cuda]"
    off = [line for line in report if want not in line]
    if off:
        fail(f"[{tag}] {len(off)} linear site(s) off the {want} kernels: {off[0]}")
    single, dual = LAYOUT_KERNELS[layout, qdtype, False]
    expected = (single, "flash_attention") + ((dual,) if cfg.act == "swiglu" else ())

    batch = prefill_batch(cfg, b, t_in)
    step = make_prefill_step(cfg)

    def forward():
        return step(prepared.params, batch)

    t1 = time.perf_counter()
    with torch.inference_mode(), prepared.activate():
        forward()                                  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        logits = forward()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()

        def latencies():
            """PREFILL_REPEATS forward latencies (CUDA events)."""
            ms = []
            for _ in range(PREFILL_REPEATS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                forward()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            return ms

        def profile():
            return device_profile(forward, 1, [ProfilerActivity.CPU, ProfilerActivity.CUDA])[1:]
        if earlier:
            # the same forward on the first flash and nm_spmm bodies, in
            # turns: earlier, current, current, earlier
            with earlier_kernels():
                forward()
                torch.cuda.synchronize()
                e_ms = latencies()
            ms = latencies()
            kern, wall_ms = profile()
            ms += latencies()
            with earlier_kernels():
                e_ms += latencies()
                e_kern, e_wall = profile()
        else:
            ms = latencies()
            kern, wall_ms = profile()
    with torch.inference_mode(), dispatch.use_dispatch(backend="torch"):
        ref = forward()
    torch.cuda.synchronize()
    log(f"[{tag}] launches: {json.dumps({k: c for k, c in counts.items() if c})}")
    check_launches(tag, counts, expected)
    if counts["flash_attention"] != cfg.num_layers:
        fail(f"[{tag}] flash_attention launched {counts['flash_attention']} times, not "
             f"once per layer ({cfg.num_layers})")
    if tuple(logits.shape) != (b, seq, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"[{tag}] logits of shape {tuple(logits.shape)}, finite: "
             f"{bool(torch.isfinite(logits).all())}")
    tol = {None: TIER_TOL, "int8": INT8_TIER_TOL, "fp8": FP8_TIER_TOL}[qdtype]
    err = scaled_err(logits, ref)
    agree = (logits.float().argmax(-1) == ref.float().argmax(-1)).float().mean().item()
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 if kern else None
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    median = sorted(ms)[len(ms) // 2]
    unit = "frames" if cfg.frontend == "audio_frames" else "tokens"
    res = {"run": tag, "arch": cfg.name, "num_layers": cfg.num_layers, "batch": [b, seq],
           "weights_gb": weights_gb, "forward_ms_median": median, "forward_ms": ms,
           f"{unit}_per_s": b * seq / (median / 1e3),
           "kernel_launches_per_forward": sum(counts.values()),
           "device_launches_per_forward": sum(e.count for e in kern),
           "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": None if busy_ms is None else busy_ms / wall_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
           "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                            "calls": e.count} for e in top],
           "tier_scaled_err": err, "tier_tolerance": tol, "argmax_agreement": agree,
           "positions": b * seq, "launches": counts, "card": card_line}
    if earlier:
        e_busy = sum(e.self_device_time_total for e in e_kern) / 1e3 if e_kern else None
        res["earlier"] = {"forward_ms_median": sorted(e_ms)[len(e_ms) // 2], "forward_ms": e_ms,
                          "profiled_wall_ms": e_wall, "device_busy_ms": e_busy,
                          "device_busy_share": None if e_busy is None else e_busy / e_wall,
                          "bodies": "flash_attention_wmma.cu, vg_nm_spmm_tiled, "
                                    "vg_tile_gemm_tiled, vg_nm_spmm_fp8_tiled"}
    log(json.dumps(res))
    log(f"[{tag}] seconds: prepare and plan {t1 - t0:.1f}, forwards, profile and torch "
        f"tier {time.perf_counter() - t1:.1f}")
    if not (err <= tol):
        fail(f"[{tag}] cuda vs torch tier logits differ: {err:.4f} > {tol}")
    return res


# --------------------------------------------------------------- main
# --------------------------------------------------------------- phase 5
# tensor-parallel serving over a (1, 2) mesh (ServingSpec.mesh) of full-width
# internlm2-1.8b, the first 8 requests of the seeded trace: (layout,
# sparsity, qdtype, static, depth).  Five runs cut to 4 of 24 layers for
# time, then int8 gather 2:4 at all 24.
SHARD_MESH = (1, 2)
SHARD_REQUESTS = 8
SHARD_RUNS = (("dense", None, None, False, 4), ("gather", (2, 4), None, False, 4),
              ("gather", (2, 4), "int8", False, 4), ("gather", (2, 4), "int8", True, 4),
              ("gather", (1, 4), "fp8", False, 4), ("gather", (2, 4), "int8", False, 24))
# the column-parallel sites of a layer (wq, wk, wv and the gate-up pair's
# two GEMMs) and its row-parallel ones (wo, w_out)
COL_SITES = 5
ROW_SITES = 2


def shard_tag(layout, sparsity, qdtype, static, depth):
    return (f"tp{SHARD_MESH[1]}/" + ("gather-" if layout == "gather" else "")
            + (f"{sparsity[0]}:{sparsity[1]}" if sparsity else "dense")
            + (f"/{qdtype}" if qdtype else "") + ("/static" if static else "")
            + f"/{depth}L")


def sharded_step_profile(prepared, cfg, spec, steps: int = 3) -> dict:
    """One rank's view of a batched decode step at position 255 (every
    slot active): host wall, the device's busy share under torch.profiler
    (this process's kernels only), launches split into the hand-written
    kernels (their wrappers' counts) and all others, and the model axis's
    collectives (calls, MB, host wall)."""
    from torch.profiler import ProfilerActivity

    from repro_torch import kernels
    from repro_torch.models import init_paged_caches, paged_decode_step
    from repro_torch.models.pjit_utils import COLLECTIVES, reset_collectives

    dev = prepared.device
    b, w = spec.slots, spec.table_width
    with torch.inference_mode(), prepared.activate():
        caches = init_paged_caches(cfg, b * w + 1, spec.block_len, device=dev)
        table = torch.arange(1, b * w + 1, device=dev).reshape(b, w)
        tokens = torch.randint(1, cfg.vocab_size, (b, 1), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(3))
        positions = torch.full((b,), 255, device=dev)
        active = torch.ones((b,), dtype=torch.bool, device=dev)

        def step():
            return paged_decode_step(prepared.params, caches, tokens, positions, table,
                                     active, cfg, spec.block_len)

        step()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        reset_collectives()
        prof, kern, wall_ms = device_profile(step, steps, [ProfilerActivity.CUDA,
                                                           ProfilerActivity.CPU])
        hand = sum(kernels.launch_counts().values()) / steps
        coll = dict(COLLECTIVES)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps if kern else None
    launches = sum(e.count for e in kern) / steps
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
            "launches_per_step": launches, "hand_written_launches_per_step": hand,
            "other_launches_per_step": launches - hand,
            "collectives_per_step": coll["calls"] / steps,
            "collective_mb_per_step": coll["bytes"] / steps / 1e6,
            "collective_host_ms_per_step": coll["seconds"] * 1e3 / steps,
            "top_kernels": [{"name": e.key[:80], "ms_per_step":
                             e.self_device_time_total / 1e3 / steps}
                            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]]}


def shard_rank(rank, world, dev, base_cfg, runs, out_dir):
    """One rank of the sharded serving phase: every run of ``runs`` in
    turn, the same work on every rank (the collectives pair up); rank 0
    also serves each model unsharded for the tier gate.  Writes its
    results to ``out_dir/rank{r}.json``."""
    import dataclasses

    from repro_torch import kernels, serving
    from repro_torch.models import init_params
    from repro_torch.models.pjit_utils import COLLECTIVES, reset_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for layout, sparsity, qdtype, static, depth in runs:
        tag = shard_tag(layout, sparsity, qdtype, static, depth)
        t0 = time.perf_counter()
        spec = serving.ServingSpec(layout=layout, sparsity=sparsity, qdtype=qdtype,
                                   static_scales=static, mesh=SHARD_MESH, slots=8,
                                   max_len=512, block_len=8, prefill_chunk=64)
        cfg = spec.apply_to(dataclasses.replace(base_cfg, num_layers=depth))
        calib_tokens = None
        if static:
            calib_tokens = torch.randint(
                1, cfg.vocab_size, (spec.slots, min(spec.max_len, CALIB_TOKENS)),
                generator=torch.Generator(device=dev).manual_seed(2), device=dev)
        ref = None
        with torch.inference_mode():
            params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
            if rank == 0:     # the same model served unsharded, for the tier gate
                full = serving.prepare(params, dataclasses.replace(spec, mesh=None), cfg=cfg,
                                       calib_tokens=calib_tokens, device=dev)
                ref = chunk_and_step(full, cfg, spec, "cuda")[:2]
                del full
            prepared = serving.prepare(params, spec, cfg=cfg, calib_tokens=calib_tokens,
                                       device=dev)
        del params
        torch.cuda.synchronize()
        weights_gb = sum(t.numel() * t.element_size()
                         for t in _tensors(prepared.params)) / 1e9
        report = prepared.dispatch_report()
        want = f"{KINDS[layout]}{'_' + qdtype if qdtype else ''}[cuda]"
        off = [ln for ln in report if want not in ln or "shard_map[" not in ln
               or (static and "act-scales=static" not in ln)]
        if off:
            fail(f"[{tag}] rank {rank}: {len(off)} site(s) off the sharded {want} "
                 f"kernels: {off[0]}")
        engine = serving.Engine(prepared)
        engine.run(serving.make_poisson_trace(seed=1, num_requests=2,
                                              vocab_size=cfg.vocab_size,
                                              prompt_mix=((64, 1.0),), new_mix=((2, 1.0),)))
        trace = serving.make_poisson_trace(
            seed=0, num_requests=16, rate=1.0, vocab_size=cfg.vocab_size,
            prompt_mix=((128, 1.0), (192, 1.0), (256, 1.0)),
            new_mix=((32, 1.0),))[:SHARD_REQUESTS]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        reset_collectives()
        rep = engine.run(trace)      # raises unless every rank made the same tokens
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        coll = dict(COLLECTIVES)
        # every row-parallel site on its layout's raw partial (K11 for a
        # quantized gather) and nothing else; every column site on its
        # layout's single GEMM
        single = LAYOUT_KERNELS[layout, qdtype, False][0]
        k11 = f"nm_spmm_gather_{qdtype}" if layout == "gather" and qdtype else None
        calls = rep.model_calls * depth
        want_counts = ({single: COL_SITES * calls, k11: ROW_SITES * calls} if k11
                       else {single: (COL_SITES + ROW_SITES) * calls})
        if counts != want_counts:
            fail(f"[{tag}] rank {rank}: launches {counts}, expected {want_counts} "
                 f"({rep.model_calls} model calls x {depth} layers)")
        if rep.completed != len(trace) or any(len(x.tokens) != 32 for x in rep.stats):
            fail(f"[{tag}] rank {rank}: {rep.completed}/{len(trace)} requests completed")
        profile = sharded_step_profile(prepared, cfg, spec)
        with prepared.activate():
            got = chunk_and_step(prepared, cfg, spec, "cuda")[:2]
        res = {"run": tag, "rank": rank, "device": str(dev), "num_layers": depth,
               "weights_gb_per_rank": weights_gb, "launches": counts,
               "model_calls": rep.model_calls, "decode_profile": profile,
               "serving_collectives": {"calls": coll["calls"], "mb": coll["bytes"] / 1e6,
                                       "host_s": coll["seconds"]}}
        if rank == 0:
            tol = {None: TIER_TOL, "int8": STATIC_TIER_TOL if static else INT8_TIER_TOL,
                   "fp8": FP8_TIER_TOL}[qdtype]
            gaps = [scaled_err(g, r) for g, r in zip(got, ref)]
            if not all(torch.isfinite(g).all() for g in got):
                fail(f"[{tag}] non-finite sharded logits")
            agree = (torch.cat(got).argmax(-1) == torch.cat(ref).argmax(-1)).float().mean()
            res.update({"tokens_per_s": rep.tokens_per_s, "p50_latency_s": rep.p50_latency_s,
                        "p99_latency_s": rep.p99_latency_s, "wall_s": rep.wall_s,
                        "token_streams_equal_across_ranks": True,
                        "vs_unsharded": {"prefill_scaled_err": gaps[0],
                                         "decode_scaled_err": gaps[1], "tolerance": tol,
                                         "greedy_agreement": agree.item()},
                        "plan": report[:2],
                        # the raw partials' rows: a decode batch of 8 padded to
                        # 32, a prefill chunk of 64
                        "kernel_plans": redesigned_plans(cfg, layout, sparsity, qdtype,
                                                         (32, spec.prefill_chunk),
                                                         SHARD_MESH[1])})
            if not max(gaps) <= tol:
                fail(f"[{tag}] sharded vs unsharded logits: {gaps} > {tol}")
        res["seconds"] = time.perf_counter() - t0
        log(json.dumps(res))
        results.append(res)
        del prepared, engine
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def sharded_phase(base_cfg, runs=SHARD_RUNS) -> list:
    """Tensor-parallel serving on SHARD_MESH: the ranks are spawned once for
    every run (the kernels are already built: they only load them).  Ranks
    share the cards round-robin (one H100: both on it, gloo); a rank's
    failure fails the phase.  Returns every rank's results."""
    import tempfile

    from repro_torch.launch import mesh as tmesh

    world = SHARD_MESH[1]
    backend = tmesh.backend_for(world)
    log(f"sharded serving: mesh {SHARD_MESH[0]}x{world} over torch.distributed, backend "
        f"{backend}; " + ", ".join(f"rank {r} -> {tmesh.rank_device(r)}"
                                   for r in range(world)))
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            tmesh.spawn_ranks(shard_rank, world, base_cfg, runs, out_dir)
        except Exception as e:        # a rank raised or exited: the phase failed
            fail(f"sharded serving: {type(e).__name__}: {str(e)[-2000:]}")
        return [r for k in range(world)
                for r in json.load(open(os.path.join(out_dir, f"rank{k}.json")))]


def layer_decode(rows, kernel, n, b, shapes):
    """Sum of one layer's decode-step launches of ``kernel`` at batch b."""
    tot = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    used = []
    for k, o in shapes:
        r = next(r for r in rows if (r["kernel"], r["B"], r.get("K"), r.get("O"), r.get("n"))
                 == (kernel, b, k, o, n))
        for key in tot:
            tot[key] += r[key]
        used.append(r)
    if all("earlier_ms" in r for r in used):
        tot["earlier_ms"] = sum(r["earlier_ms"] for r in used)
    tot["bound_by"] = max(used, key=lambda r: r["bound_ms"])["bound_by"]
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["kernel"] == kernel)
    return tot


def stream_static_smem() -> dict:
    """The static shared memory ptxas gave each instantiation of the two
    streams' kernels (nm_spmm_sp.cuh's, nm_spmm_sp_fp8.cuh's) in this run's
    build, by its MASKED flag, the last literal of the template.  kmask.cuh's
    bitmask is declared only where MASKED, so the unmasked ones hold none."""
    from repro_torch.kernels import _build

    out = {"masked": set(), "unmasked": set()}
    for text in _build.BUILD_LOG.values():
        entry = None
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)
                continue
            t = entry and re.search(r"nm_spmm_sp(?:_fp8)?_kernelI((?:L[ib]\d+E)+)", entry)
            if t and "Used " in ln and "registers" in ln:
                masked = re.findall(r"L[ib](\d+)E", t.group(1))[-1] == "1"
                m = re.search(r"(\d+) bytes smem", ln)
                out["masked" if masked else "unmasked"].add(int(m.group(1)) if m else 0)
                entry = None
    return {key: sorted(v) for key, v in out.items()}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke test needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    secs = _build.build_all()
    log(f"build: {json.dumps(secs)} seconds")
    for name, text in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"ptxas {name}: {len(regs)} kernels; " + "; ".join(sorted(set(regs))))
    smem = stream_static_smem()
    log(f"the streams' static shared memory, bytes a block: {json.dumps(smem)}")
    if any(smem["unmasked"]):
        fail(f"an unmasked stream kernel holds static shared memory: {smem['unmasked']}")

    from repro_torch.kernels.mma_sp_probe import probe
    found = probe()
    log(f"mma.sp operand layout probe: {json.dumps(found, default=str)}")
    if not found["ok"]:
        fail("the sparse tensor-core instruction's operand layout is not the one "
             "nm_spmm's sparse body assumes")

    cfg = get_config("internlm2_1_8b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    card_line = card()
    t0 = time.perf_counter()
    moe_cfg = get_config(MOE_ARCH)
    rows = kernel_phase(cfg, gen, card_line)
    quantized_kernel_phase(cfg, moe_cfg, gen, card_line, rows, torch.int8)
    quantized_kernel_phase(cfg, moe_cfg, gen, card_line, rows, FP8)
    log(f"kernel phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for qdtype in (None, torch.int8, FP8):
        gather_kernel_phase(cfg, gen, card_line, rows, qdtype)
    log(f"gather kernel phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dual_sweep_phase([(c.d_model, c.d_ff) for c in (cfg, get_config(PHI3_ARCH), moe_cfg)],
                     gen, card_line)
    log(f"dual sweep phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fp8_sweep_phase(cfg, moe_cfg, gen, card_line)
    log(f"fp8 sweep phase {time.perf_counter() - t0:.1f}s")
    t_new = time.perf_counter()
    kmajor_kernel_phase(cfg, gen, card_line, rows)
    k11_s = time.perf_counter() - t_new
    log(f"K11 kernel phase {k11_s:.1f}s")
    t0 = time.perf_counter()
    for qdtype in (None, torch.int8, FP8):
        masked_kernel_phase(gen, card_line, rows, qdtype)
    log(f"masked kernel phase {time.perf_counter() - t0:.1f}s")
    gemma_cfg = get_config(GEMMA_ARCH)
    t0 = time.perf_counter()
    for qdtype in (torch.int8, FP8):
        requant_single_phase(gemma_cfg, gen, card_line, rows, qdtype)
    log(f"requant single phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    attention_phase(cfg, gen, card_line, rows)
    attention_phase(gemma_cfg, gen, card_line, rows)
    hubert_cfg, phi3_cfg = get_config(HUBERT_ARCH), get_config(PHI3_ARCH)
    attention_phase(hubert_cfg, gen, card_line, rows, HUBERT_ATTN_SHAPES)
    attention_phase(phi3_cfg, gen, card_line, rows, PHI3_ATTN_SHAPES)
    log(f"attention phase {time.perf_counter() - t0:.1f}s")
    for q, dt in QDTYPES.items():
        log(f"activation quantize pass, {q} (one call, B=8, K={cfg.d_model}): "
            f"{json.dumps(quantize_pass(cfg.d_model, dt))}")
    mamba_cfg, jamba_cfg = get_config(MAMBA_ARCH), get_config(JAMBA_ARCH)
    t0 = time.perf_counter()
    ssm_kernel_phase(mamba_cfg, gen, card_line, rows)
    log(f"SSM kernel phase {time.perf_counter() - t0:.1f}s")

    t_serving = time.perf_counter()
    served, tiers, launches = [], [], {}
    runs = [(cfg, layout, sparsity, qdtype, static, depth, None, {})
            for layout, sparsity, qdtype, static, depth in LAYOUTS]
    runs += [(moe_cfg, layout, sparsity, qdtype, static, MOE_DEPTH, path, {})
             for path, layout, sparsity, qdtype, static in MOE_RUNS]
    runs += [(gemma_cfg, *run, None, GEMMA_SERVE) for run in GEMMA_RUNS]
    runs += [(get_config(STARCODER_ARCH), *run, None, {}) for run in STARCODER_RUNS]
    runs += [(mamba_cfg, *run, None, {"requests": MOE_REQUESTS, "consistency": run[2] is None})
             for run in MAMBA_RUNS]
    runs += [(jamba_cfg, *run, None, "gather", {"cuts": JAMBA_CUTS}) for run in JAMBA_RUNS]
    flash_by_d = {}         # flash_attention launches by head_dim
    for base, layout, sparsity, qdtype, static, depth, path, opts in runs:
        t0 = time.perf_counter()
        res, tier = serve_layout(base, layout, sparsity, qdtype, static, depth, path, **opts)
        served.append(res)
        tiers.append(tier)
        # a static run's main path is its calibration forward and its serving
        run_counts = [res["launches"]] + ([res["calibration"]["launches"]]
                                          if "calibration" in res else [])
        for counts in run_counts:
            for name, cnt in counts.items():
                launches[name] = launches.get(name, 0) + cnt
            flash_by_d[base.head_dim] = (flash_by_d.get(base.head_dim, 0)
                                         + counts["flash_attention"])
        torch.cuda.empty_cache()
        log(f"[{res['layout']}] phase {time.perf_counter() - t0:.1f}s")
    log(f"serving phase {time.perf_counter() - t_serving:.1f}s")
    # the decode steps that run the float nm_spmm_dual, the bf16 nm_spmm_masked,
    # the bf16 tile_gemm_masked, nm_spmm_masked_fp8, the bf16
    # nm_spmm_gather_bk_masked, K9 fp8, tile_gemm_masked_fp8, nm_spmm_int8,
    # tile_gemm_int8, nm_spmm_gather_bk_int8, nm_spmm_dual_int8(_requant),
    # tile_gemm_dual_int8(_requant), K9 int8(_requant), nm_spmm_masked_int8 and
    # tile_gemm_masked_int8
    busy = {res["layout"]: res["decode_profile"]["device_busy_ms"] for res in served
            if res["layout"] in ("2:4", "1:4", "2:4/int8", "1:4/int8", "2:4/int8/static",
                                 "dense/int8", "gather-2:4/int8", "gather-1:4/int8",
                                 "moe-spgemm/2:4", "moe-spgemm/dense",
                                 "moe-spgemm/dense/fp8", "moe-spgemm/2:4/fp8",
                                 "moe-spgemm/gather-2:4", "moe-spgemm/gather-2:4/fp8",
                                 "moe-spgemm/2:4/int8/static", "moe-spgemm/dense/int8/static",
                                 "moe-spgemm/gather-2:4/int8/static")}
    log(f"decode step device busy ms (internlm2-1.8b bf16 2:4 and 1:4, int8 2:4 and 1:4, "
        f"static int8 2:4, int8 dense, gather 2:4 and 1:4, qwen3-moe spgemm bf16 2:4, bf16 "
        f"dense, fp8 dense, fp8 2:4, bf16 gather 2:4, fp8 gather 2:4, static int8 2:4, "
        f"dense and gather 2:4): {json.dumps(busy)}")
    ssm_runs = {res["layout"]: {
        "tokens_per_s": res["tokens_per_s"], "p50_latency_s": res["p50_latency_s"],
        "p99_latency_s": res["p99_latency_s"], "weights_gb": res["weights_gb"],
        **{k: res["decode_profile"][k] for k in ("step_wall_ms", "device_busy_ms",
                                                  "device_idle_share", "launches_per_step")},
        **{f"prefill_{k}": res["prefill_profile"][k]
           for k in ("chunk_wall_ms", "device_busy_ms", "launches_per_token")}}
        for res in served if res["arch"] in (mamba_cfg.name, jamba_cfg.name)}
    log(f"SSM and hybrid serving ({card_line}): {json.dumps(ssm_runs)}")

    t0 = time.perf_counter()
    prefill_kernel_phase(hubert_cfg, HUBERT_RUNS, HUBERT_BATCH, gen, card_line, rows)
    prefill_kernel_phase(phi3_cfg, PHI3_RUNS, PHI3_BATCH, gen, card_line, rows)
    log(f"prefill kernel phase {time.perf_counter() - t0:.1f}s")
    t_prefill = time.perf_counter()
    prefill = []
    runs = [(hubert_cfg, *run, HUBERT_BATCH) for run in HUBERT_RUNS]
    runs += [(phi3_cfg, *run, PHI3_BATCH) for run in PHI3_RUNS]
    for base, layout, sparsity, qdtype, depth, batch_shape in runs:
        t0 = time.perf_counter()
        res = prefill_run(base, layout, sparsity, qdtype, depth, batch_shape, card_line,
                          earlier=base is hubert_cfg and layout in ("dense", "compressed")
                          and qdtype is None)
        prefill.append(res)
        for name, cnt in res["launches"].items():
            launches[name] = launches.get(name, 0) + cnt
        flash_by_d[base.head_dim] = (flash_by_d.get(base.head_dim, 0)
                                     + res["launches"]["flash_attention"])
        torch.cuda.empty_cache()
        log(f"[{res['run']}] phase {time.perf_counter() - t0:.1f}s")
    log(f"prefill phase {time.perf_counter() - t_prefill:.1f}s")

    t_shard = time.perf_counter()
    shard_results = sharded_phase(cfg)
    for res in shard_results:
        for name, cnt in res["launches"].items():
            launches[name] = launches.get(name, 0) + cnt
    log(f"sharded serving phase {time.perf_counter() - t_shard:.1f}s; the two new phases "
        f"(K11 kernels, sharded serving) {time.perf_counter() - t_shard + k11_s:.1f}s")

    d, ff = cfg.d_model, cfg.d_ff
    singles = [(d, cfg.attn_dim), (d, cfg.kv_dim), (d, cfg.kv_dim), (cfg.attn_dim, d), (ff, d)]
    entries = []
    kernel_rows = [("tile_gemm", 4, singles), ("tile_gemm_dual", 4, [(d, ff)]),
                   ("nm_spmm", 2, singles), ("nm_spmm_dual", 2, [(d, ff)])]
    for q in ("int8", "fp8"):
        kernel_rows += [(f"tile_gemm_{q}", 4, singles), (f"tile_gemm_dual_{q}", 4, [(d, ff)]),
                        (f"nm_spmm_{q}", 2, singles), (f"nm_spmm_dual_{q}", 2, [(d, ff)]),
                        (f"tile_gemm_dual_{q}_requant", 4, [(d, ff)]),
                        (f"nm_spmm_dual_{q}_requant", 2, [(d, ff)])]
    kernel_rows += [("nm_spmm_gather_bk", 2, singles), ("nm_spmm_gather_dual_bk", 2, [(d, ff)])]
    for q in ("int8", "fp8"):
        kernel_rows += [(f"nm_spmm_gather_bk_{q}", 2, singles),
                        (f"nm_spmm_gather_dual_bk_{q}", 2, [(d, ff)]),
                        (f"nm_spmm_gather_dual_bk_{q}_requant", 2, [(d, ff)])]
    moe_ff, moe_d = moe_cfg.d_ff, moe_cfg.d_model
    # the bodies each redesigned kernel's plan picks from (its decode rows
    # run the first, its prefill rows the last; K8's gather pass is gemm.cu's)
    bodies = {"tile_gemm": (SOURCES["nm_spmm"], SOURCES["tile_gemm"]),
              "tile_gemm_fp8": (SOURCES["nm_spmm_fp8"], SOURCES["tile_gemm_fp8"]),
              "nm_spmm_gather_bk": (SOURCES["nm_spmm"], SOURCES["float"], SOURCES["tile_gemm"]),
              "tile_gemm_dual": (SOURCES["nm_spmm"], SOURCES["tile_gemm"]),
              "nm_spmm_dual": (SOURCES["nm_spmm"], SOURCES["float"]),
              "nm_spmm_masked": (SOURCES["nm_spmm"], SOURCES["float"]),
              "tile_gemm_masked": (SOURCES["nm_spmm"], SOURCES["float"]),
              "nm_spmm_masked_fp8": (SOURCES["nm_spmm_fp8"], SOURCES["fp8"]),
              "tile_gemm_masked_fp8": (SOURCES["nm_spmm_fp8"], SOURCES["fp8"]),
              "nm_spmm_gather_bk_masked_fp8": (SOURCES["nm_spmm_fp8"], SOURCES["fp8"]),
              **{name: (SOURCES["nm_spmm_fp8"], SOURCES["int8"])
                 for name in ("nm_spmm_masked_int8", "tile_gemm_masked_int8",
                              "nm_spmm_gather_bk_masked_int8",
                              "nm_spmm_int8", "nm_spmm_int8_requant", "tile_gemm_int8",
                              "tile_gemm_int8_requant", "nm_spmm_gather_bk_int8",
                              "nm_spmm_gather_bk_int8_requant", "nm_spmm_dual_int8",
                              "nm_spmm_dual_int8_requant", "nm_spmm_gather_int8",
                              "tile_gemm_dual_int8", "tile_gemm_dual_int8_requant",
                              "nm_spmm_gather_dual_bk_int8",
                              "nm_spmm_gather_dual_bk_int8_requant")},
              "nm_spmm_gather_bk_masked": (SOURCES["nm_spmm"], SOURCES["float"]),
              "nm_spmm_gather_dual_bk": (SOURCES["nm_spmm"], SOURCES["float"],
                                         SOURCES["tile_gemm"]),
              "nm_spmm_gather_bk_fp8": (SOURCES["nm_spmm_fp8"], SOURCES["fp8"],
                                        SOURCES["tile_gemm_fp8"]),
              **{name: (SOURCES["nm_spmm_fp8"], SOURCES["fp8"])
                 for name in ("nm_spmm_dual_fp8", "nm_spmm_dual_fp8_requant",
                              "tile_gemm_dual_fp8_requant", "nm_spmm_gather_fp8",
                              "nm_spmm_gather_dual_bk_fp8",
                              "nm_spmm_gather_dual_bk_fp8_requant")},
              "tile_gemm_dual_fp8": (SOURCES["nm_spmm_fp8"], SOURCES["tile_gemm_fp8"])}
    for name, n, shapes in kernel_rows:
        tot = layer_decode(rows, name, n, 8, shapes)
        entry = {
            "name": name, "route": "cuda",
            "source": SOURCES[name if name in SOURCES
                              else "fp8" if "_fp8" in name
                              else "int8" if "_int8" in name else "float"],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["kernel_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
            **({"earlier_ms": tot["earlier_ms"]} if "earlier_ms" in tot else {}),
            "measured_as": f"one layer's decode launches at B=8 ({len(shapes)} "
                           f"shape(s)){', n=2 (2:4)' if n == 2 else ''}"
                           f"{'; library on the pre-gathered X' if 'gather' in name else ''}"
                           f"{', two calls (gate, up)' if 'gather_dual' in name else ''}"}
        if name.endswith("_requant"):
            entry["off_by_one_share"] = max(r["off_by_one_share"] for r in rows
                                            if r["kernel"] == name)
        if name in ("nm_spmm", "nm_spmm_gather_bk_int8"):
            # the SSM path's sites: wz, wx (d_model -> d_inner), w_out
            md, mdi = mamba_cfg.d_model, mamba_cfg.d_inner
            tot = layer_decode(rows, name, 2, 8, [(md, mdi), (md, mdi), (mdi, md)])
            entry["mamba2_layer"] = {
                "measured_as": f"one {mamba_cfg.name} layer's decode launches at B=8 (wz, wx, "
                               f"w_out), n=2 (2:4)",
                **{k: tot[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")}}
        pre = [r for r in rows if r["kernel"] == name and "prefill" in r]
        if name in bodies:
            entry["bodies"] = bodies[name]
        if pre and name in bodies:
            # the many-row body: hubert-xlarge's prefill sites at 4000 rows (K8
            # and the duals: phi-3-vision's at 1024)
            entry["prefill"] = {
                "measured_as": "the prefill sites (K, O) at their rows "
                               "(hubert-xlarge 4000, phi-3-vision 1024)",
                "sites": [[r["prefill"], r["B"], r["K"], r["O"]] for r in pre],
                **{key: [r[key] for r in pre]
                   for key in ("kernel_ms", "earlier_ms", "library_ms", "bound_ms")}}
        entries.append(entry)
    # the K10 masked kernels: one expert w_out launch at B=8 with about 40%
    # of its K steps live (the bound counts the live tiles only)
    for layout in MASKED_NAMES:
        for q in (None, "int8", "fp8"):
            name = masked_kernel(layout, q)
            n = 4 if layout == "dense" else 2
            r = next(r for r in rows if (r["kernel"], r["B"], r["K"], r["O"], r["n"])
                     == (name, 8, moe_ff, moe_d, n) and 0 < r["live_share"] < 1)
            entries.append({
                "name": name, "route": "cuda", "source": SOURCES.get(name, SOURCES[q or "float"]),
                "replaces": REPLACES[name], "launches": launches.get(name, 0),
                "max_abs_err": max(x["max_abs_err"] for x in rows if x["kernel"] == name),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "unmasked_ms": r["unmasked_ms"],
                **({"earlier_ms": r["earlier_ms"], "bodies": bodies[name]}
                   if "earlier_ms" in r else {}),
                "measured_as": f"one expert w_out launch at B=8, (K, O) = ({moe_ff}, {moe_d})"
                               f"{', n=2 (2:4)' if n == 2 else ''}, {r['live_share']:.2f} of "
                               f"its K steps live; library on the same masked X"
                               f"{' (pre-gathered)' if layout == 'gather' else ''}"})
    # K0's remainder: one gemma3 gelu w_in launch at B=8 (n=2 for N:M)
    for layout, n in (("dense", 4), ("compressed", 2), ("gather", 2)):
        for q in ("int8", "fp8"):
            name = f"{LAYOUT_MODULES[layout][1]}_{q}_requant"
            r = next(r for r in rows if (r["kernel"], r["B"], r.get("n")) == (name, 8, n))
            entries.append({
                "name": name, "route": "cuda",
                "source": SOURCES[{"nm_spmm_fp8_requant": "nm_spmm_fp8",
                                   "tile_gemm_fp8_requant": "nm_spmm_fp8",
                                   "nm_spmm_gather_bk_fp8_requant": "nm_spmm_fp8"}.get(
                                       name, name if name in SOURCES else q)],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": max(x["max_abs_err"] for x in rows if x["kernel"] == name),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "unfused_ms": r["unfused_ms"],
                **({"earlier_ms": r["earlier_ms"]} if "earlier_ms" in r else {}),
                **({"bodies": bodies[name]} if name in bodies else {}),
                "off_by_one_share": max(x["off_by_one_share"] for x in rows
                                        if x["kernel"] == name),
                "measured_as": f"one gemma3-1b w_in launch at B=8, (K, O) = ({r['K']}, "
                               f"{r['O']}), gelu + requant{', n=2 (2:4)' if n == 2 else ''}; "
                               f"unfused_ms: the kernel storing bf16 then the static "
                               f"quantize pass; library on the {r['library']}"})
    # flash_attention at the calibration forward's shape (one layer's launch):
    # internlm2-1.8b's head_dim 128, and gemma3-1b's 256; then one layer's
    # prefill launch: hubert-xlarge's non-causal 80 and phi-3-vision's 96
    new_d = (gemma_cfg.head_dim, hubert_cfg.head_dim, phi3_cfg.head_dim)
    for name, hd, count, shape, what in (
            ("flash_attention", cfg.head_dim,
             sum(c for d_, c in flash_by_d.items() if d_ not in new_d), ATTN_SHAPES[0],
             "calibration"),
            ("flash_attention_d256", gemma_cfg.head_dim, flash_by_d.get(256, 0),
             ATTN_SHAPES[0], "calibration"),
            ("flash_attention_d80_noncausal", hubert_cfg.head_dim,
             flash_by_d.get(hubert_cfg.head_dim, 0), HUBERT_ATTN_SHAPES[0], "prefill"),
            ("flash_attention_d96", phi3_cfg.head_dim, flash_by_d.get(phi3_cfg.head_dim, 0),
             PHI3_ATTN_SHAPES[0], "prefill")):
        r = next(r for r in rows if r["kernel"] == "flash_attention" and r["D"] == hd
                 and (r["B"], r["T"]) == shape)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES["attention"],
            "replaces": REPLACES[name], "launches": count,
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == "flash_attention" and x["D"] == hd),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "earlier_ms": r["earlier_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "measured_as": f"one layer's {what} launch: B={r['B']}, T={r['T']}, "
                           f"{r['Hq']} query / {r['Hkv']} KV heads, D={r['D']}, "
                           f"{'causal' if r['causal'] else 'non-causal'}"})
    # K11 at one layer's two row-parallel sites (wo, w_out) on the (1, 2)
    # mesh, B = 32 (a decode batch of 8 padded), in the form the path runs:
    # int8 raw at 2:4, fp8 raw at 1:4 (their sharded runs); the float form
    # (not on the path: a float row site runs K8 storing fp32) at 2:4
    k11_shapes = [(cfg.attn_dim // K11_MESH, d), (ff // K11_MESH, d)]
    for name, n, form in (("nm_spmm_gather", 2, ""), ("nm_spmm_gather_int8", 2, "_raw"),
                          ("nm_spmm_gather_fp8", 1, "_raw")):
        tot = layer_decode(rows, name + form, n, 32, k11_shapes)
        extra = {}
        if form:
            tr = [r for r in rows if r["kernel"] == name + "_transposes" and r["B"] == 32]
            extra["transposes_ms"] = sum(r["in_ms"] + r["out_ms"] for r in tr)
        if "earlier_ms" in tot:
            extra["earlier_ms"] = tot["earlier_ms"]
            extra["bodies"] = bodies[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name if name in SOURCES else "fp8" if "_fp8" in name
                              else "int8" if "_int8" in name else "float"],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name + form),
            "ms": tot["kernel_ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": tot["library_ms"], **extra,
            "measured_as": f"one layer's two row-parallel launches (wo, w_out) at a (1, 2) "
                           f"mesh's local shapes {k11_shapes}, B=32, n={n} "
                           f"({'raw accumulator' if form else 'fp32 out'}); library on the "
                           f"pre-gathered row-major X"
                           + ("; transposes_ms: the codes in, the accumulator out" if form
                              else "")})
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
