// tile_gemm_fp8's many-row body: the e4m3 form of tile_gemm_sm90.cuh, a
// persistent, warp-specialised TMA + wgmma GEMM over 128 x 128 output tiles.
// Included by gemm_fp8.cu, whose vg_tile_gemm_fp8 launches it with its flush
// when tile_gemm/kernel.py::fp8_plan finds enough rows (from 256: the
// calibration forward, hubert-xlarge's 4,000 prefill rows); the few-row
// plans run nm_spmm_sp_fp8.cuh's stream over the dense weight.  In DUAL
// form it is tile_gemm_dual_fp8's many-row body (vg_tile_gemm_dual_fp8,
// where tile_gemm/kernel.py::fp8_dual_plan picks it; see below).
//
// Replaces (JAX package, Pallas on the TPU):
//   tile_gemm_fp8  repro/kernels/tile_gemm/kernel.py::tile_gemm_fp8
//                  (_tile_gemm_quantized, _gemm_q_raw_kernel, _gemm_kernel)
//   tile_gemm_dual_fp8  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual, fp8
//                  branch (_gemm_dual_kernel), bf16 / fp32 out (never the
//                  requant form)
//
// Y (B, O) = flush(Xq (B, K) e4m3 @ Wq (K, O) e4m3), fp32 sums; the flush
// is the caller's (gemm_fp8.cu's SingleFlush: acc * xs[row] * ws[col] with
// __fmul_rn, + bias, silu | gelu, then bf16 / fp32 / e4m3 against *rq; or
// the raw accumulator).  A block of three warpgroups walks the tiles t, t +
// gridDim.x, .. (rows fastest), one block an SM:
//   - warp 8 (one thread) keeps a STAGES-deep ring filled with TMA: the X
//     tile (128 rows x 128 K bytes, K-major, 128-byte swizzle) and the raw
//     W tile as it lies in device memory (128 K rows x 128 channels, O
//     contiguous), both on the stage's `loaded` mbarrier; rows of X at or
//     past B, K past the end and channels at or past O arrive as zeros;
//   - e4m3 wgmma takes no transpose: both operands must be K-major in
//     shared memory (only 16-bit types have the transpose bit).  So warps
//     9-11 turn each landed raw W tile into a K-major, 128-byte-swizzled
//     [channel][128 K bytes] tile: a lane holds 16 K rows of 4 channels
//     (16 four-byte loads of whole raw rows, conflict-free), builds each
//     channel's 16 K bytes with __byte_perm (gather_byte) and stores them
//     as one 16-byte chunk (the channel order rotated by lane so that the
//     eight lanes of a store phase hit eight chunks), then
//     fence.proxy.async (the generic-proxy stores must be visible to
//     wgmma's async proxy) and an arrival on the stage's `full` mbarrier;
//     the weight stays as the JAX package stores it, no second copy;
//   - warpgroups 0 and 1 (the consumers), each 64 rows of the tile, wait
//     for `full`, run wgmma.mma_async m64n128k32 e4m3 x4 over the stage
//     into a partial accumulator that starts from zero, wait for it, and
//     add it into the fp32 accumulator (__fadd_rn) before giving the stage
//     back on `empty`; two partials in turn, so that one stage's products
//     run while the stage before is added.  The promotion interval is 128 K (the shared and
//     streaming bodies promote every 64): the tensor cores never carry a
//     running sum past 128 e4m3 products; at K = 8192 the remaining 64
//     partials are plain fp32 adds.  Three accumulators of 64 registers a
//     thread leave no room for the 128 x 256 tile.
// setmaxnreg moves registers from the producer warpgroup (56) to the
// consumers (224).  The epilogue goes through a shared fp32 tile per
// consumer warpgroup (EPC channels at a time), so consecutive threads flush
// consecutive channels of a row.  No split: every output is one block's sum
// in one order, the same bits on every launch.
//
// The gate-up dual (DUAL).  An output tile is 128 rows x 64 channels of
// each weight: a stage carries the X tile and both weights' raw 128 K x 64
// tiles (two tensor maps), and the transposers turn both into K-major
// swizzled 64 x 128 tiles (lanes 0-15 the gate's, 16-31 the up's; the up
// lanes read their rows in swapped pairs, so each load's 32 lanes hit 32
// banks): the single's 48 KB a stage.  Each consumer warpgroup runs wgmma
// m64n64k32 per weight into the two halves of the same 64 registers, with
// the single's promotion (two partials in turn, added every 128 K): 192
// registers a thread, as the single's; a 128-channel tile of each weight
// would need 384.  The flush forms silu(t_g) * t_u in registers in
// DualFlush's order (flush.value) on the way to the epilogue tile, then
// stores bf16 or fp32 four channels a thread.  Its e4m3 sums move
// requantized codes by more than one step, so tile_gemm_dual_fp8_requant
// never takes it.
//
// What bounds it on an H100.  At 4,000 rows the products are far above the
// ridge (~590 fp8 operations per byte): the fp8 tensor-core rate, 1979
// TFLOP/s, bounds it (hubert's (1280, 1280) site: 13.1 GFLOP, 6.6 us).  The
// transpose reads and writes each W byte once more in shared memory, and
// the two consumers read 48 KB a stage: shared-memory bandwidth, not the
// tensor cores, is the first limit of this form.

#pragma once

#include "nm_spmm_sp_fp8.cuh"
#include "sm90.cuh"

namespace tgf8 {

using tg::desc_sw128;
using tg::mbar_arrive;
using tg::mbar_expect_tx;
using tg::mbar_init;
using tg::mbar_wait;
using tg::named_sync;
using tg::smem_u32;
using tg::tma_load_2d;

constexpr int BM = 128;                   // output rows a tile (two consumer warpgroups)
constexpr int BN = 128;                   // output channels a tile (the dual: of both weights)
constexpr int BK = 128;                   // K a stage: one 128-byte swizzle row of e4m3
constexpr int NTHREADS = 384;             // consumers 0, 1; producer 2 (TMA warp 8, warps 9-11)
constexpr int STAGES = 4;
constexpr int EPC = 32;                   // epilogue channels a pass
constexpr int X_BYTES = BM * BK;          // 16 KB
constexpr int W_BYTES = BN * BK;          // the K-major W tile(s), 16 KB
constexpr int RAW_BYTES = BK * BN;        // the raw W tile(s), 16 KB
constexpr int STAGE = X_BYTES + W_BYTES + RAW_BYTES;   // a multiple of 1024
constexpr int EPLD = EPC + 4;
constexpr int EP_BYTES = 64 * EPLD * 4;
constexpr int TRANSPOSERS = 3 * 32;
// the ring (1024-aligned), 3 x STAGES mbarriers, two epilogue tiles, 1 KB of slack
constexpr int BYTES = STAGES * STAGE + 3 * STAGES * 8 + 2 * EP_BYTES + 1024;
// the dual's output tile: 128 rows x DUAL_BN channels of each weight (a
// stage: both weights' 128 K x 64 raw tiles and K-major tiles, the single's
// bytes)
constexpr int DUAL_BN = BN / 2;

#define TGF8_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128, fp32) = A (64 x 32 e4m3, K-major) x B (32 x 128 e4m3, K-major)
// (+ D when accumulate != 0)
__device__ __forceinline__ void wgmma_m64n128k32_e4m3(float (&d)[64], uint64_t da, uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : TGF8_R8(0), TGF8_R8(8), TGF8_R8(16), TGF8_R8(24), TGF8_R8(32), TGF8_R8(40),
        TGF8_R8(48), TGF8_R8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32, registers OFF .. OFF + 31 of d) = A (64 x 32 e4m3,
// K-major) x B (32 x 64 e4m3, K-major) (+ D when accumulate != 0)
template <int OFF>
__device__ __forceinline__ void wgmma_m64n64k32_e4m3(float (&d)[64], uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : TGF8_R8(OFF), TGF8_R8(OFF + 8), TGF8_R8(OFF + 16), TGF8_R8(OFF + 24)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef TGF8_R8

// One transposer lane's share of a stage: K rows 16 c .. + 15 of channels
// 4 g .. + 3 of the raw [BK][RP] tile, into rows 4 g + j of the K-major
// swizzled [RP][128] tile as one 16-byte chunk each.  odd: the lane reads
// the rows in pairs swapped (r ^ 1), so that the dual's two lane halves,
// one a weight, read rows of opposite parity (distinct banks) in each load
template <int RP>
__device__ __forceinline__ void transpose_chunk(const uint8_t* raw, uint8_t* wk, int c, int g,
                                                int odd = 0) {
  uint32_t v[16], w[16];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    v[r] = *reinterpret_cast<const uint32_t*>(raw + (16 * c + (r ^ odd)) * RP + 4 * g);
#pragma unroll
  for (int r = 0; r < 16; ++r) w[r] = odd ? v[r ^ 1] : v[r];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    // channel order rotated by lane pair: a store phase's eight lanes write
    // rows whose swizzled chunk positions all differ
    const int j = (jj + (g >> 1)) & 3;
    const int row = 4 * g + j;
    uint4 out;
    out.x = spf8::gather_byte(w[0], w[1], w[2], w[3], j);
    out.y = spf8::gather_byte(w[4], w[5], w[6], w[7], j);
    out.z = spf8::gather_byte(w[8], w[9], w[10], w[11], j);
    out.w = spf8::gather_byte(w[12], w[13], w[14], w[15], j);
    *reinterpret_cast<uint4*>(wk + row * 128 + ((c ^ (row & 7)) << 4)) = out;
  }
}

// DUAL: tmw maps the gate weight and tmu the up weight (the single passes
// tmw twice), each output tile 128 rows x DUAL_BN channels of both, flushed
// by flush.value (silu(t_g) * t_u in registers) and flush.store4
template <bool DUAL, class Flush>
__global__ void __launch_bounds__(NTHREADS, 1)
tile_gemm_fp8_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                           const __grid_constant__ CUtensorMap tmw,
                           const __grid_constant__ CUtensorMap tmu, Flush flush, int b, int k,
                           int o) {
  constexpr int TN = DUAL ? DUAL_BN : BN;              // channels of each weight a tile
  constexpr int WT = TN * BK;                          // one weight's K-major (and raw) tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;         // the swizzle wants 1024-byte tiles
  const uint32_t loaded = ring + STAGES * STAGE;        // X and raw W landed (TMA bytes)
  const uint32_t full = loaded + STAGES * 8;            // K-major W written
  const uint32_t empty = full + STAGES * 8;             // both consumers done
  unsigned char* base = smem_raw + (ring - raw);        // generic pointer to the ring

  const int mt = (b + BM - 1) / BM;
  const int tiles = mt * ((o + TN - 1) / TN);
  const int nk = (k + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(loaded + 8 * s, 1);
      mbar_init(full + 8 * s, TRANSPOSERS);             // one arrival per transposing thread
      mbar_init(empty + 8 * s, 8);                      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    tg::setmaxnreg_dec<56>();
    const int pw = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    if (pw == 0) {
      // the TMA warp
      if (lane == 0) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmx))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmw))
                     : "memory");
        if constexpr (DUAL)
          asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmu))
                       : "memory");
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile % mt) * BM, n0 = (tile / mt) * TN;
          for (int kb = 0; kb < nk; ++kb) {
            mbar_wait(empty + 8 * stage, phase ^ 1u);   // a fresh barrier passes parity 1
            const uint32_t st = ring + stage * STAGE;
            mbar_expect_tx(loaded + 8 * stage, X_BYTES + RAW_BYTES);
            tma_load_2d(st, &tmx, loaded + 8 * stage, kb * BK, m0);
            // the raw tiles: the gate's, then (a dual) the up's
            tma_load_2d(st + X_BYTES + W_BYTES, &tmw, loaded + 8 * stage, n0, kb * BK);
            if constexpr (DUAL)
              tma_load_2d(st + X_BYTES + W_BYTES + WT, &tmu, loaded + 8 * stage, n0, kb * BK);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
      }
    } else {
      // the transposers: chunk c (16 K rows) of every stage goes to warp c % 3
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int stage = it % STAGES;
          mbar_wait(loaded + 8 * stage, (it / STAGES) & 1);
          unsigned char* st = base + stage * STAGE;
          for (int c = pw - 1; c < BK / 16; c += 3) {
            if constexpr (DUAL) {
              // lanes 0-15 the gate's 64 channels, 16-31 the up's
              const int w = lane >> 4;
              transpose_chunk<TN>(st + X_BYTES + W_BYTES + w * WT, st + X_BYTES + w * WT, c,
                                  lane & 15, w);
            } else {
              transpose_chunk<BN>(st + X_BYTES + W_BYTES, st + X_BYTES, c, lane);
            }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full + 8 * stage);
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns rows 64 wg .. + 63 of every tile
    tg::setmaxnreg_inc<224>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    int it = 0;                                          // the block's stage count
    // stage it's four k32 products into the partial p (from zero), one
    // group; returns the stage
    auto issue = [&](float (&p)[64]) {
      const int stage = it % STAGES;
      mbar_wait(loaded + 8 * stage, (it / STAGES) & 1);
      mbar_wait(full + 8 * stage, (it / STAGES) & 1);
      const uint32_t xa = ring + stage * STAGE + wg * 64 * 128;
      const uint32_t wa = ring + stage * STAGE + X_BYTES;
      tg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        if constexpr (DUAL) {   // registers 0-31 the gate's, 32-63 the up's
          wgmma_m64n64k32_e4m3<0>(p, desc_sw128(xa + kk * 32, 16, 1024),
                                  desc_sw128(wa + kk * 32, 16, 1024), kk);
          wgmma_m64n64k32_e4m3<32>(p, desc_sw128(xa + kk * 32, 16, 1024),
                                   desc_sw128(wa + WT + kk * 32, 16, 1024), kk);
        } else {
          wgmma_m64n128k32_e4m3(p, desc_sw128(xa + kk * 32, 16, 1024),
                                desc_sw128(wa + kk * 32, 16, 1024), kk);
        }
      }
      tg::wgmma_commit();
      ++it;
      return stage;
    };
    // a completed stage back to the producer, its partial into acc (fp32)
    auto promote = [&](float (&acc)[64], const float (&p)[64], int stage) {
      if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mt) * BM, n0 = (tile / mt) * TN;
      // two partials in turn: stage s + 1's products run while stage s's
      // partial is added, in stage order
      float acc[64], p0[64], p1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = p0[i] = p1[i] = 0.f;
      int prev = issue(p0);
      bool odd = true;                                   // the last group in flight is p0's
      for (int kb = 1; kb < nk; ++kb) {
        if (odd) {
          const int s1 = issue(p1);
          tg::wgmma_wait<1>();                           // p0's group is done
          promote(acc, p0, prev);
          prev = s1;
        } else {
          const int s0 = issue(p0);
          tg::wgmma_wait<1>();                           // p1's group is done
          promote(acc, p1, prev);
          prev = s0;
        }
        odd = !odd;
      }
      tg::wgmma_wait<0>();
      if (odd) promote(acc, p0, prev);
      else promote(acc, p1, prev);

      // the epilogue, per EPC channels: the warpgroup's fp32 accumulators go
      // to its shared tile (register 4i + e of (warp, lane) is row 16 warp +
      // lane / 4 (+ 8 for e >= 2), column 8i + 2 (lane % 4) + (e & 1); a
      // dual's gate and up registers 4i + e and 32 + 4i + e share that place
      // and go as silu(t_g) * t_u, flush.value's order), then consecutive
      // threads flush consecutive channels of a row
      float* ep = reinterpret_cast<float*>(smem_raw + (empty + STAGES * 8 - raw)) +
                  wg * (EP_BYTES / 4);
#pragma unroll
      for (int ch = 0; ch < TN / EPC; ++ch) {
        named_sync(1 + wg, 128);                         // the tile is free again
#pragma unroll
        for (int i = 0; i < EPC / 8; ++i) {
          const int j = ch * EPC / 8 + i;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + (lane >> 2) + 8 * half, c = 8 * i + 2 * (lane & 3);
            float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
            if constexpr (DUAL) {
              const int row = m0 + wg * 64 + r, col = n0 + ch * EPC + c;
              v0 = row < b ? flush.value(row, col, v0, acc[32 + 4 * j + 2 * half]) : 0.f;
              v1 = row < b ? flush.value(row, col + 1, v1, acc[32 + 4 * j + 2 * half + 1]) : 0.f;
            }
            *reinterpret_cast<float2*>(ep + r * EPLD + c) = make_float2(v0, v1);
          }
        }
        named_sync(1 + wg, 128);
        for (int q = tid; q < 16 * EPC; q += 128) {     // four channels a thread
          const int r = q / (EPC / 4), c = (q % (EPC / 4)) * 4;
          const int row = m0 + wg * 64 + r, col = n0 + ch * EPC + c;
          if (row >= b || col >= o) continue;
          const float4 v = *reinterpret_cast<const float4*>(ep + r * EPLD + c);
          if constexpr (DUAL) flush.store4(row, col, v);
          else flush.flush4(row, col, v);
        }
      }
    }
  }
}

template <bool DUAL, class Flush>
int launch_body(const void* x, const void* w, const void* wu, const Flush& flush, int b, int k,
                int o, void* stream) {
  if (b <= 0 || k <= 0 || o <= 0 || k % 64 != 0 || o % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int TN = DUAL ? DUAL_BN : BN;
  auto kernel = tile_gemm_fp8_wgmma_kernel<DUAL, Flush>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  CUtensorMap tmx, tmw, tmu;
  if (!tg::encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, b, k, BM, BK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tg::encode_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, k, o, BK, TN,
                     CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tg::encode_2d(&tmu, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, DUAL ? wu : w, k, o, BK, TN,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((b + BM - 1) / BM) * ((o + TN - 1) / TN);
  const int grid = tiles < tg::sm_count() ? tiles : tg::sm_count();   // persistent
  kernel<<<grid, NTHREADS, BYTES, static_cast<cudaStream_t>(stream)>>>(tmx, tmw, tmu, flush, b,
                                                                       k, o);
  return static_cast<int>(cudaGetLastError());
}

// X (b, k) and W (k, o) e4m3, k and o multiples of 64; flush.flush4(row,
// col, acc) stores four outputs from their fp32 sums
template <class Flush>
int launch(const void* x, const void* w, const Flush& flush, int b, int k, int o,
           void* stream) {
  return launch_body<false>(x, w, nullptr, flush, b, k, o, stream);
}

// The gate-up dual: silu(X @ Wg) * (X @ Wu), both (k, o) e4m3; flush.value
// (row, col, acc_g, acc_u) forms one output, flush.store4 stores four
template <class Flush>
int launch_dual(const void* x, const void* wg, const void* wu, const Flush& flush, int b, int k,
                int o, void* stream) {
  return launch_body<true>(x, wg, wu, flush, b, k, o, stream);
}

}  // namespace tgf8
