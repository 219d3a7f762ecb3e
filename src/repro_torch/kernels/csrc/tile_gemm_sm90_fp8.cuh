// tile_gemm_fp8's many-row body: the e4m3 form of tile_gemm_sm90.cuh, a
// persistent, warp-specialised TMA + wgmma GEMM over 128 x 128 output tiles.
// Included by gemm_fp8.cu, whose vg_tile_gemm_fp8 launches it with its flush
// when tile_gemm/kernel.py::fp8_plan finds enough rows (from 256: the
// calibration forward, hubert-xlarge's 4,000 prefill rows); the few-row
// plans run nm_spmm_sp_fp8.cuh's stream over the dense weight.
//
// Replaces (JAX package, Pallas on the TPU):
//   tile_gemm_fp8  repro/kernels/tile_gemm/kernel.py::tile_gemm_fp8
//                  (_tile_gemm_quantized, _gemm_q_raw_kernel, _gemm_kernel)
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
constexpr int BN = 128;                   // output channels a tile
constexpr int BK = 128;                   // K a stage: one 128-byte swizzle row of e4m3
constexpr int NTHREADS = 384;             // consumers 0, 1; producer 2 (TMA warp 8, warps 9-11)
constexpr int STAGES = 4;
constexpr int EPC = 32;                   // epilogue channels a pass
constexpr int X_BYTES = BM * BK;          // 16 KB
constexpr int W_BYTES = BN * BK;          // the K-major W tile, 16 KB
constexpr int RAW_BYTES = BK * BN;        // the raw W tile, 16 KB
constexpr int STAGE = X_BYTES + W_BYTES + RAW_BYTES;   // a multiple of 1024
constexpr int EPLD = EPC + 4;
constexpr int EP_BYTES = 64 * EPLD * 4;
constexpr int TRANSPOSERS = 3 * 32;
// the ring (1024-aligned), 3 x STAGES mbarriers, two epilogue tiles, 1 KB of slack
constexpr int BYTES = STAGES * STAGE + 3 * STAGES * 8 + 2 * EP_BYTES + 1024;

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
#undef TGF8_R8

// One transposer lane's share of a stage: K rows 16 c .. + 15 of channels
// 4 g .. + 3 of the raw [BK][BN] tile, into rows 4 g + j of the K-major
// swizzled [BN][128] tile as one 16-byte chunk each
__device__ __forceinline__ void transpose_chunk(const uint8_t* raw, uint8_t* wk, int c, int g) {
  uint32_t w[16];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    w[r] = *reinterpret_cast<const uint32_t*>(raw + (16 * c + r) * BN + 4 * g);
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

template <class Flush>
__global__ void __launch_bounds__(NTHREADS, 1)
tile_gemm_fp8_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                           const __grid_constant__ CUtensorMap tmw, Flush flush, int b, int k,
                           int o) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;         // the swizzle wants 1024-byte tiles
  const uint32_t loaded = ring + STAGES * STAGE;        // X and raw W landed (TMA bytes)
  const uint32_t full = loaded + STAGES * 8;            // K-major W written
  const uint32_t empty = full + STAGES * 8;             // both consumers done
  unsigned char* base = smem_raw + (ring - raw);        // generic pointer to the ring

  const int mt = (b + BM - 1) / BM;
  const int tiles = mt * ((o + BN - 1) / BN);
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
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
          for (int kb = 0; kb < nk; ++kb) {
            mbar_wait(empty + 8 * stage, phase ^ 1u);   // a fresh barrier passes parity 1
            const uint32_t st = ring + stage * STAGE;
            mbar_expect_tx(loaded + 8 * stage, X_BYTES + RAW_BYTES);
            tma_load_2d(st, &tmx, loaded + 8 * stage, kb * BK, m0);
            tma_load_2d(st + X_BYTES + W_BYTES, &tmw, loaded + 8 * stage, n0, kb * BK);
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
          for (int c = pw - 1; c < BK / 16; c += 3)
            transpose_chunk(st + X_BYTES + W_BYTES, st + X_BYTES, c, lane);
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
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_m64n128k32_e4m3(p, desc_sw128(xa + kk * 32, 16, 1024),
                              desc_sw128(wa + kk * 32, 16, 1024), kk);
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
      const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
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
      // lane / 4 (+ 8 for e >= 2), column 8i + 2 (lane % 4) + (e & 1)), then
      // consecutive threads flush consecutive channels of a row
      float* ep = reinterpret_cast<float*>(smem_raw + (empty + STAGES * 8 - raw)) +
                  wg * (EP_BYTES / 4);
#pragma unroll
      for (int ch = 0; ch < BN / EPC; ++ch) {
        named_sync(1 + wg, 128);                         // the tile is free again
#pragma unroll
        for (int i = 0; i < EPC / 8; ++i) {
          const int j = ch * EPC / 8 + i;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(
                ep + (warp * 16 + (lane >> 2) + 8 * half) * EPLD + 8 * i + 2 * (lane & 3)) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
        named_sync(1 + wg, 128);
        for (int q = tid; q < 16 * EPC; q += 128) {     // four channels a thread
          const int r = q / (EPC / 4), c = (q % (EPC / 4)) * 4;
          const int row = m0 + wg * 64 + r, col = n0 + ch * EPC + c;
          if (row < b && col < o)
            flush.flush4(row, col, *reinterpret_cast<const float4*>(ep + r * EPLD + c));
        }
      }
    }
  }
}

// X (b, k) and W (k, o) e4m3, k and o multiples of 64; flush(row, col, acc)
// stores one output from its fp32 sum
template <class Flush>
int launch(const void* x, const void* w, const Flush& flush, int b, int k, int o,
           void* stream) {
  if (b <= 0 || k <= 0 || o <= 0 || k % 64 != 0 || o % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tile_gemm_fp8_wgmma_kernel<Flush>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  CUtensorMap tmx, tmw;
  if (!tg::encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, b, k, BM, BK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tg::encode_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, k, o, BK, BN,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((b + BM - 1) / BM) * ((o + BN - 1) / BN);
  const int grid = tiles < tg::sm_count() ? tiles : tg::sm_count();   // persistent
  kernel<<<grid, NTHREADS, BYTES, static_cast<cudaStream_t>(stream)>>>(tmx, tmw, flush, b, k, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tgf8
