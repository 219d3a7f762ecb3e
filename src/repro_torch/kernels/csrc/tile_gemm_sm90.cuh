// K1's many-row body: tile_gemm (bf16) as a warp-specialised wgmma GEMM
// with a TMA ring.  Included by gemm.cu, whose vg_tile_gemm launches it
// when tile_gemm/kernel.py's planner finds enough rows (from the
// calibration forward's 256 up: hubert-xlarge's 4,000 prefill rows,
// phi-3-vision's 1,024); the few-row plans run nm_spmm_sp.cuh's streaming
// body over the dense weight.  K8's many-row plan (nm_spmm_gather_bk from
// 256 rows) runs it too, over the compact X a gather pass (gemm.cu) writes.
//
// Replaces (JAX package, Pallas on the TPU):
//   tile_gemm  repro/kernels/tile_gemm/kernel.py::tile_gemm (_gemm_kernel)
//
// Y (B, O) = epilogue(X (B, K) @ W (K, O)), bf16 in, fp32 sums, bf16 or
// fp32 out.  A block of three warpgroups owns a persistent walk over the
// 128 x BN output tiles (BN = 128 or 256, the plan's; tile t, t +
// gridDim.x, ..; rows fastest), one block an SM:
//   - warpgroup 2 (the producer, one thread issuing) keeps a STAGES-deep
//     ring of shared-memory stages filled with TMA: the X tile (128 rows x
//     64 K, K-major) and the W tile (64 K x BN channels, channel-major, as
//     BN / 64 boxes of 64 x 64), both with the 128-byte swizzle, each stage
//     announced on its `full` mbarrier by the bytes it carries; rows of X
//     at or past B (and channels at or past O) arrive as zeros;
//   - warpgroups 0 and 1 (the consumers) each run wgmma.mma_async
//     m64n128k16 (BN / 128 of them a K step of 16) on their 64 rows of the
//     stage, X from shared memory as the K-major A, W as the MN-major B
//     (wgmma's transpose bit, allowed for 16-bit types), one wgmma group a
//     stage kept in flight; a stage goes back to the producer on its
//     `empty` mbarrier (one arrival per consumer warp) once the group that
//     read it has completed.
// setmaxnreg moves registers from the producer (40) to the consumers
// (232).  The epilogue runs in flush_tile's order (+ bias, then silu |
// gelu(tanh), fp32) from each warpgroup's fp32 tile in shared memory (EPC
// channels at a time), so every warp stores whole output rows (coalesced),
// bf16 or fp32 from the same fp32 sum, the rows < B and channels < O only;
// the producer is already filling the ring for the block's next tile.  There is no split:
// every output is one block's sum in one order, the same bits on every
// launch.
//
// What bounds it on an H100.  At 4,000 rows the products are far above the
// ridge (~295 flop / byte): the bf16 tensor-core rate, 989 TFLOP/s, bounds
// it (hubert's (1280, 1280) site: 13.1 GFLOP, 13.2 us; its bytes need
// 7-19 us only at 3.35 TB/s).  What the design does about it: wgmma reads
// both operands from shared memory at the full rate, TMA moves the tiles
// without spending a register or an instruction of the consumers, the ring
// keeps STAGES - 1 K steps in flight, and the persistent walk overlaps one
// tile's epilogue with the next one's loads.  What holds it back, from
// development runs on the card (K swept at 4,000 x 1280, 4 stages and a
// 128-channel epilogue tile): a fixed cost of ~6-7 us a launch and ~2-3 us
// a round of tiles (fill and epilogue), and ~0.39 us a 64-deep K step of a
// 128 x 128 tile against 0.28 at the tensor-core rate; a deeper ring with a
// narrower epilogue tile (5 stages, 64 channels) took 10-30% off; wave
// quantisation ((1280 / 128) x ceil(4000 / 128) = 320 tiles are 2.4 waves
// on 132 SMs) remains.  Tried there and left out, both slower at every
// timed shape: a 2-CTA cluster multicasting the W tile (2-3.5x slower) and
// a pingpong split (each consumer warpgroup owning whole tiles in turn,
// 5-50% slower).
//
// Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: the library needs no -lcuda)
// and passed as __grid_constant__ kernel parameters.

#pragma once

#include "sm90.cuh"

namespace tg {

constexpr int BM = 128;                  // output rows a tile (two consumer warpgroups)
constexpr int BK = 64;                   // K a stage: one 128-byte swizzle row of bf16
constexpr int NTHREADS = 384;            // consumers 0, 1; producer 2

template <int BN, int STAGES_, int EPC_>
struct Smem {
  static_assert(BN == 128 || BN == 256, "the tile is 128 x 128 or 128 x 256");
  static_assert(EPC_ == 32 || EPC_ == 64 || EPC_ == 128, "an epilogue chunk of 32-128 channels");
  static constexpr int STAGES = STAGES_;
  static constexpr int EPC = EPC_;
  static constexpr int X_BYTES = BM * BK * 2;          // 16 KB
  static constexpr int W_BYTES = BK * BN * 2;          // 16 | 32 KB
  static constexpr int STAGE = X_BYTES + W_BYTES;      // a multiple of 1024
  // each consumer warpgroup's epilogue tile: 64 rows x EPC fp32 (+ 4 of pad)
  static constexpr int EPLD = EPC + 4;
  static constexpr int EP_BYTES = 64 * EPLD * 4;
  // the ring (1024-aligned for the swizzle), the 2 x STAGES mbarriers, the
  // two epilogue tiles, plus 1 KB of slack to align the dynamic base
  static constexpr int BYTES = STAGES * STAGE + 2 * STAGES * 8 + 2 * EP_BYTES + 1024;
};

#define TG_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128, fp32, the warpgroup's fragment) += A (64 x 16, K-major) x
// B (16 x 128, MN-major: transposed)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : TG_R8(0), TG_R8(8), TG_R8(16), TG_R8(24), TG_R8(32), TG_R8(40), TG_R8(48), TG_R8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef TG_R8

template <int BN, int STAGES, int EPC>
__global__ void __launch_bounds__(NTHREADS, 1)
tile_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmw, const float* __restrict__ bias,
                       void* __restrict__ y, int b, int k, int o, int act, int out_f32) {
  using S = Smem<BN, STAGES, EPC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;         // the swizzle wants 1024-byte tiles
  const uint32_t full = ring + STAGES * S::STAGE;       // STAGES mbarriers, then STAGES more
  const uint32_t empty = full + STAGES * 8;

  const int mt = (b + BM - 1) / BM;
  const int tiles = mt * ((o + BN - 1) / BN);
  const int nk = k / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);                      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmw))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1u);     // a fresh barrier passes parity 1
          const uint32_t st = ring + stage * S::STAGE;
          mbar_expect_tx(full + 8 * stage, S::STAGE);
          tma_load_2d(st, &tmx, full + 8 * stage, kb * BK, m0);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load_2d(st + S::X_BYTES + h * BK * 128, &tmw, full + 8 * stage, n0 + 64 * h,
                        kb * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns rows 64 wg .. + 63 of every tile
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    int it = 0;                                          // the block's stage count
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
      float acc[BN / 128][64];
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int stage = it % STAGES;
        mbar_wait(full + 8 * stage, (it / STAGES) & 1);
        const uint32_t xa = ring + stage * S::STAGE + wg * 64 * 128;
        const uint32_t wa = ring + stage * S::STAGE + S::X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc_sw128(xa + kk * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < BN / 128; ++h)
            wgmma_m64n128k16(acc[h], da,
                             desc_sw128(wa + 2 * h * BK * 128 + kk * 16 * 128, BK * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();                                 // the previous stage's group is done
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);

      // the epilogue, per EPC channels: the warpgroup's fp32 accumulators go
      // to its shared tile (register 4i + e of (warp, lane) is row 16 warp
      // + lane / 4 (+ 8 for e >= 2), column 8i + 2 (lane % 4) + (e & 1) of
      // its 128), then each warp stores whole rows: bias, act, one cast,
      // coalesced
      float* ep = reinterpret_cast<float*>(smem_raw + (empty + STAGES * 8 - raw)) +
                  wg * (S::EP_BYTES / 4);
#pragma unroll
      for (int ch = 0; ch < BN / EPC; ++ch) {
        constexpr int Q = EPC / 4;                       // float4 chunks of a row
        named_sync(1 + wg, 128);                         // the tile is free again
#pragma unroll
        for (int i = 0; i < EPC / 8; ++i) {
          const int h = ch * EPC / 128, j = (ch * EPC % 128) / 8 + i;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(
                ep + (warp * 16 + (lane >> 2) + 8 * half) * S::EPLD + 8 * i + 2 * (lane & 3)) =
                make_float2(acc[h][4 * j + 2 * half], acc[h][4 * j + 2 * half + 1]);
        }
        named_sync(1 + wg, 128);
        for (int q = tid; q < 64 * Q; q += 128) {
          const int r = q / Q, c = (q % Q) * 4;
          const int row = m0 + wg * 64 + r, col = n0 + ch * EPC + c;
          if (row >= b || col >= o) continue;
          float4 v = *reinterpret_cast<const float4*>(ep + r * S::EPLD + c);
          if (bias != nullptr) {
            const float4 bv = *reinterpret_cast<const float4*>(bias + col);
            v.x += bv.x;
            v.y += bv.y;
            v.z += bv.z;
            v.w += bv.w;
          }
          v.x = apply_act(v.x, act);
          v.y = apply_act(v.y, act);
          v.z = apply_act(v.z, act);
          v.w = apply_act(v.w, act);
          const size_t at = static_cast<size_t>(row) * o + col;
          if (out_f32) {
            *reinterpret_cast<float4*>(static_cast<float*>(y) + at) = v;
          } else {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + at) =
                make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                           *reinterpret_cast<const uint32_t*>(&hi));
          }
        }
      }
    }
  }
}

template <int BN, int STAGES, int EPC>
int launch(const void* x, const void* w, const float* bias, void* y, int b, int k, int o,
           int act, int out_f32, cudaStream_t stream) {
  using S = Smem<BN, STAGES, EPC>;
  auto kernel = tile_gemm_wgmma_kernel<BN, STAGES, EPC>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  CUtensorMap tmx, tmw;
  if (!encode(&tmx, x, b, k, BM) || !encode(&tmw, w, k, o, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((b + BM - 1) / BM) * ((o + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();    // one block an SM, persistent
  kernel<<<grid, NTHREADS, S::BYTES, stream>>>(tmx, tmw, bias, y, b, k, o, act, out_f32);
  return static_cast<int>(cudaGetLastError());
}

// bn in {128, 256}: the tile's channels
inline int launch_bn(int bn, const void* x, const void* w, const void* bias, void* y, int b,
                     int k, int o, int act, int out_f32, void* stream) {
  if (b <= 0 || k <= 0 || o <= 0 || k % BK != 0 || o % 64 != 0 || act < 0 || act > 2 ||
      out_f32 < 0 || out_f32 > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  // the stages and epilogue chunks that timed best on an H100 at hubert-
  // xlarge's and phi-3-vision's sites (128: 5 stages, 64 channels; 256: 4, 32)
  if (bn == 128) return launch<128, 5, 64>(x, w, bf, y, b, k, o, act, out_f32, s);
  if (bn == 256) return launch<256, 4, 32>(x, w, bf, y, b, k, o, act, out_f32, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tg
