// Hand-written Hopper (sm_90a) kernels for the repro_torch dense and N:M
// sparse GEMMs: tile_gemm, tile_gemm_dual, nm_spmm and nm_spmm_dual.
//
// Replaces (JAX package, Pallas on the TPU):
//   tile_gemm       repro/kernels/tile_gemm/kernel.py::tile_gemm      (_gemm_kernel)
//   tile_gemm_dual  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual (_gemm_dual_kernel)
//   nm_spmm         repro/kernels/nm_spmm/kernel.py::nm_spmm          (_spmm_accumulate,
//                   _unpack_meta_tile, _decompress_tile)
//   nm_spmm_dual    repro/kernels/nm_spmm/kernel.py::nm_spmm_dual     (_spmm_dual_kernel)
//
// ONE templated kernel body serves all four: the template takes the weight
// loader (DenseLoader, or NMLoader<n> for values + 2-bit packed meta) and
// single or dual (gate-up, two weights against one X tile).
//
// What it computes.  A block of 128 threads (4 warps) owns a BM x 64 tile
// of Y (BM = 16 for decode-sized batches, 64 for prefill chunks), keeps
// its fp32 accumulators in registers as wmma fragments, and loops over K
// in steps of 64 inside the block -- the TPU kernel's sequential K grid
// axis becomes this loop.  Each step stages the X tile (rows >= B
// zero-filled) and the weight tile in shared memory, contracts them with
// bf16 -> fp32 wmma 16x16x16 fragments (each warp owns 16 output columns),
// while the next step's tiles are already in flight into registers.  The
// flush applies the epilogue in fp32 in flush_tile's order (identity ->
// + bias -> silu | gelu(tanh); dual: silu(g) * u), casts once to bf16 and
// stores with the row mask.
//
// N:M weights.  The loader reads the values tile (64*n/4 rows) and the
// packed meta tile (64*n/16 rows, four 2-bit in-block indices per byte,
// low bits first) and expands them into the dense 64 x 64 bf16 tile in
// shared memory: w[(r/n)*4 + idx(r), o] = values[r, o].  The dense weight
// never exists in device memory.
//
// What bounds it on an H100.  At decode (B = slots = 8) every weight byte
// is read once for 16 flops per bf16 pair, far below the ~295 flop/byte
// ridge, so the weight bytes over 3.35 TB/s bound it: w_out at K=8192,
// O=2048 moves 33.6 MB dense (10.0 us) and 18.9 MB at 2:4 (values 16.8 MB
// + meta 2.1 MB, 5.6 us).  Prefill chunks (B <= 64) are still
// bandwidth-bound.  What the design does about it: the N:M loader moves
// n/4 of the dense weight bytes plus 2 bits per kept value and expands on
// chip, weight loads are 16-byte vector loads along O (coalesced rows),
// and the register prefetch of the next K step overlaps the loads with
// the tensor-core work.  Launch width is O/64 blocks, too few to keep the
// card's memory system busy at decode for O <= 2048: split-K, TMA rings,
// wgmma and sparse tensor cores (mma.sp) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flush.cuh"

using namespace nvcuda;

namespace {

constexpr int BK = 64;          // K step (dense rows of the weight tile)
constexpr int BN = 64;          // output columns per block
constexpr int NTHREADS = 128;   // 4 warps, each owning 16 output columns
constexpr int XLD = BK + 8;     // bf16 pitch of the X tile (breaks bank conflicts)
constexpr int WLD = BN + 8;     // bf16 pitch of a weight tile
constexpr int CLD = BN + 4;     // fp32 pitch of an accumulator tile at the flush

__device__ __forceinline__ uint32_t word_of(const uint4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// X tile: BM rows x BK columns, one 16-byte chunk (8 bf16) per thread per
// 16 rows; rows at or beyond B read as zero.
template <int BM>
struct XLoader {
  const __nv_bfloat16* x;
  int b, k;
  uint4 r[BM / 16];

  __device__ __forceinline__ void load(int k0, int m0, int tid) {
    const int c = k0 + (tid & 7) * 8;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int row = m0 + (tid >> 3) + 16 * i;
      r[i] = row < b ? *reinterpret_cast<const uint4*>(x + (size_t)row * k + c)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* xs, int tid) const {
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int row = (tid >> 3) + 16 * i;
      *reinterpret_cast<uint4*>(xs + row * XLD + (tid & 7) * 8) = r[i];
    }
  }
};

// Dense (K, O) weight: a 64 x 64 tile is 512 16-byte chunks, 4 per thread.
struct DenseLoader {
  const __nv_bfloat16* w;
  const uint8_t* unused_meta;
  int o;
  uint4 r[4];

  __device__ __forceinline__ void load(int k0, int n0, int tid) {
    const int c = n0 + (tid & 7) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + (tid >> 3) + 16 * i;
      r[i] = *reinterpret_cast<const uint4*>(w + (size_t)row * o + c);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* ws, int tid) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 3) + 16 * i;
      *reinterpret_cast<uint4*>(ws + row * WLD + (tid & 7) * 8) = r[i];
    }
  }
};

// Compressed N:4 weight: values (K*N/4, O) bf16 and meta (K*N/16, O) uint8.
// Thread t expands M-block g = t/8 (4 dense rows) for the 8 columns of
// chunk t%8: it holds the block's N value chunks and their meta bytes.
template <int N>
struct NMLoader {
  const __nv_bfloat16* v;
  const uint8_t* meta;
  int o;
  uint4 rv[N];
  uint2 rm[N];

  __device__ __forceinline__ void load(int k0, int n0, int tid) {
    const int c = n0 + (tid & 7) * 8;
    const int r0 = (k0 / 4 + (tid >> 3)) * N;   // first compressed row of block g
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int r = r0 + s;
      rv[s] = *reinterpret_cast<const uint4*>(v + (size_t)r * o + c);
      rm[s] = *reinterpret_cast<const uint2*>(meta + (size_t)(r >> 2) * o + c);
    }
  }
  // The on-chip M:1 mux: slot p of the block receives the kept value whose
  // 2-bit index is p, else +0.  k0 is a multiple of 64, so the global
  // compressed row's position inside its meta byte is (g*N + s) % 4.
  __device__ __forceinline__ void store(__nv_bfloat16* ws, int tid) const {
    const int g = tid >> 3;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t lo = 0u, hi = 0u;
#pragma unroll
        for (int s = 0; s < N; ++s) {
          const int sh = 2 * ((g * N + s) & 3);
          const uint32_t vw = word_of(rv[s], q);
          const uint32_t mw = q < 2 ? rm[s].x : rm[s].y;
          const uint32_t i_lo = (mw >> (8 * ((2 * q) & 3) + sh)) & 3u;
          const uint32_t i_hi = (mw >> (8 * ((2 * q + 1) & 3) + sh)) & 3u;
          if (i_lo == (uint32_t)p) lo = vw & 0xffffu;
          if (i_hi == (uint32_t)p) hi = vw >> 16;
        }
        out[q] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(ws + (g * 4 + p) * WLD + (tid & 7) * 8) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
};

template <int BM, bool DUAL, class WL>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ wg, const uint8_t* __restrict__ mg,
            const __nv_bfloat16* __restrict__ wu, const uint8_t* __restrict__ mu,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
            int b, int k, int o, int act) {
  constexpr int MF = BM / 16;
  constexpr int NW = DUAL ? 2 : 1;
  constexpr int LOAD_BYTES = (BM * XLD + NW * BK * WLD) * 2;
  constexpr int FLUSH_BYTES = NW * BM * CLD * 4;
  constexpr int SMEM = LOAD_BYTES > FLUSH_BYTES ? LOAD_BYTES : FLUSH_BYTES;
  // the staging tiles and, after the K loop, the fp32 flush tiles alias
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws_g = xs + BM * XLD;
  __nv_bfloat16* ws_u = ws_g + BK * WLD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  XLoader<BM> xl{x, b, k};
  WL lg{wg, mg, o};
  WL lu{wu, mu, o};

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_g[MF];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_u[DUAL ? MF : 1];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    wmma::fill_fragment(acc_g[i], 0.0f);
    if constexpr (DUAL) wmma::fill_fragment(acc_u[i], 0.0f);
  }

  xl.load(0, m0, tid);
  lg.load(0, n0, tid);
  if constexpr (DUAL) lu.load(0, n0, tid);
  for (int k0 = 0; k0 < k; k0 += BK) {
    xl.store(xs, tid);
    lg.store(ws_g, tid);
    if constexpr (DUAL) lu.store(ws_u, tid);
    __syncthreads();
    if (k0 + BK < k) {   // next step's tiles travel while this one computes
      xl.load(k0 + BK, m0, tid);
      lg.load(k0 + BK, n0, tid);
      if constexpr (DUAL) lu.load(k0 + BK, n0, tid);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bg, bu;
      wmma::load_matrix_sync(bg, ws_g + kk * WLD + warp * 16, WLD);
      if constexpr (DUAL) wmma::load_matrix_sync(bu, ws_u + kk * WLD + warp * 16, WLD);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + i * 16 * XLD + kk, XLD);
        wmma::mma_sync(acc_g[i], a, bg, acc_g[i]);
        if constexpr (DUAL) wmma::mma_sync(acc_u[i], a, bu, acc_u[i]);
      }
    }
    __syncthreads();
  }

  float* cs_g = reinterpret_cast<float*>(smem);
  float* cs_u = cs_g + BM * CLD;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    wmma::store_matrix_sync(cs_g + i * 16 * CLD + warp * 16, acc_g[i], CLD, wmma::mem_row_major);
    if constexpr (DUAL)
      wmma::store_matrix_sync(cs_u + i * 16 * CLD + warp * 16, acc_u[i], CLD, wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = tid; e < BM * BN; e += NTHREADS) {
    const int r = e / BN;
    const int c = e % BN;
    const int row = m0 + r;
    if (row >= b) continue;
    float v = cs_g[r * CLD + c];
    if constexpr (DUAL) {
      v = silu(v) * cs_u[r * CLD + c];
    } else {
      if (bias != nullptr) v += bias[n0 + c];
      v = apply_act(v, act);
    }
    y[(size_t)row * o + n0 + c] = __float2bfloat16_rn(v);
  }
}

template <int BM, bool DUAL, class WL>
int launch(const void* x, const void* wg, const void* mg, const void* wu, const void* mu,
           const void* bias, void* y, int b, int k, int o, int act, void* stream) {
  const dim3 grid(o / BN, (b + BM - 1) / BM);
  gemm_kernel<BM, DUAL, WL><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const uint8_t*>(mg), static_cast<const __nv_bfloat16*>(wu),
      static_cast<const uint8_t*>(mu), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), b, k, o, act);
  return static_cast<int>(cudaGetLastError());
}

template <bool DUAL, class WL>
int launch_bm(int bm, const void* x, const void* wg, const void* mg, const void* wu,
              const void* mu, const void* bias, void* y, int b, int k, int o, int act,
              void* stream) {
  if (b <= 0 || k <= 0 || o <= 0 || k % BK != 0 || o % BN != 0 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16) return launch<16, DUAL, WL>(x, wg, mg, wu, mu, bias, y, b, k, o, act, stream);
  if (bm == 64) return launch<64, DUAL, WL>(x, wg, mg, wu, mu, bias, y, b, k, o, act, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool DUAL>
int launch_nm(int n, int bm, const void* x, const void* vg, const void* mg, const void* vu,
              const void* mu, const void* bias, void* y, int b, int k, int o, int act,
              void* stream) {
  if (n == 1) return launch_bm<DUAL, NMLoader<1>>(bm, x, vg, mg, vu, mu, bias, y, b, k, o, act, stream);
  if (n == 2) return launch_bm<DUAL, NMLoader<2>>(bm, x, vg, mg, vu, mu, bias, y, b, k, o, act, stream);
  if (n == 4) return launch_bm<DUAL, NMLoader<4>>(bm, x, vg, mg, vu, mu, bias, y, b, k, o, act, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function launches on the
// given stream, allocates nothing, and returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" {

int vg_tile_gemm(const void* x, const void* w, const void* bias, void* y, int b, int k,
                 int o, int act, int bm, void* stream) {
  return launch_bm<false, DenseLoader>(bm, x, w, nullptr, nullptr, nullptr, bias, y, b, k, o,
                                       act, stream);
}

int vg_tile_gemm_dual(const void* x, const void* wg, const void* wu, void* y, int b, int k,
                      int o, int bm, void* stream) {
  return launch_bm<true, DenseLoader>(bm, x, wg, nullptr, wu, nullptr, nullptr, y, b, k, o,
                                      ACT_NONE, stream);
}

int vg_nm_spmm(const void* x, const void* values, const void* meta, const void* bias, void* y,
               int b, int k, int o, int n, int act, int bm, void* stream) {
  return launch_nm<false>(n, bm, x, values, meta, nullptr, nullptr, bias, y, b, k, o, act,
                          stream);
}

int vg_nm_spmm_dual(const void* x, const void* values_g, const void* meta_g,
                    const void* values_u, const void* meta_u, void* y, int b, int k, int o,
                    int n, int bm, void* stream) {
  return launch_nm<true>(n, bm, x, values_g, meta_g, values_u, meta_u, nullptr, y, b, k, o,
                         ACT_NONE, stream);
}

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
