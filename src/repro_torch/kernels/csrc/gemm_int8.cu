// Hand-written Hopper (sm_90a) int8 kernels for the repro_torch quantized
// execution class (w8a8): tile_gemm_int8, tile_gemm_dual_int8,
// nm_spmm_int8, nm_spmm_dual_int8, the lane-aligned gather pair
// nm_spmm_gather_bk_int8 and nm_spmm_gather_dual_bk_int8, and the
// activation-sparsity (K10) variants of the three singles,
// tile_gemm_masked_int8, nm_spmm_masked_int8, nm_spmm_gather_bk_masked_int8;
// every one of them with the requantizing flush (out_kind 3); and the
// K-major gather nm_spmm_gather_int8 (K11), scaled or raw.
//
// Replaces (JAX package, Pallas on the TPU):
//   tile_gemm_int8       repro/kernels/tile_gemm/kernel.py::tile_gemm_int8
//                        (_tile_gemm_quantized, _gemm_q_raw_kernel, _gemm_kernel)
//   tile_gemm_dual_int8  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual,
//                        quantized branch (_gemm_dual_kernel with quant=True)
//   nm_spmm_int8         repro/kernels/nm_spmm/kernel.py::nm_spmm_int8
//                        (_nm_spmm_quantized, _spmm_q_raw_kernel, _spmm_kernel)
//   nm_spmm_dual_int8    repro/kernels/nm_spmm/kernel.py::nm_spmm_dual,
//                        quantized branch (_spmm_dual_kernel with quant=True)
//   nm_spmm_gather_bk_int8       repro/kernels/nm_spmm_gather/kernel.py::
//                                nm_spmm_gather_bk, quantized (_gather_bk_kernel)
//   nm_spmm_gather_dual_bk_int8  repro/kernels/nm_spmm_gather/kernel.py::
//                                nm_spmm_gather_dual_bk, quantized (_gather_dual_kernel)
//   tile_gemm_masked_int8, nm_spmm_masked_int8, nm_spmm_gather_bk_masked_int8
//        repro/kernels/{tile_gemm,nm_spmm,nm_spmm_gather}/kernel.py::
//        tile_gemm_masked, nm_spmm_masked, nm_spmm_gather_bk_masked, scaled-
//        quantized with acc_dtype=int32 (the *_masked_kernel bodies)
//   nm_spmm_gather_int8  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_int8
//                        (_nm_spmm_gather_quantized, _gather_q_kernel,
//                        _gather_q_raw_kernel)
//
// nm_spmm_int8 (and _requant) at n in {1, 2} runs the s8 form of
// nm_spmm_sp_fp8.cuh's sparse stream (mma.sp m16n8k64 s8 -> s32, the K loop
// split over a cluster, int32 partials summed in rank order) wherever
// nm_spmm/kernel.py::int8_plan picks it; tile_gemm_int8 (and _requant) the
// s8 form of its dense stream (two mma.sync m16n8k32 s8 -> s32 a step)
// wherever tile_gemm/kernel.py::int8_plan picks it; and K8 int8
// (nm_spmm_gather_bk_int8 and _requant) at n in {1, 2} that dense stream
// with the gathered X (the step's span, select16) wherever
// nm_spmm_gather/kernel.py::int8_plan picks it; K11 int8
// (nm_spmm_gather_int8) at n in {1, 2} that dense stream with the K-major X
// stage (the step's selected x_t rows, a byte transpose pass, the (O, B)
// store) wherever nm_spmm_gather/kernel.py::kmajor_int8_plan picks it; and
// the compressed gate-up dual nm_spmm_dual_int8 (and _requant) at n in {1,
// 2} the DUAL form of the sparse stream (both weights a stage, two int32
// accumulator sets) wherever nm_spmm/kernel.py::int8_dual_plan picks it; the
// dense gate-up dual tile_gemm_dual_int8 (and _requant) the DUAL form of the
// dense stream wherever tile_gemm/kernel.py::int8_dual_plan picks it; and K9
// int8 (nm_spmm_gather_dual_bk_int8 and _requant) at n in {1, 2} that DUAL
// form with the gathered X (one span a step, selected twice) wherever
// nm_spmm_gather/kernel.py::int8_dual_plan picks it; and the masked
// singles nm_spmm_masked_int8 (at n in {1, 2}) and tile_gemm_masked_int8 the
// MASKED forms of the sparse and the dense stream (each block walks the
// live steps of its split's span) wherever nm_spmm/kernel.py::int8_plan and
// tile_gemm/kernel.py::masked_int8_plan pick them; and the masked gather
// nm_spmm_gather_bk_masked_int8 at n in {1, 2} the MASKED form of K8 int8's
// gathered stream wherever nm_spmm_gather/kernel.py::masked_int8_plan picks
// it.  Each is flushed by SingleFlushI8 / DualFlushI8T below in this file's
// order (ws first for the gathers): the same bits as this body, int32 sums
// being exact in any order.  Their entries at body 0, split 1 reach this
// file's body, the form the port ran first, as its yardstick.
//
// ONE templated body serves all ten, as in gemm.cu: the template takes the
// weight loader (dense int8, or N:4 int8 values + 2-bit packed meta), the
// X loader (contiguous, gathered through the lane-aligned index, or that
// gather from K-major X, see gemm.cu), single or dual (gate-up, two
// weights against one X read), and
// MASKED: the activation-sparsity block skip of gemm.cu (kmask.cuh), on
// the int8 codes of the masked rows (zeros quantize to code 0); dead tiles
// add exact zeros to the int32 accumulator, so the output is bitwise the
// unmasked kernel's.
//
// What it computes.  A block of 128 threads (4 warps) owns a BM x 64 tile of
// Y (BM = 16 for decode-sized batches, 64 for prefill chunks) and loops over
// K in steps of 64 inside the block, with the next step's tiles in flight
// into registers while the tensor cores contract the current one: wmma
// int8 x int8 -> int32 16x16x16 fragments, so the accumulator is exact.
// The flush runs in the JAX kernels' order: t = float(acc) * xs[row] *
// ws[col] (left to right, fp32; the gather kernels multiply ws before xs,
// as nm_spmm_gather/kernel.py:315-317 does), then + bias -> silu | gelu,
// or for a dual silu(t_g) * t_u, then one cast (bf16 or fp32) and a store
// masked to the rows < B.  With no scales (raw mode) it stores the int32 accumulator
// itself.  The multiplies and the bias add use the _rn intrinsics so that
// nvcc cannot contract them into an FMA: the scaled output of the identity
// and bias points is then bitwise the plain version's.
//
// Requantize (K0's requant:int8 lattice point, epilogue.py flush_tile /
// requant_rows), in every kernel: the duals (silu*mul), the singles (the gelu
// MLP's w_in: + bias -> act) and the masked singles.  When the next linear
// quantizes against a calibrated static scale, the flush emits its rows
// already in int8 against that scale: q = clip(y / rq, +-127) rounded half
// to even (__fdiv_rn, __float2int_rn), so the codes are the plain version's
// on the same fp32 y, and the consumer's quantize pass disappears.  One
// 1-byte store per element at the (row, col) offset of the (B, O) output.
// rq is read from device memory (no host sync per site).
//
// Gathered activations.  The activations are quantized per row over their
// full K_eff row before the launch (dispatch.py's _quantize_acts); the
// kernel selects the int8 codes of the kept columns from 16-byte chunks
// of the step's X span.  K11 (K-major x_t (K_eff, B) -> (O, B)) reads 16
// batch codes of one kept x_t row per load and transposes them byte by
// byte into the X tile; its raw int32 accumulator is what the sharded
// row-parallel path all-reduces before the one dequantize.
//
// Shared-memory layout.  wmma loads need 32-byte aligned tile pointers, and
// a 16-wide int8 K or N slice is only 16 bytes, so the X tile is stored as
// four K-slices [4][BM][32 B] and each weight tile as four N-slices (one per
// warp) [4][64][32 B]: every fragment pointer is a multiple of 32 bytes and
// every pitch (32 B) a multiple of 16, as wmma asks for 8-bit types.
//
// N:M weights.  The loader reads the values tile (64*n/4 rows of int8) and
// the packed meta tile (64*n/16 rows, four 2-bit in-block indices per byte,
// low bits first) and expands them into the dense 64 x 64 int8 tile in
// shared memory: w[(r/n)*4 + idx(r), o] = values[r, o].  The dense weight
// never exists in device memory.
//
// What bounds it on an H100.  At decode (B = 8) every weight byte is read
// once for 2 int8 operations per row of X, far below the ridge (~590 int8
// operations per byte), so the weight bytes over 3.35 TB/s bound it: w_out
// (K=8192, O=2048) moves 16.8 MB of int8 (5.0 us) and 10.5 MB at 2:4
// (values 8.4 MB + meta 2.1 MB).  What the design does about it: int8
// halves the bf16 weight bytes, the N:M loader moves n/4 of them plus 2
// bits per kept value and expands on chip, and loads are 16-byte (dense)
// or 8-byte (N:M) vector loads along O.  As in gemm.cu this body's launch is
// O/64 blocks with a serial K loop; the s8 streams (above) split K over a
// cluster, and the other kernels' split-K and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flush.cuh"
#include "kmask.cuh"
#include "nm_spmm_sp_fp8.cuh"

using namespace nvcuda;

namespace {

constexpr int BK = 64;          // K step (int8 columns of X, dense rows of W)
constexpr int BN = 64;          // output columns per block
constexpr int NTHREADS = 128;   // 4 warps, each owning 16 output columns
constexpr int SP = 32;          // byte pitch of a 16-wide int8 slice row
constexpr int CLD = BN + 4;     // int32 pitch of an accumulator tile at the flush

// out_kind of the C interface
enum { OUT_BF16 = 0, OUT_F32 = 1, OUT_I32 = 2, OUT_I8 = 3 };

// X tile: BM rows x 64 int8 = four 16-byte chunks per row.  Thread t loads
// chunk t%4 of row t/4 (+32 i); rows at or beyond B read as zero.  Chunk c
// lands in K-slice c.  ke is X's row stride.
template <int BM>
struct XLoader {
  static constexpr bool kGather = false;
  static constexpr bool kKMajor = false;
  static constexpr int NI = (BM * 4 + NTHREADS - 1) / NTHREADS;
  const int8_t* x;
  const int* unused_idx[2];
  int b, ke;
  uint4 r[NI];

  __device__ __forceinline__ void load(int k0, int m0, int tid) {
    const int c = k0 + (tid & 3) * 16;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int rl = (tid >> 2) + 32 * i;
      const int row = m0 + rl;
      r[i] = (rl < BM && row < b) ? *reinterpret_cast<const uint4*>(x + (size_t)row * ke + c)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(int8_t* xs, int tid) const {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int rl = (tid >> 2) + 32 * i;
      if (rl < BM) *reinterpret_cast<uint4*>(xs + ((tid & 3) * BM + rl) * SP) = r[i];
    }
  }
};

// The 4N indices of a chunk's four M-blocks, as 16-byte vector loads.
template <int C>
__device__ __forceinline__ void load_indices(int (&d)[C], const int* p) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(p)[q];
    d[4 * q] = v.x;
    d[4 * q + 1] = v.y;
    d[4 * q + 2] = v.z;
    d[4 * q + 3] = v.w;
  }
}

// Candidate i of an M-block of four bytes held in one word; an index
// outside [0, 4) selects 0, as the TPU kernel's compare-and-select does.
__device__ __forceinline__ uint32_t pick8(uint32_t w, int i) {
  return static_cast<unsigned>(i) < 4u ? (w >> (8 * i)) & 0xffu : 0u;
}

// Gathered X tile (nm_spmm_gather, M = 4; see gemm.cu): column j of the
// tile at K step k0 is compressed row c = k0 + j, which reads X column
// (c / N) * 4 + idx[c].  Each thread loads whole 16-byte chunks of the
// step's 64 * 4 / N-byte X span (four M-blocks) with one vector load, and
// the 4N indices of those blocks (of both streams for a dual, TWO), and
// selects the kept bytes only at the store (4N of them, N words), so
// nothing in load() waits on a load.
template <int BM, int N, bool TWO>
struct GatherXLoader {
  static constexpr bool kGather = true;
  static constexpr bool kKMajor = false;
  static constexpr int CPR = 16 / N;                                 // chunks per row per step
  static constexpr int NI = (BM * CPR + NTHREADS - 1) / NTHREADS;    // chunks per thread
  const int8_t* x;
  const int* idx[2];   // gate (and, for a dual, up): one index stream each
  int b, ke;
  uint4 r[NI];
  int iv[TWO ? 2 : 1][4 * N];

  __device__ __forceinline__ void load(int k0, int m0, int tid) {
    const int ch = tid % CPR;   // NTHREADS % CPR == 0: one chunk column per thread
    load_indices(iv[0], idx[0] + k0 + 4 * N * ch);
    if constexpr (TWO) load_indices(iv[1], idx[1] + k0 + 4 * N * ch);
    const int c = (k0 / N) * 4 + 16 * ch;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int rl = (tid + NTHREADS * i) / CPR;
      const int row = m0 + rl;
      r[i] = (rl < BM && row < b) ? *reinterpret_cast<const uint4*>(x + (size_t)row * ke + c)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the kept bytes of index STREAM (0: gate, 1: up) into the X tile xs
  template <int STREAM = 0>
  __device__ __forceinline__ void store(int8_t* xs, int tid) const {
    const int ch = tid % CPR;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int rl = (tid + NTHREADS * i) / CPR;
      if (rl >= BM) continue;
      const uint32_t w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
      uint32_t out[N];
#pragma unroll
      for (int q = 0; q < N; ++q) out[q] = 0u;
#pragma unroll
      for (int blk = 0; blk < 4; ++blk)
#pragma unroll
        for (int s = 0; s < N; ++s) {
          const int p = blk * N + s;
          out[p / 4] |= pick8(w[blk], iv[STREAM][p]) << (8 * (p % 4));
        }
      uint32_t* dst = reinterpret_cast<uint32_t*>(xs + (((4 * N * ch) >> 4) * BM + rl) * SP + ((4 * N * ch) & 15));
#pragma unroll
      for (int q = 0; q < N; ++q) dst[q] = out[q];
    }
  }
};

// K-major gathered X tile (K11; see gemm.cu): x_t (K_eff, B), b its row
// stride.  Load q of the step's BK x BM/16 16-byte loads reads compressed
// row c = k0 + q % BK, batch columns m0 + (q / BK) * 16 .. + 15, from x_t
// row (c / N) * 4 + idx[c] (an index outside [0, 4) selects zeros); the
// store writes the 16 codes down column q % BK of the K-sliced tile.  B is
// a multiple of 16, so a load lies wholly inside or outside the batch.
template <int BM, int N>
struct KMajorGatherXLoader {
  static constexpr bool kGather = true;
  static constexpr bool kKMajor = true;
  static constexpr int NL = BK * (BM / 16);                  // loads per step
  static constexpr int NI = (NL + NTHREADS - 1) / NTHREADS;  // loads per thread
  const int8_t* x;
  const int* idx[2];
  int b, ke;
  uint4 r[NI];

  __device__ __forceinline__ void load(int k0, int m0, int tid) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int q = tid + NTHREADS * i;
      const int c = k0 + q % BK;
      const int col = m0 + (q / BK) * 16;
      const int sel = q < NL ? idx[0][c] : -1;
      r[i] = (col < b && static_cast<unsigned>(sel) < 4u)
                 ? *reinterpret_cast<const uint4*>(x + (size_t)((c / N) * 4 + sel) * b + col)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int STREAM = 0>
  __device__ __forceinline__ void store(int8_t* xs, int tid) const {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int q = tid + NTHREADS * i;
      if (q >= NL) continue;
      const int j = q % BK, r0 = (q / BK) * 16;
      const int8_t* v = reinterpret_cast<const int8_t*>(&r[i]);
      int8_t* dst = xs + (j >> 4) * BM * SP + (j & 15);
#pragma unroll
      for (int e = 0; e < 16; ++e) dst[(r0 + e) * SP] = v[e];
    }
  }
};

// The X-loader template argument of the kernel (as in gemm.cu).
struct Contiguous {
  template <int BM, bool DUAL> using Loader = XLoader<BM>;
};
template <int N>
struct Gathered {
  template <int BM, bool DUAL> using Loader = GatherXLoader<BM, N, DUAL>;
};
template <int N>
struct GatheredKMajor {
  template <int BM, bool DUAL> using Loader = KMajorGatherXLoader<BM, N>;
};

// Dense (K, O) int8 weight: a 64 x 64 tile is 256 16-byte chunks, 2 per
// thread; chunk t%4 of a row lands in N-slice t%4.
struct DenseLoader {
  const int8_t* w;
  const uint8_t* unused_meta;
  int o;
  uint4 r[2];

  __device__ __forceinline__ void load(int k0, int n0, int tid) {
    const int c = n0 + (tid & 3) * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + (tid >> 2) + 32 * i;
      r[i] = *reinterpret_cast<const uint4*>(w + (size_t)row * o + c);
    }
  }
  __device__ __forceinline__ void store(int8_t* ws, int tid) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 32 * i;
      *reinterpret_cast<uint4*>(ws + ((tid & 3) * BK + row) * SP) = r[i];
    }
  }
};

// Compressed N:4 int8 weight: values (K*N/4, O) int8, meta (K*N/16, O) uint8.
// Thread t expands M-block g = t/8 (4 dense rows) for the 8 columns
// 8*(t%8)..+7: it holds the block's N value words (8 bytes each) and their
// meta bytes (8 bytes each).
template <int N>
struct NMLoader {
  const int8_t* v;
  const uint8_t* meta;
  int o;
  uint2 rv[N];
  uint2 rm[N];

  __device__ __forceinline__ void load(int k0, int n0, int tid) {
    const int c = n0 + (tid & 7) * 8;
    const int r0 = (k0 / 4 + (tid >> 3)) * N;   // first compressed row of block g
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int r = r0 + s;
      rv[s] = *reinterpret_cast<const uint2*>(v + (size_t)r * o + c);
      rm[s] = *reinterpret_cast<const uint2*>(meta + (size_t)(r >> 2) * o + c);
    }
  }
  // The on-chip M:1 mux: slot p of the block receives the kept value whose
  // 2-bit index is p, else 0.  k0 is a multiple of 64, so the global
  // compressed row's position inside its meta byte is (g*N + s) % 4.
  __device__ __forceinline__ void store(int8_t* ws, int tid) const {
    const int g = tid >> 3;
    const int c8 = tid & 7;                       // 8-column group of the tile
    int8_t* dst = ws + (c8 >> 1) * BK * SP + (c8 & 1) * 8;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t out[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t word = 0u;
#pragma unroll
        for (int s = 0; s < N; ++s) {
          const int sh = 2 * ((g * N + s) & 3);
          const uint32_t vw = q == 0 ? rv[s].x : rv[s].y;
          const uint32_t mw = q == 0 ? rm[s].x : rm[s].y;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (((mw >> (8 * j + sh)) & 3u) == (uint32_t)p) word |= vw & (0xffu << (8 * j));
          }
        }
        out[q] = word;
      }
      *reinterpret_cast<uint2*>(dst + (g * 4 + p) * SP) = make_uint2(out[0], out[1]);
    }
  }
};

__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// the gather kernels' order: ws before xs (nm_spmm_gather/kernel.py:315-317)
template <bool WS_FIRST>
__device__ __forceinline__ float dequant_in_order(int acc, float xs, float ws) {
  if constexpr (WS_FIRST) return __fmul_rn(__fmul_rn(__int2float_rn(acc), ws), xs);
  return dequant(acc, xs, ws);
}

// requant_rows for int8: clip(y / scale, -127, 127), round half to even
__device__ __forceinline__ int8_t requant_int8(float y, float scale) {
  const float q = fminf(fmaxf(__fdiv_rn(y, scale), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// One output of out_kind (bf16, fp32, or the int8 code against *rq) at y[at]
__device__ __forceinline__ void store_out(void* y, size_t at, float v, int out_kind,
                                          const float* rq) {
  if (out_kind == OUT_I8) static_cast<int8_t*>(y)[at] = requant_int8(v, *rq);
  else if (out_kind == OUT_F32) static_cast<float*>(y)[at] = v;
  else static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
}

// The flush of the s8 stream (nm_spmm_sp_fp8.cuh, S8) from its summed int32
// accumulator, in gemm_int8_kernel's order: the raw int32 (out_kind 2), or
// dequant (float(acc) * xs[row] * ws[col], __fmul_rn; WS_FIRST, the gather
// kernels' order: float(acc) * ws[col] * xs[row]), + bias (__fadd_rn), act,
// then bf16, fp32 or the int8 code against *rq.  KMAJOR: the output is
// K11's (O, B), row `row` of channel `col` at col * ld + row; else (B, O) at
// row * ld + col.  ld: the output's row stride, O (or B).
template <bool WS_FIRST, bool KMAJOR = false>
struct SingleFlushI8 {
  const float* xs;
  const float* ws;
  const float* bias;
  const float* rq;
  void* y;
  int ld, act, out_kind;

  __device__ __forceinline__ void operator()(int row, int col, int acc) const {
    const size_t at = KMAJOR ? (size_t)col * ld + row : (size_t)row * ld + col;
    if (out_kind == OUT_I32) {   // raw: the exact accumulator
      static_cast<int*>(y)[at] = acc;
      return;
    }
    float v = dequant_in_order<WS_FIRST>(acc, xs[row], ws[col]);
    if (bias != nullptr) v = __fadd_rn(v, bias[col]);
    store_out(y, at, apply_act(v, act), out_kind, rq);
  }
};

// The flush of the s8 gate-up duals (nm_spmm_sp_fp8.cuh, S8 with DUAL: the
// compressed and the dense <false>, the gathered K9 <true>) from both summed
// int32 accumulators, in gemm_int8_kernel's dual order: t_g = float(acc_g) *
// xs[row] * wsg[col], t_u likewise with wsu (__fmul_rn; WS_FIRST, the gather
// kernels' order: float(acc) * ws[col] * xs[row]), silu(t_g) * t_u, then
// bf16, fp32 or the int8 code against *rq.
template <bool WS_FIRST>
struct DualFlushI8T {
  const float* xs;
  const float* wsg;
  const float* wsu;
  const float* rq;
  void* y;
  int o, out_kind;

  __device__ __forceinline__ void operator()(int row, int col, const int (&acc)[2]) const {
    const float xr = xs[row];
    store_out(y, (size_t)row * o + col,
              silu(dequant_in_order<WS_FIRST>(acc[0], xr, wsg[col])) *
                  dequant_in_order<WS_FIRST>(acc[1], xr, wsu[col]),
              out_kind, rq);
  }
};

template <int BM, bool DUAL, class WL, class XS, bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
gemm_int8_kernel(const int8_t* __restrict__ x, const int* __restrict__ ig,
                 const int* __restrict__ iu,
                 const int8_t* __restrict__ wg, const uint8_t* __restrict__ mg,
                 const int8_t* __restrict__ wu, const uint8_t* __restrict__ mu,
                 const int* __restrict__ kmask, const float* __restrict__ xs, const float* __restrict__ wsg,
                 const float* __restrict__ wsu, const float* __restrict__ bias,
                 const float* __restrict__ rq, void* __restrict__ y, int b, int ke, int k,
                 int o, int act, int out_kind) {
  using XL = typename XS::template Loader<BM, DUAL>;
  static_assert(!(DUAL && XL::kKMajor), "the K-major gather is a single GEMM");
  // a gathered dual selects X through two index streams: two X tiles
  constexpr int NX = (DUAL && XL::kGather) ? 2 : 1;
  constexpr int MF = BM / 16;
  constexpr int NW = DUAL ? 2 : 1;
  constexpr int LOAD_BYTES = NX * 4 * BM * SP + NW * 4 * BK * SP;
  constexpr int FLUSH_BYTES = NW * BM * CLD * 4;
  constexpr int SMEM = LOAD_BYTES > FLUSH_BYTES ? LOAD_BYTES : FLUSH_BYTES;
  // the staging tiles and, after the K loop, the int32 flush tiles alias
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ LiveSteps<NTHREADS> live;   // MASKED only
  int8_t* xt_g = reinterpret_cast<int8_t*>(smem);
  int8_t* xt_u = xt_g + (NX - 1) * 4 * BM * SP;
  int8_t* wt_g = xt_g + NX * 4 * BM * SP;
  int8_t* wt_u = wt_g + 4 * BK * SP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  XL xl{x, {ig, iu}, b, ke};
  WL lg{wg, mg, o};
  WL lu{wu, mu, o};

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc_g[MF];
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc_u[DUAL ? MF : 1];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    wmma::fill_fragment(acc_g[i], 0);
    if constexpr (DUAL) wmma::fill_fragment(acc_u[i], 0);
  }

  // K steps: all of them, or (MASKED) the live steps of this row block
  // (kmask.cuh; see gemm.cu)
  const int nk = k / BK;
  int s = 0;
  if constexpr (MASKED) {
    live.load(kmask, blockIdx.y, nk, tid);
    __syncthreads();
    s = live.next(0, nk);
  }
  if (s < nk) {
    xl.load(s * BK, m0, tid);
    lg.load(s * BK, n0, tid);
    if constexpr (DUAL) lu.load(s * BK, n0, tid);
  }
  while (s < nk) {
    xl.store(xt_g, tid);
    if constexpr (NX == 2) xl.template store<1>(xt_u, tid);
    lg.store(wt_g, tid);
    if constexpr (DUAL) lu.store(wt_u, tid);
    __syncthreads();
    int sn = s + 1;
    if constexpr (MASKED) sn = live.next(sn, nk);
    if (sn < nk) {   // next step's tiles travel while this one computes
      xl.load(sn * BK, m0, tid);
      lg.load(sn * BK, n0, tid);
      if constexpr (DUAL) lu.load(sn * BK, n0, tid);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bg, bu;
      wmma::load_matrix_sync(bg, reinterpret_cast<const signed char*>(
                                     wt_g + (warp * BK + ks * 16) * SP), SP);
      if constexpr (DUAL)
        wmma::load_matrix_sync(bu, reinterpret_cast<const signed char*>(
                                       wt_u + (warp * BK + ks * 16) * SP), SP);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(
                                      xt_g + (ks * BM + i * 16) * SP), SP);
        wmma::mma_sync(acc_g[i], a, bg, acc_g[i]);
        if constexpr (NX == 2) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a_u;
          wmma::load_matrix_sync(a_u, reinterpret_cast<const signed char*>(
                                          xt_u + (ks * BM + i * 16) * SP), SP);
          wmma::mma_sync(acc_u[i], a_u, bu, acc_u[i]);
        } else if constexpr (DUAL) {
          wmma::mma_sync(acc_u[i], a, bu, acc_u[i]);
        }
      }
    }
    __syncthreads();
    s = sn;
  }

  int* cs_g = reinterpret_cast<int*>(smem);
  int* cs_u = cs_g + BM * CLD;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    wmma::store_matrix_sync(cs_g + i * 16 * CLD + warp * 16, acc_g[i], CLD, wmma::mem_row_major);
    if constexpr (DUAL)
      wmma::store_matrix_sync(cs_u + i * 16 * CLD + warp * 16, acc_u[i], CLD, wmma::mem_row_major);
  }
  __syncthreads();

  const float rq_scale = out_kind == OUT_I8 ? *rq : 0.f;
  for (int e = tid; e < BM * BN; e += NTHREADS) {
    // K-major: walk the batch fastest, the (O, B) output's contiguous dim
    const int r = XL::kKMajor ? e % BM : e / BN;
    const int c = XL::kKMajor ? e / BM : e % BN;
    const int row = m0 + r;
    if (row >= b) continue;
    const size_t at = XL::kKMajor ? (size_t)(n0 + c) * b + row : (size_t)row * o + n0 + c;
    const int ag = cs_g[r * CLD + c];
    if (out_kind == OUT_I32) {   // raw: the exact accumulator
      static_cast<int*>(y)[at] = ag;
      continue;
    }
    const float xr = xs[row];
    float v = dequant_in_order<XL::kGather>(ag, xr, wsg[n0 + c]);
    if constexpr (DUAL) {
      v = silu(v) * dequant_in_order<XL::kGather>(cs_u[r * CLD + c], xr, wsu[n0 + c]);
    } else {
      if (bias != nullptr) v = __fadd_rn(v, bias[n0 + c]);
      v = apply_act(v, act);
    }
    if (out_kind == OUT_I8) static_cast<int8_t*>(y)[at] = requant_int8(v, rq_scale);
    else if (out_kind == OUT_F32) static_cast<float*>(y)[at] = v;
    else static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
  }
}

template <int BM, bool DUAL, class WL, class XS, bool MASKED>
int launch(const void* x, const void* ig, const void* iu, const void* wg, const void* mg,
           const void* wu, const void* mu, const void* kmask, const void* xs, const void* wsg,
           const void* wsu, const void* bias, const void* rq, void* y, int b, int ke, int k,
           int o, int act, int out_kind, void* stream) {
  const dim3 grid(o / BN, (b + BM - 1) / BM);
  gemm_int8_kernel<BM, DUAL, WL, XS, MASKED>
      <<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(x), static_cast<const int*>(ig),
          static_cast<const int*>(iu), static_cast<const int8_t*>(wg),
          static_cast<const uint8_t*>(mg), static_cast<const int8_t*>(wu),
          static_cast<const uint8_t*>(mu), static_cast<const int*>(kmask),
          static_cast<const float*>(xs), static_cast<const float*>(wsg),
          static_cast<const float*>(wsu), static_cast<const float*>(bias),
          static_cast<const float*>(rq), y, b, ke, k, o, act, out_kind);
  return static_cast<int>(cudaGetLastError());
}

// ke: X's row stride (K_eff); k: the contraction the weight rows run over
// (K_eff, or K_c for the gather loaders).  MASKED: single GEMMs only, with
// the (ceil(b / bm), k / 64) kmask of block_maps.
template <bool DUAL, class WL, class XS = Contiguous, bool MASKED = false>
int launch_bm(int bm, const void* x, const void* ig, const void* iu, const void* wg,
              const void* mg, const void* wu, const void* mu, const void* kmask,
              const void* xs, const void* wsg, const void* wsu, const void* bias,
              const void* rq, void* y, int b, int ke, int k, int o, int act, int out_kind,
              void* stream) {
  static_assert(!(MASKED && DUAL), "the masked kernels are single GEMMs");
  if (b <= 0 || ke <= 0 || k <= 0 || o <= 0 || k % BK != 0 || o % BN != 0 || act < 0 ||
      act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (MASKED != (kmask != nullptr) || (MASKED && k / BK > MAX_K_STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  // raw mode takes no scales and no epilogue; scaled mode needs its scales
  const bool raw = out_kind == OUT_I32;
  if (raw != (xs == nullptr) || raw != (wsg == nullptr) || (DUAL && raw != (wsu == nullptr)) ||
      (raw && (act != ACT_NONE || bias != nullptr)) || out_kind < 0 || out_kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  // the requantized store needs the consumer's scale, and only it reads one
  if ((out_kind == OUT_I8) != (rq != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16)
    return launch<16, DUAL, WL, XS, MASKED>(x, ig, iu, wg, mg, wu, mu, kmask, xs, wsg, wsu,
                                            bias, rq, y, b, ke, k, o, act, out_kind, stream);
  if (bm == 64)
    return launch<64, DUAL, WL, XS, MASKED>(x, ig, iu, wg, mg, wu, mu, kmask, xs, wsg, wsu,
                                            bias, rq, y, b, ke, k, o, act, out_kind, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool DUAL, bool MASKED = false>
int launch_nm(int n, int bm, const void* x, const void* vg, const void* mg, const void* vu,
              const void* mu, const void* kmask, const void* xs, const void* wsg,
              const void* wsu, const void* bias, const void* rq, void* y, int b, int k, int o,
              int act, int out_kind, void* stream) {
  if (n == 1)
    return launch_bm<DUAL, NMLoader<1>, Contiguous, MASKED>(
        bm, x, nullptr, nullptr, vg, mg, vu, mu, kmask, xs, wsg, wsu, bias, rq, y, b, k, k, o,
        act, out_kind, stream);
  if (n == 2)
    return launch_bm<DUAL, NMLoader<2>, Contiguous, MASKED>(
        bm, x, nullptr, nullptr, vg, mg, vu, mu, kmask, xs, wsg, wsu, bias, rq, y, b, k, k, o,
        act, out_kind, stream);
  if (n == 4)
    return launch_bm<DUAL, NMLoader<4>, Contiguous, MASKED>(
        bm, x, nullptr, nullptr, vg, mg, vu, mu, kmask, xs, wsg, wsu, bias, rq, y, b, k, k, o,
        act, out_kind, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the lane-aligned gather: X (B, ke) gathered to K_c = ke * n / 4 columns,
// contracted against the dense values tile (K_c, O); KMAJOR: X is x_t (ke,
// B), the output (O, B), b a multiple of 16
template <bool DUAL, bool MASKED = false, bool KMAJOR = false>
int launch_gather(int n, int bm, const void* x, const void* vg, const void* ig,
                  const void* vu, const void* iu, const void* kmask, const void* xs,
                  const void* wsg, const void* wsu, const void* bias, const void* rq, void* y,
                  int b, int ke, int o, int act, int out_kind, void* stream) {
  if (ke <= 0 || (ke * n) % 4 != 0 || (KMAJOR && b % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  if (n == 1)
    return launch_bm<DUAL, DenseLoader,
                     std::conditional_t<KMAJOR, GatheredKMajor<1>, Gathered<1>>, MASKED>(
        bm, x, ig, iu, vg, nullptr, vu, nullptr, kmask, xs, wsg, wsu, bias, rq, y, b, ke, kc,
        o, act, out_kind, stream);
  if (n == 2)
    return launch_bm<DUAL, DenseLoader,
                     std::conditional_t<KMAJOR, GatheredKMajor<2>, Gathered<2>>, MASKED>(
        bm, x, ig, iu, vg, nullptr, vu, nullptr, kmask, xs, wsg, wsu, bias, rq, y, b, ke, kc,
        o, act, out_kind, stream);
  if (n == 4)
    return launch_bm<DUAL, DenseLoader,
                     std::conditional_t<KMAJOR, GatheredKMajor<4>, Gathered<4>>, MASKED>(
        bm, x, ig, iu, vg, nullptr, vu, nullptr, kmask, xs, wsg, wsu, bias, rq, y, b, ke, kc,
        o, act, out_kind, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The s8 stream's flush arguments (body 1): raw mode takes no scales and no
// epilogue; the requantized store, and only it, the consumer's scale.
bool s8_flush_ok(int act, int out_kind, const void* xs, const void* ws, const void* bias,
                 const void* rq) {
  const bool raw = out_kind == OUT_I32;
  return act >= 0 && act <= 2 && out_kind >= 0 && out_kind <= 3 && raw == (xs == nullptr) &&
         raw == (ws == nullptr) && (!raw || (act == ACT_NONE && bias == nullptr)) &&
         (out_kind == OUT_I8) == (rq != nullptr);
}

// ld: the output's row stride (O; K11's (O, B) output: B)
template <bool WS_FIRST, bool KMAJOR = false>
SingleFlushI8<WS_FIRST, KMAJOR> s8_flush(const void* xs, const void* ws, const void* bias,
                                         const void* rq, void* y, int ld, int act,
                                         int out_kind) {
  return {static_cast<const float*>(xs), static_cast<const float*>(ws),
          static_cast<const float*>(bias), static_cast<const float*>(rq), y, ld, act, out_kind};
}

// ... and the duals' (all three scales; bf16, fp32 or the requantized store,
// which alone reads the consumer's scale)
bool s8_dual_flush_ok(int out_kind, const void* xs, const void* wsg, const void* wsu,
                      const void* rq) {
  return out_kind >= 0 && out_kind <= 3 && out_kind != OUT_I32 && xs != nullptr &&
         wsg != nullptr && wsu != nullptr && (out_kind == OUT_I8) == (rq != nullptr);
}

template <bool WS_FIRST>
DualFlushI8T<WS_FIRST> s8_dual_flush(const void* xs, const void* wsg, const void* wsu,
                                     const void* rq, void* y, int o, int out_kind) {
  return {static_cast<const float*>(xs), static_cast<const float*>(wsg),
          static_cast<const float*>(wsu), static_cast<const float*>(rq), y, o, out_kind};
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function launches on the
// given stream, allocates nothing, and returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernels do not take).
// out_kind: 0 bf16, 1 fp32 (scaled, xs/ws given), 2 int32 (raw, no scales),
// 3 int8 requantized against *rq (rq is given exactly then; every kernel,
// the singles' act and bias applied first).  The *_masked functions take the
// (ceil(b / bm), K steps) int32 kmask of block_maps (K / 64, or K_c / 64 for
// gather).
extern "C" {

// tile_gemm/kernel.py::int8_plan's body: 1, the s8 dense stream
// (nm_spmm_sp_fp8.cuh, S8 at N = 4; bm in {16, 64}), K split over `split`
// blocks of a cluster (a power of two up to min(8, k / 64)); 0, this file's
// body, split 1
int vg_tile_gemm_int8(const void* x, const void* w, const void* xs, const void* ws,
                      const void* bias, const void* rq, void* y, int b, int k, int o, int act,
                      int out_kind, int bm, int body, int split, void* stream) {
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bm<false, DenseLoader>(bm, x, nullptr, nullptr, w, nullptr, nullptr,
                                         nullptr, nullptr, xs, ws, nullptr, bias, rq, y, b, k,
                                         k, o, act, out_kind, stream);
  }
  if (body != 1 || !s8_flush_ok(act, out_kind, xs, ws, bias, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_s8(4, bm, x, w, nullptr, nullptr,
                         s8_flush<false>(xs, ws, bias, rq, y, o, act, out_kind), b, k, o, split,
                         stream);
}

// tile_gemm/kernel.py::masked_int8_plan's body: 1, the s8 dense stream
// (nm_spmm_sp_fp8.cuh, S8 at N = 4, MASKED; bm in {16, 64}, the maps' row
// block) walking the live steps of each block's span, K split over `split`
// blocks of a cluster (bitwise vg_tile_gemm_int8 on the same masked X); 0,
// this file's body, split 1
int vg_tile_gemm_masked_int8(const void* x, const void* w, const void* kmask, const void* xs,
                             const void* ws, const void* bias, const void* rq, void* y, int b,
                             int k, int o, int act, int out_kind, int bm, int body, int split,
                             void* stream) {
  if (kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bm<false, DenseLoader, Contiguous, true>(
        bm, x, nullptr, nullptr, w, nullptr, nullptr, nullptr, kmask, xs, ws, nullptr, bias,
        rq, y, b, k, k, o, act, out_kind, stream);
  }
  if (body != 1 || !s8_flush_ok(act, out_kind, xs, ws, bias, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_s8(4, bm, x, w, nullptr, kmask,
                         s8_flush<false>(xs, ws, bias, rq, y, o, act, out_kind), b, k, o, split,
                         stream);
}

// tile_gemm/kernel.py::int8_dual_plan's body: 1, the s8 dense dual stream
// (nm_spmm_sp_fp8.cuh, S8 with DUAL at N = 4; bm in {16, 64}), K split over
// `split` blocks of a cluster (a power of two up to min(8, k / 64)),
// flushed by DualFlushI8T<false>; 0, this file's body, split 1.  out_kind 0
// | 1 | 3 (no raw accumulator).
int vg_tile_gemm_dual_int8(const void* x, const void* wg, const void* wu, const void* xs,
                           const void* wsg, const void* wsu, const void* rq, void* y, int b,
                           int k, int o, int out_kind, int bm, int body, int split,
                           void* stream) {
  if (out_kind == OUT_I32) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bm<true, DenseLoader>(bm, x, nullptr, nullptr, wg, nullptr, wu, nullptr,
                                        nullptr, xs, wsg, wsu, nullptr, rq, y, b, k, k, o,
                                        ACT_NONE, out_kind, stream);
  }
  if (body != 1 || !s8_dual_flush_ok(out_kind, xs, wsg, wsu, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_dual<spf8::S8>(4, bm, x, wg, nullptr, wu, nullptr,
                                     s8_dual_flush<false>(xs, wsg, wsu, rq, y, o, out_kind), b,
                                     k, o, split, stream);
}

// nm_spmm/kernel.py::int8_plan's body: 1, the s8 sparse stream
// (nm_spmm_sp_fp8.cuh, S8; n in {1, 2}, bm in {16, 64}), K split over
// `split` blocks of a cluster (a power of two up to min(8, k / 64)); 0,
// this file's body at any n, split 1
int vg_nm_spmm_int8(const void* x, const void* values, const void* meta, const void* xs,
                    const void* ws, const void* bias, const void* rq, void* y, int b, int k,
                    int o, int n, int act, int out_kind, int bm, int body, int split,
                    void* stream) {
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nm<false>(n, bm, x, values, meta, nullptr, nullptr, nullptr, xs, ws, nullptr,
                            bias, rq, y, b, k, o, act, out_kind, stream);
  }
  if (body != 1 || (n != 1 && n != 2) || !s8_flush_ok(act, out_kind, xs, ws, bias, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_s8(n, bm, x, values, meta, nullptr,
                         s8_flush<false>(xs, ws, bias, rq, y, o, act, out_kind), b, k, o, split,
                         stream);
}

// nm_spmm/kernel.py::int8_plan's body, as vg_nm_spmm_int8 takes it: 1, the
// s8 sparse stream (nm_spmm_sp_fp8.cuh, S8, MASKED; n in {1, 2}, bm in {16,
// 64}, the maps' row block) walking the live steps of each block's span, K
// split over `split` blocks of a cluster (bitwise vg_nm_spmm_int8 on the
// same masked X); 0, this file's body at any n, split 1
int vg_nm_spmm_masked_int8(const void* x, const void* values, const void* meta,
                           const void* kmask, const void* xs, const void* ws, const void* bias,
                           const void* rq, void* y, int b, int k, int o, int n, int act,
                           int out_kind, int bm, int body, int split, void* stream) {
  if (kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nm<false, true>(n, bm, x, values, meta, nullptr, nullptr, kmask, xs, ws,
                                  nullptr, bias, rq, y, b, k, o, act, out_kind, stream);
  }
  if (body != 1 || (n != 1 && n != 2) || !s8_flush_ok(act, out_kind, xs, ws, bias, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_s8(n, bm, x, values, meta, kmask,
                         s8_flush<false>(xs, ws, bias, rq, y, o, act, out_kind), b, k, o, split,
                         stream);
}

// nm_spmm/kernel.py::int8_dual_plan's body: 1, the s8 sparse dual stream
// (nm_spmm_sp_fp8.cuh, S8 with DUAL; n in {1, 2}, bm in {16, 64}), K split
// over `split` blocks of a cluster (a power of two up to min(8, k / 64)),
// flushed by DualFlushI8T<false>; 0, this file's body at any n, split 1.
// out_kind 0 | 1 | 3 (no raw accumulator).
int vg_nm_spmm_dual_int8(const void* x, const void* values_g, const void* meta_g,
                         const void* values_u, const void* meta_u, const void* xs,
                         const void* wsg, const void* wsu, const void* rq, void* y, int b,
                         int k, int o, int n, int out_kind, int bm, int body, int split,
                         void* stream) {
  if (out_kind == OUT_I32) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nm<true>(n, bm, x, values_g, meta_g, values_u, meta_u, nullptr, xs, wsg,
                           wsu, nullptr, rq, y, b, k, o, ACT_NONE, out_kind, stream);
  }
  if (body != 1 || (n != 1 && n != 2) || !s8_dual_flush_ok(out_kind, xs, wsg, wsu, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_dual<spf8::S8>(n, bm, x, values_g, meta_g, values_u, meta_u,
                                     s8_dual_flush<false>(xs, wsg, wsu, rq, y, o, out_kind), b,
                                     k, o, split, stream);
}

// k is K_eff (X's width); the kernel contracts K_c = k * n / 4 rows of
// values.  nm_spmm_gather/kernel.py::int8_plan's body: 1, the s8 dense
// stream with the gathered X (nm_spmm_sp_fp8.cuh, S8, G = n in {1, 2}; bm in
// {16, 64}), K_c split over `split` blocks of a cluster (a power of two up to
// min(8, K_c / 64)), flushed ws first; 0, this file's body at any n, split 1
int vg_nm_spmm_gather_bk_int8(const void* x, const void* values, const void* idx,
                              const void* xs, const void* ws, const void* bias, const void* rq,
                              void* y, int b, int k, int o, int n, int act, int out_kind, int bm,
                              int body, int split, void* stream) {
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<false>(n, bm, x, values, idx, nullptr, nullptr, nullptr, xs, ws,
                                nullptr, bias, rq, y, b, k, o, act, out_kind, stream);
  }
  if (body != 1 || (n != 1 && n != 2) || !s8_flush_ok(act, out_kind, xs, ws, bias, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_gather<spf8::S8>(n, bm, x, values, idx, nullptr,
                                       s8_flush<true>(xs, ws, bias, rq, y, o, act, out_kind), b,
                                       k, o, split, stream);
}

// k is K_eff.  nm_spmm_gather/kernel.py::masked_int8_plan's body: 1, K8
// int8's s8 gathered stream (nm_spmm_sp_fp8.cuh, S8, G = n, MASKED; n in {1,
// 2}, bm in {16, 64}, the maps' row block) walking the live steps of each
// block's span, K_c split over `split` blocks of a cluster, flushed ws first
// (bitwise vg_nm_spmm_gather_bk_int8 on the same masked X); 0, this file's
// body at any n, split 1
int vg_nm_spmm_gather_bk_masked_int8(const void* x, const void* values, const void* idx,
                                     const void* kmask, const void* xs, const void* ws,
                                     const void* bias, const void* rq, void* y, int b, int k,
                                     int o, int n, int act, int out_kind, int bm, int body,
                                     int split, void* stream) {
  if (kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<false, true>(n, bm, x, values, idx, nullptr, nullptr, kmask, xs, ws,
                                      nullptr, bias, rq, y, b, k, o, act, out_kind, stream);
  }
  if (body != 1 || (n != 1 && n != 2) || !s8_flush_ok(act, out_kind, xs, ws, bias, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_gather<spf8::S8>(n, bm, x, values, idx, kmask,
                                       s8_flush<true>(xs, ws, bias, rq, y, o, act, out_kind), b,
                                       k, o, split, stream);
}

// k is K_eff.  nm_spmm_gather/kernel.py::int8_dual_plan's body: 1, the s8
// gathered dual stream (nm_spmm_sp_fp8.cuh, S8, G = n with DUAL: one span a
// step selected twice; n in {1, 2}, bm 16), K_c split over `split` blocks of
// a cluster, flushed by DualFlushI8T<true> (ws first, as this file's body);
// 0, this file's body at any n, split 1.  out_kind 0 | 1 | 3 (no raw
// accumulator).
int vg_nm_spmm_gather_dual_bk_int8(const void* x, const void* values_g, const void* idx_g,
                                   const void* values_u, const void* idx_u, const void* xs,
                                   const void* wsg, const void* wsu, const void* rq, void* y,
                                   int b, int k, int o, int n, int out_kind, int bm, int body,
                                   int split, void* stream) {
  if (out_kind == OUT_I32) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<true>(n, bm, x, values_g, idx_g, values_u, idx_u, nullptr, xs, wsg,
                               wsu, nullptr, rq, y, b, k, o, ACT_NONE, out_kind, stream);
  }
  if (body != 1 || (n != 1 && n != 2) || !s8_dual_flush_ok(out_kind, xs, wsg, wsu, rq))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_gather_dual<spf8::S8>(
      n, bm, x, values_g, idx_g, values_u, idx_u,
      s8_dual_flush<true>(xs, wsg, wsu, rq, y, o, out_kind), b, k, o, split, stream);
}

// K11: x_t (k, b) K-major -> y_t (o, b), b a multiple of 16; xs (1, b) and
// ws (o, 1) for out_kind 0 | 1, none for the raw int32 accumulator (2).
// nm_spmm_gather/kernel.py::kmajor_int8_plan's body: 1, the s8 dense stream
// with the K-major X stage (nm_spmm_sp_fp8.cuh, S8 with KM, G = n in {1, 2};
// bm in {16, 64}), K_c split over `split` blocks of a cluster, flushed
// float(acc) * ws * xs into the (O, B) output; 0, this file's body at any n,
// split 1
int vg_nm_spmm_gather_int8(const void* x_t, const void* values, const void* idx,
                           const void* xs, const void* ws, void* y_t, int b, int k, int o,
                           int n, int out_kind, int bm, int body, int split, void* stream) {
  if (out_kind == OUT_I8) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<false, false, true>(n, bm, x_t, values, idx, nullptr, nullptr,
                                             nullptr, xs, ws, nullptr, nullptr, nullptr, y_t,
                                             b, k, o, ACT_NONE, out_kind, stream);
  }
  if (body != 1 || (n != 1 && n != 2) ||
      !s8_flush_ok(ACT_NONE, out_kind, xs, ws, nullptr, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_kmajor<spf8::S8>(
      n, bm, x_t, values, idx,
      s8_flush<true, true>(xs, ws, nullptr, nullptr, y_t, b, ACT_NONE, out_kind), b, k, o,
      split, stream);
}

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
