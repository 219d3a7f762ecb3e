// Hand-written Hopper (sm_90a) fp8 kernels for the repro_torch fp8
// execution class (e4m3 weights x e4m3 activations, fp32 accumulation):
// tile_gemm_fp8, tile_gemm_dual_fp8, nm_spmm_fp8, nm_spmm_dual_fp8, the
// lane-aligned gather pair nm_spmm_gather_bk_fp8 and
// nm_spmm_gather_dual_bk_fp8, and the activation-sparsity (K10) variants of
// the three singles, tile_gemm_masked_fp8, nm_spmm_masked_fp8,
// nm_spmm_gather_bk_masked_fp8; every one of them with the requantizing
// flush (out_kind 3); and the K-major gather nm_spmm_gather_fp8 (K11),
// scaled or raw.
//
// Replaces (JAX package, Pallas on the TPU):
//   tile_gemm_fp8       repro/kernels/tile_gemm/kernel.py::tile_gemm_fp8
//                       (_tile_gemm_quantized, _gemm_q_raw_kernel, _gemm_kernel)
//   tile_gemm_dual_fp8  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual,
//                       quantized branch with acc_dtype=float32 (_gemm_dual_kernel)
//   nm_spmm_fp8         repro/kernels/nm_spmm/kernel.py::nm_spmm_fp8
//                       (_nm_spmm_quantized, _spmm_q_raw_kernel, _spmm_kernel)
//   nm_spmm_dual_fp8    repro/kernels/nm_spmm/kernel.py::nm_spmm_dual,
//                       quantized branch with acc_dtype=float32 (_spmm_dual_kernel)
//   nm_spmm_gather_bk_fp8       repro/kernels/nm_spmm_gather/kernel.py::
//                               nm_spmm_gather_bk, fp8 (_gather_bk_kernel)
//   nm_spmm_gather_dual_bk_fp8  repro/kernels/nm_spmm_gather/kernel.py::
//                               nm_spmm_gather_dual_bk, fp8 (_gather_dual_kernel)
//   tile_gemm_masked_fp8, nm_spmm_masked_fp8, nm_spmm_gather_bk_masked_fp8
//        repro/kernels/{tile_gemm,nm_spmm,nm_spmm_gather}/kernel.py::
//        tile_gemm_masked, nm_spmm_masked, nm_spmm_gather_bk_masked, scaled-
//        quantized with acc_dtype=float32 (the *_masked_kernel bodies)
//   nm_spmm_gather_fp8  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_fp8
//                       (_nm_spmm_gather_quantized, _gather_q_kernel,
//                       _gather_q_raw_kernel)
// and, in the duals' flush, the requant:float8_e4m3fn point of
// repro/kernels/epilogue.py::flush_tile / requant_rows.
//
// nm_spmm_fp8 at n in {1, 2} runs its own body on the sparse tensor
// cores, nm_spmm_sp_fp8.cuh (mma.sp m16n8k64 e4m3, K split across a
// cluster), and so does nm_spmm_dual_fp8 (with its requantizing form) in
// that header's DUAL form where nm_spmm/kernel.py::fp8_dual_plan picks it;
// tile_gemm_fp8 (with its requantizing form) runs the two bodies
// tile_gemm/kernel.py::fp8_plan picks: below 256 rows the same stream over
// the dense weight (mma.sync m16n8k32, split-K), from 256 rows
// tile_gemm_sm90_fp8.cuh (TMA + wgmma m64n128k32 e4m3, the weight tile
// transposed on chip); tile_gemm_dual_fp8 (with its requantizing form) the
// DUAL forms of those two (the wgmma one never for the requantized codes),
// as tile_gemm/kernel.py::fp8_dual_plan picks; nm_spmm_gather_bk_fp8 (with
// its requantizing form) at n in {1, 2} runs the same two with the X side
// gathered, as nm_spmm_gather/kernel.py::fp8_plan picks: the stream with a
// select pass over the step's span, or the gather pass below
// (gather_then_wgmma) in front of the wgmma body; nm_spmm_gather_dual_bk_fp8
// (K9 fp8, with its requantizing form) at n in {1, 2} the stream's gathered
// DUAL form (one span a step selected twice) where
// nm_spmm_gather/kernel.py::fp8_dual_plan picks it; and K11 fp8
// (nm_spmm_gather_fp8) at n in {1, 2} the stream with a K-major X stage, as
// nm_spmm_gather/kernel.py::kmajor_fp8_plan picks.  Each is flushed by
// SingleFlushT / DualFlushT below in the same order as this file's body.
// nm_spmm_masked_fp8 at n in {1, 2} runs nm_spmm_fp8's sparse stream in
// MASKED form (each block walking the live steps of its span) wherever
// fp8_plan gives nm_spmm_fp8 that stream, and the shared body where it
// keeps the shared one; tile_gemm_masked_fp8 the dense stream in MASKED
// form wherever tile_gemm/kernel.py::fp8_plan gives tile_gemm_fp8 that
// stream (tile_gemm/kernel.py::masked_fp8_plan), else the shared body; and
// nm_spmm_gather_bk_masked_fp8 at n in {1, 2} K8 fp8's gathered stream in
// MASKED form wherever nm_spmm_gather/kernel.py::masked_fp8_plan picks it
// (K8 fp8's tile and split up to 16 rows, its split over 64-row tiles at
// 17-64 rows where K_c >= 2048), else the shared body.
// vg_nm_spmm_fp8_tiled, vg_tile_gemm_fp8_tiled, vg_nm_spmm_dual_fp8_tiled,
// vg_nm_spmm_gather_bk_fp8_tiled, vg_tile_gemm_dual_fp8_tiled and
// vg_nm_spmm_gather_fp8_tiled keep the shared body for them, the forms the
// port ran first, as yardsticks (vg_nm_spmm_masked_fp8,
// vg_tile_gemm_masked_fp8, vg_nm_spmm_gather_bk_masked_fp8 and
// vg_nm_spmm_gather_dual_bk_fp8 reach theirs at body 0, split 1).
//
// ONE templated body serves all ten, as in gemm_int8.cu: the template
// takes the weight loader (dense e4m3, or N:4 e4m3 values + 2-bit packed
// meta), the X loader (contiguous, gathered through the lane-aligned
// index, or that gather from K-major X, see gemm.cu), single or dual (gate-up, two weights against one X
// read), and MASKED: the activation-sparsity block skip of gemm.cu
// (kmask.cuh).  A dead 64-deep step's partial sum would be +0, so
// skipping it leaves the fp32 accumulator bitwise as it was.
//
// What it computes.  A block of 128 threads (4 warps) owns a BM x 64 tile
// of Y (BM = 16 for decode-sized batches, 64 for prefill chunks) and
// loops over K in steps of 64 inside the block, the next step's tiles in
// flight into registers while the tensor cores contract the current one.
// There is no wmma fragment for e4m3, so the product is the card's fp8
// instruction itself, mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32
// (sm_89 and later): each warp owns 16 output columns (two n8 tiles) and
// every m16 row tile.  The products of two e4m3 values are exact in fp32;
// the tensor cores' own running sum is reported to keep fewer mantissa
// bits than fp32, so each 64-deep K step (two k32 instructions) starts
// from zero and is added into a separate fp32 register accumulator
// (promotion every 64 K): at K = 8192 the tensor cores sum 64 products at
// a time and the remaining 128 partial sums are plain fp32 adds.
// The flush runs from the fragments in the JAX kernels' order: t =
// acc * xs[row] * ws[col] (left to right, fp32, __fmul_rn; the gather
// kernels multiply ws before xs, nm_spmm_gather/kernel.py:315-317), then + bias ->
// silu | gelu, or for a dual silu(t_g) * t_u, then one cast (bf16 or fp32)
// and a store masked to the rows < B.  With no scales (raw mode) it
// stores the fp32 accumulator itself.  Only the accumulator's summation
// order differs from the plain version.
//
// Requantize (K0's requant:float8_e4m3fn lattice point), in every kernel:
// the duals, the singles (the gelu MLP's w_in: + bias -> act) and the masked
// singles.  When the next linear quantizes against a calibrated static
// scale, the flush emits its rows already in e4m3 against that scale: q =
// y / rq (__fdiv_rn), clipped to +-448, then the round-to-nearest-even
// cast (__nv_cvt_float_to_fp8, satfinite), so the codes are the plain
// version's on the same fp32 y.  rq is read from device memory (no host
// sync per site).
//
// Operand layouts.  .row.col wants each thread's A bytes consecutive
// along K (X (B, K) already is) and its B bytes consecutive along K too,
// but W is (K, O) with O contiguous.  So the weight tile is stored
// transposed in shared memory, [64 O][64 K bytes]: each thread holds
// four consecutive K rows of 8 O bytes and writes one 32-bit word (four
// K bytes) per column, built with __byte_perm.  The N:M expansion writes
// its four dense rows the same way.  Rows of both tiles are padded to 80
// bytes, so the fragment loads (8 rows x 4 words per instruction) hit 32
// distinct banks.  At decode the m16 row tile is half masked (B = 8);
// the kernel is bound by weight bytes, not by tensor-core rate, so the
// operands are not swapped.
//
// Gathered activations.  The rows are quantized to e4m3 over their full
// K_eff row before the launch; the gather loader selects the kept
// columns' bytes from 16-byte chunks of the step's X span into the same
// [BM][80 B] X tile the hand-loaded A fragments read, so the mma path is
// unchanged.
//
// N:M weights.  The loader reads the values tile (64*n/4 rows of e4m3)
// and the packed meta tile (64*n/16 rows, four 2-bit in-block indices
// per byte, low bits first) and expands them on chip:
// w[(r/n)*4 + idx(r), o] = values[r, o].  The dense weight never exists
// in device memory.  fp8 is one byte like int8, so the loads and the
// byte mux are gemm_int8.cu's.
//
// What bounds it on an H100.  At decode (B = 8) every weight byte is read
// once for 2 fp8 operations per row of X, far below the ridge (~590 fp8
// operations per byte at 1979 TFLOP/s over 3.35 TB/s), so the weight
// bytes over 3.35 TB/s bound it: the same bytes as int8, e.g. 1.27 /
// 0.80 / 0.41 us at (K, O) = (2048, 2048) dense / 2:4 / 1:4.  What the
// design does about it: e4m3 halves the bf16 weight bytes, the N:M
// loader moves n/4 of them plus 2 bits per kept value and expands on
// chip, loads are 8- and 16-byte vectors.  As in gemm_int8.cu the launch
// is O/64 blocks with a serial K loop (the streaming bodies split K, the
// wgmma body runs a TMA ring): this shared body keeps none of that.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Three nvcc processes build this file side by side (_build.py's PARTS):
// VG_PART 0 compiles the dense entry points (tile_gemm*_fp8), 1 the
// compressed ones (nm_spmm*_fp8), 2 the gathered ones (nm_spmm_gather*_fp8);
// each part instantiates only the kernels its entry points launch.  With no
// VG_PART one library holds them all.
#ifdef VG_PART
#define VG_HAS_PART(p) (VG_PART == (p))
#else
#define VG_HAS_PART(p) 1
#endif

#include "flush.cuh"
#include "kmask.cuh"
#include "nm_spmm_sp_fp8.cuh"
#include "tile_gemm_sm90_fp8.cuh"

namespace {

using spf8::gather_byte;

constexpr int BK = 64;          // K step (e4m3 columns of X, dense rows of W)
constexpr int BN = 64;          // output columns per block
constexpr int NTHREADS = 128;   // 4 warps, each owning 16 output columns
constexpr int PITCH = 80;       // bytes per shared row: 64 K bytes + 16 of padding
constexpr float E4M3_MAX = 448.f;

// out_kind of the C interface
enum { OUT_BF16 = 0, OUT_F32 = 1, OUT_RAW = 2, OUT_E4M3 = 3 };

// X tile: BM rows x 64 bytes = four 16-byte chunks per row.  Thread t
// loads chunk t%4 of row t/4 (+32 i); rows at or beyond B read as zero.
// ke is X's row stride.
template <int BM>
struct XLoader {
  static constexpr bool kGather = false;
  static constexpr bool kKMajor = false;
  static constexpr int NI = (BM * 4 + NTHREADS - 1) / NTHREADS;
  const uint8_t* x;
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
  __device__ __forceinline__ void store(uint8_t* xs, int tid) const {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int rl = (tid >> 2) + 32 * i;
      if (rl < BM) *reinterpret_cast<uint4*>(xs + rl * PITCH + (tid & 3) * 16) = r[i];
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
  const uint8_t* x;
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
  __device__ __forceinline__ void store(uint8_t* xs, int tid) const {
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
      uint32_t* dst = reinterpret_cast<uint32_t*>(xs + rl * PITCH + 4 * N * ch);
#pragma unroll
      for (int q = 0; q < N; ++q) dst[q] = out[q];
    }
  }
};

// K-major gathered X tile (K11; see gemm.cu and gemm_int8.cu): x_t
// (K_eff, B) e4m3, b its row stride.  Load q of the step's BK x BM/16
// 16-byte loads reads compressed row c = k0 + q % BK, batch columns m0 +
// (q / BK) * 16 .. + 15, from x_t row (c / N) * 4 + idx[c] (an index
// outside [0, 4) selects zeros); the store writes the 16 bytes down column
// q % BK of the [BM][PITCH] tile.  B is a multiple of 16.
template <int BM, int N>
struct KMajorGatherXLoader {
  static constexpr bool kGather = true;
  static constexpr bool kKMajor = true;
  static constexpr int NL = BK * (BM / 16);                  // loads per step
  static constexpr int NI = (NL + NTHREADS - 1) / NTHREADS;  // loads per thread
  const uint8_t* x;
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
  __device__ __forceinline__ void store(uint8_t* xs, int tid) const {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int q = tid + NTHREADS * i;
      if (q >= NL) continue;
      const int j = q % BK, r0 = (q / BK) * 16;
      const uint8_t* v = reinterpret_cast<const uint8_t*>(&r[i]);
#pragma unroll
      for (int e = 0; e < 16; ++e) xs[(r0 + e) * PITCH + j] = v[e];
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

// Four consecutive K rows (k_base + p) of 8 O bytes (o_base + c, byte c of
// rows[p]) -> the transposed tile [O][K]: one 32-bit word per column.
__device__ __forceinline__ void store_transposed(uint8_t* ws, const uint2 (&rows)[4],
                                                 int o_base, int k_base) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t word =
        c < 4 ? gather_byte(rows[0].x, rows[1].x, rows[2].x, rows[3].x, c)
              : gather_byte(rows[0].y, rows[1].y, rows[2].y, rows[3].y, c - 4);
    *reinterpret_cast<uint32_t*>(ws + (o_base + c) * PITCH + k_base) = word;
  }
}

// Dense (K, O) e4m3 weight: thread t loads K rows 4*(t/8)..+3 of the 8
// columns 8*(t%8)..+7 (8-byte loads; a warp reads 64 contiguous bytes of
// each of its rows).
struct DenseLoader {
  const uint8_t* w;
  const uint8_t* unused_meta;
  int o;
  uint2 r[4];

  __device__ __forceinline__ void load(int k0, int n0, int tid) {
    const int row = k0 + 4 * (tid >> 3);
    const int c = n0 + 8 * (tid & 7);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      r[p] = *reinterpret_cast<const uint2*>(w + (size_t)(row + p) * o + c);
  }
  __device__ __forceinline__ void store(uint8_t* ws, int tid) const {
    store_transposed(ws, r, 8 * (tid & 7), 4 * (tid >> 3));
  }
};

// Compressed N:4 e4m3 weight: values (K*N/4, O), meta (K*N/16, O) uint8.
// Thread t expands M-block g = t/8 (dense rows 4g..4g+3 of the tile) for
// the 8 columns 8*(t%8)..+7: it holds the block's N value words and their
// meta bytes (8 bytes each).
template <int N>
struct NMLoader {
  const uint8_t* v;
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
  // 2-bit index is p, else 0 (+0.0 in e4m3).  k0 is a multiple of 64, so
  // the global compressed row's position inside its meta byte is
  // (g*N + s) % 4.
  __device__ __forceinline__ void store(uint8_t* ws, int tid) const {
    const int g = tid >> 3;
    uint2 rows[4];
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
      rows[p] = make_uint2(out[0], out[1]);
    }
    store_transposed(ws, rows, 8 * (tid & 7), 4 * g);
  }
};

// d += A (16 x 32, row) * B (32 x 8, col), e4m3 in, fp32 out (spf8::mma_e4m3).
// Fragments (lane = 4 * grp + tig): a0 = A[grp][4tig..+3], a1 = A[grp+8][..],
// a2 = A[grp][16+4tig..+3], a3 = A[grp+8][16+..]; b0 = B[4tig..+3][grp],
// b1 = B[16+4tig..+3][grp]; d0, d1 = D[grp][2tig, +1], d2, d3 = D[grp+8][..].
using spf8::mma_e4m3;

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float dequant(float acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(acc, xs), ws);
}

// the gather kernels' order: ws before xs (nm_spmm_gather/kernel.py:315-317)
template <bool WS_FIRST>
__device__ __forceinline__ float dequant_in_order(float acc, float xs, float ws) {
  if constexpr (WS_FIRST) return __fmul_rn(__fmul_rn(acc, ws), xs);
  return dequant(acc, xs, ws);
}

// requant_rows for e4m3: clip(y / scale, -448, 448), then the RNE cast
__device__ __forceinline__ uint8_t requant_e4m3(float y, float scale) {
  const float q = fminf(fmaxf(__fdiv_rn(y, scale), -E4M3_MAX), E4M3_MAX);
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3));
}

// One output of out_kind (bf16, fp32, or the e4m3 code against scale) at y[at]
__device__ __forceinline__ void store_out(void* y, size_t at, float v, int out_kind,
                                          float scale) {
  if (out_kind == OUT_E4M3) static_cast<uint8_t*>(y)[at] = requant_e4m3(v, scale);
  else if (out_kind == OUT_F32) static_cast<float*>(y)[at] = v;
  else static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
}

// The flush of a single GEMM from its summed fp32 accumulator, in the
// order of gemm_fp8_kernel's (the streaming body, nm_spmm_sp_fp8.cuh, calls
// it once per output after its split-K sum; the wgmma body,
// tile_gemm_sm90_fp8.cuh, four consecutive channels at a time).  WS_FIRST:
// the gather kernels' acc * ws * xs (K8, K11), else acc * xs * ws.  KMAJOR:
// the output is K11's (O, B), row `row` of channel `col` at col * ld + row;
// else (B, O) at row * ld + col.  ld: the output's row stride, O (or B).
template <bool WS_FIRST, bool KMAJOR = false>
struct SingleFlushT {
  const float* xs;
  const float* ws;
  const float* bias;
  const float* rq;
  void* y;
  int ld, act, out_kind;

  __device__ __forceinline__ void operator()(int row, int col, float acc) const {
    const size_t at = KMAJOR ? (size_t)col * ld + row : (size_t)row * ld + col;
    if (out_kind == OUT_RAW) {   // raw: the fp32 accumulator
      static_cast<float*>(y)[at] = acc;
      return;
    }
    float v = dequant_in_order<WS_FIRST>(acc, xs[row], ws[col]);
    if (bias != nullptr) v = __fadd_rn(v, bias[col]);
    v = apply_act(v, act);
    store_out(y, at, v, out_kind, out_kind == OUT_E4M3 ? *rq : 0.f);
  }

  // channels col .. col + 3 of a row (col a multiple of 4): the same
  // operations per element, vector loads of the scales and bias, one store
  __device__ __forceinline__ void flush4(int row, int col, float4 acc) const {
    static_assert(!KMAJOR, "four consecutive channels of a (B, O) row");
    const size_t at = (size_t)row * ld + col;
    if (out_kind == OUT_RAW) {
      *reinterpret_cast<float4*>(static_cast<float*>(y) + at) = acc;
      return;
    }
    const float xr = xs[row];
    const float4 w4 = *reinterpret_cast<const float4*>(ws + col);
    float v[4] = {dequant_in_order<WS_FIRST>(acc.x, xr, w4.x),
                  dequant_in_order<WS_FIRST>(acc.y, xr, w4.y),
                  dequant_in_order<WS_FIRST>(acc.z, xr, w4.z),
                  dequant_in_order<WS_FIRST>(acc.w, xr, w4.w)};
    if (bias != nullptr) {
      const float4 b4 = *reinterpret_cast<const float4*>(bias + col);
      v[0] = __fadd_rn(v[0], b4.x);
      v[1] = __fadd_rn(v[1], b4.y);
      v[2] = __fadd_rn(v[2], b4.z);
      v[3] = __fadd_rn(v[3], b4.w);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = apply_act(v[e], act);
    if (out_kind == OUT_E4M3) {
      const float s = *rq;
      *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(y) + at) =
          static_cast<uint32_t>(requant_e4m3(v[0], s)) |
          static_cast<uint32_t>(requant_e4m3(v[1], s)) << 8 |
          static_cast<uint32_t>(requant_e4m3(v[2], s)) << 16 |
          static_cast<uint32_t>(requant_e4m3(v[3], s)) << 24;
    } else if (out_kind == OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(y) + at) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + at) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
};
using SingleFlush = SingleFlushT<false>;

// The flush of the gate-up duals (nm_spmm_sp_fp8.cuh's DUAL stream, the
// compressed, the dense and the gathered; tile_gemm_sm90_fp8.cuh's DUAL
// body) from both summed fp32 accumulators, in gemm_fp8_kernel's order: t_g
// = acc_g * xs * wsg, t_u = acc_u * xs * wsu (WS_FIRST, the gather kernels':
// acc * ws * xs), silu(t_g) * t_u, then bf16, fp32 or the e4m3 code against
// *rq.  The wgmma body forms value() in registers and stores four channels
// with store4 (bf16 or fp32: it never takes the requant).
template <bool WS_FIRST>
struct DualFlushT {
  const float* xs;
  const float* wsg;
  const float* wsu;
  const float* rq;
  void* y;
  int o, out_kind;

  __device__ __forceinline__ float value(int row, int col, float acc_g, float acc_u) const {
    const float xr = xs[row];
    return silu(dequant_in_order<WS_FIRST>(acc_g, xr, wsg[col])) *
           dequant_in_order<WS_FIRST>(acc_u, xr, wsu[col]);
  }
  __device__ __forceinline__ void operator()(int row, int col, const float (&acc)[2]) const {
    store_out(y, (size_t)row * o + col, value(row, col, acc[0], acc[1]), out_kind,
              out_kind == OUT_E4M3 ? *rq : 0.f);
  }
  __device__ __forceinline__ void store4(int row, int col, float4 v) const {
    const size_t at = (size_t)row * o + col;
    if (out_kind == OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(y) + at) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + at) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
};
using DualFlush = DualFlushT<false>;

template <int BM, bool DUAL, class WL, class XS, bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
gemm_fp8_kernel(const uint8_t* __restrict__ x, const int* __restrict__ ig,
                const int* __restrict__ iu,
                const uint8_t* __restrict__ wg, const uint8_t* __restrict__ mg,
                const uint8_t* __restrict__ wu, const uint8_t* __restrict__ mu,
                const int* __restrict__ kmask, const float* __restrict__ xs, const float* __restrict__ wsg,
                const float* __restrict__ wsu, const float* __restrict__ bias,
                const float* __restrict__ rq, void* __restrict__ y, int b, int ke, int k,
                int o, int act, int out_kind) {
  using XL = typename XS::template Loader<BM, DUAL>;
  static_assert(!(DUAL && XL::kKMajor), "the K-major gather is a single GEMM");
  // a gathered dual selects X through two index streams: two X tiles
  constexpr int NX = (DUAL && XL::kGather) ? 2 : 1;
  constexpr int MF = BM / 16;     // m16 row tiles
  constexpr int NF = 2;           // n8 column tiles per warp
  constexpr int NW = DUAL ? 2 : 1;
  __shared__ __align__(16) uint8_t xt[NX][BM * PITCH];
  __shared__ __align__(16) uint8_t wt[NW][BN * PITCH];
  __shared__ LiveSteps<NTHREADS> live;   // MASKED only

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int grp = (tid & 31) >> 2;
  const int tig = tid & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  XL xl{x, {ig, iu}, b, ke};
  WL lg{wg, mg, o};
  WL lu{wu, mu, o};

  float acc[NW][MF][NF][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.f;

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
    xl.store(xt[0], tid);
    if constexpr (NX == 2) xl.template store<1>(xt[NX - 1], tid);
    lg.store(wt[0], tid);
    if constexpr (DUAL) lu.store(wt[1], tid);
    __syncthreads();
    int sn = s + 1;
    if constexpr (MASKED) sn = live.next(sn, nk);
    if (sn < nk) {   // next step's tiles travel while this one computes
      xl.load(sn * BK, m0, tid);
      lg.load(sn * BK, n0, tid);
      if constexpr (DUAL) lu.load(sn * BK, n0, tid);
    }
    // this warp's B fragments: 16 columns, both k32 halves of the step
    uint32_t bf[NW][NF][2][2];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint8_t* p = wt[w] + (warp * 16 + j * 8 + grp) * PITCH + ks * 32 + tig * 4;
          bf[w][j][ks][0] = lds32(p);
          bf[w][j][ks][1] = lds32(p + 16);
        }
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      // the A fragments of each X tile (gate and, gathered dual, up)
      uint32_t af[NX][2][4];
#pragma unroll
      for (int t = 0; t < NX; ++t)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint8_t* p = xt[t] + (i * 16 + grp) * PITCH + ks * 32 + tig * 4;
          af[t][ks][0] = lds32(p);
          af[t][ks][1] = lds32(p + 8 * PITCH);
          af[t][ks][2] = lds32(p + 16);
          af[t][ks][3] = lds32(p + 8 * PITCH + 16);
        }
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          // the 64-deep partial sum on the tensor cores, promoted into fp32
          const int t = NX == 2 ? w : 0;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_e4m3(part, af[t][0], bf[w][j][0][0], bf[w][j][0][1]);
          mma_e4m3(part, af[t][1], bf[w][j][1][0], bf[w][j][1][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[w][i][j][e] = __fadd_rn(acc[w][i][j][e], part[e]);
        }
    }
    __syncthreads();
    s = sn;
  }

  const float rq_scale = out_kind == OUT_E4M3 ? *rq : 0.f;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + i * 16 + grp + (e >> 1) * 8;
        if (row >= b) continue;
        const int col = n0 + warp * 16 + j * 8 + tig * 2 + (e & 1);
        // K-major (K11): the output is (O, B)
        const size_t at = XL::kKMajor ? (size_t)col * b + row : (size_t)row * o + col;
        const float ag = acc[0][i][j][e];
        if (out_kind == OUT_RAW) {   // raw: the fp32 accumulator
          static_cast<float*>(y)[at] = ag;
          continue;
        }
        const float xr = xs[row];
        float v = dequant_in_order<XL::kGather>(ag, xr, wsg[col]);
        if constexpr (DUAL) {
          v = silu(v) * dequant_in_order<XL::kGather>(acc[NW - 1][i][j][e], xr, wsu[col]);
        } else {
          if (bias != nullptr) v = __fadd_rn(v, bias[col]);
          v = apply_act(v, act);
        }
        if (out_kind == OUT_E4M3) static_cast<uint8_t*>(y)[at] = requant_e4m3(v, rq_scale);
        else if (out_kind == OUT_F32) static_cast<float*>(y)[at] = v;
        else static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
      }
}

// The checks of a single GEMM's flush (raw: no scales and no epilogue;
// scaled: both scales; the requantized store: the consumer's scale, and
// only it reads one) and the flush itself; false when they fail.  ld: the
// output's row stride.
template <bool WS_FIRST, bool KMAJOR>
bool single_flush(const void* xs, const void* ws, const void* bias, const void* rq, void* y,
                  int ld, int act, int out_kind, SingleFlushT<WS_FIRST, KMAJOR>& flush) {
  const bool raw = out_kind == OUT_RAW;
  if (act < 0 || act > 2 || out_kind < 0 || out_kind > 3 || raw != (xs == nullptr) ||
      raw != (ws == nullptr) || (raw && (act != ACT_NONE || bias != nullptr)) ||
      (out_kind == OUT_E4M3) != (rq != nullptr))
    return false;
  flush = SingleFlushT<WS_FIRST, KMAJOR>{
      static_cast<const float*>(xs), static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(rq), y, ld, act, out_kind};
  return true;
}

// ... and of the dual's (all three scales; bf16, fp32 or the requantized
// store, which alone reads the consumer's scale)
template <bool WS_FIRST>
bool dual_flush(const void* xs, const void* wsg, const void* wsu, const void* rq, void* y,
                int o, int out_kind, DualFlushT<WS_FIRST>& flush) {
  if (out_kind < 0 || out_kind > 3 || out_kind == OUT_RAW || xs == nullptr || wsg == nullptr ||
      wsu == nullptr || (out_kind == OUT_E4M3) != (rq != nullptr))
    return false;
  flush = DualFlushT<WS_FIRST>{static_cast<const float*>(xs), static_cast<const float*>(wsg),
                               static_cast<const float*>(wsu), static_cast<const float*>(rq), y,
                               o, out_kind};
  return true;
}

template <int BM, bool DUAL, class WL, class XS, bool MASKED>
int launch(const void* x, const void* ig, const void* iu, const void* wg, const void* mg,
           const void* wu, const void* mu, const void* kmask, const void* xs, const void* wsg,
           const void* wsu, const void* bias, const void* rq, void* y, int b, int ke, int k,
           int o, int act, int out_kind, void* stream) {
  const dim3 grid(o / BN, (b + BM - 1) / BM);
  gemm_fp8_kernel<BM, DUAL, WL, XS, MASKED>
      <<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(x), static_cast<const int*>(ig),
          static_cast<const int*>(iu), static_cast<const uint8_t*>(wg),
          static_cast<const uint8_t*>(mg), static_cast<const uint8_t*>(wu),
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
  const bool raw = out_kind == OUT_RAW;
  if (raw != (xs == nullptr) || raw != (wsg == nullptr) || (DUAL && raw != (wsu == nullptr)) ||
      (raw && (act != ACT_NONE || bias != nullptr)) || out_kind < 0 || out_kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  // the requantized store needs the consumer's scale, and only it reads one
  if ((out_kind == OUT_E4M3) != (rq != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
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

// K8 fp8's many-row body (nm_spmm_gather/kernel.py::fp8_plan from 256
// rows): a gather pass writes the compact e4m3 X, xg (B, K_c) = gather(X
// (B, K_eff), idx), then tile_gemm_fp8's TMA + wgmma body
// (tile_gemm_sm90_fp8.cuh) contracts it with the values as it contracts a
// dense weight, flushed in the gather order.  The byte counterpart of
// gemm.cu's gather_columns_kernel: thread u writes columns 16 (u % (K_c /
// 16)) .. + 15 of row u / (K_c / 16) as one 16-byte store from the 16-byte
// chunks of their M-blocks (2:4: two, 1:4: four) and spf8::select16 (an
// index outside [0, 4) gives +0): X is read once, coalesced, and xg (half
// of X's bytes at 2:4) goes through L2 to the GEMM.
template <int G>
__global__ void __launch_bounds__(256)
gather_columns_e4m3_kernel(const uint8_t* __restrict__ x, const int* __restrict__ idx,
                           uint8_t* __restrict__ xg, int b, int kc) {
  const int per_row = kc / 16;
  const long long u = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (u >= static_cast<long long>(b) * per_row) return;
  const int row = static_cast<int>(u / per_row), j0 = static_cast<int>(u % per_row) * 16;
  const uint4* src =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * (kc / G * 4) + j0 / G * 4);
  uint32_t wd[16 / G];
#pragma unroll
  for (int c = 0; c < 4 / G; ++c) {
    const uint4 v = __ldg(src + c);
    wd[4 * c] = v.x;
    wd[4 * c + 1] = v.y;
    wd[4 * c + 2] = v.z;
    wd[4 * c + 3] = v.w;
  }
  int e[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx + j0) + c);
    e[4 * c] = q.x;
    e[4 * c + 1] = q.y;
    e[4 * c + 2] = q.z;
    e[4 * c + 3] = q.w;
  }
  *reinterpret_cast<uint4*>(xg + static_cast<size_t>(row) * kc + j0) = spf8::select16<G>(wd, e);
}

#if VG_HAS_PART(2)
// the pass into the caller's scratch xg (n in {1, 2}, K_c = ke * n / 4 a
// multiple of 64), then the wgmma body with the ws-first flush
int gather_then_wgmma(int n, const void* x, const void* values, const void* idx, void* xg,
                      const SingleFlushT<true>& flush, int b, int ke, int o, void* stream) {
  if (b <= 0 || ke <= 0 || o <= 0 || (n != 1 && n != 2) || (ke * n) % 4 != 0 ||
      (ke * n / 4) % BK != 0 || xg == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = static_cast<long long>(b) * (kc / 16);
  const int blocks = static_cast<int>((units + 255) / 256);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const int* gi = static_cast<const int*>(idx);
  uint8_t* gb = static_cast<uint8_t*>(xg);
  if (n == 2) gather_columns_e4m3_kernel<2><<<blocks, 256, 0, s>>>(xb, gi, gb, b, kc);
  else gather_columns_e4m3_kernel<1><<<blocks, 256, 0, s>>>(xb, gi, gb, b, kc);
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return tgf8::launch(xg, values, flush, b, kc, o, stream);
}

#endif  // VG_HAS_PART(2)

}  // namespace

// Plain C interface (loaded with ctypes), the signatures of gemm_int8.cu's.
// Every function launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernels do not take).  out_kind: 0 bf16, 1 fp32 (scaled,
// xs/ws given), 2 fp32 raw accumulator (no scales), 3 e4m3 requantized
// against *rq (rq is given exactly then).  The *_masked functions take the
// (ceil(b / bm), K steps) int32 kmask of block_maps (K / 64, or K_c / 64 for
// gather).
extern "C" {

#if VG_HAS_PART(0)
// tile_gemm/kernel.py::fp8_plan's body: 0, the shared body (bm in {16,
// 64}, bn 64, split 1); 1, the stream over the dense weight
// (nm_spmm_sp_fp8.cuh, N = 4; bm in {16, 64}, bn 64), K split over `split`
// blocks of a cluster (a power of two up to min(8, k / 64)); 2, the wgmma
// body (tile_gemm_sm90_fp8.cuh; bm 128, bn 128, split 1)
int vg_tile_gemm_fp8(const void* x, const void* w, const void* xs, const void* ws,
                     const void* bias, const void* rq, void* y, int b, int k, int o, int act,
                     int out_kind, int bm, int body, int bn, int split, void* stream) {
  if (body == 0) {
    if (bn != 64 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bm<false, DenseLoader>(bm, x, nullptr, nullptr, w, nullptr, nullptr, nullptr,
                                         nullptr, xs, ws, nullptr, bias, rq, y, b, k, k, o, act,
                                         out_kind, stream);
  }
  SingleFlush flush;
  if (!single_flush(xs, ws, bias, rq, y, o, act, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 1 && bn == 64)
    return spf8::launch_nm(4, bm, x, w, nullptr, nullptr, flush, b, k, o, split, stream);
  if (body == 2 && bm == tgf8::BM && bn == tgf8::BN && split == 1)
    return tgf8::launch(x, w, flush, b, k, o, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared body: the first form of tile_gemm_fp8, timed beside the
// current bodies (not on any path: vg_tile_gemm_fp8 reaches the same body
// through its plan)
int vg_tile_gemm_fp8_tiled(const void* x, const void* w, const void* xs, const void* ws,
                           const void* bias, const void* rq, void* y, int b, int k, int o,
                           int act, int out_kind, int bm, void* stream) {
  return launch_bm<false, DenseLoader>(bm, x, nullptr, nullptr, w, nullptr, nullptr, nullptr,
                                       nullptr, xs, ws, nullptr, bias, rq, y, b, k, k, o, act,
                                       out_kind, stream);
}

// tile_gemm/kernel.py::masked_fp8_plan's body: 1, tile_gemm_fp8's stream
// over the dense weight (nm_spmm_sp_fp8.cuh, N = 4, MASKED; bm in {16, 64})
// walking the live steps of each block's span, K split over `split` blocks
// of a cluster (tile_gemm_fp8's split: bitwise vg_tile_gemm_fp8's stream on
// the same masked X); 0, the shared body, split 1
int vg_tile_gemm_masked_fp8(const void* x, const void* w, const void* kmask, const void* xs,
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
  SingleFlush flush;
  if (body != 1 || !single_flush(xs, ws, bias, rq, y, o, act, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_nm(4, bm, x, w, nullptr, kmask, flush, b, k, o, split, stream);
}

// tile_gemm/kernel.py::fp8_dual_plan's body: 0, the shared body (bm in {16,
// 64}, bn 64, split 1); 1, the dual stream over both dense weights
// (nm_spmm_sp_fp8.cuh, DUAL, N = 4; bm in {16, 64}, bn 64), K split over
// `split` blocks of a cluster (a power of two up to min(8, k / 64)); 2, the
// dual wgmma body (tile_gemm_sm90_fp8.cuh, DUAL; bm 128, bn 64 channels of
// each weight, split 1; bf16 or fp32 only).  out_kind 0 | 1 | 3 (no raw
// accumulator).
int vg_tile_gemm_dual_fp8(const void* x, const void* wg, const void* wu, const void* xs,
                          const void* wsg, const void* wsu, const void* rq, void* y, int b,
                          int k, int o, int out_kind, int bm, int body, int bn, int split,
                          void* stream) {
  if (out_kind == OUT_RAW) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (bn != 64 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bm<true, DenseLoader>(bm, x, nullptr, nullptr, wg, nullptr, wu, nullptr,
                                        nullptr, xs, wsg, wsu, nullptr, rq, y, b, k, k, o,
                                        ACT_NONE, out_kind, stream);
  }
  DualFlush flush;
  if (!dual_flush(xs, wsg, wsu, rq, y, o, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 1 && bn == 64)
    return spf8::launch_dual(4, bm, x, wg, nullptr, wu, nullptr, flush, b, k, o, split, stream);
  if (body == 2 && bm == tgf8::BM && bn == tgf8::DUAL_BN && split == 1 && out_kind != OUT_E4M3)
    return tgf8::launch_dual(x, wg, wu, flush, b, k, o, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared body: the first form of tile_gemm_dual_fp8, timed beside the
// current bodies (not on any path: vg_tile_gemm_dual_fp8 reaches the same
// body through its plan)
int vg_tile_gemm_dual_fp8_tiled(const void* x, const void* wg, const void* wu, const void* xs,
                                const void* wsg, const void* wsu, const void* rq, void* y,
                                int b, int k, int o, int out_kind, int bm, void* stream) {
  if (out_kind == OUT_RAW) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bm<true, DenseLoader>(bm, x, nullptr, nullptr, wg, nullptr, wu, nullptr,
                                      nullptr, xs, wsg, wsu, nullptr, rq, y, b, k, k, o,
                                      ACT_NONE, out_kind, stream);
}

#endif  // VG_HAS_PART(0)

#if VG_HAS_PART(1)
// nm_spmm/kernel.py::fp8_plan's body: 1, the sparse-tensor-core body
// (nm_spmm_sp_fp8.cuh, n in {1, 2}), K split over `split` blocks of a
// cluster (a power of two up to min(8, k / 64)); 0, the shared body at any
// n, split 1
int vg_nm_spmm_fp8(const void* x, const void* values, const void* meta, const void* xs,
                   const void* ws, const void* bias, const void* rq, void* y, int b, int k,
                   int o, int n, int act, int out_kind, int bm, int body, int split,
                   void* stream) {
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nm<false>(n, bm, x, values, meta, nullptr, nullptr, nullptr, xs, ws, nullptr,
                            bias, rq, y, b, k, o, act, out_kind, stream);
  }
  SingleFlush flush;
  if (body != 1 || (n != 1 && n != 2) ||
      !single_flush(xs, ws, bias, rq, y, o, act, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_nm(n, bm, x, values, meta, nullptr, flush, b, k, o, split, stream);
}

// the shared body at any n: the first form of nm_spmm_fp8, timed beside the
// current bodies (not on any path: vg_nm_spmm_fp8 reaches the same body
// through its plan)
int vg_nm_spmm_fp8_tiled(const void* x, const void* values, const void* meta, const void* xs,
                         const void* ws, const void* bias, const void* rq, void* y, int b,
                         int k, int o, int n, int act, int out_kind, int bm, void* stream) {
  return launch_nm<false>(n, bm, x, values, meta, nullptr, nullptr, nullptr, xs, ws, nullptr,
                          bias, rq, y, b, k, o, act, out_kind, stream);
}

// nm_spmm/kernel.py::fp8_plan's body, as vg_nm_spmm_fp8 takes it: 1, the
// sparse-tensor-core body (nm_spmm_sp_fp8.cuh, MASKED; n in {1, 2}) walking
// the live steps of each block's span, K split over `split` blocks of a
// cluster (nm_spmm_fp8's split: bitwise vg_nm_spmm_fp8 on the same masked
// X); 0, the shared body at any n, split 1
int vg_nm_spmm_masked_fp8(const void* x, const void* values, const void* meta,
                          const void* kmask, const void* xs, const void* ws, const void* bias,
                          const void* rq, void* y, int b, int k, int o, int n, int act,
                          int out_kind, int bm, int body, int split, void* stream) {
  if (kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nm<false, true>(n, bm, x, values, meta, nullptr, nullptr, kmask, xs, ws,
                                  nullptr, bias, rq, y, b, k, o, act, out_kind, stream);
  }
  SingleFlush flush;
  if (body != 1 || (n != 1 && n != 2) ||
      !single_flush(xs, ws, bias, rq, y, o, act, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_nm(n, bm, x, values, meta, kmask, flush, b, k, o, split, stream);
}

// nm_spmm/kernel.py::fp8_dual_plan's body: 1, the sparse dual stream
// (nm_spmm_sp_fp8.cuh, DUAL; n in {1, 2}, bm in {16, 64}), K split over
// `split` blocks of a cluster (a power of two up to min(8, k / 64)); 0, the
// shared body at any n, split 1.  out_kind 0 | 1 | 3 (no raw accumulator).
int vg_nm_spmm_dual_fp8(const void* x, const void* values_g, const void* meta_g,
                        const void* values_u, const void* meta_u, const void* xs,
                        const void* wsg, const void* wsu, const void* rq, void* y, int b,
                        int k, int o, int n, int out_kind, int bm, int body, int split,
                        void* stream) {
  if (out_kind == OUT_RAW) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nm<true>(n, bm, x, values_g, meta_g, values_u, meta_u, nullptr, xs, wsg, wsu,
                           nullptr, rq, y, b, k, o, ACT_NONE, out_kind, stream);
  }
  DualFlush flush;
  if (body != 1 || (n != 1 && n != 2) || !dual_flush(xs, wsg, wsu, rq, y, o, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_dual(n, bm, x, values_g, meta_g, values_u, meta_u, flush, b, k, o, split,
                           stream);
}

// the shared body at any n: the first form of nm_spmm_dual_fp8, timed
// beside the current bodies (not on any path: vg_nm_spmm_dual_fp8 reaches
// the same body through its plan)
int vg_nm_spmm_dual_fp8_tiled(const void* x, const void* values_g, const void* meta_g,
                              const void* values_u, const void* meta_u, const void* xs,
                              const void* wsg, const void* wsu, const void* rq, void* y, int b,
                              int k, int o, int n, int out_kind, int bm, void* stream) {
  if (out_kind == OUT_RAW) return static_cast<int>(cudaErrorInvalidValue);
  return launch_nm<true>(n, bm, x, values_g, meta_g, values_u, meta_u, nullptr, xs, wsg, wsu,
                         nullptr, rq, y, b, k, o, ACT_NONE, out_kind, stream);
}

#endif  // VG_HAS_PART(1)

#if VG_HAS_PART(2)
// k is K_eff (X's width); the kernel contracts K_c = k * n / 4 rows of
// values.  nm_spmm_gather/kernel.py::fp8_plan's body: 0, the shared body
// (any n; bm in {16, 64}, bn 64, split 1); 1, the e4m3 stream over the
// values with the gathered X (nm_spmm_sp_fp8.cuh, G = n; n in {1, 2}, bm in
// {16, 64}, bn 64), K_c split over `split` blocks of a cluster; 2, the
// e4m3 gather pass into `scratch` (B, K_c) bytes, then tile_gemm_fp8's
// wgmma body over it (n in {1, 2}, bm 128, bn 128, split 1).  The own
// bodies flush in the gather order, acc * ws * xs.  scratch is read only by
// body 2.
int vg_nm_spmm_gather_bk_fp8(const void* x, const void* values, const void* idx,
                             const void* xs, const void* ws, const void* bias, const void* rq,
                             void* y, int b, int k, int o, int n, int act, int out_kind, int bm,
                             int body, int bn, int split, void* scratch, void* stream) {
  if (body == 0) {
    if (bn != 64 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<false>(n, bm, x, values, idx, nullptr, nullptr, nullptr, xs, ws,
                                nullptr, bias, rq, y, b, k, o, act, out_kind, stream);
  }
  SingleFlushT<true> flush;
  if (!single_flush(xs, ws, bias, rq, y, o, act, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 1 && bn == 64)
    return spf8::launch_gather(n, bm, x, values, idx, nullptr, flush, b, k, o, split, stream);
  if (body == 2 && bm == tgf8::BM && bn == tgf8::BN && split == 1)
    return gather_then_wgmma(n, x, values, idx, scratch, flush, b, k, o, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared body at any n: the first form of nm_spmm_gather_bk_fp8, timed
// beside the current bodies (not on any path)
int vg_nm_spmm_gather_bk_fp8_tiled(const void* x, const void* values, const void* idx,
                                   const void* xs, const void* ws, const void* bias,
                                   const void* rq, void* y, int b, int k, int o, int n, int act,
                                   int out_kind, int bm, void* stream) {
  return launch_gather<false>(n, bm, x, values, idx, nullptr, nullptr, nullptr, xs, ws,
                              nullptr, bias, rq, y, b, k, o, act, out_kind, stream);
}

// k is K_eff.  nm_spmm_gather/kernel.py::masked_fp8_plan's body: 1, K8
// fp8's e4m3 gathered stream (nm_spmm_sp_fp8.cuh, G = n, MASKED; n in {1,
// 2}, bm in {16, 64}, the maps' row block) walking the live steps of each
// block's span, K_c split over `split` blocks of a cluster, flushed in the
// gather order, acc * ws * xs (at vg_nm_spmm_gather_bk_fp8's stream tile
// and split: bitwise it on the same masked X); 0, the shared body at any n,
// split 1
int vg_nm_spmm_gather_bk_masked_fp8(const void* x, const void* values, const void* idx,
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
  SingleFlushT<true> flush;
  if (body != 1 || (n != 1 && n != 2) ||
      !single_flush(xs, ws, bias, rq, y, o, act, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_gather(n, bm, x, values, idx, kmask, flush, b, k, o, split, stream);
}

// k is K_eff.  nm_spmm_gather/kernel.py::fp8_dual_plan's body: 1, the e4m3
// stream over both values with one span a step selected twice
// (nm_spmm_sp_fp8.cuh, G = n, DUAL; n in {1, 2}, bm 16), K_c split over
// `split` blocks of a cluster, flushed by DualFlushT<true> (the gather
// order, acc * ws * xs); 0, the shared body (any n; bm 16 | 64, split 1).
// out_kind 0 | 1 | 3 (no raw accumulator).
int vg_nm_spmm_gather_dual_bk_fp8(const void* x, const void* values_g, const void* idx_g,
                                  const void* values_u, const void* idx_u, const void* xs,
                                  const void* wsg, const void* wsu, const void* rq, void* y,
                                  int b, int k, int o, int n, int out_kind, int bm, int body,
                                  int split, void* stream) {
  if (out_kind == OUT_RAW) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<true>(n, bm, x, values_g, idx_g, values_u, idx_u, nullptr, xs, wsg,
                               wsu, nullptr, rq, y, b, k, o, ACT_NONE, out_kind, stream);
  }
  DualFlushT<true> flush;
  if (body != 1 || (n != 1 && n != 2) || !dual_flush(xs, wsg, wsu, rq, y, o, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_gather_dual(n, bm, x, values_g, idx_g, values_u, idx_u, flush, b, k, o,
                                  split, stream);
}

// K11: x_t (k, b) K-major -> y_t (o, b), b a multiple of 16; xs (1, b) and
// ws (o, 1) for out_kind 0 | 1, none for the raw fp32 accumulator (2).
// nm_spmm_gather/kernel.py::kmajor_fp8_plan's body: 1, the e4m3 stream with
// the K-major X stage (nm_spmm_sp_fp8.cuh, KM; n in {1, 2}, bm in {16, 64}),
// K_c split over `split` blocks of a cluster, flushed acc * ws * xs into the
// (O, B) output; 0, the shared body (any n, split 1)
int vg_nm_spmm_gather_fp8(const void* x_t, const void* values, const void* idx,
                          const void* xs, const void* ws, void* y_t, int b, int k, int o,
                          int n, int out_kind, int bm, int body, int split, void* stream) {
  if (out_kind == OUT_E4M3) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<false, false, true>(n, bm, x_t, values, idx, nullptr, nullptr,
                                             nullptr, xs, ws, nullptr, nullptr, nullptr, y_t,
                                             b, k, o, ACT_NONE, out_kind, stream);
  }
  SingleFlushT<true, true> flush;
  if (body != 1 || (n != 1 && n != 2) ||
      !single_flush(xs, ws, nullptr, nullptr, y_t, b, ACT_NONE, out_kind, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  return spf8::launch_kmajor(n, bm, x_t, values, idx, flush, b, k, o, split, stream);
}

// the shared body at any n: the first form of nm_spmm_gather_fp8, timed
// beside the current bodies (not on any path)
int vg_nm_spmm_gather_fp8_tiled(const void* x_t, const void* values, const void* idx,
                                const void* xs, const void* ws, void* y_t, int b, int k, int o,
                                int n, int out_kind, int bm, void* stream) {
  if (out_kind == OUT_E4M3) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gather<false, false, true>(n, bm, x_t, values, idx, nullptr, nullptr, nullptr,
                                           xs, ws, nullptr, nullptr, nullptr, y_t, b, k, o,
                                           ACT_NONE, out_kind, stream);
}

#endif  // VG_HAS_PART(2)

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
