// Hand-written Hopper (sm_90a) kernels for the repro_torch dense and N:M
// sparse GEMMs: tile_gemm, tile_gemm_dual, nm_spmm, nm_spmm_dual, the
// lane-aligned gather pair nm_spmm_gather_bk and nm_spmm_gather_dual_bk,
// the activation-sparsity (K10) variants of the three single GEMMs,
// tile_gemm_masked, nm_spmm_masked and nm_spmm_gather_bk_masked, and the
// K-major gather nm_spmm_gather (K11).
//
// Replaces (JAX package, Pallas on the TPU):
//   tile_gemm       repro/kernels/tile_gemm/kernel.py::tile_gemm      (_gemm_kernel)
//   tile_gemm_dual  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual (_gemm_dual_kernel)
//   nm_spmm         repro/kernels/nm_spmm/kernel.py::nm_spmm          (_spmm_accumulate,
//                   _unpack_meta_tile, _decompress_tile)
//   nm_spmm_dual    repro/kernels/nm_spmm/kernel.py::nm_spmm_dual     (_spmm_dual_kernel)
//   nm_spmm_gather_bk       repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_bk
//                           (_gather_bk_kernel, _gather_step, _gather_contract)
//   nm_spmm_gather_dual_bk  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_dual_bk
//                           (_gather_dual_kernel)
//   tile_gemm_masked        repro/kernels/tile_gemm/kernel.py::tile_gemm_masked
//                           (_gemm_masked_kernel)
//   nm_spmm_masked          repro/kernels/nm_spmm/kernel.py::nm_spmm_masked
//                           (_spmm_masked_kernel)
//   nm_spmm_gather_bk_masked  repro/kernels/nm_spmm_gather/kernel.py::
//                             nm_spmm_gather_bk_masked (_gather_bk_masked_kernel)
//   nm_spmm_gather          repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather
//                           (_gather_kernel, _gather_accumulate)
//
// ONE templated kernel body serves all ten: the template takes the weight
// loader (DenseLoader, or NMLoader<n> for values + 2-bit packed meta), the
// X loader (contiguous, gathered through the lane-aligned index, or
// gathered from K-major X), single or dual (gate-up, two weights against
// one X read), and MASKED.
//
// K-major gather (K11, nm_spmm_gather).  Y_t (O, B) = gather(x_t)^T-contract
// values: X arrives transposed, x_t (K_eff, B) with the batch contiguous,
// and the output leaves transposed, (O, B), as the TPU kernel's K-major
// layout has it (the sharded row-parallel path hands it xq.T).  The loader
// reads, for compressed row c of the step and the block's batch columns,
// row (c / n) * 4 + idx[c] of x_t: 8 consecutive batch values per 16-byte
// load, then transposes them into the [BM][XLD] X tile the mma path reads,
// so the tensor-core loop and the flush are the other kernels'; the flush
// stores column-wise into (O, B).  Bound: the same values bytes as K8.
// A simple first form: the index load precedes its X load (no overlap) and
// the transpose is 2-byte shared stores.
//
// Activation sparsity (MASKED, single GEMMs).  The masked X of a MoE
// expert's w_out holds whole zero (row block, K step) tiles; kmask
// (block_maps over X at this kernel's blocks: BM rows, 64 weight rows per
// step) marks the live ones.  The block zero-fills its accumulators
// unconditionally and walks only its row block's live steps (kmask.cuh):
// a dead step is neither loaded, nor prefetched as the next step, nor
// multiplied.  A dead tile of X contributes exact zeros to the fp32 sum,
// so the output is bitwise the unmasked kernel's on the same X, and a row
// block with no live step still flushes (bias and activation of a zero
// accumulator).  Bound: the live tiles' weight bytes.
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
// nm_spmm at n in {1, 2} (the float single) runs its own body on the
// sparse tensor cores, nm_spmm_sp.cuh (mma.sp, K split across a cluster);
// tile_gemm (K1) runs the same streaming body over the dense weight at few
// rows and tile_gemm_sm90.cuh's TMA + wgmma body at many, as
// tile_gemm/kernel.py's planner picks; nm_spmm_gather_bk (K8) at n in {1,
// 2} runs those two bodies over its dense values with the X side gathered
// (the stream selecting each step's X tile; from 256 rows a gather pass in
// front of the wgmma body, gather_then_k1 below), as
// nm_spmm_gather/kernel.py::plan picks.  The float gate-up duals run the
// dual forms of those two bodies (both weights' tiles a stage, two
// accumulators, one silu(g) * u flush), as the dual_plans pick:
// tile_gemm_dual over its dense weights, nm_spmm_gather_dual_bk (K9) at n
// in {1, 2} with one X span a step selected twice in the stream and, in
// front of the wgmma body, one gather pass writing both compact X's
// (gather_dual_then_wgmma below).  vg_nm_spmm_tiled, vg_tile_gemm_tiled,
// vg_nm_spmm_gather_bk_tiled, vg_tile_gemm_dual_tiled and
// vg_nm_spmm_gather_dual_bk_tiled keep the shared body below for them, the
// forms the port ran first, as yardsticks.  nm_spmm_dual at n in {1, 2}
// runs the stream's compressed dual form where nm_spmm/kernel.py::dual_plan
// picks it, the bf16 nm_spmm_masked at n in {1, 2} the stream's MASKED
// form, the bf16 tile_gemm_masked below 256 rows K1's stream in MASKED
// form, and the bf16 nm_spmm_gather_bk_masked at 2:4 K8's gathered stream
// in MASKED form wherever K8 streams (vg_nm_spmm_dual_tiled and
// vg_nm_spmm_masked_tiled keep their shared bodies as yardsticks;
// vg_tile_gemm_masked and vg_nm_spmm_gather_bk_masked reach theirs at body
// 0, split 1).  nm_spmm and nm_spmm_dual at n = 4, nm_spmm_masked at n = 4,
// tile_gemm_masked from 256 rows, nm_spmm_gather_bk_masked where K8 leaves
// the stream, K8 and K9 at n = 4 and K11 stay on the shared body.
//
// N:M weights.  The loader reads the values tile (64*n/4 rows) and the
// packed meta tile (64*n/16 rows, four 2-bit in-block indices per byte,
// low bits first) and expands them into the dense 64 x 64 bf16 tile in
// shared memory: w[(r/n)*4 + idx(r), o] = values[r, o].  The dense weight
// never exists in device memory.
//
// Lane-aligned gather (nm_spmm_gather).  All O channels share one in-block
// index per compressed row, so the kernel contracts over K_c = K*n/4
// instead of expanding the weight: the weight tile is a plain dense tile
// of values (K_c, O), and the X tile's column j at K step k0 is X column
// ((k0 + j) / n) * 4 + idx[k0 + j] -- the TPU kernel's sublane
// compare-and-select and its VMEM transposes become 16-byte loads of the
// step's X span and a select in registers.  n/4 of the dense weight bytes, n/4 of the FLOPs and n/4 as many
// serial K steps.  The dual gathers X twice (gate and up keep their own
// index streams) into two X tiles.
//
// What bounds it on an H100.  At decode (B = slots = 8) every weight byte
// is read once for 16 flops per bf16 pair, far below the ~295 flop/byte
// ridge, so the weight bytes over 3.35 TB/s bound it: w_out at K=8192,
// O=2048 moves 33.6 MB dense (10.0 us) and 18.9 MB at 2:4 (values 16.8 MB
// + meta 2.1 MB, 5.6 us), 16.8 MB in the gather layout (values + 8 KB of
// index).  Prefill chunks (B <= 64) are still bandwidth-bound.  What the
// design does about it: the N:M loader moves n/4 of the dense weight
// bytes plus 2 bits per kept value and expands on chip, the gather loader
// moves n/4 of them and no expansion, weight loads are 16-byte vector
// loads along O (coalesced rows), and the register prefetch of the next
// K step overlaps the loads with the tensor-core work.  Launch width is
// O/64 blocks, too few to keep the card's memory system busy at decode
// for O <= 2048 (the streaming body of nm_spmm and tile_gemm splits K for
// that): split-K, TMA rings and wgmma in this shared body are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flush.cuh"
#include "kmask.cuh"
#include "nm_spmm_sp.cuh"
#include "tile_gemm_sm90.cuh"

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
// 16 rows; rows at or beyond B read as zero.  ke is X's row stride.
template <int BM>
struct XLoader {
  static constexpr bool kGather = false;
  static constexpr bool kKMajor = false;
  const __nv_bfloat16* x;
  const int* unused_idx[2];
  int b, ke;
  uint4 r[BM / 16];

  __device__ __forceinline__ void load(int k0, int m0, int tid) {
    const int c = k0 + (tid & 7) * 8;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int row = m0 + (tid >> 3) + 16 * i;
      r[i] = row < b ? *reinterpret_cast<const uint4*>(x + (size_t)row * ke + c)
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

// The 2N (bf16) or 4N (one-byte types) indices of a chunk's M-blocks, as
// 8- or 16-byte vector loads (idx is 16-byte aligned, every chunk's first
// index a multiple of 2N).
template <int C>
__device__ __forceinline__ void load_indices(int (&d)[C], const int* p) {
  if constexpr (C == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int4 v = reinterpret_cast<const int4*>(p)[q];
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
  }
}

// Candidate i of an M-block of four bf16 held in two words; an index
// outside [0, 4) selects +0, as the TPU kernel's compare-and-select does.
__device__ __forceinline__ uint32_t pick16(uint32_t lo, uint32_t hi, int i) {
  return static_cast<unsigned>(i) < 4u ? ((i < 2 ? lo : hi) >> (16 * (i & 1))) & 0xffffu : 0u;
}

// Gathered X tile (nm_spmm_gather, M = 4): column j of the tile at K step
// k0 is compressed row c = k0 + j, which reads X column (c / N) * 4 +
// idx[c] of the K_eff = ke columns.  The step's kept columns lie in a
// span of 64 * 4 / N X columns; each thread loads whole 16-byte chunks of
// it (two M-blocks, 8 candidates) with one vector load, and the 2N
// indices of those blocks (of both streams for a dual: gate and up share
// the span), and selects the kept values only at the store: nothing in
// load() waits on a load, so the weight loads issued after it never
// stall.  NTHREADS is a multiple of the chunks per row, so a thread keeps
// one chunk column (and its indices) for all its rows.
template <int BM, int N, bool TWO>
struct GatherXLoader {
  static constexpr bool kGather = true;
  static constexpr bool kKMajor = false;
  static constexpr int CPR = 32 / N;                    // chunks per row per step
  static constexpr int NI = BM * CPR / NTHREADS;        // chunks per thread
  const __nv_bfloat16* x;
  const int* idx[2];   // gate (and, for a dual, up): one index stream each
  int b, ke;
  uint4 r[NI];
  int iv[TWO ? 2 : 1][2 * N];

  __device__ __forceinline__ void load(int k0, int m0, int tid) {
    const int ch = tid % CPR;
    load_indices(iv[0], idx[0] + k0 + 2 * N * ch);
    if constexpr (TWO) load_indices(iv[1], idx[1] + k0 + 2 * N * ch);
    const int c = (k0 / N) * 4 + 8 * ch;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int row = m0 + (tid + NTHREADS * i) / CPR;
      r[i] = row < b ? *reinterpret_cast<const uint4*>(x + (size_t)row * ke + c)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the kept values of index STREAM (0: gate, 1: up) into the X tile xs
  template <int STREAM = 0>
  __device__ __forceinline__ void store(__nv_bfloat16* xs, int tid) const {
    const int ch = tid % CPR;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int rl = (tid + NTHREADS * i) / CPR;
      uint32_t out[N];
#pragma unroll
      for (int q = 0; q < N; ++q) out[q] = 0u;
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        const uint32_t lo = word_of(r[i], 2 * blk), hi = word_of(r[i], 2 * blk + 1);
#pragma unroll
        for (int s = 0; s < N; ++s) {
          const int p = blk * N + s;
          out[p / 2] |= pick16(lo, hi, iv[STREAM][p]) << (16 * (p % 2));
        }
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(xs + rl * XLD + 2 * N * ch);
#pragma unroll
      for (int q = 0; q < N; ++q) dst[q] = out[q];
    }
  }
};

// K-major gathered X tile (K11): x_t is (K_eff, B), b its row stride.  Load
// q of the step's BK x BM/8 16-byte loads reads compressed row c = k0 + q %
// BK, batch columns m0 + (q / BK) * 8 .. + 7, from x_t row (c / N) * 4 +
// idx[c] (an index outside [0, 4) selects zeros, as the TPU kernel's
// compare-and-select does); the store writes the 8 values down column q %
// BK of the [BM][XLD] tile.  B is a multiple of 16 (the wrapper checks it),
// so a load lies wholly inside or outside the batch.
template <int BM, int N>
struct KMajorGatherXLoader {
  static constexpr bool kGather = true;
  static constexpr bool kKMajor = true;
  static constexpr int NI = BK * (BM / 8) / NTHREADS;   // loads per thread
  const __nv_bfloat16* x;
  const int* idx[2];
  int b, ke;
  uint4 r[NI];

  __device__ __forceinline__ void load(int k0, int m0, int tid) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int q = tid + NTHREADS * i;
      const int c = k0 + q % BK;
      const int col = m0 + (q / BK) * 8;
      const int sel = idx[0][c];
      r[i] = (col < b && static_cast<unsigned>(sel) < 4u)
                 ? *reinterpret_cast<const uint4*>(x + (size_t)((c / N) * 4 + sel) * b + col)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int STREAM = 0>
  __device__ __forceinline__ void store(__nv_bfloat16* xs, int tid) const {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int q = tid + NTHREADS * i;
      const int j = q % BK, r0 = (q / BK) * 8;
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&r[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[(r0 + e) * XLD + j] = v[e];
    }
  }
};

// The X-loader template argument of the kernel: contiguous rows, the
// lane-aligned gather at N:4, or that gather from K-major X (single only).
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

template <int BM, bool DUAL, class WL, class XS, bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ig,
            const int* __restrict__ iu,
            const __nv_bfloat16* __restrict__ wg, const uint8_t* __restrict__ mg,
            const __nv_bfloat16* __restrict__ wu, const uint8_t* __restrict__ mu,
            const int* __restrict__ kmask, const float* __restrict__ bias,
            void* __restrict__ y, int b, int ke, int k, int o, int act, int out_f32) {
  using XL = typename XS::template Loader<BM, DUAL>;
  static_assert(!(DUAL && XL::kKMajor), "the K-major gather is a single GEMM");
  // a gathered dual selects X through two index streams: two X tiles
  constexpr int NX = (DUAL && XL::kGather) ? 2 : 1;
  constexpr int MF = BM / 16;
  constexpr int NW = DUAL ? 2 : 1;
  constexpr int LOAD_BYTES = (NX * BM * XLD + NW * BK * WLD) * 2;
  constexpr int FLUSH_BYTES = NW * BM * CLD * 4;
  constexpr int SMEM = LOAD_BYTES > FLUSH_BYTES ? LOAD_BYTES : FLUSH_BYTES;
  // the staging tiles and, after the K loop, the fp32 flush tiles alias
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ LiveSteps<NTHREADS> live;   // MASKED only
  __nv_bfloat16* xs_g = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs_u = xs_g + (NX - 1) * BM * XLD;
  __nv_bfloat16* ws_g = xs_g + NX * BM * XLD;
  __nv_bfloat16* ws_u = ws_g + BK * WLD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  XL xl{x, {ig, iu}, b, ke};
  WL lg{wg, mg, o};
  WL lu{wu, mu, o};

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_g[MF];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_u[DUAL ? MF : 1];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    wmma::fill_fragment(acc_g[i], 0.0f);
    if constexpr (DUAL) wmma::fill_fragment(acc_u[i], 0.0f);
  }

  // K steps: all of them, or (MASKED) the live steps of this row block
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
    xl.store(xs_g, tid);
    if constexpr (NX == 2) xl.template store<1>(xs_u, tid);
    lg.store(ws_g, tid);
    if constexpr (DUAL) lu.store(ws_u, tid);
    __syncthreads();
    int sn = s + 1;
    if constexpr (MASKED) sn = live.next(sn, nk);
    if (sn < nk) {   // next step's tiles travel while this one computes
      xl.load(sn * BK, m0, tid);
      lg.load(sn * BK, n0, tid);
      if constexpr (DUAL) lu.load(sn * BK, n0, tid);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bg, bu;
      wmma::load_matrix_sync(bg, ws_g + kk * WLD + warp * 16, WLD);
      if constexpr (DUAL) wmma::load_matrix_sync(bu, ws_u + kk * WLD + warp * 16, WLD);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs_g + i * 16 * XLD + kk, XLD);
        wmma::mma_sync(acc_g[i], a, bg, acc_g[i]);
        if constexpr (NX == 2) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_u;
          wmma::load_matrix_sync(a_u, xs_u + i * 16 * XLD + kk, XLD);
          wmma::mma_sync(acc_u[i], a_u, bu, acc_u[i]);
        } else if constexpr (DUAL) {
          wmma::mma_sync(acc_u[i], a, bu, acc_u[i]);
        }
      }
    }
    __syncthreads();
    s = sn;
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
    // K-major: walk the batch fastest, the (O, B) output's contiguous dim
    const int r = XL::kKMajor ? e % BM : e / BN;
    const int c = XL::kKMajor ? e / BM : e % BN;
    const int row = m0 + r;
    if (row >= b) continue;
    float v = cs_g[r * CLD + c];
    if constexpr (DUAL) {
      v = silu(v) * cs_u[r * CLD + c];
    } else {
      if (bias != nullptr) v += bias[n0 + c];
      v = apply_act(v, act);
    }
    const size_t at = XL::kKMajor ? (size_t)(n0 + c) * b + row : (size_t)row * o + n0 + c;
    if (out_f32) static_cast<float*>(y)[at] = v;
    else static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
  }
}

template <int BM, bool DUAL, class WL, class XS, bool MASKED>
int launch(const void* x, const void* ig, const void* iu, const void* wg, const void* mg,
           const void* wu, const void* mu, const void* kmask, const void* bias, void* y,
           int b, int ke, int k, int o, int act, void* stream, int out_f32) {
  const dim3 grid(o / BN, (b + BM - 1) / BM);
  gemm_kernel<BM, DUAL, WL, XS, MASKED>
      <<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(ig),
          static_cast<const int*>(iu), static_cast<const __nv_bfloat16*>(wg),
          static_cast<const uint8_t*>(mg), static_cast<const __nv_bfloat16*>(wu),
          static_cast<const uint8_t*>(mu), static_cast<const int*>(kmask),
          static_cast<const float*>(bias), y, b, ke, k, o, act, out_f32);
  return static_cast<int>(cudaGetLastError());
}

// ke: X's row stride (K_eff); k: the contraction the weight rows run over
// (K_eff, or K_c for the gather loaders).  MASKED: single GEMMs only, with
// the (ceil(b / bm), k / 64) kmask of block_maps.  out_f32: store fp32
// (the raw sums a row-parallel shard all-reduces), else bf16.
template <bool DUAL, class WL, class XS = Contiguous, bool MASKED = false>
int launch_bm(int bm, const void* x, const void* ig, const void* iu, const void* wg,
              const void* mg, const void* wu, const void* mu, const void* kmask,
              const void* bias, void* y, int b, int ke, int k, int o, int act,
              void* stream, int out_f32 = 0) {
  static_assert(!(MASKED && DUAL), "the masked kernels are single GEMMs");
  if (b <= 0 || ke <= 0 || k <= 0 || o <= 0 || k % BK != 0 || o % BN != 0 || act < 0 ||
      act > 2 || out_f32 < 0 || out_f32 > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (MASKED != (kmask != nullptr) || (MASKED && k / BK > MAX_K_STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16)
    return launch<16, DUAL, WL, XS, MASKED>(x, ig, iu, wg, mg, wu, mu, kmask, bias, y, b, ke,
                                            k, o, act, stream, out_f32);
  if (bm == 64)
    return launch<64, DUAL, WL, XS, MASKED>(x, ig, iu, wg, mg, wu, mu, kmask, bias, y, b, ke,
                                            k, o, act, stream, out_f32);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool DUAL, bool MASKED = false>
int launch_nm(int n, int bm, const void* x, const void* vg, const void* mg, const void* vu,
              const void* mu, const void* kmask, const void* bias, void* y, int b, int k,
              int o, int act, void* stream, int out_f32 = 0) {
  if (n == 1)
    return launch_bm<DUAL, NMLoader<1>, Contiguous, MASKED>(
        bm, x, nullptr, nullptr, vg, mg, vu, mu, kmask, bias, y, b, k, k, o, act, stream,
        out_f32);
  if (n == 2)
    return launch_bm<DUAL, NMLoader<2>, Contiguous, MASKED>(
        bm, x, nullptr, nullptr, vg, mg, vu, mu, kmask, bias, y, b, k, k, o, act, stream,
        out_f32);
  if (n == 4)
    return launch_bm<DUAL, NMLoader<4>, Contiguous, MASKED>(
        bm, x, nullptr, nullptr, vg, mg, vu, mu, kmask, bias, y, b, k, k, o, act, stream,
        out_f32);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the lane-aligned gather: X (B, ke) gathered to K_c = ke * n / 4 columns,
// contracted against the dense values tile (K_c, O); KMAJOR: X is x_t (ke,
// B), the output (O, B), b a multiple of 16
template <bool DUAL, bool MASKED = false, bool KMAJOR = false>
int launch_gather(int n, int bm, const void* x, const void* vg, const void* ig,
                  const void* vu, const void* iu, const void* kmask, const void* bias, void* y,
                  int b, int ke, int o, int act, void* stream, int out_f32 = 0) {
  if (ke <= 0 || (ke * n) % 4 != 0 || (KMAJOR && b % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  if (n == 1)
    return launch_bm<DUAL, DenseLoader,
                     std::conditional_t<KMAJOR, GatheredKMajor<1>, Gathered<1>>, MASKED>(
        bm, x, ig, iu, vg, nullptr, vu, nullptr, kmask, bias, y, b, ke, kc, o, act, stream,
        out_f32);
  if (n == 2)
    return launch_bm<DUAL, DenseLoader,
                     std::conditional_t<KMAJOR, GatheredKMajor<2>, Gathered<2>>, MASKED>(
        bm, x, ig, iu, vg, nullptr, vu, nullptr, kmask, bias, y, b, ke, kc, o, act, stream,
        out_f32);
  if (n == 4)
    return launch_bm<DUAL, DenseLoader,
                     std::conditional_t<KMAJOR, GatheredKMajor<4>, Gathered<4>>, MASKED>(
        bm, x, ig, iu, vg, nullptr, vu, nullptr, kmask, bias, y, b, ke, kc, o, act, stream,
        out_f32);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8's many-row body (nm_spmm_gather/kernel.py::plan from 256 rows): a
// gather pass writes the compact X, xg (B, K_c) = gather(X (B, K_eff), idx),
// then K1's TMA + wgmma body (tile_gemm_sm90.cuh) contracts it with the
// values as it contracts a dense weight.  Thread u of the pass writes
// columns 8 (u % (K_c / 8)) .. + 7 of row u / (K_c / 8) as one 16-byte
// store, from the 16-byte chunks of their M-blocks (2:4: two chunks, 1:4:
// four) and sp::pick_half's select (an index outside [0, 4) gives +0): X is
// read once, coalesced, and xg (half of X's bytes at 2:4) goes through L2
// to the GEMM.  Two fused forms were measured first on an H100 and were
// slower at every timed shape: the consumers selecting their A fragments in
// registers from a TMA-loaded span (wgmma with A from registers; the span
// is twice the gathered bytes at 2:4, and the ring held 3 stages of it),
// and warps of the producer selecting the A tile into shared memory.
// TWO (K9's pass): the unit's chunks are read once and selected twice,
// through idx and idx_u, into xg (B, 2 K_c): the gate's compact X in columns
// [0, K_c), the up's in [K_c, 2 K_c) -- the TPU kernel's promise that X
// crosses HBM once.
template <int G, bool TWO = false>
__global__ void __launch_bounds__(256)
gather_columns_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
                      const int* __restrict__ idx_u, __nv_bfloat16* __restrict__ xg, int b,
                      int kc) {
  const int per_row = kc / 8;
  const long long u = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (u >= static_cast<long long>(b) * per_row) return;
  const int row = static_cast<int>(u / per_row), j0 = static_cast<int>(u % per_row) * 8;
  const uint4* src =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * (kc / G * 4) + j0 / G * 4);
  uint32_t w[16 / G];
#pragma unroll
  for (int c = 0; c < 4 / G; ++c) {
    const uint4 v = __ldg(src + c);
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int t = 0; t < (TWO ? 2 : 1); ++t) {
    const int* ix = t ? idx_u : idx;
    const int4 i0 = __ldg(reinterpret_cast<const int4*>(ix + j0));
    const int4 i1 = __ldg(reinterpret_cast<const int4*>(ix + j0 + 4));
    const int e[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
    uint32_t out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (G == 2)      // the pair's M-block: words 2q, 2q + 1
        out[q] = sp::pick_half(w[2 * q], w[2 * q + 1], e[2 * q], 0) |
                 sp::pick_half(w[2 * q], w[2 * q + 1], e[2 * q + 1], 1);
      else                       // blocks 2q, 2q + 1: words 4q .. + 3
        out[q] = sp::pick_half(w[4 * q], w[4 * q + 1], e[2 * q], 0) |
                 sp::pick_half(w[4 * q + 2], w[4 * q + 3], e[2 * q + 1], 1);
    }
    *reinterpret_cast<uint4*>(xg + static_cast<size_t>(row) * (TWO ? 2 * kc : kc) + t * kc +
                              j0) = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// The pass into the caller's scratch xg: one thread a 16-byte unit of each
// compact X; idx_u == nullptr writes one (B, K_c), else both into (B, 2 K_c)
int gather_pass(int n, const void* x, const void* idx, const void* idx_u, void* xg, int b,
                int kc, cudaStream_t s) {
  const long long units = static_cast<long long>(b) * (kc / 8);
  const int blocks = static_cast<int>((units + 255) / 256);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int* gi = static_cast<const int*>(idx);
  const int* ui = static_cast<const int*>(idx_u);
  __nv_bfloat16* gb = static_cast<__nv_bfloat16*>(xg);
  if (ui == nullptr) {
    if (n == 2) gather_columns_kernel<2><<<blocks, 256, 0, s>>>(xb, gi, ui, gb, b, kc);
    else gather_columns_kernel<1><<<blocks, 256, 0, s>>>(xb, gi, ui, gb, b, kc);
  } else {
    if (n == 2) gather_columns_kernel<2, true><<<blocks, 256, 0, s>>>(xb, gi, ui, gb, b, kc);
    else gather_columns_kernel<1, true><<<blocks, 256, 0, s>>>(xb, gi, ui, gb, b, kc);
  }
  return static_cast<int>(cudaGetLastError());
}

// n in {1, 2}, K_c = ke * n / 4 a multiple of 64, a scratch given
bool gather_pass_ok(int n, int b, int ke, int o, const void* xg) {
  return b > 0 && ke > 0 && o > 0 && (n == 1 || n == 2) && (ke * n) % 4 == 0 &&
         (ke * n / 4) % BK == 0 && xg != nullptr;
}

// the pass, then K1's body with bn channels a tile
int gather_then_k1(int n, int bn, const void* x, const void* values, const void* idx, void* xg,
                   const void* bias, void* y, int b, int ke, int o, int act, int out_f32,
                   void* stream) {
  if (!gather_pass_ok(n, b, ke, o, xg)) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  const int e = gather_pass(n, x, idx, nullptr, xg, b, kc, static_cast<cudaStream_t>(stream));
  if (e != 0) return e;
  return tg::launch_bn(bn, xg, values, bias, y, b, kc, o, act, out_f32, stream);
}

// K9's many-row body (nm_spmm_gather/kernel.py::dual_plan's wgmma): one pass
// writes both compact X's into xg (B, 2 K_c), then the dual wgmma body
// (tile_gemm_sm90.cuh) with two X tiles a stage
int gather_dual_then_wgmma(int n, const void* x, const void* vg, const void* ig, const void* vu,
                           const void* iu, void* xg, void* y, int b, int ke, int o,
                           void* stream) {
  if (!gather_pass_ok(n, b, ke, o, xg)) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  const int e = gather_pass(n, x, ig, iu, xg, b, kc, static_cast<cudaStream_t>(stream));
  if (e != 0) return e;
  return tg::launch_dual(2, xg, vg, vu, y, b, kc, o, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function launches on the
// given stream, allocates nothing, and returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernels do not take).
// The *_masked functions take the (ceil(b / bm), K steps) int32 kmask of
// block_maps (K steps of 64 weight rows: K / 64, or K_c / 64 for gather).
// out_f32 (the three plain singles and K11): 1 stores fp32, 0 bf16.
extern "C" {

// tile_gemm/kernel.py's plan: bm in {16, 64} streams the weight through
// nm_spmm_sp.cuh's body (N = 4), K split over `split` blocks of a cluster;
// bm = 128 is tile_gemm_sm90.cuh's wgmma body with `bn` channels a tile
// (128 | 256), split 1
int vg_tile_gemm(const void* x, const void* w, const void* bias, void* y, int b, int k,
                 int o, int act, int out_f32, int bm, int bn, int split, void* stream) {
  if (bm == tg::BM) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return tg::launch_bn(bn, x, w, bias, y, b, k, o, act, out_f32, stream);
  }
  if (bn != 64) return static_cast<int>(cudaErrorInvalidValue);
  return sp::launch_nm(4, bm, x, w, nullptr, nullptr, bias, y, b, k, o, act, out_f32, split,
                       stream);
}

// the shared body: the first form of tile_gemm, timed beside the current
// bodies (not on any path)
int vg_tile_gemm_tiled(const void* x, const void* w, const void* bias, void* y, int b, int k,
                       int o, int act, int out_f32, int bm, void* stream) {
  return launch_bm<false, DenseLoader>(bm, x, nullptr, nullptr, w, nullptr, nullptr, nullptr,
                                       nullptr, bias, y, b, k, k, o, act, stream, out_f32);
}

// tile_gemm/kernel.py::masked_plan's body: 1, K1's stream over the dense
// weight (nm_spmm_sp.cuh, N = 4, MASKED; bm 16 | 64) walking the live steps
// of each block's span, K split over `split` blocks of a cluster (K1's
// split: bitwise vg_tile_gemm on the same masked X below 256 rows); 0, the
// shared body (bm 16 | 64), split 1
int vg_tile_gemm_masked(const void* x, const void* w, const void* kmask, const void* bias,
                        void* y, int b, int k, int o, int act, int bm, int body, int split,
                        void* stream) {
  if (kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 1)
    return sp::launch_nm(4, bm, x, w, nullptr, kmask, bias, y, b, k, o, act, 0, split, stream);
  if (body != 0 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bm<false, DenseLoader, Contiguous, true>(bm, x, nullptr, nullptr, w, nullptr,
                                                         nullptr, nullptr, kmask, bias, y, b,
                                                         k, k, o, act, stream);
}

// tile_gemm/kernel.py::dual_plan's body: 0, the shared body (bm 16 | 64, bn
// 64, split 1); 1, the stream over both weights (nm_spmm_sp.cuh; bm 16 | 64,
// bn 64), K split over `split` blocks of a cluster; 2, the dual wgmma body
// (tile_gemm_sm90.cuh; bm 128, bn 128, split 1)
int vg_tile_gemm_dual(const void* x, const void* wg, const void* wu, void* y, int b, int k,
                      int o, int bm, int body, int bn, int split, void* stream) {
  if (body == 0) {
    if (bn != 64 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bm<true, DenseLoader>(bm, x, nullptr, nullptr, wg, nullptr, wu, nullptr,
                                        nullptr, nullptr, y, b, k, k, o, ACT_NONE, stream);
  }
  if (body == 1 && bn == 64)
    return sp::launch_dual(4, bm, x, wg, nullptr, wu, nullptr, y, b, k, o, split, stream);
  if (body == 2 && bm == tg::BM && bn == 128 && split == 1)
    return tg::launch_dual(1, x, wg, wu, y, b, k, o, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared body: the first form of tile_gemm_dual, timed beside the
// current bodies (not on any path)
int vg_tile_gemm_dual_tiled(const void* x, const void* wg, const void* wu, void* y, int b,
                            int k, int o, int bm, void* stream) {
  return launch_bm<true, DenseLoader>(bm, x, nullptr, nullptr, wg, nullptr, wu, nullptr,
                                      nullptr, nullptr, y, b, k, k, o, ACT_NONE, stream);
}

// n in {1, 2}: the sparse-tensor-core body, K split over `split` blocks of
// a cluster (a power of two up to min(8, k / 64)); n = 4: the shared body,
// split 1
int vg_nm_spmm(const void* x, const void* values, const void* meta, const void* bias, void* y,
               int b, int k, int o, int n, int act, int out_f32, int bm, int split,
               void* stream) {
  if (n == 1 || n == 2)
    return sp::launch_nm(n, bm, x, values, meta, nullptr, bias, y, b, k, o, act, out_f32, split,
                         stream);
  if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_nm<false>(n, bm, x, values, meta, nullptr, nullptr, nullptr, bias, y, b, k, o,
                          act, stream, out_f32);
}

// the shared body at any n: the first form of nm_spmm, timed beside the
// sparse body (not on any path)
int vg_nm_spmm_tiled(const void* x, const void* values, const void* meta, const void* bias,
                     void* y, int b, int k, int o, int n, int act, int out_f32, int bm,
                     void* stream) {
  return launch_nm<false>(n, bm, x, values, meta, nullptr, nullptr, nullptr, bias, y, b, k, o,
                          act, stream, out_f32);
}

// n in {1, 2}: the sparse-tensor-core body walking the live steps of each
// block's span, K split over `split` blocks of a cluster (nm_spmm's split:
// bitwise vg_nm_spmm on the same masked X); n = 4: the shared body, split 1
int vg_nm_spmm_masked(const void* x, const void* values, const void* meta, const void* kmask,
                      const void* bias, void* y, int b, int k, int o, int n, int act, int bm,
                      int split, void* stream) {
  if (kmask == nullptr || (n != 1 && n != 2 && split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 1 || n == 2)
    return sp::launch_nm(n, bm, x, values, meta, kmask, bias, y, b, k, o, act, 0, split, stream);
  return launch_nm<false, true>(n, bm, x, values, meta, nullptr, nullptr, kmask, bias, y, b, k,
                                o, act, stream);
}

// the shared body at any n: the first form of nm_spmm_masked, timed beside
// the sparse body (not on any path)
int vg_nm_spmm_masked_tiled(const void* x, const void* values, const void* meta,
                            const void* kmask, const void* bias, void* y, int b, int k, int o,
                            int n, int act, int bm, void* stream) {
  return launch_nm<false, true>(n, bm, x, values, meta, nullptr, nullptr, kmask, bias, y, b, k,
                                o, act, stream);
}

// nm_spmm/kernel.py::dual_plan's body: 0, the shared body (any n; bm 16 |
// 64, split 1); 1, the compressed dual stream (nm_spmm_sp.cuh; n in {1, 2},
// bm 16 | 64), K split over `split` blocks of a cluster
int vg_nm_spmm_dual(const void* x, const void* values_g, const void* meta_g,
                    const void* values_u, const void* meta_u, void* y, int b, int k, int o,
                    int n, int bm, int body, int split, void* stream) {
  if (body == 0) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nm<true>(n, bm, x, values_g, meta_g, values_u, meta_u, nullptr, nullptr, y, b,
                           k, o, ACT_NONE, stream);
  }
  if (body == 1 && (n == 1 || n == 2))
    return sp::launch_dual(n, bm, x, values_g, meta_g, values_u, meta_u, y, b, k, o, split,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared body at any n: the first form of nm_spmm_dual, timed beside the
// current bodies (not on any path)
int vg_nm_spmm_dual_tiled(const void* x, const void* values_g, const void* meta_g,
                          const void* values_u, const void* meta_u, void* y, int b, int k,
                          int o, int n, int bm, void* stream) {
  return launch_nm<true>(n, bm, x, values_g, meta_g, values_u, meta_u, nullptr, nullptr, y, b,
                         k, o, ACT_NONE, stream);
}

// k is K_eff (X's width); the kernel contracts K_c = k * n / 4 rows of
// values.  nm_spmm_gather/kernel.py::plan's body: 0, the shared body (any n;
// bm in {16, 64}, bn 64, split 1); 1, the stream over the values with the
// gathered X (nm_spmm_sp.cuh; n in {1, 2}, bm in {16, 64}, bn 64), K_c
// split over `split` blocks of a cluster; 2, the gather pass into
// `scratch` (B, K_c) bf16, then K1's wgmma body over it (n in {1, 2}, bm
// 128, bn 128 | 256, split 1).  scratch is read only by body 2.
int vg_nm_spmm_gather_bk(const void* x, const void* values, const void* idx, const void* bias,
                         void* y, int b, int k, int o, int n, int act, int out_f32, int bm,
                         int body, int bn, int split, void* scratch, void* stream) {
  if (body == 0) {
    if (bn != 64 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<false>(n, bm, x, values, idx, nullptr, nullptr, nullptr, bias, y, b, k,
                                o, act, stream, out_f32);
  }
  if (body == 1 && bn == 64)
    return sp::launch_gather(n, bm, x, values, idx, nullptr, bias, y, b, k, o, act, out_f32,
                             split, stream);
  if (body == 2 && bm == tg::BM && split == 1)
    return gather_then_k1(n, bn, x, values, idx, scratch, bias, y, b, k, o, act, out_f32,
                          stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared body at any n: the first form of nm_spmm_gather_bk, timed
// beside the current bodies (not on any path)
int vg_nm_spmm_gather_bk_tiled(const void* x, const void* values, const void* idx,
                               const void* bias, void* y, int b, int k, int o, int n, int act,
                               int out_f32, int bm, void* stream) {
  return launch_gather<false>(n, bm, x, values, idx, nullptr, nullptr, nullptr, bias, y, b, k,
                              o, act, stream, out_f32);
}

// K11: x_t (k, b) K-major -> y_t (o, b), b a multiple of 16; no epilogue
int vg_nm_spmm_gather(const void* x_t, const void* values, const void* idx, void* y_t, int b,
                      int k, int o, int n, int out_f32, int bm, void* stream) {
  return launch_gather<false, false, true>(n, bm, x_t, values, idx, nullptr, nullptr, nullptr,
                                           nullptr, y_t, b, k, o, ACT_NONE, stream, out_f32);
}

// k is K_eff.  nm_spmm_gather/kernel.py::masked_plan's body: 1, K8's stream
// over the values with the gathered X (nm_spmm_sp.cuh, G = 2, MASKED; n = 2,
// bm 16 | 64) walking the live steps of each block's span, K_c split over
// `split` blocks of a cluster (K8's split: bitwise vg_nm_spmm_gather_bk on
// the same masked X); 0, the shared body (any n, bm 16 | 64), split 1
int vg_nm_spmm_gather_bk_masked(const void* x, const void* values, const void* idx,
                                const void* kmask, const void* bias, void* y, int b, int k,
                                int o, int n, int act, int bm, int body, int split,
                                void* stream) {
  if (kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 1)
    return sp::launch_gather(n, bm, x, values, idx, kmask, bias, y, b, k, o, act, 0, split,
                             stream);
  if (body != 0 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gather<false, true>(n, bm, x, values, idx, nullptr, nullptr, kmask, bias, y, b,
                                    k, o, act, stream);
}

// k is K_eff.  nm_spmm_gather/kernel.py::dual_plan's body: 0, the shared
// body (any n; bm 16 | 64, bn 64, split 1); 1, the stream over both values
// with one span a step selected twice (nm_spmm_sp.cuh; n in {1, 2}, bm 16 |
// 64, bn 64), K_c split over `split` blocks of a cluster; 2, the dual gather
// pass into `scratch` (B, 2 K_c) bf16, then the dual wgmma body with two X
// tiles (n in {1, 2}, bm 128, bn 128, split 1).  scratch is read only by body 2.
int vg_nm_spmm_gather_dual_bk(const void* x, const void* values_g, const void* idx_g,
                              const void* values_u, const void* idx_u, void* y, int b, int k,
                              int o, int n, int bm, int body, int bn, int split, void* scratch,
                              void* stream) {
  if (body == 0) {
    if (bn != 64 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gather<true>(n, bm, x, values_g, idx_g, values_u, idx_u, nullptr, nullptr, y,
                               b, k, o, ACT_NONE, stream);
  }
  if (body == 1 && bn == 64)
    return sp::launch_gather_dual(n, bm, x, values_g, idx_g, values_u, idx_u, y, b, k, o, split,
                                  stream);
  if (body == 2 && bm == tg::BM && bn == 128 && split == 1)
    return gather_dual_then_wgmma(n, x, values_g, idx_g, values_u, idx_u, scratch, y, b, k, o,
                                  stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared body at any n: the first form of nm_spmm_gather_dual_bk, timed
// beside the current bodies (not on any path)
int vg_nm_spmm_gather_dual_bk_tiled(const void* x, const void* values_g, const void* idx_g,
                                    const void* values_u, const void* idx_u, void* y, int b,
                                    int k, int o, int n, int bm, void* stream) {
  return launch_gather<true>(n, bm, x, values_g, idx_g, values_u, idx_u, nullptr, nullptr, y, b,
                             k, o, ACT_NONE, stream);
}

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
