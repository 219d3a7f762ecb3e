// nm_spmm on Hopper's sparse tensor cores: the float single at n in {1, 2}
// (included by gemm.cu, whose vg_nm_spmm launches it; every other GEMM of
// gemm.cu keeps the shared gemm_kernel body).
//
// Replaces (JAX package, Pallas on the TPU):
//   nm_spmm  repro/kernels/nm_spmm/kernel.py::nm_spmm (_spmm_accumulate,
//            _unpack_meta_tile, _decompress_tile), float, n in {1, 2}
//
// Y (B, O) = X (B, K) @ dec(values (K*n/4, O), meta_packed (K*n/16, O)).
// The TPU kernel decompresses each tile with a compare-and-select and
// multiplies it dense; here the compressed tile goes to the tensor core as
// it is: mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32 takes A
// 2:4 sparse along K, held compressed with a 2-bit index per kept value,
// which is VEGETA's sparse tile engine on this card.  The weight is A (16
// output channels x 32 K per instruction), X is B (K x 8 batch rows), so
// a decode batch of 8 fills the instruction's N = 8 exactly.
//
// Operand layout (pinned on the card by kernels/mma_sp_probe.py, see its
// docstring).  A comes from the values tile (K_c rows x 64 channels in
// shared memory) with ldmatrix.x4.trans.  The metadata is built in
// registers from meta_packed, not repacked.  With selector 0 lane 4g + u
// (u in {0, 1}) holds K columns 16u .. 16u + 15 of channel g in its low
// 16 bits and of channel g + 8 in its high 16, two indices per 4-column
// group, low bits first: at 2:4 that is two consecutive meta_packed bytes
// of each channel (four 2-bit indices per byte, low bits first), so the
// word is four byte loads.  The compressor keeps each group's indices
// sorted and distinct, as the instruction wants.  1:4 runs as 2:4: each
// group's one kept value goes to the slot of its index and a +0 to the
// other, the pair (0, 1) for index 0, else (0, index); values are read
// with 16-bit shared loads and the word is spread from one meta byte of
// each channel (expand_1of4).  The 1:4 bytes in device memory stay 1:4's.
//
// Tiling.  A block of 4 warps owns 64 output channels x BM batch rows
// (the plan's row block: 16 at decode, each warp 16 channels x 16 rows; 64
// above, each warp 32 x 32) and walks its share of K in steps of 64
// through a cp.async ring of values, meta and X tiles (X rows at or past B
// zero-filled; n8 tiles wholly past B skipped).  At decode the O / 64 x 1
// blocks would fill a quarter of the 132 SMs at best, so K is split across
// the `split` blocks of a thread-block cluster (the wrapper's split_k, up
// to two blocks an SM: q, o and w_out 32 x 8, k and v 16 x 8 at
// internlm2-1.8b; 1 when the row tiles fill the card).  Each block writes
// its fp32 partial of every slice of the tile into the inbox of the
// slice's owner (distributed shared memory), then one cluster barrier;
// block r sums its slice over ranks 0, 1, .. in that fixed order from its
// own shared memory, applies the epilogue once in flush_tile's order (+
// bias, then silu | gelu) and stores bf16 or fp32 from the same fp32 sum.
// One launch, no atomics, no workspace: the same inputs give the same bits
// on every launch.
//
// What bounds it on an H100.  At decode every weight byte is read once
// for 16 flops per bf16 pair: bytes over 3.35 TB/s (w_out at K = 8192, O
// = 2048, 2:4: 18.9 MB, 5.6 us).  In development runs on the card a
// variant without the tensor-core work was barely faster and a deeper
// ring no faster, so what holds a block back is the stream of 128-byte
// row segments it reads (64 channels of rows 4 KB apart) and the launch's
// fixed costs (first bytes, the cluster barrier), not compute or bytes in
// flight; more blocks (two an SM) helped most.  At prefill (4,000 rows)
// the products are above the ridge and the sparse instruction's rate
// (twice the dense one per K) bounds it; a 128-channel tile of 8 warps
// was faster at two of hubert's sites and slower at B = 64 and at decode
// in a development run, so it was left out.  Not done here: TMA, wgmma's
// sparse form, a persistent schedule.

#pragma once

#include <cooperative_groups.h>

namespace sp {

namespace cg = cooperative_groups;

constexpr int BO = 64;              // output channels per block (4 warps x 16)
constexpr int BKS = 64;             // dense K per pipeline stage (two mma K steps)
constexpr int NT = 128;
constexpr int VLD = BO + 8;         // bf16 pitch of the values tile (ldmatrix rows on distinct banks)
constexpr int XLD = BKS + 8;        // bf16 pitch of the X tile
constexpr int PLD = BO + 4;         // fp32 pitch of the partial tile
constexpr int MAX_SPLIT = 8;        // a portable cluster size

template <int N, int BM>
struct Layout {
  static_assert(N == 1 || N == 2, "the sparse body takes 1:4 and 2:4");
  // ring depth: 4 stages at decode (a deeper ring streamed no faster on
  // the H100); 3 at the 64-row tile, which keep 4 blocks on an SM
  static constexpr int STAGES = BM == 16 ? 4 : 3;
  static constexpr int VROWS = BKS * N / 4;      // compressed rows a stage (32 | 16)
  static constexpr int MROWS = VROWS / 4;        // meta_packed rows a stage (8 | 4)
  static constexpr int V_BYTES = VROWS * VLD * 2;
  static constexpr int M_BYTES = MROWS * BO;
  static constexpr int X_BYTES = BM * XLD * 2;
  static constexpr int STAGE = V_BYTES + M_BYTES + X_BYTES;   // a multiple of 16
  static constexpr int PART = BM * PLD * 4;                   // the partial tile
  static constexpr int RING = STAGES * STAGE > PART ? STAGES * STAGE : PART;
  static constexpr int INBOX = BM * BO * 4;   // the peers' partial slices (split > 1 only)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// D += A (16 x 32, 2:4, compressed) x B (32 x 8), fp32 accumulate
__device__ __forceinline__ void mma_sp(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[4], uint32_t e) {
  asm volatile(
      "mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, 0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(b[2]),
        "r"(b[3]), "r"(e));
}

// A 1:4 row's metadata word from its 8 packed 2-bit indices (group j at
// bits 2j): group j's nibble is the pair (0, i), or (0, 1) for i == 0.
__device__ __forceinline__ uint32_t expand_1of4(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;          // index j at bits 4j, 4j + 1
  const uint32_t zero = ~(x | (x >> 1)) & 0x11111111u;
  return (x | zero) << 2;
}

// The kept value v (bf16 bits) of a 1:4 group as its 2:4 pair of slots.
__device__ __forceinline__ uint32_t pair_1of4(uint32_t v, uint32_t i) {
  return i == 0u ? v : v << 16;
}

template <int N, int BM>
__global__ void __launch_bounds__(NT)
nm_spmm_sp_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                  const uint8_t* __restrict__ meta, const float* __restrict__ bias,
                  void* __restrict__ y, int b, int k, int o, int act, int out_f32, int split) {
  using L = Layout<N, BM>;
  constexpr int STAGES = L::STAGES;
  constexpr int WN = BM == 16 ? 1 : 2;         // warps along the batch rows
  constexpr int WM = 4 / WN;                   // warps along the channels
  constexpr int MT = BO / (16 * WM);           // m16 channel tiles a warp (1 | 2)
  constexpr int NJ = BM / (8 * WN);            // n8 batch-row tiles a warp (2 | 4)
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ch0 = (warp % WM) * MT * 16;       // the warp's first channel in the tile
  const int r0 = (warp / WM) * NJ * 8;         // the warp's first batch row in the tile
  const int n0 = blockIdx.x * BO;
  const int m0 = blockIdx.y * BM;
  const int rank = blockIdx.z;                 // the cluster is (1, 1, split): rank = z
  const int nk = k / BKS;
  const int s0 = static_cast<int>(static_cast<long long>(rank) * nk / split);
  const int ns = static_cast<int>(static_cast<long long>(rank + 1) * nk / split) - s0;
  const int rows = min(BM, b - m0);            // live batch rows of this tile

  auto load_stage = [&](int st, int s) {
    unsigned char* base = smem + st * L::STAGE;
    __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(base);
    uint8_t* ms = base + L::V_BYTES;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + L::V_BYTES + L::M_BYTES);
    const int kc0 = s * L::VROWS;
#pragma unroll
    for (int c = tid; c < L::VROWS * 8; c += NT) {
      const int r = c >> 3, col = (c & 7) * 8;
      cp_async16(vs + r * VLD + col, v + static_cast<size_t>(kc0 + r) * o + n0 + col, 16);
    }
    if (tid < L::MROWS * 4) {
      const int r = tid >> 2, col = (tid & 3) * 16;
      cp_async16(ms + r * BO + col, meta + static_cast<size_t>(s * L::MROWS + r) * o + n0 + col,
                 16);
    }
#pragma unroll
    for (int c = tid; c < BM * 8; c += NT) {
      const int r = c >> 3, col = (c & 7) * 8;
      const bool live = r < rows;
      cp_async16(xs + r * XLD + col,
                 x + static_cast<size_t>(live ? m0 + r : 0) * k + s * BKS + col, live ? 16 : 0);
    }
  };

  float acc[MT][NJ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ns) load_stage(st, s0 + st);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // step i has landed; every warp is done with step i - 1's stage
    if (i + STAGES - 1 < ns) load_stage((i + STAGES - 1) % STAGES, s0 + i + STAGES - 1);
    cp_async_commit();

    const unsigned char* base = smem + (i % STAGES) * L::STAGE;
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(base);
    const uint8_t* ms = base + L::V_BYTES;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(base + L::V_BYTES + L::M_BYTES);
#pragma unroll
    for (int kk = 0; kk < BKS / 32; ++kk) {
      uint32_t bf[NJ][4];    // X rows r0 + 8j .. + 7 at K 32kk .. + 31
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (r0 + j * 8 < rows)   // warp-uniform: n8 tiles wholly past B are skipped
          ldsm_x4(bf[j], xs + (r0 + j * 8 + (lane & 7)) * XLD + kk * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int c = ch0 + mt * 16;    // channels c .. c + 15: A's rows
        uint32_t a[4];
        uint32_t e;
        if constexpr (N == 2) {
          // compressed rows 16kk .. + 15 x channels c .. + 15, transposed
          ldsm_x4_trans(a, vs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * VLD + c +
                               ((lane >> 3) & 1) * 8);
          // lane 4g (4g + 1) supplies K columns 0-15 (16-31) of channels
          // c + g and c + g + 8: meta_packed rows 4kk + 2t, + 1 of each
          const uint8_t* mp = ms + (kk * 4 + 2 * (t & 1)) * BO + c + g;
          e = static_cast<uint32_t>(mp[0]) | static_cast<uint32_t>(mp[BO]) << 8 |
              static_cast<uint32_t>(mp[8]) << 16 | static_cast<uint32_t>(mp[BO + 8]) << 24;
        } else {
          // group t (and t + 4) of channels c + g and c + g + 8: compressed
          // row 8kk + t (+ 4), its index in meta row 2kk (+ 1) at bits 2t
          uint32_t mb[2][2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int col = c + g + 8 * r;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mb[r][h] = ms[(2 * kk + h) * BO + col];
              const uint32_t val =
                  reinterpret_cast<const uint16_t*>(vs)[(8 * kk + t + 4 * h) * VLD + col];
              a[r + 2 * h] = pair_1of4(val, (mb[r][h] >> (2 * t)) & 3u);
            }
          }
          // lane 4g (4g + 1): groups 0-3 (4-7) of channel c + g, then of c + g + 8
          e = expand_1of4(mb[0][t & 1] | (mb[1][t & 1] << 8));
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (r0 + j * 8 < rows) mma_sp(acc[mt][j], a, bf[j], e);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();       // the ring is drained: the partial tile may alias it

  // partial tile [batch row][channel], fp32
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = r0 + j * 8 + 2 * t;
      const int c = ch0 + mt * 16 + g;
      part[r * PLD + c] = acc[mt][j][0];
      part[(r + 1) * PLD + c] = acc[mt][j][1];
      part[r * PLD + c + 8] = acc[mt][j][2];
      part[(r + 1) * PLD + c + 8] = acc[mt][j][3];
    }
  __syncthreads();

  // Block q owns elements [q E / split, (q + 1) E / split) of the tile (E =
  // BM x 64, row-major).  Each block stores its partial of every slice into
  // the owner's inbox, at [its rank][offset in the slice]; after one
  // cluster barrier every owner sums its inbox in rank order (the same bits
  // whichever block sums them) from its own shared memory, so no block
  // reads a peer's memory and none waits for the others to leave.
  constexpr int E = BM * BO;
  float* inbox = reinterpret_cast<float*>(smem + L::RING);
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    const int slice = E / split;        // split is a power of two up to 8: exact
    for (int q = tid; q < E; q += NT) {
      const int owner = q / slice;
      cluster.map_shared_rank(inbox, owner)[rank * slice + q % slice] =
          part[(q / BO) * PLD + q % BO];
    }
    cluster.sync();
  }
  const int slice = E / split;
  for (int q = rank * slice + tid; q < (rank + 1) * slice; q += NT) {
    const int r = q / BO, c = q % BO;
    if (m0 + r >= b) continue;
    float s = part[r * PLD + c];
    if (split > 1) {
      s = inbox[q - rank * slice];
      for (int z = 1; z < split; ++z) s += inbox[z * slice + q - rank * slice];
    }
    if (bias != nullptr) s += bias[n0 + c];
    s = apply_act(s, act);
    const size_t at = static_cast<size_t>(m0 + r) * o + n0 + c;
    if (out_f32) static_cast<float*>(y)[at] = s;
    else static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(s);
  }
}

template <int N, int BM>
int launch(const void* x, const void* v, const void* meta, const void* bias, void* y, int b,
           int k, int o, int act, int out_f32, int split, cudaStream_t stream) {
  using L = Layout<N, BM>;
  auto kernel = nm_spmm_sp_kernel<N, BM>;
  static bool opted_in = false;     // above 48 KB a block's shared memory is asked for
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::RING + L::INBOX);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(o / BO, (b + BM - 1) / BM, split);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::RING + (split > 1 ? L::INBOX : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(meta), static_cast<const float*>(bias), y, b, k, o, act,
      out_f32, split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// n in {1, 2}, bm in {16, 64}, split a power of two up to min(8, k / 64)
inline int launch_nm(int n, int bm, const void* x, const void* v, const void* meta,
                     const void* bias, void* y, int b, int k, int o, int act, int out_f32,
                     int split, void* stream) {
  if (b <= 0 || k <= 0 || o <= 0 || k % BKS != 0 || o % BO != 0 || act < 0 || act > 2 ||
      out_f32 < 0 || out_f32 > 1 || split < 1 || split > MAX_SPLIT || (split & (split - 1)) ||
      split > k / BKS ||
      (b + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SP_LAUNCH(NN, BB) \
  return launch<NN, BB>(x, v, meta, bias, y, b, k, o, act, out_f32, split, s)
  if (n == 2 && bm == 16) VG_SP_LAUNCH(2, 16);
  if (n == 2 && bm == 64) VG_SP_LAUNCH(2, 64);
  if (n == 1 && bm == 16) VG_SP_LAUNCH(1, 16);
  if (n == 1 && bm == 64) VG_SP_LAUNCH(1, 64);
#undef VG_SP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sp
