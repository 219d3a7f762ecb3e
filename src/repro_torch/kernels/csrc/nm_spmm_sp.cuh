// nm_spmm on Hopper's sparse tensor cores: the float single at n in {1, 2},
// and with the activation-sparsity skip (MASKED) the bf16 nm_spmm_masked;
// and the same streaming body over a dense weight (N = 4): K1's few-row
// tile_gemm (with MASKED, the bf16 tile_gemm_masked's), and, with the X
// side gathered (G = n in {1, 2}), K8's few-row nm_spmm_gather_bk over its
// dense values (with MASKED, the bf16 nm_spmm_gather_bk_masked's); in DUAL
// form (two weights, two
// accumulators, one silu(g) * u flush) the float gate-up duals' few-row
// tile_gemm_dual and nm_spmm_gather_dual_bk (K9), and the compressed
// nm_spmm_dual at n in {1, 2}.  Included by gemm.cu, whose vg_nm_spmm,
// vg_nm_spmm_masked, vg_nm_spmm_dual, vg_tile_gemm, vg_tile_gemm_masked,
// vg_nm_spmm_gather_bk, vg_nm_spmm_gather_bk_masked, vg_tile_gemm_dual and
// vg_nm_spmm_gather_dual_bk launch it; every other
// GEMM of gemm.cu keeps the shared gemm_kernel body, and the many-row
// bodies of K1, K8 and the dense and gathered duals are tile_gemm_sm90.cuh's.
//
// Replaces (JAX package, Pallas on the TPU):
//   nm_spmm    repro/kernels/nm_spmm/kernel.py::nm_spmm (_spmm_accumulate,
//              _unpack_meta_tile, _decompress_tile), float, n in {1, 2}
//   tile_gemm  repro/kernels/tile_gemm/kernel.py::tile_gemm (_gemm_kernel),
//              at the row counts that cannot fill the card (decode, the
//              engine's prefill chunks; the planner in tile_gemm/kernel.py)
//   nm_spmm_gather_bk  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_bk
//              (_gather_bk_kernel), float, n in {1, 2}, at the same row counts
//              (nm_spmm_gather/kernel.py::plan)
//   tile_gemm_dual  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual
//              (_gemm_dual_kernel), float, at the row counts of
//              tile_gemm/kernel.py::dual_plan's stream (decode; qwen3-moe's
//              expert chunks)
//   nm_spmm_gather_dual_bk  repro/kernels/nm_spmm_gather/kernel.py::
//              nm_spmm_gather_dual_bk (_gather_dual_kernel), float, n in {1,
//              2}, likewise (nm_spmm_gather/kernel.py::dual_plan)
//   nm_spmm_dual  repro/kernels/nm_spmm/kernel.py::nm_spmm_dual
//              (_spmm_dual_kernel), float, n in {1, 2}, where
//              nm_spmm/kernel.py::dual_plan picks the stream
//   nm_spmm_masked  repro/kernels/nm_spmm/kernel.py::nm_spmm_masked
//              (_spmm_masked_kernel), float, n in {1, 2}
//   tile_gemm_masked  repro/kernels/tile_gemm/kernel.py::tile_gemm_masked
//              (_gemm_masked_kernel), bf16, below 256 rows (where K1 streams)
//   nm_spmm_gather_bk_masked  repro/kernels/nm_spmm_gather/kernel.py::
//              nm_spmm_gather_bk_masked (_gather_bk_masked_kernel), bf16, 2:4,
//              where K8 streams (nm_spmm_gather/kernel.py::masked_plan)
//
// Y (B, O) = X (B, K) @ dec(values (K*n/4, O), meta_packed (K*n/16, O)).
// The TPU kernel decompresses each tile with a compare-and-select and
// multiplies it dense; here the compressed tile goes to the tensor core as
// it is: mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32 takes A
// 2:4 sparse along K, held compressed with a 2-bit index per kept value,
// which is VEGETA's sparse tile engine on this card.  The weight is A (16
// output channels x 32 K per instruction), X is B (K x 8 batch rows), so
// a decode batch of 8 fills the instruction's N = 8 exactly.  The dense
// weight (N = 4) is A of mma.sync.m16n8k16 the same way: two per 32 K.
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
// the `split` blocks of a thread-block cluster (the wrapper's split_k /
// tile_gemm's plan, up to two blocks an SM: q, o and w_out 32 x 8, k and v
// 16 x 8 at internlm2-1.8b; 1 when the row tiles fill the card), summed in
// rank order (splitk.cuh): the epilogue runs once in flush_tile's order (+
// bias, then silu | gelu) and stores bf16 or fp32 from the same fp32 sum,
// the same bits on every launch.
//
// What bounds it on an H100.  At decode every weight byte is read once
// for 16 flops per bf16 pair: bytes over 3.35 TB/s (w_out at K = 8192, O
// = 2048, 2:4: 18.9 MB, 5.6 us; dense 33.6 MB, 10.0 us).  In development
// runs on the card a variant without the tensor-core work was barely
// faster and a deeper ring no faster, so what holds a block back is the
// stream of 128-byte row segments it reads (64 channels of rows 4 KB
// apart) and the launch's fixed costs (first bytes, the cluster barrier),
// not compute or bytes in flight; more blocks (two an SM) helped most.
// The dense weight streams four stages of 64 x 64 (8 KB) through each
// block, two blocks an SM: ~50 KB in flight per SM.  At prefill (4,000
// rows) the sparse products are above the ridge and the sparse
// instruction's rate (twice the dense one per K) bounds it; a 128-channel
// tile of 8 warps was faster at two of hubert's sites and slower at B =
// 64 and at decode in a development run, so it was left out.  Not done
// here: TMA, wgmma's sparse form, a persistent schedule.
//
// The gathered X (G = n, K8).  values (K_c, O) is a dense weight, so the
// body is the N = 4 stream over it with only the X side changed: a stage
// carries the step's 64 indices and the span of 256 / n X columns its
// compressed rows read (cp.async, rows at or past B zero-filled); after the
// stage lands, a select pass builds the compact [rows][64] X tile that
// ldmatrix reads (column c of the step is span column (c / n) * 4 + idx[c];
// an index outside [0, 4) selects +0, as the TPU kernel's compare-and-
// select does), one more block barrier, then the same products.  At decode
// the span is 4-8 KB a step and the select pass ~2 KB.  Bound: values +
// index + X bytes over 3.35 TB/s, as K1's with n/4 of its weight.
//
// The gate-up duals (DUAL).  A stage carries the step's tiles of both
// weights beside ONE X tile (dense) or ONE span (gathered: both index
// slices ride along, and the select pass reads each unit's span words once
// and selects them twice, into two compact tiles); each warp keeps two
// accumulator sets; the split's inbox holds both partials, summed in rank
// order plane by plane (splitk::finish_planes) before the one flush,
// silu(g) * u in fp32 and one cast (flush_tile's silu_mul point).  At
// internlm2-1.8b's gate-up (2048, 8192) at decode that is 128 tiles split 2
// over a cluster, two blocks an SM (91 KB dense, 106 KB gathered at 2:4
// each; 1:4's span takes a 3-deep ring to stay at two).  The compressed
// dual (N in {1, 2}) lands each weight's values and meta tiles beside the
// one X tile; each warp reads the X registers once and issues one mma.sp a
// weight, building each weight's A registers and metadata word from its own
// tiles (57 KB at 2:4 and 16 rows, 89 KB at 64).  Bound: both weights'
// bytes (+ indices or meta) + X once, over 3.35 TB/s.
//
// The masked single (MASKED: nm_spmm_masked at N in {1, 2},
// tile_gemm_masked over the dense weight at N = 4, nm_spmm_gather_bk_masked
// over it with the gathered X: a kmask column is one step of 64 compressed
// rows, the stage's 256 / G span, so a dead step's span is neither loaded
// nor selected).  Each block keeps the span
// splitk::span gives the unmasked kernel over all K steps and walks only
// its live steps (kmask.cuh's bitmask of the row block's map row): a dead
// step is neither loaded, prefetched nor multiplied.  A dead tile of the
// masked X would add exact zeros, so the partition and the order of the
// sums are the unmasked kernel's: bitwise nm_spmm (K1 at N = 4) on the
// same masked X at the same split (K8 for the gathered X).  A rank with no
// live step in its span walks none and
// still stores its zero partial into the owners' inboxes and meets the
// cluster barrier; a row block with no live step flushes bias and
// activation of zero.  Bound: the live steps' weight and X bytes.

#pragma once

#include "kmask.cuh"
#include "splitk.cuh"

namespace sp {

using splitk::cp_async16;
using splitk::expand_1of4;
using splitk::ldsm_x4;
using splitk::ldsm_x4_trans;

constexpr int BO = 64;              // output channels per block (4 warps x 16)
constexpr int BKS = 64;             // dense K per pipeline stage (two mma K steps)
constexpr int NT = 128;
constexpr int VLD = BO + 8;         // bf16 pitch of the values tile (ldmatrix rows on distinct banks)
constexpr int XLD = BKS + 8;        // bf16 pitch of the X tile
constexpr int PLD = BO + 4;         // fp32 pitch of the partial tile

// A stage is [values (gate)][values (up)][meta (gate)][meta (up)][indices
// (gate)][indices (up)][X], the up tiles for a DUAL only: the gate-up duals
// carry both weights' tiles of the step (and both meta tiles or index
// slices) beside ONE X tile or span.
template <int N, int BM, int G = 0, bool DUAL = false>
struct Layout {
  static_assert(N == 1 || N == 2 || N == 4, "the streaming body takes 1:4, 2:4 and dense");
  static_assert(G == 0 || (N == 4 && (G == 1 || G == 2)),
                "the gathered X (1:4 | 2:4) streams against dense values");
  static constexpr int NW = DUAL ? 2 : 1;        // weights a stage (gate, up)
  // ring depth: 4 stages at decode (a deeper ring streamed no faster on
  // the H100) and for the dense weight; 3 at the sparse 64-row tile, which
  // keep 4 blocks on an SM, and at the gathered 64-row tile (its span);
  // 3 for the gathered dual at 1:4 and 16 rows, whose 4 (120 KB) would
  // leave one block an SM
  static constexpr int STAGES =
      (DUAL && G == 1 && BM == 16) ? 3 : (BM == 16 || (N == 4 && G == 0)) ? 4 : 3;
  static constexpr int VROWS = BKS * N / 4;      // weight rows a stage (16 | 32 | 64)
  static constexpr int MROWS = N == 4 ? 0 : VROWS / 4;   // meta_packed rows a stage (4 | 8)
  static constexpr int V_BYTES = VROWS * VLD * 2;             // one weight's tile
  static constexpr int M_BYTES = MROWS * BO;                 // one weight's meta tile
  static constexpr int I_BYTES = G ? BKS * 4 : 0;            // one stream's int32 indices
  static constexpr int SPAN = G ? 256 / G : BKS;             // X columns a stage
  static constexpr int SLD = G ? SPAN + 8 : XLD;             // bf16 pitch of the X rows
  static constexpr int X_BYTES = BM * SLD * 2;
  static constexpr int I_AT = NW * (V_BYTES + M_BYTES);      // the indices in a stage
  static constexpr int X_AT = I_AT + NW * I_BYTES;           // the X tile (or span)
  static constexpr int STAGE = X_AT + X_BYTES;                // a multiple of 16
  static constexpr int PART = NW * BM * PLD * 4;              // the partial tiles
  static constexpr int RING = STAGES * STAGE > PART ? STAGES * STAGE : PART;
  static constexpr int COMPACT = G ? NW * BM * XLD * 2 : 0;   // the selected X tiles (gather)
  static constexpr int INBOX = NW * BM * BO * 4;  // the peers' partial slices (split > 1 only)
};

// Candidate e of an M-block of four bf16 held in (lo, hi), into half h of a
// word; +0 for an index outside [0, 4)
__device__ __forceinline__ uint32_t pick_half(uint32_t lo, uint32_t hi, int e, int h) {
  const uint32_t s = 2u * (static_cast<uint32_t>(e) & 3u);
  const uint32_t sel = h ? ((s << 8) | ((s + 1u) << 12)) : (s | ((s + 1u) << 4));
  const uint32_t keep = static_cast<unsigned>(e) < 4u ? (h ? 0xffff0000u : 0xffffu) : 0u;
  return __byte_perm(lo, hi, sel) & keep;
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

// D += A (16 x 16, dense) x B (16 x 8), fp32 accumulate
__device__ __forceinline__ void mma_dense(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The kept value v (bf16 bits) of a 1:4 group as its 2:4 pair of slots.
__device__ __forceinline__ uint32_t pair_1of4(uint32_t v, uint32_t i) {
  return i == 0u ? v : v << 16;
}

// k: the contraction (K, or K_c for the gathered X, whose `meta` is the
// int32 index and whose X rows are K_eff = k * 4 / G wide).  DUAL: v2 and
// meta2 are the up weight's (v, meta the gate's), the flush silu(g) * u.
// MASKED (a single): kmask is block_maps' (row blocks, k / 64) map (k / 64
// steps of 64 weight rows: K / 64, or K_c / 64 for the gathered X, each
// 256 / G X columns); the block walks the live steps of its span only.
template <int N, int BM, int G = 0, bool DUAL = false, bool MASKED = false>
__global__ void __launch_bounds__(NT)
nm_spmm_sp_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ v,
                  const uint8_t* __restrict__ meta, const __nv_bfloat16* __restrict__ v2,
                  const uint8_t* __restrict__ meta2, const int* __restrict__ kmask,
                  const float* __restrict__ bias, void* __restrict__ y, int b, int k, int o,
                  int act, int out_f32, int split) {
  using L = Layout<N, BM, G, DUAL>;
  static_assert(!MASKED || !DUAL, "the masked stream is a single");
  constexpr int NW = L::NW;
  constexpr int NXT = (DUAL && G != 0) ? 2 : 1;  // X tiles the products read (gathered dual: 2)
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
  int s0, ns;
  splitk::span(rank, split, k / BKS, s0, ns);
  const int rows = min(BM, b - m0);            // live batch rows of this tile

  // The walk: the span's steps, or (MASKED) its live steps only
  // (kmask.cuh's block_live and SpanWalk).
  SpanWalk<MASKED, NT> at(block_live<MASKED, NT>(kmask, blockIdx.y, k / BKS, tid), s0, ns);
  ns = at.steps();

  auto load_stage = [&](int st, int s) {
    unsigned char* base = smem + st * L::STAGE;
    uint8_t* ms = base + NW * L::V_BYTES;
    const int kc0 = s * L::VROWS;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(base + w * L::V_BYTES);
      const __nv_bfloat16* src = w ? v2 : v;
#pragma unroll
      for (int c = tid; c < L::VROWS * 8; c += NT) {
        const int r = c >> 3, col = (c & 7) * 8;
        cp_async16(vs + r * VLD + col, src + static_cast<size_t>(kc0 + r) * o + n0 + col, 16);
      }
    }
    if constexpr (L::MROWS > 0) {
      if (tid < NW * L::MROWS * 4) {             // each weight's meta rows
        const int w = tid / (L::MROWS * 4), q = tid % (L::MROWS * 4);
        const int r = q >> 2, col = (q & 3) * 16;
        cp_async16(ms + w * L::M_BYTES + r * BO + col,
                   (w ? meta2 : meta) + static_cast<size_t>(s * L::MROWS + r) * o + n0 + col, 16);
      }
    }
    if constexpr (G != 0) {
      // the step's indices (each weight's), and the X span they select from
      // (ke = k * 4 / G): one span for both weights of a dual
      int* is = reinterpret_cast<int*>(base + L::I_AT);
      __nv_bfloat16* xsp = reinterpret_cast<__nv_bfloat16*>(base + L::X_AT);
      if (tid < NW * BKS / 4) {
        const int w = tid / (BKS / 4), q = tid % (BKS / 4);
        cp_async16(is + w * BKS + 4 * q,
                   reinterpret_cast<const int*>(w ? meta2 : meta) + s * BKS + 4 * q, 16);
      }
      constexpr int CPR = L::SPAN / 8;             // 16-byte chunks of a span row
#pragma unroll
      for (int c = tid; c < BM * CPR; c += NT) {
        const int r = c / CPR, col = (c % CPR) * 8;
        const bool live = r < rows;
        cp_async16(xsp + r * L::SLD + col,
                   x + static_cast<size_t>(live ? m0 + r : 0) * (k / G * 4) + s * L::SPAN + col,
                   live ? 16 : 0);
      }
    } else {
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + L::X_AT);
#pragma unroll
      for (int c = tid; c < BM * 8; c += NT) {
        const int r = c >> 3, col = (c & 7) * 8;
        const bool live = r < rows;
        cp_async16(xs + r * XLD + col,
                   x + static_cast<size_t>(live ? m0 + r : 0) * k + s * BKS + col, live ? 16 : 0);
      }
    }
  };

  float acc[NW][MT][NJ][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[w][mt][j][0] = acc[w][mt][j][1] = acc[w][mt][j][2] = acc[w][mt][j][3] = 0.f;

  auto compute = [&](int st) {
    const unsigned char* base = smem + st * L::STAGE;
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(base);
    const uint8_t* ms = base + NW * L::V_BYTES;
    const __nv_bfloat16* xt[NXT];
    xt[0] = reinterpret_cast<const __nv_bfloat16*>(base + L::X_AT);
    if constexpr (G != 0) {
      // the select pass: unit u = (row u / 8, compressed columns 8 (u % 8) ..
      // + 7) of the compact tile, one 16-byte store; column pair (2p, 2p + 1)
      // reads M-block p (2:4: 8 span bytes) or blocks 2p, 2p + 1 (1:4).  A
      // dual reads the unit's span words once and selects twice, through
      // each weight's indices, into two compact tiles.
      const int* is = reinterpret_cast<const int*>(base + L::I_AT);
      const __nv_bfloat16* xsp = reinterpret_cast<const __nv_bfloat16*>(base + L::X_AT);
      __nv_bfloat16* ct = reinterpret_cast<__nv_bfloat16*>(smem + L::RING);
#pragma unroll
      for (int u = tid; u < BM * 8; u += NT) {
        const int r = u >> 3, j0 = (u & 7) * 8;
        const uint32_t* row = reinterpret_cast<const uint32_t*>(xsp + r * L::SLD + j0 / G * 4);
        uint32_t wd[16 / G];
#pragma unroll
        for (int i = 0; i < 16 / G; ++i) wd[i] = row[i];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const int4 e0 = *reinterpret_cast<const int4*>(is + w * BKS + j0);
          const int4 e1 = *reinterpret_cast<const int4*>(is + w * BKS + j0 + 4);
          const int e[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
          uint32_t out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (G == 2) {     // block q of the unit's four: words 2q, 2q + 1
              out[q] = pick_half(wd[2 * q], wd[2 * q + 1], e[2 * q], 0) |
                       pick_half(wd[2 * q], wd[2 * q + 1], e[2 * q + 1], 1);
            } else {                    // blocks 2q, 2q + 1: words 4q .. + 3
              out[q] = pick_half(wd[4 * q], wd[4 * q + 1], e[2 * q], 0) |
                       pick_half(wd[4 * q + 2], wd[4 * q + 3], e[2 * q + 1], 1);
            }
          }
          *reinterpret_cast<uint4*>(ct + w * BM * XLD + r * XLD + j0) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < NXT; ++t) xt[t] = ct + t * BM * XLD;
    }
#pragma unroll
    for (int kk = 0; kk < BKS / 32; ++kk) {
      uint32_t bf[NXT][NJ][4];    // X rows r0 + 8j .. + 7 at K 32kk .. + 31
#pragma unroll
      for (int t = 0; t < NXT; ++t)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (r0 + j * 8 < rows)   // warp-uniform: n8 tiles wholly past B are skipped
            ldsm_x4(bf[t][j],
                    xt[t] + (r0 + j * 8 + (lane & 7)) * XLD + kk * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int c = ch0 + mt * 16;    // channels c .. c + 15: A's rows
        if constexpr (N == 4) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            // dense rows 32kk .. + 15 and + 16 .. + 31 x channels c .. + 15 of
            // weight w, transposed; a gathered dual's up weight reads its own X
            uint32_t a0[4], a1[4];
            const __nv_bfloat16* p = vs + w * (L::V_BYTES / 2) +
                                     (kk * 32 + (lane & 7) + ((lane >> 4) << 3)) * VLD + c +
                                     ((lane >> 3) & 1) * 8;
            ldsm_x4_trans(a0, p);
            ldsm_x4_trans(a1, p + 16 * VLD);
            const uint32_t(&bx)[NJ][4] = bf[NXT == 2 ? w : 0];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              if (r0 + j * 8 < rows) {
                mma_dense(acc[w][mt][j], a0, bx[j][0], bx[j][1]);
                mma_dense(acc[w][mt][j], a1, bx[j][2], bx[j][3]);
              }
          }
        } else {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            // weight w's values and meta tiles; both weights of a dual read
            // the one X tile's registers
            const __nv_bfloat16* vw = vs + w * (L::V_BYTES / 2);
            const uint8_t* mw = ms + w * L::M_BYTES;
            uint32_t a[4];
            uint32_t e;
            if constexpr (N == 2) {
              // compressed rows 16kk .. + 15 x channels c .. + 15, transposed
              ldsm_x4_trans(a, vw + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * VLD + c +
                                   ((lane >> 3) & 1) * 8);
              // lane 4g (4g + 1) supplies K columns 0-15 (16-31) of channels
              // c + g and c + g + 8: meta_packed rows 4kk + 2t, + 1 of each
              const uint8_t* mp = mw + (kk * 4 + 2 * (t & 1)) * BO + c + g;
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
                  mb[r][h] = mw[(2 * kk + h) * BO + col];
                  const uint32_t val =
                      reinterpret_cast<const uint16_t*>(vw)[(8 * kk + t + 4 * h) * VLD + col];
                  a[r + 2 * h] = pair_1of4(val, (mb[r][h] >> (2 * t)) & 3u);
                }
              }
              // lane 4g (4g + 1): groups 0-3 (4-7) of channel c + g, then of c + g + 8
              e = expand_1of4(mb[0][t & 1] | (mb[1][t & 1] << 8));
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              if (r0 + j * 8 < rows) mma_sp(acc[w][mt][j], a, bf[0][j], e);
          }
        }
      }
    }
  };
  splitk::run_ring<L::STAGES>(ns, at, load_stage, compute);

  // partial tiles [weight][batch row][channel], fp32
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* pw = part + w * BM * PLD;
        const int r = r0 + j * 8 + 2 * t;
        const int c = ch0 + mt * 16 + g;
        pw[r * PLD + c] = acc[w][mt][j][0];
        pw[(r + 1) * PLD + c] = acc[w][mt][j][1];
        pw[r * PLD + c + 8] = acc[w][mt][j][2];
        pw[(r + 1) * PLD + c + 8] = acc[w][mt][j][3];
      }
  __syncthreads();

  splitk::finish_planes<BM, BO, PLD, NT, NW>(
      part, reinterpret_cast<float*>(smem + L::RING + L::COMPACT), rank, split, rows,
      [&](int r, int c, const float (&sum)[NW]) {
        float s = sum[0];
        if constexpr (DUAL) {
          s = silu(s) * sum[NW - 1];       // flush_tile's silu_mul point, in fp32
        } else {
          if (bias != nullptr) s += bias[n0 + c];
          s = apply_act(s, act);
        }
        const size_t at = static_cast<size_t>(m0 + r) * o + n0 + c;
        if (out_f32) static_cast<float*>(y)[at] = s;
        else static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(s);
      });
}

template <int N, int BM, int G = 0, bool DUAL = false, bool MASKED = false>
int launch(const void* x, const void* v, const void* meta, const void* v2, const void* meta2,
           const void* kmask, const float* bias, void* y, int b, int k, int o, int act,
           int out_f32, int split, cudaStream_t stream) {
  using L = Layout<N, BM, G, DUAL>;
  static int opted = 0;
  return splitk::launch(nm_spmm_sp_kernel<N, BM, G, DUAL, MASKED>, opted,
                        dim3(o / BO, (b + BM - 1) / BM), NT, L::RING + L::COMPACT, L::INBOX,
                        split, stream, static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(meta),
                        static_cast<const __nv_bfloat16*>(v2),
                        static_cast<const uint8_t*>(meta2), static_cast<const int*>(kmask), bias,
                        y, b, k, o, act, out_f32, split);
}

// n in {1, 2} (values + meta_packed) or 4 (a dense (K, O) weight, meta
// unused), bm in {16, 64}, split a power of two up to min(8, k / 64);
// kmask: the masked single (nm_spmm_masked at n in {1, 2}, tile_gemm_masked
// at n = 4) with block_maps' (ceil(b / bm), k / 64) map, else nullptr
inline int launch_nm(int n, int bm, const void* x, const void* v, const void* meta,
                     const void* kmask, const void* bias, void* y, int b, int k, int o, int act,
                     int out_f32, int split, void* stream) {
  if (b <= 0 || k <= 0 || o <= 0 || k % BKS != 0 || o % BO != 0 || act < 0 || act > 2 ||
      out_f32 < 0 || out_f32 > 1 || !splitk::split_ok(split, k / BKS) ||
      (b + bm - 1) / bm > 65535 || (kmask != nullptr && k / BKS > MAX_K_STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
#define VG_SP_LAUNCH(NN, BB, MM)                                                              \
  return launch<NN, BB, 0, false, MM>(x, v, meta, nullptr, nullptr, kmask, bf, y, b, k, o, act, \
                                      out_f32, split, s)
  if (kmask != nullptr) {
    if (n == 2 && bm == 16) VG_SP_LAUNCH(2, 16, true);
    if (n == 2 && bm == 64) VG_SP_LAUNCH(2, 64, true);
    if (n == 1 && bm == 16) VG_SP_LAUNCH(1, 16, true);
    if (n == 1 && bm == 64) VG_SP_LAUNCH(1, 64, true);
    if (n == 4 && bm == 16) VG_SP_LAUNCH(4, 16, true);
    if (n == 4 && bm == 64) VG_SP_LAUNCH(4, 64, true);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 2 && bm == 16) VG_SP_LAUNCH(2, 16, false);
  if (n == 2 && bm == 64) VG_SP_LAUNCH(2, 64, false);
  if (n == 1 && bm == 16) VG_SP_LAUNCH(1, 16, false);
  if (n == 1 && bm == 64) VG_SP_LAUNCH(1, 64, false);
  if (n == 4 && bm == 16) VG_SP_LAUNCH(4, 16, false);
  if (n == 4 && bm == 64) VG_SP_LAUNCH(4, 64, false);
#undef VG_SP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8's few-row body: X (b, ke) gathered at n in {1, 2} through idx (K_c =
// ke * n / 4 int32) against values (K_c, O) as a dense weight; bm in {16,
// 64}, split a power of two up to min(8, K_c / 64); kmask: the masked
// single (nm_spmm_gather_bk_masked, bf16 out, n = 2: where
// nm_spmm_gather/kernel.py::masked_plan streams) with block_maps' (ceil(b /
// bm), K_c / 64) map, else nullptr
inline int launch_gather(int n, int bm, const void* x, const void* values, const void* idx,
                         const void* kmask, const void* bias, void* y, int b, int ke, int o,
                         int act, int out_f32, int split, void* stream) {
  const int kc = ke * n / 4;
  if (b <= 0 || ke <= 0 || o <= 0 || (ke * n) % 4 != 0 || kc % BKS != 0 || o % BO != 0 ||
      act < 0 || act > 2 || out_f32 < 0 || out_f32 > 1 || !splitk::split_ok(split, kc / BKS) ||
      (b + bm - 1) / bm > 65535 ||
      (kmask != nullptr && (n != 2 || out_f32 != 0 || kc / BKS > MAX_K_STEPS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
#define VG_SP_GATHER(GG, BB, MM)                                                               \
  return launch<4, BB, GG, false, MM>(x, values, idx, nullptr, nullptr, kmask, bf, y, b, kc, o, \
                                      act, out_f32, split, s)
  if (kmask != nullptr) {
    if (n == 2 && bm == 16) VG_SP_GATHER(2, 16, true);
    if (n == 2 && bm == 64) VG_SP_GATHER(2, 64, true);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 2 && bm == 16) VG_SP_GATHER(2, 16, false);
  if (n == 2 && bm == 64) VG_SP_GATHER(2, 64, false);
  if (n == 1 && bm == 16) VG_SP_GATHER(1, 16, false);
  if (n == 1 && bm == 64) VG_SP_GATHER(1, 64, false);
#undef VG_SP_GATHER
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float gate-up duals' few-row body: Y (b, o) = silu(X @ Wg) * (X @ Wu),
// bf16: n = 4, both (k, o) weights dense (tile_gemm_dual; mg, mu unused);
// n in {1, 2}, both compressed, values (k n / 4, o) + meta_packed (k n /
// 16, o) (nm_spmm_dual); bm in {16, 64}, split a power of two up to min(8,
// k / 64)
inline int launch_dual(int n, int bm, const void* x, const void* wg, const void* mg,
                       const void* wu, const void* mu, void* y, int b, int k, int o, int split,
                       void* stream) {
  if (b <= 0 || k <= 0 || o <= 0 || k % BKS != 0 || o % BO != 0 ||
      !splitk::split_ok(split, k / BKS) || (b + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SP_DUAL(NN, BB)                                                                  \
  return launch<NN, BB, 0, true>(x, wg, mg, wu, mu, nullptr, nullptr, y, b, k, o, ACT_NONE, 0, \
                                 split, s)
  if (n == 4 && bm == 16) VG_SP_DUAL(4, 16);
  if (n == 4 && bm == 64) VG_SP_DUAL(4, 64);
  if (n == 2 && bm == 16) VG_SP_DUAL(2, 16);
  if (n == 2 && bm == 64) VG_SP_DUAL(2, 64);
  if (n == 1 && bm == 16) VG_SP_DUAL(1, 16);
  if (n == 1 && bm == 64) VG_SP_DUAL(1, 64);
#undef VG_SP_DUAL
  return static_cast<int>(cudaErrorInvalidValue);
}

// ... and K9's (nm_spmm_gather_dual_bk): X (b, ke) gathered at n in {1, 2}
// through idx_g and idx_u (K_c = ke * n / 4 int32 each) against values_g and
// values_u (K_c, O); one span a step, selected twice
inline int launch_gather_dual(int n, int bm, const void* x, const void* vg, const void* ig,
                              const void* vu, const void* iu, void* y, int b, int ke, int o,
                              int split, void* stream) {
  const int kc = ke * n / 4;
  if (b <= 0 || ke <= 0 || o <= 0 || (ke * n) % 4 != 0 || kc % BKS != 0 || o % BO != 0 ||
      !splitk::split_ok(split, kc / BKS) || (b + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SP_GATHER_DUAL(GG, BB) \
  return launch<4, BB, GG, true>(x, vg, ig, vu, iu, nullptr, nullptr, y, b, kc, o, ACT_NONE, 0, \
                                 split, s)
  if (n == 2 && bm == 16) VG_SP_GATHER_DUAL(2, 16);
  if (n == 2 && bm == 64) VG_SP_GATHER_DUAL(2, 64);
  if (n == 1 && bm == 16) VG_SP_GATHER_DUAL(1, 16);
  if (n == 1 && bm == 64) VG_SP_GATHER_DUAL(1, 64);
#undef VG_SP_GATHER_DUAL
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sp
