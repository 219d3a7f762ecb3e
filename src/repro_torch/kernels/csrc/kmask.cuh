// The activation-sparsity block skip shared by the masked GEMM kernels
// (K10: tile_gemm_masked, nm_spmm_masked, nm_spmm_gather_bk_masked, in
// gemm.cu, gemm_int8.cu and gemm_fp8.cu; the bf16 nm_spmm_masked at n in
// {1, 2} and tile_gemm_masked below 256 rows in nm_spmm_sp.cuh's stream, and
// nm_spmm_masked_fp8, tile_gemm_masked_fp8, nm_spmm_masked_int8,
// tile_gemm_masked_int8 and the 8-bit masked gathers in nm_spmm_sp_fp8.cuh's,
// each walking the live steps of its split's span; that header's forms end
// a row block with no live step without the split's exchange).
//
// kmask is block_maps' (row blocks, K steps) int32 map over the masked X:
// kmask[i][s] != 0 iff row block i holds a nonzero in K step s.  A block
// folds its row of the map into a bitmask in shared memory once, with one
// coalesced load per 32 steps and a warp ballot, and then walks only the
// live steps: a dead step is neither loaded nor multiplied, and a dead
// next step is not prefetched.  (The TPU kernel's kmap, which re-addresses
// dead steps so that Pallas elides their DMA copies, has no use here.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_K_STEPS = 1024;   // the K steps one row block may span

template <int NTHREADS>
struct LiveSteps {
  uint32_t bits[MAX_K_STEPS / 32];

  // Fold row `row` of kmask (nk steps per row) into the bitmask.  Every
  // thread of the block calls it; the caller synchronises after it.
  __device__ __forceinline__ void load(const int* kmask, int row, int nk, int tid) {
    const int lane = tid & 31;
    for (int base = (tid >> 5) * 32; base < nk; base += NTHREADS) {
      const int s = base + lane;
      const bool live = s < nk && kmask[(size_t)row * nk + s] != 0;
      const uint32_t m = __ballot_sync(0xffffffffu, live);
      if (lane == 0) bits[base >> 5] = m;
    }
  }

  // The live steps in [s, e).
  __device__ __forceinline__ int count(int s, int e) const {
    int c = 0;
    for (; s < e; s = (s | 31) + 1) {
      uint32_t w = bits[s >> 5] >> (s & 31);
      if (e - s < 32) w &= (1u << (e - s)) - 1u;
      c += __popc(w);
    }
    return c;
  }

  // The first live step at or after s, or nk when none is left.
  __device__ __forceinline__ int next(int s, int nk) const {
    while (s < nk) {
      const uint32_t w = bits[s >> 5] >> (s & 31);
      if (w != 0u) return s + __ffs(static_cast<int>(w)) - 1;
      s = (s | 31) + 1;
    }
    return nk;
  }
};

// The row block's bitmask for a streaming kernel: with MASKED, row `row` of
// kmask folded into a LiveSteps in static shared memory, synchronised; else
// nullptr.  The array is declared only in the masked instantiations, so the
// unmasked kernels hold no static shared memory for it.  Every thread of the
// block calls it.
template <bool MASKED, int NTHREADS>
__device__ __forceinline__ const LiveSteps<NTHREADS>* block_live(const int* kmask, int row,
                                                                 int nk, int tid) {
  if constexpr (MASKED) {
    __shared__ LiveSteps<NTHREADS> live;
    live.load(kmask, row, nk, tid);
    __syncthreads();
    return &live;
  } else {
    return nullptr;
  }
}

// A streaming block's walk over its split span [s0, s0 + ns), the step map
// splitk::run_ring takes: every step, or with MASKED only the live ones of
// `live` (the row block's bitmask, block_live's).
// The span stays the unmasked kernel's, so the sums keep its partition and
// order; a rank whose span holds no live step walks none (steps() == 0)
// and still joins the split's finish with its zero partial.  at(i) is
// called once for each i, in increasing order.
template <bool MASKED, int NTHREADS>
struct SpanWalk {
  const LiveSteps<NTHREADS>* live;
  int s0, end, cursor;

  __device__ __forceinline__ SpanWalk(const LiveSteps<NTHREADS>* l, int first, int ns)
      : live(l), s0(first), end(first + ns), cursor(first) {
    if constexpr (MASKED) cursor = live->next(s0, end);
  }
  // the steps the walk visits
  __device__ __forceinline__ int steps() const {
    if constexpr (MASKED) return live->count(s0, end);
    return end - s0;
  }
  __device__ __forceinline__ int operator()(int i) {
    if constexpr (MASKED) {
      const int s = cursor;
      cursor = live->next(s + 1, end);
      return s;
    }
    return s0 + i;
  }
};
