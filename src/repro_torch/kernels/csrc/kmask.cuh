// The activation-sparsity block skip shared by the masked GEMM kernels
// (K10: tile_gemm_masked, nm_spmm_masked, nm_spmm_gather_bk_masked, in
// gemm.cu, gemm_int8.cu and gemm_fp8.cu; bf16 nm_spmm_masked at n in {1, 2}
// in nm_spmm_sp.cuh's stream, which walks the live steps of its split's
// span).
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
