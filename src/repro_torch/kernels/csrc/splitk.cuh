// The pieces the port's streaming GEMM bodies share (nm_spmm_sp.cuh: the
// float nm_spmm at n in {1, 2}, K1's, K8's and the float gate-up duals'
// few-row streams; nm_spmm_sp_fp8.cuh: nm_spmm_fp8 at n in {1, 2}): the
// cp.async ring of weight and X tiles, ldmatrix, the 1:4-as-2:4 metadata
// spread, and the split of an output tile's K loop over the blocks of a
// thread-block cluster.
//
// Split-K without atomics.  Each block of the cluster writes its fp32
// partial of every slice of the tile into the inbox of the slice's owner
// (distributed shared memory), then one cluster barrier; block r sums its
// slice over ranks 0, 1, .. in that fixed order from its own shared memory
// and flushes it once.  One launch, no workspace: the same inputs give the
// same bits on every launch, whichever block finishes first.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace splitk {

namespace cg = cooperative_groups;

constexpr int MAX_SPLIT = 8;        // a portable cluster size

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

// A 1:4 row's metadata word from its 8 packed 2-bit indices (group j at
// bits 2j): group j's nibble is the pair (0, i), or (0, 1) for i == 0.
__device__ __forceinline__ uint32_t expand_1of4(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;          // index j at bits 4j, 4j + 1
  const uint32_t zero = ~(x | (x >> 1)) & 0x11111111u;
  return (x | zero) << 2;
}

// Block `rank` of `split` takes K steps [s0, s0 + ns) of nk.
__device__ __forceinline__ void span(int rank, int split, int nk, int& s0, int& ns) {
  s0 = static_cast<int>(static_cast<long long>(rank) * nk / split);
  ns = static_cast<int>(static_cast<long long>(rank + 1) * nk / split) - s0;
}

// The ring: load(st, s) issues step s's cp.async copies into stage st;
// compute(st) contracts stage st.  STAGES - 1 steps travel while one is
// contracted.  Returns with the ring drained and every warp past it.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void run_ring(int s0, int ns, Load&& load, Compute&& compute) {
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ns) load(st, s0 + st);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // step i has landed; every warp is done with step i - 1's stage
    if (i + STAGES - 1 < ns) load((i + STAGES - 1) % STAGES, s0 + i + STAGES - 1);
    cp_async_commit();
    compute(i % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();       // the ring is drained: the partial tile may alias it
}

// The split's end.  part: this block's NP fp32 partials (planes p at part
// + p BM PLD, each [BM][PLD] of the BM x BO tile; written and
// synchronized; NP = 2 for a gate-up dual, whose flush combines both);
// inbox: NP x E floats after the ring, E = BM x BO (split > 1 only).  Block
// q owns elements [q E / split, (q + 1) E / split) of the tile (row-major);
// each block stores its partials of every slice into the owner's inbox at
// [its rank][plane][offset in the slice]; after one cluster barrier every
// owner sums its inbox in rank order, plane by plane (the same bits
// whichever block sums them), from its own shared memory, so no block reads
// a peer's memory and none waits for the others to leave.  Then flush(r,
// c, sums) for each of its live rows (r < rows).
template <int BM, int BO, int PLD, int NT, int NP, class Flush>
__device__ __forceinline__ void finish_planes(const float* part, float* inbox, int rank,
                                              int split, int rows, Flush&& flush) {
  constexpr int E = BM * BO;
  const int tid = threadIdx.x;
  const int slice = E / split;        // split is a power of two up to 8: exact
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int q = tid; q < E; q += NT) {
      float* box = cluster.map_shared_rank(inbox, q / slice) + rank * NP * slice + q % slice;
#pragma unroll
      for (int p = 0; p < NP; ++p) box[p * slice] = part[p * BM * PLD + (q / BO) * PLD + q % BO];
    }
    cluster.sync();
  }
  for (int q = rank * slice + tid; q < (rank + 1) * slice; q += NT) {
    const int r = q / BO, c = q % BO, at = q - rank * slice;
    if (r >= rows) continue;
    float s[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      s[p] = part[p * BM * PLD + r * PLD + c];
      if (split > 1) {
        s[p] = inbox[p * slice + at];
        for (int z = 1; z < split; ++z) s[p] += inbox[(z * NP + p) * slice + at];
      }
    }
    flush(r, c, s);
  }
}

// finish_planes with one partial: flush(r, c, sum)
template <int BM, int BO, int PLD, int NT, class Flush>
__device__ __forceinline__ void finish(const float* part, float* inbox, int rank, int split,
                                       int rows, Flush&& flush) {
  finish_planes<BM, BO, PLD, NT, 1>(part, inbox, rank, split, rows,
                                    [&](int r, int c, const float (&s)[1]) { flush(r, c, s[0]); });
}

// A split that the bodies take: a power of two up to min(MAX_SPLIT, nk).
inline bool split_ok(int split, int nk) {
  return split >= 1 && split <= MAX_SPLIT && (split & (split - 1)) == 0 && split <= nk;
}

// Launch `kernel` on a (1, 1, split) cluster grid.  `opted_in` is the
// caller's per-kernel flag: above 48 KB a block's shared memory is asked
// for once, at its largest (ring + inbox).
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), bool& opted_in, dim3 grid, int threads, int ring_bytes,
           int inbox_bytes, int split, cudaStream_t stream, Args... args) {
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes + inbox_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x, grid.y, split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = ring_bytes + (split > 1 ? inbox_bytes : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace splitk
