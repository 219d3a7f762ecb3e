// Probe of Hopper's sparse tensor-core instruction, for the operand layout
// the nm_spmm sparse body (nm_spmm_sp.cuh) relies on.
//
//   mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32
//
// One warp loads its operand registers exactly as the host lays them out
// (4 words of A, 4 of B and one metadata word per lane), runs one
// instruction with sparsity selector 0, and stores its 4 fp32 results per
// lane.  The host (kernels/mma_sp_probe.py) owns every layout assumption:
// it builds the registers from a known 16 x 32 2:4 matrix and a 32 x 8
// matrix, and compares the product with the plain one, so the fragment
// maps of A, B, D and the metadata word are pinned on the card without a
// rebuild.  Bound: none (one instruction); it exists to be right.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mma_sp_probe_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                    const uint32_t* __restrict__ e, float* __restrict__ d) {
  const int lane = threadIdx.x;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const uint4 av = reinterpret_cast<const uint4*>(a)[lane];
  const uint4 bv = reinterpret_cast<const uint4*>(b)[lane];
  asm volatile(
      "mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, 0x0;\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(av.x), "r"(av.y), "r"(av.z), "r"(av.w), "r"(bv.x), "r"(bv.y), "r"(bv.z),
        "r"(bv.w), "r"(e[lane]));
  reinterpret_cast<float4*>(d)[lane] = make_float4(c[0], c[1], c[2], c[3]);
}

}  // namespace

extern "C" {

// a, b: 32 lanes x 4 words; e: 32 words; d: 32 lanes x 4 floats.
int vg_mma_sp_probe(const void* a, const void* b, const void* e, void* d, void* stream) {
  mma_sp_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(e), static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
