// Probes of Hopper's tensor-core instructions, for the operand layouts the
// streaming bodies rely on:
//
//   mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32   (nm_spmm_sp.cuh)
//   mma.sp.sync.aligned.m16n8k64.row.col.f32.e4m3.e4m3.f32   (nm_spmm_sp_fp8.cuh)
//   mma.sp.sync.aligned.m16n8k64.row.col.s32.s8.s8.s32       (its s8 form)
//   mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32      (its dense stream, N = 4)
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32          (that stream's s8 form)
//
// One warp loads its operand registers exactly as the host lays them out
// (4 words of A, 4 of B and one metadata word per lane; the dense forms
// read 2 words of B and no metadata), runs one instruction (the sparse
// ones with sparsity selector 0), and stores its 4 results per lane (fp32,
// or s32 for s8).  The host (kernels/mma_sp_probe.py) owns every layout assumption:
// it builds the registers from a known 2:4 A and a dense B, and compares
// the product with the plain one, so the fragment maps of A, B, D and the
// metadata word are pinned on the card without a rebuild.  Bound: none
// (one instruction); it exists to be right.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { BF16 = 0, E4M3 = 1, S8 = 2, DENSE_E4M3 = 3, DENSE_S8 = 4 };

template <int KIND>
__global__ void mma_sp_probe_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                    const uint32_t* __restrict__ e, float* __restrict__ d) {
  const int lane = threadIdx.x;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const uint4 av = reinterpret_cast<const uint4*>(a)[lane];
  const uint4 bv = reinterpret_cast<const uint4*>(b)[lane];
  if constexpr (KIND == DENSE_S8) {
    int ci[4] = {0, 0, 0, 0};
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(ci[0]), "+r"(ci[1]), "+r"(ci[2]), "+r"(ci[3])
        : "r"(av.x), "r"(av.y), "r"(av.z), "r"(av.w), "r"(bv.x), "r"(bv.y));
    reinterpret_cast<int4*>(d)[lane] = make_int4(ci[0], ci[1], ci[2], ci[3]);
    return;
  } else if constexpr (KIND == DENSE_E4M3) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(av.x), "r"(av.y), "r"(av.z), "r"(av.w), "r"(bv.x), "r"(bv.y));
  } else if constexpr (KIND == S8) {
    int ci[4] = {0, 0, 0, 0};
    asm volatile(
        "mma.sp.sync.aligned.m16n8k64.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, 0x0;\n"
        : "+r"(ci[0]), "+r"(ci[1]), "+r"(ci[2]), "+r"(ci[3])
        : "r"(av.x), "r"(av.y), "r"(av.z), "r"(av.w), "r"(bv.x), "r"(bv.y), "r"(bv.z),
          "r"(bv.w), "r"(e[lane]));
    reinterpret_cast<int4*>(d)[lane] = make_int4(ci[0], ci[1], ci[2], ci[3]);
    return;
  } else if constexpr (KIND == E4M3) {
    asm volatile(
        "mma.sp.sync.aligned.m16n8k64.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, 0x0;\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(av.x), "r"(av.y), "r"(av.z), "r"(av.w), "r"(bv.x), "r"(bv.y), "r"(bv.z),
          "r"(bv.w), "r"(e[lane]));
  } else {
    asm volatile(
        "mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, 0x0;\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(av.x), "r"(av.y), "r"(av.z), "r"(av.w), "r"(bv.x), "r"(bv.y), "r"(bv.z),
          "r"(bv.w), "r"(e[lane]));
  }
  reinterpret_cast<float4*>(d)[lane] = make_float4(c[0], c[1], c[2], c[3]);
}

template <int KIND>
int launch(const void* a, const void* b, const void* e, void* d, void* stream) {
  mma_sp_probe_kernel<KIND><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(e), static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b: 32 lanes x 4 words; e: 32 words; d: 32 lanes x 4 floats (s8: int32).
int vg_mma_sp_probe(const void* a, const void* b, const void* e, void* d, void* stream) {
  return launch<BF16>(a, b, e, d, stream);
}

int vg_mma_sp_probe_e4m3(const void* a, const void* b, const void* e, void* d, void* stream) {
  return launch<E4M3>(a, b, e, d, stream);
}

int vg_mma_sp_probe_s8(const void* a, const void* b, const void* e, void* d, void* stream) {
  return launch<S8>(a, b, e, d, stream);
}

// the dense m16n8k32 forms: b's words 2, 3 and e unused
int vg_mma_probe_e4m3(const void* a, const void* b, const void* e, void* d, void* stream) {
  return launch<DENSE_E4M3>(a, b, e, d, stream);
}

int vg_mma_probe_s8(const void* a, const void* b, const void* e, void* d, void* stream) {
  return launch<DENSE_S8>(a, b, e, d, stream);
}

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
