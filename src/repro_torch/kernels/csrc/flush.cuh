// The fp32 flush functions shared by the port's GEMM kernels (gemm.cu,
// gemm_int8.cu): the activation codes of the C interface and the
// activations of the epilogue lattice, in epilogue.flush_tile's formulation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu's default (approximate=True) formulation
  return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_SILU) return silu(v);
  if (act == ACT_GELU) return gelu_tanh(v);
  return v;
}
