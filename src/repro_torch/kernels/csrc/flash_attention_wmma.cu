// The first Hopper (sm_90a) flash attention body of repro_torch, kept as
// the yardstick that chip_smoke.py times the register-resident body
// (flash_attention.cu) against: the same function, entry point
// vg_flash_attention_wmma.  Not on any path.  wmma 16x16x16 fragments,
// the scores and the fp32 accumulator in shared memory, synchronous K / V
// loads; its note follows as it was written.
//
// Online-softmax attention over (B, Hq, T, D) bf16 with grouped KV heads,
// for head_dim D in {64, 80, 96, 128, 256}, causal or not.
//
// Replaces (JAX package, Pallas on the TPU):
//   flash_attention  repro/kernels/flash_attention/kernel.py::flash_attention
//                    (body _attn_kernel; GQA by the wrapper's jnp.repeat in
//                    flash_attention/ops.py)
//
// What it computes, as the TPU kernel does: for each query row, over KV
// blocks in order, s = (q . k) * scale in fp32, with CAUSAL the mask q_pos
// >= k_pos (top-left aligned) with masked scores at -1e30, a running max m,
// a running sum l += sum(exp(s - m_new)) in fp32, and an fp32 accumulator
// acc = acc * alpha + bf16(p) @ v; at the end o = acc / l (l == 0 read as
// 1), cast to bf16 once.  Causal: KV blocks wholly above the diagonal are
// skipped.  Not causal (an encoder, the TPU kernel's causal=False branch):
// every block runs to T; keys at or past T (the zero-filled ragged edge)
// stay masked in both branches, so a ragged T never lets a zero key into
// the softmax.
//
// Layout.  One block of 128 threads (4 warps) owns 64 query rows of one
// (batch, query head); warp w owns rows 16w..16w+15.  GQA: the block reads
// KV head h / (Hq / Hkv) itself, so K and V are never repeated in memory.
// q, k, v and o are addressed through (batch, head, token) element strides
// with the head_dim contiguous, so the model's (B, T, H, D) projections are
// read and written in place, with no transposed copies.  Rows at or beyond
// T (the ragged edge) load as zeros, their keys are masked, and their
// outputs are not stored, so T need not be a multiple of 64.
//
// Per KV step of 64 keys: the K and V tiles are staged in shared memory;
// each warp contracts its 16 Q rows against the K tile with bf16 wmma
// 16x16x16 fragments into an fp32 score tile in shared memory; two lanes
// per row then apply the scale, the mask and the online-softmax update
// (row max and sum through one shuffle), write p as bf16 and rescale the
// row's fp32 accumulator (kept in shared memory, since a wmma fragment's
// element-to-row map is opaque); then the warp adds bf16(p) @ V into the
// accumulator with wmma.
//
// What bounds it on an H100.  Attention does 4 * D flops per (query, key)
// pair it scores (causal: those at or below the diagonal; not causal: all
// T^2: hubert-xlarge's 8 x 500 frames, 16 heads of 80, come to 10.2 GFLOP
// on 41 MB, bytes-bound at 12.2 us) and moves q, k, v and o once:
// at prefill (T = 2048, D = 128, 16 query heads over 8 KV heads) that is
// 17.2 GFLOP on 25 MB, above the bf16 ridge (~295 flop/byte), so the
// tensor-core rate bounds it (17.4 us at 989 TFLOP/s); at the calibration
// shape (T = 32) the bytes do.  What the design does about it: the S and P tiles never leave
// the SM (the T x T score matrix is never written to device memory), K and
// V are read once per 64 query rows, and causal blocks above the diagonal
// are skipped.  It is far from that bound: wmma instead of wgmma, no TMA or
// cp.async pipeline, and the accumulator round-trips through shared memory
// every KV step.  Making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per block (4 warps x 16)
constexpr int BKV = 64;         // keys per KV step
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;

// Shared-memory layout for head_dim D (byte offsets; every buffer starts on
// a 128-byte boundary and every wmma tile pointer on a 32-byte one: a
// 16-row step of the bf16 tiles is 32 * (D + 8) bytes and of the fp32
// accumulator 64 * (D + 4), both multiples of 32 for D a multiple of 16,
// and a 16-column step is 32 or 64 bytes).  BYTES: 71,680 for D = 64,
// 81,920 for D = 80 (hubert-xlarge), 92,160 for D = 96 (phi-3-vision), so
// two blocks fit per SM; 112,640 for D = 128 and 194,560 for D = 256
// (gemma3's head_dim: Q, K and V at 64 x 264 bf16, the scores at 64 x 68
// fp32, P at 64 x 72 bf16, the accumulator at 64 x 260 fp32), all under
// the 227 KB a block may opt into, so D = 256 runs one block per SM.
template <int D>
struct Smem {
  static_assert(D % 16 == 0, "head_dim must be a multiple of the wmma k-step");
  static constexpr int LDH = D + 8;       // bf16 pitch of the Q, K and V tiles
  static constexpr int LDS = BKV + 4;     // fp32 pitch of the score tile
  static constexpr int LDP = BKV + 8;     // bf16 pitch of the probability tile
  static constexpr int LDO = D + 4;       // fp32 pitch of the output accumulator
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDH * 2;
  static constexpr int V = K + BKV * LDH * 2;
  static constexpr int S = V + BKV * LDH * 2;
  static constexpr int P = S + BQ * LDS * 4;
  static constexpr int O = P + BQ * LDP * 2;
  static constexpr int BYTES = O + BQ * LDO * 4;
};

// Rows r0 .. r0+63 of one (T, D) head slice (row stride st elements) into a
// shared tile of pitch D + 8, 16 bytes per load (D / 8 of them a row: 10
// for D = 80, 12 for D = 96); rows >= t read as zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int t, int tid) {
  constexpr int CPR = D / 8;    // 16-byte chunks per row
  for (int c = tid; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * st + col);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = val;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int hq, int hkv, int t,
                       long long q_sb, long long q_sh, long long q_st,
                       long long k_sb, long long k_sh, long long k_st,
                       long long v_sb, long long v_sh, long long v_st,
                       long long o_sb, long long o_sh, long long o_st,
                       float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  float* ss = reinterpret_cast<float*>(smem + L::S);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  float* os = reinterpret_cast<float*>(smem + L::O);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);           // the KV head of this query head

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  load_tile<D>(qs, qb, q_st, q0, t, tid);
  for (int e = tid; e < BQ * L::LDO; e += NTHREADS) os[e] = 0.f;

  // two lanes per query row: lane pair (2i, 2i+1) owns local row 16w + i,
  // each lane half of its scores and half of its D output columns (40 for
  // D = 80, 48 for D = 96)
  const int rl = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qpos = q0 + rl;
  float m = NEG_INF;
  float l = 0.f;
  // keys [0, kv_end): causal, blocks past this block's last row are wholly
  // masked; not causal, every key up to T is scored
  const int kv_end = CAUSAL ? min(t, q0 + BQ) : t;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();     // the previous step is done with K and V (and Q, O are ready)
    load_tile<D>(ks, kb, k_st, k0, t, tid);
    load_tile<D>(vs, vb, v_st, k0, t, tid);
    __syncthreads();

    // S (16 x 64 per warp) = Q K^T, fp32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + warp * 16 * L::LDH + kk * 16, L::LDH);
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        // K^T as a column-major (D x keys) operand: element (d, key) at key * LDH + d
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, ks + j * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(sacc[j], a, bk, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j)
      wmma::store_matrix_sync(ss + warp * 16 * L::LDS + j * 16, sacc[j], L::LDS,
                              wmma::mem_row_major);
    __syncwarp();

    // online softmax over this row's 64 scores (32 per lane)
    const float* srow = ss + rl * L::LDS + half * 32;
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kpos = k0 + half * 32 + c;
      float s = __fmul_rn(srow[c], scale);
      if ((CAUSAL && kpos > qpos) || kpos >= t) s = NEG_INF;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    __nv_bfloat16* prow = ps + rl * L::LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16_rn(p);    // p in the value dtype for the PV product
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    float* orow = os + rl * L::LDO + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // O (16 x D per warp) += bf16(P) V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      float* otile = os + warp * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(oacc, otile, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, ps + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(vf, vs + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(oacc, pa, vf, oacc);
      }
      wmma::store_matrix_sync(otile, oacc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qpos < t) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float* orow = os + rl * L::LDO + half * (D / 2);
    __nv_bfloat16* dst = o + b * o_sb + h * o_sh + (long long)qpos * o_st + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) dst[c] = __float2bfloat16_rn(orow[c] / l_safe);
  }
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int t,
           long long q_sb, long long q_sh, long long q_st, long long k_sb, long long k_sh,
           long long k_st, long long v_sb, long long v_sh, long long v_st, long long o_sb,
           long long o_sh, long long o_st, float scale, void* stream) {
  // above 48 KB a block's shared memory must be asked for (once per kernel)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((t + BQ - 1) / BQ, hq, b);
  flash_attention_kernel<D, CAUSAL><<<grid, NTHREADS, Smem<D>::BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq, hkv, t, q_sb,
      q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for head_dim d; cudaErrorInvalidValue for any other d.
template <bool CAUSAL>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
             int t, int d, long long q_sb, long long q_sh, long long q_st, long long k_sb,
             long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
             long long o_sb, long long o_sh, long long o_st, float scale, void* stream) {
#define VG_FLASH_LAUNCH(DIM)                                                                  \
  return launch<DIM, CAUSAL>(q, k, v, o, b, hq, hkv, t, q_sb, q_sh, q_st, k_sb, k_sh, k_st,   \
                             v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale, stream)
  switch (d) {
    case 64: VG_FLASH_LAUNCH(64);
    case 80: VG_FLASH_LAUNCH(80);
    case 96: VG_FLASH_LAUNCH(96);
    case 128: VG_FLASH_LAUNCH(128);
    case 256: VG_FLASH_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VG_FLASH_LAUNCH
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take: a head_dim
// outside {64, 80, 96, 128, 256}, no silent fallback).  causal is 0 or 1.
// Strides are in elements; the head_dim of every operand is contiguous.
extern "C" {

int vg_flash_attention_wmma(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int t, int d, int causal, long long q_sb, long long q_sh,
                       long long q_st, long long k_sb, long long k_sh, long long k_st,
                       long long v_sb, long long v_sh, long long v_st, long long o_sb,
                       long long o_sh, long long o_st, float scale, void* stream) {
  if (b <= 0 || t <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || b > 65535 || hq > 65535 ||
      (causal != 0 && causal != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (causal)
    return launch_d<true>(q, k, v, o, b, hq, hkv, t, d, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                          v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale, stream);
  return launch_d<false>(q, k, v, o, b, hq, hkv, t, d, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                         v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale, stream);
}

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
