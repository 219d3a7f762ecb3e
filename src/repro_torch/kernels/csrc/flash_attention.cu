// Hand-written Hopper (sm_90a) flash attention for repro_torch, causal or
// not: online-softmax attention over (B, Hq, T, D) bf16 with grouped KV
// heads, for head_dim D in {64, 80, 96, 128, 256}, in the FlashAttention-2
// form, everything of one query tile held in registers.
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
// the softmax.  exp is exp2 with scale * log2(e) folded into the scores.
//
// Layout.  One block of 128 threads (4 warps) owns BQ query rows of one
// (batch, query head): 64, warp w rows 16w .. 16w + 15; at D <= 80, 128,
// warp w rows 32w .. 32w + 31 as two m16 tiles (see Tile).  The heaviest
// causal tiles are scheduled first.  GQA: the block reads KV head h / (Hq
// / Hkv) itself, so K and V are never repeated in memory.  q, k, v and o
// are addressed through (batch, head, token) element strides with the
// head_dim contiguous, so the model's (B, T, H, D) projections are read
// and written in place.  Rows at or beyond T load as zeros (cp.async
// zero-fill), their keys are masked, and their outputs are not stored.
//
// Per KV step of BKV keys (64; 32 at D = 256): K and V arrive through a
// double-buffered cp.async ring, step j + 1 loading while step j computes.
// Each warp forms S = Q K^T (16 x BKV per query tile) with mma.sync
// m16n8k16 bf16 into fp32 registers: Q's A fragments are loaded once with
// ldmatrix (re-read from shared memory each step at D = 256, to keep the
// 128 fp32 of O a thread in registers, and with two query tiles a warp),
// K's B fragments with ldmatrix, each serving the warp's query tiles.  The C
// fragment puts a row's scores on the four lanes of a quad, so the row max
// and sum take two shuffles each and exp runs on every lane.  P converts
// to bf16 in registers and is the A fragment of O += P V directly (V's B
// fragments by ldmatrix.trans); S and P never touch shared memory.  O, m
// and l stay in fp32 registers for the whole KV loop; O is rescaled in
// registers and written once, after o / l.
//
// What bounds it on an H100.  Attention does 4 * D flops per (query, key)
// pair it scores (causal: those at or below the diagonal; not causal: all
// T^2: hubert-xlarge's 8 x 500 frames, 16 heads of 80, come to 10.2 GFLOP
// on 41 MB, bytes-bound at 12.2 us) and moves q, k, v and o once.  At
// prefill (T = 2048, D = 128, 16 query heads over 8 KV heads) that is 17.2
// GFLOP on 25 MB, above the bf16 ridge (~295 flop/byte), so the
// tensor-core rate bounds it (17.4 us at 989 TFLOP/s).  Not done here:
// wgmma and warp specialisation (the FA3 form), TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Tiles for head_dim D (bf16 pitch D + 8: the 8 rows of an ldmatrix fall
// on distinct banks).  At D <= 80 a warp owns two m16 query tiles (32
// rows, FlashAttention-2's split: each K and V fragment serves both); in
// development runs on the H100 that was faster at hubert-xlarge's 8 x
// 500, D 80, and slower at D 96, where the 2 x 48 fp32 of O take the
// registers.  Shared bytes: Q (BQ rows) + two stages of K and V: 55,296
// (D 64), 67,584 (80), 66,560 (96), 87,040 (128), 101,376 (256, BKV 32),
// all under the 227 KB a block may opt into
// (flash_attention/kernel.py::tile_config mirrors this).
template <int D>
struct Tile {
  static_assert(D % 16 == 0, "head_dim must be a multiple of the mma k-step");
  static constexpr int MQ = D <= 80 ? 2 : 1;          // m16 query tiles a warp
  static constexpr int BQ = 64 * MQ;                  // query rows a block (4 warps)
  static constexpr int BKV = D > 128 ? 32 : 64;
  static constexpr bool Q_SMEM = D > 128 || MQ > 1;   // Q fragments re-read each KV step
  static constexpr int LD = D + 8;
  static constexpr int Q_BYTES = BQ * LD * 2;
  static constexpr int KV_BYTES = BKV * LD * 2;    // one K or V tile
  static constexpr int BYTES = Q_BYTES + 4 * KV_BYTES;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

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

// D (16 x 8, fp32) += A (16 x 16, bf16, row) x B (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
  using L = Tile<D>;
  constexpr int MQ = L::MQ;
  constexpr int BQ = L::BQ;
  constexpr int BKV = L::BKV;
  constexpr int LD = L::LD;
  constexpr int KD = D / 16;        // k16 chunks of the head_dim (S = Q K^T)
  constexpr int NS = BKV / 8;       // n8 tiles of keys
  constexpr int ND = D / 8;         // n8 tiles of the head_dim (O = P V)
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);           // the KV head of this query head

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  // rows r0 .. r0 + n - 1 of a (T, D) head slice (row stride st) into a
  // tile of pitch LD, 16 bytes per cp.async; rows >= t zero-filled
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long st, int r0,
                       int n) {
    constexpr int CPR = D / 8;
    for (int c = tid; c < n * CPR; c += NTHREADS) {
      const int r = c / CPR;
      const int col = (c % CPR) * 8;
      const bool live = r0 + r < t;
      cp_async16(dst + r * LD + col, src + static_cast<long long>(live ? r0 + r : 0) * st + col,
                 live ? 16 : 0);
    }
  };
  auto k_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::Q_BYTES + st * 2 * L::KV_BYTES);
  };
  auto v_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::Q_BYTES + (st * 2 + 1) * L::KV_BYTES);
  };

  // keys [0, kv_end): causal, blocks past this block's last row are wholly
  // masked; not causal, every key up to T is scored
  const int kv_end = CAUSAL ? min(t, q0 + BQ) : t;
  const int nblk = (kv_end + BKV - 1) / BKV;
  load_rows(qs, qb, q_st, q0, BQ);
  load_rows(k_tile(0), kb, k_st, 0, BKV);
  load_rows(v_tile(0), vb, v_st, 0, BKV);
  cp_async_commit();

  // warp w owns rows 16 MQ w .. + 16 MQ - 1; Q's A fragments of m-tile mq
  // at head_dim chunk kd: q_frag + mq * 16 * LD + kd * 16
  const __nv_bfloat16* q_frag =
      qs + (warp * 16 * MQ + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  uint32_t qf[L::Q_SMEM ? 1 : KD][4];
  float oacc[MQ][ND][4];
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      oacc[mq][dn][0] = oacc[mq][dn][1] = oacc[mq][dn][2] = oacc[mq][dn][3] = 0.f;
  float m_run[MQ][2];
  float l_run[MQ][2];                   // this lane's share of the row sums
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq) {
    m_run[mq][0] = m_run[mq][1] = NEG_INF;
    l_run[mq][0] = l_run[mq][1] = 0.f;
  }
  const float sl2 = scale * LOG2E;
  // this lane's rows: row0 + 16 mq and row0 + 16 mq + 8
  const int row0 = q0 + warp * 16 * MQ + g;

  for (int j = 0; j < nblk; ++j) {
    const int st = j & 1;
    if (j + 1 < nblk) {    // the next step's K and V travel while this one computes
      load_rows(k_tile(st ^ 1), kb, k_st, (j + 1) * BKV, BKV);
      load_rows(v_tile(st ^ 1), vb, v_st, (j + 1) * BKV, BKV);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if constexpr (!L::Q_SMEM) {
      if (j == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) ldsm_x4(qf[kd], q_frag + kd * 16);
      }
    }

    // S (16 MQ x BKV) = Q K^T, fp32 in registers; each K fragment serves
    // the warp's MQ query tiles
    const __nv_bfloat16* ks = k_tile(st);
    float s[MQ][NS][4];
#pragma unroll
    for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
      for (int nn = 0; nn < NS; ++nn) s[mq][nn][0] = s[mq][nn][1] = s[mq][nn][2] = s[mq][nn][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[MQ][4];
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq) {
        if constexpr (L::Q_SMEM) {
          ldsm_x4(a[mq], q_frag + mq * 16 * LD + kd * 16);
        } else {
          a[mq][0] = qf[kd][0]; a[mq][1] = qf[kd][1]; a[mq][2] = qf[kd][2]; a[mq][3] = qf[kd][3];
        }
      }
#pragma unroll
      for (int nn = 0; nn < NS; nn += 2) {
        uint32_t bk[4];   // keys 8nn .. 8nn + 15 at head_dim 16kd .. 16kd + 15
        ldsm_x4(bk, ks + (nn * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mq = 0; mq < MQ; ++mq) {
          mma16816(s[mq][nn], a[mq], bk[0], bk[1]);
          mma16816(s[mq][nn + 1], a[mq], bk[2], bk[3]);
        }
      }
    }

    // online softmax: lane (g, tq) holds keys 8nn + 2tq, + 1 of rows
    // row0 + 16mq (s[mq][.][0..1]) and + 8 (s[mq][.][2..3]); a row lives on
    // one quad
    const int k0 = j * BKV;
    const bool edge = k0 + BKV > t || (CAUSAL && k0 + BKV - 1 > q0);
    uint32_t pf[MQ][NS / 2][4];   // P as the A fragments of the PV product, 16 keys each
#pragma unroll
    for (int mq = 0; mq < MQ; ++mq) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nn = 0; nn < NS; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float xv = s[mq][nn][e] * sl2;
          if (edge) {
            const int key = k0 + nn * 8 + 2 * tq + (e & 1);
            const int row = row0 + mq * 16 + (e >> 1) * 8;
            if ((CAUSAL && key > row) || key >= t) xv = NEG_INF;
          }
          s[mq][nn][e] = xv;
          mx[e >> 1] = fmaxf(mx[e >> 1], xv);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[mq][r], mx[r]);
        alpha[r] = ex2(m_run[mq][r] - m_new);
        m_run[mq][r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nn = 0; nn < NS; ++nn) {
        const float p0 = ex2(s[mq][nn][0] - m_run[mq][0]);
        const float p1 = ex2(s[mq][nn][1] - m_run[mq][0]);
        const float p2 = ex2(s[mq][nn][2] - m_run[mq][1]);
        const float p3 = ex2(s[mq][nn][3] - m_run[mq][1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[mq][nn >> 1][(nn & 1) * 2] = pack_bf16(p0, p1);       // p in the value dtype
        pf[mq][nn >> 1][(nn & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[mq][r] = l_run[mq][r] * alpha[r] + rs[r];
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        oacc[mq][dn][0] *= alpha[0];
        oacc[mq][dn][1] *= alpha[0];
        oacc[mq][dn][2] *= alpha[1];
        oacc[mq][dn][3] *= alpha[1];
      }
    }

    // O (16 MQ x D) += bf16(P) V; each V fragment serves the MQ query tiles
    const __nv_bfloat16* vs = v_tile(st);
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bv[4];   // keys 16kc .. 16kc + 15 at head_dim 8dn .. 8dn + 15, transposed
        ldsm_x4_trans(bv, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 8 +
                              (lane >> 4) * 8);
#pragma unroll
        for (int mq = 0; mq < MQ; ++mq) {
          mma16816(oacc[mq][dn], pf[mq][kc], bv[0], bv[1]);
          mma16816(oacc[mq][dn + 1], pf[mq][kc], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();     // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int mq = 0; mq < MQ; ++mq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mq][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + mq * 16 + r * 8;
      if (row < t) {
        const float l_safe = l == 0.f ? 1.f : l;
        __nv_bfloat16* dst =
            o + b * o_sb + h * o_sh + static_cast<long long>(row) * o_st + 2 * tq;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn)
          *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) = __floats2bfloat162_rn(
              oacc[mq][dn][2 * r] / l_safe, oacc[mq][dn][2 * r + 1] / l_safe);
      }
    }
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
        Tile<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((t + Tile<D>::BQ - 1) / Tile<D>::BQ, hq, b);
  flash_attention_kernel<D, CAUSAL>
      <<<grid, NTHREADS, Tile<D>::BYTES, static_cast<cudaStream_t>(stream)>>>(
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

int vg_flash_attention(const void* q, const void* k, const void* v, void* o, int b, int hq,
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

// The shared memory a block of head_dim d asks for (0 for any other d).
int vg_flash_attention_smem(int d) {
  switch (d) {
    case 64: return Tile<64>::BYTES;
    case 80: return Tile<80>::BYTES;
    case 96: return Tile<96>::BYTES;
    case 128: return Tile<128>::BYTES;
    case 256: return Tile<256>::BYTES;
    default: return 0;
  }
}

const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
