// Helpers shared by the Hopper paged-attention kernels (paged_decode.cu,
// paged_prefill.cu): element conversion, vector loads from shared memory,
// cp.async copies into shared memory, the bf16 tensor-core instructions
// (ldmatrix, mma.sync m16n8k16) and the dispatch over dtypes and head
// dims. Every source that includes this header is rebuilt when it
// changes (ops/cuda_build.py hashes csrc/*.cuh into each library).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pst {

// The Pallas kernels' mask: a key that is walked but not visible scores
// MASK_VALUE; a softmax over only such keys gives their uniform average.
constexpr float MASK_VALUE = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
// A key outside the walk (past its end in a partial chunk) scores -inf:
// it takes no part in the softmax, not even as a masked key.
#define NEG_INF __uint_as_float(0xff800000u)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two bf16 packed in one 32-bit word (low half first) -> two floats
__device__ __forceinline__ void unpack_bf16x2(uint32_t u, float* o) {
  o[0] = __uint_as_float(u << 16);
  o[1] = __uint_as_float(u & 0xffff0000u);
}

// N consecutive elements at p as floats, in one vector load of
// N * sizeof(T) bytes (p aligned to that size).
template <int N>
__device__ __forceinline__ void load_f(const float* p, float* o) {
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else {
    static_assert(N == 2, "load_f<float>: N in {2, 4, 8}");
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    unpack_bf16x2(a.x, o); unpack_bf16x2(a.y, o + 2);
    unpack_bf16x2(a.z, o + 4); unpack_bf16x2(a.w, o + 6);
  } else if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(a.x, o); unpack_bf16x2(a.y, o + 2);
  } else {
    static_assert(N == 2, "load_f<bf16>: N in {2, 4, 8}");
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p), o);
  }
}

// two floats -> two consecutive elements at p
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16-byte asynchronous copy global -> shared (L2 only, .cg). With
// valid == false nothing is read and the 16 bytes are zero-filled, so
// rows past the end of a walk hold zeros, never stale values.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix: four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses
// of matrix i, register i returns the calling lane's part of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// A warp's 16 x (8 * NB) attention tile in the mma.sync m16n8k16 register
// layout (FlashAttention-2): lane = 4 * gid + tig holds, for column block
// nb, S[nb][0..1] = row gid, columns 8 nb + 2 tig + {0, 1}, and
// S[nb][2..3] = row gid + 8, the same columns; O[nd][..] likewise over 8-
// column blocks of the head dim. The same layout serves the bf16 tensor-
// core path (qk_mma, pv_mma) and the f32 CUDA-core path (qk_fma, pv_fma),
// so masks and the online softmax are one code.

// Head dims up to which a warp keeps its D/16 Q fragments (4 registers
// each) in registers for the whole walk. Above it they do not fit beside
// the 16 x D f32 accumulator (4 D / 8 registers a thread: 128 at D = 256)
// within the 255 registers a thread may hold, so each k-step reads its
// fragment again from the Q tile in shared memory (qk_mma_smem).
constexpr int MAX_D_Q_IN_REGS = 128;

// Keys of one shared-memory tile (the prefill tile's BN, the decode
// ring's KT): 64, and 32 on the f32 FMA path (any dtype pair but bf16 q
// and cache) above head dim 128, where 64 rows of 4-byte elements in a
// two-stage K/V ring would not fit a block's 227 KB.
template <int D, bool MMA>
constexpr int key_tile() {
  return (D > MAX_D_Q_IN_REGS && !MMA) ? 32 : 64;
}

// The A fragment of k-step kk of the 16 query rows at Qs (row stride
// QROW).
template <int QROW>
__device__ __forceinline__ void load_q_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* Qs, int kk,
                                            int lane) {
  ldmatrix_x4(a, Qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * QROW +
                     kk * 16 + (lane >> 4) * 8);
}

// A fragments of the 16 query rows at Qs, all D/16 k-steps.
template <int D, int QROW>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const __nv_bfloat16* Qs,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_q_frag<QROW>(qf[kk], Qs, kk, lane);
}

// S += Q K^T over k-step kk (head-dim columns 16 kk .. 16 kk + 15) for
// the 8 NB keys whose rows start at Ks (stride KROW).
template <int NB, int KROW>
__device__ __forceinline__ void qk_mma_step(float (&S)[NB][4],
                                            const uint32_t (&a)[4],
                                            const __nv_bfloat16* Ks, int kk,
                                            int lane) {
#pragma unroll
  for (int nbp = 0; nbp < NB / 2; ++nbp) {
    uint32_t b[4];
    ldmatrix_x4(b, Ks + (nbp * 16 + (lane & 7) + (lane >> 4) * 8) * KROW +
                       kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16_16816(S[2 * nbp], a, b[0], b[1]);
    mma_bf16_16816(S[2 * nbp + 1], a, b[2], b[3]);
  }
}

// S += Q K^T, Q from its fragments in registers.
template <int D, int NB, int KROW>
__device__ __forceinline__ void qk_mma(float (&S)[NB][4],
                                       const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* Ks, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    qk_mma_step<NB, KROW>(S, qf[kk], Ks, kk, lane);
}

// S += Q K^T, each k-step's Q fragment read from the Q tile at Qs (head
// dims above MAX_D_Q_IN_REGS).
template <int D, int NB, int QROW, int KROW>
__device__ __forceinline__ void qk_mma_smem(float (&S)[NB][4],
                                            const __nv_bfloat16* Qs,
                                            const __nv_bfloat16* Ks,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_q_frag<QROW>(a, Qs, kk, lane);
    qk_mma_step<NB, KROW>(S, a, Ks, kk, lane);
  }
}

// O += P V: P from S (rounded to bf16), V rows at Vs (stride KROW).
template <int D, int NB, int KROW>
__device__ __forceinline__ void pv_mma(float (&O)[D / 8][4],
                                       const float (&S)[NB][4],
                                       const __nv_bfloat16* Vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(S[2 * kk][0], S[2 * kk][1]);
    a[1] = pack_bf16x2(S[2 * kk][2], S[2 * kk][3]);
    a[2] = pack_bf16x2(S[2 * kk + 1][0], S[2 * kk + 1][1]);
    a[3] = pack_bf16x2(S[2 * kk + 1][2], S[2 * kk + 1][3]);
#pragma unroll
    for (int ndp = 0; ndp < D / 16; ++ndp) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KROW +
                 ndp * 16 + (lane >> 4) * 8);
      mma_bf16_16816(O[2 * ndp], a, b[0], b[1]);
      mma_bf16_16816(O[2 * ndp + 1], a, b[2], b[3]);
    }
  }
}

// The same products with f32 FMAs out of shared memory, any element
// types. row1 == false skips rows gid + 8 (decode pads its g rows to 16).
template <int D, int NB, int QROW, int KROW, typename TQ, typename TC>
__device__ __forceinline__ void qk_fma(float (&S)[NB][4], const TQ* Qs,
                                       const TC* Ks, int lane, bool row1) {
  const int gid = lane >> 2, tig = lane & 3;
  const TQ* q0 = Qs + gid * QROW;
  const TQ* q1 = q0 + 8 * QROW;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float a0[4], a1[4] = {0.f, 0.f, 0.f, 0.f};
    load_f<4>(q0 + c, a0);
    if (row1) load_f<4>(q1 + c, a1);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float kf[4];
        load_f<4>(Ks + (nb * 8 + tig * 2 + e) * KROW + c, kf);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          S[nb][e] = fmaf(a0[x], kf[x], S[nb][e]);
          S[nb][2 + e] = fmaf(a1[x], kf[x], S[nb][2 + e]);
        }
      }
    }
  }
}

// O += P V with P staged through the warp's 16 x (8 NB) f32 buffer Pw.
template <int D, int NB, int KROW, typename TC>
__device__ __forceinline__ void pv_fma(float (&O)[D / 8][4],
                                       const float (&S)[NB][4], float* Pw,
                                       const TC* Vs, int lane, bool row1) {
  constexpr int W = 8 * NB;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    Pw[gid * W + nb * 8 + tig * 2] = S[nb][0];
    Pw[gid * W + nb * 8 + tig * 2 + 1] = S[nb][1];
    Pw[(gid + 8) * W + nb * 8 + tig * 2] = S[nb][2];
    Pw[(gid + 8) * W + nb * 8 + tig * 2 + 1] = S[nb][3];
  }
  __syncwarp();
#pragma unroll 4
  for (int key = 0; key < W; ++key) {
    const float p0 = Pw[gid * W + key];
    const float p1 = row1 ? Pw[(gid + 8) * W + key] : 0.f;
    const TC* vrow = Vs + key * KROW + tig * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      float v[2];
      load_f<2>(vrow + nd * 8, v);
      O[nd][0] = fmaf(p0, v[0], O[nd][0]);
      O[nd][1] = fmaf(p0, v[1], O[nd][1]);
      O[nd][2] = fmaf(p1, v[0], O[nd][2]);
      O[nd][3] = fmaf(p1, v[1], O[nd][3]);
    }
  }
  __syncwarp();  // Pw is rewritten by the next tile
}

// One online-softmax step over a tile of scaled, masked scores: row maxima
// over the 4 lanes of a row, S -> exp(S - m_new), per-lane partial row
// sums l (summed over the 4 lanes at the end), O rescaled.
template <int NB, int ND>
__device__ __forceinline__ void online_softmax(float (&S)[NB][4],
                                               float (&O)[ND][4], float& m0,
                                               float& m1, float& l0,
                                               float& l1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    mx0 = fmaxf(mx0, fmaxf(S[nb][0], S[nb][1]));
    mx1 = fmaxf(mx1, fmaxf(S[nb][2], S[nb][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, o));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    S[nb][0] = __expf(S[nb][0] - mn0);
    S[nb][1] = __expf(S[nb][1] - mn0);
    S[nb][2] = __expf(S[nb][2] - mn1);
    S[nb][3] = __expf(S[nb][3] - mn1);
    rs0 += S[nb][0] + S[nb][1];
    rs1 += S[nb][2] + S[nb][3];
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    O[nd][0] *= c0;
    O[nd][1] *= c0;
    O[nd][2] *= c1;
    O[nd][3] *= c1;
  }
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB needs
// it); *granted remembers the most already granted to this kernel, so the
// attribute is set only when a launch needs more.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

}  // namespace pst

// Dispatch over (q dtype, cache dtype, head dim): dtype codes 0 = float32,
// 1 = bfloat16; head dims 64, 128 and 256. CALL(TQ, TC, D) is an
// expression returning int (a CUDA error code).
#define PST_DISPATCH_TYPES_D(qdt, cdt, d, CALL)                         \
  do {                                                                  \
    if ((qdt) < 0 || (qdt) > 1 || (cdt) < 0 || (cdt) > 1 ||             \
        ((d) != 64 && (d) != 128 && (d) != 256))                        \
      return (int)cudaErrorInvalidValue;                                \
    switch (((qdt) * 2 + (cdt)) * 3 + ((d) == 128) + 2 * ((d) == 256)) { \
      case 0: return CALL(float, float, 64);                            \
      case 1: return CALL(float, float, 128);                           \
      case 2: return CALL(float, float, 256);                           \
      case 3: return CALL(float, __nv_bfloat16, 64);                    \
      case 4: return CALL(float, __nv_bfloat16, 128);                   \
      case 5: return CALL(float, __nv_bfloat16, 256);                   \
      case 6: return CALL(__nv_bfloat16, float, 64);                    \
      case 7: return CALL(__nv_bfloat16, float, 128);                   \
      case 8: return CALL(__nv_bfloat16, float, 256);                   \
      case 9: return CALL(__nv_bfloat16, __nv_bfloat16, 64);            \
      case 10: return CALL(__nv_bfloat16, __nv_bfloat16, 128);          \
      default: return CALL(__nv_bfloat16, __nv_bfloat16, 256);          \
    }                                                                   \
  } while (0)
