// The tensor-core attention tile shared by the prefill and ragged kernels
// (paged_prefill.cu, paged_attention.cu): one thread block attends BM = 64
// fused query rows of one contiguous chunk of a sequence, for one kv head,
// over a given range of the sequence's pages.
//
// A chunk is t query rows at positions q_start, q_start + 1, ...; row r,
// query head h * g + j sits at q[(r * nq + h * g + j) * D] (out likewise).
// Fused row f = r * g + j (the Pallas packing). Key p lives in slot
// table[p / bs] * bs + p % bs of the head-major cache (L, nkv, slots, d);
// offsets are 64-bit. The tile walks pages [n_start, n_used); a walked
// key p is visible to a row at position q when p <= q and, with a window,
// p > q - window; an invisible walked key scores MASK_VALUE; f32 online
// softmax; out = acc / max(l, 1e-30) (0 for a tile that walks no page).
//
// - Key tiles of BN keys (64; 32 on the FMA path at head dim 256,
//   attention_common.cuh key_tile) are assembled from their BN / bs pages
//   through the table with 16-byte cp.async into a two-stage shared-memory
//   ring (tile j + 1 in flight while tile j is computed); rows are padded
//   by 16 bytes so ldmatrix reads are free of bank conflicts. Block sizes
//   are powers of two, so a key's slot is a shift and a mask.
// - bf16 q and cache: S = Q K^T and O += P V on the tensor cores with
//   mma.sync m16n8k16 (f32 accumulators; Q fragments loaded once with
//   ldmatrix up to head dim 128, at 256 read again from the Q tile at
//   each k-step so the 16 x 256 accumulator keeps its 128 registers a
//   thread; K with ldmatrix, V with ldmatrix.trans), the FlashAttention-2
//   register layout, P rounded to bf16 for the PV product. The scale is
//   applied to the f32 scores. Only the key tiles that hold a causal or
//   window edge or the walk's end are masked. In bf16 the output stays
//   within 2^-6 * max|ref| per (row, head) of the plain f32-softmax
//   version (one output rounding plus the rounding of P).
// - Any other dtype pair: the same tiles, ring, masks and register layout,
//   with f32 CUDA-core FMAs out of shared memory in place of the two MMAs
//   (P goes through a per-warp shared buffer).
// - At head dim 256 a block's shared memory (168,960 bytes in bf16)
//   leaves room for one block an SM, so the kernels declare one block an
//   SM there and two below (min_blocks).
// - Warp w owns fused rows [16 w, 16 w + 16) of the tile. Rows past t * g
//   (a partly filled tile) read no q, are zero and are never stored. A
//   warp whose rows all lie past t * g computes on zeros all the same: a
//   warp-uniform branch around its products slowed every kernel on the
//   card (PERF.md). A chunk of at most 16 fused rows can take the
//   KSPLIT form instead (below).
#pragma once

#include "attention_common.cuh"

namespace pst {
namespace tile {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 64;  // fused query rows per block (16 per warp)
constexpr int ROW_PAD_BYTES = 16;

// Blocks an SM the kernels' __launch_bounds__ promise at head dim D: two
// up to 128 (85 KB of shared memory a block in bf16), one at 256.
template <int D>
constexpr int min_blocks() {
  return D > MAX_D_Q_IN_REGS ? 1 : 2;
}

// What every tile of one launch shares: the cache and its geometry, the
// head counts and the softmax constants.
struct CacheArgs {
  const void* k_cache;
  const void* v_cache;
  int layer, nq, nkv, g;
  int64_t slots;
  int bs, bs_shift, num_pages;
  float scale;
  int window;
};

// Fills *a; false when the shapes are not ones the tile takes (g a whole
// number, block size a power of two).
inline bool make_cache_args(const void* k_cache, const void* v_cache,
                            int layer, int nq, int nkv, int64_t slots,
                            int bs, int num_pages, float scale, int window,
                            CacheArgs* a) {
  if (nkv <= 0 || nq % nkv || bs <= 0 || (bs & (bs - 1))) return false;
  a->k_cache = k_cache; a->v_cache = v_cache;
  a->layer = layer; a->nq = nq; a->nkv = nkv; a->g = nq / nkv;
  a->slots = slots; a->bs = bs; a->bs_shift = __builtin_ctz(bs);
  a->num_pages = num_pages; a->scale = scale; a->window = window;
  return true;
}

template <typename TQ, typename TC, int D>
struct Geo {
  static constexpr bool MMA =
      sizeof(TQ) == 2 && sizeof(TC) == 2;  // bf16 q and cache
  static constexpr int QROW = D + ROW_PAD_BYTES / sizeof(TQ);
  static constexpr int KROW = D + ROW_PAD_BYTES / sizeof(TC);
  static constexpr int BN = key_tile<D, MMA>();  // keys per tile
  static constexpr int NB = BN / 8;   // 8-key column blocks of S
  static constexpr int ND = D / 8;    // 8-column blocks of O
  static constexpr bool QREG = D <= MAX_D_Q_IN_REGS;  // Q frags in regs
};

// Dynamic shared memory: the Q tile, the two-stage K/V ring and, on the
// FMA path, each warp's 16 x BN block of P. Mirrored by
// ops/paged_attention._prefill_smem.
template <typename TQ, typename TC, int D>
size_t smem_bytes() {
  using G = Geo<TQ, TC, D>;
  return sizeof(TQ) * size_t(BM) * G::QROW +
         sizeof(TC) * size_t(2 * 2 * G::BN) * G::KROW +
         (G::MMA ? 0 : sizeof(float) * size_t(WARPS) * 16 * G::BN);
}

// Fused rows [tile * BM, tile * BM + BM) of kv head h of the chunk (q, out,
// q_start, t) over pages [n_start, n_used) of `table`. Every thread of the
// block calls it with the same arguments.
//
// KSPLIT (a chunk of at most 16 fused rows, tile 0): every warp holds the
// same 16 rows and takes keys [w BN / 4, (w + 1) BN / 4) of each key tile
// with its own online softmax, and the four warps' (m, l, acc) merge
// through the ring at the end, as the decode kernel's warps do.
// Otherwise warp w owns rows [16 w, 16 w + 16) and all BN keys of each
// tile.
template <typename TQ, typename TC, int D, bool KSPLIT = false>
__device__ __forceinline__ void attend_tile(
    const CacheArgs& p, const TQ* __restrict__ q, TQ* __restrict__ out,
    const int* __restrict__ table, int q_start, int t, int tile, int h,
    int n_start, int n_used, unsigned char* smem) {
  using G = Geo<TQ, TC, D>;
  constexpr int BN = G::BN;
  constexpr int NBW = KSPLIT ? BN / 32 : G::NB;  // 8-key blocks a warp
  const int g = p.g;
  const int n_rows = t * g;
  const int f0 = tile * BM;
  const int f_last = min(f0 + BM, n_rows) - 1;
  const int qpos_lo = q_start + f0 / g;
  const int qpos_hi = q_start + f_last / g;
  const int k_lo = n_start * p.bs, k_hi = n_used * p.bs;
  const int n_kt = (k_hi - k_lo + BN - 1) / BN;

  TQ* Qs = reinterpret_cast<TQ*>(smem);
  TC* ring = reinterpret_cast<TC*>(smem + sizeof(TQ) * BM * G::QROW);
  float* Ps = reinterpret_cast<float*>(ring + 2 * 2 * BN * G::KROW);

  const int64_t head = ((int64_t)p.layer * p.nkv + h) * p.slots;
  const TC* kbase = static_cast<const TC*>(p.k_cache) + head * D;
  const TC* vbase = static_cast<const TC*>(p.v_cache) + head * D;

  // Q tile: fused row f -> q[f / g, h * g + f % g, :]
  {
    constexpr int V = 16 / sizeof(TQ), CH = D / V;
    for (int idx = threadIdx.x; idx < BM * CH; idx += THREADS) {
      const int r = idx / CH, ch = idx % CH;
      const int f = f0 + r;
      const bool ok = f < n_rows;
      const int64_t off =
          ok ? ((int64_t)(f / g) * p.nq + h * g + f % g) * D + ch * V : 0;
      cp_async16(Qs + r * G::QROW + ch * V, q + off, ok);
    }
  }
  // K/V tile kt -> ring stage: each thread copies 16-byte piece ch of
  // rows r0, r0 + THREADS / CH, ...; all its table reads are issued before
  // its copies
  auto load_tile = [&](int kt, int stage) {
    constexpr int V = 16 / sizeof(TC), CH = D / V, IT = BN * CH / THREADS;
    static_assert(THREADS % CH == 0, "a thread keeps one 16-byte column");
    TC* ks = ring + stage * 2 * BN * G::KROW;
    TC* vs = ks + BN * G::KROW;
    const int k0 = k_lo + kt * BN, ch = threadIdx.x % CH;
    int64_t off[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int kp = k0 + (threadIdx.x + it * THREADS) / CH;
      off[it] = kp < k_hi ? (((int64_t)table[kp >> p.bs_shift]
                              << p.bs_shift) + (kp & (p.bs - 1))) * D +
                                ch * V
                          : -1;
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int r = (threadIdx.x + it * THREADS) / CH;
      const bool ok = off[it] >= 0;
      cp_async16(ks + r * G::KROW + ch * V, kbase + (ok ? off[it] : 0), ok);
      cp_async16(vs + r * G::KROW + ch * V, vbase + (ok ? off[it] : 0), ok);
    }
  };
  if (n_kt > 0) load_tile(0, 0);
  cp_async_commit();  // group 0: the Q tile and key tile 0

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int rw = KSPLIT ? 0 : warp * 16;  // the warp's first row
  const int kw = KSPLIT ? warp * (BN / WARPS) : 0;  // its first key
  // rows of this thread's accumulator fragments: rw + gid and rw + gid + 8
  const int qp0 = q_start + (f0 + rw + gid) / g;
  const int qp1 = q_start + (f0 + rw + gid + 8) / g;

  float O[G::ND][4];
#pragma unroll
  for (int nd = 0; nd < G::ND; ++nd)
    O[nd][0] = O[nd][1] = O[nd][2] = O[nd][3] = 0.f;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  // bf16 path up to MAX_D_Q_IN_REGS: Q fragments, loaded once
  [[maybe_unused]] uint32_t qf[G::QREG ? D / 16 : 1][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, at kt == 0, the Q tile) landed
    const TC* Ks = ring + (kt & 1) * 2 * BN * G::KROW + kw * G::KROW;
    const TC* Vs = Ks + BN * G::KROW;
    const int k0 = k_lo + kt * BN + kw;

    // ---- S = Q K^T (16 x 8 NBW per warp) ----
    float S[NBW][4];
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb)
      S[nb][0] = S[nb][1] = S[nb][2] = S[nb][3] = 0.f;
    if constexpr (G::MMA && G::QREG) {
      if (kt == 0) load_q_frags<D, G::QROW>(qf, Qs + rw * G::QROW, lane);
      qk_mma<D, NBW, G::KROW>(S, qf, Ks, lane);
    } else if constexpr (G::MMA) {
      qk_mma_smem<D, NBW, G::QROW, G::KROW>(S, Qs + rw * G::QROW, Ks, lane);
    } else {
      qk_fma<D, NBW, G::QROW, G::KROW>(S, Qs + rw * G::QROW, Ks, lane, true);
    }

    // ---- scale, mask the edge tiles, online softmax ----
    const bool edge = k0 + 8 * NBW > k_hi || k0 + 8 * NBW - 1 > qpos_lo ||
                      (p.window > 0 && k0 <= qpos_hi - p.window);
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = S[nb][e] * p.scale;
        if (edge) {
          const int kp = k0 + nb * 8 + tig * 2 + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp >= k_hi)
            s = NEG_INF;
          else if (kp > qp || (p.window > 0 && kp <= qp - p.window))
            s = MASK_VALUE;
        }
        S[nb][e] = s;
      }
    }
    online_softmax(S, O, m0, m1, l0, l1);

    // ---- O += P V ----
    if constexpr (G::MMA)
      pv_mma<D, NBW, G::KROW>(O, S, Vs, lane);
    else
      pv_fma<D, NBW, G::KROW>(O, S, Ps + warp * 16 * BN, Vs, lane, true);
    __syncthreads();  // stage (kt & 1) is refilled by tile kt + 2
  }
  if (n_kt == 0) cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(FULL_MASK, l0, o);
    l1 += __shfl_xor_sync(FULL_MASK, l1, o);
  }
  if constexpr (KSPLIT) {
    // ---- merge the warps over the ring: m, l (WARPS x 16), acc ----
    static_assert(sizeof(TC) * 2 * 2 * BN * G::KROW >=
                      sizeof(float) * WARPS * 16 * (D + 2),
                  "the warps' partial results fit in the ring");
    float* rm = reinterpret_cast<float*>(ring);
    float* rl = rm + WARPS * 16;
    float* ra = rl + WARPS * 16;
    if (tig == 0) {
      rm[warp * 16 + gid] = m0;
      rl[warp * 16 + gid] = l0;
      rm[warp * 16 + gid + 8] = m1;
      rl[warp * 16 + gid + 8] = l1;
    }
    float* a = ra + (warp * 16 + gid) * D + tig * 2;
#pragma unroll
    for (int nd = 0; nd < G::ND; ++nd) {
      a[nd * 8] = O[nd][0];
      a[nd * 8 + 1] = O[nd][1];
      a[8 * D + nd * 8] = O[nd][2];
      a[8 * D + nd * 8 + 1] = O[nd][3];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n_rows * D; idx += THREADS) {
      const int f = idx / D, c = idx % D;
      float mm = MASK_VALUE;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, rm[w * 16 + f]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float e = __expf(rm[w * 16 + f] - mm);
        ll += rl[w * 16 + f] * e;
        aa += ra[(w * 16 + f) * D + c] * e;
      }
      out[((int64_t)(f / g) * p.nq + h * g + f % g) * D + c] =
          from_f<TQ>(aa / fmaxf(ll, 1e-30f));
    }
    return;
  }

  // ---- out = O / max(l, 1e-30) for the rows that exist ----
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int fa = f0 + rw + gid, fb = fa + 8;
  if (fa < n_rows) {
    TQ* o = out + ((int64_t)(fa / g) * p.nq + h * g + fa % g) * D + tig * 2;
#pragma unroll
    for (int nd = 0; nd < G::ND; ++nd)
      store2(o + nd * 8, O[nd][0] / d0, O[nd][1] / d0);
  }
  if (fb < n_rows) {
    TQ* o = out + ((int64_t)(fb / g) * p.nq + h * g + fb % g) * D + tig * 2;
#pragma unroll
    for (int nd = 0; nd < G::ND; ++nd)
      store2(o + nd * 8, O[nd][2] / d1, O[nd][3] / d1);
  }
}

}  // namespace tile
}  // namespace pst
