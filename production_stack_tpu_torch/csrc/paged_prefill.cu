// pst_paged_prefill_attention: chunked-prefill paged GQA attention for one
// sequence, for Hopper (sm_90a). Replaces paged_prefill_attention /
// _prefill_kernel of production_stack_tpu/ops/pallas_attention.py.
//
// What it computes: the chunk's t query rows at positions q_start + r
// over the sequence's pages in the head-major cache (L, nkv, slots, d)
// (key p lives in slot table[p / bs] * bs + p % bs; 64-bit offsets).
// Fused row f = r * g + j is query row r, head h * g + j of kv head h
// (the Pallas packing). Key p is visible to a row at position q when
// p <= q and, with a window, p > q - window; a walked but invisible key
// scores MASK_VALUE; f32 online softmax; out = acc / max(l, 1e-30).
//
// What bounds it: operations. A 512-row chunk at q_start 1024 does about
// 4 * 1280 * 24 * 128 flops per row, some 8 GFLOP, against some 5 MB of
// K/V bytes: far above the card's 295 flops per byte, so only the tensor
// cores come near its bound. The design:
//
// - Grid (ceil(t * g / 64), nkv): a block owns BM = 64 fused rows of one
//   kv head (4 warps x 16 rows) and walks key tiles of BN = 64 keys from
//   the page of its earliest visible key (window) to the page of its last
//   row's position; key tiles wholly above its last row are never walked.
//   The tiles with the latest rows (most keys) start first. Rows past
//   t * g (a partly filled last tile) read no q, are zero and are never
//   stored.
// - Each K/V tile is assembled from its 64 / bs pages through the block
//   table with 16-byte cp.async into a two-stage shared-memory ring (tile
//   j + 1 in flight while tile j is computed); rows are padded by 16
//   bytes so ldmatrix reads are free of bank conflicts. Block sizes are
//   powers of two, so a key's slot is a shift and a mask.
// - bf16 q and cache: S = Q K^T and O += P V on the tensor cores with
//   mma.sync m16n8k16 (f32 accumulators; Q fragments loaded once with
//   ldmatrix, K with ldmatrix, V with ldmatrix.trans), the FlashAttention-2
//   register layout, P rounded to bf16 for the PV product. The scale is
//   applied to the f32 scores. Only the tiles that hold a causal or
//   window edge or the walk's end are masked.
//   In bf16 the output stays within 2^-6 * max|ref| per (row, head) of
//   the plain f32-softmax version (one output rounding plus the rounding
//   of P), the tolerance chip_smoke.py and the card tests hold it to.
// - Any other dtype pair: the same grid, tiles, ring, masks and register
//   layout, with f32 CUDA-core FMAs out of shared memory in place of the
//   two MMAs (P goes through a per-warp shared buffer).

#include "attention_common.cuh"

namespace {

using namespace pst;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 64;  // fused query rows per block (16 per warp)
constexpr int BN = 64;  // keys per tile
constexpr int ROW_PAD_BYTES = 16;

struct PrefillParams {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  void* out;
  const int* block_table;
  int q_start, layer, t, nq, nkv, g;
  int64_t slots;
  int bs, bs_shift, num_pages;
  float scale;
  int window;
};

template <typename TQ, typename TC, int D>
struct Geo {
  static constexpr bool MMA =
      sizeof(TQ) == 2 && sizeof(TC) == 2;  // bf16 q and cache
  static constexpr int QROW = D + ROW_PAD_BYTES / sizeof(TQ);
  static constexpr int KROW = D + ROW_PAD_BYTES / sizeof(TC);
  static constexpr int NB = BN / 8;   // 8-key column blocks of S
  static constexpr int ND = D / 8;    // 8-column blocks of O
};

// Dynamic shared memory: the Q tile, the two-stage K/V ring and, on the
// FMA path, each warp's 16 x BN block of P. Mirrored by
// ops/paged_attention._prefill_smem.
template <typename TQ, typename TC, int D>
size_t smem_bytes() {
  using G = Geo<TQ, TC, D>;
  return sizeof(TQ) * size_t(BM) * G::QROW +
         sizeof(TC) * size_t(2 * 2 * BN) * G::KROW +
         (G::MMA ? 0 : sizeof(float) * size_t(WARPS) * 16 * BN);
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS, 2) prefill_kernel(
    const PrefillParams p) {
  using G = Geo<TQ, TC, D>;
  const int g = p.g;
  const int n_rows = p.t * g;
  const int n_tiles = (n_rows + BM - 1) / BM;
  const int tile = n_tiles - 1 - blockIdx.x;  // most keys first
  const int h = blockIdx.y;
  const int f0 = tile * BM;
  const int f_last = min(f0 + BM, n_rows) - 1;
  const int qpos_lo = p.q_start + f0 / g;
  const int qpos_hi = p.q_start + f_last / g;
  // pages holding positions [0, qpos_hi]; with a window, from the page of
  // the earliest row's first visible key (Pallas _prefill_kernel)
  const int n_used = min(qpos_hi / p.bs + 1, p.num_pages);
  int n_start = p.window > 0 ? max(qpos_lo - p.window + 1, 0) / p.bs : 0;
  n_start = min(n_start, n_used);
  const int k_lo = n_start * p.bs, k_hi = n_used * p.bs;
  const int n_kt = (k_hi - k_lo + BN - 1) / BN;

  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  TC* ring = reinterpret_cast<TC*>(smem + sizeof(TQ) * BM * G::QROW);
  float* Ps = reinterpret_cast<float*>(ring + 2 * 2 * BN * G::KROW);

  const int64_t head = ((int64_t)p.layer * p.nkv + h) * p.slots;
  const TC* kbase = static_cast<const TC*>(p.k_cache) + head * D;
  const TC* vbase = static_cast<const TC*>(p.v_cache) + head * D;
  const TQ* qg = static_cast<const TQ*>(p.q);

  // Q tile: fused row f -> q[f / g, h * g + f % g, :]
  {
    constexpr int V = 16 / sizeof(TQ), CH = D / V;
    for (int idx = threadIdx.x; idx < BM * CH; idx += THREADS) {
      const int r = idx / CH, ch = idx % CH;
      const int f = f0 + r;
      const bool ok = f < n_rows;
      const int64_t off =
          ok ? ((int64_t)(f / g) * p.nq + h * g + f % g) * D + ch * V : 0;
      cp_async16(Qs + r * G::QROW + ch * V, qg + off, ok);
    }
  }
  // K/V tile kt -> ring stage: each thread copies 16-byte piece ch of
  // rows r0, r0 + THREADS / CH, ...; all its table reads are issued before
  // its copies (block sizes are powers of two: shift and mask)
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
      off[it] = kp < k_hi ? (((int64_t)p.block_table[kp >> p.bs_shift]
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
  const int rw = warp * 16;  // the warp's first row in the tile
  // rows of this thread's accumulator fragments: rw + gid and rw + gid + 8
  const int qp0 = p.q_start + (f0 + rw + gid) / g;
  const int qp1 = p.q_start + (f0 + rw + gid + 8) / g;

  float O[G::ND][4];
#pragma unroll
  for (int nd = 0; nd < G::ND; ++nd)
    O[nd][0] = O[nd][1] = O[nd][2] = O[nd][3] = 0.f;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  uint32_t qf[D / 16][4];  // bf16 path: Q fragments, loaded once

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, at kt == 0, the Q tile) landed
    const TC* Ks = ring + (kt & 1) * 2 * BN * G::KROW;
    const TC* Vs = Ks + BN * G::KROW;
    const int k0 = k_lo + kt * BN;

    // ---- S = Q K^T (16 x 64 per warp) ----
    float S[G::NB][4];
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb)
      S[nb][0] = S[nb][1] = S[nb][2] = S[nb][3] = 0.f;
    if constexpr (G::MMA) {
      if (kt == 0) load_q_frags<D, G::QROW>(qf, Qs + rw * G::QROW, lane);
      qk_mma<D, G::NB, G::KROW>(S, qf, Ks, lane);
    } else {
      qk_fma<D, G::NB, G::QROW, G::KROW>(S, Qs + rw * G::QROW, Ks, lane,
                                         true);
    }

    // ---- scale, mask the edge tiles, online softmax ----
    const bool edge = k0 + BN > k_hi || k0 + BN - 1 > qpos_lo ||
                      (p.window > 0 && k0 <= qpos_hi - p.window);
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb) {
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
      pv_mma<D, G::NB, G::KROW>(O, S, Vs, lane);
    else
      pv_fma<D, G::NB, G::KROW>(O, S, Ps + warp * 16 * BN, Vs, lane, true);
    __syncthreads();  // stage (kt & 1) is refilled by tile kt + 2
  }
  if (n_kt == 0) cp_async_wait<0>();

  // ---- out = O / max(l, 1e-30) for the rows that exist ----
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(FULL_MASK, l0, o);
    l1 += __shfl_xor_sync(FULL_MASK, l1, o);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  TQ* out = static_cast<TQ*>(p.out);
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

template <typename TQ, typename TC, int D>
int launch(const PrefillParams& p, cudaStream_t stream) {
  static size_t granted = 0;
  const size_t bytes = smem_bytes<TQ, TC, D>();
  cudaError_t e = allow_smem(prefill_kernel<TQ, TC, D>, bytes, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.t * p.g + BM - 1) / BM, p.nkv);
  prefill_kernel<TQ, TC, D><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 = launched).
int pst_paged_prefill_attention(
    const void* q, const void* k_cache, const void* v_cache, void* out,
    const void* block_table, int q_dtype, int cache_dtype, int layer,
    int q_start, int t, int nq, int nkv, int64_t slots, int d, int bs,
    int num_pages, float scale, int window, void* stream) {
  if (nkv <= 0 || nq % nkv || t <= 0 || bs <= 0 || (bs & (bs - 1)))
    return (int)cudaErrorInvalidValue;
  PrefillParams p;
  p.q = q; p.k_cache = k_cache; p.v_cache = v_cache; p.out = out;
  p.block_table = static_cast<const int*>(block_table);
  p.q_start = q_start; p.layer = layer; p.t = t; p.nq = nq; p.nkv = nkv;
  p.g = nq / nkv; p.slots = slots; p.bs = bs; p.bs_shift = __builtin_ctz(bs);
  p.num_pages = num_pages;
  p.scale = scale; p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_LAUNCH(TQ, TC, D) launch<TQ, TC, D>(p, s)
  PST_DISPATCH_TYPES_D(q_dtype, cache_dtype, d, PST_LAUNCH);
#undef PST_LAUNCH
  return (int)cudaErrorInvalidValue;  // not reached
}

}  // extern "C"
