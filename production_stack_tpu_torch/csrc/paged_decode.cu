// pst_paged_decode_attention: one decode step of paged GQA attention for
// Hopper (sm_90a). Replaces paged_decode_attention / _decode_kernel of
// production_stack_tpu/ops/pallas_attention.py.
//
// What it computes: sequence i's one query row, at position ctx_i - 1,
// over the keys of its pages [n_start, n_used) in the head-major cache
// (L, nkv, slots, d) (key p of a sequence lives in slot
// table[p / bs] * bs + p % bs; offsets are 64-bit). A walked key is
// visible when p <= ctx - 1 and, with a window, p > ctx - 1 - window;
// an invisible walked key scores MASK_VALUE; f32 online softmax; the
// output is acc / max(l, 1e-30), 0 for a sequence that walks no page.
//
// What bounds it: the bytes of the K and V pages it walks (a decode row
// does 4 * d flops per key and head and reads 4 * d bytes per key and kv
// head in bf16, far below the card's 295 flops per byte). At serving
// batch sizes a block's time is latency, not bandwidth: the design fills
// the card with blocks and keeps each block's dependent steps few:
//
// - Split-K (flash-decoding). Grid (b, nkv, n_splits): split s walks
//   table pages [s * pps, (s + 1) * pps) intersected with the sequence's
//   [n_start, n_used). The host sizes n_splits from the table width
//   (ops/paged_attention._decode_split_plan), never from the device's
//   context lengths; a split that holds no page of the sequence returns
//   at once and the merge skips it. The split's table slice and q are
//   fetched before the context length is known.
// - One block holds all g query heads of its kv head (padded to the 16
//   rows of one MMA tile), so each K/V byte is read from device memory
//   once.
// - Chunks of KT = 64 keys are copied into a shared-memory ring of NSTAGE
//   stages (3 in bf16, 2 in f32) with 16-byte cp.async (neighbouring
//   threads on neighbouring addresses; rows past the walk are
//   zero-filled): chunks c + 1 .. c + NSTAGE - 1 are in flight while
//   chunk c is computed, and one __syncthreads per chunk frees a stage.
//   Block sizes are powers of two (shift and mask).
// - Warp w takes keys [16 w, 16 w + 16) of every chunk with its own online
//   softmax: in bf16, S = Q K^T and O += P V are two and sixteen
//   mma.sync m16n8k16 per k-step (the prefill kernel's fragment code,
//   attention_common.cuh), P rounded to bf16; in f32 the same fragments
//   by CUDA-core FMAs. The four warps' (m, l, acc) merge in shared memory
//   (over the ring) at the end of the split.
//   In bf16 the output stays within 2^-6 * max|ref| per (row, head) of
//   the plain version (one output rounding plus the rounding of P).
// - With n_splits == 1 the block writes the output; otherwise it writes
//   its split's (m, l, acc) to f32 scratch (allocated by the wrapper)
//   and decode_merge_kernel combines the splits per (sequence, kv head).

#include "attention_common.cuh"

namespace {

using namespace pst;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KT = 64;               // keys per chunk, 16 per warp
constexpr int QROWS = 16;            // g query heads padded to an MMA tile
constexpr int MAX_SPLIT_PAGES = 32;  // 256 keys at block size 8
constexpr int ROW_PAD_BYTES = 16;    // ldmatrix rows free of bank conflicts

struct DecodeParams {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  void* out;
  float* part_acc;  // (b, nkv, n_splits, g, d)
  float* part_ml;   // (b, nkv, n_splits, g, 2)
  const int* block_tables;
  const int* context_lens;
  int layer, b, nq, nkv, g;
  int64_t slots;
  int bs, bs_shift, num_pages, pages_per_split, n_splits;
  float scale;
  int window;
};

template <typename TQ, typename TC, int D>
struct Geo {
  static constexpr bool MMA = sizeof(TQ) == 2 && sizeof(TC) == 2;
  static constexpr int QROW = D + ROW_PAD_BYTES / sizeof(TQ);
  static constexpr int KROW = D + ROW_PAD_BYTES / sizeof(TC);
  static constexpr int STAGE = 2 * KT * KROW;  // K rows then V rows
  static constexpr int NSTAGE = sizeof(TC) == 2 ? 3 : 2;
  static constexpr int ND = D / 8;
};

// Dynamic shared memory: the q tile (16 rows), the split's table slice,
// the K/V ring (whose space the warps' (m, l, acc) reuse for the
// end-of-split merge) and, on the FMA path, each warp's 16 x 16 block of
// P. Mirrored by ops/paged_attention._decode_smem.
template <typename TQ, typename TC, int D>
size_t smem_bytes(int g) {
  using G = Geo<TQ, TC, D>;
  const size_t ring = sizeof(TC) * size_t(G::NSTAGE) * G::STAGE;
  const size_t red = sizeof(float) * size_t(WARPS) * g * (D + 2);
  return sizeof(TQ) * size_t(QROWS) * G::QROW +
         sizeof(int) * MAX_SPLIT_PAGES + (ring > red ? ring : red) +
         (G::MMA ? 0 : sizeof(float) * size_t(WARPS) * 16 * 16);
}

// The pages [lo, hi) that sequence i walks (Pallas _decode_kernel).
__device__ __forceinline__ void page_range(const DecodeParams& p, int ctx,
                                           int* lo, int* hi) {
  const int n_used = min((ctx + p.bs - 1) / p.bs, p.num_pages);
  const int n_start = p.window > 0 ? max(ctx - p.window, 0) / p.bs : 0;
  *lo = min(n_start, n_used);
  *hi = n_used;
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const DecodeParams p) {
  using G = Geo<TQ, TC, D>;
  const int i = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int g = p.g;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  int* tbl = reinterpret_cast<int*>(Qs + QROWS * G::QROW);
  TC* ring = reinterpret_cast<TC*>(tbl + MAX_SPLIT_PAGES);
  float* Ps = reinterpret_cast<float*>(ring + G::NSTAGE * G::STAGE);

  // the split's table slice and the q rows, fetched before the context
  // length is known (rows g..15 of the q tile are zero)
  const int pg0 = sp * p.pages_per_split;
  for (int j = threadIdx.x; j < p.pages_per_split; j += THREADS)
    if (pg0 + j < p.num_pages)
      tbl[j] = p.block_tables[(int64_t)i * p.num_pages + pg0 + j];
  {
    constexpr int V = 16 / sizeof(TQ), CH = D / V;
    const TQ* qi =
        static_cast<const TQ*>(p.q) + ((int64_t)i * p.nq + h * g) * D;
    for (int idx = threadIdx.x; idx < QROWS * CH; idx += THREADS) {
      const int r = idx / CH, ch = idx % CH;
      cp_async16(Qs + r * G::QROW + ch * V, qi + (r < g ? r * D + ch * V : 0),
                 r < g);
    }
  }
  const int ctx = p.context_lens[i];
  int n_start, n_used;
  page_range(p, ctx, &n_start, &n_used);
  const int p_lo = max(pg0, n_start);
  const int p_hi = min(pg0 + p.pages_per_split, n_used);
  TQ* out = static_cast<TQ*>(p.out) + ((int64_t)i * p.nq + h * g) * D;
  if (p_lo >= p_hi) {
    // no page of this sequence in the split: the merge skips it; a
    // sequence that walks no page at all gives 0
    cp_async_commit();
    cp_async_wait<0>();
    if (p.n_splits == 1)
      for (int idx = threadIdx.x; idx < g * D; idx += THREADS)
        out[idx] = from_f<TQ>(0.f);
    return;
  }
  const int k_lo = p_lo * p.bs, k_hi = p_hi * p.bs;
  const int t0 = p_lo - pg0;  // tbl index of page p_lo
  const int qpos = ctx - 1;
  __syncthreads();  // tbl visible

  const int64_t head = ((int64_t)p.layer * p.nkv + h) * p.slots;
  const TC* kbase = static_cast<const TC*>(p.k_cache) + head * D;
  const TC* vbase = static_cast<const TC*>(p.v_cache) + head * D;
  const int bmask = p.bs - 1;
  auto load_chunk = [&](int c) {
    constexpr int V = 16 / sizeof(TC), CH = D / V;
    TC* ks = ring + (c % G::NSTAGE) * G::STAGE;
    TC* vs = ks + KT * G::KROW;
#pragma unroll
    for (int it = 0; it < KT * CH / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / CH, ch = idx % CH;
      const int kk = c * KT + r;  // key k_lo + kk
      const bool ok = kk < k_hi - k_lo;
      int64_t off = 0;
      if (ok)
        off = ((int64_t)tbl[t0 + (kk >> p.bs_shift)] * p.bs + (kk & bmask)) *
                  D +
              ch * V;
      cp_async16(ks + r * G::KROW + ch * V, kbase + off, ok);
      cp_async16(vs + r * G::KROW + ch * V, vbase + off, ok);
    }
  };

  const int n_chunks = (k_hi - k_lo + KT - 1) / KT;
#pragma unroll
  for (int c = 0; c < G::NSTAGE - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    cp_async_commit();  // one group per chunk (the first with q), empty
                        // past the end
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool row1 = gid + 8 < g;  // rows gid + 8 hold a query head
  float O[G::ND][4];
#pragma unroll
  for (int nd = 0; nd < G::ND; ++nd)
    O[nd][0] = O[nd][1] = O[nd][2] = O[nd][3] = 0.f;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  uint32_t qf[D / 16][4];  // bf16 path: q fragments, loaded once

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<G::NSTAGE - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    if (c + G::NSTAGE - 1 < n_chunks) load_chunk(c + G::NSTAGE - 1);
    cp_async_commit();
    const TC* Kw = ring + (c % G::NSTAGE) * G::STAGE + warp * 16 * G::KROW;
    const TC* Vw = Kw + KT * G::KROW;
    const int k0 = k_lo + c * KT + warp * 16;

    float S[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (G::MMA) {
      if (c == 0) load_q_frags<D, G::QROW>(qf, Qs, lane);
      qk_mma<D, 2, G::KROW>(S, qf, Kw, lane);
    } else {
      qk_fma<D, 2, G::QROW, G::KROW>(S, Qs, Kw, lane, row1);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nb * 8 + tig * 2 + (e & 1);
        const float s = S[nb][e] * p.scale;
        S[nb][e] = kp >= k_hi ? NEG_INF
                   : (kp > qpos || (p.window > 0 && kp <= qpos - p.window))
                       ? MASK_VALUE
                       : s;
      }
    }
    online_softmax(S, O, m0, m1, l0, l1);
    if constexpr (G::MMA)
      pv_mma<D, 2, G::KROW>(O, S, Vw, lane);
    else
      pv_fma<D, 2, G::KROW>(O, S, Ps + warp * 16 * 16, Vw, lane, row1);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // merge the four warps over the ring: m (WARPS x g), l (WARPS x g), acc
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(FULL_MASK, l0, o);
    l1 += __shfl_xor_sync(FULL_MASK, l1, o);
  }
  float* rm = reinterpret_cast<float*>(ring);
  float* rl = rm + WARPS * g;
  float* ra = rl + WARPS * g;
  if (gid < g) {
    if (tig == 0) {
      rm[warp * g + gid] = m0;
      rl[warp * g + gid] = l0;
    }
    float* a = ra + (warp * g + gid) * D + tig * 2;
#pragma unroll
    for (int nd = 0; nd < G::ND; ++nd) {
      a[nd * 8] = O[nd][0];
      a[nd * 8 + 1] = O[nd][1];
    }
  }
  if (row1) {
    if (tig == 0) {
      rm[warp * g + gid + 8] = m1;
      rl[warp * g + gid + 8] = l1;
    }
    float* a = ra + (warp * g + gid + 8) * D + tig * 2;
#pragma unroll
    for (int nd = 0; nd < G::ND; ++nd) {
      a[nd * 8] = O[nd][2];
      a[nd * 8 + 1] = O[nd][3];
    }
  }
  __syncthreads();
  const int64_t part = ((int64_t)i * p.nkv + h) * p.n_splits + sp;
  for (int idx = threadIdx.x; idx < g * D; idx += THREADS) {
    const int j = idx / D;
    float mm = MASK_VALUE;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, rm[w * g + j]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = __expf(rm[w * g + j] - mm);
      ll += rl[w * g + j] * e;
      aa += ra[w * g * D + idx] * e;
    }
    if (p.n_splits == 1) {
      out[idx] = from_f<TQ>(aa / fmaxf(ll, 1e-30f));
    } else {
      p.part_acc[part * g * D + idx] = aa;
      if (idx % D == 0) {
        p.part_ml[(part * g + j) * 2 + 0] = mm;
        p.part_ml[(part * g + j) * 2 + 1] = ll;
      }
    }
  }
}

// Combine the splits of (sequence i, kv head h): the splits holding
// pages of [n_start, n_used) are s in [n_start / pps, ceil(n_used / pps)).
// Splits are read in groups of MERGE_GROUP, all loads of a group issued
// together, under a running maximum.
constexpr int MERGE_GROUP = 8;

template <typename TQ>
__global__ void __launch_bounds__(THREADS) decode_merge_kernel(
    const DecodeParams p, int d) {
  const int i = blockIdx.x, h = blockIdx.y, g = p.g;
  int n_start, n_used;
  page_range(p, p.context_lens[i], &n_start, &n_used);
  const int pps = p.pages_per_split;
  const int s_lo = n_start < n_used ? n_start / pps : 0;
  const int s_hi = n_start < n_used ? (n_used + pps - 1) / pps : 0;
  const int64_t base = ((int64_t)i * p.nkv + h) * p.n_splits;
  TQ* out = static_cast<TQ*>(p.out) + ((int64_t)i * p.nq + h * g) * d;
  for (int idx = threadIdx.x; idx < g * d; idx += THREADS) {
    const int j = idx / d;
    const float* ml = p.part_ml + (base * g + j) * 2;
    const float* acc = p.part_acc + base * g * d + idx;
    float mm = MASK_VALUE, ll = 0.f, aa = 0.f;
    for (int s0 = s_lo; s0 < s_hi; s0 += MERGE_GROUP) {
      float mv[MERGE_GROUP], lv[MERGE_GROUP], av[MERGE_GROUP];
#pragma unroll
      for (int k = 0; k < MERGE_GROUP; ++k) {
        const int s = s0 + k;
        const bool ok = s < s_hi;
        mv[k] = ok ? ml[(int64_t)s * g * 2] : NEG_INF;
        lv[k] = ok ? ml[(int64_t)s * g * 2 + 1] : 0.f;
        av[k] = ok ? acc[(int64_t)s * g * d] : 0.f;
      }
      float gm = mm;
#pragma unroll
      for (int k = 0; k < MERGE_GROUP; ++k) gm = fmaxf(gm, mv[k]);
      const float corr = __expf(mm - gm);
      ll *= corr;
      aa *= corr;
#pragma unroll
      for (int k = 0; k < MERGE_GROUP; ++k) {
        const float e = __expf(mv[k] - gm);
        ll += lv[k] * e;
        aa += av[k] * e;
      }
      mm = gm;
    }
    out[idx] = from_f<TQ>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename TQ, typename TC, int D>
int launch(const DecodeParams& p, cudaStream_t stream) {
  static size_t granted = 0;
  const size_t bytes = smem_bytes<TQ, TC, D>(p.g);
  cudaError_t e =
      allow_smem(decode_split_kernel<TQ, TC, D>, bytes, &granted);
  if (e != cudaSuccess) return (int)e;
  decode_split_kernel<TQ, TC, D>
      <<<dim3(p.b, p.nkv, p.n_splits), THREADS, bytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_splits == 1) return (int)e;
  decode_merge_kernel<TQ><<<dim3(p.b, p.nkv), THREADS, 0, stream>>>(p, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part_acc / part_ml: f32 scratch of (b, nkv, n_splits, g, d) and
// (b, nkv, n_splits, g, 2) elements, unused (may be null) when
// n_splits == 1. Returns a CUDA error code (0 = launched).
int pst_paged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, void* out,
    void* part_acc, void* part_ml, const void* block_tables,
    const void* context_lens, int q_dtype, int cache_dtype, int layer, int b,
    int nq, int nkv, int64_t slots, int d, int bs, int num_pages,
    int pages_per_split, int n_splits, float scale, int window,
    void* stream) {
  if (nkv <= 0 || nq % nkv || nq / nkv > QROWS || pages_per_split <= 0 ||
      pages_per_split > MAX_SPLIT_PAGES || n_splits <= 0 || bs <= 0 ||
      (bs & (bs - 1)))
    return (int)cudaErrorInvalidValue;
  DecodeParams p;
  p.q = q; p.k_cache = k_cache; p.v_cache = v_cache; p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.block_tables = static_cast<const int*>(block_tables);
  p.context_lens = static_cast<const int*>(context_lens);
  p.layer = layer; p.b = b; p.nq = nq; p.nkv = nkv; p.g = nq / nkv;
  p.slots = slots; p.bs = bs; p.bs_shift = __builtin_ctz(bs);
  p.num_pages = num_pages;
  p.pages_per_split = pages_per_split; p.n_splits = n_splits;
  p.scale = scale; p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_LAUNCH(TQ, TC, D) launch<TQ, TC, D>(p, s)
  PST_DISPATCH_TYPES_D(q_dtype, cache_dtype, d, PST_LAUNCH);
#undef PST_LAUNCH
  return (int)cudaErrorInvalidValue;  // not reached
}

}  // extern "C"
