// Paged GQA attention over the head-major paged KV cache, for Hopper
// (sm_90a). Three entry points, one per TPU kernel of
// production_stack_tpu/ops/pallas_attention.py:
//
//   pst_ragged_paged_attention   <- ragged_paged_attention / _ragged_kernel
//   pst_paged_prefill_attention  <- paged_prefill_attention / _prefill_kernel
//   pst_paged_decode_attention   <- paged_decode_attention / _decode_kernel
//
// Cache layout: k_cache, v_cache are (L, nkv, slots, d), row-major; the
// key of absolute position p of a sequence lives in slot
// table[p / bs] * bs + p % bs. Offsets are 64-bit: ((layer * nkv + h) *
// slots + slot) * d passes 2^31 on a large cache.
//
// Shared design (first, simple version). One thread block per (query-row
// tile or sequence, kv head). The tile's TQ query rows times the g query
// heads of that kv head form R = TQ * g fused rows (fused row f is query
// row f / g, head h * g + f % g, the Pallas packing), held in shared
// memory as f32 and pre-scaled. The block walks the lane's pages in key
// chunks of up to KC keys: it loads the chunk's K and V into shared
// memory as f32, computes the R x KC scores, updates an f32 running
// max / sum per row (online softmax, MASK_VALUE = -1e30 for masked keys,
// exactly the Pallas recurrence), and rescales an f32 accumulator of
// R x d in shared memory. Each block stores only its own rows: unlike
// the TPU grid, blocks run in parallel and carry nothing between them.
//
// What bounds it: every entry point must read the K and V bytes of the
// pages it walks from device memory (bs * d * sizeof(T) per page and
// head, twice); q and out are small beside them at decode. The kernels
// read each walked page once per (row tile, kv head), so a prefill chunk
// of t rows reads its context t / TQ times (mostly from L2). No tensor
// cores, TMA or split-K yet: those are the Hopper redesign's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float MASK_VALUE = -1e30f;
constexpr int KC = 32;        // keys per chunk (one warp in the softmax)
constexpr int THREADS = 128;  // four warps per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Smem {
  float* q;     // (R, d)
  float* acc;   // (R, d)
  float* k;     // (KC, d + 1): padded stride keeps the score loop free of
                // bank conflicts
  float* v;     // (KC, d)
  float* s;     // (R, KC)
  float* m;     // (R,)
  float* l;     // (R,)
  float* corr;  // (R,)
};

inline size_t smem_bytes(int R, int d) {
  return sizeof(float) *
         (size_t(2) * R * d + size_t(KC) * (d + 1) + size_t(KC) * d +
          size_t(R) * KC + size_t(3) * R);
}

__device__ inline Smem carve(float* base, int R, int d) {
  Smem sm;
  sm.q = base;
  sm.acc = sm.q + R * d;
  sm.k = sm.acc + R * d;
  sm.v = sm.k + KC * (d + 1);
  sm.s = sm.v + KC * d;
  sm.m = sm.s + R * KC;
  sm.l = sm.m + R;
  sm.corr = sm.l + R;
  return sm;
}

// Load the tile's q rows [row_base, row_base + tq) for kv head h into
// shared memory (f32, times scale) and reset the softmax state.
template <typename TQ>
__device__ void load_q(const TQ* __restrict__ q, int64_t row_base, int tq,
                       int nq, int d, int h, int g, float scale,
                       const Smem& sm) {
  const int R = tq * g;
  for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
    const int f = idx / d, c = idx % d;
    const int r = f / g, j = f % g;
    const int64_t off = ((row_base + r) * nq + (int64_t)h * g + j) * d + c;
    sm.q[idx] = to_f(q[off]) * scale;
    sm.acc[idx] = 0.f;
  }
  for (int f = threadIdx.x; f < R; f += blockDim.x) {
    sm.m[f] = MASK_VALUE;
    sm.l[f] = 0.f;
  }
  __syncthreads();
}

// Walk pages [n_start, n_used) of one lane's table. Fused row f sits at
// absolute query position qpos_base + f / g; key position kp is visible
// when kp <= qpos and, with a window, kp > qpos - window.
template <typename TC>
__device__ void walk_pages(const TC* __restrict__ kc,
                           const TC* __restrict__ vc, int64_t head_base,
                           const int* __restrict__ table, int n_start,
                           int n_used, int bs, int d, int R, int g,
                           int qpos_base, int window, const Smem& sm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int pg = n_start; pg < n_used; ++pg) {
    const int64_t slot0 = (int64_t)table[pg] * bs;
    for (int k0 = 0; k0 < bs; k0 += KC) {
      const int kn = min(KC, bs - k0);
      // 1. K and V chunk -> shared (f32); neighbouring threads read
      //    neighbouring elements of one slot row
      for (int idx = threadIdx.x; idx < kn * d; idx += blockDim.x) {
        const int j = idx / d, c = idx % d;
        const int64_t off = (head_base + slot0 + k0 + j) * d + c;
        sm.k[j * (d + 1) + c] = to_f(kc[off]);
        sm.v[j * d + c] = to_f(vc[off]);
      }
      __syncthreads();
      // 2. masked scores
      const int kpos0 = pg * bs + k0;
      for (int idx = threadIdx.x; idx < R * kn; idx += blockDim.x) {
        const int f = idx / kn, j = idx % kn;
        const float* qr = sm.q + f * d;
        const float* kr = sm.k + j * (d + 1);
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        const int qpos = qpos_base + f / g;
        const int kp = kpos0 + j;
        bool valid = kp <= qpos;
        if (window > 0) valid = valid && (kp > qpos - window);
        sm.s[f * KC + j] = valid ? dot : MASK_VALUE;
      }
      __syncthreads();
      // 3. online softmax, one warp per fused row
      for (int f = warp; f < R; f += n_warps) {
        const float sv = lane < kn ? sm.s[f * KC + lane] : -3.0e38f;
        float mx = sv;
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = sm.m[f];
        const float m_new = fmaxf(m_old, mx);
        const float p = lane < kn ? expf(sv - m_new) : 0.f;
        float sum = p;
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane < kn) sm.s[f * KC + lane] = p;
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          sm.corr[f] = corr;
          sm.l[f] = sm.l[f] * corr + sum;
          sm.m[f] = m_new;
        }
      }
      __syncthreads();
      // 4. acc = acc * corr + p @ v
      for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
        const int f = idx / d, c = idx % d;
        const float* pr = sm.s + f * KC;
        float a = sm.acc[idx] * sm.corr[f];
        for (int j = 0; j < kn; ++j) a = fmaf(pr[j], sm.v[j * d + c], a);
        sm.acc[idx] = a;
      }
      __syncthreads();
    }
  }
}

// Store tile rows [r_lo, r_hi) as acc / max(l, 1e-30): a row that walked
// no page stores 0, as the Pallas kernels do.
template <typename TQ>
__device__ void store_rows(TQ* __restrict__ out, int64_t row_base, int r_lo,
                           int r_hi, int nq, int d, int h, int g,
                           const Smem& sm) {
  const int n = (r_hi - r_lo) * g;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int f = r_lo * g + idx / d, c = idx % d;
    const int r = f / g, j = f % g;
    const int64_t off = ((row_base + r) * nq + (int64_t)h * g + j) * d + c;
    out[off] = from_f<TQ>(sm.acc[f * d + c] / fmaxf(sm.l[f], 1e-30f));
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// ragged_paged_attention (pallas_attention.py:_ragged_kernel). Grid:
// (G row blocks of tq rows, nkv). Block i walks its CSR segments
// [blk_seg[i], blk_seg[i+1]); segment [lane, row0, n_rows, qpos0] owns
// tile rows [row0, row0 + n_rows) at positions qpos0.. and walks the
// lane's pages [n_start, n_used). Bound: KV bytes of the walked pages.
template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS) ragged_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, TQ* __restrict__ out,
    const int* __restrict__ block_tables, const int* __restrict__ blk_seg,
    const int* __restrict__ seg_meta, int layer, int nq, int nkv,
    int64_t slots, int d, int bs, int num_pages, int tq, float scale,
    int window) {
  extern __shared__ float smem_raw[];
  const int i = blockIdx.x, h = blockIdx.y;
  const int g = nq / nkv, R = tq * g;
  const Smem sm = carve(smem_raw, R, d);
  const int64_t row_base = (int64_t)i * tq;
  const int64_t head_base = ((int64_t)layer * nkv + h) * slots;
  const int s_lo = blk_seg[i], s_hi = blk_seg[i + 1];
  for (int s = s_lo; s < s_hi; ++s) {
    const int lane = seg_meta[4 * s + 0];
    const int row0 = seg_meta[4 * s + 1];
    const int n_rows = seg_meta[4 * s + 2];
    const int qpos0 = seg_meta[4 * s + 3];
    if (n_rows <= 0) continue;  // idle segment: stores nothing
    const int n_used = min((qpos0 + n_rows + bs - 1) / bs, num_pages);
    int n_start = window > 0 ? max(qpos0 - window + 1, 0) / bs : 0;
    n_start = min(n_start, n_used);
    load_q(q, row_base, tq, nq, d, h, g, scale, sm);
    walk_pages(kc, vc, head_base, block_tables + (int64_t)lane * num_pages,
               n_start, n_used, bs, d, R, g, qpos0 - row0, window, sm);
    store_rows(out, row_base, max(row0, 0), min(row0 + n_rows, tq), nq, d,
               h, g, sm);
  }
}

// paged_prefill_attention (pallas_attention.py:_prefill_kernel). Grid:
// (t / tq q-tiles, nkv). Tile i holds rows at positions tile_base + r,
// tile_base = q_start + i * tq, and walks pages up to tile_base + tq;
// with a window, from the page of the tile's earliest visible key.
// Bound: KV bytes of the context pages, once per tile.
template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS) prefill_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, TQ* __restrict__ out,
    const int* __restrict__ block_table, int q_start, int layer, int nq,
    int nkv, int64_t slots, int d, int bs, int num_pages, int tq,
    float scale, int window) {
  extern __shared__ float smem_raw[];
  const int i = blockIdx.x, h = blockIdx.y;
  const int g = nq / nkv, R = tq * g;
  const Smem sm = carve(smem_raw, R, d);
  const int64_t row_base = (int64_t)i * tq;
  const int tile_base = q_start + i * tq;
  const int n_used = min((tile_base + tq + bs - 1) / bs, num_pages);
  const int n_start = window > 0 ? max(tile_base - window + 1, 0) / bs : 0;
  load_q(q, row_base, tq, nq, d, h, g, scale, sm);
  walk_pages(kc, vc, ((int64_t)layer * nkv + h) * slots, block_table,
             n_start, n_used, bs, d, R, g, tile_base, window, sm);
  store_rows(out, row_base, 0, tq, nq, d, h, g, sm);
}

// paged_decode_attention (pallas_attention.py:_decode_kernel). Grid:
// (b, nkv). Sequence i's one query row sits at position ctx - 1 and walks
// pages [n_start, ceil(ctx / bs)). Bound: KV bytes of its context.
template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, TQ* __restrict__ out,
    const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, int layer, int nq, int nkv,
    int64_t slots, int d, int bs, int num_pages, float scale, int window) {
  extern __shared__ float smem_raw[];
  const int i = blockIdx.x, h = blockIdx.y;
  const int g = nq / nkv;
  const Smem sm = carve(smem_raw, g, d);
  const int ctx = context_lens[i];
  const int n_used = min((ctx + bs - 1) / bs, num_pages);
  const int n_start = window > 0 ? max(ctx - window, 0) / bs : 0;
  load_q(q, (int64_t)i, 1, nq, d, h, g, scale, sm);
  walk_pages(kc, vc, ((int64_t)layer * nkv + h) * slots,
             block_tables + (int64_t)i * num_pages, n_start, n_used, bs, d,
             g, g, ctx - 1, window, sm);
  store_rows(out, (int64_t)i, 0, 1, nq, d, h, g, sm);
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// dtype codes: 0 = float32, 1 = bfloat16
#define PST_DISPATCH(qdt, cdt, ...)                                \
  if ((qdt) == 0 && (cdt) == 0) {                                  \
    using TQ = float; using TC = float; __VA_ARGS__                \
  } else if ((qdt) == 1 && (cdt) == 1) {                           \
    using TQ = __nv_bfloat16; using TC = __nv_bfloat16;            \
    __VA_ARGS__                                                    \
  } else if ((qdt) == 1 && (cdt) == 0) {                           \
    using TQ = __nv_bfloat16; using TC = float; __VA_ARGS__        \
  } else if ((qdt) == 0 && (cdt) == 1) {                           \
    using TQ = float; using TC = __nv_bfloat16; __VA_ARGS__        \
  } else {                                                         \
    return (int)cudaErrorInvalidValue;                             \
  }

}  // namespace

extern "C" {

int pst_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache, void* out,
    const void* block_tables, const void* blk_seg, const void* seg_meta,
    int q_dtype, int cache_dtype, int layer, int n_blocks, int tq, int nq,
    int nkv, int64_t slots, int d, int bs, int num_pages, float scale,
    int window, void* stream) {
  const size_t bytes = smem_bytes(tq * (nq / nkv), d);
  const dim3 grid(n_blocks, nkv);
  PST_DISPATCH(q_dtype, cache_dtype,
    cudaError_t e = prepare(ragged_kernel<TQ, TC>, bytes);
    if (e != cudaSuccess) return (int)e;
    ragged_kernel<TQ, TC><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
        (const TQ*)q, (const TC*)k_cache, (const TC*)v_cache, (TQ*)out,
        (const int*)block_tables, (const int*)blk_seg,
        (const int*)seg_meta, layer, nq, nkv, slots, d, bs, num_pages, tq,
        scale, window);
  )
  return (int)cudaGetLastError();
}

int pst_paged_prefill_attention(
    const void* q, const void* k_cache, const void* v_cache, void* out,
    const void* block_table, int q_dtype, int cache_dtype, int layer,
    int q_start, int t, int tq, int nq, int nkv, int64_t slots, int d,
    int bs, int num_pages, float scale, int window, void* stream) {
  const size_t bytes = smem_bytes(tq * (nq / nkv), d);
  const dim3 grid(t / tq, nkv);
  PST_DISPATCH(q_dtype, cache_dtype,
    cudaError_t e = prepare(prefill_kernel<TQ, TC>, bytes);
    if (e != cudaSuccess) return (int)e;
    prefill_kernel<TQ, TC><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
        (const TQ*)q, (const TC*)k_cache, (const TC*)v_cache, (TQ*)out,
        (const int*)block_table, q_start, layer, nq, nkv, slots, d, bs,
        num_pages, tq, scale, window);
  )
  return (int)cudaGetLastError();
}

int pst_paged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, void* out,
    const void* block_tables, const void* context_lens, int q_dtype,
    int cache_dtype, int layer, int b, int nq, int nkv, int64_t slots,
    int d, int bs, int num_pages, float scale, int window, void* stream) {
  const size_t bytes = smem_bytes(nq / nkv, d);
  const dim3 grid(b, nkv);
  PST_DISPATCH(q_dtype, cache_dtype,
    cudaError_t e = prepare(decode_kernel<TQ, TC>, bytes);
    if (e != cudaSuccess) return (int)e;
    decode_kernel<TQ, TC><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
        (const TQ*)q, (const TC*)k_cache, (const TC*)v_cache, (TQ*)out,
        (const int*)block_tables, (const int*)context_lens, layer, nq, nkv,
        slots, d, bs, num_pages, scale, window);
  )
  return (int)cudaGetLastError();
}

}  // extern "C"
