// pst_paged_prefill_attention: chunked-prefill paged GQA attention for one
// sequence, for Hopper (sm_90a). Replaces paged_prefill_attention /
// _prefill_kernel of production_stack_tpu/ops/pallas_attention.py.
//
// What it computes: the chunk's t query rows at positions q_start + r
// over the sequence's pages in the head-major cache (L, nkv, slots, d),
// causal, with an optional window (paged_tile.cuh states the masks and
// the softmax). q_start is read from device memory (one int32, as the
// Pallas kernel takes it by scalar prefetch), so a CUDA graph that
// captured the launch serves any chunk start its buffer is given.
//
// What bounds it: operations. A 512-row chunk at q_start 1024 does about
// 4 * 1280 * 24 * 128 flops per row, some 8 GFLOP, against some 5 MB of
// K/V bytes: far above the card's 295 flops per byte, so only the tensor
// cores come near its bound. The design:
//
// - Grid (ceil(t * g / 64), nkv): a block owns BM = 64 fused rows of one
//   kv head and runs the tensor-core tile of paged_tile.cuh (mma.sync
//   m16n8k16 in bf16, a two-stage cp.async ring of 64-key tiles assembled
//   through the block table, edge-only masks, an f32 FMA twin for any
//   other dtype pair, on 32-key tiles at head dim 256). Head dims 64, 128
//   and 256; at 256 (Gemma-7B: 16 heads) a 512-row chunk over 1024 keys
//   does some 6.4 GFLOP against 25 MB of q, out, K and V, so there the
//   two bounds meet (about 7 us each).
// - Each block walks its own page range: from the page of its earliest
//   row's first visible key (window) to the page of its last row's
//   position, so key tiles wholly above its last row are never walked.
//   The tiles with the latest rows (most keys) start first.

#include "paged_tile.cuh"

namespace {

using namespace pst;
using namespace pst::tile;

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
    prefill_kernel(
    const CacheArgs p, const TQ* __restrict__ q, TQ* __restrict__ out,
    const int* __restrict__ table, const int* __restrict__ q_start_dev,
    int t) {
  const int q_start = *q_start_dev;
  const int g = p.g;
  const int n_rows = t * g;
  const int n_tiles = (n_rows + BM - 1) / BM;
  const int tile = n_tiles - 1 - blockIdx.x;  // most keys first
  const int qpos_lo = q_start + tile * BM / g;
  const int qpos_hi = q_start + (min(tile * BM + BM, n_rows) - 1) / g;
  // pages holding positions [0, qpos_hi]; with a window, from the page of
  // the earliest row's first visible key (Pallas _prefill_kernel)
  const int n_used = min(qpos_hi / p.bs + 1, p.num_pages);
  int n_start = p.window > 0 ? max(qpos_lo - p.window + 1, 0) / p.bs : 0;
  n_start = min(n_start, n_used);
  extern __shared__ __align__(16) unsigned char smem[];
  attend_tile<TQ, TC, D>(p, q, out, table, q_start, t, tile, blockIdx.y,
                         n_start, n_used, smem);
}

template <typename TQ, typename TC, int D>
int launch(const CacheArgs& p, const void* q, void* out, const int* table,
           const int* q_start, int t, cudaStream_t stream) {
  static size_t granted = 0;
  const size_t bytes = smem_bytes<TQ, TC, D>();
  cudaError_t e = allow_smem(prefill_kernel<TQ, TC, D>, bytes, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t * p.g + BM - 1) / BM, p.nkv);
  prefill_kernel<TQ, TC, D><<<grid, THREADS, bytes, stream>>>(
      p, static_cast<const TQ*>(q), static_cast<TQ*>(out), table, q_start,
      t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 = launched).
int pst_paged_prefill_attention(
    const void* q, const void* k_cache, const void* v_cache, void* out,
    const void* block_table, const void* q_start, int q_dtype,
    int cache_dtype, int layer, int t, int nq, int nkv, int64_t slots,
    int d, int bs,
    int num_pages, float scale, int window, void* stream) {
  CacheArgs p;
  if (t <= 0 || !make_cache_args(k_cache, v_cache, layer, nq, nkv, slots,
                                 bs, num_pages, scale, window, &p))
    return (int)cudaErrorInvalidValue;
  const int* table = static_cast<const int*>(block_table);
  const int* start = static_cast<const int*>(q_start);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_LAUNCH(TQ, TC, D) \
  launch<TQ, TC, D>(p, q, out, table, start, t, s)
  PST_DISPATCH_TYPES_D(q_dtype, cache_dtype, d, PST_LAUNCH);
#undef PST_LAUNCH
  return (int)cudaErrorInvalidValue;  // not reached
}

}  // extern "C"
