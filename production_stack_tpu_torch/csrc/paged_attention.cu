// pst_ragged_paged_attention: ragged paged GQA attention over any lane
// mix, for Hopper (sm_90a). Replaces ragged_paged_attention /
// _ragged_kernel of production_stack_tpu/ops/pallas_attention.py. (The
// decode and prefill kernels live in paged_decode.cu and paged_prefill.cu.)
//
// What it computes: a flat row space of G row blocks of tq rows. Block i
// owns the CSR segments [blk_seg[i], blk_seg[i+1]) of seg_meta, each
// [lane, row0, n_rows, qpos0]: its rows row0 <= r < row0 + n_rows (clipped
// to [0, tq)) sit at positions qpos0 + r - row0 and attend the lane's
// pages [n_start, n_used), n_used = ceil((qpos0 + n_rows) / bs) capped at
// the table width and, with a window, n_start the page of qpos0's first
// visible key (Pallas _ragged_kernel). Masks and softmax are the prefill
// tile's (paged_tile.cuh). A segment with n_rows <= 0 stores nothing;
// rows that no segment covers are left undefined.
//
// What bounds it: a decode row reads 4 * d bytes per key and kv head for
// 4 * g * d flops (bytes); a prefill chunk does far more flops per byte
// than the card's 295 (operations). The design runs both on one tile:
//
// - A segment is a contiguous chunk of one lane: its clipped rows are
//   chunk rows i * tq + lo .. i * tq + hi at q_start = qpos0 + lo - row0.
//   Each runs the prefill kernel's tensor-core tile (mma.sync in bf16,
//   f32 FMA twin otherwise, two-stage cp.async ring through the lane's
//   table) over the segment's page range, so a row whose walked keys are
//   all masked gets the plain version's uniform average.
// - Grid (SC * tiles_per_seg, nkv), tiles_per_seg = ceil(tq * g / 64):
//   one block per (segment, 64-fused-row tile, kv head). Segments that
//   share a row block (decode lanes, one row each) run in parallel; no
//   block carries anything to another, so there is no scratch and no
//   merge. Blocks leave in CSR order, the kv heads of one segment
//   together (the linear block index runs over heads fastest), so the
//   segments a caller packs first start first.
// - A block finds its row block by a binary search of blk_seg and exits
//   at once for a segment past blk_seg[G], an idle segment, or a tile
//   past the segment's fused rows.
// - A segment of at most 16 fused rows (a decode row at g <= 16) fills
//   one 16-row MMA tile: there the four warps split each key tile (16 of
//   64 keys apiece, 8 of 32 on the FMA path at head dim 256) and merge
//   at the end (paged_tile.cuh KSPLIT), so its products are not left to
//   one warp while three compute zero rows.

#include "paged_tile.cuh"

namespace {

using namespace pst;
using namespace pst::tile;

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
    ragged_tile_kernel(
    const CacheArgs p, const TQ* __restrict__ q, TQ* __restrict__ out,
    const int* __restrict__ block_tables, const int* __restrict__ blk_seg,
    const int* __restrict__ seg_meta, int n_blocks, int tq,
    int tiles_per_seg) {
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int h = lin % p.nkv;
  const int x = lin / p.nkv;
  const int s = x / tiles_per_seg, tile = x % tiles_per_seg;
  const int lane = seg_meta[4 * s + 0];
  const int row0 = seg_meta[4 * s + 1];
  const int n_rows = seg_meta[4 * s + 2];
  const int qpos0 = seg_meta[4 * s + 3];
  if (s < blk_seg[0] || s >= blk_seg[n_blocks] || n_rows <= 0) return;
  const int lo = max(row0, 0), hi = min(row0 + n_rows, tq);
  const int t = hi - lo;
  if (t <= 0 || tile * BM >= t * p.g) return;
  // the row block i with blk_seg[i] <= s < blk_seg[i + 1]
  int i = 0, i_hi = n_blocks;
  while (i_hi - i > 1) {
    const int mid = (i + i_hi) >> 1;
    if (blk_seg[mid] <= s) i = mid; else i_hi = mid;
  }
  // the segment's pages (Pallas _ragged_kernel), not the tile's
  const int n_used = min((qpos0 + n_rows + p.bs - 1) / p.bs, p.num_pages);
  int n_start = p.window > 0 ? max(qpos0 - p.window + 1, 0) / p.bs : 0;
  n_start = min(n_start, n_used);
  const int64_t row = ((int64_t)i * tq + lo) * p.nq * D;
  const int* table = block_tables + (int64_t)lane * p.num_pages;
  extern __shared__ __align__(16) unsigned char smem[];
  if (t * p.g <= 16)  // a decode row: the warps split each key tile
    attend_tile<TQ, TC, D, true>(p, q + row, out + row, table,
                                 qpos0 + lo - row0, t, 0, h, n_start,
                                 n_used, smem);
  else
    attend_tile<TQ, TC, D>(p, q + row, out + row, table, qpos0 + lo - row0,
                           t, tile, h, n_start, n_used, smem);
}

template <typename TQ, typename TC, int D>
int launch(const CacheArgs& p, const void* q, void* out,
           const int* block_tables, const int* blk_seg, const int* seg_meta,
           int n_blocks, int n_segs, int tq, cudaStream_t stream) {
  static size_t granted = 0;
  const size_t bytes = smem_bytes<TQ, TC, D>();
  cudaError_t e = allow_smem(ragged_tile_kernel<TQ, TC, D>, bytes, &granted);
  if (e != cudaSuccess) return (int)e;
  const int tiles_per_seg = (tq * p.g + BM - 1) / BM;
  const dim3 grid(n_segs * tiles_per_seg, p.nkv);
  ragged_tile_kernel<TQ, TC, D><<<grid, THREADS, bytes, stream>>>(
      p, static_cast<const TQ*>(q), static_cast<TQ*>(out), block_tables,
      blk_seg, seg_meta, n_blocks, tq, tiles_per_seg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 = launched).
int pst_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache, void* out,
    const void* block_tables, const void* blk_seg, const void* seg_meta,
    int q_dtype, int cache_dtype, int layer, int n_blocks, int n_segs,
    int tq, int nq, int nkv, int64_t slots, int d, int bs, int num_pages,
    float scale, int window, void* stream) {
  CacheArgs p;
  if (n_blocks <= 0 || n_segs <= 0 || tq <= 0 ||
      !make_cache_args(k_cache, v_cache, layer, nq, nkv, slots, bs,
                       num_pages, scale, window, &p))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_LAUNCH(TQ, TC, D)                                             \
  launch<TQ, TC, D>(p, q, out, static_cast<const int*>(block_tables),     \
                    static_cast<const int*>(blk_seg),                     \
                    static_cast<const int*>(seg_meta), n_blocks, n_segs,  \
                    tq, s)
  PST_DISPATCH_TYPES_D(q_dtype, cache_dtype, d, PST_LAUNCH);
#undef PST_LAUNCH
  return (int)cudaErrorInvalidValue;  // not reached
}

}  // extern "C"
