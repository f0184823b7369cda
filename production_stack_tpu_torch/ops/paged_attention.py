"""Paged GQA attention over the head-major paged KV cache: the three
hand-written CUDA kernels (csrc/paged_attention.cu for ragged,
csrc/paged_decode.cu, csrc/paged_prefill.cu, the first and last sharing
csrc/paged_tile.cuh; built into one library by ops/cuda_build.py), their
wrappers, their plain PyTorch versions and a launch counter.

Counterpart of ``production_stack_tpu/ops/pallas_attention.py``; the
functions keep its names, signatures and layouts:

- the KV cache is HEAD-MAJOR ``(L, nkv, slots, d)``; ``layer`` indexes
  the full cache, so no per-layer copy is ever made;
- ``ragged_paged_attention`` runs a flattened row space of any lane mix
  described by CSR segment metadata (``blk_seg``, ``seg_meta``); on the
  card each segment is a contiguous chunk run on the prefill kernel's
  tile, one block per (segment, tile, kv head);
- ``paged_prefill_attention`` runs one sequence's contiguous chunk
  (tensor-core tiles of 64 fused rows x 64 keys on the card, shared
  with the ragged kernel in csrc/paged_tile.cuh);
- ``paged_decode_attention`` runs one query row per sequence, its
  context split across blocks (split-K) and the splits merged.

A wrapper checks its inputs the same way for both devices, then, handed
CUDA tensors, checks the shapes its kernel takes (head dims, block
sizes, shared memory) and launches the kernel (or raises); handed CPU
tensors, it computes the plain version. There is no fallback from one
to the other. The plain versions walk the same page ranges with the same
masking (MASK_VALUE = -1e30, f32 softmax), and the decode one the same
splits, so a row's result does not depend on which of the two computed
it beyond summation order (and, in bf16, the rounding of P before the
card kernels' tensor-core PV product).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MASK_VALUE = -1e30

# Query-tile rows of the ragged kernel's row blocks (the Pallas
# RAGGED_TQ): prefill chunks pack RAGGED_TQ-aligned, decode lanes share
# blocks one row each.
RAGGED_TQ = 8
# Row granularity of a prefill chunk: the runner pads chunks to a
# multiple of PREFILL_TQ rows (the kernel itself tiles 64 fused rows and
# masks a partly filled last tile). The plain version walks PREFILL_TQ-row
# tiles, each over its own page range.
PREFILL_TQ = 8
# Fused query rows x keys of one prefill (and ragged) kernel tile
# (csrc/paged_tile.cuh BM, BN).
PREFILL_BM = PREFILL_BN = 64
# Keys one decode split walks: split s holds table pages
# [s * pps, (s + 1) * pps), pps = DECODE_SPLIT_KEYS // block_size.
DECODE_SPLIT_KEYS = 256
# Keys of one decode chunk in the kernel's shared-memory ring (KT), and
# the ring's stages (NSTAGE) by cache element size.
DECODE_KT = 64
DECODE_STAGES = {2: 3, 4: 2}
# Query heads per kv head the decode kernel takes: one 16-row MMA tile.
DECODE_MAX_G = 16
# Shapes the card kernels are built for.
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_BLOCK_SIZES = (8, 16, 32, 64, 128)
# Shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448

# Launch accounting: each wrapper adds one where it launches its kernel
# and nowhere else (the plain versions never count).
_LAUNCHES = {"decode": 0, "prefill": 0, "ragged": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# -- plain versions ----------------------------------------------------------
def _attend(q_rows, k_cache, v_cache, layer, pages, q_pos, kpos0,
            block_size, scale, window):
    """Rows at absolute positions `q_pos` over the keys of `pages` (page j
    holds positions kpos0 + j*bs ..). A row that walks no page gives 0,
    a row whose walked keys are all masked gives their uniform average —
    both what the online-softmax kernels give. It is the merge of one
    split, so a decode row whose pages fit one split is bit-identical
    whichever plain version computed it."""
    if pages.numel() == 0:
        return torch.zeros_like(q_rows)
    return _merge_splits([_attend_stats(q_rows, k_cache, v_cache, layer,
                                        pages, q_pos, kpos0, block_size,
                                        scale, window)], q_rows)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ragged_paged_attention_plain(q, k_cache, v_cache, layer, block_tables,
                                 blk_seg, seg_meta, *, block_size, scale,
                                 window=None):
    """Plain PyTorch version of the ragged kernel. Rows that no segment
    covers are 0 here (the kernel leaves them undefined)."""
    r = q.shape[0]
    num_pages = block_tables.shape[1]
    n_blocks = blk_seg.shape[0] - 1
    tq = r // n_blocks
    bs = block_size
    out = torch.zeros_like(q)
    csr = blk_seg.tolist()
    meta = seg_meta.tolist()
    for i in range(n_blocks):
        for s in range(csr[i], csr[i + 1]):
            lane, row0, n_rows, qpos0 = meta[s]
            if n_rows <= 0:
                continue
            n_used = min(_cdiv(qpos0 + n_rows, bs), num_pages)
            n_start = 0 if window is None else max(qpos0 - window + 1, 0) // bs
            n_start = min(n_start, n_used)
            lo, hi = max(row0, 0), min(row0 + n_rows, tq)
            rows = torch.arange(lo, hi, device=q.device)
            out[i * tq + lo:i * tq + hi] = _attend(
                q[i * tq + lo:i * tq + hi], k_cache, v_cache, int(layer),
                block_tables[lane, n_start:n_used], qpos0 + rows - row0,
                n_start * bs, bs, scale, window,
            )
    return out


def paged_prefill_attention_plain(q, k_cache, v_cache, layer, block_table,
                                  q_start, *, block_size, scale,
                                  window=None):
    """Plain PyTorch version of the prefill kernel (same PREFILL_TQ tiles
    and per-tile page ranges)."""
    t = q.shape[0]
    num_pages = block_table.shape[0]
    bs = block_size
    q_start = int(q_start)
    out = torch.empty_like(q)
    for t0 in range(0, t, PREFILL_TQ):
        tq = min(PREFILL_TQ, t - t0)
        base = q_start + t0
        n_used = min(_cdiv(base + tq, bs), num_pages)
        n_start = 0 if window is None else max(base - window + 1, 0) // bs
        n_start = min(n_start, n_used)
        out[t0:t0 + tq] = _attend(
            q[t0:t0 + tq], k_cache, v_cache, int(layer),
            block_table[n_start:n_used],
            base + torch.arange(tq, device=q.device), n_start * bs, bs,
            scale, window,
        )
    return out


def _decode_split_plan(num_pages: int, block_size: int,
                       pages_per_split: int | None = None):
    """(pages_per_split, n_splits) of the decode kernel's grid: split s
    walks table pages [s * pps, (s + 1) * pps) intersected with the
    sequence's [n_start, n_used). Sized from the table's width, which the
    host knows, never from context lengths on the device."""
    pps = pages_per_split or max(1, DECODE_SPLIT_KEYS // block_size)
    return pps, max(1, _cdiv(num_pages, pps))


def _decode_pages(ctx: int, block_size: int, num_pages: int, window):
    """The pages [n_start, n_used) a decode row at position ctx - 1
    walks (Pallas _decode_kernel)."""
    n_used = min(_cdiv(ctx, block_size), num_pages)
    n_start = 0 if window is None else max(ctx - window, 0) // block_size
    return min(n_start, n_used), n_used


def _attend_stats(q_rows, k_cache, v_cache, layer, pages, q_pos, kpos0,
                  block_size, scale, window):
    """f32 softmax statistics of rows at positions `q_pos` over the keys
    of `pages` (page j holds positions kpos0 + j*bs ..): m (n, nq) the
    max masked score, l (n, nq) the sum of exp(s - m), acc (n, nq, d) the
    exp(s - m)-weighted sum of v. The scale applies to the f32 scores."""
    n, nq, d = q_rows.shape
    nkv = k_cache.shape[1]
    g = nq // nkv
    offs = torch.arange(block_size, device=pages.device)
    slots = (pages.long()[:, None] * block_size + offs).reshape(-1)
    k = k_cache[layer][:, slots].float()  # (nkv, K, d)
    v = v_cache[layer][:, slots].float()
    qf = q_rows.float().reshape(n, nkv, g, d)
    s = torch.einsum("nhgd,hkd->nhgk", qf, k) * scale
    kpos = kpos0 + torch.arange(slots.numel(), device=q_rows.device)
    qp = q_pos.to(q_rows.device).long()[:, None]
    valid = kpos[None, :] <= qp
    if window is not None:
        valid = valid & (kpos[None, :] > qp - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("nhgk,hkd->nhgd", p, v)
    return (m.reshape(n, nq), p.sum(dim=-1).reshape(n, nq),
            acc.reshape(n, nq, d))


def _merge_splits(parts, like):
    """Combine per-split (m, l, acc) as the decode kernel's merge does:
    out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30),
    M = max_s m_s; no split at all gives 0."""
    if not parts:
        return torch.zeros_like(like)
    m = torch.stack([pt[0] for pt in parts])  # (S, n, nq)
    w = torch.exp(m - m.amax(dim=0))
    l = (torch.stack([pt[1] for pt in parts]) * w).sum(dim=0)
    acc = (torch.stack([pt[2] for pt in parts]) * w[..., None]).sum(dim=0)
    return (acc / l.clamp_min(1e-30)[..., None]).to(like.dtype)


def paged_decode_attention_plain(q, k_cache, v_cache, layer, block_tables,
                                 context_lens, *, block_size, scale,
                                 window=None, pages_per_split=None):
    """Plain PyTorch version of the decode kernel: the same split plan
    (`_decode_split_plan`; `pages_per_split` overrides the kernel's) and
    the same merge of per-split (m, l, acc)."""
    num_pages = block_tables.shape[1]
    bs = block_size
    pps, n_splits = _decode_split_plan(num_pages, bs, pages_per_split)
    out = torch.empty_like(q)
    for i, ctx in enumerate(context_lens.tolist()):
        n_start, n_used = _decode_pages(ctx, bs, num_pages, window)
        parts = []
        for sp in range(n_splits):
            lo, hi = max(sp * pps, n_start), min((sp + 1) * pps, n_used)
            if lo < hi:
                parts.append(_attend_stats(
                    q[i:i + 1], k_cache, v_cache, int(layer),
                    block_tables[i, lo:hi],
                    torch.tensor([ctx - 1], device=q.device), lo * bs, bs,
                    scale, window,
                ))
        out[i:i + 1] = _merge_splits(parts, q[i:i + 1])
    return out


# -- wrappers ----------------------------------------------------------------
def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on one CUDA device; anything else is an error."""
    if all(t.is_cuda for t in tensors):
        if len({t.get_device() for t in tensors}) == 1:
            return False
    elif all(t.is_cpu for t in tensors):
        return True
    raise ValueError(
        "paged attention needs all tensors on the CPU or all on one CUDA "
        f"device, got {sorted(str(t.device) for t in tensors)}"
    )


@functools.lru_cache(maxsize=1024)
def _shapes(q_shape, q_dtype, cache_shape, cache_dtype, v_shape, v_dtype,
            block_size):
    """(nq, nkv, slots, d) of q (rows, nq, d) and the caches (L, nkv,
    slots, d), or ValueError. A function of shapes and dtypes alone, so a
    wrapper checks each combination once, not on every call."""
    if len(q_shape) != 3 or len(cache_shape) != 4:
        raise ValueError(
            f"q must be (rows, nq, d) and the cache (L, nkv, slots, d); got "
            f"{tuple(q_shape)} and {tuple(cache_shape)}"
        )
    if v_shape != cache_shape or v_dtype != cache_dtype:
        raise ValueError("k_cache and v_cache must match in shape and dtype")
    _, nq, d = q_shape
    _, nkv, slots, dc = cache_shape
    if dc != d or nq % nkv:
        raise ValueError(
            f"head dims disagree (q d={d}, cache d={dc}) or nq={nq} is not "
            f"a multiple of nkv={nkv}"
        )
    if d > 256 or d % 8:
        raise ValueError(f"head_dim must be <= 256 and a multiple of 8, got {d}")
    if q_dtype not in _DTYPE_CODES or cache_dtype not in _DTYPE_CODES:
        raise ValueError(
            f"kernels take float32 or bfloat16, got q {q_dtype} and cache "
            f"{cache_dtype}"
        )
    if slots % block_size:
        raise ValueError(f"cache slots {slots} not a multiple of {block_size}")
    return nq, nkv, slots, d


def _check_common(q, k_cache, v_cache, block_size):
    shapes = _shapes(q.shape, q.dtype, k_cache.shape, k_cache.dtype,
                     v_cache.shape, v_cache.dtype, block_size)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return shapes


def _check_index(name, t, dim):
    if t.dtype != torch.int32 or t.dim() != dim or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dim}-d int32 tensor, got "
            f"{t.dtype} {tuple(t.shape)}"
        )


def _check_layer(layer, k_cache):
    layer = int(layer)
    if not 0 <= layer < k_cache.shape[0]:
        raise ValueError(f"layer {layer} outside [0, {k_cache.shape[0]})")
    return layer


def _fits(need: int, what: str) -> int:
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} needs {need} bytes of shared memory, more than a "
            "Hopper block has"
        )
    return need


def _decode_smem(g, d, q_itemsize, cache_itemsize) -> int:
    """csrc/paged_decode.cu smem_bytes: the q tile (16 rows of d elements
    + 16 bytes), the split's table slice (32 ints), the ring of
    DECODE_STAGES stages of K and V chunks (DECODE_KT rows of d elements +
    16 bytes), whose space the four warps' (m, l, acc) reuse, and on the
    FMA path (not bf16 q and cache) each warp's 16 x 16 block of P."""
    mma = q_itemsize == 2 and cache_itemsize == 2
    ring = (DECODE_STAGES[cache_itemsize] * 2 * DECODE_KT
            * (d * cache_itemsize + 16))
    need = (16 * (d * q_itemsize + 16) + 4 * 32
            + max(ring, 4 * 4 * g * (d + 2)) + (0 if mma else 4 * 4 * 16 * 16))
    return _fits(need, f"the decode kernel at g={g}, head_dim {d}")


def _prefill_smem(d, q_itemsize, cache_itemsize) -> int:
    """csrc/paged_tile.cuh smem_bytes, the prefill and ragged kernels'
    shared memory per block: the Q tile (PREFILL_BM rows of d
    elements + 16 bytes), two stages of K and V tiles (PREFILL_BN rows),
    and on the FMA path (not bf16 q and cache) each warp's 16 x
    PREFILL_BN block of P in f32."""
    mma = q_itemsize == 2 and cache_itemsize == 2
    need = (PREFILL_BM * (d * q_itemsize + 16)
            + 2 * 2 * PREFILL_BN * (d * cache_itemsize + 16)
            + (0 if mma else 4 * 4 * 16 * PREFILL_BN))
    return _fits(need, f"the prefill kernel at head_dim {d}")


def check_kernel_shapes(d, block_size, g=None):
    """Shapes the card kernels are built for (g: decode's query heads per
    kv head); raised before any launch, and by the model runner at boot
    for the model it serves on the card."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the card kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if block_size not in KERNEL_BLOCK_SIZES:
        raise ValueError(f"the card kernels take block_size in "
                         f"{KERNEL_BLOCK_SIZES}, got {block_size}")
    if g is not None and g > DECODE_MAX_G:
        raise ValueError(f"the decode kernel takes at most {DECODE_MAX_G} "
                         f"query heads per kv head, got {g}")


@functools.lru_cache(maxsize=1024)
def _decode_plan(g, d, q_itemsize, cache_itemsize, block_size, num_pages):
    """The decode kernel's (pages_per_split, n_splits) for these shapes,
    after checking that it is built for them and that they fit."""
    check_kernel_shapes(d, block_size, g)
    _decode_smem(g, d, q_itemsize, cache_itemsize)
    return _decode_split_plan(num_pages, block_size)


@functools.lru_cache(maxsize=1024)
def _prefill_plan(d, q_itemsize, cache_itemsize, block_size):
    """Checks that the prefill tile (prefill and ragged kernels) is built
    for these shapes and fits."""
    check_kernel_shapes(d, block_size)
    _prefill_smem(d, q_itemsize, cache_itemsize)


def _ragged_grid(n_segs: int, tq: int, g: int, nkv: int) -> tuple:
    """The ragged kernel's grid (csrc/paged_attention.cu launch): one block
    per (segment, PREFILL_BM-fused-row tile of a segment's at most tq * g
    fused rows, kv head), (n_segs * tiles_per_seg, nkv). Shapes alone:
    the host never reads the segments."""
    return n_segs * _cdiv(tq * g, PREFILL_BM), nkv


def _check_aligned(*ptrs):
    """The card kernels copy rows into shared memory in 16-byte pieces
    (cp.async): the tensors they copy from must start on a 16-byte
    boundary."""
    for p in ptrs:
        if p % 16:
            raise ValueError("the card kernels need 16-byte aligned q and "
                             "caches (a view at an odd offset?)")


_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
# entry point -> argtypes, exactly the C signatures
_ARGTYPES = {
    "pst_ragged_paged_attention": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP,   # q k v out tables blk_seg meta
        _I32, _I32, _I32, _I32, _I32,        # dtypes layer G SC
        _I32, _I32, _I32,                    # tq nq nkv
        _I64, _I32, _I32, _I32, _F32, _I32, _VP,   # slots d bs P scale win s
    ],
    "pst_paged_prefill_attention": [
        _VP, _VP, _VP, _VP, _VP,             # q k v out table
        _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # dtypes layer q_start t nq nkv
        _I64, _I32, _I32, _I32, _F32, _I32, _VP,   # slots d bs P scale win s
    ],
    "pst_paged_decode_attention": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,  # q k v out acc ml tables ctx
        _I32, _I32, _I32, _I32, _I32, _I32,  # dtypes layer b nq nkv
        _I64, _I32, _I32, _I32, _I32, _I32,  # slots d bs P pps n_splits
        _F32, _I32, _VP,                     # scale window stream
    ],
}
_FNS: dict = {}


def _kernel(entry: str):
    """The C entry point, the kernel library built and loaded on first
    use."""
    fn = _FNS.get(entry)
    if fn is None:
        from production_stack_tpu_torch.ops import cuda_build

        fn = getattr(cuda_build.load(), entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the raw cudaStream_t."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _window_arg(window) -> int:
    if window is None:
        return 0
    if int(window) <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    return int(window)


def ragged_paged_attention(q, k_cache, v_cache, layer, block_tables,
                           blk_seg, seg_meta, *, block_size, scale,
                           window=None):
    """One launch of ragged paged attention over any lane mix.

    q (R, nq, d) holds every lane's query rows back to back; block i of
    R // G rows owns segments [blk_seg[i], blk_seg[i+1]) of seg_meta,
    each [lane, row0, n_rows, q_pos0]. Returns (R, nq, d) in q.dtype;
    rows covered by no segment are undefined.

    On the card one block runs each (segment, PREFILL_BM-fused-row tile,
    kv head) on the prefill kernel's tile (`_ragged_grid`), so it takes
    the prefill kernel's head dims and block sizes."""
    on_cpu = _on_cpu(q, k_cache, v_cache, block_tables, blk_seg, seg_meta)
    nq, nkv, slots, d = _check_common(q, k_cache, v_cache, block_size)
    _check_index("block_tables", block_tables, 2)
    _check_index("blk_seg", blk_seg, 1)
    _check_index("seg_meta", seg_meta, 2)
    if seg_meta.shape[1] != 4:
        raise ValueError(f"seg_meta must be (SC, 4), got {tuple(seg_meta.shape)}")
    r = q.shape[0]
    n_blocks = blk_seg.shape[0] - 1
    if n_blocks < 1 or r % n_blocks:
        raise ValueError(f"row space {r} must tile into {n_blocks} blocks")
    tq = r // n_blocks
    layer = _check_layer(layer, k_cache)
    if on_cpu:
        return ragged_paged_attention_plain(
            q, k_cache, v_cache, layer, block_tables, blk_seg, seg_meta,
            block_size=block_size, scale=scale, window=window,
        )
    _prefill_plan(d, q.element_size(), k_cache.element_size(), block_size)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    _check_aligned(*ptrs)
    out = torch.empty_like(q)
    n_segs = seg_meta.shape[0]
    if n_segs == 0:
        return out  # no segment: every row undefined, nothing to launch
    rc = _kernel("pst_ragged_paged_attention")(
        *ptrs, out.data_ptr(), block_tables.data_ptr(), blk_seg.data_ptr(),
        seg_meta.data_ptr(), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_cache.dtype], layer, n_blocks, n_segs, tq, nq, nkv,
        slots, d, block_size, block_tables.shape[1], float(scale),
        _window_arg(window), _stream(q),
    )
    _raise_on(rc, "ragged paged attention")
    _LAUNCHES["ragged"] += 1
    return out


def paged_prefill_attention(q, k_cache, v_cache, layer, block_table,
                            q_start, *, block_size, scale, window=None):
    """Chunked-prefill paged attention for one sequence whose t query
    rows (a positive multiple of PREFILL_TQ) sit at positions q_start,
    q_start + 1, ... -> (t, nq, d)."""
    on_cpu = _on_cpu(q, k_cache, v_cache, block_table)
    nq, nkv, slots, d = _check_common(q, k_cache, v_cache, block_size)
    _check_index("block_table", block_table, 1)
    t = q.shape[0]
    if t == 0 or t % PREFILL_TQ:
        raise ValueError(f"chunk rows {t} must be a positive multiple of "
                         f"{PREFILL_TQ}")
    layer = _check_layer(layer, k_cache)
    q_start = int(q_start)
    if q_start < 0:
        raise ValueError(f"q_start must be >= 0, got {q_start}")
    if on_cpu:
        return paged_prefill_attention_plain(
            q, k_cache, v_cache, layer, block_table, q_start,
            block_size=block_size, scale=scale, window=window,
        )
    _prefill_plan(d, q.element_size(), k_cache.element_size(), block_size)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    _check_aligned(*ptrs)
    out = torch.empty_like(q)
    rc = _kernel("pst_paged_prefill_attention")(
        *ptrs, out.data_ptr(), block_table.data_ptr(),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], layer, q_start,
        t, nq, nkv, slots, d, block_size, block_table.shape[0],
        float(scale), _window_arg(window), _stream(q),
    )
    _raise_on(rc, "paged prefill attention")
    _LAUNCHES["prefill"] += 1
    return out


def paged_decode_attention(q, k_cache, v_cache, layer, block_tables,
                           context_lens, *, block_size, scale, window=None):
    """One decode step of paged attention. Returns (b, nq, d) in q.dtype.

    On the card the context splits into `_decode_split_plan` splits of
    DECODE_SPLIT_KEYS keys, each one block per (sequence, kv head); with
    more than one split, f32 scratch holds each split's (m, l, acc) and a
    second kernel merges them."""
    on_cpu = _on_cpu(q, k_cache, v_cache, block_tables, context_lens)
    nq, nkv, slots, d = _check_common(q, k_cache, v_cache, block_size)
    _check_index("block_tables", block_tables, 2)
    _check_index("context_lens", context_lens, 1)
    b = q.shape[0]
    if b == 0 or block_tables.shape[0] != b or context_lens.shape[0] != b:
        raise ValueError(
            f"q {tuple(q.shape)}, block_tables {tuple(block_tables.shape)} "
            f"and context_lens {tuple(context_lens.shape)} disagree on batch"
        )
    layer = _check_layer(layer, k_cache)
    if on_cpu:
        return paged_decode_attention_plain(
            q, k_cache, v_cache, layer, block_tables, context_lens,
            block_size=block_size, scale=scale, window=window,
        )
    g = nq // nkv
    num_pages = block_tables.shape[1]
    pps, n_splits = _decode_plan(g, d, q.element_size(),
                                 k_cache.element_size(), block_size,
                                 num_pages)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    _check_aligned(*ptrs)
    out = torch.empty_like(q)
    part_acc = part_ml = 0  # null: one split writes the output itself
    if n_splits > 1:
        # f32 scratch: (b, nkv, n_splits, g, d) acc, then (.., g, 2) m, l
        n_acc = b * nkv * n_splits * g * d
        scratch = torch.empty((n_acc + n_acc // d * 2,),
                              dtype=torch.float32, device=q.device)
        part_acc = scratch.data_ptr()
        part_ml = part_acc + 4 * n_acc
    rc = _kernel("pst_paged_decode_attention")(
        *ptrs, out.data_ptr(), part_acc, part_ml, block_tables.data_ptr(),
        context_lens.data_ptr(), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_cache.dtype], layer, b, nq, nkv, slots, d,
        block_size, num_pages, pps, n_splits, float(scale),
        _window_arg(window), _stream(q),
    )
    _raise_on(rc, "paged decode attention")
    _LAUNCHES["decode"] += 1
    return out
