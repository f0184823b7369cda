"""Paged GQA attention over the head-major paged KV cache: the three
hand-written CUDA kernels (csrc/paged_attention.cu), their wrappers, their
plain PyTorch versions and a launch counter.

Counterpart of ``production_stack_tpu/ops/pallas_attention.py``; the
functions keep its names, signatures and layouts:

- the KV cache is HEAD-MAJOR ``(L, nkv, slots, d)``; ``layer`` indexes
  the full cache, so no per-layer copy is ever made;
- ``ragged_paged_attention`` runs a flattened row space of any lane mix
  described by CSR segment metadata (``blk_seg``, ``seg_meta``);
- ``paged_prefill_attention`` runs one sequence's contiguous chunk;
- ``paged_decode_attention`` runs one query row per sequence.

A wrapper checks its inputs the same way for both devices, then, handed
CUDA tensors, launches its kernel (or raises); handed CPU tensors, it
computes the plain version. There is no fallback from one to the other.
The plain versions walk the same page ranges with the same masking
(MASK_VALUE = -1e30, f32 softmax), so a row's result does not depend on
which of the two computed it beyond summation order.
"""

from __future__ import annotations

import ctypes

import torch

MASK_VALUE = -1e30

# Query-tile rows of the ragged kernel's row blocks (the Pallas
# RAGGED_TQ): prefill chunks pack RAGGED_TQ-aligned, decode lanes share
# blocks one row each.
RAGGED_TQ = 8
# Query-tile rows of the card's prefill kernel. The Pallas kernel sizes
# its tile to TPU VMEM (_prefill_q_tile); on the card one block holds
# PREFILL_TQ rows x g heads in shared memory, and more tiles mean more
# blocks in flight.
PREFILL_TQ = 8
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
    both what the online-softmax kernels give."""
    n, nq, d = q_rows.shape
    if pages.numel() == 0:
        return torch.zeros_like(q_rows)
    nkv = k_cache.shape[1]
    g = nq // nkv
    offs = torch.arange(block_size, device=pages.device)
    slots = (pages.long()[:, None] * block_size + offs).reshape(-1)
    k = k_cache[layer][:, slots].float()  # (nkv, K, d)
    v = v_cache[layer][:, slots].float()
    qf = q_rows.float().reshape(n, nkv, g, d) * scale
    s = torch.einsum("nhgd,hkd->nhgk", qf, k)
    kpos = kpos0 + torch.arange(slots.numel(), device=q_rows.device)
    qp = q_pos.to(q_rows.device).long()[:, None]
    valid = kpos[None, :] <= qp
    if window is not None:
        valid = valid & (kpos[None, :] > qp - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("nhgk,hkd->nhgd", p, v)
    return out.reshape(n, nq, d).to(q_rows.dtype)


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


def paged_decode_attention_plain(q, k_cache, v_cache, layer, block_tables,
                                 context_lens, *, block_size, scale,
                                 window=None):
    """Plain PyTorch version of the decode kernel."""
    num_pages = block_tables.shape[1]
    bs = block_size
    out = torch.empty_like(q)
    for i, ctx in enumerate(context_lens.tolist()):
        n_used = min(_cdiv(ctx, bs), num_pages)
        n_start = 0 if window is None else max(ctx - window, 0) // bs
        n_start = min(n_start, n_used)
        out[i:i + 1] = _attend(
            q[i:i + 1], k_cache, v_cache, int(layer),
            block_tables[i, n_start:n_used],
            torch.tensor([ctx - 1], device=q.device), n_start * bs, bs,
            scale, window,
        )
    return out


# -- wrappers ----------------------------------------------------------------
def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on a CUDA device; anything else is an error."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        "paged attention needs all tensors on the CPU or all on one CUDA "
        f"device, got {sorted(str(t.device) for t in tensors)}"
    )


def _check_common(q, k_cache, v_cache, block_size):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"q must be (rows, nq, d) and the cache (L, nkv, slots, d); got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}"
        )
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache must match in shape and dtype")
    _, nq, d = q.shape
    _, nkv, slots, dc = k_cache.shape
    if dc != d or nq % nkv:
        raise ValueError(
            f"head dims disagree (q d={d}, cache d={dc}) or nq={nq} is not "
            f"a multiple of nkv={nkv}"
        )
    if d > 256 or d % 8:
        raise ValueError(f"head_dim must be <= 256 and a multiple of 8, got {d}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"kernels take float32 or bfloat16, got q {q.dtype} and cache "
            f"{k_cache.dtype}"
        )
    if slots % block_size:
        raise ValueError(f"cache slots {slots} not a multiple of {block_size}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return nq, nkv, slots, d


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


def _smem(rows, d) -> int:
    need = 4 * (2 * rows * d + 32 * (d + 1) + 32 * d + rows * 32 + 3 * rows)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"{rows} fused query rows at head_dim {d} need {need} bytes of "
            "shared memory, more than a Hopper block has"
        )
    return need


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _lib():
    from production_stack_tpu_torch.ops import cuda_build

    lib = cuda_build.load("paged_attention")
    if not getattr(lib, "_pst_typed", False):
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_float)
        lib.pst_ragged_paged_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
            i64, i32, i32, i32, f32, i32, vp,
        ]
        lib.pst_paged_prefill_attention.argtypes = [
            vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i64,
            i32, i32, i32, f32, i32, vp,
        ]
        lib.pst_paged_decode_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i64, i32,
            i32, i32, f32, i32, vp,
        ]
        for fn in (lib.pst_ragged_paged_attention,
                   lib.pst_paged_prefill_attention,
                   lib.pst_paged_decode_attention):
            fn.restype = ctypes.c_int
        lib._pst_typed = True
    return lib


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
    rows covered by no segment are undefined."""
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
    _smem(tq * (nq // nkv), d)
    layer = _check_layer(layer, k_cache)
    if on_cpu:
        return ragged_paged_attention_plain(
            q, k_cache, v_cache, layer, block_tables, blk_seg, seg_meta,
            block_size=block_size, scale=scale, window=window,
        )
    out = torch.empty_like(q)
    rc = _lib().pst_ragged_paged_attention(
        _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out),
        _ptr(block_tables), _ptr(blk_seg), _ptr(seg_meta),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], layer,
        n_blocks, tq, nq, nkv, slots, d, block_size,
        block_tables.shape[1], float(scale), _window_arg(window),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, "ragged paged attention")
    _LAUNCHES["ragged"] += 1
    return out


def paged_prefill_attention(q, k_cache, v_cache, layer, block_table,
                            q_start, *, block_size, scale, window=None):
    """Chunked-prefill paged attention for one sequence whose t query
    rows sit at positions q_start, q_start + 1, ... -> (t, nq, d)."""
    on_cpu = _on_cpu(q, k_cache, v_cache, block_table)
    nq, nkv, slots, d = _check_common(q, k_cache, v_cache, block_size)
    _check_index("block_table", block_table, 1)
    t = q.shape[0]
    if t == 0 or t % PREFILL_TQ:
        raise ValueError(f"chunk rows {t} must be a positive multiple of "
                         f"{PREFILL_TQ}")
    _smem(PREFILL_TQ * (nq // nkv), d)
    layer = _check_layer(layer, k_cache)
    q_start = int(q_start)
    if q_start < 0:
        raise ValueError(f"q_start must be >= 0, got {q_start}")
    if on_cpu:
        return paged_prefill_attention_plain(
            q, k_cache, v_cache, layer, block_table, q_start,
            block_size=block_size, scale=scale, window=window,
        )
    out = torch.empty_like(q)
    rc = _lib().pst_paged_prefill_attention(
        _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out), _ptr(block_table),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], layer, q_start,
        t, PREFILL_TQ, nq, nkv, slots, d, block_size, block_table.shape[0],
        float(scale), _window_arg(window),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, "paged prefill attention")
    _LAUNCHES["prefill"] += 1
    return out


def paged_decode_attention(q, k_cache, v_cache, layer, block_tables,
                           context_lens, *, block_size, scale, window=None):
    """One decode step of paged attention. Returns (b, nq, d) in q.dtype."""
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
    _smem(nq // nkv, d)
    layer = _check_layer(layer, k_cache)
    if on_cpu:
        return paged_decode_attention_plain(
            q, k_cache, v_cache, layer, block_tables, context_lens,
            block_size=block_size, scale=scale, window=window,
        )
    out = torch.empty_like(q)
    rc = _lib().pst_paged_decode_attention(
        _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out),
        _ptr(block_tables), _ptr(context_lens), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_cache.dtype], layer, b, nq, nkv, slots, d,
        block_size, block_tables.shape[1], float(scale),
        _window_arg(window),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, "paged decode attention")
    _LAUNCHES["decode"] += 1
    return out
