"""Paged attention over a block-table-indexed KV cache — the gather path.

Counterpart of ``production_stack_tpu/ops/attention.py``. A sequence owns
an ordered list of blocks (its *block table*); the token at absolute
position p lives in slot ``block_table[p // block_size] * block_size +
p % block_size``, so row i of the gathered context is absolute position i.

This module materialises the gathered context and runs a plain masked
softmax. It is the oracle the paged kernels (ops/paged_attention.py) are
held against in the tests; the card's serving path never calls it.
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e30


def block_table_slots(block_table: torch.Tensor,
                      block_size: int) -> torch.Tensor:
    """Expand a block table into per-position cache slots.

    block_table: (..., num_blocks) int -> slots (..., num_blocks * block_size)
    where slots[..., p] is the cache row holding absolute position p."""
    bt = torch.as_tensor(block_table).long()
    offsets = torch.arange(block_size, dtype=torch.long, device=bt.device)
    slots = bt[..., :, None] * block_size + offsets
    return slots.reshape(*bt.shape[:-1], -1)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                scale: float) -> torch.Tensor:
    """q: (..., nq, d), k: (..., c, nkv, d) -> scores (..., nkv, g, c) f32."""
    *lead, nq, d = q.shape
    nkv = k.shape[-2]
    qg = q.reshape(*lead, nkv, nq // nkv, d).float()
    return torch.einsum("...kgd,...ckd->...kgc", qg, k.float()) * scale


def _gqa_output(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (..., nkv, g, c), v: (..., c, nkv, d) -> out (..., nq, d) f32."""
    *lead, nkv, g, _ = p.shape
    out = torch.einsum("...kgc,...ckd->...kgd", p, v.float())
    return out.reshape(*lead, nkv * g, v.shape[-1])


def context_attention_decode(
    q: torch.Tensor,             # (batch, num_q_heads, head_dim)
    k_ctx: torch.Tensor,         # (batch, padded_ctx, num_kv_heads, head_dim)
    v_ctx: torch.Tensor,
    context_lens: torch.Tensor,  # (batch,) valid positions incl. the new token
    scale: float,
    window: int | None = None,
) -> torch.Tensor:
    """One decode step over gathered per-sequence context. -> (b, nq, d).

    With `window`, the query (at position context_len-1) attends only its
    last `window` predecessors incl. itself (keys j with
    q_pos - window < j <= q_pos)."""
    scores = _gqa_scores(q, k_ctx, scale)  # (b, nkv, g, c)
    c = k_ctx.shape[1]
    key_pos = torch.arange(c, device=q.device)[None, :]
    lens = context_lens.to(q.device).long()[:, None]
    valid = key_pos < lens
    if window is not None:
        valid = valid & (key_pos > lens - 1 - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, MASK_VALUE))
    p = torch.softmax(scores, dim=-1)
    return _gqa_output(p, v_ctx).to(q.dtype)


def context_attention_prefill(
    q: torch.Tensor,            # (t, num_q_heads, head_dim) — chunk queries
    k_ctx: torch.Tensor,        # (padded_ctx, num_kv_heads, head_dim)
    v_ctx: torch.Tensor,
    q_positions: torch.Tensor,  # (t,) absolute positions of the chunk tokens
    total_len: int,             # valid context positions (prefix + chunk)
    scale: float,
    window: int | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention for one sequence; causal over absolute
    positions (context rows ARE absolute positions). -> (t, nq, d)."""
    scores = _gqa_scores(q, k_ctx, scale)  # (t, nkv, g, c)
    c = k_ctx.shape[0]
    key_pos = torch.arange(c, device=q.device)[None, :]
    qp = q_positions.to(q.device).long()[:, None]
    mask = (key_pos <= qp) & (key_pos < int(total_len))
    if window is not None:
        mask = mask & (key_pos > qp - window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, MASK_VALUE))
    p = torch.softmax(scores, dim=-1)
    return _gqa_output(p, v_ctx).to(q.dtype)
