"""Ring attention: sequence parallelism for long-context prefill.

Counterpart of ``production_stack_tpu/parallel/ring_attention.py``. The
JAX ring runs inside ``shard_map`` on an ``sp`` mesh axis and rotates
K/V blocks with ``lax.ppermute``. Here a ring is a list of ``sp`` torch
devices driven from one process (the single-controller model the JAX
engine uses too): rank i holds query block Q_i on ``devices[i]`` and
owns K/V block KV_i; at hop r it attends to the block first owned by
rank (i - r) mod sp, moved to its own device with
``Tensor.to(device, non_blocking=True)``, which is the identity when
both ranks share a device. Every operation is an enqueue: nothing here
reads a value back to the host.

Each rank keeps a flash-style online softmax over the hops (running
max ``m``, normalizer ``l``, weighted sum ``acc``, all float32), so
after sp hops every query block has seen every KV block. Causality
uses GLOBAL positions: query block i covers [i*lq, (i+1)*lq) (shifted
by ``q_offset`` in chunked prefill), KV block j covers
[j*lk, (j+1)*lk), and one ``qpos >= kpos`` mask covers the visible,
diagonal and fully masked cases. ``window`` adds HF sliding-window
semantics (keys j with q_pos - window < j <= q_pos).

GQA groups q heads onto kv heads inside the products, so the moved
blocks stay at kv-head width. Scores and values are float32 products of
the inputs (JAX's ``preferred_element_type=jnp.float32``): bf16 inputs
are widened exactly, and the products run at the card's float32 rate
(TF32 off). The ring's einsums are XLA code in JAX and plain torch
here: no kernel.
"""

from __future__ import annotations

import torch


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[b,lq,h,d] x [b,lk,hk,d] -> [b,h,lq,lk] f32 with h = g*hk (GQA):
    the g q heads of a kv head form one (g*lq, d) operand."""
    b, lq, h, d = q.shape
    lk, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.float().reshape(b, lq, hk, g, d).permute(0, 2, 3, 1, 4)
    s = torch.matmul(qg.reshape(b, hk, g * lq, d),
                     k.float().permute(0, 2, 3, 1))
    return s.view(b, h, lq, lk)


def _grouped_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[b,h,lq,lk] x [b,lk,hk,d] -> [b,lq,h,d] (f32 accumulation)."""
    b, h, lq, lk = p.shape
    hk, d = v.shape[2], v.shape[3]
    g = h // hk
    o = torch.matmul(p.reshape(b, hk, g * lq, lk),
                     v.float().permute(0, 2, 1, 3))
    return o.view(b, hk, g, lq, d).permute(0, 3, 1, 2, 4).reshape(
        b, lq, h, d)


def ring_attention_local(
    q: torch.Tensor,
    k_blocks: list[torch.Tensor],
    v_blocks: list[torch.Tensor],
    rank: int,
    q_offset: int | torch.Tensor | None = None,
    *,
    causal: bool = True,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Rank `rank`'s body of the ring.

    q: [b, lq, h, d], the rank's query block on its device; k_blocks[j],
    v_blocks[j]: [b, lk, hk, d], the KV block rank j owns (sp = the list
    length). Returns [b, lq, h, d] attention output for the rank's query
    block, in q.dtype.

    `q_offset` (a host int or a 0-d device tensor) shifts the query
    blocks' global positions: chunked long-context prefill runs a
    [start, start+C) query slice against the full-sequence cache, so the
    causal mask compares start-relative query rows to absolute key rows.
    None = the classic full-sequence ring (q and kv cover the same span).
    """
    b, lq, h, d = q.shape
    sp = len(k_blocks)
    lk = k_blocks[0].shape[1]
    dev = q.device
    scale = d ** -0.5 if scale is None else scale
    qpos = rank * lq + torch.arange(lq, device=dev)
    if q_offset is not None:
        qpos = qpos + q_offset
    acc = torch.zeros((b, lq, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, lq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    for r in range(sp):
        src = (rank - r) % sp  # original owner of the resident KV block
        k_blk = k_blocks[src].to(dev, non_blocking=True)
        v_blk = v_blocks[src].to(dev, non_blocking=True)
        s = _grouped_scores(q, k_blk).mul_(scale)  # [b,h,lq,lk] f32
        if causal:
            kpos = src * lk + torch.arange(lk, device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            masked = ~mask
            s.masked_fill_(masked, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # rows with every position masked so far keep m == -inf; exp(s - m)
        # would be NaN, so pin those rows to zero contribution
        safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = s.sub_(safe_m[..., None]).exp_()
        if causal:
            p.masked_fill_(masked, 0.0)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.transpose(1, 2)[..., None] + _grouped_values(
            p, v_blk)
        m = m_new
        del s, p
    norm = torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return (acc / norm).to(q.dtype)


def ring_attention_blocks(
    q: torch.Tensor,
    k_blocks: list[torch.Tensor],
    v_blocks: list[torch.Tensor],
    q_offset: int | torch.Tensor | None = None,
    *,
    causal: bool = True,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """The ring over sequence-sharded K/V: q [b, Lq, h, d] (Lq divisible
    by sp = len(k_blocks)) is split into sp query blocks, block i placed
    on k_blocks[i]'s device (its rank's), each rank runs
    `ring_attention_local`, and the outputs are concatenated on q's
    device -> [b, Lq, h, d]."""
    sp = len(k_blocks)
    Lq = q.shape[1]
    if Lq % sp:
        raise ValueError(
            f"query length {Lq} is not divisible by the ring size {sp}: "
            "pad the sequence to a multiple of it")
    lq = Lq // sp
    outs = []
    for i in range(sp):
        qi = q[:, i * lq:(i + 1) * lq].to(k_blocks[i].device,
                                           non_blocking=True)
        outs.append(ring_attention_local(
            qi, k_blocks, v_blocks, i, q_offset, causal=causal,
            scale=scale, window=window,
        ).to(q.device, non_blocking=True))
    return torch.cat(outs, dim=1)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    devices: list,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Full-array entry: q [b, S, h, d], k/v [b, S, hk, d] with S the
    global sequence; shards S over the ring `devices` (one rank a
    device entry) and runs the ring. Returns [b, S, h, d] on q's device.

    S must divide evenly by the ring size (pad the prompt to the bucket,
    exactly as the engine's chunked prefill already does)."""
    sp = len(devices)
    S = k.shape[1]
    if S % sp or q.shape[1] % sp:
        raise ValueError(
            f"sequence length {S} is not divisible by the ring size {sp}: "
            "pad the sequence to a multiple of it")
    lk = S // sp
    k_blocks = [k[:, j * lk:(j + 1) * lk].to(devices[j], non_blocking=True)
                for j in range(sp)]
    v_blocks = [v[:, j * lk:(j + 1) * lk].to(devices[j], non_blocking=True)
                for j in range(sp)]
    return ring_attention_blocks(q, k_blocks, v_blocks, causal=causal,
                                 scale=scale)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Unsharded oracle: plain softmax attention with GQA."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s = _grouped_scores(q, k) * scale
    if causal:
        n, lk = q.shape[1], k.shape[1]
        qpos = torch.arange(n, device=q.device)[:, None]
        kpos = torch.arange(lk, device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return _grouped_values(p, v).to(q.dtype)
