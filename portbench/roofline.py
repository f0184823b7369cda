"""The H100's peaks and the work the served requests needed: model FLOPs
and the attention kernels' roofline bound.

Peaks: NVIDIA H100 SXM5 data sheet, dense (no sparsity): 989 TFLOP/s
bf16 on the tensor cores, 3.35 TB/s of HBM3, at the 700 W power limit.

Every count here comes from what the requests needed, never from how
the program launched it: a prompt's uncached rows and a token's context,
not buckets, padding or variants. A prompt is one attention call over
its whole context (what chunking splits is the program's choice); each
generated token after the first is one call over its context. A call
reads each input byte once (its K/V, its queries) and writes its output
once. So a later change to how the work is launched cannot change these
numbers.

``attn_bound_s`` is the bound of ``chip_smoke.py``'s kernel phase (the
attention roofline PR 1 defined), copied here so that it stays fixed.
"""

from __future__ import annotations

from dataclasses import dataclass

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0


@dataclass(frozen=True)
class Shape:
    """The sizes the counts need, read from a published config.json."""
    layers: int
    hidden: int
    intermediate: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    bytes_per_value: int = 2  # bf16 weights, activations and KV

    @classmethod
    def from_hf(cls, hf: dict) -> "Shape":
        heads = hf["num_attention_heads"]
        return cls(
            layers=hf["num_hidden_layers"], hidden=hf["hidden_size"],
            intermediate=hf["intermediate_size"], heads=heads,
            kv_heads=hf.get("num_key_value_heads", heads),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
            vocab=hf["vocab_size"])

    @property
    def layer_matmul_params(self) -> int:
        """Weights a token row multiplies in one layer: q, k, v, o and
        the gated MLP's three."""
        h, d = self.hidden, self.head_dim
        return (h * self.heads * d + 2 * h * self.kv_heads * d
                + self.heads * d * h + 3 * h * self.intermediate)


def attn_bound_s(shape: Shape, n_rows: int, visible_keys: int,
                 kv_tokens: int) -> float:
    """Least seconds one layer's attention call can take on the H100:
    its K/V of `kv_tokens` and its `n_rows` queries and outputs moved
    once, against 4 * visible_keys * nq * d operations (QK^T and PV)."""
    b = shape.bytes_per_value
    kv_bytes = 2 * kv_tokens * shape.kv_heads * shape.head_dim * b
    qo_bytes = 2 * n_rows * shape.heads * shape.head_dim * b
    ops = 4 * visible_keys * shape.heads * shape.head_dim
    return max((kv_bytes + qo_bytes) / HBM_BYTES_PER_S, ops / BF16_FLOPS)


def causal_keys(start: int, end: int) -> int:
    """Keys the rows at positions start..end-1 see: sum of (p + 1)."""
    return (end * (end + 1) - start * (start + 1)) // 2


@dataclass
class Work:
    """FLOPs and attention bound of some served work."""
    flops: float = 0.0
    attn_bound_s: float = 0.0
    rows: float = 0

    def add(self, other: "Work", share: float = 1.0) -> None:
        self.flops += share * other.flops
        self.attn_bound_s += share * other.attn_bound_s
        self.rows += share * other.rows


def prefill_work(shape: Shape, prompt_len: int, cached: int) -> Work:
    """A prompt of `prompt_len` tokens whose first `cached` were in the
    prefix cache: its uncached rows through every layer, one attention
    call a layer over the whole context, and the logits of its last row
    (the first generated token)."""
    rows = prompt_len - cached
    keys = causal_keys(cached, prompt_len)
    s = shape
    flops = (2 * s.layer_matmul_params * s.layers * rows
             + 4 * keys * s.heads * s.head_dim * s.layers
             + 2 * s.hidden * s.vocab)
    bound = s.layers * attn_bound_s(s, rows, keys, prompt_len)
    return Work(flops, bound, rows)


def decode_work(shape: Shape, prompt_len: int, token_index: int) -> Work:
    """Generated token `token_index` (2 for the second, ...): one row,
    the previous token at position prompt_len + token_index - 2, seeing
    prompt_len + token_index - 1 keys, and its logits."""
    ctx = prompt_len + token_index - 1
    s = shape
    flops = (2 * s.layer_matmul_params * s.layers
             + 4 * ctx * s.heads * s.head_dim * s.layers
             + 2 * s.hidden * s.vocab)
    bound = s.layers * attn_bound_s(s, 1, ctx, ctx)
    return Work(flops, bound, 1)


def overlap(a: float, b: float, t0: float, t1: float) -> float:
    """The share of the interval [a, b] that lies in [t0, t1)."""
    if b <= a:
        return 1.0 if t0 <= b < t1 else 0.0
    return max(0.0, min(b, t1) - max(a, t0)) / (b - a)


def served_work(shape: Shape, requests, t0: float, t1: float) -> Work:
    """The work behind what `requests` got in [t0, t1). Each delivery's
    work (a prompt's with the first token, a later token's with it) is
    spread over the time since the request's previous delivery, or since
    it was sent, and counted for the part of that interval inside the
    window."""
    total = Work()
    for r in requests:
        seen, prev = 0, r.sent_s
        for t, n in r.chunks:
            share = overlap(prev, t, t0, t1)
            if share > 0:
                for j in range(seen + 1, seen + n + 1):
                    w = (prefill_work(shape, r.prompt_len, r.cached)
                         if j == 1 else decode_work(shape, r.prompt_len, j))
                    total.add(w, share)
            seen, prev = seen + n, t
    return total
