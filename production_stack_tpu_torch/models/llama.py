"""Llama-class decoder over a paged KV cache, as functions on tensors.

Counterpart of ``production_stack_tpu/models/llama.py`` with the same
signatures and layouts: params are a dict whose layer weights are stacked
on a leading layer axis, projection weights are ``(in, out)``, and the
KV cache is head-major ``(L, nkv, slots, d)``. Attention is injected as a
callback ``attn_fn(q, layer, k_cache, v_cache)`` so the model runner
chooses the kernel and its metadata.

PyTorch runs eagerly, so the layer scan is a Python loop, and the K/V of
the new rows are written INTO the cache tensors in place (JAX's donated
scatter): the caller's caches are updated, and the same tensors are
returned for symmetry with the JAX signature.

Tensor parallelism (``tp_group``, parallel/group.TPGroup): the params are
one rank's shard (parallel/sharding.py) and ``cfg`` its local view
(``ModelConfig.tp_local``); the f32 partials of ``wo`` and ``w_down``
are all-reduced before their cast, where the JAX package's GSPMD psum
sits on the f32 dot, as is a MoE block's output (each rank runs its
E/tp experts: expert parallelism), and an untied lm_head's vocab slices
are gathered.
With ``tp_group=None`` nothing of that runs. Pipeline parallelism
(parallel/pp_serving.forward_pp) runs the same pieces, ``embed_tokens``,
``decoder_stack`` over a stage's layers and ``final_rows``, with a
hand-off between the stages.

Multi-LoRA (engine/lora.py's stacked slots) adds scaling * (x @ A) @ B
to the wq/wk/wv/wo projections, in plain PyTorch as the JAX package
computes it in XLA. A MoE model (Mixtral) runs ops/moe.py's block in
place of the dense MLP; its experts take no adapter.
"""

from __future__ import annotations

from typing import Callable

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.ops.layers import (
    apply_rope,
    matmul_f32,
    rms_norm,
    rope_cos_sin,
    swiglu,
)
from production_stack_tpu_torch.ops.moe import moe_block
from production_stack_tpu_torch.parallel import sharding

# attn_fn(q_rope, layer_idx, k_cache, v_cache) -> attn_out
AttnFn = Callable[[torch.Tensor, int, torch.Tensor, torch.Tensor],
                  torch.Tensor]


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    shard: tuple[int, int] | None = None,
    layers: tuple[int, int] | None = None,
) -> dict:
    """Random-init parameters (scaled normal), layer weights stacked on
    axis 0. `generator` must live on `device`; weights are drawn there in
    float32 one tensor at a time and cast to `dtype`. A MoE model
    (Mixtral) has a router moe_gate (L, h, E) and stacked experts w_gate /
    w_up (L, E, h, f), w_down (L, E, f, h) in place of the dense MLP.

    `shard` = (rank, tp) and `layers` = (lo, hi), a pipeline stage's
    layer range: every tensor is still drawn whole, in the same order from
    the same generator, and only the stage's layers and the rank's slice
    of a split leaf (parallel/sharding.py) are kept, so a tp=N, pp=M
    model is the tp=1, pp=1 model of the same seed, cut."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L = cfg.num_layers
    rank, tp = shard if shard is not None else (0, 1)
    span = layers  # the name is the layer dict's below

    def keep(path, x):
        return sharding.cut(path, x, cfg, rank, tp, span)

    def w(path, shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return keep(path, (x * fan_in**-0.5).to(dtype))

    def ones(path, shape):
        return keep(path, torch.ones(shape, dtype=dtype, device=device))

    def zeros(path, shape):
        return keep(path, torch.zeros(shape, dtype=dtype, device=device))

    def lw(name, shape, fan_in):
        return w(("layers", name), shape, fan_in)

    layers = {
        "attn_norm": ones(("layers", "attn_norm"), (L, h)),
        "mlp_norm": ones(("layers", "mlp_norm"), (L, h)),
        "wq": lw("wq", (L, h, cfg.q_size), h),
        "wk": lw("wk", (L, h, cfg.kv_size), h),
        "wv": lw("wv", (L, h, cfg.kv_size), h),
        "wo": lw("wo", (L, cfg.q_size, h), cfg.q_size),
    }
    if cfg.is_moe:
        E = cfg.num_experts
        layers["moe_gate"] = lw("moe_gate", (L, h, E), h)
        layers["w_gate"] = lw("w_gate", (L, E, h, i), h)
        layers["w_up"] = lw("w_up", (L, E, h, i), h)
        layers["w_down"] = lw("w_down", (L, E, i, h), i)
    else:
        layers["w_gate"] = lw("w_gate", (L, h, i), h)
        layers["w_up"] = lw("w_up", (L, h, i), h)
        layers["w_down"] = lw("w_down", (L, i, h), i)
    if cfg.qkv_bias:
        layers["bq"] = zeros(("layers", "bq"), (L, cfg.q_size))
        layers["bk"] = zeros(("layers", "bk"), (L, cfg.kv_size))
        layers["bv"] = zeros(("layers", "bv"), (L, cfg.kv_size))
    params = {
        "embed": w(("embed",), (v, h), h),
        "layers": layers,
        "final_norm": ones(("final_norm",), (h,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(("lm_head",), (h, v), h)
    return params


def decoder_layer(
    cfg: ModelConfig,
    h: torch.Tensor,            # (n, hidden)
    kc: torch.Tensor,           # (L, nkv, slots, d) — written in place
    vc: torch.Tensor,
    lp: dict,                   # this layer's param slice
    l: int,                     # layer index into kc/vc
    *,
    cos: torch.Tensor,
    sin: torch.Tensor,
    write_slots: torch.Tensor,  # (n,) int64 cache rows of the new tokens
    attn_fn: AttnFn,
    dtype: torch.dtype,
    cache_dtype: torch.dtype,
    lora_ctx: tuple | None = None,  # (lz, slot | weights (n, S))
    reduce=None,                # TP: in-place all-reduce of f32 partials
    first_expert: int = 0,      # EP: the first of the rank's experts
):
    """One decoder layer over n token rows. Writes the rows' K/V into the
    cache at `write_slots` (in place) BEFORE attn_fn runs, so attention
    sees them.

    `lora_ctx` = (lz, sel): lz holds this layer's adapter rows ({t}_B
    (S, r, out), scaling (S,), {t}_A (S, in, r), or (in, S*r) on the
    per-row path); sel is one slot (an int or 0-d tensor: every row uses
    it) or (n, S) f32 per-row weights, row i's scaling at its slot's
    column and 0 elsewhere (see lora_row_weights)."""
    n = h.shape[0]

    def proj(x, target, bias):
        out = matmul_f32(x, lp[target])
        if bias is not None:
            out = out + bias.float()
        if lora_ctx is not None:
            out = out + lora_delta(x, lora_ctx, target)
        return out

    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps,
                 cfg.norm_weight_offset)
    q = proj(x, "wq", lp["bq"] if cfg.qkv_bias else None)
    k = proj(x, "wk", lp["bk"] if cfg.qkv_bias else None)
    v = proj(x, "wv", lp["bv"] if cfg.qkv_bias else None)
    q = q.to(dtype).reshape(n, cfg.num_heads, cfg.head_dim)
    k = k.to(dtype).reshape(n, cfg.num_kv_heads, cfg.head_dim)
    v = v.to(dtype).reshape(n, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    # head-major in-place cache write: (nkv, n, d) rows at write_slots.
    # Padded rows all point at the trash slot 0, so which of them lands
    # there is unspecified, as in the JAX scatter.
    kc[l][:, write_slots] = k.to(cache_dtype).transpose(0, 1)
    vc[l][:, write_slots] = v.to(cache_dtype).transpose(0, 1)

    attn_out = attn_fn(q, l, kc, vc)  # (n, nq, d)
    o = proj(attn_out.reshape(n, cfg.q_size).to(dtype), "wo", None)
    if reduce is not None:
        o = reduce(o)
    h = h + o.to(dtype)

    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps,
                 cfg.norm_weight_offset)
    if cfg.is_moe:
        # under TP the rank's experts' share, summed as the dense MLP's
        o = moe_block(
            x, lp["moe_gate"], lp["w_gate"], lp["w_up"], lp["w_down"],
            cfg.num_experts_per_tok, cfg.moe_capacity_factor,
            first_expert=first_expert,
        )
        if reduce is not None:
            o = reduce(o)
        h = h + o.to(dtype)
    else:
        h = h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"],
                       act=cfg.hidden_act, reduce=reduce)
    return h, kc, vc


def forward(
    cfg: ModelConfig,
    params: dict,
    token_ids: torch.Tensor,    # (n,) int
    positions: torch.Tensor,    # (n,) int absolute positions
    k_cache: torch.Tensor,      # (L, nkv, num_slots, d) — head-major
    v_cache: torch.Tensor,
    write_slots: torch.Tensor,  # (n,) int cache rows for the new tokens
    attn_fn: AttnFn,
    logits_rows: torch.Tensor,  # (r,) int rows of h to project to logits
    lora: dict | None = None,  # LoraManager.buffers
    lora_slots: torch.Tensor | int | None = None,  # (n,) or one slot
    return_hidden: bool = False,
    tp_group=None,  # parallel/group.TPGroup: params are its rank's shard
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the decoder over n tokens; returns (logits[r, V] f32, k_cache,
    v_cache). The new tokens' K/V are written into the caches in place
    before attention runs.

    Multi-LoRA: with `lora` (A (L, S, in, r), B (L, S, r, out), scaling
    (S,)) and `lora_slots`, scaling * (x @ A) @ B of each row's slot is
    added to wq/wk/wv/wo (slot 0 is all zeros: no adapter). A scalar slot
    is the uniform path, an (n,) vector the per-token one."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    h = embed_tokens(cfg, params, token_ids)

    sel = None
    if lora is not None:
        if lora_slots is None:
            raise ValueError("lora buffers given without lora_slots")
        if isinstance(lora_slots, int) or lora_slots.dim() == 0:
            # one slot for every row (a prefill chunk, a one-adapter
            # batch): plain (in, r) products
            sel = lora_slots
        else:
            sel = lora_row_weights(lora["scaling"], lora_slots)
            # each layer multiplies x by every slot's A at once: A as
            # (L, in, S*r), one permuted copy a target a forward
            lora = {k: v.permute(0, 2, 1, 3).flatten(2)
                    if k.endswith("_A") else v for k, v in lora.items()}

    h = decoder_stack(
        cfg, params, h, k_cache, v_cache, cos=cos, sin=sin,
        write_slots=write_slots, attn_fn=attn_fn, lora=lora, sel=sel,
        reduce=tp_group.all_reduce if tp_group is not None else None,
        first_expert=(sharding.expert_range(cfg, tp_group.rank,
                                            tp_group.world_size)[0]
                      if tp_group is not None and cfg.is_moe else 0))
    return (final_rows(cfg, params, h, logits_rows, return_hidden,
                       tp_group), k_cache, v_cache)


def embed_tokens(cfg: ModelConfig, params: dict,
                 token_ids: torch.Tensor) -> torch.Tensor:
    """(n, hidden) input rows of `token_ids`, in the params' dtype."""
    dtype = params["embed"].dtype
    h = params["embed"][token_ids.long()].to(dtype)
    if cfg.embed_scale != 1.0:
        # Gemma normalizer: hidden states enter the stack scaled by
        # sqrt(hidden_size)
        h = (h.float() * cfg.embed_scale).to(dtype)
    return h


def decoder_stack(cfg: ModelConfig, params: dict, h: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                  cos: torch.Tensor, sin: torch.Tensor,
                  write_slots: torch.Tensor, attn_fn: AttnFn,
                  lora: dict | None = None, sel=None,
                  reduce=None, first_expert: int = 0) -> torch.Tensor:
    """The cfg.num_layers layers of `params` over rows `h` (layer l of
    the params writes layer l of the caches, in place); returns the
    stack's output rows."""
    dtype = params["embed"].dtype
    cache_dtype = k_cache.dtype
    write_slots = write_slots.long()
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        lora_ctx = None
        if lora is not None:
            lora_ctx = ({k: (v if k == "scaling" else v[l])
                         for k, v in lora.items()}, sel)
        h, k_cache, v_cache = decoder_layer(
            cfg, h, k_cache, v_cache, lp, l,
            cos=cos, sin=sin, write_slots=write_slots, attn_fn=attn_fn,
            dtype=dtype, cache_dtype=cache_dtype, lora_ctx=lora_ctx,
            reduce=reduce, first_expert=first_expert,
        )
    return h


def final_rows(cfg: ModelConfig, params: dict, h: torch.Tensor,
               logits_rows: torch.Tensor, return_hidden: bool,
               tp_group=None) -> torch.Tensor:
    """The final norm of the stack's output `h`, rows `logits_rows`:
    their (r, V) f32 logits, or with `return_hidden` the (r, hidden) f32
    rows themselves."""
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps,
                 cfg.norm_weight_offset)
    h_sel = h[logits_rows.long()]  # (r, hidden)
    if return_hidden:
        return h_sel.float()
    return lm_logits(cfg, params, h_sel, tp_group)


def lm_logits(cfg: ModelConfig, params: dict, h: torch.Tensor,
              tp_group=None) -> torch.Tensor:
    """(r, V) f32 logits of final hidden rows `h`: the tied embedding or
    the lm_head; under tensor parallelism an untied lm_head is the
    rank's vocab slice, and the slices are gathered on every rank."""
    if cfg.tie_word_embeddings:
        return matmul_f32(h, params["embed"].t())
    logits = matmul_f32(h, params["lm_head"])
    if tp_group is not None:
        logits = tp_group.gather_last(logits)
    return logits


def lora_row_weights(scaling: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """(n, S) f32 per-row adapter weights of a per-token forward: row i
    holds scaling[slots[i]] at column slots[i] and exact zeros elsewhere,
    so a slot-0 (base) row adds exactly 0."""
    S = scaling.shape[0]
    onehot = slots.long()[:, None] == torch.arange(S, device=slots.device)
    return onehot.float() * scaling[slots.long()][:, None]


def lora_delta(x: torch.Tensor, lora_ctx: tuple,
               target: str) -> torch.Tensor:
    """scaling * (x @ A) @ B of one target for the rows of x, f32.

    One slot: x @ A[slot] then @ B[slot]. Per row (the JAX package
    gathers each row's A and B, (n, in, r) and (n, r, out) a target, which
    is hundreds of MB at a 2048-row chunk): x times every slot's A at
    once, A laid out (in, S*r) by forward(), then each row's r columns
    kept by its weights (n, S) and the (n, S*r) result times B viewed
    (S*r, out) — the other slots' columns are exact zeros there."""
    lz, sel = lora_ctx
    A, B = lz[f"{target}_A"], lz[f"{target}_B"]
    if isinstance(sel, int) or sel.dim() == 0:
        t = matmul_f32(x, A[sel])
        return (t @ B[sel].float()) * lz["scaling"][sel]
    n = x.shape[0]
    S, r, dout = B.shape
    t = matmul_f32(x, A).view(n, S, r) * sel[:, :, None]
    return t.view(n, S * r) @ B.reshape(S * r, dout).float()


def attention_scale(cfg: ModelConfig) -> float:
    return cfg.head_dim**-0.5
