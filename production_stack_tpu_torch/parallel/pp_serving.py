"""Pipeline parallelism as a serving config: a drop-in forward for the
runner with layers (and their KV) split over the stages of a rank set.

Counterpart of ``production_stack_tpu/parallel/pp_serving.py``. The JAX
package runs one SPMD program per engine step over a ("pp", "tp") mesh:
at phase t every stage runs its layer slice, the stages not holding real
activations write their garbage K/V into trash slot 0, activations move
forward with ``ppermute`` and the last stage's output is ``psum``med to
every device. Here a stage is a set of processes (parallel/group.py's
rank layout: rank r is stage r // tp), so the phase loop keeps its
shape and drops the garbage compute:

- every rank embeds the step's tokens (the embedding sits on every
  stage);
- at phase t only stage t runs its L/S layers, on its own KV cache of
  L/S layers with stage-local layer indices (the JAX ``attn_fn``
  contract), its tp ranks reducing over their stage's ``tp`` group; the
  other stages run nothing and write nothing (slot 0 keeps what it had);
- the phase ends with a ``broadcast`` of stage t's output rows over the
  rank's ``pp`` group, in place of the ``ppermute`` (gloo's point-to-
  point ops read host memory only; a broadcast is a collective both
  backends take on CUDA tensors, and it moves the bytes unchanged);
- after phase S-1 every rank holds the last stage's output (the JAX
  ``psum`` of zeros and that output), runs the final norm and the
  lm_head (the vocab gathered over its tp group) and samples as every
  TP rank does.

One forward keeps 1/S of the stages busy, as in the JAX package:
pipelined prefill (parallel/pipeline.py) and continuous batching fill
the bubble; what PP buys is models whose weights and KV exceed one card.

Scope (validate_pp_serving, at engine boot): dense decoders (MoE: tensor
parallelism), no LoRA; the runner serves PP on the gather path, as the
JAX runner forces its XLA path under pp.
"""

from __future__ import annotations

import torch

from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.ops.layers import rope_cos_sin

PP_AXIS = "pp"


def validate_pp_serving(cfg: ModelConfig, pp: int, config) -> None:
    """Serving-config validation (engine boot, loud and early): the JAX
    package's, message for message."""
    if cfg.num_layers % pp:
        raise ValueError(
            f"model {cfg.name}: num_layers {cfg.num_layers} not "
            f"divisible by pipeline_parallel_size={pp}"
        )
    if cfg.is_moe:
        raise ValueError(
            "pipeline parallelism covers dense decoders; shard MoE "
            "models with expert parallelism (tensor_parallel_size)"
        )
    if config.enable_lora:
        raise ValueError(
            "--enable-lora is not supported with pipeline parallelism "
            "yet (adapter buffers are not stage-sharded)"
        )


def forward_pp(
    cfg: ModelConfig,
    params: dict,
    token_ids: torch.Tensor,    # (n,) int
    positions: torch.Tensor,    # (n,) int
    k_cache: torch.Tensor,      # (L/S, nkv/tp, slots, d): the stage's
    v_cache: torch.Tensor,
    write_slots: torch.Tensor,  # (n,) int
    attn_fn,
    logits_rows: torch.Tensor,  # (r,) int
    lora: dict | None = None,
    lora_slots: torch.Tensor | int | None = None,
    return_hidden: bool = False,
    *,
    group,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as models.llama.forward, staged over the set's
    stages. `cfg` is the rank's local view (L/S layers, its tp heads),
    `params` its stage's layers and tp shard, `group` its
    parallel/group.TPGroup. `attn_fn(q, l, kc, vc)` receives the
    stage-local cache with local layer indices. Every rank returns the
    same logits (or hidden rows) and its own caches."""
    if lora is not None:
        raise NotImplementedError("LoRA under pipeline parallelism")
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    h = llama.embed_tokens(cfg, params, token_ids)
    reduce = group.tp.all_reduce if group.tp is not None else None
    for t in range(group.pp_size):  # phase t: stage t holds the rows
        if group.stage == t:
            h = llama.decoder_stack(
                cfg, params, h, k_cache, v_cache, cos=cos, sin=sin,
                write_slots=write_slots, attn_fn=attn_fn,
                reduce=reduce).contiguous()
        group.pp.broadcast(h, src=t)
    return (llama.final_rows(cfg, params, h, logits_rows, return_hidden,
                             group.tp), k_cache, v_cache)
