"""Pipeline parallelism: a GPipe-style microbatch pipeline over S stages,
each stage a device holding its layers and their KV cache.

Counterpart of ``production_stack_tpu/parallel/pipeline.py``. The JAX
package runs one SPMD program over a ``pp`` mesh axis: every device runs
the same step loop, ``lax.axis_index`` picks the stage's microbatch and
``ppermute`` hands the activations on. Here one process drives the S
stages (a list of devices, ``make_pp_stages``; a device may repeat:
stages that share a card), and the schedule is the same M + S - 1 step
loop:

- params keep models/llama.py's stacked-layer layout; stage s holds
  layers [s*L/S, (s+1)*L/S) on its device (``shard_params_pp``), with
  the embedding, final norm and lm_head beside them (the JAX package
  replicates those over "pp");
- each stage's KV cache (L/S, nkv, M*chunk+1, d) sits on its device,
  cache rows are absolute positions, and the last row is the bubble
  trash row;
- a prompt is split into M sequence-chunk microbatches (chunked-prefill
  semantics: chunk m attends causally to chunks 0..m, already in the
  stage's cache by construction), attended with
  ops/attention.context_attention_prefill;
- at step t stage s works on microbatch t - s; a step out of range
  computes on whatever the stage holds and writes only the trash row
  (bubble steps cost compute but never touch a real position);
- a stage's output moves to the next stage's device with
  ``Tensor.to(next_device, non_blocking=True)`` (ordered on the
  devices' streams), and the last stage's outputs go through the final
  norm and the lm_head there.

Scope: dense Llama-family decoders without a sliding window.
"""

from __future__ import annotations

import torch

from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.ops.attention import context_attention_prefill
from production_stack_tpu_torch.ops.layers import rope_cos_sin
from production_stack_tpu_torch.parallel.sharding import (
    shard_params,
    stage_layers,
)

PP_AXIS = "pp"


def make_pp_stages(pp_size: int, devices: list | None = None
                   ) -> list[torch.device]:
    """The stages' devices: the first pp_size entries of `devices`
    (default: every card of the host), with the JAX make_pp_mesh message
    when there are fewer."""
    devs = (list(devices) if devices is not None
            else [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    if pp_size > len(devs):
        raise ValueError(
            f"pipeline_parallel_size={pp_size} > available devices "
            f"{len(devs)}"
        )
    return [torch.device(d) for d in devs[:pp_size]]


def validate_pp(cfg: ModelConfig, pp_size: int) -> None:
    """The JAX package's validate_pp, message for message."""
    if cfg.num_layers % pp_size:
        raise ValueError(
            f"model {cfg.name}: num_layers {cfg.num_layers} not divisible "
            f"by pp={pp_size} (layers shard whole per stage)"
        )
    if cfg.is_moe:
        raise ValueError(
            "pipeline parallelism covers dense decoders; shard MoE models "
            "with expert parallelism instead (parallel/sharding.py)"
        )
    if cfg.sliding_window:
        raise ValueError(
            f"model {cfg.name}: sliding-window attention is served by "
            "the engine's XLA path; the pipeline prefiller attends full "
            "context"
        )


def shard_params_pp(params: dict, stages: list[torch.device],
                    cfg: ModelConfig) -> list[dict]:
    """Stage s's params on stages[s]: its layers of every stacked leaf,
    and the embedding, final norm and lm_head (no copy where a tensor is
    already on the stage's device)."""
    S = len(stages)
    return [
        _to(shard_params(params, cfg, 0, 1,
                         layers=stage_layers(cfg.num_layers, s, S)), dev)
        for s, dev in enumerate(stages)
    ]


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class PipelinedPrefiller:
    """Prefill one prompt through a pp-staged decoder.

    Returns per-token logits plus each stage's KV for the prompt (cache
    rows ARE absolute positions, the contract chunked prefill uses)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 stages: list[torch.device], microbatch_tokens: int = 64,
                 num_microbatches: int | None = None):
        validate_pp(cfg, len(stages))
        self.cfg = cfg
        self.stages = list(stages)
        S = len(self.stages)
        self.local = cfg.pp_local(S)
        self.microbatch_tokens = microbatch_tokens
        # M >= S keeps every stage busy in steady state; correctness
        # holds for any M >= 1
        self.num_microbatches = num_microbatches or max(2, S)
        self.params = shard_params_pp(params, self.stages, cfg)

    # stackcheck: not-hot — an offline prefill: one eager forward of the
    # stage's layers a schedule step
    def prefill(self, token_ids: list[int]):
        """-> (logits (T, V) f32 on the last stage's device, [k_cache]
        and [v_cache] a stage, T). A stage's caches are (L/S, nkv,
        M*chunk+1, d) on its device, in the params' dtype; the final row
        is the bubble trash row, valid rows are positions [0, T)."""
        cfg, local, stages = self.cfg, self.local, self.stages
        S, M = len(stages), self.num_microbatches
        T = len(token_ids)
        chunk = max(self.microbatch_tokens, -(-T // M))  # M chunks cover T
        t_pad = M * chunk
        dtype = self.params[0]["embed"].dtype
        shape = (local.num_layers, cfg.num_kv_heads, t_pad + 1,
                 cfg.head_dim)
        kcs = [torch.zeros(shape, dtype=dtype, device=d) for d in stages]
        vcs = [torch.zeros_like(k) for k in kcs]
        toks = torch.tensor(list(token_ids) + [0] * (t_pad - T),
                            dtype=torch.int32, device=stages[0])
        h0 = llama.embed_tokens(cfg, self.params[0], toks).view(
            M, chunk, cfg.hidden_size)
        outputs = [None] * M
        state = [torch.zeros((chunk, cfg.hidden_size), dtype=dtype,
                             device=d) for d in stages]
        scale = cfg.head_dim**-0.5
        for t in range(M + S - 1):
            outs = []
            for s, dev in enumerate(stages):
                mb = t - s  # the microbatch this stage works on now
                valid = 0 <= mb < M
                mb_c = min(max(mb, 0), M - 1)
                h_in = h0[mb_c] if s == 0 else state[s]
                pos = torch.arange(mb_c * chunk, (mb_c + 1) * chunk,
                                   dtype=torch.int32, device=dev)
                # bubble steps write into the trash row only
                write = (pos if valid else
                         torch.full((chunk,), t_pad, dtype=torch.int32,
                                    device=dev))
                total = (mb_c + 1) * chunk if valid else 0
                cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)

                def attn(q, l, kc, vc, pos=pos, total=total):
                    return context_attention_prefill(
                        q, kc[l].transpose(0, 1), vc[l].transpose(0, 1),
                        pos, total, scale)

                outs.append(llama.decoder_stack(
                    local, self.params[s], h_in, kcs[s], vcs[s], cos=cos,
                    sin=sin, write_slots=write, attn_fn=attn))
                if s == S - 1 and t - (S - 1) >= 0:
                    outputs[t - (S - 1)] = outs[-1]
            # hand each stage's activations to the next stage
            for s in range(S - 1):
                state[s + 1] = outs[s].to(stages[s + 1], non_blocking=True)
        last = self.params[-1]
        logits = llama.final_rows(
            cfg, last, torch.cat(outputs),
            torch.arange(T, device=stages[-1]), False)
        return logits, kcs, vcs, T
