"""Engine configuration.

The fields of ``production_stack_tpu/engine/config.py`` that the port
serves, plus ``device``, with the JAX package's defaults: unified ragged
rounds (a round holding prefill chunks and decode lanes runs as one
lane-typed forward on the ragged kernel), fused K-step decode up to
``num_scheduler_steps`` with device-side stop masks and adaptive K, the
prefill pipeline and the decode prefetch; the KV offload tiers, the
shared cache server, the KV controller and both roles of disaggregated
prefill/decode; OpenAI tool calling, the per-request timeline, and
n-gram speculative decoding (``num_speculative_tokens``, drafts from
prompt lookup), the attention implementation (``attention_impl``: the
kernels or the gather path), MoE models, the startup warm-up of every
serving program (``precompile_serving``) and the double-buffered decode
(``async_decode``), tensor and pipeline parallelism
(``tensor_parallel_size`` x ``pipeline_parallel_size`` ranks, all but
rank 0 spawned beside the engine, parallel/launch.py), the multi-host
job (``multihost``: parallel/multihost.py) and the long-prefill lane
(``long_prefill_threshold`` over a ring of ``context_parallel_size``
ranks, engine/long_prefill.py). A rank set serves every one of them
on one host; under pipeline parallelism and across hosts it refuses
(or turns off) what the JAX package's meshed and multi-host engines do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from production_stack_tpu_torch.models.config import (
    ModelConfig,
    get_model_config,
)


@dataclass
class EngineConfig:
    model: str = "pst-tiny-debug"
    tokenizer: str | None = None  # defaults to model path; "byte" for tests
    # optional Jinja chat-template override (string or file path) applied
    # over whatever the tokenizer ships
    chat_template: str | None = None
    # "cuda" (the card and its kernels; raises when there is none) or
    # "cpu" (the kernels' plain PyTorch versions, for tests)
    device: str = "cuda"
    dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    seed: int = 0

    # KV cache sizing: explicit block count, or a fraction of device
    # memory after the weights
    block_size: int = 32
    num_kv_blocks: int | None = None
    hbm_utilization: float = 0.9

    # scheduling
    # vLLM --scheduling-policy: "fcfs" (arrival order) or "priority"
    # (requests carry an integer `priority`; lower = served first,
    # preemption evicts the LOWEST-priority victim)
    scheduling_policy: str = "fcfs"
    max_model_len: int | None = None  # None -> model's max
    max_num_seqs: int = 8
    max_prefill_chunk: int = 512
    enable_chunked_prefill: bool = True
    # cross-sequence prefill packing: up to this many sequences' prompt
    # chunks run in ONE forward (prefill_batch)
    max_prefill_seqs: int = 8
    enable_prefix_caching: bool = True
    # max consecutive prefill dispatches while decodes wait (bounded
    # ITL); 0 = prefill always wins
    decode_interleave: int = 1
    # packed prefill and decode run the ragged paged-attention kernel
    # (decode lanes as one-row segments). False (--no-ragged-kernel)
    # composes the per-sequence prefill and decode kernels instead.
    ragged_kernel: bool = True
    # fused decode iterations per dispatch (vLLM --num-scheduler-steps):
    # sampling (penalties included) runs on the device and K tokens come
    # back in one fetch. At most block_size (idle and frozen lanes write
    # inside the trash block). With adaptive_decode_k this is the cap.
    num_scheduler_steps: int = 1
    # device-side stop masks in the fused loop: EOS, stop_token_ids and
    # the max_tokens countdown freeze a lane mid-round (pad token, KV
    # write to the trash slot, no state update); the host applies each
    # lane's valid count, and a round whose lanes are all done exits.
    # False (--no-device-stop) keeps the fixed-trip loop.
    device_stop: bool = True
    # the scheduler sizes each round's K from pow2 buckets up to
    # num_scheduler_steps (clamped while admission waits, bounded by the
    # batch's remaining budget); False keeps the fixed K
    adaptive_decode_k: bool = True
    # unified ragged rounds: a round with both prefill chunks and
    # decode-ready lanes runs as ONE lane-typed forward (one ragged
    # kernel launch a layer over [prefill rows | decode rows]) followed by
    # the decode loop. False (--no-ragged-dispatch) alternates split
    # prefill and decode rounds.
    ragged_dispatch: bool = True
    # speculative h2d prefetch: while a fused decode (or ragged) round
    # runs, the NEXT round's packed buffer for the same lanes (positions,
    # contexts, keys advanced by K) is built and its copy started on a
    # side stream; the next round runs chained on the device tokens when
    # the prediction holds, else the stage is a counted miss. Acts only
    # when num_scheduler_steps > 1. False: --no-prefetch-decode.
    prefetch_decode: bool = True
    # pipelined prefill: every prefill dispatch ships ONE packed buffer
    # (packed groups on the ragged-rows layout under the ragged kernel),
    # the next chunk's buffer is staged while a chunk computes, a cold
    # multi-chunk prompt chains its chunks in one engine step with one
    # fetch, and a staged chunk is a zero-cost admission for the
    # scheduler's interleave. False: --no-prefill-pipeline, the
    # per-array upload path.
    prefill_pipeline: bool = True
    # attention implementation, the JAX package's names: "pallas" = the
    # hand-written kernels (CUDA on the card, their plain versions on the
    # CPU), "xla" = the gather path (ops/attention.py: each lane's
    # context gathered by slot, plain masked softmax), "auto" = pallas,
    # except on the card for a head_dim the kernels are not built for
    # (ModelRunner resolves it at boot from the shapes alone)
    attention_impl: str = "auto"

    # serving
    served_model_name: str | None = None
    # OpenAI tool calling (engine/tools.py; vLLM flag names): auto tool
    # choice requires the explicit opt-in
    enable_auto_tool_choice: bool = False
    tool_call_parser: str = "hermes"
    # require `Authorization: Bearer <key>` on /v1/* (vLLM --api-key)
    api_key: str | None = None

    # multi-LoRA: adapters hot-loaded into max_loras stacked slots of
    # rank up to max_lora_rank (engine/lora.py)
    enable_lora: bool = False
    max_loras: int = 4
    max_lora_rank: int = 16

    # -- observability ------------------------------------------------
    # per-request lifecycle timeline (tracing/timeline.py): enqueue ->
    # admit -> prefill chunks -> first token -> sampled decode rounds ->
    # preempt/resume -> finish, served by /debug/requests and exported
    # as `engine_request` spans. Appends only, on the host; False makes
    # every hook one boolean check.
    request_timeline: bool = True
    # finished timelines kept for /debug/requests (bounded ring)
    timeline_ring_size: int = 256
    # engine-side span export: "none" | "log" | "memory" | "otlp"
    tracing_exporter: str = "none"

    # speculative decoding (vLLM's ngram prompt-lookup drafting): up to
    # this many draft tokens a lane a round, verified in one packed
    # forward. 0 = off.
    num_speculative_tokens: int = 0
    ngram_prompt_lookup_max: int = 3
    ngram_prompt_lookup_min: int = 1

    async_decode: bool = False        # double-buffered decode
    precompile_serving: bool = False  # startup shape warmup
    # a rank set of tensor_parallel_size x pipeline_parallel_size ranks,
    # one process each (rank 0 serves): Megatron-sharded within a stage,
    # layers split over the stages (parallel/pp_serving.py)
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    # the engine spans the processes (hosts) of a multi-host job
    # (parallel/multihost.initialize): process 0 serves, every other
    # process runs its ranks as followers
    multihost: bool = False

    # long-context serving (context-parallel ring prefill,
    # engine/long_prefill.py): a prompt whose UNCACHED remainder exceeds
    # this many tokens leaves the chunked-prefill lane and runs as
    # sequence-sharded ring chunks over context_parallel_size ranks
    # (parallel/long_context.py), its KV landing in the paged cache
    # through the KV import primitives. None = off; requires
    # context_parallel_size > 1.
    long_prefill_threshold: int | None = None
    # ring chunk length in tokens (rounded up to a multiple of the ring
    # size and the KV block size); the padded sequence is chunk x pow2
    long_prefill_chunk: int = 2048
    # ranks of the ring (0/1 = none): the cards past the serving one when
    # the host has them, else the serving card (or the CPU) repeated
    context_parallel_size: int = 0

    # disaggregated prefill/decode role: None (undeclared) | "prefill"
    # | "decode" | "both". Prefill/both engines serve KV chains over
    # kv_transfer_config["listen"] (kv/transfer.py); decode/both engines
    # pull through a PeerTier at kv_transfer_config["peer"] (comma list
    # of peer addresses — a prefill engine or a cache server, address-
    # interchangeably). The role is advertised on the /v1/models card so
    # the router's `pd` policy can split the fleet.
    kv_role: str | None = None
    kv_transfer_config: dict = field(default_factory=dict)

    # KV offload (LMCache-equivalent) tiers: host RAM, local disk, the
    # shared cache server (write-through) and the KV controller
    cpu_offload_bytes: int = 0
    disk_offload_dir: str | None = None
    remote_cache_url: str | None = None
    kv_controller_url: str | None = None
    kv_instance_id: str = "default-instance"
    # zero-stall KV tiering: exports are deferred (freed blocks pinned,
    # the gather enqueued after the step's dispatch, d2h and tier IO on
    # the offload worker) and restores are staged (tier fetch + h2d while
    # the request WAITS). True keeps the synchronous path — d2h export
    # inside scheduling, blocking tier reads and import on the step
    # loop — as the attribution control (--sync-kv-offload).
    sync_kv_offload: bool = False
    # staged-restore admission budget: how long an admission slot may be
    # held back while the request's tier fetch + h2d are in flight,
    # before falling back to recompute-from-scratch
    kv_restore_wait_s: float = 2.0

    def __post_init__(self) -> None:
        if self.long_prefill_threshold is not None:
            if self.long_prefill_threshold <= 0:
                raise ValueError(
                    "long_prefill_threshold must be positive (None "
                    "disables the long-prefill lane)"
                )
            if self.context_parallel_size <= 1:
                raise ValueError(
                    "long_prefill_threshold requires "
                    "context_parallel_size > 1 (the ring needs an sp "
                    "mesh axis)"
                )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}"
            )
        if self.scheduling_policy not in ("fcfs", "priority"):
            raise ValueError(
                "scheduling_policy must be 'fcfs' or 'priority'"
            )
        if self.kv_role not in (None, "prefill", "decode", "both"):
            raise ValueError(
                "kv_role must be one of None/'prefill'/'decode'/'both',"
                f" got {self.kv_role!r}"
            )
        if not 1 <= self.num_scheduler_steps <= self.block_size:
            raise ValueError(
                f"num_scheduler_steps={self.num_scheduler_steps} must be in "
                f"[1, block_size={self.block_size}]: idle lanes would "
                "overrun the trash block"
            )
        # n=0 would make the prompt-lookup window match every position
        # (arr[-0:] is the whole context), degenerating drafts to noise.
        if self.num_speculative_tokens:
            if not (
                1
                <= self.ngram_prompt_lookup_min
                <= self.ngram_prompt_lookup_max
            ):
                raise ValueError(
                    "require 1 <= ngram_prompt_lookup_min <= "
                    f"ngram_prompt_lookup_max, got min="
                    f"{self.ngram_prompt_lookup_min} max="
                    f"{self.ngram_prompt_lookup_max}"
                )
        if self.attention_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                "attention_impl must be auto|xla|pallas, got "
                f"{self.attention_impl!r}"
            )
        if self.tensor_parallel_size < 1:
            raise ValueError("tensor_parallel_size must be >= 1")
        if self.pipeline_parallel_size < 1:
            raise ValueError("pipeline_parallel_size must be >= 1")

    def pd_role(self) -> str | None:
        """Resolved PD role for discovery: the explicit kv_role, else
        inferred from the transfer config ('both' when an engine both
        serves and pulls), else None (not PD-configured)."""
        if self.kv_role in ("prefill", "decode", "both"):
            return self.kv_role
        cfg = self.kv_transfer_config or {}
        listen, peer = cfg.get("listen"), cfg.get("peer")
        if listen and peer:
            return "both"
        if listen:
            return "prefill"
        if peer:
            return "decode"
        return None

    def model_config(self) -> ModelConfig:
        return get_model_config(self.model)

    def resolved_max_model_len(self) -> int:
        mc = self.model_config()
        if self.max_model_len is None:
            return mc.max_model_len
        return min(self.max_model_len, mc.max_model_len)
