"""Engine configuration.

The fields of ``production_stack_tpu/engine/config.py`` that the port
serves, plus ``device``, with the JAX package's defaults: unified ragged
rounds (a round holding prefill chunks and decode lanes runs as one
lane-typed forward on the ragged kernel), fused K-step decode up to
``num_scheduler_steps`` with device-side stop masks and adaptive K, the
prefill pipeline and the decode prefetch. The fields of features not
ported yet stay so that
asking for one fails loudly: ``__post_init__`` raises
NotImplementedError for each (see ``unported``), so no request ever
reaches a missing path.
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

    # serving
    served_model_name: str | None = None
    # require `Authorization: Bearer <key>` on /v1/* (vLLM --api-key)
    api_key: str | None = None

    # multi-LoRA: adapters hot-loaded into max_loras stacked slots of
    # rank up to max_lora_rank (engine/lora.py)
    enable_lora: bool = False
    max_loras: int = 4
    max_lora_rank: int = 16

    # -- not ported yet: any non-default value refuses at construction --
    async_decode: bool = False        # double-buffered decode
    precompile_serving: bool = False  # startup shape warmup
    num_speculative_tokens: int = 0   # ngram spec decode
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    context_parallel_size: int = 0
    long_prefill_threshold: int | None = None
    multihost: bool = False
    # KV offload tiers and disaggregated prefill/decode
    cpu_offload_bytes: int = 0
    disk_offload_dir: str | None = None
    remote_cache_url: str | None = None
    kv_controller_url: str | None = None
    kv_role: str | None = None
    kv_transfer_config: dict = field(default_factory=dict)

    def unported(self) -> list[str]:
        """Names of the requested features this port cannot serve yet."""
        checks = {
            # the composed-kernel ragged round (per-lane prefill and
            # decode kernels in one round) is not ported
            "ragged_dispatch with --no-ragged-kernel (pass "
            "--no-ragged-dispatch)": (
                self.ragged_dispatch and not self.ragged_kernel
            ),
            "async_decode": self.async_decode,
            "precompile_serving": self.precompile_serving,
            "num_speculative_tokens": self.num_speculative_tokens > 0,
            "tensor_parallel_size>1": self.tensor_parallel_size > 1,
            "pipeline_parallel_size>1": self.pipeline_parallel_size > 1,
            "context_parallel_size>1": self.context_parallel_size > 1,
            "long_prefill_threshold": self.long_prefill_threshold is not None,
            "multihost": self.multihost,
            "cpu_offload_bytes": self.cpu_offload_bytes > 0,
            "disk_offload_dir": self.disk_offload_dir is not None,
            "remote_cache_url": self.remote_cache_url is not None,
            "kv_controller_url": self.kv_controller_url is not None,
            "kv_role": self.kv_role is not None,
            "kv_transfer_config": any(
                (self.kv_transfer_config or {}).values()
            ),
        }
        return [name for name, on in checks.items() if on]

    def __post_init__(self) -> None:
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}"
            )
        if self.scheduling_policy not in ("fcfs", "priority"):
            raise ValueError(
                "scheduling_policy must be 'fcfs' or 'priority'"
            )
        if not 1 <= self.num_scheduler_steps <= self.block_size:
            raise ValueError(
                f"num_scheduler_steps={self.num_scheduler_steps} must be in "
                f"[1, block_size={self.block_size}]: idle lanes would "
                "overrun the trash block"
            )
        missing = self.unported()
        if self.model_config().is_moe:
            missing.append(f"MoE model {self.model}")
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: "
                + ", ".join(missing)
            )

    def pd_role(self) -> str | None:
        """Resolved PD role for discovery (None: not PD-configured —
        the only value this slice serves)."""
        return self.kv_role

    def model_config(self) -> ModelConfig:
        return get_model_config(self.model)

    def resolved_max_model_len(self) -> int:
        mc = self.model_config()
        if self.max_model_len is None:
            return mc.max_model_len
        return min(self.max_model_len, mc.max_model_len)
