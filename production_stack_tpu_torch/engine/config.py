"""Engine configuration.

The fields of ``production_stack_tpu/engine/config.py`` that this slice
of the port serves, plus ``device``. The slice serves split
prefill/decode rounds with single-step decode and no prefill pipeline.
The fields of features not ported yet stay so that asking for one fails
loudly: ``__post_init__`` raises NotImplementedError for each (see
``unported``), so no request ever reaches a missing path.
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

    # serving
    served_model_name: str | None = None
    # require `Authorization: Bearer <key>` on /v1/* (vLLM --api-key)
    api_key: str | None = None

    # -- not ported yet: any non-default value refuses at construction --
    num_scheduler_steps: int = 1      # fused K-step decode
    ragged_dispatch: bool = False     # unified prefill+decode rounds
    prefill_pipeline: bool = False    # fused h2d buffer + staged chunks
    async_decode: bool = False        # double-buffered decode
    precompile_serving: bool = False  # startup shape warmup
    num_speculative_tokens: int = 0   # ngram spec decode
    enable_lora: bool = False
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
            "ragged_dispatch": self.ragged_dispatch,
            "num_scheduler_steps>1": self.num_scheduler_steps != 1,
            "prefill_pipeline": self.prefill_pipeline,
            "async_decode": self.async_decode,
            "precompile_serving": self.precompile_serving,
            "num_speculative_tokens": self.num_speculative_tokens > 0,
            "enable_lora": self.enable_lora,
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
