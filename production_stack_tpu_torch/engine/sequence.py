"""Request/sequence state tracked by the scheduler."""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.utils.xxh64 import xxh64


class SequenceStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED_STOPPED = "stop"
    FINISHED_LENGTH = "length"
    FINISHED_ABORTED = "abort"

    @property
    def finished(self) -> bool:
        return self in (
            SequenceStatus.FINISHED_STOPPED,
            SequenceStatus.FINISHED_LENGTH,
            SequenceStatus.FINISHED_ABORTED,
        )


@dataclass
class RequestMetrics:
    arrival_time: float = field(default_factory=time.time)
    # first admission WAITING -> RUNNING (queue-wait = admitted - arrival)
    admitted_time: float | None = None
    first_scheduled_time: float | None = None
    first_token_time: float | None = None
    finished_time: float | None = None
    num_cached_prompt_tokens: int = 0
    num_preemptions: int = 0
    # wall seconds spent preempted (preempt -> re-admission), summed over
    # every preemption; feeds tpu:preemption_stall_seconds
    preempt_stall_s: float = 0.0
    last_preempt_time: float | None = None
    # seconds AsyncLLMEngine.generate waited for the engine's lock
    # before adding the request (None when added another way)
    lock_wait_s: float | None = None


class Sequence:
    """One request's sequence (n=1; parallel sampling fans out to n Sequences)."""

    _arrival_counter = 0

    def __init__(
        self,
        request_id: str,
        prompt_token_ids: list[int],
        sampling_params: SamplingParams,
        eos_token_id: int | None,
        arrival_time: float | None = None,
        lora_name: str | None = None,
        hash_seed: int | None = None,
        priority: int = 0,
    ):
        self.request_id = request_id
        self.prompt_token_ids = list(prompt_token_ids)
        # preemption-by-recompute folds generated tokens into the prompt;
        # orig_prompt_len keeps the user-visible prompt/output boundary
        self.orig_prompt_len = len(self.prompt_token_ids)
        self.output_token_ids: list[int] = []
        self.sampling_params = sampling_params
        self.eos_token_id = eos_token_id
        self.lora_name = lora_name
        # prefix-cache hash-chain seed: LoRA requests must never share KV
        # blocks with base-model (or other-adapter) requests, so the chain
        # starts from a per-adapter seed instead of 0 (the engine passes a
        # LoraManager-derived seed that also folds in the load generation)
        if hash_seed is not None:
            self.hash_seed = hash_seed
        elif lora_name is None:
            self.hash_seed = 0
        else:
            self.hash_seed = xxh64(b"lora:" + lora_name.encode())
        # vLLM --scheduling-policy priority role: LOWER value = served
        # first; ties break by arrival order (a per-process ordinal, not
        # wall time, so equal-timestamp arrivals stay FIFO)
        self.priority = priority
        Sequence._arrival_counter += 1
        self.arrival_ordinal = Sequence._arrival_counter
        self.status = SequenceStatus.WAITING
        self.metrics = RequestMetrics()
        if arrival_time is not None:
            self.metrics.arrival_time = arrival_time

        # paged-KV state (owned by the block manager)
        self.block_table: list[int] = []
        # tokens whose K/V are already in the cache (prefix-cache hits count)
        self.num_computed_tokens = 0
        # long-prefill lane (engine/long_prefill.py): True while the
        # context-parallel ring computes this prompt — the scheduler's
        # chunked-prefill planners skip the sequence and the engine
        # drives its ring chunks + KV landing outside schedule()
        self.long_prefill_active = False

        # incremental prefix-cache hashing state (chain hashes of the
        # sequence's full blocks registered so far)
        self.block_hashes: list[int] = []

        # detokenization state
        self.output_text = ""
        self._stopped_by: str | None = None

    # -- lengths ----------------------------------------------------------
    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def all_token_ids(self) -> list[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def generated_token_ids(self) -> list[int]:
        """All tokens generated for this request, including any folded into
        the prompt by preemption-recompute."""
        return self.prompt_token_ids[self.orig_prompt_len :] + (
            self.output_token_ids
        )

    @property
    def prefill_done(self) -> bool:
        """All prompt tokens have K/V in cache and first logits were produced."""
        return self.num_computed_tokens >= self.num_prompt_tokens

    @property
    def num_uncomputed_prompt_tokens(self) -> int:
        return max(0, self.num_prompt_tokens - self.num_computed_tokens)

    @property
    def finished(self) -> bool:
        return self.status.finished

    @property
    def finish_reason(self) -> str | None:
        if not self.status.finished:
            return None
        return self.status.value

    def append_token(self, token_id: int) -> None:
        """Append a sampled token. Its K/V is computed by the decode step
        that later consumes it, so num_computed_tokens is NOT advanced here
        (invariant during decode: num_computed_tokens == num_tokens - 1)."""
        self.output_token_ids.append(token_id)

    def check_stop(self, new_text: str | None = None) -> None:
        """Update status if a stop condition fired on the latest token."""
        sp = self.sampling_params
        n_generated = len(self.generated_token_ids)
        if n_generated >= sp.max_tokens:
            self.status = SequenceStatus.FINISHED_LENGTH
            return
        if n_generated < sp.min_tokens:
            return
        last = self.output_token_ids[-1]
        if not sp.ignore_eos and self.eos_token_id is not None:
            if last == self.eos_token_id:
                self.status = SequenceStatus.FINISHED_STOPPED
                return
        if last in sp.stop_token_ids:
            self.status = SequenceStatus.FINISHED_STOPPED
            return
        if sp.stop and new_text is not None:
            for s in sp.stop:
                idx = self.output_text.find(s)
                if idx != -1:
                    # vLLM include_stop_str_in_output: keep the matched
                    # stop string (truncate AFTER it, not before)
                    end = idx + (len(s) if sp.include_stop_str_in_output
                                 else 0)
                    self.output_text = self.output_text[:end]
                    self._stopped_by = s
                    self.status = SequenceStatus.FINISHED_STOPPED
                    return

    def reset_for_recompute(self) -> None:
        """Preemption by recomputation: drop cache state, keep tokens.

        Generated tokens are folded into the prompt so the whole sequence is
        re-prefilled on resumption (same trick vLLM uses for recompute).
        """
        self.prompt_token_ids = self.all_token_ids
        self.output_token_ids = []
        # keep output_text; new tokens will continue appending
        self.num_computed_tokens = 0
        self.block_table = []
        self.block_hashes = []
        self.long_prefill_active = False
        self.status = SequenceStatus.PREEMPTED
        self.metrics.num_preemptions += 1
        self.metrics.last_preempt_time = time.time()
