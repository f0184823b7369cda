"""Engine step outputs returned to the serving layer."""

from __future__ import annotations

from dataclasses import dataclass, field

from production_stack_tpu_torch.engine.sequence import RequestMetrics


@dataclass
class RequestOutput:
    request_id: str
    prompt_token_ids: list[int]
    token_ids: list[int]  # all output tokens so far
    new_token_ids: list[int]  # tokens produced this step
    text: str  # full output text so far
    delta_text: str  # text produced this step
    finished: bool
    finish_reason: str | None
    metrics: RequestMetrics
    num_cached_tokens: int = 0
    # per-token logprob entries (only when SamplingParams.logprobs set):
    # {"token_id", "logprob", "top_logprobs": [{"token_id", "logprob"}]}
    logprobs: list[dict] | None = None  # all tokens so far
    new_logprobs: list[dict] | None = None  # this step (streaming)
    # vLLM prompt_logprobs role: one entry per prompt position (None
    # first), populated on the FINAL output only
    prompt_logprobs: list[dict | None] | None = None


@dataclass
class EngineStatsSnapshot:
    """Feeds the Prometheus /metrics contract the router scrapes
    (reference: src/vllm_router/stats/engine_stats.py:63-76)."""

    num_running: int = 0
    num_waiting: int = 0
    kv_usage: float = 0.0  # -> vllm:gpu_cache_usage_perc
    prefix_cache_queries: int = 0  # -> vllm:gpu_prefix_cache_queries_total
    prefix_cache_hits: int = 0  # -> vllm:gpu_prefix_cache_hits_total
    prompt_tokens_total: int = 0
    generation_tokens_total: int = 0
    num_preemptions_total: int = 0
    requests_finished_total: int = 0
    # speculative decoding acceptance (vllm:spec_decode_* role)
    spec_draft_tokens_total: int = 0
    spec_accepted_tokens_total: int = 0
    # pipelined-prefill attribution: wall seconds per phase of the
    # prefill dispatch path (prep = host array build, h2d = upload,
    # dispatch = jitted-call enqueue, fetch = device->host token reads)
    # plus staging effectiveness — tpu:prefill_* in /metrics and the
    # bench.py prefill_phase_s detail slot
    prefill_prep_seconds_total: float = 0.0
    prefill_h2d_seconds_total: float = 0.0
    prefill_dispatch_seconds_total: float = 0.0
    prefill_fetch_seconds_total: float = 0.0
    prefill_staged_hits_total: int = 0
    prefill_staged_misses_total: int = 0
    prefill_chained_chunks_total: int = 0
    # long-prefill lane (context-parallel ring prefill, engine/
    # long_prefill.py): requests served by the ring, ring chunks
    # dispatched, ring failures that fell back to chunked prefill, and
    # the per-phase TTFT attribution — ring compute, device->host KV
    # materialization, paged-cache landing, and tier-export overflow
    # seconds that ran while long jobs were in flight —
    # tpu:prefill_ring/d2h/land/overflow_* in /metrics and the bench
    # `long_prefill` detail slot
    long_prefill_requests_total: int = 0
    long_prefill_chunks_total: int = 0
    long_prefill_fallbacks_total: int = 0
    long_prefill_ring_seconds_total: float = 0.0
    long_prefill_d2h_seconds_total: float = 0.0
    long_prefill_land_seconds_total: float = 0.0
    long_prefill_overflow_seconds_total: float = 0.0
    # elastic fused decode: rounds dispatched, sampled-then-discarded
    # overshoot tokens (~0 with device stops, except host-resolved stop
    # strings), and whole-round device early exits — tpu:decode_* in
    # /metrics and the bench `elastic_decode` detail slot
    decode_rounds_total: int = 0
    decode_overshoot_tokens_total: int = 0
    decode_early_exit_rounds_total: int = 0
    # unified ragged dispatch: fused lane-typed rounds, rounds a mixed
    # plan ran split (exotic lanes), and per-side lane totals —
    # tpu:ragged_* in /metrics and the bench `ragged_dispatch` slot
    ragged_rounds_total: int = 0
    ragged_split_rounds_total: int = 0
    ragged_prefill_lanes_total: int = 0
    ragged_decode_lanes_total: int = 0
    # compile-count observability: program-variant builds (jit cache
    # misses on the runner's step builders) since boot, total and per
    # builder kind — tpu:compile_events_total in /metrics and the
    # bench `compiles` detail slot. The chip-window cold-start tax
    # (and the single-kernel variant-space shrink) read directly off
    # this instead of being inferred from compile logs.
    compile_events_total: int = 0
    # kind -> count, e.g. {"decode_multi": 3, "ragged_rows": 2}
    compile_events: dict = field(default_factory=dict)
    # zero-stall KV tiering attribution: deferred-export batches (wall
    # seconds measured ON THE OFFLOAD WORKER — overlapped activity, not
    # step-loop stalls) and staged restores (enqueue -> landed), plus
    # per-tier hit/miss/byte counters — tpu:kv_* in /metrics and the
    # bench `kv_offload` detail slot
    kv_export_seconds_total: float = 0.0
    kv_export_blocks_total: int = 0
    kv_export_bytes_total: int = 0
    kv_restore_seconds_total: float = 0.0
    kv_restore_blocks_total: int = 0
    kv_restore_bytes_total: int = 0
    kv_restore_fallbacks_total: int = 0
    # deferred exports forced synchronous by the device-buffer backlog
    # cap (slow tier backpressure — see LLMEngine.KV_EXPORT_BACKLOG_CAP)
    kv_export_sync_fallbacks_total: int = 0
    # tier name -> {hits, misses, read_bytes, write_bytes}
    kv_tier_counters: dict = field(default_factory=dict)
    # disaggregated-prefill peer pulls (PeerTier): blocks served by /
    # missing from the PD peer, bytes pulled over the transfer link,
    # and failed pulls (dead peer, corrupt frame) — tpu:kv_peer_* in
    # /metrics and the bench `pd_transfer` detail slot
    kv_peer_hits_total: int = 0
    kv_peer_misses_total: int = 0
    kv_peer_read_bytes_total: int = 0
    kv_peer_fallbacks_total: int = 0
    # shared cache server (RemoteTier): blocks served by / missing from
    # the cluster-wide cache, bytes over the wire in each direction,
    # write-behind put_batch frames shipped, and failed flushes/pulls
    # (dead server) — tpu:kv_remote_* in /metrics and the bench
    # `kv_remote` detail slot
    kv_remote_hits_total: int = 0
    kv_remote_misses_total: int = 0
    kv_remote_read_bytes_total: int = 0
    kv_remote_write_bytes_total: int = 0
    kv_remote_flushes_total: int = 0
    kv_remote_fallbacks_total: int = 0

    @property
    def prefix_cache_hit_rate(self) -> float:
        if self.prefix_cache_queries == 0:
            return 0.0
        return self.prefix_cache_hits / self.prefix_cache_queries
