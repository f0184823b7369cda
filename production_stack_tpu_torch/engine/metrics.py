"""Engine Prometheus metrics, written by hand with the standard library.

Counterpart of ``production_stack_tpu/engine/metrics.py`` for the
families the port serves. Names, types, the ``model_name`` label and the
histogram buckets are the JAX module's, and the text is what
prometheus_client writes for them (a counter ``x`` is written as
``x_total``, its HELP and TYPE lines included; a histogram as
``_bucket`` / ``_count`` / ``_sum``; the ``_created`` samples are left
out), so the
router (``router/stats/engine_stats.py``) scrapes a port engine exactly
as it scrapes a JAX one: queue depth, KV usage, the prefix-cache hit
rate and the scheduling-delay histogram behind admission's load score.
The machine with the card has no prometheus_client, hence no import of
it here.

Snapshot families are rendered from ``LLMEngine.stats()`` at each
scrape; request histograms are fed once per finished request by the
server (``observe_request``, the JAX server's ``_observe_finish``), and
``tpu:ragged_lane_mix`` from the engine's drained lane-mix observations
(``observe_ragged``). ``tpu:compile_events_total`` carries the runner's
program-variant builds by kind (its JAX name already ends in ``_total``,
which prometheus_client does not double).
"""

from __future__ import annotations

import time

from production_stack_tpu_torch.engine.outputs import EngineStatsSnapshot

_LATENCY_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.5, 3.0, 6.0, 12.0, 30.0, 60.0,
)
_TPOT_BUCKETS = (0.002, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64,
                 1.28)
_DECODE_K_BUCKETS = (1, 2, 4, 8, 16, 32)
_RAGGED_LANE_BUCKETS = (1, 2, 4, 8, 16)

# (name, help, snapshot field)
_GAUGES = (
    ("vllm:num_requests_running", "Requests currently being decoded",
     "num_running"),
    ("vllm:num_requests_waiting", "Requests waiting to be scheduled",
     "num_waiting"),
    ("vllm:gpu_cache_usage_perc", "KV-cache usage (1 = full)", "kv_usage"),
    # the JAX module's device-native alias (dashboards use either)
    ("tpu:hbm_kv_cache_usage_perc", "KV-cache usage in TPU HBM",
     "kv_usage"),
    ("vllm:gpu_prefix_cache_hit_rate",
     "Prefix-cache hit rate over engine lifetime", "prefix_cache_hit_rate"),
    ("vllm:gpu_prefix_cache_hits_total", "Prefix-cache token hits (total)",
     "prefix_cache_hits"),
    ("vllm:gpu_prefix_cache_queries_total",
     "Prefix-cache token queries (total)", "prefix_cache_queries"),
)
_COUNTERS = (
    ("vllm:prompt_tokens", "Prefill tokens processed",
     "prompt_tokens_total"),
    ("vllm:generation_tokens", "Tokens generated",
     "generation_tokens_total"),
    ("vllm:num_preemptions", "Sequence preemptions",
     "num_preemptions_total"),
    ("vllm:spec_decode_num_draft_tokens", "Speculative draft tokens proposed",
     "spec_draft_tokens_total"),
    ("vllm:spec_decode_num_accepted_tokens",
     "Speculative draft tokens accepted", "spec_accepted_tokens_total"),
    ("tpu:prefill_prep_seconds", "Prefill host-prep wall time",
     "prefill_prep_seconds_total"),
    ("tpu:prefill_h2d_seconds", "Prefill host->device upload wall time",
     "prefill_h2d_seconds_total"),
    ("tpu:prefill_dispatch_seconds", "Prefill dispatch-enqueue wall time",
     "prefill_dispatch_seconds_total"),
    ("tpu:prefill_fetch_seconds", "Prefill device->host fetch wall time",
     "prefill_fetch_seconds_total"),
    ("tpu:prefill_staged_hits",
     "Prefill dispatches served from a pre-uploaded staged buffer",
     "prefill_staged_hits_total"),
    ("tpu:prefill_staged_misses",
     "Staged prefill buffers invalidated before dispatch",
     "prefill_staged_misses_total"),
    ("tpu:prefill_chained_chunks",
     "Prefill chunks dispatched via cold-prompt chaining (no host "
     "round-trip between chunks)", "prefill_chained_chunks_total"),
    # the long-prefill lane (context-parallel ring prefill): per-phase
    # attribution of the prompts the ring serves
    ("tpu:long_prefill_requests",
     "Prompts served via the context-parallel ring prefill lane",
     "long_prefill_requests_total"),
    ("tpu:long_prefill_chunks", "Ring prefill chunk dispatches",
     "long_prefill_chunks_total"),
    ("tpu:long_prefill_fallbacks",
     "Long prefills that failed back to chunked prefill",
     "long_prefill_fallbacks_total"),
    ("tpu:prefill_ring_seconds",
     "Long-prefill ring compute wall time (job start -> ring drained; "
     "overlaps other users' decode rounds)",
     "long_prefill_ring_seconds_total"),
    ("tpu:prefill_ring_d2h_seconds",
     "Long-prefill device->host KV materialization wall time (on the "
     "long-prefill worker)", "long_prefill_d2h_seconds_total"),
    ("tpu:prefill_kv_land_seconds",
     "Long-prefill paged-cache landing wall time (first parked batch -> "
     "last donated import enqueued)", "long_prefill_land_seconds_total"),
    ("tpu:prefill_overflow_export_seconds",
     "Tier-export seconds attributed to in-flight long prefills (HBM "
     "headroom the landed chain displaced)",
     "long_prefill_overflow_seconds_total"),
    ("tpu:decode_rounds", "Decode rounds dispatched", "decode_rounds_total"),
    ("tpu:decode_overshoot_tokens",
     "Sampled decode slots discarded by the host past a stop condition",
     "decode_overshoot_tokens_total"),
    ("tpu:decode_early_exit_rounds",
     "Fused decode rounds whose device loop exited before the trip count "
     "because every lane had finished", "decode_early_exit_rounds_total"),
    ("tpu:ragged_rounds",
     "Lane-typed ragged rounds dispatched fused (prefill chunks + decode "
     "steps in one device program)", "ragged_rounds_total"),
    ("tpu:ragged_split_rounds",
     "Planned mixed rounds executed as split prefill+decode dispatches",
     "ragged_split_rounds_total"),
    ("tpu:kv_export_blocks", "KV blocks exported to the offload tiers",
     "kv_export_blocks_total"),
    ("tpu:kv_restore_blocks",
     "KV blocks restored from the offload tiers into HBM",
     "kv_restore_blocks_total"),
    ("tpu:kv_restore_fallbacks",
     "Staged restores that fell back to recompute (broken chain, timeout, "
     "or full HBM)", "kv_restore_fallbacks_total"),
    ("tpu:kv_export_sync_fallbacks",
     "Deferred exports forced synchronous by the device-buffer backlog "
     "cap (tier IO slower than eviction churn)",
     "kv_export_sync_fallbacks_total"),
    ("tpu:kv_peer_hits",
     "KV blocks pulled from the disaggregated-prefill peer",
     "kv_peer_hits_total"),
    ("tpu:kv_peer_misses",
     "KV blocks requested from the PD peer but not served (chain evicted "
     "or never prefilled there)", "kv_peer_misses_total"),
    ("tpu:kv_peer_read_bytes",
     "Bytes pulled over the inter-engine KV transfer link",
     "kv_peer_read_bytes_total"),
    ("tpu:kv_peer_fallbacks",
     "Failed PD peer pulls (dead peer / mid-frame death / corrupt "
     "payload) that degraded to local recompute", "kv_peer_fallbacks_total"),
    ("tpu:kv_remote_hits", "KV blocks served by the shared cache server",
     "kv_remote_hits_total"),
    ("tpu:kv_remote_misses",
     "KV blocks requested from the shared cache server but not held there "
     "(cold chain or evicted/expired)", "kv_remote_misses_total"),
    ("tpu:kv_remote_read_bytes", "Bytes pulled from the shared cache server",
     "kv_remote_read_bytes_total"),
    ("tpu:kv_remote_write_bytes",
     "Bytes shipped to the shared cache server (write-behind batched puts)",
     "kv_remote_write_bytes_total"),
    ("tpu:kv_remote_flushes",
     "Write-behind put_batch frames shipped to the shared cache",
     "kv_remote_flushes_total"),
    ("tpu:kv_remote_fallbacks",
     "Failed shared-cache flushes/pulls (dead server / corrupt frame) that "
     "degraded without stalling the engine", "kv_remote_fallbacks_total"),
)
# (name, help, kv_tier_counters key): one sample per tier
_TIER_COUNTERS = (
    ("tpu:kv_tier_hits", "KV tier read hits", "hits"),
    ("tpu:kv_tier_misses",
     "KV tier read misses (consulted tier did not hold the block)",
     "misses"),
    ("tpu:kv_tier_read_bytes", "Bytes served from a KV tier", "read_bytes"),
    ("tpu:kv_tier_write_bytes", "Bytes admitted into a KV tier",
     "write_bytes"),
)
_COMPILE_HELP = (
    "Program-variant builds (program-cache misses in the model runner) "
    "— the cold-start compile tax, labeled by kind (decode, "
    "decode_multi, ...)")
_KV_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
               1.0, 2.5, 5.0)


def _num(v: float) -> str:
    """A sample value as prometheus_client prints it."""
    v = float(v)
    if v == float("inf"):
        return "+Inf"
    return repr(v)


class Histogram:
    """Cumulative buckets, count and sum of one label set."""

    def __init__(self, buckets):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float, n: int = 1) -> None:
        """`n` observations of `value`."""
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.counts[i] += n
        self.count += n
        self.sum += value * n

    def lines(self, name: str, label: str) -> list[str]:
        out = [f'{name}_bucket{{{label},le="{_num(le)}"}} {_num(n)}'
               for le, n in zip(self.buckets, self.counts)]
        return out + [
            f'{name}_bucket{{{label},le="+Inf"}} {_num(self.count)}',
            f"{name}_count{{{label}}} {_num(self.count)}",
            f"{name}_sum{{{label}}} {_num(self.sum)}",
        ]


class EngineMetrics:
    def __init__(self, model_name: str):
        self.model_name = model_name
        self._label = f'model_name="{model_name}"'
        # request-lifecycle histograms, fed at each finish
        self.ttft = Histogram(_LATENCY_BUCKETS)
        self.tpot = Histogram(_TPOT_BUCKETS)
        self.e2e_latency = Histogram(_LATENCY_BUCKETS)
        self.queue_time = Histogram(_LATENCY_BUCKETS)
        self.sched_delay = Histogram(_LATENCY_BUCKETS)
        self.preempt_stall = Histogram(_LATENCY_BUCKETS)
        self._request_hists = (
            ("vllm:time_to_first_token_seconds", "TTFT", self.ttft),
            ("vllm:time_per_output_token_seconds", "Inter-token latency",
             self.tpot),
            ("vllm:e2e_request_latency_seconds",
             "End-to-end request latency", self.e2e_latency),
            ("tpu:request_queue_seconds",
             "Enqueue -> scheduler admission (waiting-queue wait)",
             self.queue_time),
            ("tpu:scheduling_delay_seconds",
             "Scheduler admission -> first prefill dispatch",
             self.sched_delay),
            ("tpu:preemption_stall_seconds",
             "Wall time spent preempted (preempt -> re-admission), summed "
             "per request; observed only for preempted requests",
             self.preempt_stall),
        )
        # finish reason -> finished requests
        self.request_success: dict[str, int] = {}
        # KV tiering: deferred-export batch wall time (on the offload
        # worker) and staged-restore enqueue -> landed time
        self.kv_export_s = Histogram(_KV_BUCKETS)
        self.kv_restore_s = Histogram(_KV_BUCKETS)
        self._kv_hists = (
            ("tpu:kv_export_seconds",
             "Deferred KV export batch wall time (d2h materialization + "
             "tier store, on the offload worker)", self.kv_export_s),
            ("tpu:kv_restore_seconds",
             "Staged KV restore wall time (enqueue -> blocks landed in "
             "HBM; overlaps the request's queue wait)", self.kv_restore_s),
        )
        # prefill lanes of each fused ragged round (one observation a
        # mixed prefill+decode dispatch)
        self.ragged_lane_mix = Histogram(_RAGGED_LANE_BUCKETS)
        self._ragged_hists = (
            ("tpu:ragged_lane_mix",
             "Prefill-chunk lanes fused into a ragged round (each "
             "observation is one mixed prefill+decode dispatch)",
             self.ragged_lane_mix),
        )

    def observe_kv(self, export_seconds: list[float],
                   restore_seconds: list[float]) -> None:
        """Feed drained engine observations (LLMEngine.
        drain_kv_observations) into the tpu:kv_*_seconds histograms."""
        for s in export_seconds:
            self.kv_export_s.observe(max(0.0, s))
        for s in restore_seconds:
            self.kv_restore_s.observe(max(0.0, s))

    def observe_ragged(self, lane_counts: list[int]) -> None:
        """Feed drained ragged lane-mix observations (LLMEngine.
        drain_ragged_observations: prefill lanes per fused round) into
        the tpu:ragged_lane_mix histogram."""
        for n in lane_counts:
            self.ragged_lane_mix.observe(n)

    def observe_request(
        self,
        finish_reason: str,
        ttft_s: float | None,
        e2e_s: float | None,
        n_output_tokens: int,
        queue_s: float | None = None,
        sched_delay_s: float | None = None,
        preempt_stall_s: float | None = None,
    ) -> None:
        """One finished request (the JAX module's observe_request)."""
        self.request_success[finish_reason] = (
            self.request_success.get(finish_reason, 0) + 1)
        if ttft_s is not None:
            self.ttft.observe(ttft_s)
        if e2e_s is not None:
            self.e2e_latency.observe(e2e_s)
            if ttft_s is not None and n_output_tokens > 1:
                self.tpot.observe(
                    (e2e_s - ttft_s) / (n_output_tokens - 1))
        if queue_s is not None:
            self.queue_time.observe(max(0.0, queue_s))
        if sched_delay_s is not None:
            self.sched_delay.observe(max(0.0, sched_delay_s))
        if preempt_stall_s is not None:
            self.preempt_stall.observe(max(0.0, preempt_stall_s))

    def observe_finish(self, out, arrival: float) -> None:
        """observe_request from a finished RequestOutput, the time its
        HTTP request arrived and its RequestMetrics stamps (the JAX
        server's _observe_finish)."""
        m = out.metrics
        self.observe_request(
            out.finish_reason or "stop",
            (m.first_token_time - arrival
             if m.first_token_time is not None else None),
            time.time() - arrival, len(out.token_ids),
            queue_s=(m.admitted_time - m.arrival_time
                     if m.admitted_time is not None else None),
            sched_delay_s=(
                m.first_scheduled_time - m.admitted_time
                if (m.first_scheduled_time is not None
                    and m.admitted_time is not None) else None),
            preempt_stall_s=(m.preempt_stall_s
                             if m.num_preemptions > 0 else None),
        )

    def render(self, s: EngineStatsSnapshot) -> str:
        """The text exposition of every family, from one snapshot."""
        lab = self._label
        lines: list[str] = []
        for name, help_, attr in _GAUGES:
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} gauge",
                      f"{name}{{{lab}}} {_num(getattr(s, attr))}"]
        for name, help_, attr in _COUNTERS:
            lines += [f"# HELP {name}_total {help_}",
                      f"# TYPE {name}_total counter",
                      f"{name}_total{{{lab}}} {_num(getattr(s, attr))}"]
        name = "vllm:request_success_total"
        lines += [f"# HELP {name} Finished requests",
                  f"# TYPE {name} counter"]
        for reason, n in sorted(self.request_success.items()):
            lines.append(f'{name}{{{lab},finished_reason="{reason}"}} '
                         f"{_num(n)}")
        # the chosen-K histogram from the snapshot's per-K round counts
        name = "tpu:decode_k"
        k_hist = Histogram(_DECODE_K_BUCKETS)
        for k, n in s.decode_k_hist.items():
            k_hist.observe(k, n)
        lines += [f"# HELP {name} Fused decode iterations dispatched per "
                  "round (adaptive K buckets; the cap with "
                  "--no-adaptive-decode-k)", f"# TYPE {name} histogram"]
        lines += k_hist.lines(name, lab)
        for name, help_, hist in (self._request_hists + self._kv_hists
                                  + self._ragged_hists):
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
            lines += hist.lines(name, lab)
        # named with its _total in the JAX module: prometheus_client
        # writes it once, as here
        name = "tpu:compile_events_total"
        lines += [f"# HELP {name} {_COMPILE_HELP}",
                  f"# TYPE {name} counter"]
        lines += [f'{name}{{{lab},kind="{kind}"}} {_num(n)}'
                  for kind, n in sorted((s.compile_events or {}).items())]
        tiers = sorted((s.kv_tier_counters or {}).items())
        for name, help_, key in _TIER_COUNTERS:
            lines += [f"# HELP {name}_total {help_}",
                      f"# TYPE {name}_total counter"]
            lines += [f'{name}_total{{{lab},tier="{tier}"}} '
                      f"{_num(c.get(key, 0))}" for tier, c in tiers]
        return "\n".join(lines) + "\n"
