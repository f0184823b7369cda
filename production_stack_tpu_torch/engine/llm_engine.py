"""LLMEngine: ties scheduler + block manager + model runner + sampler into
the step loop. One step == one prefill chunk group, one decode round, or
one lane-typed round holding both.

Counterpart of ``production_stack_tpu/engine/llm_engine.py`` on one
device: ``step`` -> ``_step_scheduled`` -> ``_step_ragged`` (a planned
mixed round: ONE ``ModelRunner.ragged_dispatch``, or split execution of
the same plan for lanes the fused round cannot take),
``_run_prefill_works`` (standard works, packed when several; under the
prefill pipeline a cold prompt's chunks chain in one step and the next
chunk is staged) or ``_run_decode_round`` (the fused K-step
``decode_multi`` with device stops when the round's K > 1, else
single-step decode with host-side sampling). With K > 1 the decode
prefetch stages the next fused or ragged round while the current one
runs; every stage is validated by fingerprint at its dispatch, and a
stale one is a counted miss. The scheduler, block manager and sequences
are the JAX package's, copied. Multi-LoRA (``--enable-lora``): every
dispatch carries its lanes' adapter slots, and every staged buffer's
fingerprint holds the slots it was built for.

KV tiers (the JAX engine's KV section): cached blocks that leave HBM are
exported to host RAM / disk / the shared cache server (deferred: pinned,
their gather enqueued after the step's dispatch, the d2h and tier IO on
the offload worker), and a request whose prefix is held by a tier, a PD
peer or the cache server restores it through a staged import while it
waits. The controller reporter streams HBM and tier admits and evicts.

Guided decoding (``engine/structured.py``): a constrained lane's allowed
tokens come from its machine on the host (single-step rounds and first
tokens), or, on fused and ragged rounds, from the TokenDFA tables the
runner evaluates inside the decode loop (``_device_guided_tables``); a
constraint too large to compile, or a lane near its token budget,
keeps the host mask. Prompt logprobs run on the single-sequence prefill,
which scores every row on the device. Every request has a lifecycle
timeline (``tracing/``) when ``request_timeline`` is on.

Speculative decoding (``num_speculative_tokens``): a decode-only round
whose lanes all sample plainly drafts each lane's next tokens by n-gram
prompt lookup and verifies them in ONE packed forward
(``ModelRunner.verify_batch``), every row sampled on the device with the
key its sequential step would use, so the accepted stream is the plain
one. ``embed_one`` mean-pools the final hidden state over a scratch
cache (``ModelRunner.embed``) for /v1/embeddings, /v1/rerank and
/v1/score.

Async decode (``async_decode``, K > 1): a fused decode round leaves its
tokens on the device (``_pending_decode``); the next step dispatches
round N+1 chained on them before it fetches round N (``_can_chain``,
``_resolve_pending``), so the fetch and the host's bookkeeping overlap
the device's work. Chained rounds carry no device stops, penalties, bias
or guided tables; a lane that stopped mid-flight discards at most one
round. Ragged rounds are off under it. ``precompile_serving`` runs the
JAX engine's warm-up grid of every config-derivable serving program
(the runner's ``precompile_*`` sweeps).

Long prefill (``long_prefill_threshold`` with ``context_parallel_size``
> 1, engine/long_prefill.py): a prompt past the threshold runs as
sequence-parallel ring chunks, one a step before ``schedule()``; the
other users' rounds run between the chunks (not at their normal cadence:
on one card a step that dispatches a chunk lasts about the chunk's
device time, since the round queues behind it); its KV lands in the
paged cache through the KV import primitives and its first token is
sampled from the ring's final-row logits (``_advance_long_prefills``).
A ring whose ranks share the serving card runs each chunk as a captured
program (a replay); adapter and prompt-logprob requests stay chunked; a
failed eager ring falls back to the chunked lane, a failed captured
chunk raises.

Tensor and pipeline parallelism (``tensor_parallel_size`` x
``pipeline_parallel_size`` = N > 1): the engine is rank 0 of a rank set
(parallel/launch.start_tp_ranks spawns ranks 1..N-1 unless the caller
passes its own ``tp_group``), and its runner is wrapped in
engine/multihost_engine.BroadcastingRunner, which publishes every
forward to the followers. The JAX meshed engine's rules hold: no
unified ragged rounds, no staged decode or ragged rounds, no staged
prefill (each stage is a device buffer the followers never see);
split rounds, the fused K-step decode, async decode (a chained round
is published with a marker, each rank chaining on its own tokens),
packed prefill, spec decode, embeddings, guided lanes, prompt logprobs
and the warm-up sweep are served, and on one host so are LoRA, the KV
tiers, the remote cache, PD roles and, at pp=1, the long-prefill lane
(its ring chunks, collect and landing are broadcast steps; exports,
imports and adapter loads too, issued from the step thread or under
AsyncLLMEngine's lock; a rank-set failure in one raises RankSetError,
never a counted fallback). Under pipeline parallelism the lane is off
and long prompts serve chunked, as in JAX. ``shutdown`` stops and joins
the followers. Under ``multihost`` (a job of
parallel/multihost.initialize) this engine is process 0's: the rank
set spans the job's processes, ``validate_multihost_config`` refuses
what is not broadcast, and the JAX multi-host engine's rules turn off
device stops, the decode prefetch, the prefill pipeline, ragged rounds,
async decode and the long-prefill lane.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from production_stack_tpu_torch.engine.block_manager import BlockManager
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.model_runner import (
    ModelRunner,
    validate_parallel,
)
from production_stack_tpu_torch.engine.multihost_engine import (
    BroadcastingRunner,
    RankSetError,
    validate_multihost_config,
)
from production_stack_tpu_torch.engine.outputs import (
    EngineStatsSnapshot,
    RequestOutput,
)
from production_stack_tpu_torch.engine.sampler import (
    LOGPROB_CAP,
    apply_penalties,
)
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.scheduler import (
    PrefillWork,
    Scheduler,
    SchedulerConfig,
    decode_k_buckets,
    decode_precompile_variants,
)
from production_stack_tpu_torch.engine.sequence import (
    Sequence,
    SequenceStatus,
)
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.kv.offload import own_block
from production_stack_tpu_torch.tracing import (
    NULL_RECORDER,
    RequestTracer,
    TimelineRecorder,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class LLMEngine:
    def __init__(self, config: EngineConfig, params: dict | None = None,
                 eager: bool = False, tp_group=None):
        """`eager`: the runner's comparison control (ModelRunner).
        `tp_group`: rank 0's group of a rank set the caller started
        (parallel/launch.start_tp_ranks, e.g. with its own devices and
        backend); None with tensor_parallel_size x
        pipeline_parallel_size > 1 starts one here."""
        self.config = config
        world = config.tensor_parallel_size * config.pipeline_parallel_size
        if config.multihost:
            from production_stack_tpu_torch.parallel import multihost

            validate_multihost_config(config)
            if multihost.is_multihost() and world < (
                    hosts := multihost.process_count()):
                raise ValueError(
                    f"a multi-host job of {hosts} processes needs a rank "
                    "set of at least as many ranks (tensor_parallel_size "
                    f"x pipeline_parallel_size = {world})")
        # the JAX runner's boot checks, before any rank starts
        validate_parallel(config, config.model_config())
        self.tokenizer = get_tokenizer(
            config.tokenizer, config.model,
            chat_template=config.chat_template,
        )
        if world > 1 and tp_group is None:
            from production_stack_tpu_torch.parallel.launch import (
                start_tp_ranks,
            )

            tp_group = start_tp_ranks(config, params=params)
        self.tp_group = tp_group
        try:
            self.runner = ModelRunner(config, params=params, eager=eager,
                                      group=tp_group)
            if tp_group is not None:
                self.runner = BroadcastingRunner(self.runner, tp_group)
                self.runner.wait_ready()
        except BaseException:
            if tp_group is not None:
                self._stop_ranks()
            raise
        # the JAX meshed engine's rules: in a rank set every device
        # buffer a stage would build lives on rank 0 only (and the JAX
        # multi-host engine's: the broadcast ships host argument lists)
        self._rank_set = tp_group is not None or config.multihost
        # async decode pipeline (double-buffered dispatch): the in-flight
        # decode round whose sampled tokens are still on the device
        self._pending_decode: dict | None = None
        self._async_decode = (
            config.async_decode and config.num_scheduler_steps > 1
            and not config.multihost
        )
        # the grid the last precompile_serving ran
        self.precompile_grid: dict | None = None
        self.block_manager = BlockManager(
            num_blocks=self.runner.num_blocks,
            block_size=config.block_size,
            enable_prefix_caching=config.enable_prefix_caching,
        )
        self.scheduler = Scheduler(
            SchedulerConfig(
                max_num_seqs=config.max_num_seqs,
                max_prefill_chunk=config.max_prefill_chunk,
                max_model_len=config.resolved_max_model_len(),
                enable_chunked_prefill=config.enable_chunked_prefill,
                max_prefill_seqs=config.max_prefill_seqs,
                scheduling_policy=config.scheduling_policy,
                decode_interleave=config.decode_interleave,
                decode_lookahead=max(0, config.num_scheduler_steps - 1),
                decode_k_cap=config.num_scheduler_steps,
                adaptive_decode_k=(
                    config.adaptive_decode_k
                    and config.num_scheduler_steps > 1
                ),
                # the chain commits round N+1 before round N's lane mix
                # is known: no ragged rounds under async decode; nor in
                # a rank set, as in the JAX meshed engine
                ragged_dispatch=(config.ragged_dispatch
                                 and not self._async_decode
                                 and not self._rank_set),
            ),
            self.block_manager,
        )
        # -- request-lifecycle timeline (tracing/timeline.py) -------------
        # one recorder per engine: scheduler admission / preemption
        # events, per-chunk prefill attribution, first token, sampled
        # decode rounds, finish. Appends only; the per-step call sites
        # guard on _tl_enabled so a disabled recorder costs one check.
        exporter = config.tracing_exporter
        if not config.request_timeline and exporter != "none":
            # engine spans are derived from timelines: with recording off
            # the exporter would sit dead, so say so and drop it
            logger.warning(
                "engine span export DISABLED: tracing_exporter=%r "
                "requires request timelines (drop "
                "--no-request-timeline to export engine_request spans)",
                exporter,
            )
            exporter = "none"
        self.tracer = RequestTracer(
            exporter, service_name=config.served_model_name or config.model,
        )
        self.timeline = (
            TimelineRecorder(maxlen=config.timeline_ring_size,
                             tracer=self.tracer)
            if config.request_timeline else NULL_RECORDER
        )
        self._tl_enabled = self.timeline.enabled
        self.scheduler.timeline = self.timeline
        # device-side stop masks ride the fused K-step loop only (not
        # multi-host: the broadcast wire ships host token lists)
        self._device_stop = (
            config.device_stop and config.num_scheduler_steps > 1
            and not config.multihost
        )
        self._ragged_dispatch = self.scheduler.config.ragged_dispatch
        # speculative h2d prefetch (stage_decode_multi / stage_ragged):
        # the NEXT fused round's buffer is copied while the current round
        # runs, and that round chains on the device tokens when the
        # prediction holds (fused rounds only: K > 1)
        self._prefetch_decode = (
            config.prefetch_decode and config.num_scheduler_steps > 1
            and not config.multihost
        )
        self._staged_decode: dict | None = None
        self._staged_hits_total = 0
        self._staged_misses_total = 0
        # pipelined prefill: staged next chunk, chained cold prompts,
        # zero-cost staged admission in the scheduler's interleave
        self._prefill_pipeline = (config.prefill_pipeline
                                  and not config.multihost)
        self._staged_prefill: dict | None = None
        self._pf_staged_hits_total = 0
        self._pf_staged_misses_total = 0
        self._pf_chained_chunks_total = 0
        # staged NEXT ragged round: a lane-mix change between stage and
        # dispatch is a counted miss, never a dispatch error
        self._staged_ragged: dict | None = None
        self._ragged_staged_hits_total = 0
        self._ragged_staged_misses_total = 0
        # "ragged" | "prefill" | "decode" | "idle": the last step's round
        self.last_step_kind = "idle"
        self._seqs: dict[str, Sequence] = {}
        # lifetime counters for /metrics
        self._prompt_tokens_total = 0
        self._generation_tokens_total = 0
        self._preemptions_total = 0
        self._finished_total = 0
        # speculative decoding: n-gram drafts verified in one packed
        # forward a round; drafts proposed and accepted, for /metrics
        self._spec_enabled = config.num_speculative_tokens > 0
        self._spec_drafts_total = 0
        self._spec_accepted_total = 0
        # decode rounds, the chosen-K histogram (tpu:decode_k),
        # host-discarded overshoot tokens (~0 under device stops) and
        # rounds whose device loop exited early
        self._decode_rounds_total = 0
        self._decode_k_hist: dict[int, int] = {}
        self._decode_overshoot_tokens_total = 0
        self._decode_early_exit_rounds_total = 0
        # unified ragged rounds: dispatched fused, planned mixed but run
        # split (lanes the fused round cannot take), and lane totals
        self._ragged_rounds_total = 0
        self._ragged_split_rounds_total = 0
        self._ragged_prefill_lanes_total = 0
        self._ragged_decode_lanes_total = 0
        # prefill lanes of each fused ragged round, drained into the
        # tpu:ragged_lane_mix histogram (appends / pops are GIL-atomic)
        self._ragged_obs: deque = deque(maxlen=4096)
        # rounds with guided lanes that took the host mask (the runner
        # counts those that ran on the device tables: guided_rounds)
        self._guided_host_rounds_total = 0
        self._init_kv_tiers()
        self._init_long_prefill()

    def _init_long_prefill(self) -> None:
        """The long-prefill lane (engine/long_prefill.py): prompts past
        long_prefill_threshold ring over context_parallel_size ranks,
        with decode / ragged rounds run between the chunks, and their KV
        lands through the KV import primitives. In a tp rank set each tp
        rank rings its own kv heads (engine/long_prefill.py). Under
        pipeline parallelism and multihost the lane is off, as in JAX.
        A ring that cannot be built degrades loudly to chunked-only
        serving. A ring whose ranks share the serving card runs its
        chunks as captured programs (boot logs its memory); any other
        ring on the card boots with a warning that it runs eagerly."""
        config = self.config
        self.long_prefill = None
        if (config.long_prefill_threshold is None
                or config.context_parallel_size <= 1):
            return
        if config.multihost or config.pipeline_parallel_size > 1:
            # the JAX engine's condition: the lane is off under pp and
            # across hosts, and those prompts serve chunked
            logger.info(
                "long-prefill lane off (%s): prompts past %d tokens "
                "serve via chunked prefill",
                "multihost" if config.multihost
                else f"pipeline_parallel_size={config.pipeline_parallel_size}",
                config.long_prefill_threshold,
            )
            return
        from production_stack_tpu_torch.engine.long_prefill import (
            LongPrefillManager,
        )

        try:
            self.long_prefill = LongPrefillManager(
                self.runner, chunk_tokens=config.long_prefill_chunk)
        except Exception as e:  # noqa: BLE001 — a ring that cannot be
            # built: serve every prompt chunked instead of refusing to
            # boot
            logger.warning(
                "long-prefill lane DISABLED (%s); prompts past %d tokens "
                "will serve via chunked prefill",
                e, config.long_prefill_threshold,
            )
        else:
            self.scheduler.config.long_prefill_threshold = (
                config.long_prefill_threshold)
            self.scheduler.long_prefill = self._begin_long_prefill
            pre = self.long_prefill.prefiller
            ring = pre.devices
            if pre.captured:
                pair, pool = self.runner._ring_reserve()
                logger.info(
                    "long-prefill ring: %d ranks on %s, each chunk a "
                    "captured program; the KV sizing kept back %.1f MiB "
                    "for its cache pair and %.1f MiB for its graph pool",
                    len(ring), ring[0], pair / 2**20, pool / 2**20)
            elif self.runner.device.type == "cuda":
                why = ("the runner is eager" if self.tp_group is None
                       and self.runner.eager else
                       "a rank set's rings are eager, and capturing a "
                       "ring across cards needs a machine with several "
                       "(ROADMAP Queue 1 item 3)")
                logger.warning(
                    "long-prefill ring: %d ranks on %s dispatch each "
                    "chunk eagerly (%s)", len(ring),
                    ", ".join(str(d) for d in ring), why)

    # -- KV offload tiers + controller reporting (LMCache-equivalent) ------
    def _init_kv_tiers(self) -> None:
        """The JAX engine's KV set-up: controller reporter, PD peer,
        offload manager and the block manager / scheduler hooks."""
        config = self.config
        self.kv_reporter = None
        self.offload = None
        if config.kv_controller_url:
            from production_stack_tpu_torch.kv.controller import (
                ControllerReporter,
            )

            self.kv_reporter = ControllerReporter(
                config.kv_controller_url,
                instance_id=config.kv_instance_id,
                url=config.kv_instance_id,
                block_size=config.block_size,
                snapshot_fn=self._kv_snapshot,
            )
        from production_stack_tpu_torch.kv.offload import (
            build_offload_manager,
        )

        # disaggregated-prefill consumer side: a PeerTier that rides the
        # offload manager's pending-READ map, so the staged restore below
        # handles peer pulls with no blocking socket IO on this thread
        self.kv_peer = None
        peer_spec = (config.kv_transfer_config or {}).get("peer")
        if peer_spec and config.kv_role != "prefill":
            from production_stack_tpu_torch.kv.peer import PeerTier

            self.kv_peer = PeerTier(peer_spec)
        self.offload = build_offload_manager(
            config, self.kv_reporter, peer=self.kv_peer
        )
        if self.kv_reporter is not None:
            bm = self.block_manager
            bm.on_admit = lambda hs: self.kv_reporter.admit("hbm", hs)
            bm.on_evict = lambda hs: self.kv_reporter.evict("hbm", hs)
        # zero-stall KV tiering: deferred export + staged restore;
        # sync_kv_offload keeps the synchronous path as the control
        self._kv_async = (
            self.offload is not None and not config.sync_kv_offload
        )
        # deferred-export queue: (block_id, hash) pairs pinned against
        # reuse until _flush_kv_exports enqueues their device snapshot
        self._kv_export_pending: list[tuple[int, int]] = []
        self._kv_export_queued: set[int] = set()
        # staged restores by request_id (see _begin_kv_restore)
        self._kv_restores: dict[str, dict] = {}
        # histogram observations drained by the server's stats loop
        # (deque appends/pops are GIL-atomic: the export side appends
        # from the offload worker thread)
        self._kv_export_obs: deque = deque(maxlen=1024)
        self._kv_restore_obs: deque = deque(maxlen=1024)
        self._kv_export_seconds_total = 0.0
        self._kv_export_blocks_total = 0
        self._kv_export_bytes_total = 0
        self._kv_restore_seconds_total = 0.0
        self._kv_restore_blocks_total = 0
        self._kv_restore_bytes_total = 0
        self._kv_restore_fallbacks_total = 0
        self._kv_export_sync_fallbacks_total = 0
        # wall seconds spent in SYNCHRONOUS tier exports (backlog-cap
        # degradations and sync_kv_offload): the overflow-export slice
        # of a long prefill's attribution reads the delta of this and of
        # the worker-side export seconds over the job's lifetime
        self._kv_export_sync_seconds_total = 0.0
        # high-water anchor for that attribution: overlapping long jobs
        # must not each claim the SAME export seconds; each finalize
        # claims only the window past the last claim
        self._long_overflow_anchor = 0.0
        if self.offload is not None and (
            self.offload.tiers or self.offload.remote is not None
        ):
            # export hooks only where there is somewhere to export TO: a
            # peer-only manager (pure PD decode engine) must not pin and
            # snapshot freed blocks into an empty cascade
            if self._kv_async:
                self.block_manager.on_freed_cached = (
                    self._queue_freed_exports
                )
                self.scheduler.kv_flush = self._flush_kv_exports
            else:
                self.block_manager.on_freed_cached = (
                    self._offload_freed_blocks
                )
        if self.offload is not None:
            self.scheduler.kv_restore = self._restore_from_offload

    def _kv_snapshot(self) -> dict[str, list[int]]:
        """Full tier->hashes state for controller (re)registration replay."""
        out = {"hbm": list(self.block_manager.cached_blocks.keys())}
        if self.offload is not None:
            out.update(self.offload.snapshot())
        return out

    def _offload_freed_blocks(self, pairs: list[tuple[int, int]]) -> None:
        """SYNCHRONOUS export path (--sync-kv-offload): cached blocks just
        became evictable -> batched d2h export inside scheduling -> tiers."""
        pairs = [(bid, h) for bid, h in pairs if not self.offload.contains(h)]
        self._export_sync(pairs)

    def _export_sync(self, pairs: list[tuple[int, int]]) -> None:
        """Blocking export of (block_id, hash) pairs on the CALLING
        thread: the --sync-kv-offload path and the async path's
        backlog-cap degradation share it."""
        if not pairs:
            return
        t0 = time.monotonic()
        data = self.runner.export_blocks([bid for bid, _ in pairs])
        # per-block owning copies: a view of the batched export would pin
        # the WHOLE export alive in the CPU tier until every sibling block
        # is evicted, blowing the tier's byte accounting
        self.offload.put_batch(
            [(h, own_block(data, i)) for i, (_, h) in enumerate(pairs)]
        )
        self._kv_export_sync_seconds_total += time.monotonic() - t0

    def _queue_freed_exports(self, pairs: list[tuple[int, int]]) -> None:
        """Deferred export (the zero-stall path): freed-but-cached blocks
        are PINNED against reuse and queued; _flush_kv_exports enqueues
        their device snapshot at the end of the step (after the dispatch)
        and the blocking d2h + tier IO run on the offload worker."""
        fresh: list[tuple[int, int]] = []
        pin: list[int] = []
        for bid, h in pairs:
            if h in self._kv_export_queued:
                pin.append(bid)  # re-freed before the snapshot: re-pin
                continue
            if self.offload.contains(h):
                continue
            fresh.append((bid, h))
            pin.append(bid)
            self._kv_export_queued.add(h)
        if pin:
            self.block_manager.pin_for_export(pin)
        self._kv_export_pending.extend(fresh)

    # in-flight deferred-export batches before the flush degrades to a
    # synchronous (stalling, counted) export: device gather buffers
    # queued behind a slow tier must not fill the card
    KV_EXPORT_BACKLOG_CAP = 4

    # stackcheck: hot-path — runs on the step thread between/after
    # device dispatches: may only ENQUEUE the device-side snapshot; the
    # blocking d2h + tier IO happen on the offload worker (the
    # backlog-cap branch is the deliberate, counted exception)
    def _flush_kv_exports(self) -> bool:
        """Enqueue the deferred-export snapshot and release the pins.
        The gather runs on the runner's compute stream with an event
        after it, so later dispatches cannot overwrite the snapshot —
        unpinning here is safe. Returns True when anything was flushed
        (scheduler retry contract)."""
        pending = self._kv_export_pending
        if not pending:
            return False
        self._kv_export_pending = []
        self._kv_export_queued.clear()
        bids = [bid for bid, _ in pending]
        try:
            if self.offload.export_backlog() >= self.KV_EXPORT_BACKLOG_CAP:
                # backpressure: materialize THIS batch on the step thread
                # (a bounded, counted stall) instead of growing the queue
                self._kv_export_sync_fallbacks_total += 1
                self._export_sync(pending)
                return True
            handle = self.runner.stage_export_blocks(bids)
            self.offload.put_batch_async(
                [h for _, h in pending], handle,
                self.runner.materialize_export, self._note_kv_export,
            )
        except RankSetError:
            raise  # the rank set is down: an error, never a dropped batch
        except Exception:  # noqa: BLE001 — export is best-effort: a
            # failed gather (e.g. device OOM sizing the snapshot) drops
            # the batch, it must not kill the step or leak the pins
            logger.exception("kv export staging failed; batch dropped")
        finally:
            # pins release even on failure — a leaked pin would shrink
            # the KV pool permanently
            self.block_manager.unpin_exported(bids)
        return True

    def _note_kv_export(
        self, seconds: float, blocks: int, nbytes: int
    ) -> None:
        """Offload-worker callback when a deferred export batch lands
        (GIL-atomic appends/adds only)."""
        self._kv_export_obs.append(seconds)
        self._kv_export_seconds_total += seconds
        self._kv_export_blocks_total += blocks
        self._kv_export_bytes_total += nbytes

    # -- staged restore ----------------------------------------------------
    # outstanding restore records (fetching or staged) before new
    # enqueue-time restores stop being started; the admission head
    # bypasses the cap (force)
    KV_RESTORE_FETCH_CAP = 8

    def _begin_kv_restore(
        self, seq: Sequence, force: bool = False
    ) -> tuple[dict | None, list[int] | None]:
        """Start the async restore for a request: find the tier chain
        continuation past the resident HBM prefix (cheap host-map probes
        only) and queue its reads on the offload worker. Returns (record,
        hashes) — hashes also on a no-restore miss."""
        if not force and len(self._kv_restores) >= \
                self.KV_RESTORE_FETCH_CAP:
            return None, None
        if seq.sampling_params.prompt_logprobs is not None:
            # the scheduler allocates these with reuse_cache=False (every
            # position must be computed): a restored prefix would go
            # unused
            return None, None
        bm = self.block_manager
        # ONE hashing pass per admission: reused by staging and finalize
        hashes = bm.block_hashes_for(seq.prompt_token_ids, seq.hash_seed)
        if not hashes:
            return None, hashes
        # cap the fetch at what could ever be adopted: the pool's usable
        # blocks (minus the null block) and the model-length ceiling
        cap = min(
            bm.num_blocks - 1,
            self.scheduler.config.max_model_len // bm.block_size,
        )
        has_chain = self.offload.has_chain_source()
        i = 0
        want: list[int] = []   # ordered fetch list (local + chain)
        local: list[int] = []  # hashes a local tier claims to hold
        remote: list[int] = []  # tail a chain source may hold (1 pull)
        while i < len(hashes) and len(want) < cap:
            h = hashes[i]
            if bm.contains_hash(h):
                i += 1  # already resident: nothing to fetch
                continue
            if self.offload.contains_local(h):
                want.append(h)
                local.append(h)
            elif has_chain:
                # past the local continuation the PD peer or the shared
                # cache server may still hold the chain: the whole tail
                # rides ONE get_chain pull on the offload worker
                want.append(h)
                remote.append(h)
            else:
                break  # chain continuation ends here
            i += 1
        if not want:
            return None, hashes
        if local:
            self.offload.request_reads(local)
        if remote:
            self.offload.request_chain_reads(remote)
        rec = {
            "rid": seq.request_id,
            "hashes": hashes,
            "want": want,
            # a pure-chain record that comes back empty is a cold prompt
            # neither the peer nor the shared cache held: not a fallback
            "peer_only": bool(remote) and not local,
            "state": "fetching",
            "t0": time.monotonic(),
            "handle": None,
            "cols": {},
            "col_bytes": [],
            "col_tiers": [],
        }
        self._kv_restores[seq.request_id] = rec
        return rec, hashes

    # staged (device-buffer-holding) restores allowed at once: a burst of
    # waiting requests must not land every chain on the card at once
    KV_RESTORE_STAGED_CAP = 4

    def _poll_kv_restores(self) -> None:
        """Advance in-flight restores (start the h2d for completed
        fetches) so uploads overlap whatever the engine is doing."""
        staged = sum(
            1 for r in self._kv_restores.values()
            if r["state"] == "staged"
        )
        for rec in list(self._kv_restores.values()):
            if rec["state"] != "fetching":
                continue
            if staged >= self.KV_RESTORE_STAGED_CAP:
                break
            try:
                self._advance_kv_restore(rec)
                if rec["state"] == "staged":
                    staged += 1
            except RankSetError:
                raise  # an error of the rank set, not a recompute
            except Exception:  # noqa: BLE001 — a staging failure must
                # never kill the step loop: this request recomputes
                logger.exception(
                    "kv restore staging failed for %s; recomputing",
                    rec["rid"],
                )
                self._mark_restore_failed(rec)

    # stackcheck: hot-path — restore staging on the step thread:
    # assemble the host batch and START its h2d; no device fetch, no
    # tier IO (reads completed on the worker)
    def _advance_kv_restore(self, rec: dict) -> None:
        if rec["state"] != "fetching":
            return
        done = self.offload.poll_reads(rec["want"])
        if len(done) < len(rec["want"]):
            return  # worker still fetching
        usable: list[tuple[int, torch.Tensor, str]] = []
        for h in rec["want"]:
            arr, tier = done[h]
            if arr is None:
                break  # mid-restore failure: the tail recomputes
            usable.append((h, arr, tier))
        self.offload.discard_reads(rec["want"])
        # references are released: leave "fetching" NOW so a staging
        # exception below cannot discard a second time
        rec["state"] = "failed"
        if not usable:
            rec["nothing_fetched"] = True
            return
        data = torch.stack([a for _, a, _ in usable], dim=2)
        rec["handle"] = self.runner.stage_import_blocks(data)
        rec["cols"] = {h: j for j, (h, _, _) in enumerate(usable)}
        rec["col_bytes"] = [int(a.nbytes) for _, a, _ in usable]
        rec["col_tiers"] = [tier for _, _, tier in usable]
        rec["state"] = "staged"

    def _finalize_kv_restore(self, seq: Sequence, rec: dict) -> None:
        """Admission-time landing: re-validate the staged window against
        the CURRENT cache (the chain must still connect from the resident
        prefix; any break recomputes from the break) and scatter the
        adopted blocks in place."""
        self._kv_restores.pop(rec["rid"], None)
        if rec["state"] != "staged":
            if not (rec.get("peer_only") and rec.get("nothing_fetched")):
                self._kv_restore_fallbacks_total += 1
            return
        bm = self.block_manager
        if self._kv_export_pending:
            # release export pins so adoption can claim free blocks
            self._flush_kv_exports()
        cols = rec["cols"]
        hashes = rec["hashes"]
        bids: list[int] = []
        src: list[int] = []
        adopted: list[int] = []
        i = 0
        while i < len(hashes):
            h = hashes[i]
            if bm.contains_hash(h):
                i += 1
                continue
            j = cols.get(h)
            if j is None:
                break  # staged window over (or chain moved): recompute
            if not bm.can_adopt_another(len(bids)):
                break  # only OUR adoptions left to evict
            bid = bm.adopt_cached_block(h)
            if bid is None:
                break  # pool exhausted: partial
            bids.append(bid)
            src.append(j)
            adopted.append(h)
            i += 1
        import_failed = False
        if bids and not self._import_restored(bids, adopted,
                                              rec["handle"], src):
            bids = []
            src = []
            import_failed = True
        seconds = time.monotonic() - rec["t0"]
        tiers: dict[str, int] = {}
        for j in src:
            t = rec["col_tiers"][j]
            tiers[t] = tiers.get(t, 0) + 1
        if bids:
            self._kv_restore_obs.append(seconds)
            self._kv_restore_seconds_total += seconds
            self._kv_restore_blocks_total += len(bids)
            self._kv_restore_bytes_total += sum(
                rec["col_bytes"][j] for j in src
            )
        elif i < len(hashes) or import_failed:
            # adoption was CUT SHORT (chain break / full HBM) or the
            # import failed; a walk that reached the end restoring
            # nothing found everything resident: not a fallback
            self._kv_restore_fallbacks_total += 1
        if self._tl_enabled:
            self.timeline.event(
                seq.request_id, "kv_restore",
                {"tiers": tiers, "blocks": len(bids),
                 "seconds": round(seconds, 6)},
            )

    def _import_restored(
        self, bids: list[int], adopted: list[int], handle,
        src: list[int],
    ) -> bool:
        """Land adopted blocks via the staged scatter; on failure
        UN-ADOPT them — a cache entry whose KV was never written would
        serve garbage to every later prefix hit on its hash."""
        try:
            self.runner.import_staged_blocks(bids, handle, src)
            return True
        except RankSetError:
            raise  # the rank set is down: never a counted fallback
        except Exception:  # noqa: BLE001 — e.g. stale wrong-shape tier
            # data after a model swap; the request just recomputes
            logger.exception(
                "kv import failed; dropping %d adopted blocks", len(bids)
            )
            for h in adopted:
                self.block_manager.drop_cached_block(h)
            return False

    def _drop_kv_restore(self, request_id: str) -> None:
        """Forget a request's staged restore (abort / admission abort)."""
        rec = self._kv_restores.pop(request_id, None)
        if rec is not None and rec["state"] == "fetching":
            self.offload.discard_reads(rec["want"])

    def _mark_restore_failed(self, rec: dict) -> None:
        """Park a failed restore as state='failed' but KEEP the record:
        the owning request's next admission attempt consumes it (one
        fallback, recompute, proceed) instead of re-creating it fresh
        each step."""
        if rec["state"] == "fetching":
            self.offload.discard_reads(rec["want"])
        rec["state"] = "failed"

    def _restore_from_offload(self, seq: Sequence):
        """Scheduler admission hook. Async mode: poll/stage/land the
        request's staged restore — returns False to keep the request
        WAITING while its tier fetch + h2d are in flight (bounded by
        kv_restore_wait_s, then recompute). Sync mode: the blocking
        restore. Always returns truthy once admission may proceed."""
        if not self._kv_async:
            self._restore_sync(seq)
            return True
        if not self.block_manager.enable_prefix_caching:
            return True
        rec = self._kv_restores.get(seq.request_id)
        if rec is None:
            # no record (preempted requeue, fetch-cap skip, or blocks
            # offloaded after enqueue): begin the ASYNC fetch now
            rec, _hashes = self._begin_kv_restore(seq, force=True)
            if rec is None:
                return True
        try:
            self._advance_kv_restore(rec)
        except RankSetError:
            raise
        except Exception:  # noqa: BLE001 — staging failure: recompute
            logger.exception(
                "kv restore staging failed for %s; recomputing",
                seq.request_id,
            )
            self._mark_restore_failed(rec)
        if rec["state"] == "fetching":
            # the wait budget covers how long the request HOLDS its
            # admission slot: consecutive deferrals bill at most ~one
            # engine round each
            now = time.monotonic()
            last = rec.get("last_defer")
            if last is not None:
                rec["held_s"] = (
                    rec.get("held_s", 0.0) + min(now - last, 1.0)
                )
            rec["last_defer"] = now
            if rec.get("held_s", 0.0) < self.config.kv_restore_wait_s:
                return False
            logger.warning(
                "kv restore for %s held admission %.1fs; recomputing",
                seq.request_id, self.config.kv_restore_wait_s,
            )
            self._drop_kv_restore(seq.request_id)
            self._kv_restore_fallbacks_total += 1
            return True
        self._finalize_kv_restore(seq, rec)
        return True

    def _restore_sync(self, seq: Sequence) -> None:
        """Synchronous restore: blocking tier reads on the scheduler
        thread (the --sync-kv-offload control)."""
        bm = self.block_manager
        if not bm.enable_prefix_caching:
            return
        hashes = bm.block_hashes_for(seq.prompt_token_ids, seq.hash_seed)
        matched, _ = bm.match_prefix(seq.prompt_token_ids, seq.hash_seed)
        restore: list[tuple[int, torch.Tensor]] = []  # (block_id, data)
        adopted: list[int] = []
        i = len(matched)
        hbm_full = False
        while i < len(hashes):
            h = hashes[i]
            if bm.contains_hash(h):
                break  # already back in HBM (another seq restored it)
            arr = self.offload.get(h)
            if arr is None:
                break  # local chain broken; try the PD peer below
            if not bm.can_adopt_another(len(restore)):
                hbm_full = True
                break
            bid = bm.adopt_cached_block(h)
            if bid is None:
                hbm_full = True  # no room: a network pull is pointless
                break
            restore.append((bid, arr))
            adopted.append(h)
            i += 1
        self._import_restored_host(restore, adopted)
        if not hbm_full:
            self._pd_transfer_restore(seq, hashes)

    def _pd_transfer_restore(
        self, seq: Sequence, hashes: list[int] | None = None
    ) -> None:
        """SYNC-MODE chain-source pull: one batched blocking round-trip
        from the PD peer (then the shared cache server) for whatever the
        local tiers could not supply. Only reachable from _restore_sync;
        the async path routes chain pulls through the staged restore."""
        if self.offload is None or not self.offload.has_chain_source():
            return
        bm = self.block_manager
        if hashes is None:
            hashes = bm.block_hashes_for(
                seq.prompt_token_ids, seq.hash_seed
            )
        i = 0
        while i < len(hashes) and bm.contains_hash(hashes[i]):
            i += 1
        if i >= len(hashes):
            return
        blocks: list[torch.Tensor] = []
        for source in self.offload.chain_sources():
            if i + len(blocks) >= len(hashes):
                break
            # a source serving only a short prefix hands the UNSERVED
            # TAIL to the next one
            got, _addr = source.get_chain(hashes[i + len(blocks):])
            blocks.extend(got)
        if not blocks:
            return
        restore: list[tuple[int, torch.Tensor]] = []
        adopted: list[int] = []
        for j, arr in enumerate(blocks):
            if not bm.can_adopt_another(len(restore)):
                break
            bid = bm.adopt_cached_block(hashes[i + j])
            if bid is None:
                break
            restore.append((bid, arr))
            adopted.append(hashes[i + j])
        self._import_restored_host(restore, adopted)

    def _import_restored_host(
        self, restore: list[tuple[int, torch.Tensor]], adopted: list[int]
    ) -> None:
        """import_blocks with the same un-adopt-on-failure contract as
        _import_restored (sync restore + PD pull paths)."""
        if not restore:
            return
        try:
            self.runner.import_blocks(
                [bid for bid, _ in restore],
                torch.stack([a for _, a in restore], dim=2),
            )
        except RankSetError:
            raise
        except Exception:  # noqa: BLE001 — see _import_restored
            logger.exception(
                "kv import failed; dropping %d adopted blocks",
                len(restore),
            )
            for h in adopted:
                self.block_manager.drop_cached_block(h)

    def drain_kv_observations(self) -> tuple[list[float], list[float]]:
        """(export_seconds, restore_seconds) observations since the last
        drain, for the server's tpu:kv_*_seconds histograms."""
        exp: list[float] = []
        rst: list[float] = []
        while True:
            try:
                exp.append(self._kv_export_obs.popleft())
            except IndexError:
                break
        while True:
            try:
                rst.append(self._kv_restore_obs.popleft())
            except IndexError:
                break
        return exp, rst

    # -- long-prefill lane (context-parallel ring prefill) ------------------
    def _begin_long_prefill(self, seq: Sequence) -> bool:
        """Scheduler admission hook: claim an admitted long prompt for
        the ring lane. Declines (-> chunked path) for adapter requests
        (the ring runs base weights only) and prompt_logprobs (the ring
        fetches only the final row's logits)."""
        mgr = self.long_prefill
        if mgr is None:
            return False
        if seq.lora_name is not None:
            return False
        if seq.sampling_params.prompt_logprobs is not None:
            return False
        # anchor for the overflow-export attribution: tier-export
        # seconds that accrue while this job is in flight are the
        # headroom the landed chain displaced
        export_s0 = (self._kv_export_seconds_total
                     + self._kv_export_sync_seconds_total)
        if not mgr.start(seq, export_s0=export_s0):
            return False
        seq.long_prefill_active = True
        if seq.metrics.first_scheduled_time is None:
            seq.metrics.first_scheduled_time = time.time()
        return True

    def _advance_long_prefills(self) -> tuple[list[Sequence], bool]:
        """One engine step's worth of long-prefill progress (chunk
        dispatch / batch landing — LongPrefillManager.advance) plus
        finalization of completed jobs: the sequence's chain is fully
        landed in the paged cache, so its first token is sampled from
        the ring's final-row logits and it joins the normal decode path.
        Returns (stepped sequences, progressed)."""
        mgr = self.long_prefill
        done, failed, progressed = mgr.advance()
        stepped: list[Sequence] = []
        for rec in failed:
            seq = rec["seq"]
            if seq.request_id in self._seqs and not seq.finished:
                # the block table is already allocated; the chunked
                # planners pick the sequence up next schedule()
                seq.long_prefill_active = False
                logger.warning(
                    "long prefill failed for %s; serving via chunked "
                    "prefill", seq.request_id,
                )
        for rec in done:
            seq = rec["seq"]
            if (
                seq.finished
                or seq.request_id not in self._seqs
                or not seq.long_prefill_active
            ):
                continue  # aborted/preempted while the last batch landed
            seq.long_prefill_active = False
            new_tokens = seq.num_prompt_tokens - seq.num_computed_tokens
            seq.num_computed_tokens = seq.num_prompt_tokens
            self._prompt_tokens_total += max(0, new_tokens)
            export_now = (self._kv_export_seconds_total
                          + self._kv_export_sync_seconds_total)
            # claim only the export window past BOTH this job's start and
            # the last claim: overlapping jobs share the seconds instead
            # of each counting them (see _long_overflow_anchor)
            anchor = max(rec.get("export_s0", export_now),
                         self._long_overflow_anchor)
            overflow_s = max(0.0, export_now - anchor)
            self._long_overflow_anchor = export_now
            mgr.phase_s["overflow"] += overflow_s
            # first token: sampled from the ring's final-row logits (the
            # worker parked them on the host, pinned) on the runner's
            # device, as the host-sampled finals of _run_prefill_works
            logits = rec["logits"].to(self.runner.device, non_blocking=True)
            sampled, used_logits = self._sample(
                [seq], logits[None], return_logits=True)
            entry = None
            n_lp = seq.sampling_params.logprobs
            if n_lp is not None:
                entry = self._host_logprob_entry(
                    # stackcheck: disable=device-sync-transitive — the
                    # long-prefill first-token logprob row materializes
                    # only when the request asked for logprobs
                    _to_numpy(used_logits)[0], int(sampled[0]), n_lp)
            if self._tl_enabled:
                self.timeline.event(
                    seq.request_id, "long_prefill",
                    {
                        "prompt_tokens": rec["n"],
                        "chunk_tokens": mgr.chunk,
                        "chunks": rec["ring_end"] // mgr.chunk,
                        "blocks_landed": rec["landed_blocks"],
                        "cached_prompt_tokens": (
                            rec["start_block"] * mgr.block_size),
                        "ring_s": round(rec["ring_s"], 6),
                        "d2h_s": round(rec["d2h_s"], 6),
                        "land_s": round(rec["land_s"], 6),
                        "overflow_s": round(overflow_s, 6),
                    },
                )
            # stackcheck: disable=device-sync-transitive — host token:
            # _sample (the not-hot host sampling seam) returned host ints
            self._append_token(seq, int(sampled[0]), entry)
            stepped.append(seq)
        return stepped, progressed

    def _cancel_long_prefill(self, seq: Sequence) -> None:
        """Drop a sequence's ring job (abort / preemption)."""
        if self.long_prefill is not None:
            self.long_prefill.cancel(seq.request_id)
        seq.long_prefill_active = False

    def add_request(
        self,
        request_id: str,
        prompt: str | None = None,
        prompt_token_ids: list[int] | None = None,
        sampling_params: SamplingParams | None = None,
        arrival_time: float | None = None,
        lora_name: str | None = None,
        priority: int = 0,
        traceparent: str | None = None,
    ) -> None:
        if request_id in self._seqs:
            raise ValueError(f"duplicate request_id {request_id!r}")
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("need prompt or prompt_token_ids")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if not prompt_token_ids:
            raise ValueError("empty prompt")
        if not all(isinstance(t, (int, np.integer))
                   for t in prompt_token_ids):
            # validate BEFORE admission: a non-int reaching the runner's
            # array build would raise inside the step-loop thread
            raise ValueError("prompt_token_ids must be integers")
        sp = sampling_params or SamplingParams()
        if sp.truncate_prompt_tokens is not None:
            from production_stack_tpu_torch.engine.sampling_params import (
                truncate_prompt,
            )

            prompt_token_ids = truncate_prompt(
                prompt_token_ids, sp, self.scheduler.config.max_model_len
            )
        if (sp.prompt_logprobs is not None
                and sp.prompt_logprobs > LOGPROB_CAP):
            raise ValueError(f"prompt_logprobs > {LOGPROB_CAP} unsupported")
        if sp.logit_bias:
            vocab = self.runner.model_config.vocab_size
            bad = [t for t in sp.logit_bias if t >= vocab]
            if bad:
                raise ValueError(
                    f"logit_bias token ids {bad[:5]} out of range for "
                    f"vocab size {vocab}"
                )
        if sp.logprobs is not None and not 0 <= sp.logprobs <= LOGPROB_CAP:
            raise ValueError(f"logprobs must be in [0, {LOGPROB_CAP}]")
        lora = self.runner.lora_manager
        if lora_name is not None:
            if lora is None:
                raise ValueError(
                    "request names a LoRA adapter but the engine was "
                    "started without --enable-lora"
                )
            lora.slot_of(lora_name)  # raises KeyError if unknown
        seq = Sequence(
            request_id=request_id,
            prompt_token_ids=prompt_token_ids,
            sampling_params=sp,
            eos_token_id=self.tokenizer.eos_token_id,
            arrival_time=arrival_time,
            lora_name=lora_name,
            hash_seed=(None if lora is None
                       else lora.hash_seed_of(lora_name)),
            priority=int(priority),
        )
        self._setup_guided(seq)
        self._seqs[request_id] = seq
        self.scheduler.add_seq(seq)
        if self._kv_async and self.block_manager.enable_prefix_caching:
            # the staged restore starts the moment the request enters the
            # waiting queue: the tier fetch (offload worker) and then the
            # h2d (_poll_kv_restores) overlap the queue wait
            try:
                self._begin_kv_restore(seq)
            except Exception:  # noqa: BLE001 — restore is best-effort;
                # admission simply recomputes the prefix
                logger.exception("kv restore staging failed for %s",
                                 request_id)
        self.timeline.start(
            request_id,
            arrival_time=seq.metrics.arrival_time,
            traceparent=traceparent,
            prompt_tokens=seq.num_prompt_tokens,
            priority=seq.priority,
        )

    def _setup_guided(self, seq: Sequence) -> None:
        """Validate a request's guided constraint and attach its machine
        (or its tokenized choices) to the sequence; schema, pattern and
        grammar errors raise ValueError (HTTP 400)."""
        sp = seq.sampling_params
        if sp.guided_choice is not None:
            if not sp.guided_choice or not all(
                isinstance(c, str) and c for c in sp.guided_choice
            ):
                raise ValueError(
                    "guided_choice must be a non-empty list of "
                    "non-empty strings"
                )
            try:
                choice_ids = [
                    self.tokenizer.encode(c, add_bos=False)
                    for c in sp.guided_choice
                ]
            except TypeError:  # tokenizer without the add_bos kwarg
                choice_ids = [
                    self.tokenizer.encode(c) for c in sp.guided_choice
                ]
            if any(not ids for ids in choice_ids):
                raise ValueError("guided_choice entries must tokenize "
                                 "to at least one token")
            seq._guided_choices = choice_ids  # type: ignore[attr-defined]
        if (sp.guided_json is not None or sp.guided_regex is not None
                or sp.guided_grammar is not None):
            from production_stack_tpu_torch.engine import structured

            if self.tokenizer.eos_token_id is None:
                # the mask offers EOS as the stop-here move at accepting
                # states; without one a finished constraint could not
                # stop
                raise ValueError(
                    "guided decoding requires a tokenizer with an EOS "
                    "token"
                )
            kind, spec = (
                ("json", sp.guided_json)
                if sp.guided_json is not None
                else ("regex", sp.guided_regex)
                if sp.guided_regex is not None
                else ("grammar", sp.guided_grammar)
            )
            machine = structured.get_machine(kind, spec)
            seq._guided_machine = machine  # type: ignore[attr-defined]
            seq._guided_state = machine.initial()  # type: ignore[attr-defined]

    def abort_request(self, request_id: str) -> bool:
        seq = self._seqs.pop(request_id, None)
        if seq is None:
            return False
        if self._kv_restores:
            self._drop_kv_restore(request_id)
        if self.long_prefill is not None:
            self._cancel_long_prefill(seq)
        aborted = self.scheduler.abort(request_id)
        self.timeline.finish(request_id, "abort")
        return aborted

    def has_request(self, request_id: str) -> bool:
        return request_id in self._seqs

    def has_request_prefix(self, request_id: str) -> bool:
        pref = f"{request_id}-c"
        return any(k.startswith(pref) for k in list(self._seqs))

    def has_unfinished(self) -> bool:
        # an in-flight async round counts even when every owning request
        # was aborted: the loop must step once more to flush it
        return (self.scheduler.has_unfinished()
                or self._pending_decode is not None)

    # -- the step loop ----------------------------------------------------
    # stackcheck: hot-path — may only enqueue (flush = device-snapshot
    # enqueue; the d2h runs on the offload worker)
    def step(self) -> list[RequestOutput]:
        with self.runner.on_compute_stream():
            try:
                return self._step_impl()
            finally:
                # deferred KV exports flush at the END of every step —
                # after the dispatch, so the d2h overlaps device compute;
                # on idle/final steps this keeps freed blocks from staying
                # pinned
                if self._kv_export_pending:
                    self._flush_kv_exports()

    # stackcheck: hot-path — the engine round: dispatch, then the round's
    # sanctioned fetches (each suppressed where it stands)
    def _step_impl(self) -> list[RequestOutput]:
        """The async fast path: with a round in flight, dispatch the next
        one chained on its device tokens, then fetch and apply it (the
        fetch overlaps the new round). A round that cannot chain is
        flushed before scheduling reads any sequence state."""
        pend = self._pending_decode
        if pend is None:
            return self._step_scheduled()
        if not self._can_chain():
            return self._resolve_pending() + self._step_scheduled()
        seqs: list[Sequence] = pend["seqs"]
        k = pend["k"]
        want_lp = pend["lps"] is not None
        temps, top_ps, top_ks, min_ps, keys, _ = self._sampling_arrays(seqs)
        keys[:, 1] += k  # k sampled-but-unapplied tokens a lane
        ys = self.runner.decode_multi(
            pend["toks"][-1], [s.num_tokens - 1 + k for s in seqs],
            [s.block_table for s in seqs], [s.num_tokens + k for s in seqs],
            k, temps, top_ps, top_ks, keys, min_ps=min_ps,
            want_logprobs=want_lp, lora_slots=self._lora_slots(seqs),
        )
        outputs = self._resolve_pending()
        self._pending_decode = {
            "seqs": seqs, "k": k,
            "toks": ys[0] if want_lp else ys,
            "lps": ys[1:] if want_lp else None,
        }
        self.last_step_kind = "decode"
        return outputs

    def _can_chain(self) -> bool:
        """True when the in-flight round can be followed by another on
        the SAME lanes before its tokens land: nothing waiting for
        admission, every lane alive and unguided with no logit bias, the
        running set unchanged, and tables growable for both rounds
        without preemption. Host-side stops do not refuse the chain: a
        lane found stopped at resolve time discards its overshoot (at
        most one round), and the next step flushes."""
        pend = self._pending_decode
        if pend is None or self.scheduler.waiting:
            return False
        seqs: list[Sequence] = pend["seqs"]
        if any(s.finished for s in seqs):
            return False
        if any(self._is_guided(s) or s.sampling_params.logit_bias
               for s in seqs):
            return False  # a chained dispatch carries neither
        if {id(s) for s in self.scheduler.running} != {id(s) for s in seqs}:
            return False
        return self._reserve_next_round(seqs, pend["k"])

    def _resolve_pending(self) -> list[RequestOutput]:
        """Fetch the in-flight round's tokens and apply them (the
        synchronous path's bookkeeping). Requests aborted mid-flight
        already had their final output: they are not finalized again."""
        pend = self._pending_decode
        self._pending_decode = None
        seqs = pend["seqs"]
        lps = pend["lps"]
        self._apply_fused_decode(
            seqs, pend["k"],
            pend["toks"] if lps is None else (pend["toks"], *lps),
            lps is not None, False)
        return self._finalize_stepped(
            [s for s in seqs if s.request_id in self._seqs])

    def _step_scheduled(self) -> list[RequestOutput]:
        if self._kv_restores:
            # start h2d uploads for restores whose tier fetch landed while
            # their requests sit in the waiting queue
            self._poll_kv_restores()
        # long-prefill lane: advance ring chunks / KV landing BEFORE
        # scheduling, so a job whose chain just finished landing is
        # decode-ready in THIS round's plan. Enqueues only, never a
        # device fetch, so the rounds below keep their cadence.
        long_stepped: list[Sequence] = []
        long_progress = True
        if self.long_prefill is not None and self.long_prefill.active:
            long_stepped, long_progress = self._advance_long_prefills()
        sched_out = self.scheduler.schedule()
        if sched_out.preempted or sched_out.prefills or sched_out.aborted:
            # a table free or lane-set change invalidates the staged
            # decode round (the free epoch in its fingerprint already
            # would; dropping it here releases the buffer). A RAGGED
            # round's stage expects prefill lanes: _dispatch_ragged
            # validates (or miss-counts) it
            self._staged_decode = None
        if self._staged_ragged is not None and (
            sched_out.preempted or sched_out.aborted
            or not sched_out.is_ragged
        ):
            # the staged lane mix did not come true (a table was freed,
            # the prefill drained, or the round went pure): a counted
            # staging miss, never a dispatch error
            self._ragged_staged_misses_total += 1
            self._staged_ragged = None
        if sched_out.preempted and self.long_prefill is not None:
            # a preempted long-lane sequence lost its block table: its
            # ring job is stale. A sequence preempted AND re-admitted in
            # this same schedule() carries the flag again with a FRESH
            # job (manager.start replaced the stale record): keep it
            for seq in sched_out.preempted:
                if not seq.long_prefill_active:
                    self.long_prefill.cancel(seq.request_id)
        if sched_out.preempted:
            # preemption frees tables that can be handed out again: the
            # staged prefill buffer goes too, and a zero-cost admission
            # granted for it in this schedule() becomes a charged one
            if self._staged_prefill is not None:
                self._pf_staged_misses_total += 1
                self.scheduler.note_staged_prefill_miss()
            self._staged_prefill = None
            self.scheduler.staged_prefill_ready = False
        self._preemptions_total += len(sched_out.preempted)
        self.last_step_kind = (
            "ragged" if sched_out.is_ragged
            else "prefill" if sched_out.prefills
            else "decode" if sched_out.decode is not None
            else "idle"
        )
        if sched_out.is_empty:
            if long_stepped:
                # a long prefill finished with nothing else scheduled:
                # emit its first-token output now
                return self._finalize_stepped(long_stepped)
            if self._kv_restores and not self.scheduler.running:
                # every waiting request is restore-deferred and nothing is
                # dispatchable: yield briefly instead of pegging the step
                # thread against the offload worker doing the fetch
                # stackcheck: disable=blocking-hot — deliberate 1ms idle
                # yield on the no-dispatchable-work branch (see above)
                time.sleep(0.001)
            elif (self.long_prefill is not None
                  and self.long_prefill.active and not long_progress):
                # only long-prefill work exists and it waits on the
                # materialization worker: yield instead of pegging the
                # step thread against the worker's copy
                # stackcheck: disable=blocking-hot — deliberate 0.5ms
                # idle yield while the worker owns the d2h (see above)
                time.sleep(0.0005)
            return []

        outputs: list[RequestOutput] = []
        for seq in sched_out.aborted:
            seq.metrics.finished_time = time.time()
            self._finished_total += 1
            outputs.append(self._make_output(seq))
            self._seqs.pop(seq.request_id, None)
            if self._kv_restores:
                self._drop_kv_restore(seq.request_id)
            self.timeline.finish(seq.request_id, seq.finish_reason)

        stepped: list[Sequence] = list(long_stepped)
        if sched_out.is_ragged:
            # prefill-chunk lanes + the decode batch in ONE lane-typed
            # round (split execution for lanes the fused round cannot
            # take)
            stepped.extend(
                self._step_ragged(sched_out.prefills, sched_out.decode)
            )
        elif sched_out.prefills:
            # pipelined prefill: a buffer staged in an earlier round may
            # serve this dispatch (fingerprint-checked in
            # _run_prefill_works); then a cold group's next chunks chain
            # in THIS step while nothing is decode-ready, and otherwise
            # the next chunk is staged so its copy overlaps the
            # interleaved decode round. The chain is capped: one step
            # holds the server's step lock.
            staged = self._staged_prefill
            self._staged_prefill = None
            self.scheduler.staged_prefill_ready = False
            works = sched_out.prefills
            chain_budget = self.scheduler.config.max_staged_prefill_run
            chained = False
            while True:
                stepped.extend(
                    self._run_prefill_works(works, staged, chained=chained)
                )
                staged = None
                if chain_budget <= 0:
                    break
                nxt = self._chain_next_prefill(works)
                if nxt is None:
                    break
                chain_budget -= 1
                self._pf_chained_chunks_total += len(nxt)
                chained = True
                works = nxt
            self._maybe_stage_prefill(works)
        elif sched_out.decode is not None:
            seqs = sched_out.decode.seqs
            spec = (self._try_spec_decode_batch(seqs)
                    if self._spec_enabled else None)
            if spec is not None:
                stepped.extend(spec)
            else:
                stepped.extend(
                    self._run_decode_round(seqs, sched_out.decode.k))
        if long_stepped and len(stepped) > len(long_stepped):
            # a just-finalized long prefill may ALSO have ridden this
            # round's decode batch (its first token made it decode-ready
            # before schedule()): finalize it once
            seen: set[int] = set()
            stepped = [s for s in stepped
                       if not (id(s) in seen or seen.add(id(s)))]
        outputs.extend(self._finalize_stepped(stepped))
        return outputs

    # -- decode prefetch -----------------------------------------------------
    def _reserve_next_round(self, seqs: list[Sequence], k: int) -> bool:
        """Bounds and block reservation for staging a SECOND fused round
        before the first one's tokens are applied: every lane at least 2K
        tokens from its max_tokens / max_model_len bounds, and tables
        grown to cover both rounds. All or nothing: blocks are allocated
        only after every lane passed, so a refusal leaves no lane holding
        speculatively grown tables."""
        bs = self.block_manager.block_size
        grow = 0
        for s in seqs:
            remaining = s.sampling_params.max_tokens - len(
                s.generated_token_ids) - k
            if remaining < k:
                return False  # final rounds run unstaged
            if s.num_tokens + 2 * k >= self.scheduler.config.max_model_len:
                return False
            need = (s.num_tokens + 2 * k + bs - 1) // bs - len(s.block_table)
            if need > 0:
                grow += need
        if grow > self.block_manager.num_free_blocks:
            return False  # needs preemption: go through schedule()
        for s in seqs:
            ok = self.block_manager.ensure_capacity(
                s.num_tokens + 2 * k, s.block_table
            )
            assert ok  # guaranteed by the free-block check above
        return True

    def _can_stage(self, seqs: list[Sequence], k: int) -> bool:
        """True when the NEXT fused round on these same lanes can be
        staged: no waiting admission, no lane mid-prefill under ragged
        rounds (the next round is lane-typed: the ragged stage covers
        it), no guided lane (a staged round carries no DFA tables: guided
        lanes re-initialize their device states every round), and tables
        growable to cover this round and the next."""
        if self._rank_set:
            return False  # a staged buffer would live on rank 0 only
        if self.scheduler.waiting:
            return False  # admission will change the lane set
        if self._ragged_dispatch and any(
            not s.prefill_done and not s.long_prefill_active
            for s in self.scheduler.running
        ):
            return False  # a long-lane runner is NOT a ragged lane: its
            # ring runs outside the round, so pure-decode staging stays
            # live under it
        if any(self._is_guided(s) for s in seqs):
            return False
        return self._reserve_next_round(seqs, k)

    def _stage_fingerprint(
        self, seqs: list[Sequence], k: int, advance: int = 0
    ) -> tuple:
        """State a staged buffer was built for, as observed at the NEXT
        dispatch: the same lanes in the same order, each exactly
        `advance` tokens further, tables untouched since the stage's
        growth and NO free() in between (the free epoch: freed block ids
        can be handed to another sequence). At stage time `advance` is
        the current round's K and `k` the staged round's predicted K.
        The lanes' adapter slots are part of it: an unload or reload
        between the stage and the dispatch that moves a slot breaks
        it."""
        return (
            tuple(s.request_id for s in seqs),
            tuple(s.num_tokens + advance for s in seqs),
            tuple(len(s.block_table) for s in seqs),
            self.block_manager.free_epoch,
            k,
            self._slots_key(seqs),
        )

    @staticmethod
    def _advance_stop(stop: tuple | None, k: int) -> tuple | None:
        """A round's device-stop arrays as the round K tokens later sees
        them (a lane that freezes earlier breaks the fingerprint, so the
        stale stage is never dispatched)."""
        if stop is None:
            return None
        return (stop[0], np.maximum(stop[1] - k, 0), stop[2] - k, stop[3])

    def _run_decode_round(
        self, seqs: list[Sequence], k_steps: int
    ) -> list[Sequence]:
        """One decode round over `seqs` (the split path's decode step and
        the ragged round's split execution): the fused K-step loop on the
        device when K > 1 (chained on a staged buffer when the prefetch
        prediction held, then staging the next round), else one forward
        with host-side sampling (penalties / logit bias / guided mask
        applied first). Guided lanes ride the fused loop on the device
        DFA tables; a lane near its token budget (its final steps need
        the host's completion steering) or a constraint too large to
        compile keeps the whole round on the host path. Returns the
        stepped lanes: none when the round went async (a later step
        resolves it)."""
        guided_tables = None
        needs_guided = any(self._is_guided(s) for s in seqs)
        if needs_guided and k_steps > 1:
            near_budget = any(
                self._is_guided(s)
                and (s.sampling_params.max_tokens
                     - len(s.generated_token_ids))
                <= k_steps + self.GUIDED_STEER_BOUND
                for s in seqs
            )
            if not near_budget:
                guided_tables = self._device_guided_tables(seqs)
        if k_steps > 1 and (not needs_guided or guided_tables is not None):
            temps, top_ps, top_ks, min_ps, keys, needs_pen = (
                self._sampling_arrays(seqs)
            )
            penalties = self._penalty_args(seqs) if needs_pen else None
            want_lp = any(
                s.sampling_params.logprobs is not None for s in seqs
            )
            bias = self._bias_arrays(seqs)
            will_async = (self._async_decode and penalties is None
                          and guided_tables is None and bias is None)
            # no device stops on a round the chain follows: the chain
            # commits round N+1 before round N's valid counts exist
            stop = (self._stop_arrays(seqs)
                    if self._device_stop and not will_async else None)
            tokens = [s.all_token_ids[-1] for s in seqs]
            slots = self._lora_slots(seqs)
            staged_kw = {}
            st = self._staged_decode
            self._staged_decode = None
            if st is not None:
                if (penalties is None and bias is None
                        and guided_tables is None
                        and st["fp"] == self._stage_fingerprint(
                            seqs, k_steps)):
                    # the prediction held: chain on the previous round's
                    # device tokens with the buffer already copied
                    staged_kw = {"staged": st["handle"]}
                    tokens = st["chain_tokens"]
                    self._staged_hits_total += 1
                else:
                    self._staged_misses_total += 1
            ys = self.runner.decode_multi(
                tokens,
                [s.num_tokens - 1 for s in seqs],
                [s.block_table for s in seqs],
                [s.num_tokens for s in seqs], k_steps,
                temps, top_ps, top_ks, keys, min_ps=min_ps,
                penalties=penalties, want_logprobs=want_lp,
                guided=guided_tables, logit_bias=bias, stop=stop,
                lora_slots=slots, **staged_kw,
            )
            if will_async:
                # the tokens stay on the device: the next step dispatches
                # the following round before fetching this one
                self._pending_decode = {
                    "seqs": list(seqs), "k": k_steps,
                    "toks": ys[0] if want_lp else ys,
                    "lps": ys[1:] if want_lp else None,
                }
                return []
            if (self._prefetch_decode and penalties is None
                    and guided_tables is None and bias is None
                    and self._can_stage(seqs, k_steps)):
                # stage round N+1 now: its copy rides out this round's
                # fetch. Its K is predicted and capped at this round's,
                # the most _reserve_next_round grew the tables for.
                nk = keys.copy()
                nk[:, 1] += k_steps
                k_next = min(
                    self.scheduler.pick_decode_k(seqs, advance=k_steps),
                    k_steps,
                )
                toks_dev = ys[0] if isinstance(ys, tuple) else ys
                self._staged_decode = {
                    "fp": self._stage_fingerprint(
                        seqs, k_next, advance=k_steps),
                    "handle": self.runner.stage_decode_multi(
                        [s.num_tokens - 1 + k_steps for s in seqs],
                        [s.block_table for s in seqs],
                        [s.num_tokens + k_steps for s in seqs],
                        k_next, temps, top_ps, top_ks, nk,
                        min_ps=min_ps,
                        stop=self._advance_stop(stop, k_steps),
                        lora_slots=slots,
                    ),
                    "chain_tokens": toks_dev[-1],
                }
            self._apply_fused_decode(seqs, k_steps, ys, want_lp,
                                     stop is not None)
            return list(seqs)
        if needs_guided:
            self._guided_host_rounds_total += 1
        tokens = [s.all_token_ids[-1] for s in seqs]
        positions = [s.num_tokens - 1 for s in seqs]
        tables = [s.block_table for s in seqs]
        ctx_lens = [s.num_tokens for s in seqs]
        logits = self.runner.decode(tokens, positions, tables, ctx_lens,
                                    lora_slots=self._lora_slots(seqs))
        sampled, used_logits = self._sample(
            seqs, logits[: len(seqs)], return_logits=True
        )
        want_lp = any(s.sampling_params.logprobs is not None for s in seqs)
        if want_lp:
            # stackcheck: disable=device-sync-transitive — the K=1
            # round's logprob rows ride its one fetch (JAX: the one intended
            # per-round materialization of the sampled-from logits)
            used_logits = np.asarray(_to_numpy(used_logits))
        stepped: list[Sequence] = []
        for i, (seq, token) in enumerate(zip(seqs, sampled)):
            seq.num_computed_tokens = seq.num_tokens
            entry = None
            if seq.sampling_params.logprobs is not None:
                entry = self._host_logprob_entry(
                    # stackcheck: disable=device-sync-transitive — host token
                    # (as below); the row was fetched just above
                    used_logits[i], int(token),
                    seq.sampling_params.logprobs,
                )
            # stackcheck: disable=device-sync-transitive — host token:
            # _sample (the not-hot host sampling seam) returned host ints
            self._append_token(seq, int(token), entry)
            stepped.append(seq)
        # adaptive K can size a round down to 1: it belongs in the
        # tpu:decode_k histogram too
        self._note_decode_round(seqs, 1)
        return stepped

    def _apply_fused_decode(self, seqs: list[Sequence], k_steps: int, ys,
                            want_lp: bool, with_stop: bool,
                            round_attrs: dict | None = None) -> None:
        """Fetch a fused round's device results in one place (the fetch
        phase meter) and apply them: ys as decode_multi returns it."""
        ys = ys if isinstance(ys, tuple) else (ys,)
        tf = time.perf_counter()
        host = [_to_numpy(a) for a in ys]
        self.runner._phase_add("fetch", time.perf_counter() - tf)
        valid = host.pop() if with_stop else None
        self._apply_multi_tokens(
            seqs, host[0], k_steps,
            lps=tuple(host[1:4]) if want_lp else None, valid=valid,
            round_attrs=round_attrs,
        )

    # stackcheck: not-hot — host-side token bookkeeping over numpy
    # arrays every caller already fetched at its metered fetch point
    def _apply_multi_tokens(
        self, seqs: list[Sequence], toks: np.ndarray, k: int,
        lps: tuple | None = None, valid: np.ndarray | None = None,
        round_attrs: dict | None = None,
    ) -> None:
        """Apply a fused round's (k, b) sampled tokens. `lps` = (chosen
        (k, b), top_vals (k, b, CAP), top_ids (k, b, CAP)) when a lane
        asked for logprobs. `valid` = the device-stop per-lane valid
        counts: rows at or past valid[lane] were frozen on the device and
        are skipped without counting as overshoot."""
        vcounts = valid[:len(seqs)].tolist() if valid is not None else None
        if vcounts and max(vcounts) < k:
            # every lane froze before the trip count: the loop exited
            self._decode_early_exit_rounds_total += 1
        for i in range(k):
            for j, seq in enumerate(seqs):
                if vcounts is not None and i >= vcounts[j]:
                    continue  # device-frozen rows: pad, never sampled
                if seq.finished:
                    # host-side stop (stop strings, guided completion, or
                    # the fixed-trip --no-device-stop loop): a sampled
                    # slot discarded
                    self._decode_overshoot_tokens_total += 1
                    continue
                seq.num_computed_tokens = seq.num_tokens
                entry = None
                n = seq.sampling_params.logprobs
                if lps is not None and n is not None:
                    chosen, tv, ti = lps
                    entry = {
                        "token_id": int(toks[i, j]),
                        "logprob": float(chosen[i, j]),
                        "top_logprobs": [
                            {"token_id": int(ti[i, j, m]),
                             "logprob": float(tv[i, j, m])}
                            for m in range(n)
                        ],
                    }
                self._append_token(seq, int(toks[i, j]), entry)
        if round_attrs:
            self._note_decode_round(seqs, k, extra_attrs=round_attrs)
        else:
            self._note_decode_round(seqs, k)

    def _note_decode_round(self, seqs: list[Sequence], k: int,
                           extra_attrs: dict | None = None) -> None:
        """Per-round decode accounting shared by the fused and the
        single-step paths: tpu:decode_rounds, the tpu:decode_k chosen-K
        histogram, and one SAMPLED timeline tick a request a round
        (tracing.DECODE_EVENT_EVERY) with the round's lane mix."""
        self._decode_rounds_total += 1
        self._decode_k_hist[k] = self._decode_k_hist.get(k, 0) + 1
        if self._tl_enabled:
            # a split decode round carries no prefill lanes; ragged rounds
            # override through extra_attrs
            attrs = {
                "k_chosen": k,
                "lanes_done": sum(1 for s in seqs if s.finished),
                "prefill_lanes": 0, "decode_lanes": len(seqs),
            }
            if extra_attrs:
                attrs.update(extra_attrs)
            for seq in seqs:
                if not seq.finished:
                    self.timeline.decode_round(seq.request_id, k,
                                               attrs=attrs)

    # -- speculative decoding (prompt-lookup n-gram drafts) ----------------
    # haystack bound for prompt-lookup: the scan runs per lane per round
    # on the step loop, so it is capped to a recent suffix (older matches
    # are stale context anyway)
    NGRAM_SCAN_WINDOW = 8192

    # stackcheck: not-hot — host n-gram matching over python token lists;
    # no device tensor reaches it
    def _ngram_drafts(self, seq: Sequence, k: int) -> list[int]:
        """Up to `k` draft tokens: the continuation of the LAST earlier
        occurrence of the context's trailing n-gram, longest n first
        (vLLM's ngram prompt lookup): no draft model, only the
        sequence's own tokens."""
        context = seq.all_token_ids[-self.NGRAM_SCAN_WINDOW:]
        arr = np.asarray(context, np.int32)
        cfg = self.config
        for n in range(cfg.ngram_prompt_lookup_max,
                       cfg.ngram_prompt_lookup_min - 1, -1):
            if len(arr) <= n:
                continue
            pattern = arr[-n:]
            win = np.lib.stride_tricks.sliding_window_view(arr, n)
            matches = np.nonzero((win == pattern).all(axis=1))[0]
            matches = matches[matches + n < len(arr)]  # need continuation
            if len(matches):
                i = int(matches[-1])
                return [int(t) for t in context[i + n: i + n + k]]
        return []

    def _try_spec_decode_batch(
        self, seqs: list[Sequence]
    ) -> list[Sequence] | None:
        """One speculative round over the whole decode batch; returns
        the stepped lanes, or None to run the normal decode round.

        Every lane's chunk [last_token, d_1..d_k] (zero-draft lanes feed
        their last token alone) runs in ONE packed verify forward whose
        every row is sampled on the device with the key sequential decode
        would use at that step, (seed, generated_len + j): acceptance by
        equality then yields exactly the sequential stream at any
        temperature. Eligibility is whole-batch: a lane that edits its
        logits each step (logprobs, a guided mask, penalties, logit_bias)
        sends the batch to the normal path. The round stages nothing, so
        no later round chains on it; a decode stage built before it
        misses by its fingerprint."""
        for s in seqs:
            sp = s.sampling_params
            if (
                sp.logprobs is not None
                or self._is_guided(s)
                or sp.logit_bias
                or sp.presence_penalty != 0.0
                or sp.frequency_penalty != 0.0
                or sp.repetition_penalty != 1.0
            ):
                return None
        k_cfg = self.config.num_speculative_tokens
        drafts_by_lane: list[list[int]] = []
        for s in seqs:
            n0 = s.num_tokens
            # drafts fit the KV layout and the generation budget, and the
            # k + 1 fed rows one prefill bucket
            k = min(
                k_cfg,
                self.scheduler.config.max_model_len - n0,
                s.sampling_params.max_tokens
                - len(s.generated_token_ids) - 1,
                self.config.max_prefill_chunk - 1,
            )
            d = self._ngram_drafts(s, k) if k > 0 else []
            if d and not self.block_manager.ensure_capacity(
                n0 + len(d), s.block_table
            ):
                d = []  # no room to grow: this lane rides draft-free
            drafts_by_lane.append(d)
        if not any(drafts_by_lane):
            return None
        chunks = [[s.all_token_ids[-1]] + d
                  for s, d in zip(seqs, drafts_by_lane)]
        temps, top_ps, top_ks, min_ps, _keys, _pen = (
            self._sampling_arrays(seqs))
        seeds = np.asarray(
            [self._seq_seed(s) & 0xFFFFFFFF for s in seqs], np.uint32)
        starts = np.asarray(
            [len(s.generated_token_ids) for s in seqs], np.int64)
        sampled = self.runner.verify_batch(
            chunks,
            start_positions=[s.num_tokens - 1 for s in seqs],
            block_tables=[s.block_table for s in seqs],
            total_lens=[s.num_tokens - 1 + len(c)
                        for s, c in zip(seqs, chunks)],
            row_sampling=(temps, top_ps, top_ks, min_ps, seeds, starts),
            lora_slots=self._lora_slots(seqs),
        )
        stepped: list[Sequence] = []
        for seq, drafts, row in zip(seqs, drafts_by_lane, sampled):
            accepted = 0
            for d in drafts:
                # stackcheck: disable=device-sync-transitive — row is
                # verify_batch's fetched numpy output
                if int(row[accepted]) != d:
                    break
                accepted += 1
            self._spec_drafts_total += len(drafts)
            self._spec_accepted_total += accepted
            # the accepted drafts, then the verify forward's own next
            # token (the correction on a mismatch, the bonus token on
            # full acceptance)
            # stackcheck: disable=device-sync-transitive — row is
            # verify_batch's fetched numpy output
            new_tokens = drafts[:accepted] + [int(row[accepted])]
            for t in new_tokens:
                if seq.finished:
                    break  # EOS / stop mid-acceptance: drop the rest
                seq.num_computed_tokens = seq.num_tokens
                # stackcheck: disable=device-sync-transitive — accepted tokens
                # are host ints
                self._append_token(seq, int(t))
            if self._tl_enabled and not seq.finished:
                self.timeline.decode_round(seq.request_id, len(new_tokens))
            stepped.append(seq)
        return stepped

    # -- unified ragged rounds ----------------------------------------------
    def _penalty_args(self, seqs: list[Sequence]) -> tuple:
        """(gen_lists, presence, frequency, repetition) for the fused
        decode loop."""
        pres = np.zeros((len(seqs),), np.float32)
        freq = np.zeros((len(seqs),), np.float32)
        rep = np.ones((len(seqs),), np.float32)
        for i, s in enumerate(seqs):
            pres[i] = s.sampling_params.presence_penalty
            freq[i] = s.sampling_params.frequency_penalty
            rep[i] = s.sampling_params.repetition_penalty
        return (
            [list(s.generated_token_ids) for s in seqs], pres, freq, rep,
        )

    def _ragged_prefill_fusable(self, works: list[PrefillWork]) -> bool:
        """Prefill lanes the fused round can serve: no prompt_logprobs
        lane (it scores every row on the single-sequence prefill) and no
        final chunk whose first token needs host sampling."""
        for w in works:
            if w.seq.sampling_params.prompt_logprobs is not None:
                return False
            if w.is_last_chunk and self._needs_host_first_sample(w.seq):
                return False
        return True

    def _step_ragged(self, works: list[PrefillWork], dwork) -> list[Sequence]:
        """One planned lane-typed round: prefill-chunk lanes + the decode
        batch in ONE ragged_dispatch when every lane is fusable, else
        split execution of the SAME plan (both halves still run this
        step). The decode half's guided gates are _run_decode_round's;
        the fused round also takes K = 1 rounds on the DFA tables."""
        seqs, k_steps = dwork.seqs, dwork.k
        guided_tables = None
        fusable = True
        if any(self._is_guided(s) for s in seqs):
            near_budget = any(
                self._is_guided(s)
                and (s.sampling_params.max_tokens
                     - len(s.generated_token_ids))
                <= k_steps + self.GUIDED_STEER_BOUND
                for s in seqs
            )
            if near_budget:
                fusable = False
            else:
                guided_tables = self._device_guided_tables(seqs)
                fusable = guided_tables is not None
        if fusable:
            fusable = self._ragged_prefill_fusable(works)
        if not fusable:
            self._ragged_split_rounds_total += 1
            if self._staged_ragged is not None:
                # the stage expects the fused round: a counted miss
                self._ragged_staged_misses_total += 1
                self._staged_ragged = None
            stepped = self._run_prefill_works(works)
            stepped.extend(self._run_decode_round(seqs, k_steps))
            return stepped
        return self._dispatch_ragged(works, seqs, k_steps, guided_tables)

    def _dispatch_ragged(self, works: list[PrefillWork],
                         seqs: list[Sequence], k_steps: int,
                         guided_tables: tuple | None = None,
                         ) -> list[Sequence]:
        """The fused lane-typed round: one packed buffer (staged ahead
        when the prediction held), one dispatch, the next round staged
        before any fetch, then the prefill bookkeeping and the shared
        fused-decode bookkeeping."""
        now = time.time()
        if self._staged_prefill is not None:
            # a pure-prefill round was staged but the round went
            # lane-typed: the prefill stage cannot serve it
            self._pf_staged_misses_total += 1
            self._staged_prefill = None
            self.scheduler.staged_prefill_ready = False
        for w in works:
            if w.seq.metrics.first_scheduled_time is None:
                w.seq.metrics.first_scheduled_time = now
        phase_snap = (
            self.runner.phase_snapshot() if self._tl_enabled else None
        )
        pf_sampling = self._sampling_arrays([w.seq for w in works])[:5]
        temps, top_ps, top_ks, min_ps, keys, needs_pen = (
            self._sampling_arrays(seqs)
        )
        penalties = self._penalty_args(seqs) if needs_pen else None
        want_lp = any(s.sampling_params.logprobs is not None for s in seqs)
        bias = self._bias_arrays(seqs)
        stop = self._stop_arrays(seqs) if self._device_stop else None
        tokens = [s.all_token_ids[-1] for s in seqs]
        staged_kw = {}
        st = self._staged_ragged
        self._staged_ragged = None
        if st is not None:
            if (penalties is None and bias is None
                    and guided_tables is None
                    and st["fp"] == self._ragged_fingerprint(
                        works, seqs, k_steps)):
                # the prediction held: the decode lanes chain on the
                # previous round's device tokens, the buffer is copied
                staged_kw = {"staged": st["handle"]}
                tokens = st["chain_tokens"]
                self._ragged_staged_hits_total += 1
            else:
                # lane mix or state drifted since the stage (the runner
                # also checks the buffer's total length): a counted
                # miss, the dispatch builds and uploads its own
                self._ragged_staged_misses_total += 1
        pf_sampled, pf_logits, ys = self.runner.ragged_dispatch(
            [w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
             for w in works],
            [w.chunk_start for w in works],
            [w.seq.block_table for w in works],
            [w.chunk_start + w.chunk_len for w in works],
            tokens,
            [s.num_tokens - 1 for s in seqs],
            [s.block_table for s in seqs],
            [s.num_tokens for s in seqs],
            k_steps, temps, top_ps, top_ks, keys, min_ps=min_ps,
            pf_sampling=pf_sampling, penalties=penalties,
            want_logprobs=want_lp, guided=guided_tables, logit_bias=bias,
            stop=stop,
            pf_lora_slots=self._lora_slots([w.seq for w in works]),
            lora_slots=self._lora_slots(seqs), **staged_kw,
        )
        # stage the predicted NEXT ragged round before any fetch below,
        # so its copy overlaps this round
        self._maybe_stage_ragged(
            works, seqs, k_steps, temps, top_ps, top_ks, keys, min_ps,
            stop, penalties, bias, guided_tables,
            ys[0] if isinstance(ys, tuple) else ys,
        )
        stepped: list[Sequence] = []
        for w in works:
            w.seq.num_computed_tokens += w.chunk_len
            self._prompt_tokens_total += w.chunk_len
        if self._tl_enabled:
            phases = self.runner.phase_delta(phase_snap)
            for w in works:
                self.timeline.event(
                    w.seq.request_id, "prefill_chunk",
                    {
                        "chunk_start": w.chunk_start,
                        "chunk_len": w.chunk_len,
                        "last": w.is_last_chunk,
                        "staged_hit": len(staged_kw) > 0,
                        "chained": False,
                        "group_size": len(works),
                        "ragged": True,
                        "prefill_lanes": len(works),
                        "decode_lanes": len(seqs),
                        **({"group_phase_s": phases} if phases else {}),
                    },
                )
        finals = [(i, w) for i, w in enumerate(works) if w.is_last_chunk]
        if finals:
            tf = time.perf_counter()
            toks_np = _to_numpy(pf_sampled)  # ONE fetch for the lanes
            self.runner._phase_add("fetch", time.perf_counter() - tf)
            for i, w in finals:
                # stackcheck: disable=device-sync-transitive — an element of
                # the ragged round's one prefill-token fetch, already on the
                # host
                tok = int(toks_np[i])
                if tok < 0:
                    # only non-real lanes are pinned to the idle
                    # sentinel: a real lane with it means the lane
                    # packing drifted
                    raise RuntimeError(
                        f"ragged dispatch returned the idle-lane sentinel "
                        f"for real prefill lane {i} ({w.seq.request_id})"
                    )
                entry = None
                n = w.seq.sampling_params.logprobs
                if n is not None:
                    entry = self._host_logprob_entry(
                        _to_numpy(pf_logits[i]), tok, n
                    )
                self._append_token(w.seq, tok, entry)
                stepped.append(w.seq)
        self._apply_fused_decode(
            seqs, k_steps, ys, want_lp, stop is not None,
            round_attrs={"prefill_lanes": len(works),
                         "decode_lanes": len(seqs)},
        )
        stepped.extend(seqs)
        self._note_ragged_round(len(works), len(seqs))
        return stepped

    def _note_ragged_round(self, n_pf: int, n_dec: int) -> None:
        """Fused lane-typed round accounting: tpu:ragged_rounds, the lane
        totals and the tpu:ragged_lane_mix feed."""
        self._ragged_rounds_total += 1
        self._ragged_prefill_lanes_total += n_pf
        self._ragged_decode_lanes_total += n_dec
        self._ragged_obs.append(n_pf)

    def drain_ragged_observations(self) -> list[int]:
        """Prefill-lane counts of fused ragged rounds since the last
        drain, for the server's tpu:ragged_lane_mix histogram (deque pops
        are GIL-atomic)."""
        out: list[int] = []
        while True:
            try:
                out.append(self._ragged_obs.popleft())
            except IndexError:
                break
        return out

    def _predict_next_prefill_works(
        self, works: list[PrefillWork]
    ) -> list[PrefillWork]:
        """The chunk set of the round AFTER `works`, predicted before
        this round's bookkeeping lands (the ragged stage starts while
        the dispatch is in flight): each non-final lane advances by its
        own chunk."""
        nxt: list[PrefillWork] = []
        chunked = self.scheduler.config.enable_chunked_prefill
        for w in works:
            s = w.seq
            if s.sampling_params.prompt_logprobs is not None:
                continue
            start = w.chunk_start + w.chunk_len
            rem = s.num_prompt_tokens - start
            if rem <= 0:
                continue
            clen = (min(rem, self.scheduler.config.max_prefill_chunk)
                    if chunked else rem)
            nxt.append(PrefillWork(seq=s, chunk_start=start,
                                   chunk_len=clen))
        return nxt

    def _ragged_fingerprint(
        self, works: list[PrefillWork], seqs: list[Sequence], k: int
    ) -> tuple:
        """State a staged ragged buffer was built for, as observed at
        dispatch: the prefill lanes' fingerprint, the decode lanes in
        order at exact token counts and table lengths, the free epoch
        and the round's K, and both lane sets' adapter slots. Any
        lane-mix change — a prefill lane finishing, an admission, another
        adaptive K — breaks it."""
        return (
            self._prefill_fingerprint(works),
            tuple(s.request_id for s in seqs),
            tuple(s.num_tokens for s in seqs),
            tuple(len(s.block_table) for s in seqs),
            self.block_manager.free_epoch,
            k,
            self._slots_key(seqs),
        )

    def _maybe_stage_ragged(
        self, works, seqs, k_steps, temps, top_ps, top_ks, keys, min_ps,
        stop, penalties, bias, guided_tables, toks_dev,
    ) -> None:
        """Stage the PREDICTED next lane-typed round: prefill lanes
        advance by their chunk, decode lanes chain on this round's
        device tokens advanced by K. Validated by fingerprint, and by
        the runner's bucket key and total length, before use."""
        if not (self._prefetch_decode and self._prefill_pipeline):
            return
        if (penalties is not None or bias is not None
                or guided_tables is not None):
            return  # per-round host state does not chain
        if self.scheduler.waiting:
            return  # admission will change the lane set
        if any(w.is_last_chunk for w in works):
            # a finishing prefill lane moves to the decode side next
            # round: the lane mix changes by construction
            return
        nxt = self._predict_next_prefill_works(works)
        if not nxt:
            return
        if not self._reserve_next_round(seqs, k_steps):
            return
        k_next = min(
            self.scheduler.pick_decode_k(seqs, advance=k_steps), k_steps,
        )
        nk = keys.copy()
        nk[:, 1] += k_steps
        handle = self.runner.stage_ragged(
            [w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
             for w in nxt],
            [w.chunk_start for w in nxt],
            [w.seq.block_table for w in nxt],
            [w.chunk_start + w.chunk_len for w in nxt],
            self._sampling_arrays([w.seq for w in nxt])[:5],
            [s.num_tokens - 1 + k_steps for s in seqs],
            [s.block_table for s in seqs],
            [s.num_tokens + k_steps for s in seqs],
            k_next, temps, top_ps, top_ks, nk, min_ps=min_ps,
            stop=self._advance_stop(stop, k_steps),
            pf_lora_slots=self._lora_slots([w.seq for w in nxt]),
            lora_slots=self._lora_slots(seqs),
        )
        self._staged_ragged = {
            "fp": (
                self._prefill_fingerprint(nxt),
                tuple(s.request_id for s in seqs),
                tuple(s.num_tokens + k_steps for s in seqs),
                tuple(len(s.block_table) for s in seqs),
                self.block_manager.free_epoch,
                k_next,
                self._slots_key(seqs),
            ),
            "handle": handle,
            "chain_tokens": toks_dev[-1],
        }

    # -- pipelined prefill -----------------------------------------------------
    def _prefill_fingerprint(self, works: list[PrefillWork]) -> tuple:
        """State a staged prefill buffer was built for, as observed at
        dispatch: the same sequences in the same order at the same chunk
        offsets, tables untouched (length + the free epoch), no token
        appended since the stage (the sampling keys hold the generated
        length) and the same adapter slots."""
        return (
            tuple(w.seq.request_id for w in works),
            tuple(w.chunk_start for w in works),
            tuple(w.chunk_len for w in works),
            tuple(len(w.seq.block_table) for w in works),
            tuple(len(w.seq.generated_token_ids) for w in works),
            self.block_manager.free_epoch,
            self._slots_key([w.seq for w in works]),
        )

    def _next_prefill_works(
        self, works: list[PrefillWork]
    ) -> list[PrefillWork]:
        """The predicted chunk set after `works` completes: the same
        sequences (order kept) that still have prompt left. prompt_logprobs
        sequences are left out: their per-chunk fetches serialize
        anyway."""
        nxt: list[PrefillWork] = []
        chunked = self.scheduler.config.enable_chunked_prefill
        for w in works:
            s = w.seq
            if s.finished or s not in self.scheduler.running:
                continue
            if s.sampling_params.prompt_logprobs is not None:
                continue
            rem = s.num_uncomputed_prompt_tokens
            if rem <= 0:
                continue
            clen = (min(rem, self.scheduler.config.max_prefill_chunk)
                    if chunked else rem)
            nxt.append(PrefillWork(seq=s, chunk_start=s.num_computed_tokens,
                                   chunk_len=clen))
        return nxt

    def _chain_next_prefill(
        self, works: list[PrefillWork]
    ) -> list[PrefillWork] | None:
        """Chained multi-chunk dispatch: when every scheduled chunk was
        non-final and NOTHING is decode-ready or waiting, the group's
        next chunks run in this same engine step — no scheduler pass
        between a cold prompt's chunks, each chunk's upload overlapping
        the previous chunk's compute. Only the final chunk's sampled
        token is fetched."""
        if not self._prefill_pipeline:
            return None
        if any(w.is_last_chunk for w in works):
            return None  # finals made their sequences decode-ready
        if any(w.seq.sampling_params.prompt_logprobs is not None
               for w in works):
            return None
        if self.scheduler.waiting:
            return None  # admission may pack new arrivals into the group
        if any(s.prefill_done and not s.finished
               for s in self.scheduler.running):
            return None  # a decode stream would starve: interleave
        return self._next_prefill_works(works) or None

    def _maybe_stage_prefill(self, works: list[PrefillWork]) -> None:
        """Stage the predicted next chunk group's packed buffer, so its
        copy rides out the interleaved decode round instead of sitting
        before the next prefill dispatch; validated by fingerprint
        before use."""
        if not self._prefill_pipeline or self._rank_set:
            return  # in a rank set a stage would live on rank 0 only
        if self.scheduler.waiting:
            return  # the next group will include new admissions
        if self._ragged_dispatch and any(
            s.prefill_done and not s.finished
            for s in self.scheduler.running
        ):
            # a decode-ready lane exists: the next round is lane-typed
            # and consumes the RAGGED stage, never this one
            return
        nxt = self._next_prefill_works(works)
        if not nxt:
            return
        sampling = self._sampling_arrays([w.seq for w in nxt])[:5]
        chunks = [
            w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
            for w in nxt
        ]
        slots = self._lora_slots([w.seq for w in nxt])
        if len(nxt) == 1:
            w = nxt[0]
            handle = self.runner.stage_prefill(
                chunks[0], w.chunk_start, w.seq.block_table,
                w.chunk_start + w.chunk_len, sampling=sampling,
                lora_slot=slots[0] if slots else 0,
            )
        else:
            handle = self.runner.stage_prefill_batch(
                chunks,
                start_positions=[w.chunk_start for w in nxt],
                block_tables=[w.seq.block_table for w in nxt],
                total_lens=[w.chunk_start + w.chunk_len for w in nxt],
                sampling=sampling, lora_slots=slots,
            )
        self._staged_prefill = {"fp": self._prefill_fingerprint(nxt),
                                "handle": handle}
        self.scheduler.staged_prefill_ready = True

    def _run_prefill_works(
        self, works: list[PrefillWork], staged: dict | None = None,
        chained: bool = False,
    ) -> list[Sequence]:
        """Dispatch one scheduled prefill chunk group: prompt_logprobs
        sequences on the single-sequence prefill that scores every row on
        the device, the others on the single-sequence forward (one) or
        one packed forward (several); first tokens (sampled on the
        device) are appended for final chunks. `staged` = a
        _maybe_stage_prefill record, used when its fingerprint matches
        this exact group (else a counted miss). `chained` marks a group
        dispatched by cold-prompt chaining, for the timeline."""
        stepped: list[Sequence] = []
        now = time.time()
        for w in works:
            if w.seq.metrics.first_scheduled_time is None:
                w.seq.metrics.first_scheduled_time = now
        phase_snap = (
            self.runner.phase_snapshot() if self._tl_enabled else None
        )
        staged_kw = {}
        if staged is not None:
            if staged["fp"] == self._prefill_fingerprint(works):
                # the prediction held: the buffer's copy already ran
                staged_kw = {"staged": staged["handle"]}
                self._pf_staged_hits_total += 1
            else:
                self._pf_staged_misses_total += 1
                self.scheduler.note_staged_prefill_miss()
        plp_works = [(i, w) for i, w in enumerate(works)
                     if w.seq.sampling_params.prompt_logprobs is not None]
        std_works = [(i, w) for i, w in enumerate(works)
                     if w.seq.sampling_params.prompt_logprobs is None]
        last_logits: dict[int, torch.Tensor] = {}
        tok_of: dict[int, int] = {}  # index in works -> sampled token
        for i, w in plp_works:
            seq = w.seq
            chunk = seq.prompt_token_ids[
                w.chunk_start:w.chunk_start + w.chunk_len]
            # row j scores the NEXT prompt token; the final chunk's last
            # row has none (its continuation is generated)
            tgts = seq.prompt_token_ids[
                w.chunk_start + 1:w.chunk_start + w.chunk_len + 1]
            slots = self._lora_slots([seq])
            token_dev, logits, chosen, tv, ti = self.runner.prefill(
                chunk, start_pos=w.chunk_start,
                block_table=seq.block_table,
                total_len=w.chunk_start + w.chunk_len,
                sampling=self._sampling_arrays([seq])[:5],
                lora_slot=slots[0] if slots else 0,
                # stackcheck: disable=device-sync-transitive — prompt ids,
                # a host list
                prompt_lp_targets=[int(x) for x in tgts],
            )
            tf = time.perf_counter()
            # the lane's one fetch: its token and the (t, CAP) scores
            # stackcheck: disable=device-sync-transitive — the prompt-
            # logprob lane's one fetch: its token (JAX: the same lane's
            # int(np.asarray(token_dev)) fetch)
            tok_of[i] = int(_to_numpy(token_dev))
            chosen, tv, ti = _to_numpy(chosen), _to_numpy(tv), _to_numpy(ti)
            self.runner._phase_add("fetch", time.perf_counter() - tf)
            last_logits[i] = logits
            self._accumulate_prompt_lps(seq, w.chunk_start, tgts, chosen,
                                        tv, ti)
        if std_works:
            sworks = [w for _, w in std_works]
            seqs_w = [w.seq for w in sworks]
            sampling = self._sampling_arrays(seqs_w)[:5]
            chunks = [
                w.seq.prompt_token_ids[
                    w.chunk_start:w.chunk_start + w.chunk_len]
                for w in sworks
            ]
            slots = self._lora_slots(seqs_w)
            if len(sworks) == 1:
                w = sworks[0]
                token_dev, logits = self.runner.prefill(
                    chunks[0],
                    start_pos=w.chunk_start,
                    block_table=w.seq.block_table,
                    total_len=w.chunk_start + w.chunk_len,
                    sampling=sampling, lora_slot=slots[0] if slots else 0,
                    **staged_kw,
                )
                tokens_dev = token_dev[None]
                last_logits[std_works[0][0]] = logits
            else:
                tokens_dev, logits = self.runner.prefill_batch(
                    chunks,
                    start_positions=[w.chunk_start for w in sworks],
                    block_tables=[w.seq.block_table for w in sworks],
                    total_lens=[w.chunk_start + w.chunk_len
                                for w in sworks],
                    sampling=sampling, lora_slots=slots, **staged_kw,
                )
                for j, (i, _) in enumerate(std_works):
                    last_logits[i] = logits[j]
            if any(w.is_last_chunk for w in sworks):
                tf = time.perf_counter()
                toks_np = _to_numpy(tokens_dev)  # ONE fetch for the group
                self.runner._phase_add("fetch", time.perf_counter() - tf)
                for j, (i, _) in enumerate(std_works):
                    # stackcheck: disable=device-sync-transitive — an element
                    # of the group's one fetch, already on the host
                    tok_of[i] = int(toks_np[j])
        for w in works:
            w.seq.num_computed_tokens += w.chunk_len
            self._prompt_tokens_total += w.chunk_len
        if self._tl_enabled:
            # one event a chunk, with the dispatch group's per-phase wall
            # time (the group shares one dispatch)
            phases = self.runner.phase_delta(phase_snap)
            for w in works:
                self.timeline.event(
                    w.seq.request_id, "prefill_chunk",
                    {
                        "chunk_start": w.chunk_start,
                        "chunk_len": w.chunk_len,
                        "last": w.is_last_chunk,
                        "staged_hit": len(staged_kw) > 0,
                        "chained": chained,
                        "group_size": len(works),
                        "prefill_lanes": len(works),
                        "decode_lanes": 0,
                        **({"group_phase_s": phases} if phases else {}),
                    },
                )
        finals = [(i, w) for i, w in enumerate(works) if w.is_last_chunk]
        # guided lanes, logit bias, and a post-preemption sequence with
        # active penalties (its generated history is folded into the
        # prompt) sample their first token on the host
        pen = [(i, w) for i, w in finals
               if self._needs_host_first_sample(w.seq)]
        for i, w in finals:
            if self._needs_host_first_sample(w.seq):
                continue
            entry = None
            n = w.seq.sampling_params.logprobs
            if n is not None:
                entry = self._host_logprob_entry(
                    _to_numpy(last_logits[i]), tok_of[i], n
                )
            self._append_token(w.seq, tok_of[i], entry)
            stepped.append(w.seq)
        if pen:
            rows = torch.stack([last_logits[i] for i, _ in pen])
            sampled, used_logits = self._sample(
                [w.seq for _, w in pen], rows, return_logits=True
            )
            used_logits = _to_numpy(used_logits)
            for j, ((_, w), token) in enumerate(zip(pen, sampled)):
                entry = None
                n = w.seq.sampling_params.logprobs
                if n is not None:
                    entry = self._host_logprob_entry(
                        # stackcheck: disable=device-sync-transitive — host
                        # token (as below); the row was fetched by the
                        # _to_numpy above
                        used_logits[j], int(token), n
                    )
                # stackcheck: disable=device-sync-transitive — host token:
                # _sample (the not-hot host sampling seam) returned host ints
                self._append_token(w.seq, int(token), entry)
                stepped.append(w.seq)
        return stepped

    def _needs_host_first_sample(self, s: Sequence) -> bool:
        """A final prefill chunk whose first token cannot be taken from
        the on-device sample: a guided mask, logit_bias, or non-empty
        penalty state after a preemption recompute."""
        sp = s.sampling_params
        if self._is_guided(s):
            return True  # the first token must be masked
        if sp.logit_bias:
            return True  # the on-device sample knows no bias
        return len(s.generated_token_ids) > 0 and (
            sp.presence_penalty != 0.0
            or sp.frequency_penalty != 0.0
            or sp.repetition_penalty != 1.0
        )

    def _finalize_stepped(
        self, stepped: list[Sequence]
    ) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        for seq in stepped:
            self._register_full_blocks(seq)
            outputs.append(self._make_output(seq))
            if seq.finished:
                seq.metrics.finished_time = time.time()
                self._finished_total += 1
                self.scheduler.free_finished(seq)
                self._seqs.pop(seq.request_id, None)
                self.timeline.finish(
                    seq.request_id, seq.finish_reason,
                    {
                        "generated_tokens": len(seq.generated_token_ids),
                        "preemptions": seq.metrics.num_preemptions,
                    } if self._tl_enabled else None,
                )
        return outputs

    # -- internals ---------------------------------------------------------
    def _sampling_arrays(
        self, seqs: list[Sequence], b: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
               np.ndarray, bool]:
        """Per-lane sampling parameter arrays + whether any sequence needs
        logit penalties. Key = (seed, generated_len)."""
        b = b if b is not None else len(seqs)
        temps = np.zeros((b,), np.float32)
        top_ps = np.ones((b,), np.float32)
        top_ks = np.full((b,), -1, np.int32)
        min_ps = np.zeros((b,), np.float32)
        keys = np.zeros((b, 2), np.uint32)
        needs_penalties = False
        for i, s in enumerate(seqs):
            sp = s.sampling_params
            temps[i] = sp.temperature
            top_ps[i] = sp.top_p
            top_ks[i] = sp.top_k
            min_ps[i] = sp.min_p
            if (
                sp.presence_penalty != 0.0
                or sp.frequency_penalty != 0.0
                or sp.repetition_penalty != 1.0
            ):
                needs_penalties = True
            keys[i] = (
                np.uint32(self._seq_seed(s) & 0xFFFFFFFF),
                np.uint32(len(s.generated_token_ids)),
            )
        return temps, top_ps, top_ks, min_ps, keys, needs_penalties

    # stackcheck: hot-path — host arrays for the fused decode dispatch:
    # one pass over the batch, no device work
    def _stop_arrays(
        self, seqs: list[Sequence]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
        """Per-lane device-stop arrays for decode_multi / ragged_dispatch:
        (eos, min_rem, budget, stop_ids|None). eos is -1 under ignore_eos
        (or an EOS-less tokenizer); min_rem / budget are this round's
        countdowns of the host's min_tokens and max_tokens + max_model_len
        gates (Sequence.check_stop); stop_ids pads each lane's
        stop_token_ids to the batch's pow2 cap (>= 4) with -1. Stop
        STRINGS stay host-resolved."""
        b = len(seqs)
        eos = np.full((b,), -1, np.int32)
        min_rem = np.zeros((b,), np.int32)
        budget = np.zeros((b,), np.int32)
        mml = self.scheduler.config.max_model_len
        max_ids = 0
        for i, s in enumerate(seqs):
            sp = s.sampling_params
            if not sp.ignore_eos and s.eos_token_id is not None:
                # stackcheck: disable=device-sync-hot — a request's EOS id,
                # a host int
                eos[i] = int(s.eos_token_id)
            gen = len(s.generated_token_ids)
            min_rem[i] = max(0, sp.min_tokens - gen)
            # scheduled lanes are unfinished, so both terms are >= 1
            budget[i] = max(1, min(sp.max_tokens - gen, mml - s.num_tokens))
            if sp.stop_token_ids:
                max_ids = max(max_ids, len(sp.stop_token_ids))
        stop_ids = None
        if max_ids:
            cap = max(4, 1 << (max_ids - 1).bit_length())
            stop_ids = np.full((b, cap), -1, np.int32)
            for i, s in enumerate(seqs):
                ids = list(s.sampling_params.stop_token_ids or ())
                if ids:
                    stop_ids[i, :len(ids)] = ids
        return eos, min_rem, budget, stop_ids

    @staticmethod
    def _bias_arrays(
        seqs: list[Sequence],
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Per-lane OpenAI logit_bias as dense (b, cap) id / value arrays
        (cap: the pow2 bucket of the largest map, >= 8), or None when no
        lane has one; padding adds 0.0 to token 0."""
        maxn = max(len(s.sampling_params.logit_bias or {}) for s in seqs)
        if maxn == 0:
            return None
        cap = max(8, 1 << (maxn - 1).bit_length())
        ids = np.zeros((len(seqs), cap), np.int32)
        vals = np.zeros((len(seqs), cap), np.float32)
        for i, sq in enumerate(seqs):
            for j, (t, v) in enumerate(
                (sq.sampling_params.logit_bias or {}).items()
            ):
                ids[i, j] = t
                vals[i, j] = v
        return ids, vals

    def _seq_seed(self, s: Sequence) -> int:
        sp = s.sampling_params
        return (
            sp.seed
            if sp.seed is not None
            else (self.config.seed ^ (hash(s.request_id) & 0x7FFFFFFF))
        )

    # -- structured output (guided choice / json / regex / grammar) --------
    @staticmethod
    def _is_guided(seq: Sequence) -> bool:
        return (
            getattr(seq, "_guided_choices", None) is not None
            or getattr(seq, "_guided_machine", None) is not None
        )

    def _mask_cache(self):
        """Lazy per-engine vocab trie for constraint masking."""
        mc = getattr(self, "_token_mask_cache", None)
        if mc is None:
            from production_stack_tpu_torch.engine.structured import (
                TokenMaskCache,
            )

            mc = TokenMaskCache(self.tokenizer)
            self._token_mask_cache = mc
        return mc

    def _guided_allowed(self, seq: Sequence) -> set[int] | None:
        """Tokens the constraint allows next, or None when the sequence
        is unconstrained."""
        machine = getattr(seq, "_guided_machine", None)
        if machine is not None:
            if getattr(seq, "_guided_dead", False):
                # the constraint blew up earlier for THIS request: the
                # only legal move is to stop
                return (
                    {int(seq.eos_token_id)}
                    if seq.eos_token_id is not None else set()
                )
            states = seq._guided_state
            try:
                allowed = set(self._mask_cache().allowed(machine, states))
            except ValueError as e:
                # fail ONLY this request: a per-lane constraint blow-up
                # must never abort the engine step
                logger.warning(
                    "guided constraint diverged for %s mid-generation "
                    "(%s); ending the stream", seq.request_id, e,
                )
                seq._guided_dead = True  # type: ignore[attr-defined]
                return (
                    {int(seq.eos_token_id)}
                    if seq.eos_token_id is not None else set()
                )
            # budget-aware completion steering: with only a few budget
            # tokens left, keep only moves from which the machine can
            # still accept within what remains
            remaining = (seq.sampling_params.max_tokens
                         - len(seq.generated_token_ids))
            if 0 < remaining <= self.GUIDED_STEER_BOUND:
                steered = self._steer_allowed(
                    machine, states, allowed, remaining
                )
                if steered is not None:
                    allowed = steered
            if machine.accepting(states) and seq.eos_token_id is not None:
                allowed.add(int(seq.eos_token_id))
            if not allowed and seq.eos_token_id is not None:
                # dead end (should not happen for live machines)
                allowed.add(int(seq.eos_token_id))
            return allowed
        choices = getattr(seq, "_guided_choices", None)
        if choices is None:
            return None
        g = list(seq.generated_token_ids)
        allowed = set()
        complete = False
        for ids in choices:
            if len(ids) > len(g) and list(ids[: len(g)]) == g:
                allowed.add(int(ids[len(g)]))
            elif list(ids) == g:
                complete = True
        if complete and allowed and seq.eos_token_id is not None:
            # a complete choice that a longer one still extends ("go" vs
            # "gone"): EOS is the stop-here option the model may take
            allowed.add(int(seq.eos_token_id))
        return allowed

    # budget window (tokens) in which constraint steering engages; also
    # the margin by which guided lanes leave the fused device path so
    # their final steered steps run host-masked (unsteered steps mask
    # identically on both paths)
    GUIDED_STEER_BOUND = 8
    # frontier cap for the completion-distance search: a node offering
    # more distinct next strings than this is too wide to steer
    GUIDED_STEER_FANOUT = 128

    # stackcheck: not-hot — host-side BFS over a constraint machine, run
    # only in a guided request's final GUIDED_STEER_BOUND tokens
    def _dist_to_accept(self, machine, states, cap: int) -> int | None:
        """Shortest number of further tokens from `states` to an
        accepting state (token-level BFS, deduped by token string), or
        None when none is reachable within `cap` tokens or the frontier
        is too wide. Memoized per live machine object (weak-keyed)."""
        import weakref

        memos = getattr(self, "_guided_dist_memo", None)
        if memos is None:
            memos = weakref.WeakKeyDictionary()
            self._guided_dist_memo = memos
        memo = memos.get(machine)
        if memo is None:
            memo = {}
            memos[machine] = memo
        cached = memo.get(states)
        if cached is not None:
            dist, searched_cap = cached
            if dist is not None or cap <= searched_cap:
                return dist
        mc = self._mask_cache()
        if machine.accepting(states):
            memo[states] = (0, cap)
            return 0
        seen = {states}
        frontier = [states]
        for d in range(1, cap + 1):
            nxt = []
            for st in frontier:
                try:
                    allowed = mc.allowed(machine, st)
                except ValueError:
                    continue  # diverging constraint: unsearchable here
                strs = {mc.token_str(t) for t in allowed}
                strs.discard("")
                if len(strs) > self.GUIDED_STEER_FANOUT:
                    memo[states] = (None, cap)
                    return None
                for tok_s in strs:
                    try:
                        ns = machine.step_str(st, tok_s)
                    except ValueError:
                        continue
                    if not ns or ns in seen:
                        continue
                    if machine.accepting(ns):
                        memo[states] = (d, cap)
                        return d
                    seen.add(ns)
                    nxt.append(ns)
            if not nxt:
                break
            frontier = nxt
        memo[states] = (None, cap)
        return None

    def _steer_allowed(
        self, machine, states, allowed: set[int], remaining: int,
    ) -> set[int] | None:
        """Subset of `allowed` whose successor states can still accept
        within `remaining - 1` further tokens, or None when steering is
        infeasible (the caller keeps the unsteered mask)."""
        mc = self._mask_cache()
        by_str: dict[str, list[int]] = {}
        for t in allowed:
            by_str.setdefault(mc.token_str(t), []).append(t)
        by_str.pop("", None)
        if len(by_str) > self.GUIDED_STEER_FANOUT:
            return None
        keep: set[int] = set()
        for tok_s, ids in by_str.items():
            try:
                ns = machine.step_str(states, tok_s)
            except ValueError:
                continue
            if not ns:
                continue
            d = self._dist_to_accept(machine, ns, remaining - 1)
            if d is not None and d <= remaining - 1:
                keep.update(ids)
        return keep or None

    # stackcheck: not-hot — host table assembly for a round with guided
    # lanes: cached per set of live constraints, a dict probe a round
    def _device_guided_tables(self, seqs: list[Sequence]):
        """TokenDFA tables of a round with guided lanes, for the runner's
        fused loop: (cache_token, init_states (b,), lane_map (b,),
        token_class (M, V) int32, class_mask (S, C) bool, class_trans
        (S, C) int32), or None when a lane's constraint is too large to
        compile under budget or its state was never enumerated (the
        caller keeps the host path). Unguided lanes ride a shared
        allow-everything machine, the last real row."""
        from production_stack_tpu_torch.engine.structured import (
            get_token_dfa,
        )

        vocab = self.runner.model_config.vocab_size
        mask_cache = self._mask_cache()
        lane_dfas: list = []
        for s in seqs:
            machine = getattr(s, "_guided_machine", None)
            choices = getattr(s, "_guided_choices", None)
            if machine is None and choices is None:
                lane_dfas.append(None)
                continue
            # a missing EOS id is legal for guided_choice: -1 never lands
            # in the vocab-range EOS column
            eos = (int(s.eos_token_id)
                   if s.eos_token_id is not None else -1)
            dfa = get_token_dfa(
                machine if machine is not None else choices,
                mask_cache, vocab, eos,
            )
            if dfa is None:
                return None  # over budget (or diverging): host path
            lane_dfas.append(dfa)

        distinct: list = []
        for d in lane_dfas:
            if d is not None and all(d is not x for x in distinct):
                distinct.append(d)
        # order-invariant identity: reordering the running lanes must not
        # rebuild the tables or their device copies
        distinct.sort(key=lambda d: d.serial)
        n_real = len(distinct) + 1
        offsets: dict[int, int] = {}
        off = 0
        for d in distinct:
            offsets[id(d)] = off
            off += d.num_states
        free_state = off
        s_total = off + 1
        c_max = max([d.num_classes for d in distinct] + [1])
        s_pad = 1 << (s_total - 1).bit_length()
        c_pad = 1 << (c_max - 1).bit_length()
        m_pad = 1 << (n_real - 1).bit_length()
        # identity by TokenDFA.serial, never id(): ids recycle once the
        # structured module's LRU drops a DFA
        cache_token = (
            tuple(d.serial for d in distinct), s_pad, c_pad, m_pad,
        )
        cached = getattr(self, "_guided_host_tables", None)
        if cached is not None and cached[0] == cache_token:
            _, token_class, class_mask, class_trans = cached
        else:
            token_class = np.zeros((m_pad, vocab), np.int32)
            class_mask = np.zeros((s_pad, c_pad), bool)
            class_trans = np.tile(
                np.arange(s_pad, dtype=np.int32)[:, None], (1, c_pad)
            )
            for mi, d in enumerate(distinct):
                token_class[mi] = d.token_class
                o = offsets[id(d)]
                S, C = d.class_mask.shape
                class_mask[o:o + S, :C] = d.class_mask
                class_trans[o:o + S, :C] = d.class_trans + o
            class_mask[free_state, :] = True  # allow-all, unguided lanes
            self._guided_host_tables = (
                cache_token, token_class, class_mask, class_trans,
            )
        init_states = np.zeros((len(seqs),), np.int32)
        lane_map = np.zeros((len(seqs),), np.int32)
        for i, (s, d) in enumerate(zip(seqs, lane_dfas)):
            if d is None:
                init_states[i] = free_state
                lane_map[i] = n_real - 1
                continue
            machine = getattr(s, "_guided_machine", None)
            host_state = (
                s._guided_state if machine is not None
                else tuple(s.generated_token_ids)
            )
            idx = d.state_index.get(host_state)
            if idx is None:
                # a frozen / strayed state the DFA never enumerated
                return None
            init_states[i] = offsets[id(d)] + idx
            lane_map[i] = distinct.index(d)
        return (cache_token, init_states, lane_map, token_class,
                class_mask, class_trans)

    def _apply_guided_mask(self, seqs: list[Sequence],
                           logits: torch.Tensor) -> torch.Tensor:
        """-inf everything outside each guided lane's allowed set."""
        if not any(self._is_guided(s) for s in seqs):
            return logits
        allowed = np.ones(tuple(logits.shape), bool)
        for i, s in enumerate(seqs):
            ok = self._guided_allowed(s)
            if ok:
                allowed[i] = False
                allowed[i, list(ok)] = True
        return torch.where(self.runner._dev(allowed), logits,
                           torch.full_like(logits, float("-inf")))

    # stackcheck: not-hot — the single-step HOST sampling seam: it reads
    # the logits for penalty / bias / guided math by contract
    def _sample(self, seqs: list[Sequence], logits: torch.Tensor,
                return_logits: bool = False):
        b = logits.shape[0]
        temps, top_ps, top_ks, min_ps, keys, needs_penalties = (
            self._sampling_arrays(seqs, b)
        )
        if needs_penalties:
            logits = self._apply_penalties(seqs, logits)
        if any(s.sampling_params.logit_bias for s in seqs):
            logits = logits.clone()
            vocab = logits.shape[-1]
            for i, sq in enumerate(seqs):
                for t, v in (sq.sampling_params.logit_bias or {}).items():
                    if int(t) < vocab:
                        logits[i, int(t)] += float(v)
        logits = self._apply_guided_mask(seqs, logits)
        out = self.runner.sample(logits, temps, top_ps, top_ks, min_ps, keys)
        sampled = _to_numpy(out)[: len(seqs)]
        if return_logits:
            # the (penalized) logits the sample came from — what logprob
            # entries are computed against
            return sampled, logits
        return sampled

    @staticmethod
    # stackcheck: not-hot — host bookkeeping over a chunk's prompt
    # logprob arrays, fetched at the lane's one fetch before the call
    def _accumulate_prompt_lps(
        seq: Sequence, chunk_start: int, tgts: list[int],
        chosen: np.ndarray, tv: np.ndarray, ti: np.ndarray,
    ) -> None:
        """Collect one chunk's per-position prompt logprobs (already
        fetched). Capped at the ORIGINAL prompt length: a recompute after
        preemption folds generated tokens into the prompt, and those are
        not prompt."""
        n = seq.sampling_params.prompt_logprobs
        entries = getattr(seq, "_prompt_lp_entries", None)
        if entries is None:
            entries = []
            seq._prompt_lp_entries = entries  # type: ignore[attr-defined]
        limit = seq.orig_prompt_len - 1
        for j, t in enumerate(tgts):
            pos = chunk_start + 1 + j  # the prompt position row j scores
            if pos > limit:
                break
            if pos - 1 < len(entries):
                continue  # a recompute replays earlier chunks
            entries.append({
                "token_id": int(t),
                "logprob": float(chosen[j]),
                "top_logprobs": [
                    {"token_id": int(ti[j, m]), "logprob": float(tv[j, m])}
                    for m in range(n)
                ],
            })

    @staticmethod
    # stackcheck: not-hot — numpy over a logits row its caller already
    # fetched (the row's fetch is that caller's suppressed _to_numpy)
    def _host_logprob_entry(
        logits_row: np.ndarray, token: int, n: int
    ) -> dict:
        row = np.asarray(logits_row, np.float32)
        m = float(np.max(row))
        row = row - (m + np.log(np.sum(np.exp(row - m))))
        if n > 0:
            top = np.argpartition(-row, min(n, row.shape[0] - 1))[:n]
            top = top[np.argsort(-row[top])]
        else:
            top = np.array([], np.int64)
        return {
            "token_id": int(token),
            "logprob": float(row[token]),
            "top_logprobs": [
                {"token_id": int(t), "logprob": float(row[t])}
                for t in top
            ],
        }

    def _apply_penalties(
        self, seqs: list[Sequence], logits: torch.Tensor
    ) -> torch.Tensor:
        vocab = logits.shape[-1]
        b = logits.shape[0]
        counts = np.zeros((b, vocab), np.float32)
        presence = np.zeros((b,), np.float32)
        frequency = np.zeros((b,), np.float32)
        repetition = np.ones((b,), np.float32)
        for i, s in enumerate(seqs):
            sp = s.sampling_params
            presence[i] = sp.presence_penalty
            frequency[i] = sp.frequency_penalty
            repetition[i] = sp.repetition_penalty
            gen = s.generated_token_ids
            if gen:
                counts[i] = np.bincount(
                    np.asarray(gen) % vocab, minlength=vocab
                ).astype(np.float32)
        dev = self.runner._dev
        counts_d = dev(counts)
        return apply_penalties(
            logits, counts_d > 0, counts_d, dev(presence), dev(frequency),
            dev(repetition),
        )

    # stackcheck: not-hot — host bookkeeping of one sampled token that
    # is already a host int (every caller fetched it first)
    def _append_token(self, seq: Sequence, token: int,
                      logprob_entry: dict | None = None) -> None:
        if seq.metrics.first_token_time is None:
            seq.metrics.first_token_time = time.time()
            if self._tl_enabled:
                self.timeline.event(
                    seq.request_id, "first_token",
                    {"ttft_s": round(seq.metrics.first_token_time
                                     - seq.metrics.arrival_time, 6)},
                )
        seq.append_token(int(token))
        self._generation_tokens_total += 1
        machine = getattr(seq, "_guided_machine", None)
        if machine is not None and int(token) != (
            seq.eos_token_id if seq.eos_token_id is not None else -1
        ):
            ts = self._mask_cache().token_str(int(token))
            if ts:
                try:
                    ns = machine.step_str(seq._guided_state, ts)
                except ValueError:
                    ns = frozenset()  # per-lane containment
                    seq._guided_dead = True  # type: ignore[attr-defined]
                if ns:
                    seq._guided_state = ns  # type: ignore[attr-defined]
                # an empty set: the token strayed off the machine (only
                # on an unmasked path); the state stays frozen
        if seq.sampling_params.logprobs is not None:
            entries = getattr(seq, "_logprob_entries", None)
            if entries is None:
                entries = []
                seq._logprob_entries = entries  # type: ignore[attr-defined]
            entries.append(logprob_entry or {
                "token_id": int(token), "logprob": float("nan"),
                "top_logprobs": [],
            })
            pend = getattr(seq, "_pending_lps", None)
            if pend is None:
                pend = []
                seq._pending_lps = pend  # type: ignore[attr-defined]
            pend.append(entries[-1])
        # incremental detokenization: O(1) amortised per token
        detok = getattr(seq, "_detok", None)
        if detok is None:
            from production_stack_tpu_torch.engine.detokenizer import (
                IncrementalDetokenizer,
            )

            detok = IncrementalDetokenizer(self.tokenizer)
            for t in seq.generated_token_ids[:-1]:  # post-preemption replay
                detok.append(t)
            seq._detok = detok  # type: ignore[attr-defined]
        new_text = detok.append(int(token))
        seq.output_text = new_text
        # trailing U+FFFD chars are withheld from the stream until the
        # partial UTF-8 character completes (flushed on finish)
        prev_emitted = getattr(seq, "_emitted_chars", 0)
        stable = len(new_text)
        while stable > 0 and new_text[stable - 1] == "�":
            stable -= 1
        stable = max(stable, prev_emitted)  # never retract sent text
        seq._pending_delta = (
            getattr(seq, "_pending_delta", "")
            + new_text[prev_emitted:stable]
        )  # type: ignore[attr-defined]
        seq._emitted_chars = stable  # type: ignore[attr-defined]
        seq._pending_ids = (
            getattr(seq, "_pending_ids", []) + [int(token)]
        )  # type: ignore[attr-defined]
        seq.check_stop(new_text)
        choices = getattr(seq, "_guided_choices", None)
        if not seq.finished and choices is not None:
            g = list(seq.generated_token_ids)
            complete = any(list(ids) == g for ids in choices)
            extendable = any(
                len(ids) > len(g) and list(ids[: len(g)]) == g
                for ids in choices
            )
            # finish when a choice completed and nothing longer extends
            # it, or when no choice matches any more (the model took EOS
            # at a complete-but-extendable prefix)
            if (complete and not (
                extendable and seq.eos_token_id is not None
            )) or (not complete and not extendable):
                seq.status = SequenceStatus.FINISHED_STOPPED
        # hard cap: the KV layout cannot hold more than max_model_len
        if (
            not seq.finished
            and seq.num_tokens >= self.scheduler.config.max_model_len
        ):
            seq.status = SequenceStatus.FINISHED_LENGTH

    def _register_full_blocks(self, seq: Sequence) -> None:
        bs = self.block_manager.block_size
        all_ids = seq.all_token_ids
        while (len(seq.block_hashes) + 1) * bs <= seq.num_computed_tokens:
            i = len(seq.block_hashes)
            if i >= len(seq.block_table):
                break
            prev = (
                seq.block_hashes[-1] if seq.block_hashes else seq.hash_seed
            )
            h = self.block_manager.register_block(
                prev, tuple(all_ids[i * bs : (i + 1) * bs]),
                seq.block_table[i],
            )
            seq.block_hashes.append(h)

    def _make_output(self, seq: Sequence) -> RequestOutput:
        new_ids = getattr(seq, "_pending_ids", [])
        delta = getattr(seq, "_pending_delta", "")
        if seq.finished:
            # flush any withheld trailing U+FFFD on every finish path
            emitted = getattr(seq, "_emitted_chars", 0)
            if emitted < len(seq.output_text):
                delta += seq.output_text[emitted:]
                seq._emitted_chars = len(seq.output_text)  # type: ignore[attr-defined]
        seq._pending_ids = []  # type: ignore[attr-defined]
        seq._pending_delta = ""  # type: ignore[attr-defined]
        lp_all = lp_new = None
        if seq.sampling_params.logprobs is not None:
            lp_new = getattr(seq, "_pending_lps", [])
            seq._pending_lps = []  # type: ignore[attr-defined]
            if seq.finished:
                lp_all = list(getattr(seq, "_logprob_entries", []))
        plp = None
        if seq.sampling_params.prompt_logprobs is not None and seq.finished:
            # vLLM shape: one entry a prompt position, None first (no
            # context scores position 0)
            plp = [None] + list(getattr(seq, "_prompt_lp_entries", []))
        return RequestOutput(
            request_id=seq.request_id,
            prompt_token_ids=seq.prompt_token_ids[: seq.orig_prompt_len],
            token_ids=list(seq.generated_token_ids),
            new_token_ids=list(new_ids),
            text=seq.output_text,
            delta_text=delta,
            finished=seq.finished,
            finish_reason=seq.finish_reason,
            metrics=seq.metrics,
            num_cached_tokens=seq.metrics.num_cached_prompt_tokens,
            logprobs=lp_all,
            new_logprobs=lp_new,
            prompt_logprobs=plp,
        )

    # -- LoRA hot-load (adapters applied in the forwards; engine/lora.py)
    def load_lora(self, name: str, path: str) -> None:
        if self.runner.lora_manager is None:
            raise RuntimeError(
                "LoRA is disabled; start the engine with --enable-lora"
            )
        # in a rank set a broadcast step (every rank loads its slice)
        self.runner.load_lora(name, path)

    def unload_lora(self, name: str) -> None:
        if self.runner.lora_manager is not None:
            self.runner.unload_lora(name)

    def list_loras(self) -> list[str]:
        if self.runner.lora_manager is None:
            return []
        return self.runner.lora_manager.list_adapters()

    def _lora_slot(self, seq: Sequence) -> int:
        if self.runner.lora_manager is None:
            return 0
        try:
            return self.runner.lora_manager.slot_of(seq.lora_name)
        except KeyError:
            # adapter unloaded mid-request: degrade to the base model
            # rather than killing the step loop
            logger.warning(
                "request %s: LoRA %r no longer loaded; using base model",
                seq.request_id, seq.lora_name,
            )
            seq.lora_name = None
            return 0

    def _lora_slots(self, seqs: list[Sequence]) -> list[int] | None:
        """Each lane's adapter slot for a dispatch (None: LoRA is off)."""
        if self.runner.lora_manager is None:
            return None
        return [self._lora_slot(s) for s in seqs]

    def _slots_key(self, seqs: list[Sequence]) -> tuple:
        """The lanes' adapter slots, as a fingerprint field."""
        return tuple(self._lora_slots(seqs) or ())

    def shutdown(self) -> None:
        if self.long_prefill is not None:
            self.long_prefill.close()
        if self.offload is not None:
            self.offload.close()  # also closes the PD PeerTier
        if self.kv_reporter is not None:
            self.kv_reporter.close()
        if self.tp_group is not None:
            self._stop_ranks()

    def _stop_ranks(self) -> None:
        """Stop and join the followers of this engine's rank set."""
        group, self.tp_group = self.tp_group, None
        runner = getattr(self, "runner", None)
        if isinstance(runner, BroadcastingRunner):
            runner.shutdown_followers()
        else:  # the runner never got built: nothing listens for a step
            for p in group.followers:
                p.terminate()
                p.join(5)
        group.close()

    def tp_alive(self) -> bool:
        """False once a follower of the rank set died or a broadcast
        dispatch failed (always True without a rank set)."""
        if not isinstance(self.runner, BroadcastingRunner):
            return True
        return self.runner.alive()

    # -- embeddings (stateless one-shots, /v1/embeddings) -------------------
    def embed_one(
        self, text: str, lora_name: str | None = None
    ) -> tuple[np.ndarray, int]:
        """Embed one text -> (vector, token_count). One text a call, so
        the server can release the step-loop lock between items."""
        ids = self.tokenizer.encode(text)
        if not ids:
            ids = [self.tokenizer.eos_token_id or 0]
        lora_slot = 0
        if lora_name is not None:
            if self.runner.lora_manager is None:
                raise ValueError(
                    "embeddings for a LoRA adapter require --enable-lora"
                )
            lora_slot = self.runner.lora_manager.slot_of(lora_name)
        return self.runner.embed(ids, lora_slot=lora_slot), len(ids)

    def embed(self, texts: list[str],
              lora_name: str | None = None) -> list[np.ndarray]:
        return [self.embed_one(t, lora_name)[0] for t in texts]

    # -- stats for /metrics -------------------------------------------------
    def stats(self) -> EngineStatsSnapshot:
        phase = self.runner.prefill_phase_s
        peer = self.kv_peer
        remote = self.offload.remote if self.offload is not None else None
        return EngineStatsSnapshot(
            num_running=self.scheduler.num_running,
            num_waiting=self.scheduler.num_waiting,
            kv_usage=self.block_manager.usage,
            prefix_cache_queries=self.block_manager.prefix_queries,
            prefix_cache_hits=self.block_manager.prefix_hits,
            prompt_tokens_total=self._prompt_tokens_total,
            generation_tokens_total=self._generation_tokens_total,
            num_preemptions_total=self._preemptions_total,
            requests_finished_total=self._finished_total,
            spec_draft_tokens_total=self._spec_drafts_total,
            spec_accepted_tokens_total=self._spec_accepted_total,
            prefill_prep_seconds_total=phase["prep"],
            prefill_h2d_seconds_total=phase["h2d"],
            prefill_dispatch_seconds_total=phase["dispatch"],
            prefill_fetch_seconds_total=phase["fetch"],
            prefill_staged_hits_total=self._pf_staged_hits_total,
            prefill_staged_misses_total=self._pf_staged_misses_total,
            prefill_chained_chunks_total=self._pf_chained_chunks_total,
            **self._long_prefill_stats(),
            decode_rounds_total=self._decode_rounds_total,
            decode_overshoot_tokens_total=(
                self._decode_overshoot_tokens_total),
            decode_early_exit_rounds_total=(
                self._decode_early_exit_rounds_total),
            decode_k_hist=dict(self._decode_k_hist),
            ragged_rounds_total=self._ragged_rounds_total,
            ragged_split_rounds_total=self._ragged_split_rounds_total,
            ragged_prefill_lanes_total=self._ragged_prefill_lanes_total,
            ragged_decode_lanes_total=self._ragged_decode_lanes_total,
            compile_events_total=self.runner.compile_events_total,
            compile_events=dict(self.runner.compile_events),
            kv_export_seconds_total=self._kv_export_seconds_total,
            kv_export_blocks_total=self._kv_export_blocks_total,
            kv_export_bytes_total=self._kv_export_bytes_total,
            kv_restore_seconds_total=self._kv_restore_seconds_total,
            kv_restore_blocks_total=self._kv_restore_blocks_total,
            kv_restore_bytes_total=self._kv_restore_bytes_total,
            kv_restore_fallbacks_total=self._kv_restore_fallbacks_total,
            kv_export_sync_fallbacks_total=(
                self._kv_export_sync_fallbacks_total),
            kv_tier_counters=(
                self.offload.counters() if self.offload is not None
                else {}),
            kv_peer_hits_total=peer.hits if peer else 0,
            kv_peer_misses_total=peer.misses if peer else 0,
            kv_peer_read_bytes_total=peer.read_bytes if peer else 0,
            kv_peer_fallbacks_total=peer.fallbacks if peer else 0,
            kv_remote_hits_total=remote.hits if remote else 0,
            kv_remote_misses_total=remote.misses if remote else 0,
            kv_remote_read_bytes_total=remote.read_bytes if remote else 0,
            kv_remote_write_bytes_total=(
                remote.write_bytes if remote else 0),
            kv_remote_flushes_total=remote.flushes if remote else 0,
            kv_remote_fallbacks_total=remote.fallbacks if remote else 0,
        )

    def _long_prefill_stats(self) -> dict:
        mgr = self.long_prefill
        if mgr is None:
            return {}
        return dict(
            long_prefill_requests_total=mgr.requests_total,
            long_prefill_chunks_total=mgr.chunks_total,
            long_prefill_fallbacks_total=mgr.fallbacks_total,
            long_prefill_ring_seconds_total=mgr.phase_s["ring"],
            long_prefill_d2h_seconds_total=mgr.phase_s["d2h"],
            long_prefill_land_seconds_total=mgr.phase_s["land"],
            long_prefill_overflow_seconds_total=mgr.phase_s["overflow"],
        )

    # -- startup warm-up ----------------------------------------------------
    def precompile_serving(self) -> int:
        """Run every config-derivable serving program once (the JAX
        engine's grid): the single-sequence prefill of every pow2 chunk
        bucket x every reachable ctx bucket, the packed prefill of every
        pow2 group size (under the ragged kernel, once per padded row
        bucket), the decode variants of every K the scheduler can pick
        (``decode_precompile_variants``: chained and device-stop ones as
        this config dispatches them), the ragged rounds' lane-mix
        buckets, and, when on, the verify and KV-import dispatches. On
        the card the decode variants' CUDA graphs are captured here and
        the eager programs warmed. Request-dependent variants
        (penalties, logprobs, bias, stop ids, guided tables, adapters)
        still build on first use. Returns the trash dispatches run; the
        grid is kept in ``precompile_grid``. The reachable contexts stop
        at the resolved max_model_len or what the pool holds."""
        rnr = self.runner
        cfg = self.config
        sched = self.scheduler.config
        bs = self.block_manager.block_size
        cap = min(sched.max_model_len, rnr.num_blocks * bs)
        ctxs: list[int] = []
        c = rnr._ctx_bucket(1)
        while True:
            ctxs.append(c)
            if c >= cap:
                break
            c = rnr._ctx_bucket(c + 1)
        tbs: list[int] = []
        t = rnr._prefill_bucket(1)
        while True:
            tbs.append(t)
            if t >= rnr._prefill_bucket(cfg.max_prefill_chunk):
                break
            t = rnr._prefill_bucket(t + 1)
        singles: list[tuple[int, int]] = []
        groups: list[tuple[int, int, int]] = []
        for c in ctxs:
            for t in tbs:
                if t > c:
                    continue
                singles.append((t, c))
                s = 2
                while s <= cfg.max_prefill_seqs:
                    groups.append((s, t, c))
                    s *= 2
        if rnr.ragged_kernel and rnr.prefill_pipeline:
            # the packed prefill keys on the padded row bucket: (group,
            # chunk) pairs of equal rows share one program
            seen_rows: set[tuple[int, int]] = set()
            deduped = []
            for s, t, c in groups:
                rkey = (rnr._rows_bucket(s * t), c)
                if rkey not in seen_rows:
                    seen_rows.add(rkey)
                    deduped.append((s, t, c))
            groups = deduped
        variants = decode_precompile_variants(
            cfg.num_scheduler_steps, sched.adaptive_decode_k,
            overlap=self._async_decode or self._prefetch_decode,
            async_chained=self._async_decode, device_stop=self._device_stop,
        )
        self.precompile_grid = {
            "ctx_buckets": ctxs, "chunk_buckets": tbs,
            "singles": len(singles), "groups": len(groups),
            "decode_variants": variants,
        }
        with rnr.on_compute_stream():
            n = rnr.precompile_prefill(singles, groups)
            # decode: context lengths that land IN each bucket after the
            # +K-1 lookahead shift
            for kk, chained, stop in variants:
                n += rnr.precompile_decode(
                    [max(1, c - kk + 1) for c in ctxs], kk,
                    chained=chained, stop=stop,
                )
            if self._ragged_dispatch:
                n += rnr.precompile_ragged(
                    [max(1, c - cfg.num_scheduler_steps + 1) for c in ctxs],
                    decode_k_buckets(cfg.num_scheduler_steps,
                                     sched.adaptive_decode_k),
                    cfg.max_prefill_seqs, cfg.max_prefill_chunk,
                    stop=self._device_stop, chained=self._prefetch_decode,
                )
            if cfg.num_speculative_tokens > 0:
                n += rnr.precompile_verify(
                    ctxs, cfg.num_speculative_tokens + 1, cfg.max_num_seqs)
            if self.offload is not None:
                n += rnr.precompile_kv_import(cap // bs)
            # what the JAX sweeps leave to a live dispatch
            n += rnr.precompile_cover(
                ctxs, cfg.max_prefill_chunk, cfg.max_prefill_seqs,
                stop=self._device_stop, ragged=self._ragged_dispatch)
            if rnr.device.type == "cuda":
                torch.cuda.synchronize(rnr.device)
        return n

    # -- offline convenience (tests, benchmarks) ---------------------------
    def generate(
        self,
        prompts: list[str] | list[list[int]],
        sampling_params: SamplingParams | list[SamplingParams] | None = None,
    ) -> list[RequestOutput]:
        """Synchronous batch generation; returns final outputs in order."""
        finals: dict[str, RequestOutput] = {}
        for i, p in enumerate(prompts):
            sp = (
                sampling_params[i]
                if isinstance(sampling_params, list)
                else sampling_params
            )
            kwargs = (
                {"prompt_token_ids": p}
                if isinstance(p, list)
                else {"prompt": p}
            )
            self.add_request(f"gen-{i}", sampling_params=sp, **kwargs)
        while self.has_unfinished():
            for out in self.step():
                if out.finished:
                    finals[out.request_id] = out
        return [finals[f"gen-{i}"] for i in range(len(prompts))]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Device -> host fetch (synchronises with the device)."""
    # stackcheck: disable=device-sync-transitive — the port's d2h seam:
    # each call is a metered fetch of its round (the JAX engine's
    # np.asarray at the same call sites)
    return t.detach().float().cpu().numpy() if t.is_floating_point() else (
        t.detach().cpu().numpy()  # stackcheck: disable=device-sync-transitive
    )
