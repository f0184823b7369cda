"""Long-prefill lane: context-parallel ring prefill wired into serving.

Counterpart of ``production_stack_tpu/engine/long_prefill.py``. A prompt
longer than ``EngineConfig.long_prefill_threshold`` has its blocks
allocated at admission like any prompt, but the prompt itself runs as
sequence-sharded ring chunks (parallel/long_context.py) while the
engine keeps dispatching ragged / decode rounds for everyone else. The
resulting layer-stacked KV lands in the paged cache through the same
primitives KV tiering and PD transfer use
(``ModelRunner.stage_import_blocks`` / ``import_staged_blocks``), so
decode afterwards is the normal paged path and the landed chain is
registered in the prefix cache like any other.

Division of labor:

- STEP THREAD (``advance``, once a step): dispatch the next ring chunk
  (an eager forward; every operation enqueues) while the next chunk's
  token buffer copies on a side stream, and land at most one parked
  wire-format block batch a step (a staged upload and an index copy).
  No device fetch: decode rounds for other users keep their cadence
  between chunks. An eager chunk is thousands of launches, though: on
  the card the launch queue fills, and the dispatch then waits for the
  chunk's own earlier kernels, so it holds the step thread for most of
  the chunk's device time. After the last chunk it records a CUDA event
  on each ring device's current stream (the step thread's compute
  stream).
- WORKER THREAD: wait on those events (the measured ring wall; never a
  device-wide synchronize, which would stall the decode rounds), copy
  the final logits and the sharded KV to pinned host buffers on
  streams of its own (one a ring card) that wait on the events first,
  relayout rows into the wire-format ``(2, L, n, nkv, bs, d)`` batches
  the import primitives take (pinned, so their upload needs no second
  copy), and park them for the step thread.

In a tensor-parallel rank set (rank 0's runner is a
multihost_engine.BroadcastingRunner) every ring chunk is a published
step (``lane_chunk``): each tp rank rings its own kv heads over its
shard of the params, and the chunk's all-reduces tie the ranks
together. After the last chunk one collect step (``lane_collect``)
brings every rank's heads of the ring cache to rank 0, which then
materializes and lands the whole cache as on one card; the landing's
imports are the rank set's ``kv_import`` steps. A job dropped before
its collect (cancel, a failure before a chunk was published) releases
the followers' ring state (``lane_release``).

Failure degrades, never wedges: a failed ring parks the record as
'failed' and the engine flips the sequence back to the chunked-prefill
lane (its block table is already allocated), counted in
``fallbacks_total``. That is for a failure of the lane on rank 0 alone:
a rank-set failure (RankSetError, or any error of a published step,
after which the set is broken) propagates.

Per-phase attribution (``phase_s``; the ``long_prefill`` timeline event
and the tpu:prefill_* families): ``ring`` = job start -> ring drained
(includes the decode rounds the engine interleaved), ``d2h`` = device
-> host KV copy, ``land`` = first parked batch -> last import enqueued,
``overflow`` = tier-export seconds that ran while the job was in flight
(the engine attributes these).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import torch

from production_stack_tpu_torch.engine.multihost_engine import (
    BroadcastingRunner,
    RankSetError,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# blocks per landing batch: each batch is one staged upload + one index
# copy on the step thread
LAND_BATCH_BLOCKS = 32


class LongPrefillManager:
    """Owns the ring prefiller, the in-flight long-prefill records, and
    the materialization worker. One instance per engine; all entry
    points except the worker body run on the engine step thread."""

    def __init__(self, runner, chunk_tokens: int):
        # the runner builds the prefiller (its ring of devices and the
        # params it shares); raises when the ring cannot be built — the
        # engine degrades to chunked prefill then
        self.runner = runner
        self.prefiller = runner.build_long_prefiller()
        # rank 0 of a tp rank set: chunks, collect and release are
        # published steps
        self._rank_set = isinstance(runner, BroadcastingRunner)
        self.block_size = runner.block_size
        # chunk length: ring-size AND block-size aligned so the padded
        # sequence always covers whole paged blocks
        self.chunk = self.prefiller.chunk_to(
            max(chunk_tokens, self.block_size), align=self.block_size
        )
        self._jobs: dict[str, dict] = {}
        # worker handoff: deque appends/pops are GIL-atomic; the
        # condition only wakes the worker
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._worker: threading.Thread | None = None
        # the worker's device-to-host stream on each ring card
        self._d2h_streams: dict = {}
        self._closed = False
        # lifetime accounting (tpu:long_prefill_*)
        self.requests_total = 0
        self.chunks_total = 0
        self.fallbacks_total = 0
        self.phase_s = {
            "ring": 0.0, "d2h": 0.0, "land": 0.0, "overflow": 0.0,
        }
        # rank set: seconds rank 0 spent assembling the ring caches (part
        # of the ring phase)
        self.collect_s_total = 0.0

    @property
    def active(self) -> bool:
        return bool(self._jobs)

    # -- step-thread API ---------------------------------------------------
    def start(self, seq, export_s0: float = 0.0) -> bool:
        """Begin a long prefill for an admitted sequence (block table
        already allocated). `export_s0` anchors the engine's
        overflow-export attribution. Returns False when this sequence
        cannot take the lane (it then serves on the chunked path)."""
        bs = self.block_size
        cached = seq.num_computed_tokens
        if cached % bs:
            # a non-block-aligned cached prefix only happens on nearly
            # fully-cached prompts; the chunked path serves those
            return False
        n = seq.num_prompt_tokens
        pre = self.prefiller
        s_pad = pre.seq_pad(n, self.chunk)
        rec = {
            "rid": seq.request_id,
            "seq": seq,
            "ids": list(seq.prompt_token_ids),
            "n": n,
            "table": list(seq.block_table),
            "start_block": cached // bs,
            "n_blocks": -(-n // bs),
            "s_pad": s_pad,
            # only the chunks that contain real tokens dispatch; the
            # pow2 tail of the padded cache stays zero (and is never
            # attended — every real query position sits below it)
            "ring_end": -(-n // self.chunk) * self.chunk,
            "kc": None,
            "vc": None,
            "next_start": 0,
            "staged_toks": None,
            "staged_start": -1,
            "logits_dev": None,
            "ring_events": None,
            "logits": None,
            "batches": deque(),  # (first_block_idx, wire tensor)
            "batches_done": False,
            "landed_blocks": 0,
            "state": "ringing",
            "cancelled": False,
            "export_s0": export_s0,
            "t0": time.monotonic(),
            "t_ring0": None,
            "t_land0": None,
            "ring_s": 0.0,
            "d2h_s": 0.0,
            "land_s": 0.0,
            # rank set: the followers hold a ring cache for it
            "followers_hold": False,
        }
        try:
            rec["kc"], rec["vc"] = pre.begin_cache(s_pad)
        except Exception:  # noqa: BLE001 — e.g. OOM sizing the
            # full-sequence cache; the chunked path still serves this
            logger.exception(
                "long prefill cache alloc failed for %s; using chunked "
                "prefill", seq.request_id,
            )
            return False
        old = self._jobs.pop(seq.request_id, None)
        if old is not None:
            # preempt-then-readmit inside one schedule(): the stale
            # job's table is gone — only the fresh record may land
            old["cancelled"] = True
            self._release(old)
        self._jobs[seq.request_id] = rec
        self.requests_total += 1
        return True

    # stackcheck: hot-path — once per engine step between device
    # dispatches: chunk dispatch + batch landing are enqueue-only; the
    # blocking ring wait / d2h live on the worker (_materialize)
    def advance(self) -> tuple[list[dict], list[dict], bool]:
        """Advance every in-flight job one step. Returns
        (done_records, failed_records, progressed): done records have
        all their blocks landed and host logits parked (the engine
        samples the first token and finalizes); failed records name
        sequences that must fall back to the chunked path; progressed
        is False when nothing moved (the engine may yield briefly)."""
        done: list[dict] = []
        failed: list[dict] = []
        progressed = False
        for rec in list(self._jobs.values()):
            # cancelled records never linger here: cancel() and start()'s
            # stale-job replacement pop them from _jobs with the flag set
            # (the flag itself is for the worker thread)
            state = rec["state"]
            if state == "ringing":
                try:
                    self._dispatch_next_chunk(rec)
                except Exception as e:  # noqa: BLE001 — a chunk dispatch
                    # failure (e.g. an OOM of the score tensors) must
                    # fail ONE request back to the chunked path, never
                    # the step loop; a rank-set failure is not one
                    if self._rank_set_failure(e):
                        raise
                    logger.exception(
                        "long prefill chunk dispatch failed for %s",
                        rec["rid"],
                    )
                    rec["state"] = state = "failed"
                    self._release(rec)
                else:
                    progressed = True
            elif state == "landing":
                try:
                    if self._land_one_batch(rec):
                        progressed = True
                except Exception as e:  # noqa: BLE001 — same contract: a
                    # failed import recomputes via chunked prefill
                    # (partial landings are overwritten there)
                    if self._rank_set_failure(e):
                        raise
                    logger.exception(
                        "long prefill landing failed for %s", rec["rid"],
                    )
                    rec["state"] = state = "failed"
            if state == "landing":
                want = rec["n_blocks"] - rec["start_block"]
                if (
                    rec["batches_done"]
                    and not rec["batches"]
                    and rec["landed_blocks"] >= want
                    and rec["logits"] is not None
                ):
                    if rec["t_land0"] is not None:
                        rec["land_s"] = (
                            time.monotonic() - rec["t_land0"]
                        )
                        self.phase_s["land"] += rec["land_s"]
                    rec["state"] = "done"
                    done.append(rec)
                    del self._jobs[rec["rid"]]
                    progressed = True
            elif state == "failed":
                self.fallbacks_total += 1
                failed.append(rec)
                del self._jobs[rec["rid"]]
                progressed = True
            # "materializing": the worker owns it; nothing to do here
        return done, failed, progressed

    def cancel(self, request_id: str) -> None:
        """Forget a job (abort / preemption). The worker checks the
        flag between batches, so a mid-materialization cancel stops
        parking new data; device buffers drop with the record."""
        rec = self._jobs.pop(request_id, None)
        if rec is not None:
            rec["cancelled"] = True
            self._release(rec)

    def _rank_set_failure(self, e: Exception) -> bool:
        """True when `e` broke the rank set (a follower failed, or a
        published step failed on rank 0 and left the set out of step):
        never a lane fallback."""
        return self._rank_set and (isinstance(e, RankSetError)
                                   or self.runner.broken)

    def _release(self, rec: dict) -> None:
        """The followers drop the ring state of a job that ends before
        its collect."""
        if rec["followers_hold"]:
            rec["followers_hold"] = False
            self.runner.lane_release(rec["rid"])

    def close(self) -> None:
        self._closed = True
        if self._worker is not None:
            with self._cv:
                self._queue.append(None)
                self._cv.notify()
            self._worker.join(timeout=2.0)

    # stackcheck: hot-path — enqueue-only: one eager ring-chunk forward
    # plus the NEXT chunk's staged token copy; no device fetch
    def _dispatch_next_chunk(self, rec: dict) -> None:
        pre = self.prefiller
        C = self.chunk
        start = rec["next_start"]
        toks = rec["staged_toks"]
        if toks is None or rec["staged_start"] != start:
            # cold first chunk (or a stage that never happened)
            toks = pre.stage_tokens(rec["ids"][start: start + C], C)
        rec["staged_toks"] = None
        # the FINAL real token's row, local to the last dispatched
        # chunk (earlier chunks pass a clamped dummy row; their logits
        # are computed but never fetched)
        last_local = min(max(rec["n"] - 1 - start, 0), C - 1)
        if self._rank_set:
            rec["followers_hold"] = True
            logits, kc, vc = self.runner.lane_chunk(
                rec["rid"], rec["ids"][start: start + C], start, C,
                rec["s_pad"], last_local,
                run=lambda: pre.prefill_chunk(
                    rec["kc"], rec["vc"], toks, start, last_local))
        else:
            logits, kc, vc = pre.prefill_chunk(
                rec["kc"], rec["vc"], toks, start, last_local,
            )
        rec["kc"], rec["vc"] = kc, vc
        rec["next_start"] = start + C
        self.chunks_total += 1
        if rec["next_start"] < rec["ring_end"]:
            # stage chunk N+1's tokens while chunk N rings
            nxt = rec["next_start"]
            rec["staged_toks"] = pre.stage_tokens(
                rec["ids"][nxt: nxt + C], C
            )
            rec["staged_start"] = nxt
        else:
            if self._rank_set:
                # every rank's kv heads of the ring cache, on rank 0
                t0 = time.monotonic()
                rec["followers_hold"] = False
                rec["kc"], rec["vc"] = self.runner.lane_collect(
                    rec["rid"], kc, vc)
                self.collect_s_total += time.monotonic() - t0
            rec["logits_dev"] = logits
            rec["ring_events"] = self._record_ring_events(
                [logits, *rec["kc"].shards, *rec["vc"].shards])
            rec["t_ring0"] = rec["t0"]
            rec["state"] = "materializing"
            self._submit(rec)

    def _record_ring_events(self, tensors: list[torch.Tensor]) -> list:
        """One CUDA event a device of `tensors` (the results the worker
        fetches: every ring card holds a shard), recorded on its current
        stream (the step thread's) after the last chunk: the worker waits
        on these, never on the whole device. None on the CPU, where the
        chunk's work is done when its dispatch returns."""
        events = []
        for dev in dict.fromkeys(t.device for t in tensors):
            if dev.type != "cuda":
                continue
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return events

    # stackcheck: hot-path — pop one parked host batch, START its upload
    # (stage_import_blocks) and enqueue the index copy into the paged
    # cache (import_staged_blocks): the KV import primitives
    def _land_one_batch(self, rec: dict) -> bool:
        try:
            b0, data = rec["batches"].popleft()
        except IndexError:
            return False
        if rec["t_land0"] is None:
            rec["t_land0"] = time.monotonic()
        nb = int(data.shape[2])
        handle = self.runner.stage_import_blocks(data)
        bids = rec["table"][b0: b0 + nb]
        self.runner.import_staged_blocks(bids, handle, list(range(nb)))
        rec["landed_blocks"] += nb
        return True

    # -- worker ------------------------------------------------------------
    def _submit(self, rec: dict) -> None:
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name="long-prefill-worker", daemon=True
            )
            self._worker.start()
        with self._cv:
            self._queue.append(rec)
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                rec = self._queue.popleft()
            if rec is None or self._closed:
                return
            try:
                self._materialize(rec)
            except Exception:  # noqa: BLE001 — a dead device / bad shape
                # must fail ONE request back to chunked prefill, not
                # kill the worker for every later long prompt
                logger.exception(
                    "long prefill materialization failed for %s",
                    rec["rid"],
                )
                rec["state"] = "failed"

    def _to_host(self, tensors: list[torch.Tensor],
                 events: list) -> list[torch.Tensor]:
        """Copy device tensors into pinned host buffers, ordered after the
        ring's events; waits for those copies only. A device-to-host copy
        runs on the current stream of its SOURCE card, so each card of
        the ring gets a worker stream of its own that waits on the events
        first, and the worker waits on every one of those streams. CPU
        tensors pass through."""
        if not events:
            return tensors
        torch.cuda.set_device(self.prefiller.device)
        streams: dict[torch.device, torch.cuda.Stream] = {}
        for t in tensors:
            if t.device in streams:
                continue
            stream = self._d2h_streams.get(t.device)
            if stream is None:
                stream = torch.cuda.Stream(t.device)
                self._d2h_streams[t.device] = stream
            for ev in events:
                stream.wait_event(ev)
            streams[t.device] = stream
        out = []
        for t in tensors:
            stream = streams[t.device]
            with torch.cuda.stream(stream):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                # allocated on the step thread's stream: mark the use
                # here so the memory is not handed out mid-copy
                t.record_stream(stream)
                host.copy_(t, non_blocking=True)
            out.append(host)
        for stream in streams.values():
            stream.synchronize()
        return out

    def _materialize(self, rec: dict) -> None:
        """Worker body: wait out the ring, pull logits + KV to the host,
        slice rows into wire-format block batches. All the blocking
        device IO of the long-prefill path lives here."""
        kc, vc = rec["kc"], rec["vc"]
        events = rec["ring_events"] or []
        for ev in events:
            ev.synchronize()
        t1 = time.monotonic()
        rec["ring_s"] = t1 - rec["t_ring0"]
        self.phase_s["ring"] += rec["ring_s"]
        if rec["cancelled"]:
            return
        sp = len(kc.shards)
        host = self._to_host([rec["logits_dev"], *kc.shards, *vc.shards],
                             events)
        logits, k_sh, v_sh = host[0], host[1:1 + sp], host[1 + sp:]
        # release the device references before the (slow) host
        # relayout: the ring cache frees as soon as they drop
        rec["kc"] = rec["vc"] = rec["logits_dev"] = None
        del kc, vc
        rec["d2h_s"] = time.monotonic() - t1
        self.phase_s["d2h"] += rec["d2h_s"]
        rec["logits"] = logits
        bs = self.block_size
        R = k_sh[0].shape[2]
        L, nkv, _, d = k_sh[0].shape
        total = rec["n_blocks"]
        b0 = rec["start_block"]
        if b0 >= total:
            # fully-cached prefix (nothing to land): degenerate done
            rec["batches_done"] = True
            rec["state"] = "landing"
            return
        pin = bool(events)
        for lo in range(b0, total, LAND_BATCH_BLOCKS):
            if rec["cancelled"]:
                return
            hi = min(lo + LAND_BATCH_BLOCKS, total)
            nb = hi - lo
            # head-major rows -> wire layout (2, L, n, nkv, bs, d), the
            # frame stage_import_blocks takes; a batch's rows may span
            # two shards
            batch = torch.empty((2, L, nb, nkv, bs, d), dtype=k_sh[0].dtype,
                                pin_memory=pin)
            for j, shards in enumerate((k_sh, v_sh)):
                rows = torch.cat([
                    shards[i][:, :, max(lo * bs, i * R) - i * R:
                              min(hi * bs, (i + 1) * R) - i * R]
                    for i in range(len(shards))
                    if max(lo * bs, i * R) < min(hi * bs, (i + 1) * R)
                ], dim=2)
                batch[j].copy_(
                    rows.reshape(L, nkv, nb, bs, d).transpose(1, 2))
            rec["batches"].append((lo, batch))
            # landing may start while later batches still convert
            rec["state"] = "landing"
        rec["batches_done"] = True
