"""Async facade over LLMEngine for the HTTP server.

The engine step loop (device dispatch) runs on a dedicated thread so the
asyncio event loop stays responsive for streaming; per-request outputs are
delivered to asyncio queues via call_soon_threadsafe. This mirrors the
process shape of the reference's engines (uvicorn front + engine core):
the step thread launches device work that PyTorch enqueues
asynchronously on the card's stream.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections.abc import AsyncIterator

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.outputs import (
    EngineStatsSnapshot,
    RequestOutput,
)
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.tracing.steps import (
    ENGINE_IDLE,
    ENGINE_LOCK,
    FRONT_LOCK,
    begin,
    end,
    span,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class EngineSleepingError(RuntimeError):
    pass


class AsyncLLMEngine:
    def __init__(self, config: EngineConfig, params: dict | None = None):
        self.config = config
        self.engine = LLMEngine(config, params=params)
        self._loop: asyncio.AbstractEventLoop | None = None
        # the step thread's _fail_inflight iterates these under the lock;
        # loop-side writes hold it too, except the GIL-atomic single-op
        # reads/pops on hot paths (suppressed with rationale in place)
        self._streams: dict[str, asyncio.Queue] = {}  # guarded by: self._lock
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._step_loop, name="engine-step-loop", daemon=True
        )
        # sleep/wake lifecycle (reference parity: engine /sleep /wake_up,
        # reference: src/vllm_router/service_discovery.py:414-441)
        self.sleeping = False
        self.sleep_level = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self, loop: asyncio.AbstractEventLoop | None = None) -> None:
        self._loop = loop or asyncio.get_event_loop()
        self._thread.start()

    def shutdown(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        self.engine.shutdown()

    # -- step loop thread --------------------------------------------------
    def _step_loop(self) -> None:
        logger.info("engine step loop started")
        while not self._stopped:
            if self.sleeping:
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            try:
                # the acquisition in an engine.lock range, the step's in
                # its own (tracing/steps.py)
                waiting = begin(ENGINE_LOCK)
                with self._lock:
                    end(waiting)
                    busy = self.engine.has_unfinished()
                    outputs = self.engine.step() if busy else []
            except Exception:  # noqa: BLE001 — a step failure must fail
                # the in-flight REQUESTS, not the serving thread: a dead
                # step loop wedges every current and future request
                logger.exception(
                    "engine step failed; aborting in-flight requests"
                )
                outputs = self._fail_inflight()
                busy = True
                # if the engine state is corrupt enough that aborts
                # also fail, has_unfinished() can stay true forever —
                # backoff bounds the retry/log rate instead of pegging
                # the thread in a no-sleep exception loop
                # audited for stackcheck's blocking-async rule: _step_loop
                # runs on the dedicated engine-step thread (self._thread),
                # never the event loop, so a blocking backoff is the
                # intent (the rule only scans async defs; no directive
                # needed — this note is the audit trail)
                time.sleep(0.5)
            if outputs and self._loop is not None:
                self._loop.call_soon_threadsafe(self._deliver, outputs)
            if not busy:
                with span(ENGINE_IDLE):
                    self._wake.wait(timeout=0.02)
                self._wake.clear()

    def _fail_inflight(self) -> list[RequestOutput]:
        """Abort every engine request and emit finished error outputs so
        waiting streams terminate instead of hanging forever."""
        from production_stack_tpu_torch.engine.sequence import RequestMetrics

        outs: list[RequestOutput] = []
        with self._lock:
            for request_id in list(self._streams):
                try:
                    self.engine.abort_request(request_id)
                except Exception:  # noqa: BLE001 — state may be corrupt
                    logger.exception("abort failed for %s", request_id)
                outs.append(RequestOutput(
                    request_id=request_id,
                    prompt_token_ids=[],
                    token_ids=[],
                    new_token_ids=[],
                    text="",
                    delta_text="",
                    finished=True,
                    finish_reason="error",
                    metrics=RequestMetrics(arrival_time=time.time()),
                ))
        return outs

    def _deliver(self, outputs: list[RequestOutput]) -> None:
        for out in outputs:
            # stackcheck: disable=guarded-by-lock — loop-thread dict.get
            # is GIL-atomic and _fail_inflight snapshots via list(); taking
            # the lock here would stall delivery behind the next
            # engine.step (the step thread holds it for the whole step)
            q = self._streams.get(out.request_id)
            if q is not None:
                q.put_nowait(out)

    # -- request API -------------------------------------------------------
    async def generate(
        self,
        request_id: str,
        prompt: str | None = None,
        prompt_token_ids: list[int] | None = None,
        sampling_params: SamplingParams | None = None,
        lora_name: str | None = None,
        priority: int = 0,
        traceparent: str | None = None,
    ) -> AsyncIterator[RequestOutput]:
        if self.sleeping:
            raise EngineSleepingError("engine is sleeping")
        q: asyncio.Queue[RequestOutput] = asyncio.Queue()
        finished = False
        try:
            # the wait for the lock, which the step thread holds for a
            # whole step: a front.lock range and the request's
            # lock_wait_s
            t0 = time.perf_counter()
            waiting = begin(FRONT_LOCK)
            with self._lock:
                end(waiting)
                lock_wait_s = time.perf_counter() - t0
                self._streams[request_id] = q
                self.engine.add_request(
                    request_id,
                    prompt=prompt,
                    prompt_token_ids=prompt_token_ids,
                    sampling_params=sampling_params,
                    arrival_time=time.time(),
                    lora_name=lora_name,
                    priority=priority,
                    traceparent=traceparent,
                    lock_wait_s=lock_wait_s,
                )
            self._wake.set()
            while True:
                out = await q.get()
                finished = out.finished
                yield out
                if finished:
                    break
        finally:
            # stackcheck: disable=guarded-by-lock — loop-thread dict.pop is
            # GIL-atomic vs _fail_inflight's list() snapshot; taking the
            # lock on every NORMAL completion would stall the event loop
            # behind the step thread's full engine.step
            self._streams.pop(request_id, None)
            if not finished:
                with self._lock:
                    self.engine.abort_request(request_id)

    async def abort(self, request_id: str) -> bool:
        with self._lock:
            return self.engine.abort_request(request_id)

    def has_request(self, request_id: str) -> bool:
        return self.engine.has_request(request_id)

    def has_request_prefix(self, request_id: str) -> bool:
        return self.engine.has_request_prefix(request_id)

    # -- LoRA adapters (under the step lock: a step reads the buffers) ----
    def load_lora(self, name: str, path: str) -> None:
        with self._lock:
            self.engine.load_lora(name, path)

    def unload_lora(self, name: str) -> None:
        with self._lock:
            self.engine.unload_lora(name)

    # -- introspection -----------------------------------------------------
    def stats(self) -> EngineStatsSnapshot:
        with self._lock:
            return self.engine.stats()

    def drain_kv_observations(self) -> tuple[list[float], list[float]]:
        # GIL-atomic deque pops; no step-lock needed
        return self.engine.drain_kv_observations()

    def drain_ragged_observations(self) -> list[int]:
        """Ragged lane-mix observations (tpu:ragged_lane_mix) since the
        last drain; lock-free like the KV drain."""
        return self.engine.drain_ragged_observations()

    @property
    def timeline(self):
        """Per-request lifecycle recorder (tracing.TimelineRecorder)."""
        return self.engine.timeline

    @property
    def tracer(self):
        """Engine-side span tracer (tracing.RequestTracer)."""
        return self.engine.tracer

    @property
    def tokenizer(self):
        return self.engine.tokenizer

    # -- sleep / wake ------------------------------------------------------
    def sleep(self, level: int = 1) -> None:
        """Pause serving. Level 1 keeps weights; level 2 is a deep sleep
        (the KV cache is dropped either way once in-flight work drains)."""
        self.sleeping = True
        self.sleep_level = level
        logger.info("engine going to sleep (level %d)", level)

    def wake_up(self) -> None:
        self.sleeping = False
        self.sleep_level = 0
        self._wake.set()
        logger.info("engine woke up")

    def is_sleeping(self) -> bool:
        return self.sleeping
