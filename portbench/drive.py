"""The load loop: a plan's sessions sent to ``AsyncLLMEngine.generate``
in process, each request timed from when it was due."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from portbench.generator import Plan, Session, Turn


@dataclass
class Request:
    index: int
    due_s: float               # when the plan wanted it sent (perf clock)
    prompt_ids: list[int]
    max_tokens: int
    sent_s: float = 0.0
    chunks: list = field(default_factory=list)  # (perf time, new tokens)
    first_token_s: float | None = None
    finish_s: float | None = None
    output_ids: list[int] = field(default_factory=list)
    finished: bool = False     # ended by its own length, not cut
    finish_reason: str | None = None
    cached: int = 0            # prompt tokens the prefix cache held
    metrics: object = None     # the engine's RequestMetrics
    request_id: str = ""

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def failed(self) -> bool:
        return self.finish_reason == "error"


class Driver:
    """Sends one plan's traffic until `stop_s` (perf clock): an open
    loop starts each session at its offset from `begin_s`; a closed loop
    keeps `plan.clients` clients busy. No request due at or after
    `stop_s` is sent; `close()` cuts the ones in flight."""

    def __init__(self, engine, plan: Plan, make_params, tag: str,
                 clock=time.perf_counter):
        self.engine = engine
        self.plan = plan
        self.make_params = make_params  # max_tokens -> SamplingParams
        self.tag = tag
        self.clock = clock
        self.requests: list[Request] = []
        self._tasks: set[asyncio.Task] = set()
        self.begin_s = self.stop_s = 0.0

    def start(self, begin_s: float, stop_s: float) -> None:
        self.begin_s, self.stop_s = begin_s, stop_s
        if self.plan.open_loop:
            self._spawn(self._launcher())
        else:
            # clients start spread over the mix's stagger, so that a
            # closed loop reaches its steady mix of request ages sooner
            n = self.plan.clients
            for i in range(n):
                self._spawn(self._client(begin_s + i * self.plan.stagger_s / n))

    async def close(self) -> None:
        tasks = list(self._tasks)
        for t in tasks:
            t.cancel()
        results = await asyncio.gather(*tasks, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException) and not isinstance(
                    r, asyncio.CancelledError):
                raise r

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _launcher(self) -> None:
        while True:
            s = self.plan.next_session()
            due = self.begin_s + s.start_s
            if due >= self.stop_s:
                return
            await self._sleep_until(due)
            self._spawn(self._session(s, due))

    async def _client(self, due: float) -> None:
        while due < self.stop_s:
            due = await self._session(self.plan.next_session(), due)

    async def _session(self, s: Session, due: float) -> float:
        """Runs the session's turns; returns when the next one is due."""
        convo = self.plan.shared_prefix + s.history_ids
        for turn in s.turns:
            if due >= self.stop_s:
                return due
            await self._sleep_until(due)
            convo = convo + turn.user_ids
            req = await self._request(convo, turn, due)
            if req.finish_s is None:  # cut: the stream ended early
                return self.stop_s
            convo = convo + req.output_ids
            due = req.finish_s + turn.think_s
        return due

    async def _request(self, prompt: list[int], turn: Turn,
                       due: float) -> Request:
        req = Request(len(self.requests), due, prompt, turn.max_tokens,
                      self.clock())
        req.request_id = f"{self.tag}-{req.index}"
        self.requests.append(req)
        stream = self.engine.generate(
            req.request_id, prompt_token_ids=prompt,
            sampling_params=self.make_params(turn.max_tokens))
        try:
            async for out in stream:
                now = self.clock()
                req.metrics = out.metrics
                req.cached = out.num_cached_tokens
                if out.new_token_ids:
                    if req.first_token_s is None:
                        req.first_token_s = now
                    req.chunks.append((now, len(out.new_token_ids)))
                if out.finished:
                    req.finish_s = now
                    req.finish_reason = out.finish_reason
                    req.output_ids = list(out.token_ids)
                    req.finished = out.finish_reason == "length"
        finally:
            await stream.aclose()
        return req

    async def _sleep_until(self, t: float) -> None:
        wait = t - self.clock()
        if wait > 0:
            await asyncio.sleep(wait)


class WarmupPlan:
    """The warm-up's traffic: the mix's own clients and shared prefix,
    but every request a single one whose context spans the mix's range,
    drawn at stratified quantiles, with a short answer, so that the
    shapes of long contexts come early."""

    def __init__(self, plan: Plan, clients: int, lo: int, hi: int,
                 answer: int, block: int = 16):
        self._plan = plan
        self.clients = clients
        self.open_loop = False
        self.shared_prefix = plan.shared_prefix
        self.stagger_s = 0.0
        self.lo, self.hi, self.answer = lo, hi, answer
        self.block = block
        self._made = 0
        self._order: list[int] = []

    def next_session(self) -> Session:
        if not self._order:
            self._order = self._plan.order(self.block)
        j = self._order.pop()
        total = int(self.lo + (self.hi - self.lo) * (j + 0.5) / self.block)
        n = max(1, total - self.answer - len(self.shared_prefix))
        s = Session(self._made, 0.0, [],
                    [Turn(self._plan.token_ids(n), self.answer, 0.0)])
        self._made += 1
        return s
