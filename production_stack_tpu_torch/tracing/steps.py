"""The step meter: where the engine's step thread spends its rounds.

Three parts:

- host ranges (``span``, ``begin`` / ``end``): a
  ``torch.autograd.profiler.record_function`` of a fixed name, entered
  only while a profiler runs. The test is the module global
  ``torch.autograd.profiler._is_profiler_enabled``: under
  ``profile_all_threads`` the per-thread ``_profiler_enabled()`` reads
  False on the engine's step thread although its ranges are recorded.
  With no profiler a range costs that one attribute read (a
  ``record_function`` costs ~15 us a call even then). Kineto records
  the ranges on the clock of the device's kernels, so a trace can put
  each idle stretch of the device down to the phase the step thread was
  in;
- counters (``StepMeter``), always on, published in the engine's
  ``EngineStatsSnapshot``: rounds, host seconds and seconds in the
  device->host seam by round kind, the calls through that seam, and the
  prompt rows, attention keys and first tokens of the served work;
- the seconds a request waited for the engine's lock in
  ``AsyncLLMEngine.generate`` (``RequestMetrics.lock_wait_s``), stamped
  by the front.

The ranges, outermost first. On the step thread: ``engine.lock``
(acquiring the engine's lock), ``engine.idle`` (waiting for work) and
``engine.step`` (one ``LLMEngine.step``), inside which ``step.schedule``
(the scheduler's plan and its bookkeeping), ``step.prepare`` (sampling,
stop and bias arrays, the packed buffer's build and upload),
``step.launch`` (static-buffer copies, the programs' runs and graph
replays), ``step.stage`` (building and copying the predicted next
round's buffer), ``step.wait`` (a device->host fetch: the copy and the
wait for the device) and ``step.apply`` (the round's token bookkeeping
and outputs). On the event loop: ``front.lock`` (``generate`` acquiring
the engine's lock).

Unlike the rest of ``tracing/`` this module imports torch; the package
``__init__`` does not import it, so the router stays on the stdlib.
"""

from __future__ import annotations

import contextlib
import time

import torch.autograd.profiler as _profiler

ENGINE_LOCK = "engine.lock"
ENGINE_IDLE = "engine.idle"
ENGINE_STEP = "engine.step"
SCHEDULE = "step.schedule"
PREPARE = "step.prepare"
LAUNCH = "step.launch"
STAGE = "step.stage"
WAIT = "step.wait"
APPLY = "step.apply"
FRONT_LOCK = "front.lock"
RANGES = (ENGINE_LOCK, ENGINE_IDLE, ENGINE_STEP, SCHEDULE, PREPARE, LAUNCH,
          STAGE, WAIT, APPLY, FRONT_LOCK)

# a step's round kind (LLMEngine.last_step_kind at the step's end)
KINDS = ("ragged", "prefill", "decode", "idle")

_NO_RANGE = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range `name` while a profiler runs, else a
    shared no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NO_RANGE


def begin(name: str):
    """Enter the range `name` while a profiler runs; returns the handle
    for `end` (None when none was entered). For a range that ends inside
    a ``with`` block it does not enclose."""
    if not _profiler._is_profiler_enabled:
        return None
    rng = _profiler.record_function(name)
    rng.__enter__()
    return rng


def end(rng) -> None:
    if rng is not None:
        rng.__exit__(None, None, None)


def causal_keys(start: int, end: int) -> int:
    """Keys the rows at positions start..end-1 see: sum of (p + 1)."""
    return (end * (end + 1) - start * (start + 1)) // 2


class StepMeter:
    """The engine's step counters. Owned by one LLMEngine and written
    only by the thread that steps it."""

    def __init__(self):
        self.steps = dict.fromkeys(KINDS, 0)
        self.host_s = dict.fromkeys(KINDS, 0.0)
        self.wait_s = dict.fromkeys(KINDS, 0.0)
        self.syncs = 0
        self.prompt_tokens = 0
        self.prompt_keys = 0
        self.decode_keys = 0
        self.first_tokens = 0
        self._step_wait = 0.0  # seam seconds of the step in flight

    def fetch(self, to_host, t):
        """`to_host(t)` as the step's device->host seam: counted, timed
        and in a ``step.wait`` range."""
        t0 = time.perf_counter()
        with span(WAIT):
            out = to_host(t)
        self._step_wait += time.perf_counter() - t0
        self.syncs += 1
        return out

    def step_done(self, kind: str, seconds: float) -> None:
        """A step of `seconds` (wall) whose round was of `kind`."""
        wait, self._step_wait = self._step_wait, 0.0
        self.steps[kind] += 1
        self.wait_s[kind] += wait
        self.host_s[kind] += seconds - wait

    def prompt_chunk(self, start: int, length: int) -> None:
        """Prompt rows start..start+length-1 computed."""
        self.prompt_tokens += length
        self.prompt_keys += causal_keys(start, start + length)

    def token(self, first: bool, context: int) -> None:
        """A generated token kept: a request's first, or a later one
        whose forward saw `context` keys."""
        if first:
            self.first_tokens += 1
        else:
            self.decode_keys += context

    def snapshot(self) -> dict:
        """The EngineStatsSnapshot fields."""
        return dict(
            steps_by_kind=dict(self.steps),
            step_host_seconds_by_kind=dict(self.host_s),
            step_wait_seconds_by_kind=dict(self.wait_s),
            host_syncs_total=self.syncs,
            prompt_tokens_total=self.prompt_tokens,
            prompt_keys_total=self.prompt_keys,
            decode_keys_total=self.decode_keys,
            first_tokens_total=self.first_tokens,
        )
