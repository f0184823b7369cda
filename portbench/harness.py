"""One run of one cell, as a function: weights from the seed, the port's
engine with every program built, a short warm-up, the traffic's ramp,
the measured window, then the check against the plain reference and the
metrics.

``run.py`` is the command around it: it checks the card and the modules
loaded, and prints the result. ``sweep.py`` finds an open-loop cell's
knee with the same engine.
"""

from __future__ import annotations

import asyncio
import gc
import json
import time
from dataclasses import dataclass
from pathlib import Path

import torch
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sampling_params import SamplingParams

from portbench import check, roofline
from portbench import trace as tracemod
from portbench.drive import Driver, WarmupPlan
from portbench.generator import (
    STREAM_MEASURED,
    STREAM_WARMUP,
    Plan,
    spec_range,
    with_overrides,
)
from portbench.manifest import Layout
from portbench.weights import make_params

# the warm-up by traffic that follows precompile_serving: at least
# min_s, until no program was built for stable_s, at most max_s
WARMUP = {"min_s": 4.0, "stable_s": 2.0, "max_s": 30.0, "answer_tokens": 16}


def greedy(max_tokens: int) -> SamplingParams:
    return SamplingParams(max_tokens=max_tokens, temperature=0.0,
                          ignore_eos=True)


class Cell:
    """A cell's files, found by its name in BENCHMARK.json. The cell's
    own file gives its engine arguments, any traffic overrides, its ramp
    (s, quiet_s, max_s), the traced span's seconds and its limits."""

    def __init__(self, layout: Layout, name: str):
        self.name = name
        self.workload = layout.workload(name)
        self.spec = layout.cell(name)
        self.config = layout.config(self.workload["config"])
        self.hf = self.config["hf_config"]
        self.mix = with_overrides(layout.traffic(self.workload["traffic"]),
                                  self.spec.get("traffic_overrides"))
        self.ramp = self.spec["ramp"]
        self.shape = roofline.Shape.from_hf(self.hf)
        self.model_dir = model_dir(layout, self.config)

    def engine(self, seed: int, device: str, log):
        """(engine, weights): the weights drawn from the seed, the port's
        engine on them, and every program its configuration can reach
        built. A warm-up by traffic alone left rare (rows, pages) buckets
        of the ragged round to be built inside the window."""
        params = make_params(self.hf, seed, device,
                             getattr(torch, self.config["dtype"]))
        ecfg = EngineConfig(model=str(self.model_dir), device=device,
                            seed=int(seed) % 2**31,
                            **{**self.config["engine"],
                               **self.spec.get("engine", {})})
        aeng = AsyncLLMEngine(ecfg, params=params)
        t = time.perf_counter()
        n = aeng.engine.precompile_serving()
        log(f"precompile_serving: {n} dispatches, "
            f"{aeng.engine.stats().compile_events_total} programs, "
            f"{time.perf_counter() - t:.1f} s")
        return aeng, params

    def plan(self, seed: int, mix: dict | None = None) -> Plan:
        return Plan(mix or self.mix, seed, self.hf["vocab_size"],
                    STREAM_MEASURED)

    def warm_plan(self, seed: int, ecfg: EngineConfig) -> WarmupPlan:
        """The warm-up's traffic: single requests whose contexts span the
        mix's, with short answers, so long contexts come early."""
        plan = Plan(self.mix, seed, self.hf["vocab_size"], STREAM_WARMUP)
        answer = int(WARMUP["answer_tokens"])
        lo = (len(plan.shared_prefix) + int(self.mix.get("history_tokens", 0))
              + int(spec_range(self.mix["user_tokens"])[0]) + answer)
        hi = max(lo, min(plan.max_context(), ecfg.resolved_max_model_len()))
        clients = ecfg.max_num_seqs if plan.open_loop else plan.clients
        return WarmupPlan(plan, clients, lo, hi, answer)


@dataclass
class RunData:
    """What a metric reader reads."""
    requests: list          # the measured requests (drive.Request)
    t_open: float           # the window, perf clock
    t_close: float
    perf0: float            # one instant on both clocks
    wall0: float
    before: object          # engine counters at the window's edges
    after: object
    shape: roofline.Shape
    trace: tracemod.TraceData | None
    setup_s: float
    kv_usage: list          # the engine's kv_usage, sampled each second

    def wall(self, perf: float) -> float:
        return self.wall0 + (perf - self.perf0)

    def perf(self, wall: float) -> float:
        return self.perf0 + (wall - self.wall0)


@dataclass
class Served:
    requests: list
    warm_requests: list
    t_open: float
    t_close: float
    before: object
    after: object
    span: tracemod.Span | None
    compiles_in_window: dict
    warmup_s: float
    ramp_s: float
    kv_usage: list


def model_dir(layout: Layout, config: dict) -> Path:
    """The configuration's published config.json, written where the
    port's loader reads a model directory (no weights there: the
    benchmark hands the engine its own)."""
    d = layout.pkg / ".build" / "models" / config["name"]
    d.mkdir(parents=True, exist_ok=True)
    f = d / "config.json"
    text = json.dumps(config["hf_config"], indent=1, sort_keys=True)
    if not f.exists() or f.read_text() != text:
        f.write_text(text)
    return d


async def until_quiet(runner, start: float, least_s: float, quiet_s: float,
                      most_s: float, clock) -> None:
    """Returns once `least_s` have passed since `start` and no program
    has been built for `quiet_s`, or at `most_s`."""
    last, quiet_since = runner.compile_events_total, start
    while True:
        await asyncio.sleep(0.25)
        now = clock()
        if runner.compile_events_total != last:
            last, quiet_since = runner.compile_events_total, now
        if now - start >= most_s or (now - start >= least_s
                                     and now - quiet_since >= quiet_s):
            return


def held_metrics(engine) -> dict:
    """The RequestMetrics of every request the engine's scheduler holds,
    by request id: admitted (running) or not (waiting)."""
    sched = engine.scheduler
    return {s.request_id: s.metrics
            for s in list(sched.running) + list(sched.waiting)}


async def sample_kv(engine, until: float, clock, out: list) -> None:
    """The share of KV blocks in use, once a second until `until`."""
    while clock() < until:
        out.append(engine.stats().kv_usage)
        await asyncio.sleep(1.0)


async def warm_up(aeng, cell: Cell, seed: int, clock) -> tuple[list, float]:
    """The warm-up by traffic; returns its requests and seconds."""
    t = clock()
    w = Driver(aeng, cell.warm_plan(seed, aeng.config), greedy, "warm",
               clock)
    w.start(t, t + WARMUP["max_s"])
    await until_quiet(aeng.engine.runner, t, WARMUP["min_s"],
                      WARMUP["stable_s"], WARMUP["max_s"], clock)
    await w.close()
    return w.requests, clock() - t


async def serve(aeng, cell: Cell, seed: int, seconds: float,
                span_s: float | None, clock=time.perf_counter) -> Served:
    """The warm-up, then the measured traffic: its ramp until steady and
    quiet, then the window. A traced span takes the window's last
    `span_s` seconds, so that the profiler's stop, which holds this
    loop, comes after the close."""
    aeng.start(asyncio.get_running_loop())
    runner = aeng.engine.runner
    warm_requests, warmup_s = await warm_up(aeng, cell, seed, clock)
    while aeng.engine.has_unfinished():
        await asyncio.sleep(0.01)

    d = Driver(aeng, cell.plan(seed), greedy, "req", clock)
    begin = clock()
    d.start(begin, float("inf"))
    await until_quiet(runner, begin, cell.ramp["s"], cell.ramp["quiet_s"],
                      cell.ramp["max_s"], clock)
    before = aeng.engine.stats()
    t_open = clock()
    t_close = d.stop_s = t_open + seconds
    kv_usage: list = []
    sampler = asyncio.create_task(
        sample_kv(aeng.engine, t_close, clock, kv_usage))
    span = None
    if span_s:
        span = tracemod.Span()
        await asyncio.sleep(max(0.0, t_close - span_s - clock()))
        span.start()
    await asyncio.sleep(max(0.0, t_close - clock()))
    after = aeng.engine.stats()
    held = held_metrics(aeng.engine)
    if span is not None:
        span.stop()
    await sampler
    for r in d.requests:  # no output yet: the engine's own record
        if r.metrics is None:
            r.metrics = held.get(r.request_id)
    compiles = {k: v - before.compile_events.get(k, 0)
                for k, v in after.compile_events.items()
                if v != before.compile_events.get(k, 0)}
    aeng.shutdown()  # the step thread stops; the streams are cut next
    await d.close()
    return Served(d.requests, warm_requests, t_open, t_close, before, after,
                  span, compiles, warmup_s, t_open - begin, kv_usage)


def judged(checks: dict) -> bool:
    """Whether every number compared keeps its limit."""
    return all((c["value"] >= c["limit"]) if c.get("at_least")
               else (c["value"] <= c["limit"]) for c in checks.values())


def run_cell(layout: Layout, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, process_start: float, log,
             control: bool = False) -> dict:
    """One run; returns the result (the contract's last line, without the
    module check) with the numbers compared under "checks", last. With
    `control` the float8 control is judged too, by the same checks with
    its gap in the program's place, under "control"."""
    cell = Cell(layout, cell_name)
    cuda = device.startswith("cuda")
    if trace:
        # the profiler starts once before the engine: CUPTI before any
        # graph is captured, so that the span sees each kernel a graph
        # replays (pytorch/pytorch#75504), and so that the span's own
        # start in the window is quick
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            pass
    aeng, params = cell.engine(seed, device, log)
    if trace:
        # host spans of the step loop, for naming the device's idle gaps
        step = aeng.engine.step

        def traced_step():
            with torch.profiler.record_function(tracemod.HARNESS_SPANS[0]):
                return step()

        aeng.engine.step = traced_step
    perf0, wall0 = time.perf_counter(), time.time()
    span_s = cell.spec["trace_span_s"] if trace else None
    served = asyncio.run(serve(aeng, cell, seed, seconds, span_s))
    setup_s = wall0 + (served.t_open - perf0) - process_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    t = time.perf_counter()
    trace_data = served.span.collect() if served.span else None
    del aeng
    served.span = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"warm-up {served.warmup_s:.1f} s, ramp {served.ramp_s:.1f} s; "
        f"programs built in the window: {served.compiles_in_window or 0}")
    if trace_data is not None:
        log(f"device activity in the span: {trace_data.kinds}; read in "
            f"{time.perf_counter() - t:.1f} s")

    reqs = served.requests
    window = [r for r in reqs
              if any(served.t_open <= t < served.t_close
                     for t, _ in r.chunks)]
    sample = check.draw_sample(window, seed)
    t = time.perf_counter()
    verdict = check.judge(cell.hf, params, sample, device, control)
    log(f"reference: {verdict['requests']} requests, "
        f"{verdict['positions']} served tokens, "
        f"{time.perf_counter() - t:.1f} s")
    failed = sum(r.failed for r in reqs + served.warm_requests)
    checks = {
        "max_logit_gap": {"value": verdict["max_logit_gap"],
                          "limit": cell.spec["limits"]["max_logit_gap"]},
        "failed_requests": {"value": failed, "limit": 0},
        "checked_requests": {"value": verdict["requests"],
                             "limit": check.REQUESTS, "at_least": True},
    }
    correct = judged(checks)

    data = RunData(reqs, served.t_open, served.t_close, perf0, wall0,
                   served.before, served.after, cell.shape, trace_data,
                   setup_s, served.kv_usage)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in layout.metrics(cell_name, kind):
        v = layout.reader(m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(reqs),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_data is not None:
        dev["busy_s"] = trace_data.busy_s()
        dev["window_s"] = trace_data.span_s
        result["breakdown"] = tracemod.breakdown(trace_data)
    if control:
        ctl = {**checks, "max_logit_gap": {
            **checks["max_logit_gap"],
            "value": verdict["control_max_logit_gap"]}}
        result["control"] = {"correct": judged(ctl), "checks": ctl}
    result["checks"] = checks
    return result
