"""The port's step meter (tracing/steps.py) on the CPU, on the smallest
port engine, one engine for the file:

- over a short mixed run the step counters agree with the round kinds
  the scheduler planned, and host_syncs_total with the calls through
  the engine's _to_numpy seam;
- a speculative round's verify fetch goes through that seam and is
  counted (on a second tiny engine, with n-gram drafts on);
- the counters' FLOPs equal the benchmark's served-work arithmetic
  (portbench/roofline.py's prefill_work + decode_work, written out here)
  over the same whole requests;
- under torch.profiler with profile_all_threads, as the benchmark starts
  it, the step thread's engine.step and step.* ranges are recorded,
  nested, and the front's front.lock range with them;
- with no profiler running no range is entered;
- AsyncLLMEngine.generate stamps each request's lock_wait_s.
"""

import asyncio
import random

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from production_stack_tpu_torch.engine import llm_engine
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.tracing import steps

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

CFG = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=4, num_kv_blocks=256,
           max_num_seqs=4, max_prefill_chunk=32, seed=0,
           num_scheduler_steps=4)
GREEDY = SamplingParams(max_tokens=10, temperature=0.0, ignore_eos=True)
RNG = random.Random(26)


def prompt(n):
    return [RNG.randint(1, 250) for _ in range(n)]


@pytest.fixture(scope="module")
def aeng():
    """The file's one engine: its LLMEngine is stepped by hand until the
    async tests start its step thread."""
    a = AsyncLLMEngine(EngineConfig(**CFG, device="cpu"))
    yield a
    a.shutdown()


def mixed_run(eng):
    """Three prompts, then two more while the first decode (ragged
    rounds), one sharing a cached prefix; returns each request's final
    output."""
    shared = prompt(24)
    reqs = {"a": prompt(40), "b": prompt(53), "c": shared + prompt(9)}
    late = {"d": prompt(70), "e": shared + prompt(13)}
    tag = RNG.randint(0, 1 << 30)
    for k, p in reqs.items():
        eng.add_request(f"{k}{tag}", prompt_token_ids=p,
                        sampling_params=GREEDY)
    finals, n = {}, 0
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = out
        n += 1
        if n == 3:
            for k, p in late.items():
                eng.add_request(f"{k}{tag}", prompt_token_ids=p,
                                sampling_params=GREEDY)
    return list(finals.values())


def test_counters_agree_with_the_planned_rounds(aeng, monkeypatch):
    eng = aeng.engine
    planned = {k: 0 for k in steps.KINDS}
    plan = eng._schedule_round

    def spy():
        out = plan()
        planned[eng.last_step_kind] += 1
        return out

    fetches = []
    to_numpy = llm_engine._to_numpy
    monkeypatch.setattr(eng, "_schedule_round", spy)
    monkeypatch.setattr(llm_engine, "_to_numpy",
                        lambda t: (fetches.append(1), to_numpy(t))[1])
    before = eng.stats()
    mixed_run(eng)
    after = eng.stats()
    got = {k: after.steps_by_kind[k] - before.steps_by_kind[k]
           for k in steps.KINDS}
    assert got == planned
    assert planned["ragged"] > 0 and planned["decode"] > 0
    assert planned["prefill"] > 0
    assert after.host_syncs_total - before.host_syncs_total == len(fetches)
    assert len(fetches) > 0
    for k in steps.KINDS:
        host = (after.step_host_seconds_by_kind[k]
                - before.step_host_seconds_by_kind[k])
        wait = (after.step_wait_seconds_by_kind[k]
                - before.step_wait_seconds_by_kind[k])
        assert host >= 0 and wait >= 0
        assert (host > 0) == (got[k] > 0)


def test_verify_fetch_is_counted(monkeypatch):
    eng = LLMEngine(EngineConfig(**CFG, num_speculative_tokens=2,
                                 device="cpu"))
    verified, fetched = [], []
    verify, to_numpy = eng.runner.verify_batch, llm_engine._to_numpy
    monkeypatch.setattr(eng.runner, "verify_batch",
                        lambda *a, **kw: (verified.append(verify(*a, **kw)),
                                          verified[-1])[1])
    monkeypatch.setattr(llm_engine, "_to_numpy",
                        lambda t: (fetched.append(t), to_numpy(t))[1])
    before = eng.stats()
    # a repetitive prompt: prompt lookup drafts from its first decode
    eng.generate([[65, 66, 67] * 5 + [65, 66]], [GREEDY])
    after = eng.stats()
    assert verified
    assert all(any(v is t for t in fetched) for v in verified)
    assert after.host_syncs_total - before.host_syncs_total == len(fetched)


def served_flops(mc, outs):
    """portbench/roofline.py's prefill_work + decode_work FLOPs over
    whole requests: a prompt's uncached rows, one attention call over
    its context and the first token's logits; each later token one row,
    its context and its logits."""
    p = (mc.hidden_size * mc.num_heads * mc.head_dim
         + 2 * mc.hidden_size * mc.num_kv_heads * mc.head_dim
         + mc.num_heads * mc.head_dim * mc.hidden_size
         + 3 * mc.hidden_size * mc.intermediate_size)
    attn = 4 * mc.num_heads * mc.head_dim * mc.num_layers
    head = 2 * mc.hidden_size * mc.vocab_size
    total = 0
    for o in outs:
        n, cached = len(o.prompt_token_ids), o.num_cached_tokens
        keys = (n * (n + 1) - cached * (cached + 1)) // 2
        total += 2 * p * mc.num_layers * (n - cached) + attn * keys + head
        for j in range(2, len(o.token_ids) + 1):
            total += 2 * p * mc.num_layers + attn * (n + j - 1) + head
    return total


def counter_flops(mc, before, after):
    """The benchmark's mfu.window arithmetic on the step meter's
    counters."""
    def d(name):
        return getattr(after, name) - getattr(before, name)

    p = (mc.hidden_size * mc.num_heads * mc.head_dim
         + 2 * mc.hidden_size * mc.num_kv_heads * mc.head_dim
         + mc.num_heads * mc.head_dim * mc.hidden_size
         + 3 * mc.hidden_size * mc.intermediate_size)
    rows = (d("prompt_tokens_total") + d("generation_tokens_total")
            - d("first_tokens_total"))
    keys = d("prompt_keys_total") + d("decode_keys_total")
    return (2 * p * mc.num_layers * rows
            + 4 * mc.num_heads * mc.head_dim * mc.num_layers * keys
            + 2 * mc.hidden_size * mc.vocab_size
            * d("generation_tokens_total"))


def test_counter_flops_equal_the_served_work(aeng):
    eng = aeng.engine
    before = eng.stats()
    outs = mixed_run(eng)
    after = eng.stats()
    assert len(outs) == 5 and all(len(o.token_ids) == 10 for o in outs)
    assert any(o.num_cached_tokens > 0 for o in outs)
    assert after.first_tokens_total - before.first_tokens_total == 5
    mc = eng.runner.model_config
    want = served_flops(mc, outs)
    assert counter_flops(mc, before, after) == pytest.approx(want,
                                                             rel=1e-9)


def test_no_range_without_a_profiler(aeng, monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    assert steps.span(steps.ENGINE_STEP) is steps.span(steps.WAIT)
    steps.end(steps.begin(steps.FRONT_LOCK))
    mixed_run(aeng.engine)
    assert entered == []
    # the spy stands where a running profiler's range would be entered
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    with steps.span(steps.ENGINE_STEP):
        pass
    assert entered == [steps.ENGINE_STEP]


async def session(a, n):
    async def one(i):
        outs = [o async for o in a.generate(
            f"s{i}", prompt_token_ids=prompt(20 + 9 * i),
            sampling_params=GREEDY)]
        return outs[-1]

    return await asyncio.gather(*(one(i) for i in range(n)))


@pytest.fixture(scope="module")
def served(aeng):
    """The step thread started once: requests sent concurrently through
    generate under a profiler started as the benchmark starts it."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))

    async def main():
        aeng.start(asyncio.get_running_loop())
        prof.start()
        try:
            return await session(aeng, 4)
        finally:
            prof.stop()

    outs = asyncio.run(main())
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.name() in steps.RANGES]
    return outs, ranges


def test_ranges_recorded_and_nested(served):
    _, ranges = served
    names = {n for _, _, n in ranges}
    assert {steps.ENGINE_STEP, steps.SCHEDULE, steps.PREPARE,
            steps.LAUNCH, steps.WAIT, steps.APPLY,
            steps.FRONT_LOCK} <= names
    outer = [(s, e) for s, e, n in ranges if n == steps.ENGINE_STEP]
    inner = [(s, e, n) for s, e, n in ranges if n.startswith("step.")]
    assert inner
    for s, e, n in inner:
        assert any(os <= s and e <= oe for os, oe in outer), n
    # the step thread's own ranges lie outside its steps
    for s, e, n in ranges:
        if n in (steps.ENGINE_LOCK, steps.ENGINE_IDLE):
            assert not any(os < s and e < oe for os, oe in outer), n


def test_lock_wait_stamped(served):
    outs, _ = served
    assert len(outs) == 4
    for o in outs:
        assert o.finished and len(o.token_ids) == 10
        assert o.metrics.lock_wait_s is not None
        assert o.metrics.lock_wait_s >= 0
