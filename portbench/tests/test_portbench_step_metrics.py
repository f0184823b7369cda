"""The step loop's readers (lock_wait_p95_ms, step_host_ms.*,
step_wait_ms.ragged, syncs_per_round, idle_in_step_share, idle_between_steps_share,
mfu.window) on RunData built by hand: snapshots of the step meter's
counters, synthetic host ranges and device intervals. Each reads None
where the program it measures records nothing (an older commit), or
where its window holds nothing to read."""

from dataclasses import dataclass, field

import pytest

from portbench import roofline
from portbench.harness import RunData
from portbench.manifest import Layout
from portbench.trace import TraceData

SHAPE = roofline.Shape(layers=2, hidden=64, intermediate=128, heads=4,
                       kv_heads=2, head_dim=16, vocab=384)


@dataclass
class Snap:
    """The step meter's fields of an EngineStatsSnapshot."""
    steps_by_kind: dict = field(default_factory=dict)
    step_host_seconds_by_kind: dict = field(default_factory=dict)
    step_wait_seconds_by_kind: dict = field(default_factory=dict)
    host_syncs_total: int = 0
    prompt_tokens_total: int = 0
    generation_tokens_total: int = 0
    first_tokens_total: int = 0
    prompt_keys_total: int = 0
    decode_keys_total: int = 0


@dataclass
class OldSnap:
    """A snapshot of a program without the step meter."""
    prompt_tokens_total: int = 0
    generation_tokens_total: int = 0


@dataclass
class Metrics:
    lock_wait_s: float | None = None


@dataclass
class Req:
    due_s: float
    sent_s: float
    metrics: object = None


def kinds(ragged, prefill, decode, idle):
    return {"ragged": ragged, "prefill": prefill, "decode": decode,
            "idle": idle}


BEFORE = Snap(kinds(10, 4, 20, 1), kinds(0.1, 0.02, 0.1, 0.0),
              kinds(0.05, 0.01, 0.04, 0.0), 70, 1000, 300, 20, 9000, 50000)
AFTER = Snap(kinds(110, 4, 70, 3), kinds(2.1, 0.02, 0.6, 0.001),
             kinds(0.55, 0.01, 0.29, 0.0), 395, 6000, 2300, 70, 509000,
             2050000)


def run_data(before=BEFORE, after=AFTER, trace=None, requests=()):
    return RunData(list(requests), 100.0, 150.0, 0.0, 0.0, before, after,
                   SHAPE, trace, 10.0, [])


@pytest.fixture
def read(checkout):
    layout = Layout(checkout)
    return lambda name, run: layout.reader(name)(run)


def test_step_host_ms_by_kind(read):
    run = run_data()
    # ragged: 2.0 s over 100 steps; decode: 0.5 s over 50
    assert read("step_host_ms.ragged", run) == pytest.approx(20.0)
    assert read("step_host_ms.decode", run) == pytest.approx(10.0)


def test_step_wait_ms_ragged(read):
    # 0.5 s in the seam over 100 ragged steps
    assert read("step_wait_ms.ragged", run_data()) == pytest.approx(5.0)


def test_syncs_per_round_leaves_idle_steps_out(read):
    # 325 fetches over 100 ragged + 0 prefill + 50 decode rounds
    assert read("syncs_per_round", run_data()) == pytest.approx(325 / 150)


def test_mfu_window_from_counters(read):
    s = SHAPE
    rows = 5000 + 2000 - 50
    keys = 500000 + 2000000
    flops = (2 * s.layer_matmul_params * s.layers * rows
             + 4 * s.heads * s.head_dim * s.layers * keys
             + 2 * s.hidden * s.vocab * 2000)
    want = 100.0 * flops / (50.0 * 989e12)
    assert read("mfu.window", run_data()) == pytest.approx(want, rel=1e-12)


def test_mfu_window_equals_the_served_work_of_whole_requests(read):
    """Counters of two whole requests against roofline's arithmetic."""
    reqs = [(300, 64, 9), (120, 0, 17)]  # (prompt, cached, tokens)
    work = 0.0
    after = Snap()
    for n, cached, toks in reqs:
        work += roofline.prefill_work(SHAPE, n, cached).flops
        for j in range(2, toks + 1):
            work += roofline.decode_work(SHAPE, n, j).flops
        after.prompt_tokens_total += n - cached
        after.prompt_keys_total += roofline.causal_keys(cached, n)
        after.generation_tokens_total += toks
        after.first_tokens_total += 1
        after.decode_keys_total += sum(n + j - 1 for j in range(2, toks + 1))
    got = read("mfu.window", run_data(Snap(), after))
    assert got == pytest.approx(100.0 * work / (50.0 * 989e12), rel=1e-9)


def test_lock_wait_p95(read):
    reqs = [Req(100.0 + i, 100.0 + i, Metrics(0.001 * i))
            for i in range(20)]
    reqs.append(Req(99.0, 99.0, Metrics(5.0)))      # due before the window
    reqs.append(Req(150.5, 150.5, Metrics(5.0)))    # due after it
    # no record by the close: waits from when it was sent to the close
    reqs.append(Req(149.0, 149.4, None))
    waits = sorted([0.001 * i for i in range(20)] + [0.6])
    pos = (len(waits) - 1) * 0.95
    lo = int(pos)
    want = waits[lo] + (waits[lo + 1] - waits[lo]) * (pos - lo)
    got = read("lock_wait_p95_ms", run_data(requests=reqs))
    assert got == pytest.approx(1e3 * want)


# a 100 ms span: the device runs [0, 20) [30, 50) [80, 90) ms, so it
# idles [20, 30) [50, 80) [90, 100): 50 ms. The step thread steps over
# [5, 60), fetching over [40, 58), and over [75, 100), fetching over
# [85, 95).
MS = 1_000_000


def span_trace(host=None):
    t = TraceData(0, 100 * MS, 140.0, 140.1)
    t.device = [(0, 20 * MS, "k1"), (30 * MS, 50 * MS, "k2"),
                (80 * MS, 90 * MS, "k3")]
    t.host = host if host is not None else [
        (5 * MS, 60 * MS, "LLMEngine.step"),
        (5 * MS, 60 * MS, "engine.step"),
        (10 * MS, 15 * MS, "step.prepare"),
        (40 * MS, 58 * MS, "step.wait"),
        (75 * MS, 100 * MS, "engine.step"),
        (85 * MS, 95 * MS, "step.wait"),
        (62 * MS, 70 * MS, "engine.idle"),
    ]
    return t


def test_idle_split(read):
    run = run_data(trace=span_trace())
    # in a step, no fetch: [20, 30) [58, 60) [75, 80) [95, 100) = 22 ms
    assert read("idle_in_step_share.ttft", run) == pytest.approx(22.0)
    # no step open: [60, 75) = 15 ms
    assert read("idle_between_steps_share.ttft", run) == pytest.approx(
        15.0)
    # the three parts add up to the device's idle share
    wait_part = 8.0 + 5.0  # [50, 58) and [90, 95)
    total = read("device_idle_share.ttft", run)
    assert total == pytest.approx(50.0)
    assert (read("idle_in_step_share.ttft", run)
            + read("idle_between_steps_share.ttft", run)
            + wait_part) == pytest.approx(total)


def test_idle_split_clips_to_the_span(read):
    """Ranges open at the span's edges count only inside it."""
    host = [(-50 * MS, 25 * MS, "engine.step"),
            (90 * MS, 300 * MS, "engine.step")]
    run = run_data(trace=span_trace(host))
    # in a step: [20, 25) and [90, 100); between: [25, 30) [50, 80)
    assert read("idle_in_step_share.ttft", run) == pytest.approx(15.0)
    assert read("idle_between_steps_share.ttft", run) == pytest.approx(
        35.0)


def test_idle_split_counts_the_step_the_span_opened_in(read):
    """The profiler starts mid-step: that step's engine.step range is
    not recorded, its later step.* ranges are. The step counts from the
    span's start to the loop's next range, the lock of the next step."""
    host = [(2 * MS, 25 * MS, "step.apply"),
            (27 * MS, 28 * MS, "engine.lock"),
            (28 * MS, 60 * MS, "engine.step"),
            (75 * MS, 100 * MS, "engine.step")]
    run = run_data(trace=span_trace(host))
    # in a step: [20, 27) [28, 30) [50, 60) [75, 80) [90, 100) = 34 ms;
    # between: [27, 28) [60, 75) = 16 ms
    assert read("idle_in_step_share.ttft", run) == pytest.approx(34.0)
    assert read("idle_between_steps_share.ttft", run) == pytest.approx(
        16.0)


@pytest.mark.parametrize("name", [
    "lock_wait_p95_ms", "step_host_ms.ragged", "step_host_ms.decode",
    "step_wait_ms.ragged", "syncs_per_round", "idle_in_step_share.ttft",
    "idle_between_steps_share.ttft", "mfu.window"])
def test_none_from_a_program_without_the_meter(read, name):
    """An older program: no step meter fields, no lock_wait_s, no
    engine.step range (only the harness's own LLMEngine.step)."""
    old_host = [(5 * MS, 60 * MS, "LLMEngine.step")]
    reqs = [Req(100.0 + i, 100.0 + i, object()) for i in range(5)]
    run = run_data(OldSnap(), OldSnap(10, 10), span_trace(old_host), reqs)
    assert read(name, run) is None


def test_none_without_a_trace(read):
    run = run_data()
    assert read("idle_in_step_share.ttft", run) is None
    assert read("idle_between_steps_share.ttft", run) is None


def test_none_for_a_kind_with_no_steps(read):
    after = Snap(**{**AFTER.__dict__,
                    "steps_by_kind": kinds(110, 4, 20, 3)})
    run = run_data(after=after)
    assert read("step_host_ms.decode", run) is None
    assert read("step_host_ms.ragged", run) == pytest.approx(20.0)
    none_ragged = Snap(**{**AFTER.__dict__,
                          "steps_by_kind": kinds(10, 4, 70, 3)})
    assert read("step_wait_ms.ragged", run_data(after=none_ragged)) is None


def test_none_without_requests_in_the_window(read):
    assert read("lock_wait_p95_ms", run_data()) is None
