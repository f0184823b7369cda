"""The arithmetic of the step loop's metrics, from what the program
records itself (``production_stack_tpu_torch/tracing/steps.py``): the
step meter's counters in the snapshots at the window's edges, its host
ranges in the traced span, and each request's ``lock_wait_s``.

A program without them (an older commit) has neither the counters nor
the ranges: every function here then returns None, and the metric is
left out of the result.
"""

from __future__ import annotations

from portbench import roofline, stats

# the program's range names (tracing/steps.py)
ENGINE_STEP = "engine.step"
WAIT = "step.wait"
# the step thread's ranges outside its steps
LOOP = ("engine.lock", "engine.idle")


def delta(run, name: str):
    """after - before of a snapshot field (a number, or a dict of them
    by key); None when the program has no such field."""
    a = getattr(run.after, name, None)
    b = getattr(run.before, name, None)
    if a is None or b is None:
        return None
    if isinstance(a, dict):
        return {k: v - b.get(k, 0) for k, v in a.items()}
    return a - b


def ms_per_step(run, field: str, kind: str) -> float | None:
    """Milliseconds a step of round kind `kind` over the window, of the
    step meter's seconds-by-kind `field`: ``step_host_seconds_by_kind``
    (each step's wall time less its time in the device->host seam) or
    ``step_wait_seconds_by_kind`` (its time in the seam)."""
    steps = delta(run, "steps_by_kind")
    secs = delta(run, field)
    if steps is None or secs is None or steps.get(kind, 0) <= 0:
        return None
    return 1e3 * secs[kind] / steps[kind]


def syncs_per_round(run) -> float | None:
    """Device->host fetches a step whose round was not idle."""
    syncs = delta(run, "host_syncs_total")
    steps = delta(run, "steps_by_kind")
    if syncs is None or steps is None:
        return None
    rounds = sum(n for k, n in steps.items() if k != "idle")
    return syncs / rounds if rounds > 0 else None


def window_flops(run) -> float | None:
    """The FLOPs of the work served in the window, from the program's
    counters: every computed prompt row and every generated token after
    a request's first through the layers' matmuls, the attention of
    every key they saw, and lm_head for every generated token. Equal to
    roofline.prefill_work + decode_work over the same whole requests."""
    names = ("prompt_tokens_total", "generation_tokens_total",
             "first_tokens_total", "prompt_keys_total", "decode_keys_total")
    d = {n: delta(run, n) for n in names}
    if any(v is None for v in d.values()):
        return None
    s = run.shape
    rows = (d["prompt_tokens_total"] + d["generation_tokens_total"]
            - d["first_tokens_total"])
    keys = d["prompt_keys_total"] + d["decode_keys_total"]
    return (2 * s.layer_matmul_params * s.layers * rows
            + 4 * s.heads * s.head_dim * s.layers * keys
            + 2 * s.hidden * s.vocab * d["generation_tokens_total"])


def window_mfu(run) -> float | None:
    """window_flops over the window's seconds at the H100's bf16 peak,
    in percent."""
    flops = window_flops(run)
    span = run.t_close - run.t_open
    if not flops or span <= 0:
        return None
    return 100.0 * flops / (span * roofline.BF16_FLOPS)


def merged(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out if e > s]


def overlap_length(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def step_ranges(trace) -> list[tuple[int, int]]:
    """The span's ``engine.step`` ranges, with the step it opened in. A
    range entered before the profiler started is not recorded, but the
    ranges it enters afterwards are: ``step.*`` ranges before the first
    recorded ``engine.step`` mark a step in flight from the span's start
    to the loop's next range (its next lock, idle wait or step). A range
    open at the span's end is recorded up to it."""
    t0, t1 = trace.t0_ns, trace.t1_ns
    steps = [(s, e) for s, e, n in trace.host if n == ENGINE_STEP]
    first = min((s for s, _ in steps), default=t1)
    orphans = [e for s, e, n in trace.host
               if n.startswith("step.") and s < first]
    if orphans:
        done = max(orphans)
        nxt = min((s for s, _, n in trace.host
                   if (n in LOOP or n == ENGINE_STEP) and s >= done),
                  default=t1)
        steps.append((t0, nxt))
    return merged(stats.clip(steps, t0, t1))


def idle_split(trace) -> dict | None:
    """The span's device-idle seconds split by what the step thread was
    in: ``between`` (no step open), ``in_step`` (a step open, no
    ``step.wait``) and ``in_wait`` (both). The three add up to the
    span's idle seconds. None without a trace or with no step in it."""
    if trace is None or trace.span_s <= 0:
        return None
    t0, t1 = trace.t0_ns, trace.t1_ns
    steps = step_ranges(trace)
    if not steps:
        return None
    waits = merged(stats.clip([(s, e) for s, e, n in trace.host
                               if n == WAIT], t0, t1))
    idle = stats.gaps(trace.device_intervals(), t0, t1)
    idle_ns = sum(e - s for s, e in idle)
    in_any_step = overlap_length(idle, steps)
    waiting = [(max(s, ws), min(e, we)) for s, e in steps
               for ws, we in waits if min(e, we) > max(s, ws)]
    in_wait = overlap_length(idle, merged(waiting))
    return {"between": (idle_ns - in_any_step) / 1e9,
            "in_step": (in_any_step - in_wait) / 1e9,
            "in_wait": in_wait / 1e9}


def idle_share(run, part: str) -> float | None:
    """One part of idle_split, as a percent of the span."""
    split = idle_split(run.trace)
    if split is None:
        return None
    return 100.0 * split[part] / run.trace.span_s


def lock_waits(run) -> list[float] | None:
    """The seconds each request due in the window waited for the
    engine's lock in ``generate``; one with no record by the close
    waits from when it was sent to the close. None when no request
    carries the program's record."""
    waits, recorded = [], False
    for r in run.requests:
        if not run.t_open <= r.due_s < run.t_close:
            continue
        if r.metrics is None:
            waits.append(max(0.0, run.t_close - r.sent_s))
            continue
        w = getattr(r.metrics, "lock_wait_s", None)
        if w is not None:
            recorded = True
            waits.append(w)
    return waits if recorded else None
