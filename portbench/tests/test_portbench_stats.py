"""Percentiles, rates, per-request gaps and the idle union, on synthetic
records that hold a stall."""

from dataclasses import dataclass, field

import numpy as np
import pytest

from portbench import stats


@dataclass
class Req:
    due_s: float
    chunks: list = field(default_factory=list)

    @property
    def first_token_s(self):
        return self.chunks[0][0] if self.chunks else None


@pytest.mark.parametrize("q", [0, 5, 50, 90, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(0).exponential(1.0, 137))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([], q) is None


def stalled():
    """Requests due every 0.1 s from t=0; the server stalls from 1.0 to
    2.0 s, so every request due in the stall gets its first token at
    2.0 s, and the one running through it waits too."""
    reqs = []
    for i in range(30):
        due = 0.1 * i
        first = due + 0.05 if not 1.0 <= due + 0.05 < 2.0 else 2.0
        reqs.append(Req(due, [(first, 1), (first + 0.02, 4)]))
    return reqs


def test_ttft_counts_the_stall_from_due():
    reqs = stalled()
    ttft = stats.ttfts(reqs, 0.0, 3.0)
    assert len(ttft) == 30
    # the request due at 1.0 waits until 2.0
    assert max(ttft) == pytest.approx(1.0, abs=1e-9)
    assert stats.percentile(ttft, 95) > 0.5
    inside = stats.ttfts(reqs, 2.5, 3.0)
    assert all(t == pytest.approx(0.05) for t in inside)


def test_output_rate_counts_tokens_in_window():
    reqs = stalled()
    # every request delivers 1 + 4 tokens; the last ones fall past 3.0
    n = sum(c for r in reqs for t, c in r.chunks if 0.0 <= t < 3.0)
    assert stats.output_rate(reqs, 0.0, 3.0) == pytest.approx(n / 3.0)
    assert stats.output_rate(reqs, 1.2, 1.8) == 0.0


def test_tpot_from_tokens_inside():
    r = Req(0.0, [(1.0, 1), (1.2, 8), (1.4, 8), (3.0, 8)])
    # all 25 tokens: (3.0 - 1.0) / 24
    assert stats.tpots([r], 0.0, 5.0) == [pytest.approx(2.0 / 24)]
    # window [1.1, 2.0): 16 tokens from 1.2 to 1.4
    assert stats.tpots([r], 1.1, 2.0) == [pytest.approx(0.2 / 15)]
    # one token inside: no reading
    assert stats.tpots([Req(0.0, [(1.0, 1)])], 0.0, 2.0) == []


def test_union_and_gaps_with_overlapping_streams():
    # compute stream and copy stream overlap; a stall from 5 to 9
    iv = [(0, 3), (2, 4), (4, 5), (9, 10), (9.5, 12), (1, 2)]
    assert stats.union_length(iv) == pytest.approx(5 + 3)
    assert stats.gaps(iv, 0, 12) == [(5, 9)]
    assert stats.gaps(iv, -1, 13) == [(-1, 0), (5, 9), (12, 13)]
    clipped = stats.clip(iv, 2.5, 9.75)
    assert stats.union_length(clipped) == pytest.approx(2.5 + 0.75)
    busy = stats.union_length(clipped) / (9.75 - 2.5)
    assert 1 - busy == pytest.approx(4 / 7.25)
    # a naive sum counts the overlaps twice
    assert sum(e - s for s, e in iv) > stats.union_length(iv)


def test_mirrored_annotations_are_no_device_work():
    from portbench import trace

    class Ev:
        def __init__(self, name, flag=None):
            self._name = name
            if flag is not None:
                self.is_user_annotation = lambda: flag

        def name(self):
            return self._name

    assert trace.annotation(Ev("LLMEngine.step"))
    assert trace.annotation(Ev("anything", True))
    assert not trace.annotation(Ev("ragged_tile_kernel", False))
    assert not trace.annotation(Ev("ragged_tile_kernel"))


@dataclass
class Admit:
    admitted_time: float | None


@dataclass
class Run:
    requests: list
    t_open: float
    t_close: float
    wall0: float = 1000.0

    def perf(self, wall):
        return wall - self.wall0


@dataclass
class Waiting:
    due_s: float
    metrics: object = None


def test_queue_wait_counts_the_unadmitted_to_the_close():
    """Due from 0.0 to 2.9 s; the window is [1, 3). Admission stalls from
    2.0 s: the requests due then are held (waiting, no output) until the
    close, one has no record at all, and they wait until the close."""
    from portbench.metrics import queue_wait_p95_ms

    reqs = []
    for i in range(30):
        due = 0.1 * i
        if due < 2.0:
            m = Admit(1000.0 + due + 0.01)
        elif i == 25:
            m = None
        else:
            m = Admit(None)
        reqs.append(Waiting(due, m))
    run = Run(reqs, 1.0, 3.0)
    waits = [0.01] * 10 + [3.0 - 0.1 * i for i in range(20, 30)]
    expect = stats.percentile(waits, 95) * 1e3
    assert queue_wait_p95_ms.read(run) == pytest.approx(expect)
    assert queue_wait_p95_ms.read(run) > 500  # the stall shows
