"""The traffic generator: deterministic by seed, the stated lengths, and
the same sizes for every seed in another order."""

import json
from collections import Counter

import pytest

from portbench.generator import (
    STREAM_MEASURED,
    STREAM_WARMUP,
    Plan,
    quantile,
    with_overrides,
)

MIXES = ("chat-sessions", "decode-heavy", "long-prompts")

# closed-loop mixes, kept here to hold the generator's closed loop
CLOSED = {
    "decode-heavy": {
        "loop": "closed", "clients": 64, "shared_prefix_tokens": 0,
        "history_tokens": 0, "turns": {"dist": "const", "value": 1},
        "user_tokens": {"dist": "loguniform_int", "lo": 128, "hi": 1024},
        "answer_tokens": {"dist": "uniform_int", "lo": 512, "hi": 1536},
        "think_s": {"dist": "const", "value": 0.0}, "block": 64,
        "stagger_s": 16.0},
    "long-prompts": {
        "loop": "closed", "clients": 8, "shared_prefix_tokens": 0,
        "history_tokens": 0, "turns": {"dist": "const", "value": 1},
        "user_tokens": {"dist": "loguniform_int", "lo": 2048, "hi": 8000},
        "answer_tokens": {"dist": "uniform_int", "lo": 32, "hi": 128},
        "think_s": {"dist": "const", "value": 0.0}, "block": 32,
        "stagger_s": 4.0},
}


def mix(checkout, name):
    if name in CLOSED:
        return dict(CLOSED[name])
    return json.loads((checkout / "portbench" / "traffic"
                       / f"{name}.json").read_text())


def sessions(plan, n):
    return [plan.next_session() for _ in range(n)]


def sizes(ss):
    return [(len(s.history_ids), [(len(t.user_ids), t.max_tokens,
                                   round(t.think_s, 9)) for t in s.turns])
            for s in ss]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(checkout, name):
    m = mix(checkout, name)
    a = sessions(Plan(m, 2**31 + 7, 32000), 40)
    b = sessions(Plan(m, 2**31 + 7, 32000), 40)
    assert sizes(a) == sizes(b)
    assert [t.user_ids for s in a for t in s.turns] == [
        t.user_ids for s in b for t in s.turns]
    assert [s.start_s for s in a] == [s.start_s for s in b]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_sizes_in_another_order(checkout, name):
    m = mix(checkout, name)
    block = m["block"]
    a = sessions(Plan(m, 11, 32000), block)
    b = sessions(Plan(m, 12, 32000), block)
    first = [t.max_tokens for s in a for t in s.turns][:block]
    second = [t.max_tokens for s in b for t in s.turns][:block]
    assert Counter(first) == Counter(second)
    assert [t.user_ids for s in a for t in s.turns] != [
        t.user_ids for s in b for t in s.turns]


def test_streams_differ(checkout):
    m = mix(checkout, "decode-heavy")
    a = Plan(m, 5, 32000, STREAM_MEASURED).next_session()
    b = Plan(m, 5, 32000, STREAM_WARMUP).next_session()
    assert a.turns[0].user_ids != b.turns[0].user_ids


def test_chat_lengths(checkout):
    m = mix(checkout, "chat-sessions")
    plan = Plan(m, 3, 32000)
    assert len(plan.shared_prefix) == 512
    ss = sessions(plan, 200)
    assert all(len(s.history_ids) == 1024 for s in ss)
    assert {len(s.turns) for s in ss} == set(range(4, 11))
    users = [len(t.user_ids) for s in ss for t in s.turns]
    answers = [t.max_tokens for s in ss for t in s.turns]
    # the block's quantiles (j + 0.5) / 32 stop short of both ends
    assert 32 <= min(users) <= 39 and 249 <= max(users) <= 256
    assert 64 <= min(answers) <= 70 and 250 <= max(answers) <= 256
    thinks = [t.think_s for s in ss for t in s.turns]
    assert abs(sum(thinks) / len(thinks) - 2.0) < 0.15
    starts = [s.start_s for s in ss]
    assert starts == sorted(starts)
    rate = len(starts) / starts[-1]
    assert abs(rate - m["session_rate_per_s"]) / m["session_rate_per_s"] < 0.1
    assert plan.max_context() == 512 + 1024 + 10 * (256 + 256) <= 8192


def test_rate_override(checkout):
    m = with_overrides(mix(checkout, "chat-sessions"),
                       {"session_rate_per_s": 4.0})
    ss = sessions(Plan(m, 3, 32000), 320)
    assert abs(len(ss) / ss[-1].start_s - 4.0) < 0.4


@pytest.mark.parametrize("name,lo,hi,alo,ahi", [
    ("decode-heavy", 128, 1024, 512, 1536),
    ("long-prompts", 2048, 8000, 32, 128)])
def test_closed_loop_lengths(checkout, name, lo, hi, alo, ahi):
    m = mix(checkout, name)
    plan = Plan(m, 9, 152064)
    assert not plan.open_loop and plan.clients == {"decode-heavy": 64,
                                                   "long-prompts": 8}[name]
    ss = sessions(plan, 256)
    assert all(len(s.turns) == 1 and not s.history_ids for s in ss)
    assert plan.shared_prefix == []
    users = sorted(len(s.turns[0].user_ids) for s in ss)
    answers = [s.turns[0].max_tokens for s in ss]
    assert lo <= users[0] and users[-1] <= hi
    assert alo <= min(answers) and max(answers) <= ahi
    # log-uniform: the median near the geometric mean
    geo = (lo * hi) ** 0.5
    assert abs(users[len(users) // 2] / geo - 1) < 0.1
    assert all(0 <= t < 152064 for s in ss[:4] for t in s.turns[0].user_ids)
    assert plan.max_context() <= 8192


def test_quantiles():
    assert quantile({"dist": "uniform_int", "lo": 4, "hi": 10}, 0.0001) == 4
    assert quantile({"dist": "uniform_int", "lo": 4, "hi": 10}, 0.9999) == 10
    assert quantile({"dist": "loguniform_int", "lo": 128, "hi": 1024},
                    0.5) == 362
    assert quantile({"dist": "const", "value": 1}, 0.3) == 1
    assert abs(quantile({"dist": "exponential", "mean": 2.0}, 0.5)
               - 2.0 * 0.6931471805599453) < 1e-12
