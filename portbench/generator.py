"""The one traffic generator: sessions of turns, drawn from a mix's data.

A mix (``traffic/<name>.json``) states how sessions arrive and how long
their parts are. A session is a shared prefix (the same for every
session of a run), a history of its own, then turns: each turn sends the
whole conversation so far plus a user message, and asks for an answer
of a drawn length. The next turn is due a think time after the answer
ends. ``loop: open`` starts sessions as a Poisson process at
``session_rate_per_s``; ``loop: closed`` runs ``clients`` clients, each
starting its next session when the last one ends (a session of one turn
is a single request), their first sessions spread over ``stagger_s``.

Every drawn quantity comes from a block-stratified stream: each
consecutive block of ``block`` draws holds the same quantiles of the
distribution, (j + 0.5) / block for j < block, in an order the seed
shuffles. So two seeds send the same sizes and gaps, in another order,
and a run's work does not change with its seed; the seed picks the
token ids and the order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

# independent streams of one seed
STREAM_MEASURED = 0
STREAM_WARMUP = 1


def quantile(spec: dict, u: float):
    """The value of distribution `spec` at quantile u in (0, 1)."""
    kind = spec["dist"]
    if kind == "const":
        return spec["value"]
    if kind == "uniform_int":
        lo, hi = spec["lo"], spec["hi"]
        return lo + min(int(u * (hi - lo + 1)), hi - lo)
    if kind == "loguniform_int":
        lo, hi = spec["lo"], spec["hi"]
        v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        return min(max(int(round(v)), lo), hi)
    if kind == "exponential":
        return -spec["mean"] * math.log1p(-u)
    raise ValueError(f"unknown distribution {kind!r}")


def spec_range(spec: dict) -> tuple[float, float]:
    """(smallest, largest) value the stratified stream can draw."""
    kind = spec["dist"]
    if kind == "const":
        return spec["value"], spec["value"]
    if kind in ("uniform_int", "loguniform_int"):
        return spec["lo"], spec["hi"]
    raise ValueError(f"no finite range for {kind!r}")


class Stream:
    """Draws of one distribution, block-stratified (see module doc)."""

    def __init__(self, spec: dict, rng: np.random.Generator, block: int):
        self.spec = spec
        self.rng = rng
        self.block = block
        self._pending: list = []

    def next(self):
        if not self._pending:
            order = self.rng.permutation(self.block)
            self._pending = [quantile(self.spec, (j + 0.5) / self.block)
                             for j in order][::-1]
        return self._pending.pop()


@dataclass
class Turn:
    user_ids: list[int]
    max_tokens: int
    think_s: float  # after this turn's answer, before the next turn


@dataclass
class Session:
    index: int
    start_s: float  # offset of an open loop's start; 0 in a closed loop
    history_ids: list[int]
    turns: list[Turn] = field(default_factory=list)


class Plan:
    """The sessions of one run of a mix, generated on demand."""

    def __init__(self, mix: dict, seed: int, vocab_size: int,
                 stream: int = STREAM_MEASURED):
        self.mix = mix
        self.vocab_size = vocab_size
        ss = np.random.SeedSequence([int(seed) % 2**64, stream])
        rngs = [np.random.Generator(np.random.PCG64(s))
                for s in ss.spawn(7)]
        block = int(mix.get("block", 32))
        self._tokens = rngs[0]
        self._order = rngs[1]
        self.turns = Stream(mix["turns"], rngs[2], block)
        self.user = Stream(mix["user_tokens"], rngs[3], block)
        self.answer = Stream(mix["answer_tokens"], rngs[4], block)
        self.think = Stream(mix["think_s"], rngs[5], block)
        self.gap = Stream({"dist": "exponential",
                           "mean": 1.0 / mix["session_rate_per_s"]},
                          rngs[6], block) if mix["loop"] == "open" else None
        self.shared_prefix = self.token_ids(
            int(mix.get("shared_prefix_tokens", 0)))
        self._clock = 0.0
        self._made = 0

    @property
    def open_loop(self) -> bool:
        return self.mix["loop"] == "open"

    @property
    def clients(self) -> int:
        return int(self.mix["clients"])

    @property
    def stagger_s(self) -> float:
        """A closed loop's clients start spread over this many seconds."""
        return float(self.mix.get("stagger_s", 0.0))

    def token_ids(self, n: int) -> list[int]:
        return self._tokens.integers(0, self.vocab_size, n).tolist()

    def order(self, n: int) -> list[int]:
        """0..n-1 in an order drawn from the seed."""
        return self._order.permutation(n).tolist()

    def next_session(self) -> Session:
        if self.gap is not None:
            self._clock += self.gap.next()
        s = Session(self._made, self._clock,
                    self.token_ids(int(self.mix.get("history_tokens", 0))))
        self._made += 1
        for _ in range(int(self.turns.next())):
            s.turns.append(Turn(self.token_ids(int(self.user.next())),
                                int(self.answer.next()),
                                float(self.think.next())))
        return s

    def max_context(self) -> int:
        """The longest conversation a session of this mix can reach."""
        turns = spec_range(self.mix["turns"])[1]
        per_turn = (spec_range(self.mix["user_tokens"])[1]
                    + spec_range(self.mix["answer_tokens"])[1])
        return int(self.mix.get("shared_prefix_tokens", 0)
                   + self.mix.get("history_tokens", 0) + turns * per_turn)


def with_overrides(mix: dict, overrides: dict | None) -> dict:
    """The mix with a cell's overrides (such as its rate) applied."""
    out = dict(mix)
    out.update(overrides or {})
    return out
