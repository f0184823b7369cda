"""End to end: 95th percentile, over every request with at least two
tokens in the window, of (last - first token time) / (tokens - 1) taken
from its tokens inside the window (host clock)."""

from portbench import stats


def read(run):
    p = stats.percentile(stats.tpots(run.requests, run.t_open,
                                     run.t_close), 95)
    return None if p is None else p * 1e3
