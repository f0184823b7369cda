"""The knee of an open-loop cell: one engine, built and warmed up as a
run builds it, then the cell's traffic at each of several session rates
in turn.

    python3 portbench/sweep.py --workload <cell> --seed <n> \
        --rates 0.5,1,1.5 --seconds 35 --ramp 35

For each rate it prints one JSON line: turns sent, the 95th percentile
of TTFT, output tokens/s, and the backlog of turns that were due but
not yet admitted, sampled each second of the measured part, with its
least-squares slope (turns per second). The knee is the highest rate
whose backlog does not grow. Run once, when a cell's rate is chosen; the
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def slope(ts, ys) -> float:
    n = len(ts)
    mt, my = sum(ts) / n, sum(ys) / n
    den = sum((t - mt) ** 2 for t in ts)
    return sum((t - mt) * (y - my) for t, y in zip(ts, ys)) / den


def backlog(requests, now: float, wall: float) -> int:
    """Turns due by `now` and not admitted by `wall`."""
    return sum(1 for r in requests if r.due_s <= now and (
        r.metrics is None or r.metrics.admitted_time is None
        or r.metrics.admitted_time > wall))


async def sweep(aeng, cell, seed: int, rates, seconds: float,
                ramp: float, out) -> None:
    from portbench import stats
    from portbench.drive import Driver
    from portbench.harness import greedy, warm_up

    aeng.start(asyncio.get_running_loop())
    clock = time.perf_counter
    await warm_up(aeng, cell, seed, clock)
    for i, rate in enumerate(rates):
        while aeng.engine.has_unfinished():
            await asyncio.sleep(0.05)
        plan = cell.plan(seed + i, {**cell.mix, "session_rate_per_s": rate})
        d = Driver(aeng, plan, greedy, f"r{i}", clock)
        begin = clock()
        t0, t1 = begin + ramp, begin + ramp + seconds
        d.start(begin, t1)
        samples = []
        await asyncio.sleep(ramp)
        while clock() < t1:
            samples.append((clock() - t0,
                            backlog(d.requests, clock(), time.time())))
            await asyncio.sleep(1.0)
        await d.close()
        ttft = stats.percentile(stats.ttfts(d.requests, t0, t1), 95)
        print(json.dumps({
            "rate": rate,
            "turns_sent": sum(1 for r in d.requests if t0 <= r.due_s < t1),
            "ttft_p95_ms": None if ttft is None else ttft * 1e3,
            "output_tokens_per_s": stats.output_rate(d.requests, t0, t1),
            "backlog": [b for _, b in samples],
            "backlog_slope": (slope(*zip(*samples)) if len(samples) > 2
                              else None),
        }), file=out, flush=True)
    aeng.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=35)
    ap.add_argument("--ramp", type=float, default=35)
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    from portbench.run import cache_env, log

    cache_env()
    from portbench.harness import Cell
    from portbench.manifest import Layout

    cell = Cell(Layout(CHECKOUT), args.workload)
    aeng, _ = cell.engine(args.seed, "cuda", log)
    rates = [float(r) for r in args.rates.split(",")]
    asyncio.run(sweep(aeng, cell, args.seed, rates, args.seconds,
                      args.ramp, sys.stdout))
    return 0


if __name__ == "__main__":
    sys.exit(main())
