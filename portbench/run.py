"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port
(``production_stack_tpu_torch``). The cell's files are found by its name
in ``BENCHMARK.json`` (see manifest.py). The run draws its weights and
traffic from the seed, warms up, measures for ``--seconds``, checks the
served tokens against the plain reference, and prints one JSON object as
the last line of standard output: the end-to-end metrics, or with
``--trace 1`` the per-layer ones read from a profiler span in the middle
of the window. The numbers compared for ``correct`` and their limits are
the last lines of standard error and the last key of that object.

It exits with a code other than 0, printing no result, when no CUDA card
is there (or fewer than the cell asks for), and when a JAX module
(``jax``, ``jaxlib``, ``flax``, ``production_stack_tpu``) is loaded.
Build and kernel caches live under ``portbench/.build/`` in the checkout,
so only a checkout's first run builds the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CHECKOUT = PKG.parent


def process_start_time() -> float:
    """Wall time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def cache_env() -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    build = PKG / ".build"
    os.environ["PST_KERNEL_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"  # a library must not load JAX for us


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def refuse_forbidden(when: str) -> None:
    from portbench.manifest import forbidden_modules

    bad = forbidden_modules(list(sys.modules))
    if bad:
        log(f"{when}: JAX modules are loaded: {', '.join(bad)}")
        sys.exit(4)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    started = process_start_time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the float8 control's gap (calibration "
                    "only; the benchmark's runs leave it off)")
    args = ap.parse_args(argv)

    cache_env()
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from portbench.harness import run_cell
    from portbench.manifest import Layout

    layout = Layout(CHECKOUT)
    chips = int(layout.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    import production_stack_tpu_torch as port
    import production_stack_tpu_torch.engine.async_engine  # noqa: F401
    from production_stack_tpu_torch.utils import chip_guard

    if CHECKOUT not in Path(port.__file__).resolve().parents:
        log(f"the port was not found in this checkout ({port.__file__})")
        return 5

    refuse_forbidden("at start")
    lock = chip_guard.engage(device="cuda")
    log(f"card: {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    try:
        result = run_cell(layout, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", started, log,
                          control=bool(args.control))
    finally:
        if lock is not None:
            lock.release()
    refuse_forbidden("after the window")
    if "control" in result:
        gap = result["control"]["checks"]["max_logit_gap"]
        log(f"control max_logit_gap {gap['value']} <= limit {gap['limit']}: "
            f"correct {result['control']['correct']}")
    for name, c in result["checks"].items():
        rule = ">=" if c.get("at_least") else "<="
        log(f"check {name} {c['value']} {rule} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
