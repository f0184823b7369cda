#!/usr/bin/env python3
"""Time the PyTorch port's CUDA kernels of several trees on one card, in
turns.

    python3 scripts/torch_kernel_ab.py build/parent . . build/parent

Each argument is the root of a checkout of this repository, for example
a parent commit unpacked with `git archive` into a gitignored directory.
For each, in the order given, a fresh Python process builds that tree's
kernels and runs its `chip_smoke.kernel_phase` (checks against the plain
versions included), so every tree is timed on the same card under the
same power limit. The `kernel ...` lines each turn prints are passed
through with the turn's tree in front; the last line is a JSON object
with each turn's tree and kernel stats. Exits 1 if a turn fails, and
when there is no card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = (
    "import json, sys, torch\n"
    "sys.path.insert(0, '.')\n"
    "import chip_smoke\n"
    "stats = chip_smoke.kernel_phase(torch)\n"
    "print('AB_STATS ' + json.dumps(stats), flush=True)\n"
)


def turn(tree: Path) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tree)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    stats = None
    for line in proc.stdout.splitlines():
        if line.startswith("AB_STATS "):
            stats = json.loads(line[len("AB_STATS "):])
        elif line.startswith("kernel "):
            print(f"[{tree}] {line}", flush=True)
    if proc.returncode or stats is None:
        print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n",
              file=sys.stderr)
        sys.exit(f"torch_kernel_ab: the turn in {tree} failed "
                 f"({proc.returncode})")
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: needs a card")
    trees = [Path(a).resolve() for a in sys.argv[1:]]
    if not trees or not all((t / "chip_smoke.py").is_file() for t in trees):
        sys.exit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    turns = [{"tree": str(t), "stats": dict(turn(t))} for t in trees]
    print(json.dumps({"turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
