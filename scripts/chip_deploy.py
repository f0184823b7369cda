#!/usr/bin/env python3
"""Run chip_smoke.py's deploy phase alone on one card.

    python3 scripts/chip_deploy.py

It writes Llama-3.2-3B at chip_smoke.CKPT_LAYERS layers as a checkpoint
under build/, as chip_smoke.py serves it, then runs
chip_smoke.deploy_phase on it: docker/Dockerfile.cuda's build step into a
fresh kernel directory, a read-only install, the engine from it with no
nvcc reachable on the argv helm/templates/deployment-engine-cuda.yaml
renders for helm/values-h100.yaml's entry, one streamed completion,
/metrics against the dashboard's and alerts' engine names, and SIGTERM
with a stream in flight. Every check of the phase is fatal, as in
chip_smoke.py; exits 1 with no card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this script needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as c

    t0 = time.perf_counter()
    smi = c.nvidia_smi()
    print(f"card: {smi}", flush=True)
    with c.cut_3b_checkpoint(torch, c.CKPT_LAYERS, "cut-") as cut_dir:
        counts = c.deploy_phase(torch, smi, cut_dir)
    print(f"launches: {counts}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
