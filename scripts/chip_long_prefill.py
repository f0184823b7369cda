#!/usr/bin/env python3
"""Run chip_smoke.py's long-context phase alone on one card.

    python3 scripts/chip_long_prefill.py

It builds the kernels, runs chip_smoke.decode_phase for the near-tie
bound, then chip_smoke.long_context_phase: (a) the ring against its
oracle, (b) the 28-layer prefiller against chunked prefill, (c) the lane
engine with its ring captured, the same engine with its ring's chunks
eager and the chunked control on one scenario, (d) the lane through the
CLI. Every check of the phase is fatal, as in chip_smoke.py; exits 1
with no card.
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
    from production_stack_tpu_torch.ops import cuda_build
    from production_stack_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = c.nvidia_smi()
    print(f"card: {smi}", flush=True)
    cuda_build.build()
    cuda_build.load()
    _, gap_tol = c.decode_phase(torch, pa)
    c.long_context_phase(torch, pa, gap_tol, smi)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
