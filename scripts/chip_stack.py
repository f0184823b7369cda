#!/usr/bin/env python3
"""Run chip_smoke.py's stack phase alone on one card.

    python3 scripts/chip_stack.py

It builds the kernels, runs chip_smoke.decode_phase for the near-tie
bound, then chip_smoke.stack_phase: a KV controller, four CLI engines of
Llama-3.2-3B at chip_smoke.CKPT_LAYERS layers, as chip_smoke.py serves
it (a checkpoint written under build/; two both-role, a prefill and a
decode engine) and the
port's router in front of them under each routing algorithm in turn,
then one engine SIGTERMed under load. Every check of the phase is fatal,
as in chip_smoke.py; exits 1 with no card.
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
    c.release(torch)
    with c.cut_3b_checkpoint(torch, c.CKPT_LAYERS, "cut-") as cut_dir:
        counts = c.stack_phase(torch, gap_tol, smi, cut_dir)
    print(f"launches an engine: {counts}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
