#!/usr/bin/env python3
"""Run chip_smoke.py's sync phase alone on one card.

    python3 scripts/chip_sync_census.py

It builds the kernels and a default K=8 Llama-3.2-3B engine (the
compiled phase's config) that runs precompile_serving, then runs
chip_smoke.sync_phase: the port's analyzer over its package, and that
engine and a --no-ragged-kernel one serve the mixed scenario and batch 8
under CUDA's
sync debug mode, every host sync of the package counted by site and held
to the analyzer's verdict. Every check of the phase is fatal, as in
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
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import cuda_build
    from production_stack_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = c.nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    cuda_build.build()
    cuda_build.load()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    params = llama.init_params(get_model_config("llama-3.2-3b"), gen,
                               torch.bfloat16, "cuda")
    graphed = c.compiled_engine(torch, params, 8)
    print(f"precompile_serving: {graphed.precompile_serving()} dispatches",
          flush=True)
    counts = c.sync_phase(torch, pa, smi, params, graphed)
    print(f"launches: {counts}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
