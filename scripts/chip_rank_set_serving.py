#!/usr/bin/env python3
"""Run chip_smoke.py's rank-set serving phase alone on one card.

    python3 scripts/chip_rank_set_serving.py

It builds the kernels, runs chip_smoke.decode_phase for the near-tie
bound, serves the long-context phase's lane scenario on a tp=1 lane
engine of Llama-3.2-3B (chip_smoke.TP_LAYERS layers, as the phase's
rank sets) for the first-token logits that part (g) holds
the tp=2 lane to, then runs chip_smoke.rank_set_serving_phase ((e) async
decode, (f) the warm-up sweep, (g) the ring at tp=2 x sp=2). Every check
of the phase is fatal, as in chip_smoke.py; exits 1 with no card.
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
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
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
    eng = LLMEngine(EngineConfig(
        model=c.cut_3b(), tokenizer="byte", device="cuda",
        block_size=32, num_kv_blocks=640, max_num_seqs=8, seed=c.SEED,
        long_prefill_threshold=c.LC_THRESHOLD,
        context_parallel_size=c.LC_SP, long_prefill_chunk=c.LC_CHUNK))
    first = c.lane_logits(eng.long_prefill)
    sp = SamplingParams(max_tokens=c.LC_DECODE_TOKENS, temperature=0,
                        ignore_eos=True, logprobs=2)
    r = c.lc_scenario(torch, pa, eng, "lc-lane-", sp)
    print(f"tp=1 lane: TTFT {r['ttft']:.3f}s", flush=True)
    eng.shutdown()
    del eng
    c.release(torch)
    counts = c.rank_set_serving_phase(torch, pa, gap_tol, smi,
                                      first["lc-lane-long"])
    print(f"launches a rank: {counts}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
