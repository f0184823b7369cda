"""One process (host) of a two-process multi-host job of the port, for
tests/test_torch_multihost.py.

Usage: python torch_multihost_worker.py <process_id> <port> <params.npz>

Both processes join one job on a loopback TCPStore and together hold a
tp=4 rank set of CPU ranks over gloo, two a process (the first in the
process, one spawned). Process 0 runs the LLMEngine (scheduler, sampler,
broadcasting runner) and prints one RESULT line; process 1 runs its
ranks as followers (parallel/launch.run_follower_host) and exits with
its code. The model and engine config are tests/multihost_worker.py's,
the params the JAX ones the test wrote. It imports torch and the port
only."""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.models import config as mcfg
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.parallel import multihost

CFG = mcfg.ModelConfig(
    name="pst-mh-test",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=8,
    num_kv_heads=4,
    head_dim=8,
    max_model_len=128,
    rope_theta=10000.0,
    tie_word_embeddings=True,
)
ENGINE = dict(
    model=CFG.name, tokenizer="byte", device="cpu", dtype="float32",
    cache_dtype="float32", block_size=4, num_kv_blocks=64, max_num_seqs=2,
    max_prefill_chunk=16, tensor_parallel_size=4, multihost=True,
    # spec decode rides the broadcast (verify_batch steps)
    num_speculative_tokens=2, seed=0,
)
# repetitive prompts so n-gram prompt lookup drafts
PROMPTS = [[1, 2, 3, 1, 2, 3, 1], [9, 8, 7, 9, 8, 7, 9]]


def load_params(path: str) -> dict:
    """The nested param tree from a flat npz ("layers/wq" keys)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_numpy(tree, "cpu")


def main() -> int:
    torch.set_num_threads(1)
    pid, port, npz = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mcfg._PRESETS[CFG.name] = CFG
    multihost.initialize(f"127.0.0.1:{port}", num_processes=2,
                         process_id=pid, timeout_s=60)
    cfg = EngineConfig(**ENGINE)
    params = load_params(npz)
    if pid != 0:
        from production_stack_tpu_torch.parallel.launch import (
            run_follower_host,
        )

        return run_follower_host(cfg, params=params, timeout_s=60)
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    engine = LLMEngine(cfg, params=params)
    outs = engine.generate(PROMPTS, SamplingParams(
        max_tokens=4, temperature=0.0, ignore_eos=True))
    vec, _ = engine.embed_one("hello")
    reports = engine.runner.reports()
    print("RESULT " + json.dumps({
        "tokens": [o.token_ids for o in outs],
        "spec_drafts": engine._spec_drafts_total,
        "embed": [float(x) for x in vec],
        "ranks": [(r["rank"], r["dispatch_counts"]) for r in reports],
    }), flush=True)
    if len(sys.argv) > 4:  # wait to be killed (the follower-exit case)
        print("SERVING", flush=True)
        sys.stdin.read()
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
