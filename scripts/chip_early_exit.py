#!/usr/bin/env python3
"""Count the fused decode loop's idle iterations on one card: the
iterations a round ran after every one of its lanes was done.

    python3 scripts/chip_early_exit.py [TREE ...]

For each TREE (a checkout of this repository; default: the one holding
this script), in a process of its own, it builds that tree's kernels and
a K=8 Llama-3.2-3B engine at full width (28 layers, bf16, random weights
from seed 0, the byte tokenizer, contexts capped at 2048 tokens), graphed
and then its eager control, and serves eight 32-token prompts at batch 8
whose lanes stop at different iterations on the data, as EOS stops them:
lane i's stop token id is the token its greedy stream (a probe run with
no stop) sampled at step 3 + 4 * i, and its budget is 40 tokens. Every
fused round (decode_multi, a ragged round) is wrapped: it ran `ran`
iterations, its lanes' valid counts say it needed max(valid), and the
rest were idle (frozen lanes only); of its iterations, the runner's
device counter `loop_forwards` says how many ran their decode forward
(iteration 0 of a ragged round is its step-0 program's and always
runs). A loop that reads its `done` flag back each iteration runs no
idle iteration; one that enqueues up to the lanes' budgets runs some,
and a captured one skips their forwards on the device. Prints one JSON
line per tree and engine: rounds, iterations, needed, idle, the
forwards run and those run idle (when the tree's runner counts them),
the streams' digest and the measured run's wall seconds (host clock,
synchronized), beside the card's name and power limit. Exits 1 with no
card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
STOP_AT = [3 + 4 * i for i in range(8)]
MAX_TOKENS = 40


def count_rounds(runner_cls):
    """Wrap runner_cls._decode_round_core so every device-stop round
    records (iterations run, valid counts on the device, the forwards
    its iterations ran: a device count or None) in the returned list.
    Returns (the list, a function undoing the wrap)."""
    orig = runner_cls._decode_round_core
    log: list = []

    def wrapped(self, *a, **kw):
        core = orig(self, *a, **kw)
        run = core["run"]
        if kw.get("stop_cap") is None:
            return core

        def counted(*ra, **rkw):
            i0 = self.dispatch_counts["decode_iterations"]
            dev = getattr(self, "loop_forwards", None)
            f0 = None if dev is None else dev.clone()
            ys = run(*ra, **rkw)
            fwd = None if dev is None else (
                dev - f0 + int(rkw.get("first") is not None))
            log.append((self.dispatch_counts["decode_iterations"] - i0,
                        ys[-1].clone(), fwd))
            return ys

        return {**core, "run": counted}

    runner_cls._decode_round_core = wrapped
    return log, lambda: setattr(runner_cls, "_decode_round_core", orig)


def idle_counts(log: list) -> dict:
    """Rounds, iterations run, iterations needed and idle ones, forwards
    run and forwards run idle of a count_rounds log (reads the device
    counts back: call after the run)."""
    ran = sum(n for n, _, _ in log)
    need = sum(max(1, int(v.max())) for _, v, _ in log)
    out = {"rounds": len(log), "iterations": ran, "needed": need,
           "idle": ran - need, "forwards": None, "idle_forwards": None}
    if log and all(f is not None for _, _, f in log):
        out["forwards"] = sum(int(f) for _, _, f in log)
        out["idle_forwards"] = out["forwards"] - need
    return out


def early_exit_scenario(torch, eng, tag: str, log: list) -> dict:
    """Eight 32-token prompts at batch 8: a probe run (greedy, no stop),
    then the measured run with lane i stopping on the token its probe
    sampled at STOP_AT[i]. Returns idle_counts of the measured run, its
    streams' digest and its wall seconds."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    prompts = [[(7 * i + j) % 250 + 1 for j in range(32)] for i in range(8)]

    def serve(name, sps):
        for i, (p, sp) in enumerate(zip(prompts, sps)):
            eng.add_request(f"{tag}{name}{i}", prompt_token_ids=p,
                            sampling_params=sp)
        outs = {}
        while eng.has_unfinished():
            outs.update({o.request_id: o.token_ids for o in eng.step()
                         if o.finished})
        return [outs[f"{tag}{name}{i}"] for i in range(8)]

    def sync():
        if eng.runner.device.type == "cuda":
            torch.cuda.synchronize()

    probe = serve("probe", [SamplingParams(
        max_tokens=MAX_TOKENS, temperature=0, ignore_eos=True)] * 8)
    sps = [SamplingParams(max_tokens=MAX_TOKENS, temperature=0,
                          ignore_eos=True, stop_token_ids=[probe[i][s]])
           for i, s in enumerate(STOP_AT)]
    sync()
    del log[:]
    t0 = time.perf_counter()
    streams = serve("run", sps)
    sync()
    wall = time.perf_counter() - t0
    out = idle_counts(log)
    out["stops"] = [len(s) for s in streams]
    out["digest"] = hashlib.sha256(
        json.dumps(streams).encode()).hexdigest()[:16]
    out["wall_s"] = wall
    return out


def one_tree(tree: Path) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this script needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cuda_build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(get_model_config("llama-3.2-3b"), gen,
                               torch.bfloat16, "cuda")
    log, undo = count_rounds(ModelRunner)
    try:
        for eager in (False, True):
            eng = LLMEngine(EngineConfig(
                model="llama-3.2-3b", tokenizer="byte", device="cuda",
                block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=0,
                num_scheduler_steps=8, max_model_len=2048,
                max_prefill_chunk=512), params=params, eager=eager)
            got = early_exit_scenario(torch, eng, "e", log)
            print(json.dumps({"tree": str(tree), "eager": eager, **got,
                              "card": smi}), flush=True)
            eng.shutdown()
            del eng
    finally:
        undo()
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        return one_tree(Path(argv[1]).resolve())
    rc = 0
    for tree in argv or [str(REPO)]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
