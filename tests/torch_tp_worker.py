"""Rank-set helper for tests/test_torch_tensor_parallel.py: run one
function on every rank of a CPU gloo rank set (rank 0 in the calling
process, ranks 1.. spawned) and collect each rank's result. It imports
torch and the port only, so a spawned rank starts in about a second."""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.convert import tp_params_from_numpy
from production_stack_tpu_torch.ops.attention import context_attention_prefill
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.parallel.group import TPGroup


def run_ranks(fn, tp: int, *args, timeout_s: float = 60.0) -> list:
    """[fn(group_r, *args) for r in range(tp)], each rank in its own
    process, over a TCPStore this process hosts on loopback (as
    parallel/launch.py starts a set on one host)."""
    tmp = tempfile.mkdtemp(prefix="pst-tp-test-")
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, tp, store.port, tmp, args, timeout_s,
                               torch.get_num_threads()))
             for r in range(1, tp)]
    try:
        for p in procs:
            p.start()
        group = TPGroup(0, tp, store, "cpu", "gloo", timeout_s)
        out = [fn(group, *args)]
        for p in procs:
            p.join(timeout_s)
            assert p.exitcode == 0, f"rank exited with {p.exitcode}"
        for r in range(1, tp):
            out.append(torch.load(os.path.join(tmp, f"rank{r}.pt"),
                                  weights_only=False))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(fn, rank, tp, port, tmp, args, timeout_s, threads):
    # the caller's intra-op thread count (a spawned process would start
    # with one a core)
    torch.set_num_threads(threads)
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    group = TPGroup(rank, tp, store, "cpu", "gloo", timeout_s)
    torch.save(fn(group, *args), os.path.join(tmp, f"rank{rank}.pt"))


def tp_forward(group, cases: list) -> list:
    """For each (cfg, np_params, steps, num_slots): this rank's shard of
    the params, its local KV cache, and models/llama.forward over the
    steps ((tokens, positions) chunks, cache slot == position) with the
    group's all-reduces -> ([logits (n, V) per step], k, v) as numpy."""
    out = []
    for cfg, np_params, steps, num_slots in cases:
        tp = group.world_size
        params = tp_params_from_numpy(np_params, cfg, group.rank, tp, "cpu")
        local = cfg.tp_local(tp)
        kc = torch.zeros(sharding.local_cache_shape(cfg, num_slots, tp))
        vc = torch.zeros_like(kc)
        logits = []
        for tokens, positions in steps:
            pos = torch.as_tensor(positions, dtype=torch.int32)
            total = int(positions[-1]) + 1

            def attn(q, layer, k, v):
                return context_attention_prefill(
                    q, k[layer].transpose(0, 1), v[layer].transpose(0, 1),
                    pos, total, cfg.head_dim**-0.5)

            lg, kc, vc = llama.forward(
                local, params, torch.as_tensor(tokens, dtype=torch.int32),
                pos, kc, vc, pos, attn, torch.arange(len(tokens)),
                tp_group=group)
            logits.append(lg.numpy())
        out.append((logits, kc.numpy(), vc.numpy()))
    return out
