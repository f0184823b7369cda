"""Start a tensor-parallel rank set: rank 0 here, ranks 1..N-1 spawned.

No JAX counterpart: a JAX mesh is one process. ``start_tp_ranks``
spawns ranks 1..N-1 (the spawn start method: this process may already
hold CUDA, which a forked child cannot use), each of which joins the
group, builds ``ModelRunner(config, group=...)`` (its shard of the
weights and its local KV cache) and runs
``engine.multihost_engine.follower_loop``; it returns rank 0's group,
which the caller hands to ``LLMEngine(config, tp_group=...)``. The
runner's construction itself runs collectives (the KV pool agreement),
so every rank builds in the same order.

The store is a FileStore in a temporary directory (no port). On the
card, rank 0 builds the kernel library (ops/cuda_build.py) before it
spawns: the followers load that library and never start a second nvcc
into the same build directory. Caller-supplied full params reach the
followers through a file in that directory (torch.save), never through
shared memory.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import tempfile
import traceback

import torch

from production_stack_tpu_torch.parallel.group import (
    DEFAULT_TIMEOUT_S,
    TPGroup,
    default_backend,
    resolve_devices,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


# stackcheck: not-hot — boot: spawns the followers and joins the group
def start_tp_ranks(config, devices: list | None = None,
                   backend: str | None = None, params: dict | None = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> TPGroup:
    """Start ranks 1..tp-1 of `config.tensor_parallel_size` and return
    rank 0's group. `devices`: each rank's device (default: rank r on
    cuda:r, or all on the CPU for device "cpu"); `backend`: "nccl" or
    "gloo" (default: nccl when every rank has its own card); `params`:
    full params every rank shards (default: each rank loads the
    checkpoint or draws the seeded random weights itself)."""
    tp = config.tensor_parallel_size
    if tp < 2:
        raise ValueError(f"tensor_parallel_size={tp}: nothing to start")
    devs = resolve_devices(tp, config.device, devices)
    backend = backend or default_backend(devs)
    if devs[0].startswith("cuda"):
        from production_stack_tpu_torch.ops import cuda_build

        cuda_build.build()
    store_dir = tempfile.mkdtemp(prefix="pst-tp-")
    params_path = None
    if params is not None:
        params_path = os.path.join(store_dir, "params.pt")
        torch.save(_to_cpu(params), params_path)
    store_path = os.path.join(store_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    followers = []
    try:
        for r in range(1, tp):
            p = ctx.Process(
                target=_follower_main, name=f"pst-tp-rank{r}", daemon=True,
                args=(r, config, config.model_config(), devs, backend,
                      store_path, timeout_s, params_path,
                      torch.get_num_threads()),
            )
            p.start()
            followers.append(p)
        group = TPGroup(0, tp, store_path, devs[0], backend, timeout_s)
    except BaseException:
        for p in followers:
            p.terminate()
            p.join(5)
        import shutil

        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    group.followers = followers
    group.store_dir = store_dir
    logger.info("tensor-parallel rank set: %d ranks on %s, %s", tp, devs,
                backend)
    return group


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


def _follower_main(rank: int, config, model_config, devices: list[str],
                   backend: str, store_path: str, timeout_s: float,
                   params_path: str | None, threads: int) -> None:
    """A spawned rank: join the group, build the runner, replay rank 0's
    steps; publish the exit key (error or not, with the launch counts)
    before exiting. It takes rank 0's intra-op thread count: a spawned
    process would otherwise start with one thread a core, whatever its
    launcher chose."""
    torch.set_num_threads(threads)
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.engine.multihost_engine import (
        exit_key,
        follower_loop,
        rank_report,
        ready_key,
    )
    from production_stack_tpu_torch.models import config as mconfig
    from production_stack_tpu_torch.ops import paged_attention

    if config.model == model_config.name:
        # the config rank 0 resolved (a preset registered at run time in
        # its process, too)
        mconfig._PRESETS[model_config.name] = model_config
    group = TPGroup(rank, len(devices), store_path, devices[rank], backend,
                    timeout_s)
    error = None
    runner = None
    try:
        params = (torch.load(params_path, weights_only=True)
                  if params_path is not None else None)
        runner = ModelRunner(config, params=params, group=group)
        del params
        group.store.set(ready_key(rank), b"1")
        follower_loop(runner, group)
    except BaseException:  # noqa: BLE001 — published, then re-raised
        # by the exit code: rank 0 reads it from the store
        error = traceback.format_exc()
        logger.error("tensor-parallel rank %d failed:\n%s", rank, error)
    out = {"error": error, "launches": paged_attention.launch_counts()}
    if runner is not None:
        out["report"] = rank_report(runner, group)
    group.store.set(exit_key(rank), pickle.dumps(out))
    sys.exit(1 if error is not None else 0)
