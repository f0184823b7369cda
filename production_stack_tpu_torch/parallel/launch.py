"""Start a rank set: this process's first rank here, its other ranks
spawned.

No JAX counterpart: a JAX mesh is one process a host. A rank set has
``tensor_parallel_size * pipeline_parallel_size`` ranks
(parallel/group.py's layout). ``start_tp_ranks`` spawns this host's
ranks past its first (the spawn start method: this process may already
hold CUDA, which a forked child cannot use), each of which joins the
groups, builds ``ModelRunner(config, group=...)`` (its stage's layers,
its tp shard of the weights and its local KV cache) and runs
``engine.multihost_engine.follower_loop``; it returns the group of this
process's first rank, which rank 0's caller hands to
``LLMEngine(config, tp_group=...)`` and a follower host's entry
(``run_follower_host``) to its own runner and follower loop. The
runner's construction itself runs collectives (the KV pool agreement),
so every rank builds in the same order.

On one host the set is all of this process's: rank 0 here, ranks
1..N-1 spawned, over a TCPStore rank 0 hosts on loopback at a free
port (a deleted key is gone, so the step window keeps the store
bounded; a temporary directory holds only caller-supplied params).
In a multi-host job (parallel/multihost.initialize ran) each process is
a host holding N / num_processes ranks, process p's first rank being
p * N / num_processes, its local rank i on cuda:i; the store is the
job's TCPStore and gloo binds to the host's own address.

On the card, a process builds the kernel library (ops/cuda_build.py)
before it spawns: its followers load that library and never start a
second nvcc into the same build directory. Caller-supplied full params
reach the followers through a file in a temporary directory
(torch.save), never through shared memory.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

from production_stack_tpu_torch.parallel import multihost
from production_stack_tpu_torch.parallel.group import (
    DEFAULT_TIMEOUT_S,
    TPGroup,
    resolve_devices,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


# stackcheck: not-hot — boot: spawns the followers and joins the group
def start_tp_ranks(config, devices: list | None = None,
                   backend: str | None = None, params: dict | None = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> TPGroup:
    """Start this host's ranks of `config`'s rank set (tp x pp ranks)
    past the first, and return the first's group. `devices`: each local
    rank's device (default: local rank i on cuda:i, or all on the CPU
    for device "cpu"); `backend`: "nccl" or "gloo" (default: nccl when
    every rank of the set has a card of its own, agreed through the
    store); `params`: full params every rank cuts its shard from
    (default: each rank loads the checkpoint or draws the seeded random
    weights itself)."""
    tp, pp = config.tensor_parallel_size, config.pipeline_parallel_size
    world = tp * pp
    if world < 2:
        raise ValueError(f"tensor_parallel_size={tp} x "
                         f"pipeline_parallel_size={pp}: nothing to start")
    job = multihost.job() if config.multihost else None
    hosts = job.process_count if job is not None else 1
    if world % hosts:
        raise ValueError(f"{world} ranks do not split over {hosts} hosts")
    local = world // hosts
    first = job.process_index * local if job is not None else 0
    if devices is None and config.device != "cpu" and pp > 1 and (
            local > torch.cuda.device_count()) and job is None:
        raise ValueError(
            f"pp({pp}) x tp({tp}) = {world} > available devices "
            f"{torch.cuda.device_count()}")
    devs = resolve_devices(local, config.device, devices)
    if devs[0].startswith("cuda"):
        from production_stack_tpu_torch.ops import cuda_build

        cuda_build.build()
    tmp = tempfile.mkdtemp(prefix="pst-ranks-")
    params_path = None
    if params is not None:
        params_path = os.path.join(tmp, "params.pt")
        torch.save(_to_cpu(params), params_path)
    if job is not None:
        store, spec, hostname = (job.store, ("tcp", job.host, job.port),
                                 job.hostname)
    else:
        # rank 0 hosts the set's store on loopback (a free port, read
        # back): a deleted step key is gone, where a FileStore appends
        # every set and delete to its file and never compacts it
        hostname = "127.0.0.1"
        store = dist.TCPStore(hostname, 0, is_master=True,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=timeout_s))
        spec = ("tcp", hostname, store.port)
    ctx = multiprocessing.get_context("spawn")
    followers = []
    try:
        for i in range(1, local):
            p = ctx.Process(
                target=_follower_main, name=f"pst-rank{first + i}",
                daemon=True,
                args=(first + i, world, config, config.model_config(),
                      devs[i], backend, spec, hostname, timeout_s,
                      params_path, torch.get_num_threads()),
            )
            p.start()
            followers.append(p)
        group = TPGroup(first, world, store, devs[0], backend, timeout_s,
                        pp=pp, hostname=hostname)
    except BaseException:
        for p in followers:
            p.terminate()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    group.followers = followers
    group.store_dir = tmp
    logger.info("rank set: %d ranks (tp %d x pp %d), ranks %d..%d here on "
                "%s, %s", world, tp, pp, first, first + local - 1, devs,
                group.backend)
    return group


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


def _open(spec, timeout_s: float):
    """The set's store in a spawned rank: a client of the TCPStore
    ("tcp", host, port) rank 0's process hosts (its own on one host, the
    job's in a multi-host job)."""
    _, host, port = spec
    return dist.TCPStore(host, port, is_master=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def _follower_main(rank: int, world: int, config, model_config, device: str,
                   backend: str | None, spec, hostname: str,
                   timeout_s: float, params_path: str | None,
                   threads: int) -> None:
    """A spawned rank: join the groups, build the runner, replay rank 0's
    steps (sys.exit with the code follower_rank returns). It takes its
    launcher's intra-op thread count: a spawned process would otherwise
    start with one thread a core, whatever its launcher chose."""
    torch.set_num_threads(threads)
    from production_stack_tpu_torch.models import config as mconfig

    if config.model == model_config.name:
        # the config rank 0 resolved (a preset registered at run time in
        # its process, too)
        mconfig._PRESETS[model_config.name] = model_config
    group = TPGroup(rank, world, _open(spec, timeout_s), device, backend,
                    timeout_s, pp=config.pipeline_parallel_size,
                    hostname=hostname)
    params = (torch.load(params_path, weights_only=True)
              if params_path is not None else None)
    sys.exit(follower_rank(config, group, params))


def follower_rank(config, group: TPGroup, params: dict | None = None) -> int:
    """One follower rank's life: build its runner, replay rank 0's steps
    until shutdown, and publish its exit key (its error or none, its
    launch counts and its report) whatever happened. Returns the exit
    code: 0 after a shutdown, 1 after an error."""
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.engine.multihost_engine import (
        exit_key,
        follower_loop,
        rank_report,
        ready_key,
    )
    from production_stack_tpu_torch.ops import paged_attention

    error = None
    runner = None
    steps = None
    try:
        runner = ModelRunner(config, params=params, group=group)
        del params
        group.store.set(ready_key(group.rank), b"1")
        steps = follower_loop(runner, group)
    except BaseException:  # noqa: BLE001 — published, then re-raised
        # by the exit code: rank 0 reads it from the store
        error = traceback.format_exc()
        logger.error("rank %d failed:\n%s", group.rank, error)
    out = {"error": error, "launches": paged_attention.launch_counts()}
    if runner is not None:
        out["report"] = rank_report(runner, group, steps)
    try:
        group.store.set(exit_key(group.rank), pickle.dumps(out))
    except RuntimeError as e:  # a job's store went with its host
        logger.error("rank %d: exit key not published (%s)", group.rank, e)
    return 1 if error is not None else 0


# stackcheck: not-hot — a follower host's whole life
def run_follower_host(config, params: dict | None = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """A multi-host job's process p > 0 (parallel/multihost.initialize
    ran): start this host's ranks, run the first as a follower here, and
    stop the spawned ones when it ends. `params`: the full params every
    rank cuts its shard from, as start_tp_ranks takes them. Returns the
    exit code (non-zero when rank 0's host is gone or a step failed)."""
    group = start_tp_ranks(config, params=params, timeout_s=timeout_s)
    try:
        return follower_rank(config, group, params)
    finally:
        for p in group.followers:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)
        group.close()
