"""One tensor-parallel rank's process group.

The JAX package needs no counterpart: its TP is one controller over a
mesh, and GSPMD inserts the collectives. Here every rank is a process
(parallel/launch.py starts them), and the forward reduces explicitly
through the group's ``all_reduce``, a collective both backends take on
CUDA tensors (gloo copies them through the host, NCCL runs them on the
card; gloo has no ``all_gather`` of CUDA tensors).

A group is built from an explicit backend: ``nccl`` on the card with
rank r on ``cuda:r``, ``gloo`` on the CPU; an API caller may also pass
its own devices with ``gloo`` (two ranks on one card: NCCL refuses two
ranks on one device). The backend object is made directly, not through
``init_process_group``, so a process may hold several groups one after
another (the tests build a rank set a scenario). Every group has a
timeout: a collective that a dead or stuck rank never joins raises on
the others after ``timeout_s`` instead of hanging.

The group also holds the rank set's key-value store (a FileStore in a
temporary directory: no port), which carries the step broadcast
(parallel/multihost.StepBroadcaster) and each follower's ready, report
and exit keys.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# collective and store timeout of a rank set (seconds)
DEFAULT_TIMEOUT_S = 120.0
BACKENDS = ("nccl", "gloo")


def resolve_devices(tp: int, device: str,
                    devices: list | None = None) -> list[str]:
    """The device of each rank: `devices` as given, else tp CPU ranks
    for device "cpu", else rank r on cuda:r (the JAX make_mesh message
    when the host has fewer cards)."""
    if devices is not None:
        if len(devices) != tp:
            raise ValueError(
                f"{len(devices)} devices given for tensor_parallel_size={tp}"
            )
        return [str(d) for d in devices]
    if device == "cpu":
        return ["cpu"] * tp
    n = torch.cuda.device_count()
    if tp > n:
        raise ValueError(
            f"tensor_parallel_size={tp} > available devices {n}"
        )
    return [f"cuda:{r}" for r in range(tp)]


def default_backend(devices: list[str]) -> str:
    """nccl when every rank has a card of its own, else gloo."""
    if all(d.startswith("cuda") for d in devices) and (
            len(set(devices)) == len(devices)):
        return "nccl"
    return "gloo"


def _backend(name: str, store, rank: int, size: int,
             timeout: datetime.timedelta):
    if name == "gloo":
        gloo = dist.ProcessGroupGloo
        opts = gloo._Options()
        opts._timeout = timeout
        # the ranks of a set share one host
        opts._devices = [gloo.create_device(hostname="127.0.0.1")]
        return gloo(store, rank, size, opts)
    nccl = dist.ProcessGroupNCCL
    opts = nccl.Options()
    opts._timeout = timeout
    return nccl(store, rank, size, opts)


class TPGroup:
    """Rank `rank` of `world_size`: its device, its device group and the
    rank set's store. Rank 0 of a set started by parallel/launch.py also
    holds the follower processes (`followers`) and the store's
    directory (`store_dir`), which `close` removes."""

    def __init__(self, rank: int, world_size: int, store_path: str,
                 device: str | torch.device, backend: str,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside [0, {world_size})")
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)
        self.backend = backend
        self.timeout_s = float(timeout_s)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        timeout = datetime.timedelta(seconds=self.timeout_s)
        # one store object a process (-1: no owner count; rank 0 removes
        # the directory at close)
        self.store = dist.FileStore(store_path, -1)
        self.store.set_timeout(timeout)
        self._pg = _backend(backend, dist.PrefixStore("pst/pg/", self.store),
                            rank, world_size, timeout)
        self.followers: list = []
        self.store_dir: str | None = None
        # collectives run, and those handed a host tensor by a rank on
        # the card (the serving path must have none)
        self.all_reduces = 0
        self.host_collectives = 0

    def _note(self, t: torch.Tensor) -> None:
        if self.device.type == "cuda" and not t.is_cuda:
            self.host_collectives += 1

    # stackcheck: hot-path — the all-reduce seam of every TP forward (two
    # a layer, and the vocab gather of an untied lm_head)
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of `t` over the group; returns `t`."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                         "min": dist.ReduceOp.MIN}[op]
        self._note(t)
        self.all_reduces += 1
        self._pg.allreduce([t], opts).wait()
        return t

    # stackcheck: hot-path — the vocab gather of an untied lm_head
    def gather_last(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's `local` (..., n) laid side by side on the last
        axis, (..., n * world_size), on every rank: each rank writes its
        slice into zeros and the group sums (gloo has no all_gather of
        CUDA tensors; a sum with exact zeros is exact)."""
        n = local.shape[-1]
        full = local.new_zeros((*local.shape[:-1], n * self.world_size))
        full.narrow(-1, self.rank * n, n).copy_(local)
        return self.all_reduce(full)

    def agree_min(self, value: int) -> int:
        """The smallest of every rank's `value`."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        return int(self.all_reduce(t, "min").item())

    def close(self) -> None:
        """Drop the device group; rank 0 of a launched set removes the
        store's directory."""
        self._pg = None
        if self.store_dir is not None:
            import shutil

            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None
