"""One rank's process groups: the whole rank set, its stage's tensor
parallel ranks and its pipeline of stages.

The JAX package needs no counterpart: its TP and PP are one controller
over a ("pp", "tp") mesh, and GSPMD / shard_map insert the collectives.
Here every rank is a process (parallel/launch.py starts them), and the
forward reduces and hands over explicitly through collectives both
backends take on CUDA tensors (gloo copies them through the host, NCCL
runs them on the card): ``all_reduce`` for the Megatron sums and the
vocab gather (gloo has no ``all_gather`` of CUDA tensors), ``broadcast``
for a pipeline stage's hand-off (gloo's point-to-point ops read host
memory only).

A rank set of ``world = tp * pp`` ranks is the JAX mesh reshaped
row-major: rank r is stage ``r // tp`` and tp index ``r % tp``
(parallel/sharding.rank_layout). Every rank holds three groups, built in
the same order on every rank: the whole set (``agree_min``, and at pp=1
the tensor-parallel sums), its stage's ``tp`` sub-group and its tp
index's ``pp`` sub-group, each a backend over its own PrefixStore of the
set's store (a sub-group is the whole set when the other axis is 1, and
None when its own axis is).

The backend is explicit (``nccl`` or ``gloo``), or chosen from every
rank's device identity exchanged through the store: nccl when every
rank has a card of its own, else gloo (two ranks on one card: NCCL
refuses that; a set on the CPU). The backend objects are made directly,
not through ``init_process_group``, so a process may hold several sets
one after another (the tests build a rank set a scenario). Every group
has a timeout: a collective that a dead or stuck rank never joins raises
on the others after ``timeout_s`` instead of hanging.

The store is the caller's TCPStore (one rank 0 hosts on loopback for a
set started on one host, parallel/launch.py; the job's for a set
spanning hosts, parallel/multihost.py). It carries the step
broadcast (parallel/multihost.StepBroadcaster) and each follower's
ready, report and exit keys. Gloo binds each rank to ``hostname``:
loopback for a set on one host, the host's own address when the set
spans hosts.
"""

from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist

from production_stack_tpu_torch.parallel.sharding import rank_layout

# collective and store timeout of a rank set (seconds)
DEFAULT_TIMEOUT_S = 120.0
BACKENDS = ("nccl", "gloo")


def resolve_devices(n: int, device: str,
                    devices: list | None = None) -> list[str]:
    """The device of each of n ranks: `devices` as given, else n CPU
    ranks for device "cpu", else rank r on cuda:r (the JAX make_mesh
    message when the host has fewer cards)."""
    if devices is not None:
        if len(devices) != n:
            raise ValueError(
                f"{len(devices)} devices given for tensor_parallel_size={n}"
            )
        return [str(d) for d in devices]
    if device == "cpu":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(
            f"tensor_parallel_size={n} > available devices {cards}"
        )
    return [f"cuda:{r}" for r in range(n)]


def default_backend(devices: list[str]) -> str:
    """nccl when every rank has a card of its own, else gloo. `devices`
    name each rank's card uniquely across hosts (device_identity)."""
    if all("cuda" in d for d in devices) and (
            len(set(devices)) == len(devices)):
        return "nccl"
    return "gloo"


def device_identity(device: torch.device) -> str:
    """A name of `device` that two ranks share only when they share the
    card: the card's UUID where torch reports one, else host and index;
    "cpu" for the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    return (f"cuda:{uuid}" if uuid is not None
            else f"cuda:{socket.gethostname()}:{index}")


def _backend(name: str, store, rank: int, size: int,
             timeout: datetime.timedelta, hostname: str):
    if name == "gloo":
        gloo = dist.ProcessGroupGloo
        opts = gloo._Options()
        opts._timeout = timeout
        opts._devices = [gloo.create_device(hostname=hostname)]
        return gloo(store, rank, size, opts)
    nccl = dist.ProcessGroupNCCL
    opts = nccl.Options()
    opts._timeout = timeout
    return nccl(store, rank, size, opts)


class Comm:
    """Collectives over one device group, as member `rank` of `size`;
    `owner` (the rank's TPGroup) counts them."""

    def __init__(self, pg, rank: int, size: int, owner: "TPGroup"):
        self._pg = pg
        self.rank = rank
        self.world_size = size
        self._owner = owner

    # stackcheck: hot-path — the all-reduce seam of every TP forward (two
    # a layer, and the vocab gather of an untied lm_head)
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of `t` over the group; returns `t`."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                         "min": dist.ReduceOp.MIN}[op]
        self._owner.note(t, "all_reduces")
        self._pg.allreduce([t], opts).wait()
        return t

    # stackcheck: hot-path — the vocab gather of an untied lm_head
    def gather_last(self, local: torch.Tensor) -> torch.Tensor:
        """Every member's `local` (..., n) laid side by side on the last
        axis, (..., n * world_size), on every member: each writes its
        slice into zeros and the group sums (gloo has no all_gather of
        CUDA tensors; a sum with exact zeros is exact)."""
        n = local.shape[-1]
        full = local.new_zeros((*local.shape[:-1], n * self.world_size))
        full.narrow(-1, self.rank * n, n).copy_(local)
        return self.all_reduce(full)

    # stackcheck: hot-path — a pipeline stage's hand-off (one a phase of
    # every PP forward)
    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Member `src`'s `t` into `t` on every member (in place, bit for
        bit: the bytes travel, whatever the dtype); returns `t`."""
        if not t.is_contiguous():
            raise ValueError("broadcast needs a contiguous tensor")
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        self._owner.note(t, "broadcasts")
        self._pg.broadcast([t.view(torch.uint8)], opts).wait()
        return t


class TPGroup(Comm):
    """Rank `rank` of a `world_size`-rank set of `world_size // pp` tp
    ranks a stage: its device, its groups (itself over the whole set,
    `tp` and `pp`), its (stage, tp index) and the set's store. Rank 0 of
    a set started by parallel/launch.py also holds its host's follower
    processes (`followers`) and its temporary directory (`store_dir`),
    which `close` removes."""

    def __init__(self, rank: int, world_size: int, store,
                 device: str | torch.device, backend: str | None = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S, pp: int = 1,
                 hostname: str = "127.0.0.1"):
        if backend is not None and backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside [0, {world_size})")
        if pp < 1 or world_size % pp:
            raise ValueError(f"{world_size} ranks do not split into "
                             f"pp={pp} stages")
        self.device = torch.device(device)
        self.timeout_s = float(timeout_s)
        # collectives run (all-reduces, broadcasts), and those handed a
        # host tensor by a rank on the card (the serving path must have
        # none)
        self.counts = {"all_reduces": 0, "broadcasts": 0,
                       "host_collectives": 0}
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        timeout = datetime.timedelta(seconds=self.timeout_s)
        self.store = store
        self.backend = backend or self._agree_backend(rank, world_size)
        self.tp_size = world_size // pp
        self.pp_size = pp
        self.stage, self.tp_rank = rank_layout(rank, self.tp_size)

        def sub(prefix, r, n):
            return _backend(self.backend, dist.PrefixStore(prefix, store),
                            r, n, timeout, hostname)

        super().__init__(sub("pst/pg/", rank, world_size), rank,
                         world_size, self)
        # the stage's tp ranks, then the tp index's stages (None for an
        # axis of one rank)
        self.tp = None if self.tp_size == 1 else self if pp == 1 else Comm(
            sub(f"pst/pg/tp{self.stage}/", self.tp_rank, self.tp_size),
            self.tp_rank, self.tp_size, self)
        self.pp = None if pp == 1 else self if self.tp_size == 1 else Comm(
            sub(f"pst/pg/pp{self.tp_rank}/", self.stage, pp), self.stage,
            pp, self)
        self.followers: list = []
        self.store_dir: str | None = None

    def _agree_backend(self, rank: int, world_size: int) -> str:
        """default_backend over every rank's device identity, each
        published under its rank's key and read back from the store."""
        self.store.set(f"pst/device/{rank}",
                       device_identity(self.device).encode())
        keys = [f"pst/device/{r}" for r in range(world_size)]
        self.store.wait(keys)
        return default_backend([self.store.get(k).decode() for k in keys])

    @property
    def all_reduces(self) -> int:
        return self.counts["all_reduces"]

    @property
    def host_collectives(self) -> int:
        return self.counts["host_collectives"]

    def note(self, t: torch.Tensor, kind: str) -> None:
        self.counts[kind] += 1
        if self.device.type == "cuda" and not t.is_cuda:
            self.counts["host_collectives"] += 1

    def agree_min(self, value: int) -> int:
        """The smallest of every rank's `value`."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        return int(self.all_reduce(t, "min").item())

    def close(self) -> None:
        """Drop the device groups; rank 0 of a launched set removes its
        temporary directory."""
        self._pg = None
        self.tp = self.pp = None
        if self.store_dir is not None:
            import shutil

            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None
