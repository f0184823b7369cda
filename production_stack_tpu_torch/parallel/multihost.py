"""Multi-host serving: hosts joined into one job, and the step broadcast
of a rank set (rank 0 -> followers).

Counterpart of ``production_stack_tpu/parallel/multihost.py``. The JAX
package joins the hosts of a slice into one ``jax.distributed`` job and
lays one mesh over every host's devices. Here the job is a
``torch.distributed.TCPStore`` that process 0 hosts at the coordinator
address and every other process joins (``initialize``); a process is a
host, as in JAX, and runs ``world / num_processes`` ranks of the rank
set (parallel/launch.py): its first in the process itself, the rest
spawned, local rank i on cuda:i. The set's groups, the step broadcast
and every rank's ready / report / exit keys ride that store.

- ``initialize()`` takes the coordinator from its argument or
  ``COORDINATOR_ADDRESS``; an explicitly configured job that fails to
  join raises and never falls back to single-host serving (the JAX
  rule). Without a job, ``process_index()`` is 0 and
  ``process_count()`` 1.
- ``make_multihost_mesh(tp, dp)`` is the rank layout of a (dp, tp) job:
  tp groups contiguous in rank order (within a host where they fit),
  the dp axis across them, with JAX's ValueError when tp x dp is not
  the job's rank count.

``StepBroadcaster``: the scheduler lives on rank 0 only; before each
device step it publishes the step's kind and host arguments under
``pst/step/{n}``, and every follower blocks on the next key and replays
the step against its own runner, so all ranks run the same forwards (and
so the same collectives) in the same order. The JAX side writes base64
JSON because its coordinator store holds strings; a
``torch.distributed`` Store holds bytes, so a payload is the pickle of
the step's arguments (numpy arrays and lists, written by rank 0 of the
same program). Keys older than ``window`` steps are deleted as new ones
are published, as on the JAX side.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import socket
from collections.abc import Callable

import torch
import torch.distributed as dist

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# a follower waits for the next step in slices of this many seconds,
# checking between them that rank 0 is still there
POLL_S = 1.0
# how long a process waits for the whole job to join (the JAX default
# initialization timeout)
JOIN_TIMEOUT_S = 300.0


@dataclasses.dataclass
class Job:
    """This process's place in a multi-host job."""

    process_index: int
    process_count: int
    host: str
    port: int
    store: object  # the job's TCPStore (process 0 hosts it)
    hostname: str  # the address gloo binds this host's ranks to


# the job this process joined (initialize), as jax.distributed keeps its
# global state: one a process
_JOB: Job | None = None


def _is_loopback(host: str) -> bool:
    return host == "localhost" or host.startswith("127.")


def local_address(host: str, port: int) -> str:
    """The address this host is reached at from `host`: loopback for a
    job on one host, else the interface that routes to the coordinator
    (a UDP socket's connect picks it and sends nothing)."""
    if _is_loopback(host):
        return "127.0.0.1"
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, port))
        return s.getsockname()[0]


def parse_address(address: str) -> tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not "
                         "host:port")
    return host, int(port)


# stackcheck: not-hot — boot: joins the job before anything else runs
def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_s: float = JOIN_TIMEOUT_S,
) -> None:
    """Join this process into a multi-host job: process 0 hosts the
    job's TCPStore at the coordinator address, every other process
    connects to it, and each waits (up to `timeout_s`) for all
    `num_processes` to check in. An explicitly configured job (a
    coordinator address, or more than one process) that cannot join
    raises; a bare call with nothing configured is a single-host run."""
    global _JOB
    if _JOB is not None:
        return  # already initialized
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    # explicit multi-host intent: a failure here must be loud, not a
    # silent fallback to single-host serving
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    )
    try:
        _JOB = _join(coordinator_address, num_processes, process_id,
                     timeout_s)
    except (RuntimeError, ValueError) as e:
        if explicit:
            raise RuntimeError(
                "multihost.initialize failed for an explicitly "
                f"configured multi-host job: {e}") from e
        # single-host runs land here
        logger.info("multi-host job not initialized (%s); single host", e)
        return
    logger.info("multi-host job up: process %d/%d, coordinator %s:%d, "
                "this host at %s", _JOB.process_index, _JOB.process_count,
                _JOB.host, _JOB.port, _JOB.hostname)


def _join(address, num_processes, process_id, timeout_s) -> Job:
    if address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a job needs a coordinator address (or COORDINATOR_ADDRESS), "
            "num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    host, port = parse_address(address)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, is_master=process_id == 0,
                          wait_for_workers=False, timeout=timeout)
    store.set(f"pst/job/process/{process_id}", b"1")
    store.wait([f"pst/job/process/{i}" for i in range(num_processes)],
               timeout)
    return Job(process_id, num_processes, host, port, store,
               local_address(host, port))


def job() -> Job | None:
    """The job this process joined, or None (a single-host run)."""
    return _JOB


def process_index() -> int:
    return _JOB.process_index if _JOB is not None else 0


def process_count() -> int:
    return _JOB.process_count if _JOB is not None else 1


def is_multihost() -> bool:
    return process_count() > 1


def make_multihost_mesh(tp: int, dp: int = 1,
                        ranks: int | None = None) -> list[list[int]]:
    """The (dp, tp) layout of the job's `ranks` (default: every card of
    every host, one rank a card, or one a host without cards) as global
    rank ids: row d is tp group d, its ranks contiguous (a host's ranks
    are contiguous, so a tp group that fits on a host stays on it), the
    dp axis across the groups."""
    if ranks is None:
        ranks = process_count() * max(1, torch.cuda.device_count())
    if tp * dp != ranks:
        raise ValueError(
            f"tp({tp}) x dp({dp}) != device count {ranks}"
        )
    return [list(range(d * tp, (d + 1) * tp)) for d in range(dp)]


def store_reachable(store) -> bool:
    """False once the store cannot be reached (its host is gone)."""
    try:
        store.check(["pst/step/0"])
    except dist.DistNetworkError:
        return False
    return True


class StepBroadcaster:
    PREFIX = "pst/step/"

    def __init__(self, store, window: int = 1024):
        self._store = store
        self._n = 0
        self._window = window

    @property
    def count(self) -> int:
        """Steps published (rank 0) or read (a follower) so far."""
        return self._n

    # stackcheck: hot-path — one store write a broadcast dispatch
    def publish(self, payload: dict) -> None:
        """Rank 0: publish the next step descriptor."""
        self._store.set(f"{self.PREFIX}{self._n}",
                        pickle.dumps(payload, pickle.HIGHEST_PROTOCOL))
        self._n += 1
        old = self._n - self._window
        if old >= 0:
            self._store.delete_key(f"{self.PREFIX}{old}")

    # stackcheck: not-hot — a follower's blocking wait for rank 0's next
    # step (its own loop, no serving thread)
    def next(self, alive: Callable[[], bool] | None = None) -> dict:
        """Follower: block for the next descriptor, for as long as rank 0
        sends none (an idle server); between POLL_S slices of the wait,
        `alive()` false (rank 0 gone) raises, and so does a store that
        cannot be reached (the host of a multi-host job's store, process
        0, is gone)."""
        key = f"{self.PREFIX}{self._n}"
        while True:
            try:
                self._store.wait([key], datetime.timedelta(seconds=POLL_S))
                break
            except dist.DistNetworkError as e:
                raise RuntimeError(
                    f"rank 0 is gone (its store is unreachable: {e})"
                ) from None
            except RuntimeError:  # this slice timed out
                if alive is not None and not alive():
                    raise RuntimeError("rank 0 is gone") from None
        raw = self._store.get(key)
        self._n += 1
        return pickle.loads(raw)
