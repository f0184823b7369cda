"""The step broadcast of a rank set: rank 0 -> followers.

Counterpart of ``StepBroadcaster`` in
``production_stack_tpu/parallel/multihost.py``. The scheduler lives on
rank 0 only; before each device step it publishes the step's kind and
host arguments under ``pst/step/{n}``, and every follower blocks on the
next key and replays the step against its own runner, so all ranks run
the same forwards (and so the same collectives) in the same order. The
JAX side writes base64 JSON because its coordinator store holds
strings; a ``torch.distributed`` Store holds bytes, so a payload is the
pickle of the step's arguments (numpy arrays and lists, written by rank
0 of the same program). Keys older than ``window`` steps are deleted as
new ones are published, as on the JAX side.

``initialize`` and ``make_multihost_mesh`` (hosts joined into one job)
are not ported.
"""

from __future__ import annotations

import datetime
import pickle
from collections.abc import Callable

# a follower waits for the next step in slices of this many seconds,
# checking between them that rank 0 is still there
POLL_S = 1.0


class StepBroadcaster:
    PREFIX = "pst/step/"

    def __init__(self, store, window: int = 1024):
        self._store = store
        self._n = 0
        self._window = window

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
        `alive()` false (rank 0 gone) raises."""
        key = f"{self.PREFIX}{self._n}"
        while True:
            try:
                self._store.wait([key], datetime.timedelta(seconds=POLL_S))
                break
            except RuntimeError:  # this slice timed out
                if alive is not None and not alive():
                    raise RuntimeError(
                        "tensor-parallel rank 0 is gone") from None
        raw = self._store.get(key)
        self._n += 1
        return pickle.loads(raw)
