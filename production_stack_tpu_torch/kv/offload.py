"""Engine-side KV offload tiers: host RAM -> local disk, plus the
shared-cache and PD-peer chain sources.

Copy of ``production_stack_tpu/kv/offload.py`` on the port's host block:
a CPU ``torch.Tensor`` in the wire layout, bf16 included (numpy has no
bf16, and the card's machine has no ``ml_dtypes``). ``serialize_block``
writes exactly the JAX package's bytes for the same values — an
``np.save`` frame, behind the ``KVBF16`` tag holding the uint16 bits for
bf16 — and ``DiskTier`` names and lays out its files as the JAX tier
does, so a disk directory, a peer pull or a cache server written by one
package restores in the other. Blocks arrive from the model runner's
device->host export (``ModelRunner.materialize_export``), one batched
copy per freed group, and every block a tier keeps owns its memory
(``own_block``).

Each tier is an LRU keyed by the chained block hash (same content address
the BlockManager and KV controller use). Evictions cascade to the next
tier. ALL tier IO runs on the worker thread so the engine step loop never
blocks on it:

- writes: lookups consult the pending-write map first so a block is
  visible the moment it is enqueued. `put_batch_async` additionally
  defers the d2h materialization itself to the worker — the engine only
  enqueues the device-side snapshot (zero-stall export).
- reads: `request_reads`/`poll_reads`/`take_reads` mirror the
  pending-write map with a pending-READ map, so disk/remote `get`s never
  run on the scheduler thread (staged restore).
"""

from __future__ import annotations

import io
import os
import queue
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

#: pending-write placeholder for a deferred export whose d2h
#: materialization has not landed yet: contains() sees the block (no
#: duplicate export is queued), get() treats it as not-yet-readable
_EXPORT_PENDING = object()


def _nbytes(arr: torch.Tensor) -> int:
    return int(arr.nbytes)


#: wire tag for bfloat16 payloads (np.save's own frames start with
#: \x93NUMPY, so the tag is unambiguous): the frame behind it holds the
#: uint16 bits, as the JAX package writes them
_BF16_TAG = b"KVBF16\x00\x00"


def serialize_block(arr: torch.Tensor) -> bytes:
    """One host block (or a stacked batch) as the JAX package's bytes:
    ``np.save`` of the values, or the ``KVBF16`` tag then ``np.save`` of
    the uint16 bits for bf16."""
    buf = io.BytesIO()
    arr = arr.detach().cpu().contiguous()
    if arr.dtype == torch.bfloat16:
        buf.write(_BF16_TAG)
        out = arr.view(torch.int16).numpy().view(np.uint16)
    else:
        out = arr.numpy()
    np.save(buf, out, allow_pickle=False)
    return buf.getvalue()


def deserialize_block(data: bytes) -> torch.Tensor:
    """Inverse of serialize_block, for frames written by either package
    (the bf16 tag reads back as a bf16 tensor without ml_dtypes)."""
    if data[: len(_BF16_TAG)] == _BF16_TAG:
        bits = np.load(
            io.BytesIO(data[len(_BF16_TAG):]), allow_pickle=False
        )
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.load(io.BytesIO(data), allow_pickle=False))


def own_block(data: torch.Tensor, i: int) -> torch.Tensor:
    """Block `i` of a batch stacked at dim 2, as a contiguous copy that
    owns its memory: a view of the batch would pin the WHOLE batch alive
    (and a view of a reused pinned buffer would change under the tier)
    while any one block is held."""
    return data[:, :, i].clone(memory_format=torch.contiguous_format)


class KVTier:
    """Interface for one offload tier.

    Implementations are internally thread-safe: the engine step thread
    calls get()/contains() while the manager's writer thread calls put().
    """

    name = "tier"

    def put(self, h: int, arr: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
        """Store; returns blocks evicted to make room (cascade down)."""
        raise NotImplementedError

    def get(self, h: int) -> torch.Tensor | None:
        raise NotImplementedError

    def contains(self, h: int) -> bool:
        raise NotImplementedError

    def delete(self, h: int) -> None:
        """Drop a block (TTL expiry / cache-server admin); no-op when
        absent. Default: nothing — tiers that cannot delete keep it."""

    def hashes(self) -> list[int]:
        raise NotImplementedError

    def stats(self) -> dict:
        raise NotImplementedError


class CpuTier(KVTier):
    """Host-RAM LRU of KV blocks."""

    name = "cpu"

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self.used = 0
        self._d: OrderedDict[int, torch.Tensor] = OrderedDict()
        self._lock = threading.RLock()

    def put(self, h: int, arr: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
        with self._lock:
            if h in self._d:
                self._d.move_to_end(h)
                return []
            n = _nbytes(arr)
            if n > self.capacity:
                return [(h, arr)]  # doesn't fit at all; pass straight down
            evicted = []
            while self.used + n > self.capacity and self._d:
                eh, earr = self._d.popitem(last=False)
                self.used -= _nbytes(earr)
                evicted.append((eh, earr))
            self._d[h] = arr
            self.used += n
            return evicted

    def get(self, h: int) -> torch.Tensor | None:
        with self._lock:
            arr = self._d.get(h)
            if arr is not None:
                self._d.move_to_end(h)
            return arr

    def contains(self, h: int) -> bool:
        with self._lock:
            return h in self._d

    def delete(self, h: int) -> None:
        with self._lock:
            arr = self._d.pop(h, None)
            if arr is not None:
                self.used -= _nbytes(arr)

    def hashes(self) -> list[int]:
        with self._lock:
            return list(self._d.keys())

    def stats(self) -> dict:
        with self._lock:
            return {"tier": self.name, "blocks": len(self._d),
                    "used_bytes": self.used, "capacity_bytes": self.capacity}


class DiskTier(KVTier):
    """Local-disk LRU; one file per block hash."""

    name = "disk"

    def __init__(self, directory: str, capacity_bytes: int | None = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.capacity = capacity_bytes
        self.used = 0
        self._sizes: OrderedDict[int, int] = OrderedDict()
        # hashes reserved in the index whose file has not landed yet
        # (put runs its IO outside the lock): get() WAITS for them
        # (matching the old locked-put behavior for sync-mode readers
        # racing a cascade demotion) while contains()/hashes() stay
        # non-blocking
        self._writing: set[int] = set()
        self._lock = threading.RLock()
        self._landed = threading.Condition(self._lock)
        # adopt pre-existing blocks (restart resume)
        for fn in os.listdir(directory):
            if fn.endswith(".kvblk"):
                try:
                    h = int(fn[:-6])
                except ValueError:
                    continue
                sz = os.path.getsize(os.path.join(directory, fn))
                self._sizes[h] = sz
                self.used += sz

    def _path(self, h: int) -> str:
        return os.path.join(self.dir, f"{h}.kvblk")

    def put(self, h: int, arr: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
        """File IO runs OUTSIDE the lock: the engine step thread's
        contains()/hashes() probes must never wait on a multi-MB write
        or the eviction cascade's victim reads (tier writes come from
        the single offload worker, so put/put races don't exist — the
        lock only guards the index against the probe threads)."""
        data = serialize_block(arr)  # serialize outside the lock
        victims: list[tuple[int, int]] = []
        with self._lock:
            if h in self._sizes:
                self._sizes.move_to_end(h)
                return []
            if self.capacity is not None:
                if len(data) > self.capacity:
                    return [(h, arr)]
                while self.used + len(data) > self.capacity and self._sizes:
                    eh, esz = self._sizes.popitem(last=False)
                    self.used -= esz
                    victims.append((eh, esz))
            # reserve the space under the lock; the file lands below.
            # _writing marks the gap so a concurrent get() reports
            # not-ready instead of popping the index and orphaning the
            # about-to-land file
            self._sizes[h] = len(data)
            self.used += len(data)
            self._writing.add(h)
        # read victims for the cascade but DELETE NOTHING until the new
        # block's write succeeds: an ENOSPC after removing victim files
        # would destroy blocks the tier durably held a moment ago
        victim_data = [(eh, esz, self._read(eh)) for eh, esz in victims]
        tmp = self._path(h) + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, self._path(h))
        except OSError:
            try:  # a partial .tmp on a FULL disk must not leak
                os.remove(tmp)
            except OSError:
                pass
            with self._lock:  # disk full/unwritable: roll back the
                # index and re-admit the victims (their files are
                # untouched — nothing was lost)
                if self._sizes.pop(h, None) is not None:
                    self.used -= len(data)
                for eh, esz, _ in victim_data:
                    self._sizes[eh] = esz
                    self.used += esz
            raise
        finally:
            with self._landed:
                self._writing.discard(h)
                self._landed.notify_all()
        evicted = []
        for eh, _, earr in victim_data:
            try:
                os.remove(self._path(eh))
            except OSError:
                pass
            if earr is not None:
                evicted.append((eh, earr))
        return evicted

    def _read(self, h: int) -> torch.Tensor | None:
        try:
            with open(self._path(h), "rb") as f:
                return deserialize_block(f.read())
        except (OSError, ValueError):
            return None

    def get(self, h: int) -> torch.Tensor | None:
        with self._landed:
            if h not in self._sizes:
                return None
            # mid-landing (cascade demotion in flight on the worker):
            # wait for the file like the old locked put would have made
            # us — the worker never waits here (its own put completed
            # before any of its reads run), only sync-mode readers do
            while h in self._writing:
                self._landed.wait(timeout=0.25)
                if h not in self._sizes:
                    return None  # write failed and rolled back
            self._sizes.move_to_end(h)
        arr = self._read(h)  # file IO outside the lock (see put)
        if arr is None:
            with self._lock:  # vanished/corrupt file: drop the index
                if h not in self._writing:
                    sz = self._sizes.pop(h, None)
                    if sz is not None:
                        self.used -= sz
            return None
        return arr

    def contains(self, h: int) -> bool:
        with self._lock:
            return h in self._sizes

    def delete(self, h: int) -> None:
        """Index drop under the lock, file removal outside it. A block
        mid-landing (`_writing`) is WAITED OUT like get() does —
        skipping it would leak the about-to-land file forever when the
        caller (e.g. the cache server's TTL sweep) has already dropped
        its own ledger entry and will never retry."""
        with self._landed:
            while h in self._writing:
                self._landed.wait(timeout=0.25)
            sz = self._sizes.pop(h, None)
            if sz is None:
                return
            self.used -= sz
        try:
            os.remove(self._path(h))
        except OSError:
            pass

    def hashes(self) -> list[int]:
        with self._lock:
            return list(self._sizes.keys())

    def stats(self) -> dict:
        with self._lock:
            return {"tier": self.name, "blocks": len(self._sizes),
                    "used_bytes": self.used, "capacity_bytes": self.capacity}


class KVOffloadManager:
    """Tier cascade + async worker + controller reporting.

    put_batch()/put_batch_async() are called from the engine loop when
    cached blocks leave HBM (BlockManager free/evict hooks);
    contains()/request_reads()/poll_reads() serve prefix restore on the
    admission path (Scheduler kv_restore hook) without ever running tier
    IO on the scheduler thread. get() is the synchronous fallback
    (--sync-kv-offload and unit tests).
    """

    def __init__(self, tiers: list[KVTier], reporter=None, peer=None,
                 remote=None):
        self.tiers = tiers
        # optional kv.peer.PeerTier (disaggregated prefill): NOT part of
        # the cascade — evictions never push to a peer and contains()
        # never asks the network. Peers are consulted only through
        # request_chain_reads (one chain pull per restore, on the
        # worker) and the --sync-kv-offload control path.
        self.peer = peer
        # optional kv.remote.RemoteTier (shared cache server): also NOT
        # part of the cascade. The manager writes THROUGH to it (every
        # stored block is offered via the tier's write-behind batched
        # put, so sibling engines get cross-engine hits even while the
        # local tiers still hold the block) and reads from it only as a
        # chain source (one get_chain per restore, on the worker).
        # contains() consults its push memo for export dedupe; restore
        # partitioning uses contains_local() so remote-held chains ride
        # the single pull instead of per-block reads.
        self.remote = remote
        self.reporter = reporter
        if remote is not None and reporter is not None:
            # controller admits for tier 'remote' fire only when a
            # write-behind batch is ACKED by the server — admitting at
            # buffer time would leave phantom remote entries whenever a
            # flush drops on a dead server (KV-aware routing would then
            # chase restores that always miss)
            remote.on_flushed = (
                lambda hs: self.reporter.admit(self.remote.name, hs)
            )
        # guards the pending-write/pending-read maps and the per-tier
        # counters; tiers are internally locked so the worker thread's
        # disk/remote IO never blocks the engine loop
        self._lock = threading.Lock()
        self._pending: dict[int, torch.Tensor] = {}
        # hash -> (arr | None, serving tier name | None): completed reads
        # awaiting pickup by the engine (mirror of the pending-write map)
        self._pending_reads: dict[int, tuple] = {}
        self._requested_reads: set[int] = set()
        # hash -> number of live restore records wanting it: concurrent
        # restores of a SHARED prefix (e.g. a common system prompt) each
        # hold a reference, so one record's take_reads cannot starve the
        # others (results are popped only at refcount zero)
        self._read_refs: dict[int, int] = {}
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # export jobs queued or running: each holds DEVICE gather
        # buffers alive until materialized, so callers gate on this to
        # keep HBM from becoming the slow-tier overflow buffer
        self._export_backlog = 0
        self.hits = 0
        self.misses = 0
        # per-tier hits/misses/read_bytes/write_bytes (tpu:kv_tier_*)
        self._tier_counters: dict[str, dict[str, int]] = {}
        self._worker = threading.Thread(
            target=self._run, name="kv-offload-writer", daemon=True
        )
        self._worker.start()

    def _count(self, tier: str, key: str, n: int) -> None:
        self._count_all({tier: {key: n}})

    def _count_all(self, per_tier: dict[str, dict[str, int]]) -> None:
        """One lock round-trip for a whole lookup's counter bumps — the
        worker's per-block loops share this lock with the step thread's
        contains()/poll_reads() probes."""
        with self._lock:
            for tier, deltas in per_tier.items():
                c = self._tier_counters.setdefault(
                    tier, {"hits": 0, "misses": 0,
                           "read_bytes": 0, "write_bytes": 0}
                )
                for key, n in deltas.items():
                    c[key] += n

    def counters(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {t: dict(c) for t, c in self._tier_counters.items()}

    # -- engine-facing API: writes -----------------------------------------
    def put_batch(self, pairs: list[tuple[int, torch.Tensor]]) -> None:
        if not pairs:
            return
        with self._lock:
            fresh = [
                (h, arr) for h, arr in pairs
                if h not in self._pending and not self._contains_tier(h)
            ]
            for h, arr in fresh:
                self._pending[h] = arr
        for h, arr in fresh:
            self._q.put(("write", h, arr))

    def put_batch_async(
        self, hashes: list[int], handle, materialize, on_done=None,
    ) -> None:
        """Deferred export: `handle` is a DEVICE-side snapshot of the
        blocks for `hashes` (the engine enqueues it right after the
        step's dispatch so the copy overlaps compute);
        `materialize(handle)` runs ON THE WORKER thread and returns the
        (2, L, n, nkv, bs, d) host tensor. The hashes become visible to
        contains() immediately (no duplicate export is ever queued);
        reads requested for them are served after materialization by
        FIFO order of the worker queue. `on_done(seconds, blocks,
        nbytes)` fires on the worker when the batch is stored."""
        if not hashes:
            return
        with self._lock:
            self._export_backlog += 1
            for h in hashes:
                self._pending.setdefault(h, _EXPORT_PENDING)
        # the handle (live DEVICE gather buffers) travels in a one-shot
        # box the worker consumes, so neither the queue tuple nor the
        # worker loop's job binding keeps the buffers alive after the
        # d2h materialization
        self._q.put(
            ("export", list(hashes), [handle], materialize, on_done)
        )

    def export_backlog(self) -> int:
        """Deferred-export batches queued or materializing (each pins
        device gather buffers until the worker's d2h completes)."""
        with self._lock:
            return self._export_backlog

    # -- engine-facing API: reads ------------------------------------------
    def request_reads(self, hashes: list[int]) -> None:
        """Queue tier fetches on the worker (staged restore). Each call
        takes a reference on every hash (balanced by take_reads/
        discard_reads); the fetch itself is queued once per hash."""
        enq: list[int] = []
        with self._lock:
            for h in hashes:
                self._read_refs[h] = self._read_refs.get(h, 0) + 1
                if (h not in self._pending_reads
                        and h not in self._requested_reads):
                    self._requested_reads.add(h)
                    enq.append(h)
        for h in enq:
            self._q.put(("read", h))

    def chain_sources(self) -> list:
        """Chain-read sources in preference order: the PD peer (an
        engine that JUST prefilled this prompt — intra-fleet, hottest)
        first, then the shared cache server. Both speak the same
        `get_chain(hashes) -> (blocks, addr)` contract."""
        return [s for s in (self.peer, self.remote) if s is not None]

    def has_chain_source(self) -> bool:
        return self.peer is not None or self.remote is not None

    # stackcheck: hot-path — called at add_request on the scheduler
    # thread: refcount + queue bookkeeping only; the peer's/remote's
    # blocking socket round-trip runs on the worker (_do_chain_read)
    def request_chain_reads(self, hashes: list[int]) -> None:
        """Queue ONE chain pull for `hashes` (staged restore over the
        inter-engine transfer or the shared cache server). Same
        refcount contract as request_reads; hashes already
        fetching/fetched ride the existing entry, the rest travel as a
        single get_chain round-trip (the chain hash is the address — no
        per-block requests). Without any chain source, the hashes park
        as misses so the caller's poll/take flow needs no special
        case."""
        enq: list[int] = []
        with self._lock:
            for h in hashes:
                self._read_refs[h] = self._read_refs.get(h, 0) + 1
                if (h not in self._pending_reads
                        and h not in self._requested_reads):
                    self._requested_reads.add(h)
                    enq.append(h)
        if not enq:
            return
        if not self.has_chain_source():
            with self._lock:
                for h in enq:
                    self._requested_reads.discard(h)
                    if self._read_refs.get(h, 0) > 0:
                        self._pending_reads[h] = (None, None)
            return
        self._q.put(("chain", enq))

    def poll_reads(self, hashes: list[int]) -> dict[int, tuple]:
        """Completed subset of `hashes`: h -> (arr | None, tier_name)."""
        with self._lock:
            return {
                h: self._pending_reads[h]
                for h in hashes if h in self._pending_reads
            }

    def take_reads(self, hashes: list[int]) -> dict[int, tuple]:
        """poll_reads + reference release: results are removed only when
        the LAST wanting record consumed them, so restores sharing a
        prefix each get their copy."""
        with self._lock:
            out = {}
            for h in hashes:
                if h in self._pending_reads:
                    out[h] = self._pending_reads[h]
                refs = self._read_refs.get(h, 0) - 1
                if refs > 0:
                    self._read_refs[h] = refs
                else:
                    self._read_refs.pop(h, None)
                    self._pending_reads.pop(h, None)
            return out

    def discard_reads(self, hashes: list[int]) -> None:
        self.take_reads(hashes)

    def _lookup(self, h: int) -> tuple[torch.Tensor | None, str | None]:
        """The ONE block lookup (pending-write map first — a block is
        readable the moment its write is enqueued — then the tier
        cascade), with hit/miss/byte accounting. Blocking tier IO runs
        on the CALLING thread: the worker for async reads, the
        scheduler thread only on the --sync-kv-offload path."""
        with self._lock:
            arr = self._pending.get(h)
            if arr is _EXPORT_PENDING:
                arr = None  # d2h not materialized yet: not readable
        if arr is not None:
            self.hits += 1
            self._count_all(
                {"pending": {"hits": 1,
                             "read_bytes": int(arr.nbytes)}}
            )
            return arr, "pending"
        # accumulate the walk's counters locally; ONE locked flush
        counts: dict[str, dict[str, int]] = {}
        hit_tier = None
        for tier in self.tiers:
            arr = tier.get(h)
            if arr is not None:
                hit_tier = tier.name
                counts[tier.name] = {
                    "hits": 1, "read_bytes": int(arr.nbytes),
                }
                break
            counts[tier.name] = {"misses": 1}
        if counts:
            self._count_all(counts)
        if hit_tier is not None:
            self.hits += 1
            return arr, hit_tier
        self.misses += 1
        return None, None

    def get(self, h: int) -> torch.Tensor | None:
        """Synchronous lookup (--sync-kv-offload path and unit tests);
        the engine's async restore goes through request_reads."""
        return self._lookup(h)[0]

    def contains(self, h: int) -> bool:
        """Block known to the manager ANYWHERE it could write (pending,
        local tiers, or already pushed to the shared cache) — the
        export-dedupe probe: a block the remote already holds must not
        be re-exported just because the local tiers dropped it."""
        with self._lock:
            if h in self._pending:
                return True
        if self._contains_tier(h):
            return True
        return self.remote is not None and self.remote.contains(h)

    # stackcheck: hot-path — restore partitioning on the scheduler
    # thread (_begin_kv_restore): in-memory map probes only
    def contains_local(self, h: int) -> bool:
        """Block readable via per-block LOCAL tier reads (pending map or
        cpu/disk). Remote-held blocks deliberately answer False here so
        the restore routes them through the ONE-pull chain read instead
        of a per-block network get each."""
        with self._lock:
            if h in self._pending:
                return True
        return self._contains_tier(h)

    def _contains_tier(self, h: int) -> bool:
        return any(t.contains(h) for t in self.tiers)

    def snapshot(self) -> dict[str, list[int]]:
        """tier -> hashes, for controller re-registration replay."""
        out = {t.name: t.hashes() for t in self.tiers}
        if self.remote is not None:
            out[self.remote.name] = self.remote.hashes()
        with self._lock:
            if self._pending and self.tiers:
                out.setdefault(self.tiers[0].name, []).extend(self._pending)
        return out

    def stats(self) -> list[dict]:
        with self._lock:
            n_pending = len(self._pending)
        out = [t.stats() for t in self.tiers] + [
            {"tier": "pending", "blocks": n_pending,
             "hits": self.hits, "misses": self.misses}
        ]
        if self.peer is not None:
            out.append(self.peer.stats())
        if self.remote is not None:
            out.append(self.remote.stats())
        return out

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=2.0)
        if self.peer is not None:
            self.peer.close()
        if self.remote is not None:
            self.remote.close()

    # -- worker thread -----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            kind = job[0]
            try:
                if kind == "write":
                    self._do_write(job[1], job[2])
                elif kind == "export":
                    self._do_export(job[1], job[2], job[3], job[4])
                elif kind == "chain":
                    self._do_chain_read(job[1])
                else:
                    self._do_read(job[1])
            except Exception:  # noqa: BLE001 — one bad block/file must
                # not kill the worker (and with it every later offload)
                logger.exception("kv offload %s job failed", kind)
                if kind == "export":
                    with self._lock:
                        for h in job[1]:
                            if self._pending.get(h) is _EXPORT_PENDING:
                                self._pending.pop(h, None)
                elif kind in ("read", "chain"):
                    failed = job[1] if kind == "chain" else [job[1]]
                    with self._lock:
                        for h in failed:
                            self._requested_reads.discard(h)
                            if self._read_refs.get(h, 0) > 0:
                                # same refcount guard as _do_read:
                                # parking an unowned failure entry would
                                # block the NEXT restore's fresh fetch
                                self._pending_reads[h] = (None, None)

    def _do_write(self, h: int, arr: torch.Tensor) -> None:
        try:
            self._store(h, arr)
        finally:
            with self._lock:
                self._pending.pop(h, None)

    def _do_export(self, hashes, box, materialize, on_done) -> None:
        """Deferred-export body: the BLOCKING d2h materialization plus
        per-block owning copies, all on this worker thread. `box` holds
        the device-side handle; popping it here makes this frame the
        LAST reference, so the gather buffers free the moment the copy
        lands (or fails) — not when the tier stores finish, and not
        when the worker loop rebinds its job variable."""
        t0 = time.perf_counter()
        try:
            data = materialize(box.pop())  # (2, L, n, ...) host array
        finally:
            with self._lock:
                self._export_backlog -= 1
        nbytes = 0
        for i, h in enumerate(hashes):
            # per-block owning copies (own_block): a view of the
            # batched export would pin the WHOLE export alive in the CPU
            # tier until every sibling block is evicted (byte accounting)
            arr = own_block(data, i)
            nbytes += int(arr.nbytes)
            with self._lock:
                self._pending[h] = arr
            try:
                self._store(h, arr)
            finally:
                with self._lock:
                    self._pending.pop(h, None)
        if on_done is not None:
            on_done(time.perf_counter() - t0, len(hashes), nbytes)

    def _do_read(self, h: int) -> None:
        """Pending-read body: one _lookup, result parked for the
        requester(s) (refcounted)."""
        arr, tier_name = self._lookup(h)
        with self._lock:
            self._requested_reads.discard(h)
            if self._read_refs.get(h, 0) > 0:
                # only park results someone still wants: every live
                # restore record holds a reference; a read whose
                # requesters all dropped (abort/timeout) is garbage
                self._pending_reads[h] = (arr, tier_name)

    def _do_chain_read(self, hashes: list[int]) -> None:
        """Chain-pull body: at most one blocking get_chain round-trip
        per source on this worker thread (peer first, then the shared
        cache — a source serving only a short prefix hands the
        UNSERVED TAIL to the next source, so a peer that evicted most
        of a chain the shared cache still holds does not force a
        recompute), per-block results parked for the requester(s)
        exactly like local tier reads (the pending-READ map is the
        transport-agnostic fetch interface). Each served block parks
        under its serving source's tier name ('peer'/'remote'); the
        tail nobody serves parks as misses so the owning restore
        truncates at the break and recomputes."""
        sources = self.chain_sources()
        blocks: list[torch.Tensor] = []
        tiers: list[str] = []  # per-block serving source
        for source in sources:
            if len(blocks) >= len(hashes):
                break
            got, _addr = source.get_chain(hashes[len(blocks):])
            if got:
                blocks.extend(got)
                tiers.extend([source.name] * len(got))
        counts: dict[str, dict[str, int]] = {}
        for b, t in zip(blocks, tiers):
            c = counts.setdefault(t, {"hits": 0, "read_bytes": 0})
            c["hits"] += 1
            c["read_bytes"] += int(b.nbytes)
        if len(blocks) < len(hashes):
            # the fully-unserved tail is attributed to the first
            # source walked (each source also keeps its own counters)
            first = sources[0].name if sources else "peer"
            counts.setdefault(first, {})["misses"] = (
                counts.get(first, {}).get("misses", 0)
                + len(hashes) - len(blocks)
            )
        with self._lock:
            for i, h in enumerate(hashes):
                self._requested_reads.discard(h)
                if self._read_refs.get(h, 0) > 0:
                    if i < len(blocks):
                        self._pending_reads[h] = (blocks[i], tiers[i])
                    else:
                        self._pending_reads[h] = (None, None)
        if counts:
            self._count_all(counts)

    def _store(self, h: int, arr: torch.Tensor) -> None:
        # write THROUGH to the shared cache (write-behind batched put
        # inside the tier — buffering here, the frame ships when the
        # batch fills/ages): every exported block is offered so sibling
        # engines get cross-engine hits regardless of local tier state.
        # Controller admits fire from the tier's on_flushed callback
        # (ack'd state only), not here.
        if self.remote is not None and not self.remote.contains(h):
            self.remote.put(h, arr)
        cascade = [(h, arr)]
        for tier in self.tiers:
            next_cascade: list[tuple[int, torch.Tensor]] = []
            admitted: list[int] = []
            displaced: list[int] = []
            for ch, carr in cascade:
                evicted = tier.put(ch, carr)
                # a put may (a) admit ch, possibly displacing residents, or
                # (b) reject ch outright (ch comes back in the evict list).
                # Only displaced RESIDENTS are evictions of this tier —
                # reporting a rejected block as evicted would make the
                # controller delete state the tier never held.
                if not any(eh == ch for eh, _ in evicted):
                    admitted.append(ch)
                    self._count(tier.name, "write_bytes",
                                int(carr.nbytes))
                for eh, earr in evicted:
                    next_cascade.append((eh, earr))
                    if eh != ch:
                        displaced.append(eh)
            if self.reporter is not None:
                if admitted:
                    self.reporter.admit(tier.name, admitted)
                if displaced:
                    self.reporter.evict(tier.name, displaced)
            cascade = next_cascade
            if not cascade:
                return
        # fell off the last tier: gone for good (controller already told)


def build_offload_manager(
    config, reporter=None, peer=None
) -> KVOffloadManager | None:
    """Construct tiers from EngineConfig (cpu/disk/remote settings).
    `peer` is an optional kv.peer.PeerTier: a peer-only or remote-only
    manager (no local tiers) is valid — disaggregated decode engines
    and shared-cache-only engines restore through the same pending-READ
    map without any local offload tier."""
    tiers: list[KVTier] = []
    if config.cpu_offload_bytes:
        tiers.append(CpuTier(config.cpu_offload_bytes))
    if config.disk_offload_dir:
        tiers.append(DiskTier(config.disk_offload_dir))
    remote = None
    if config.remote_cache_url:
        from production_stack_tpu_torch.kv.remote import RemoteTier

        remote = RemoteTier(config.remote_cache_url)
    if not tiers and peer is None and remote is None:
        return None
    return KVOffloadManager(tiers, reporter, peer=peer, remote=remote)
