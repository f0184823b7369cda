"""Cluster-wide shared KV cache tier: the engine side of the
`kv.cache_server` service (LMCache remote-server equivalent).

Copy of ``production_stack_tpu/kv/remote.py`` on the port's host blocks
(CPU tensors, kv/offload.py); it speaks to a JAX cache server as well as
a port one.

`RemoteTier` is the fourth KV source next to CpuTier / DiskTier /
PeerTier — a connection-pooled wire client that plugs into the
`KVOffloadManager` through the SAME zero-stall primitives (deferred
export, pending-READ map, staged import),
so the engine step loop never touches a socket:

- **Exports (write-behind, batched):** tier writes arrive on the
  offload worker (the d2h snapshot already materialized there via
  `stage_export_blocks`). `put()` only BUFFERS the block; a buffer
  reaching `flush_blocks`/`flush_bytes` — or going stale past
  `flush_age_s`, swept by a tiny daemon — ships as ONE multi-block
  `put_batch` frame. A dead server drops the batch with a counted
  fallback; the engine never stalls and local tiers are unaffected.
- **Restores (one chain pull):** the tier is a *chain source* for the
  manager's pending-READ map: `_begin_kv_restore` routes the
  non-local tail of a prompt's hash chain through
  `request_chain_reads`, the worker issues ONE `get_chain`, and the
  blocks land through `stage_import_blocks`/`import_staged_blocks`
  exactly like a PD peer pull. Chain break or server death falls back
  to recompute — never an exception into the worker loop.
- **Scheduler-thread contract:** the only methods that run on the
  scheduler thread are `contains()`/`hashes()` — a local memo of
  hashes this engine pushed, no network. Same stackcheck gate as
  peer.py (`test_kv_tiering_stays_off_hot_paths`).

`AsyncCacheClient`, the router-side client of the JAX module, lives in
kv/cache_client.py here: the router imports it, and this module imports
torch.
"""

from __future__ import annotations

import socket
import threading
import time

import torch

from production_stack_tpu_torch.kv import wire
from production_stack_tpu_torch.kv.cache_client import parse_cache_addr
from production_stack_tpu_torch.kv.offload import (
    KVTier,
    deserialize_block,
    own_block,
    serialize_block,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)



class _PooledConn:
    """One pooled blocking connection (reconnect on next use)."""

    __slots__ = ("host", "port", "timeout", "sock")

    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port, self.timeout = host, port, timeout
        self.sock: socket.socket | None = None

    def ensure(self) -> socket.socket:
        if self.sock is None:
            self.sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
            self.sock.settimeout(self.timeout)
        return self.sock

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class CacheClient:
    """Blocking, connection-POOLED cache-server client.

    Only ever driven from worker/executor threads (the offload worker,
    the sync-mode attribution control, tests) — never the scheduler
    thread. The pool exists so a long `put_batch` upload does not
    serialize a concurrent `stats`/`lookup` probe behind it: each call
    borrows a connection, creating up to `pool_size` on demand."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 pool_size: int = 2):
        self.host, self.port, self.timeout = host, port, timeout
        self.pool_size = max(1, pool_size)
        self._free: list[_PooledConn] = []
        self._lock = threading.Lock()
        self._out = 0  # connections currently borrowed

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def _borrow(self) -> _PooledConn:
        with self._lock:
            if self._free:
                self._out += 1
                return self._free.pop()
            self._out += 1
        return _PooledConn(self.host, self.port, self.timeout)

    def _give_back(self, conn: _PooledConn, broken: bool) -> None:
        if broken:
            conn.close()
        with self._lock:
            self._out -= 1
            if not broken and len(self._free) < self.pool_size:
                self._free.append(conn)
                return
        conn.close()

    def call(self, msg: dict, payload: bytes = b"") -> tuple[dict, bytes]:
        """One request/reply round-trip; one transparent reconnect for
        a connection the server idled out, then errors propagate (the
        callers all degrade)."""
        conn = self._borrow()
        broken = True
        try:
            try:
                s = conn.ensure()
                wire.sync_send(s, msg, payload)
                reply = wire.sync_recv(s)
            except OSError:
                conn.close()
                s = conn.ensure()
                wire.sync_send(s, msg, payload)
                reply = wire.sync_recv(s)
            broken = False
            return reply
        finally:
            self._give_back(conn, broken)

    # -- verbs -------------------------------------------------------------
    def put(self, h: int, arr: torch.Tensor) -> None:
        reply, _ = self.call({"type": "put", "hash": h},
                             serialize_block(arr))
        if not reply.get("ok"):
            raise OSError(reply.get("error", "put failed"))

    def put_batch(self, pairs: list[tuple[int, torch.Tensor]]) -> None:
        """ONE multi-block frame: hashes in meta, blocks stacked along
        the wire block axis in the payload."""
        if not pairs:
            return
        data = torch.stack([a for _, a in pairs], dim=2)
        reply, _ = self.call(
            {"type": "put_batch", "hashes": [h for h, _ in pairs]},
            serialize_block(data),
        )
        if not reply.get("ok"):
            raise OSError(reply.get("error", "put_batch failed"))

    def get(self, h: int) -> torch.Tensor | None:
        reply, payload = self.call({"type": "get", "hash": h})
        if not reply.get("ok"):
            raise OSError(reply.get("error", "get failed"))
        if not reply.get("found"):
            return None
        return deserialize_block(payload)

    def get_chain(self, hashes: list[int]) -> list[torch.Tensor]:
        """Longest stored run of `hashes` as per-block owning arrays."""
        reply, payload = self.call(
            {"type": "get_chain", "hashes": hashes}
        )
        if not reply.get("ok") or not reply.get("n"):
            return []
        data = deserialize_block(payload)
        # per-block contiguous copies: a view of the batched payload
        # would pin the WHOLE transfer alive while any single block is
        # parked in the pending-read map
        return [own_block(data, i) for i in range(int(data.shape[2]))]

    def lookup(self, hashes: list[int]) -> int:
        """Prefix-hit depth (blocks) for a hash chain — index only."""
        reply, _ = self.call({"type": "lookup", "hashes": hashes})
        if not reply.get("ok"):
            raise OSError(reply.get("error", "lookup failed"))
        return int(reply.get("depth", 0))

    def exists(self, h: int) -> bool:
        reply, _ = self.call({"type": "exists", "hash": h})
        return bool(reply.get("found"))

    def stats(self) -> dict:
        reply, _ = self.call({"type": "stats"})
        return reply

    def health(self) -> dict:
        reply, _ = self.call({"type": "health"})
        return reply

    def ping(self) -> bool:
        try:
            reply, _ = self.call({"type": "ping"})
            return bool(reply.get("ok"))
        except (OSError, RuntimeError, ValueError):
            return False

    def close(self) -> None:
        with self._lock:
            conns, self._free = self._free, []
        for c in conns:
            c.close()


class RemoteTier(KVTier):
    """Shared-cache tier: write-behind batched PUTs, chain-read
    restores, memo-only scheduler-thread probes.

    NOT part of the eviction cascade the way Cpu/DiskTier are: the
    manager writes THROUGH to it (every exported block is offered, so
    sibling engines get cross-engine hits even while the local tiers
    still hold the block) and reads from it only via `get_chain` on the
    worker. Everything network degrades: a dead server costs counted
    fallbacks, never an exception or a stall."""

    name = "remote"

    #: write-behind flush thresholds: a batch ships when it holds this
    #: many blocks / bytes, or when the sweeper finds it older than
    #: flush_age_s (puts arrive in per-export bursts from the worker;
    #: the age sweep only covers the trailing partial batch)
    FLUSH_BLOCKS = 16
    FLUSH_BYTES = 8 * 2**20
    FLUSH_AGE_S = 0.2

    #: push-memo expiry (see _pushed): bounds memo growth and the
    #: phantom-suppression window after server restart / TTL eviction
    MEMO_TTL_S = 900.0

    def __init__(self, url_or_client, timeout: float = 10.0,
                 flush_blocks: int | None = None,
                 flush_bytes: int | None = None,
                 flush_age_s: float | None = None,
                 memo_ttl_s: float | None = None):
        if isinstance(url_or_client, str):
            host, port = parse_cache_addr(url_or_client)
            self.client = CacheClient(host, port, timeout=timeout)
        else:
            self.client = url_or_client
        self.flush_blocks = flush_blocks or self.FLUSH_BLOCKS
        self.flush_bytes = flush_bytes or self.FLUSH_BYTES
        self.flush_age_s = (
            self.FLUSH_AGE_S if flush_age_s is None else flush_age_s
        )
        self.memo_ttl_s = (
            self.MEMO_TTL_S if memo_ttl_s is None else memo_ttl_s
        )
        self._lock = threading.RLock()
        # serializes flush() bodies (worker-thread threshold flushes vs
        # the age sweeper): without it the two could ship the same
        # snapshot twice — harmless server-side (puts dedupe) but a
        # wasted multi-MB frame
        self._flush_lock = threading.Lock()
        # write-behind buffer: hash -> host array, readable by get()
        # until the flush lands (mirror of the manager's pending map)
        self._buf: dict[int, torch.Tensor] = {}
        self._buf_bytes = 0
        self._buf_t0: float | None = None  # oldest unflushed put
        # memo of hashes this engine pushed (contains() must answer on
        # the scheduler thread without a round-trip; blocks pushed by
        # OTHER engines are found via get_chain, not contains). Entries
        # carry a deadline (memo_ttl_s): the server ages blocks out by
        # its own TTL/LRU, and a memo that never forgot would (a) grow
        # one entry per block ever exported in a long-lived engine and
        # (b) suppress re-exports of chains the server no longer holds
        # FOREVER — expiring it re-offers them at worst one re-export
        # per window. (Controller-side 'remote' admits are advisory and
        # may outlive server state until then; the router's lookup verb
        # is the authoritative hint — full memo/TTL sync is ROADMAP
        # follow-on (d).)
        self._pushed: dict[int, float] = {}  # hash -> monotonic deadline
        # lifetime counters (tpu:kv_remote_* — GIL-atomic int adds,
        # read unlocked by the engine's stats snapshot)
        self.hits = 0          # blocks served by the cache server
        self.misses = 0        # chain blocks requested but not served
        self.read_bytes = 0
        self.write_bytes = 0   # bytes acked into the server
        self.puts = 0          # blocks offered (buffered)
        self.flushes = 0       # put_batch frames shipped
        self.fallbacks = 0     # failed flushes/pulls (dead server)
        # fired with the flushed hashes AFTER a put_batch frame is
        # ACKED by the server (the KVOffloadManager wires this to the
        # controller reporter): admits must reflect state the server
        # really holds — a buffered-but-dropped batch must not leave
        # phantom 'remote' entries in the controller
        self.on_flushed = None
        self._stop = threading.Event()
        # trailing-partial-batch sweeper; the worker's own put() calls
        # do threshold flushes, this only ages out the remainder
        self._sweeper = threading.Thread(
            target=self._sweep, name="kv-remote-flush", daemon=True
        )
        self._sweeper.start()

    # -- export side (offload worker thread) -------------------------------
    def put(self, h: int,
            arr: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
        """Buffer the block (write-behind); never evicts anything back
        into the cascade — the server owns its own capacity/TTL."""
        flush_now = False
        now = time.monotonic()
        with self._lock:
            if self._pushed.get(h, 0.0) > now or h in self._buf:
                return []
            self._pushed.pop(h, None)  # expired memo entry: re-offer
            self._buf[h] = arr
            self._buf_bytes += int(arr.nbytes)
            if self._buf_t0 is None:
                self._buf_t0 = time.monotonic()
            self.puts += 1
            if (len(self._buf) >= self.flush_blocks
                    or self._buf_bytes >= self.flush_bytes):
                flush_now = True
        if flush_now:
            self.flush()
        return []

    def flush(self) -> None:
        """Ship the buffered blocks as ONE put_batch frame (caller
        thread: the offload worker, the sweeper, or close())."""
        with self._flush_lock:
            with self._lock:
                if not self._buf:
                    return
                pairs = list(self._buf.items())
                # keep the buffer readable while the frame is in
                # flight; removal AFTER the send decides its fate below
            nbytes = sum(int(a.nbytes) for _, a in pairs)
            ok = True
            try:
                self.client.put_batch(pairs)
            except (OSError, RuntimeError, ValueError) as e:
                ok = False
                self.fallbacks += 1
                logger.warning(
                    "kv remote flush of %d blocks to %s failed: %s "
                    "(batch dropped; local tiers unaffected)",
                    len(pairs), self.client.addr, e,
                )
            if ok:
                self.flushes += 1
                self.write_bytes += nbytes
            with self._lock:
                now = time.monotonic()
                for h, _ in pairs:
                    a = self._buf.pop(h, None)
                    if a is not None:
                        self._buf_bytes -= int(a.nbytes)
                    if ok:
                        self._pushed[h] = now + self.memo_ttl_s
                self._buf_t0 = time.monotonic() if self._buf else None
            if ok and self.on_flushed is not None:
                try:
                    self.on_flushed([h for h, _ in pairs])
                except Exception as e:  # noqa: BLE001 — reporting is
                    # advisory; a reporter hiccup must not fail a flush
                    logger.warning("kv remote flush callback: %s", e)

    def _sweep(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.flush_age_s)
            with self._lock:
                stale = (
                    self._buf_t0 is not None
                    and time.monotonic() - self._buf_t0
                    >= self.flush_age_s
                )
            if stale:
                self.flush()

    # -- read side (offload worker / sync attribution control) -------------
    def get(self, h: int) -> torch.Tensor | None:
        with self._lock:
            arr = self._buf.get(h)
        if arr is not None:
            self.hits += 1
            self.read_bytes += int(arr.nbytes)
            return arr
        try:
            arr = self.client.get(h)
        except (OSError, RuntimeError, ValueError) as e:
            self.fallbacks += 1
            logger.warning("kv remote get from %s failed: %s",
                           self.client.addr, e)
            return None
        if arr is None:
            self.misses += 1
            return None
        self.hits += 1
        self.read_bytes += int(arr.nbytes)
        return arr

    def get_chain(
        self, hashes: list[int]
    ) -> tuple[list[torch.Tensor], str | None]:
        """Longest stored run of `hashes` — the chain-source interface
        shared with kv.peer.PeerTier, so the manager's ONE-pull staged
        restore works against either. Unflushed buffered blocks flush
        first (they may BE the requested prefix on a fast resume)."""
        if not hashes:
            return [], None
        with self._lock:
            buffered = any(h in self._buf for h in hashes)
        if buffered:
            self.flush()
        try:
            blocks = self.client.get_chain(hashes)
        except (OSError, RuntimeError, ValueError) as e:
            self.fallbacks += 1
            logger.warning("kv remote chain pull from %s failed: %s",
                           self.client.addr, e)
            return [], None
        if not blocks:
            self.misses += len(hashes)
            return [], None
        self.hits += len(blocks)
        self.misses += max(0, len(hashes) - len(blocks))
        self.read_bytes += sum(int(b.nbytes) for b in blocks)
        return blocks, self.client.addr

    def ping(self) -> bool:
        return self.client.ping()

    # -- scheduler-thread probes (memo only — NO network) ------------------
    # stackcheck: hot-path — called from _begin_kv_restore/export dedupe
    # on the scheduler thread: local set probe only, the socket lives in
    # put/flush/get_chain on the worker thread
    def contains(self, h: int) -> bool:
        with self._lock:
            return (self._pushed.get(h, 0.0) > time.monotonic()
                    or h in self._buf)

    def hashes(self) -> list[int]:
        """ACKED hashes only (the server really holds them). Buffered-
        but-unflushed blocks are deliberately excluded: the controller
        snapshot replay uses this, and registering a batch that may yet
        drop on a dead server would plant phantom 'remote' entries —
        the exact failure the acked-only on_flushed admits prevent.
        (Buffered blocks stay readable via get()/contains().)"""
        now = time.monotonic()
        with self._lock:
            # prune while answering: the memo must not grow one entry
            # per block ever exported over an engine's lifetime
            expired = [h for h, d in self._pushed.items() if d <= now]
            for h in expired:
                del self._pushed[h]
            return list(self._pushed)

    def counters(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "read_bytes": self.read_bytes,
            "write_bytes": self.write_bytes,
            "puts": self.puts, "flushes": self.flushes,
            "fallbacks": self.fallbacks,
        }

    def stats(self) -> dict:
        with self._lock:
            buffered = len(self._buf)
            pushed = len(self._pushed)
        return {"tier": self.name, "server": self.client.addr,
                "blocks_pushed": pushed, "blocks_buffered": buffered,
                **self.counters()}

    def close(self) -> None:
        self._stop.set()
        try:
            self.flush()  # last trailing batch rides out before close
        except Exception as e:  # noqa: BLE001 — shutdown best-effort
            logger.warning("kv remote close-flush failed: %s", e)
        self._sweeper.join(timeout=1.0)
        self.client.close()
