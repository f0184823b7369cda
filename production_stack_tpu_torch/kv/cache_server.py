"""Standalone shared KV cache server (LMCache remote-server equivalent).

The cluster's fourth moving part next to router / engines / controller
(reference deploys `lmcache_experimental_server` as a shared cache pod,
helm/templates/deployment-cache-server.yaml): N engines push exported KV
block chains into it through their `kv.remote.RemoteTier` (write-behind
batched `put_batch` frames) and pull them back with ONE `get_chain` per
restore — so an engine that never saw a prompt still serves its shared
prefix at restore cost instead of recompute cost.

Production posture (vs the original 250-line stub):

- **IO outside the global lock.** The server lock guards only the
  per-chain index, the TTL ledger, and counters — never tier IO. Tier
  writes are serialized on a dedicated single-writer executor
  (preserving the tiers' single-writer invariant), reads run
  concurrently on the default executor: a multi-MB disk spill no
  longer stalls every other client's get/lookup.
- **Per-chain index + cheap `lookup` verb.** A host-RAM set of present
  hashes answers "how deep does this chain hit?" with zero tier IO and
  zero payload — the router's KV-aware policies call it per request.
- **Batched frames.** `put_batch`/`get_batch` move many blocks per
  frame (blocks stacked on the wire block axis), `get_chain` returns
  the longest stored prefix run in one payload.
- **TTL + LRU across RAM -> disk.** LRU eviction cascades cpu -> disk
  (the tiers' existing contract); `--ttl-s` additionally expires
  entries by age — lazily on the query path and via a watched sweep
  task — so a multi-tenant cache bounds staleness, not just bytes.
- **Ops surface.** `stats` (JSON), `metrics` (Prometheus text),
  `health` (liveness), and a `--probe` CLI mode for helm exec probes.

Copy of ``production_stack_tpu/kv/cache_server.py`` on the port's host
blocks (CPU tensors, kv/offload.py): engines of either package share it.

Run: python -m production_stack_tpu_torch.kv.cache_server --port 8100 \
         --capacity-gb 16 [--disk-dir /data/kvcache \
         --disk-capacity-gb 256] [--ttl-s 3600]
Probe: python -m production_stack_tpu_torch.kv.cache_server --probe \
         127.0.0.1:8100
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import torch

from production_stack_tpu_torch.kv import wire
from production_stack_tpu_torch.kv.offload import (
    CpuTier,
    DiskTier,
    deserialize_block,
    own_block,
    serialize_block,
)

# back-compat alias: the engine-side client moved to kv/remote.py when
# it grew pooling + batching; importers keep working
from production_stack_tpu_torch.kv.remote import (  # noqa: F401
    CacheClient as RemoteCacheClient,
)
from production_stack_tpu_torch.utils.log import init_logger
from production_stack_tpu_torch.utils.tasks import spawn_watched

logger = init_logger(__name__)

DEFAULT_PORT = 8100

#: TTL sweep cadence (the query path also expires lazily; the sweep
#: only bounds staleness for an idle cache)
SWEEP_INTERVAL_S = 5.0


class KVCacheServer:
    """Tiered (RAM -> disk) content-addressed KV block store + asyncio
    TCP server speaking the kv/wire.py frames.

    Lock discipline: `self._lock` guards the index set, the TTL
    ledger, and counters ONLY. Tier IO (serialization, disk writes,
    eviction-victim reads) runs with no server-level lock held — the
    tiers are internally locked with their own IO-outside-lock
    discipline. All mutating tier traffic is serialized through the
    one-thread `_writer` executor; reads share the loop's default
    executor and run concurrently with writes."""

    def __init__(self, capacity_bytes: int = 16 * 2**30,
                 disk_dir: str | None = None,
                 disk_capacity_bytes: int | None = None,
                 ttl_s: float | None = None):
        self.tiers = [CpuTier(capacity_bytes)]
        if disk_dir:
            self.tiers.append(DiskTier(disk_dir, disk_capacity_bytes))
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        # present ANYWHERE in the tier stack: the per-chain index the
        # `lookup` verb walks (no tier IO, no payload)
        self._index: set[int] = set()
        # hash -> monotonic expiry deadline, insertion-ordered (one TTL
        # for all entries => front is always the next to expire)
        self._expiry: OrderedDict[int, float] = OrderedDict()
        # expired-from-ledger hashes awaiting tier deletion on the
        # writer executor (the read path must never do tier IO)
        self._pending_deletes: list[int] = []
        # writer-executor mutations in flight / completed: while ANY
        # write runs — or ran at any point during a reader's tier walk
        # (epoch moved) — that reader's miss may be a block mid-pop
        # between tiers (the eviction victim window inside tier.put),
        # so the stale-index cleanup must not fire. Writes serialize on
        # one executor, so _writes_active is effectively a 0/1 flag.
        self._writes_active = 0
        self._write_epoch = 0
        # adopt blocks a restarted disk tier brought back
        for t in self.tiers:
            for h in t.hashes():
                self._index.add(h)
                if ttl_s is not None:
                    self._expiry[h] = time.monotonic() + ttl_s
        self._server: asyncio.AbstractServer | None = None
        self._sweep_task: asyncio.Task | None = None
        # single-writer executor: tier puts assume one writer (see
        # DiskTier.put); a slow disk spill now stalls only other WRITES
        self._writer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kv-cache-writer"
        )
        self._t0 = time.monotonic()
        self.puts = 0
        self.gets = 0
        self.hits = 0
        self.lookups = 0
        self.lookup_hits = 0     # lookups that matched >= 1 block
        self.expired = 0         # TTL expirations
        self.evicted = 0         # LRU fall-offs past the last tier

    # -- storage (writer-executor thread) ----------------------------------
    def put(self, h: int, arr: torch.Tensor) -> None:
        with self._lock:
            self.puts += 1
            self._writes_active += 1
            self._write_epoch += 1
            if self.ttl_s is not None:
                # refresh: re-put moves the entry to the TTL back too
                self._expiry.pop(h, None)
                self._expiry[h] = time.monotonic() + self.ttl_s
            refresh = h in self._index
        try:
            if refresh:
                for tier in self.tiers:
                    if tier.contains(h):
                        tier.put(h, arr)  # existing hash = move_to_end
                        return
                # index said present but no tier holds it (corrupt file
                # dropped it): fall through and store for real
            # admit into the FIRST tier and index the block immediately
            # — the eviction cascade below may stall in disk IO, and
            # readers must see the just-admitted block meanwhile (the
            # lock is never held across tier IO)
            evicted = self.tiers[0].put(h, arr)
            with self._lock:
                self._index.add(h)
            if evicted:
                self._cascade(evicted, start=1)
        finally:
            with self._lock:
                self._writes_active -= 1
                self._write_epoch += 1

    def put_batch(self, hashes: list[int], data: torch.Tensor) -> None:
        """One multi-block frame: data is (2, L, n_blocks, ...) with
        blocks stacked along axis 2 (the wire block axis)."""
        for i, h in enumerate(hashes):
            self.put(h, own_block(data, i))

    def _cascade(
        self, pairs: list[tuple[int, torch.Tensor]], start: int = 0
    ) -> None:
        """Demote evicted blocks down the tier stack with NO server
        lock held (the caller's `_writes_active` window keeps the
        stale-index cleanup quiet while victims are mid-pop between
        tiers); blocks that fall off the last tier leave the index
        (they are gone for good)."""
        cascade = pairs
        for tier in self.tiers[start:]:
            nxt: list[tuple[int, torch.Tensor]] = []
            for ch, carr in cascade:
                nxt.extend(tier.put(ch, carr))
            cascade = nxt
            if not cascade:
                return
        if cascade:
            with self._lock:
                for ch, _ in cascade:
                    self._index.discard(ch)
                    self._expiry.pop(ch, None)
                    self.evicted += 1

    # -- TTL ---------------------------------------------------------------
    def expire_ledger(self) -> int:
        """Pop expired hashes from the ledger+index (under the lock,
        NO tier IO — query paths call this lazily, so a router lookup
        probe never waits on file deletes). The popped hashes queue for
        tier deletion by the sweep task on the WRITER executor (the
        single-writer invariant; bytes free within SWEEP_INTERVAL_S —
        visibility is already correct the moment the index drops)."""
        if self.ttl_s is None:
            return 0
        now = time.monotonic()
        n = 0
        with self._lock:
            while self._expiry:
                h, deadline = next(iter(self._expiry.items()))
                if deadline > now:
                    break
                self._expiry.popitem(last=False)
                self._index.discard(h)
                self.expired += 1
                self._pending_deletes.append(h)
                n += 1
        return n

    def expire_now(self) -> int:
        """Full expiry pass INCLUDING tier deletion (the sweep task
        runs this on the writer executor; tests call it directly).
        Returns entries newly expired from the ledger."""
        n = self.expire_ledger()
        with self._lock:
            drained, self._pending_deletes = self._pending_deletes, []
            # a hash RE-PUT after its lazy ledger expiry is back in the
            # index with a fresh TTL — deleting its (re-admitted) tier
            # entry now would destroy a live block the index still
            # advertises
            due = [h for h in drained if h not in self._index]
        for h in due:
            for tier in self.tiers:
                tier.delete(h)
        return n

    # -- reads (default-executor threads) ----------------------------------
    def get(self, h: int) -> torch.Tensor | None:
        self.expire_ledger()
        with self._lock:
            self.gets += 1
            present = h in self._index
            epoch0 = self._write_epoch
        if not present:
            return None
        for tier in self.tiers:
            arr = tier.get(h)
            if arr is not None:
                with self._lock:
                    # reads run CONCURRENTLY on the default executor:
                    # an unlocked += here loses increments and skews
                    # the exported hit rate under exactly that load
                    self.hits += 1
                return arr
        with self._lock:
            if self._writes_active == 0 and self._write_epoch == epoch0:
                # index was stale (corrupt/vanished file). With a write
                # in flight — or any write having STARTED OR FINISHED
                # during our tier walk (a demotion can begin and
                # complete entirely between two probes) — the miss may
                # be an eviction victim mid-pop between tiers:
                # transient, NOT stale, and dropping it would orphan
                # the block a lower tier (now) durably holds.
                self._index.discard(h)
                self._expiry.pop(h, None)
        return None

    def get_chain(self, hashes: list[int]) -> torch.Tensor | None:
        """Longest stored run of `hashes` -> (2, L, n, nkv, bs, d) or
        None — the same chain semantics as the prefill engine's
        KVTransferServer, so a decode engine's PeerTier/RemoteTier can
        point at a shared cache server address-interchangeably with a
        prefill peer."""
        out: list[torch.Tensor] = []
        for h in hashes:
            arr = self.get(h)
            if arr is None:
                break
            out.append(arr)
        if not out:
            return None
        return torch.stack(out, dim=2)

    def get_batch(
        self, hashes: list[int]
    ) -> tuple[list[int], torch.Tensor | None]:
        """Arbitrary-subset batched read: -> (found hashes in request
        order, blocks stacked on the wire block axis)."""
        found: list[int] = []
        arrs: list[torch.Tensor] = []
        for h in hashes:
            arr = self.get(h)
            if arr is not None:
                found.append(h)
                arrs.append(arr)
        if not arrs:
            return [], None
        return found, torch.stack(arrs, dim=2)

    def lookup(self, hashes: list[int]) -> int:
        """Prefix-hit depth of a hash chain — index probes only, no
        tier IO, no payload (lazy expiry here touches only the ledger;
        file deletes belong to the sweep task). THE verb KV-aware
        routing calls per request: O(depth) set lookups under one lock
        hold."""
        self.expire_ledger()
        depth = 0
        with self._lock:
            self.lookups += 1
            for h in hashes:
                if h not in self._index:
                    break
                depth += 1
            if depth:
                self.lookup_hits += 1
        return depth

    def exists(self, h: int) -> bool:
        self.expire_ledger()
        with self._lock:
            return h in self._index

    def stats(self) -> dict:
        with self._lock:
            idx_blocks = len(self._index)
            counters = {
                "puts": self.puts, "gets": self.gets, "hits": self.hits,
                "lookups": self.lookups, "lookup_hits": self.lookup_hits,
                "expired": self.expired, "evicted": self.evicted,
            }
        counters["hit_rate"] = (
            counters["hits"] / counters["gets"] if counters["gets"] else 0.0
        )
        return {
            **counters,
            "blocks": idx_blocks,
            "ttl_s": self.ttl_s,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "tiers": [t.stats() for t in self.tiers],
        }

    def metrics_text(self) -> str:
        """Prometheus exposition text (scraped via the `metrics` verb
        or fronted by any TCP->HTTP shim); occupancy + hit-rate are the
        Grafana 'Shared KV Cache' row's inputs."""
        s = self.stats()
        lines = [
            "# TYPE pst_cache_server_puts_total counter",
            f"pst_cache_server_puts_total {s['puts']}",
            "# TYPE pst_cache_server_gets_total counter",
            f"pst_cache_server_gets_total {s['gets']}",
            "# TYPE pst_cache_server_hits_total counter",
            f"pst_cache_server_hits_total {s['hits']}",
            "# TYPE pst_cache_server_lookups_total counter",
            f"pst_cache_server_lookups_total {s['lookups']}",
            "# TYPE pst_cache_server_lookup_hits_total counter",
            f"pst_cache_server_lookup_hits_total {s['lookup_hits']}",
            "# TYPE pst_cache_server_expired_total counter",
            f"pst_cache_server_expired_total {s['expired']}",
            "# TYPE pst_cache_server_evicted_total counter",
            f"pst_cache_server_evicted_total {s['evicted']}",
            "# TYPE pst_cache_server_hit_rate gauge",
            f"pst_cache_server_hit_rate {s['hit_rate']:.6f}",
            "# TYPE pst_cache_server_blocks gauge",
            f"pst_cache_server_blocks {s['blocks']}",
            "# TYPE pst_cache_server_uptime_seconds gauge",
            f"pst_cache_server_uptime_seconds {s['uptime_s']}",
        ]
        for t in s["tiers"]:
            lab = f'{{tier="{t["tier"]}"}}'
            lines.append(
                f"pst_cache_server_tier_blocks{lab} {t.get('blocks', 0)}"
            )
            lines.append(
                f"pst_cache_server_tier_used_bytes{lab} "
                f"{t.get('used_bytes', 0)}"
            )
            cap = t.get("capacity_bytes")
            if cap:
                lines.append(
                    f"pst_cache_server_tier_capacity_bytes{lab} {cap}"
                )
        return "\n".join(lines) + "\n"

    def health(self) -> dict:
        """Liveness payload (helm exec probe via --probe)."""
        with self._lock:
            blocks = len(self._index)
        return {
            "status": "ok",
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "blocks": blocks,
            "tiers": len(self.tiers),
        }

    # -- TCP ---------------------------------------------------------------
    async def start(self, host: str = "0.0.0.0",
                    port: int = DEFAULT_PORT) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)
        if self.ttl_s is not None:
            self._sweep_task = spawn_watched(
                self._sweep_loop(), "kv-cache-ttl-sweep"
            )
        logger.info("kv-cache-server listening on %s:%d", host, port)

    @property
    def port(self) -> int | None:
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            self._sweep_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self._writer.shutdown(wait=False)

    async def _sweep_loop(self) -> None:
        """Idle-cache TTL bound: the query path expires lazily, this
        covers a cache nobody is reading from."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(SWEEP_INTERVAL_S)
            # tier deletion does disk IO: keep it off the event loop,
            # and on the WRITER executor (single-writer invariant)
            await loop.run_in_executor(self._writer, self.expire_now)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                try:
                    msg, payload = await wire.recv_msg(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break  # clean close / client died mid-frame
                except wire.WireError as e:
                    # oversized/garbage header: the stream offset is
                    # unrecoverable — drop the CONNECTION, not the server
                    logger.warning("kv-cache-server bad frame: %s", e)
                    break
                try:
                    reply, out_payload = await self._dispatch(
                        loop, msg, payload
                    )
                except Exception as e:  # noqa: BLE001 — one bad verb
                    # (corrupt payload, shape mismatch) must not kill
                    # the connection loop, let alone the server
                    logger.exception(
                        "kv-cache-server %r failed", msg.get("type")
                    )
                    reply, out_payload = (
                        {"ok": False, "error": f"{type(e).__name__}: {e}"},
                        b"",
                    )
                await wire.send_msg(writer, reply, out_payload)
        finally:
            writer.close()

    async def _dispatch(
        self, loop: asyncio.AbstractEventLoop, msg: dict, payload: bytes
    ) -> tuple[dict, bytes]:
        t = msg.get("type")
        # multi-MB (de)serialization belongs on the executor threads
        # with the tier IO — the event loop thread only shuffles frames
        if t == "put":
            def _put():
                self.put(msg["hash"], deserialize_block(payload))

            await loop.run_in_executor(self._writer, _put)
            return {"ok": True}, b""
        if t == "put_batch":
            hashes = list(msg["hashes"])

            def _put_batch():
                data = deserialize_block(payload)
                if int(data.shape[2]) != len(hashes):
                    raise ValueError(
                        f"put_batch: {len(hashes)} hashes vs "
                        f"{int(data.shape[2])} blocks"
                    )
                self.put_batch(hashes, data)

            try:
                await loop.run_in_executor(self._writer, _put_batch)
            except ValueError as e:
                return {"ok": False, "error": str(e)}, b""
            return {"ok": True, "n": len(hashes)}, b""
        if t == "get":
            def _get():
                arr = self.get(msg["hash"])
                return None if arr is None else serialize_block(arr)

            out = await loop.run_in_executor(None, _get)
            if out is None:
                return {"ok": True, "found": False}, b""
            return {"ok": True, "found": True}, out
        if t == "get_chain":
            def _get_chain():
                data = self.get_chain(msg["hashes"])
                if data is None:
                    return 0, b""
                return int(data.shape[2]), serialize_block(data)

            n, out = await loop.run_in_executor(None, _get_chain)
            return {"ok": True, "n": n}, out
        if t == "get_batch":
            def _get_batch():
                found, data = self.get_batch(msg["hashes"])
                if data is None:
                    return [], b""
                return found, serialize_block(data)

            found, out = await loop.run_in_executor(None, _get_batch)
            return {"ok": True, "found": found}, out
        if t == "lookup":
            # index-only: cheap enough for the event loop thread, but
            # expire_now can touch disk — keep it off-loop anyway
            depth = await loop.run_in_executor(
                None, self.lookup, msg["hashes"]
            )
            return {"ok": True, "depth": depth}, b""
        if t == "exists":
            found = await loop.run_in_executor(
                None, self.exists, msg["hash"]
            )
            return {"ok": True, "found": found}, b""
        if t == "stats":
            return {"ok": True, **self.stats()}, b""
        if t == "metrics":
            return {"ok": True}, self.metrics_text().encode("utf-8")
        if t == "health":
            return {"ok": True, **self.health()}, b""
        if t == "ping":
            return {"ok": True}, b""
        return {"ok": False, "error": f"unknown type {t!r}"}, b""


class InProcessCacheServer:
    """A KVCacheServer on its own daemon thread's event loop — the ONE
    start-on-a-thread/stop-via-call_soon_threadsafe harness shared by
    the bench `@remotekv` mode, the smoke harness, and the test suite
    (blocking clients in those contexts need the server's loop off
    their thread; production runs the module as its own process)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, **kw):
        self.server: KVCacheServer | None = None
        self.port: int | None = None
        self._host, self._want_port, self._kw = host, port, kw
        self._loop = None
        self._ready = threading.Event()
        self._stopped = threading.Event()
        self._startup_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._ready.wait(10):
            raise RuntimeError("in-process cache server never came up")
        if self._startup_error is not None:
            raise RuntimeError(
                "in-process cache server failed to start"
            ) from self._startup_error

    def _run(self) -> None:
        async def body():
            try:
                srv = KVCacheServer(**self._kw)
                await srv.start(self._host, self._want_port)
            except BaseException as e:  # noqa: BLE001 — surfaced to
                # the constructor; the caller decides what to do
                self._startup_error = e
                self._ready.set()
                return
            self.server = srv
            self.port = srv.port
            self._loop = asyncio.get_running_loop()
            self._stop_ev = asyncio.Event()
            self._ready.set()
            await self._stop_ev.wait()
            await srv.stop()

        asyncio.run(body())
        self._stopped.set()

    def stats(self) -> dict:
        return self.server.stats() if self.server is not None else {}

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop_ev.set)
            self._stopped.wait(5)
            self._loop = None

    close = stop  # either name reads naturally at the call sites


def probe(addr: str, timeout: float = 3.0) -> int:
    """Helm liveness probe body: one health round-trip, exit-code
    semantics (0 healthy / 1 not)."""
    import socket as _socket

    host, port = wire.parse_addr(addr, DEFAULT_PORT)
    try:
        with _socket.create_connection((host, port), timeout=timeout) as s:
            s.settimeout(timeout)
            wire.sync_send(s, {"type": "health"})
            reply, _ = wire.sync_recv(s)
    except (OSError, RuntimeError, ValueError) as e:
        print(f"unhealthy: {e}", file=sys.stderr)
        return 1
    if not reply.get("ok"):
        print(f"unhealthy: {reply}", file=sys.stderr)
        return 1
    print(
        f"ok uptime={reply.get('uptime_s')}s blocks={reply.get('blocks')}"
    )
    return 0


def main() -> None:
    p = argparse.ArgumentParser(description="TPU stack shared KV cache server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--capacity-gb", type=float, default=16.0)
    p.add_argument("--disk-dir", default=None)
    p.add_argument("--disk-capacity-gb", type=float, default=None)
    p.add_argument("--ttl-s", type=float, default=None,
                   help="expire entries this many seconds after their "
                        "last put (default: no TTL, LRU only)")
    p.add_argument("--probe", metavar="HOST:PORT", default=None,
                   help="health-probe a running server and exit 0/1 "
                        "(helm exec liveness probe)")
    args = p.parse_args()

    if args.probe:
        sys.exit(probe(args.probe))

    async def run() -> None:
        srv = KVCacheServer(
            capacity_bytes=int(args.capacity_gb * 2**30),
            disk_dir=args.disk_dir,
            disk_capacity_bytes=(
                int(args.disk_capacity_gb * 2**30)
                if args.disk_capacity_gb else None
            ),
            ttl_s=args.ttl_s,
        )
        await srv.start(args.host, args.port)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
