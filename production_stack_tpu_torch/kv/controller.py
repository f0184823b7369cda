"""KV controller: tracks which engine holds which KV block hashes per tier.

Role-equivalent of the LMCache controller manager the reference router
embeds (reference: routing_logic.py:31-39 imports, :282 starts it listening
on a TCP port; :300-376 sends LookupMsg / QueryInstMsg to it; the gateway
extension speaks the same protocol over TCP, kv_aware_picker.go:90-131).

Design: the router process runs `KVController` (asyncio TCP server).
Engines connect with a `ControllerReporter` (background thread) and stream
register/admit/evict events as blocks enter/leave their HBM + offload
tiers. Routers/pickers call `lookup(tokens)` -> {instance_id:
matched_prefix_tokens} either in-process (KvawareRouter) or over TCP
(`KVControllerClient`, used by external pickers).

Prefix matching is chained block hashing - identical to the engine's
BlockManager scheme (block_manager.hash_block) so controller-side matches
agree exactly with engine-side prefix-cache hits.
"""

from __future__ import annotations

import asyncio
import queue
import socket
import threading
import time

from production_stack_tpu_torch.engine.block_manager import iter_chain_hashes
from production_stack_tpu_torch.kv import wire
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

DEFAULT_PORT = 9000


class InstanceState:
    __slots__ = ("instance_id", "url", "block_size", "tiers", "last_seen", "meta")

    def __init__(self, instance_id: str, url: str, block_size: int,
                 meta: dict | None = None):
        self.instance_id = instance_id
        self.url = url
        self.block_size = block_size
        self.tiers: dict[str, set[int]] = {}
        self.last_seen = time.monotonic()
        self.meta = meta or {}

    def all_hashes(self) -> set[int]:
        out: set[int] = set()
        for s in self.tiers.values():
            out |= s
        return out


class KVController:
    """In-memory block-location registry + asyncio TCP server."""

    def __init__(self) -> None:
        self.instances: dict[str, InstanceState] = {}
        self._server: asyncio.AbstractServer | None = None
        self._lock = threading.Lock()  # reporters may be off-loop

    # -- registry ops (callable in-process or via TCP) ---------------------
    def register(self, instance_id: str, url: str, block_size: int,
                 meta: dict | None = None) -> None:
        with self._lock:
            self.instances[instance_id] = InstanceState(
                instance_id, url, block_size, meta
            )
        logger.info("kv-controller: registered %s (%s, block_size=%d)",
                    instance_id, url, block_size)

    def deregister(self, instance_id: str) -> None:
        with self._lock:
            self.instances.pop(instance_id, None)

    def admit(self, instance_id: str, tier: str, hashes: list[int]) -> None:
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                return
            inst.tiers.setdefault(tier, set()).update(hashes)
            inst.last_seen = time.monotonic()

    def evict(self, instance_id: str, tier: str, hashes: list[int]) -> None:
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                return
            s = inst.tiers.get(tier)
            if s is not None:
                s.difference_update(hashes)

    def lookup(self, tokens: list[int]) -> dict[str, int]:
        """Longest cached-prefix (in tokens) per instance, any tier."""
        out: dict[str, int] = {}
        with self._lock:
            # snapshot hash sets under the lock: reporters mutate the live
            # sets from other threads
            insts = [
                (i, i.all_hashes()) for i in self.instances.values()
            ]
        for inst, hashes in insts:
            n = self._match(tokens, inst, hashes)
            if n:
                out[inst.instance_id] = n
        return out

    def full_lookup(self, tokens: list[int]) -> dict[str, dict[str, int]]:
        """Per-instance, per-tier longest cached-prefix in tokens."""
        out: dict[str, dict[str, int]] = {}
        with self._lock:
            insts = [
                (i, {t: set(s) for t, s in i.tiers.items()})
                for i in self.instances.values()
            ]
        for inst, tiers in insts:
            per_tier = {}
            for tier, hashes in tiers.items():
                n = self._match(tokens, inst, hashes)
                if n:
                    per_tier[tier] = n
            if per_tier:
                out[inst.instance_id] = per_tier
        return out

    def query_instance(self, instance_id: str) -> dict | None:
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                return None
            return {
                "instance_id": inst.instance_id,
                "url": inst.url,
                "block_size": inst.block_size,
                "num_blocks": {t: len(s) for t, s in inst.tiers.items()},
                "meta": inst.meta,
            }

    @staticmethod
    def _match(tokens: list[int], inst: InstanceState,
               hashes: set[int]) -> int:
        matched = 0
        for h in iter_chain_hashes(tokens, inst.block_size):
            if h not in hashes:
                break
            matched += inst.block_size
        return matched

    # -- TCP server --------------------------------------------------------
    async def start(self, host: str = "0.0.0.0",
                    port: int = DEFAULT_PORT) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)
        logger.info("kv-controller listening on %s:%d", host, port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer_instances: list[str] = []
        try:
            while True:
                try:
                    msg, _ = await wire.recv_msg(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                reply = self._dispatch(msg, peer_instances)
                if reply is not None:
                    await wire.send_msg(writer, reply)
        finally:
            # engine connection dropping == instance gone (k8s pod death);
            # mirror the reference's watcher removing dead pods from rotation
            for iid in peer_instances:
                self.deregister(iid)
                logger.info("kv-controller: %s disconnected, deregistered", iid)
            writer.close()

    def _dispatch(self, msg: dict, peer_instances: list[str]) -> dict | None:
        t = msg.get("type")
        if t == "register":
            self.register(msg["instance_id"], msg.get("url", ""),
                          int(msg.get("block_size", 16)), msg.get("meta"))
            peer_instances.append(msg["instance_id"])
            return {"ok": True}
        if t == "admit":
            self.admit(msg["instance_id"], msg["tier"], msg["hashes"])
            return None  # fire-and-forget
        if t == "evict":
            self.evict(msg["instance_id"], msg["tier"], msg["hashes"])
            return None
        if t == "lookup":
            return {"ok": True, "matches": self.lookup(msg["tokens"])}
        if t == "full_lookup":
            return {"ok": True, "matches": self.full_lookup(msg["tokens"])}
        if t == "query_instance":
            return {"ok": True, "instance": self.query_instance(msg["instance_id"])}
        if t == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"unknown message type {t!r}"}


class KVControllerClient:
    """Async TCP client for routers/pickers querying a remote controller."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.host, self.port = host, port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()

    async def _ensure(self) -> None:
        if self._writer is None or self._writer.is_closing():
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )

    async def _call(self, msg: dict) -> dict:
        async with self._lock:
            try:
                await self._ensure()
                await wire.send_msg(self._writer, msg)
                reply, _ = await wire.recv_msg(self._reader)
            except (ConnectionError, asyncio.IncompleteReadError, OSError):
                # one reconnect attempt, then propagate
                self._writer = None
                await self._ensure()
                await wire.send_msg(self._writer, msg)
                reply, _ = await wire.recv_msg(self._reader)
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "controller error"))
        return reply

    async def lookup(self, tokens: list[int]) -> dict[str, int]:
        return (await self._call({"type": "lookup", "tokens": tokens}))["matches"]

    async def full_lookup(self, tokens: list[int]) -> dict[str, dict[str, int]]:
        reply = await self._call({"type": "full_lookup", "tokens": tokens})
        return reply["matches"]

    async def query_instance(self, instance_id: str) -> dict | None:
        reply = await self._call(
            {"type": "query_instance", "instance_id": instance_id}
        )
        return reply["instance"]

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class InProcessControllerClient:
    """Client facade over a KVController living in this process (the router
    embeds the controller, reference routing_logic.py:282; lookups then skip
    the TCP roundtrip while engines still report over TCP)."""

    def __init__(self, controller: KVController, owns_server: bool = True):
        self.controller = controller
        self.owns_server = owns_server

    async def lookup(self, tokens: list[int]) -> dict[str, int]:
        return self.controller.lookup(tokens)

    async def full_lookup(self, tokens: list[int]) -> dict[str, dict[str, int]]:
        return self.controller.full_lookup(tokens)

    async def query_instance(self, instance_id: str) -> dict | None:
        return self.controller.query_instance(instance_id)

    async def close(self) -> None:
        if self.owns_server:
            await self.controller.stop()


_LOCAL_HOSTS = ("", "127.0.0.1", "localhost", "0.0.0.0", "::1")


async def start_or_connect(
    host: str, port: int
) -> "KVControllerClient | InProcessControllerClient":
    """Embed a controller on (0.0.0.0, port) when the configured host is
    local; if the host is remote, or the local port is already taken,
    connect as a plain client instead (so pointing the router at a
    standalone controller on another machine works)."""
    if host not in _LOCAL_HOSTS:
        return KVControllerClient(host, port)
    controller = KVController()
    try:
        await controller.start("0.0.0.0", port)
        return InProcessControllerClient(controller)
    except OSError:
        logger.info(
            "kv-controller port %d taken; connecting as client to %s:%d",
            port, host, port,
        )
        return KVControllerClient(host or "127.0.0.1", port)


class ControllerReporter:
    """Engine-side event stream to the controller (daemon thread).

    The engine hot loop calls admit()/evict(); events are queued and a
    background thread ships them over a blocking socket with reconnect +
    re-registration (the controller clears our state when the connection
    drops, so on reconnect we replay a full snapshot via the snapshot_fn).
    """

    def __init__(
        self,
        controller_url: str,
        instance_id: str,
        url: str,
        block_size: int,
        snapshot_fn=None,
        max_queue: int = 65536,
    ):
        host, _, port = controller_url.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.instance_id = instance_id
        self.url = url
        self.block_size = block_size
        self.snapshot_fn = snapshot_fn  # () -> {tier: [hashes]}
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="kv-reporter", daemon=True
        )
        self._thread.start()

    def admit(self, tier: str, hashes: list[int]) -> None:
        self._put({"type": "admit", "instance_id": self.instance_id,
                   "tier": tier, "hashes": hashes})

    def evict(self, tier: str, hashes: list[int]) -> None:
        self._put({"type": "evict", "instance_id": self.instance_id,
                   "tier": tier, "hashes": hashes})

    def _put(self, msg: dict) -> None:
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            pass  # advisory state; router falls back to session routing

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    # -- worker ------------------------------------------------------------
    def _run(self) -> None:
        sock: socket.socket | None = None
        backoff = 0.5
        while not self._stop.is_set():
            if sock is None:
                try:
                    sock = socket.create_connection(
                        (self.host, self.port), timeout=5.0
                    )
                    sock.settimeout(5.0)
                    wire.sync_send(sock, {
                        "type": "register",
                        "instance_id": self.instance_id,
                        "url": self.url,
                        "block_size": self.block_size,
                    })
                    wire.sync_recv(sock)  # ack
                    if self.snapshot_fn is not None:
                        for tier, hashes in self.snapshot_fn().items():
                            if hashes:
                                wire.sync_send(sock, {
                                    "type": "admit",
                                    "instance_id": self.instance_id,
                                    "tier": tier, "hashes": list(hashes),
                                })
                    backoff = 0.5
                except OSError:
                    sock = None
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, 15.0)
                    continue
            try:
                msg = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                wire.sync_send(sock, msg)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                sock = None
                self._put(msg)  # retry after reconnect (snapshot replays anyway)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def main() -> None:  # standalone controller: python -m ...kv.controller
    import argparse

    p = argparse.ArgumentParser(description="Standalone KV controller")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = p.parse_args()

    async def run() -> None:
        c = KVController()
        await c.start(args.host, args.port)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
