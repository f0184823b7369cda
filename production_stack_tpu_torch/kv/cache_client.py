"""The router-side client of the shared KV cache server.

`AsyncCacheClient` is the asyncio client for the cache server's cheap
`lookup` verb (prefix-hit depth, no payload) feeding KV-aware routing:
a cold-on-this-engine prompt whose chain lives in the shared cache is
cheaper to restore anywhere than to recompute, so the router can pick
load-aware instead of sticky. It is the wire part of
``production_stack_tpu/kv/remote.py``'s client, kept apart from the
engine's tier (kv/remote.py imports torch; the router must not).
"""

from __future__ import annotations

from production_stack_tpu_torch.kv import wire

#: default kv.cache_server port (kept in sync with cache_server.py)
DEFAULT_CACHE_PORT = 8100


def parse_cache_addr(url: str) -> tuple[str, int]:
    """'host:port' / 'host' / ':port' -> (host, port)."""
    return wire.parse_addr(url, DEFAULT_CACHE_PORT)


class AsyncCacheClient:
    """Router-side asyncio client for the cache server's payload-free
    verbs (`lookup`, `stats`, `ping`). Lives on the router event loop —
    fully async, one connection with reconnect-on-error, a lock
    serializing request/reply pairs (lookups are tiny; no pipelining
    needed)."""

    #: client-internal fast-fail window after a failed call: requests
    #: already QUEUED on the lock when the server died must not each
    #: pay the full connect/retry timeouts in turn (the caller-side
    #: breaker only stops requests that had not entered the queue yet)
    FAIL_FAST_S = 5.0

    def __init__(self, url: str, timeout: float = 2.0):
        self.host, self.port = parse_cache_addr(url)
        self.timeout = timeout
        self._reader = None
        self._writer = None
        self._fail_until = 0.0  # monotonic
        import asyncio

        self._lock = asyncio.Lock()

    async def _ensure(self) -> None:
        import asyncio

        if self._writer is None or self._writer.is_closing():
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                self.timeout,
            )

    def _drop_connection(self) -> None:
        """Close (not just abandon) the current connection — a timed-
        out request leaves a live transport whose FD would otherwise
        leak once per error in the long-lived router process."""
        if self._writer is not None:
            try:
                self._writer.close()
            # stackcheck: disable=silent-except — closing a transport
            # that already errored/timed out; there is nothing to do
            # with a second failure and the writer is discarded anyway
            except Exception:  # noqa: BLE001
                pass
            self._writer = None

    async def _call(self, msg: dict) -> dict:
        import asyncio
        import time as _time

        async with self._lock:
            if _time.monotonic() < self._fail_until:
                # a call just failed while we queued on the lock: fail
                # fast instead of paying the connect timeouts in turn
                raise OSError("cache server in fail-fast cooldown")
            try:
                try:
                    await self._ensure()
                    await wire.send_msg(self._writer, msg)
                    reply, _ = await asyncio.wait_for(
                        wire.recv_msg(self._reader), self.timeout
                    )
                except (ConnectionError, asyncio.IncompleteReadError,
                        asyncio.TimeoutError, OSError, wire.WireError):
                    # one reconnect attempt, then propagate (callers
                    # degrade); the dead/stale connection is CLOSED
                    # first. WireError (garbage/oversize frame — e.g.
                    # the url points at a non-cache-server) also
                    # desynchronizes the stream: without the drop, the
                    # poisoned connection would be reused forever
                    # across breaker cooldowns.
                    self._drop_connection()
                    await self._ensure()
                    try:
                        await wire.send_msg(self._writer, msg)
                        reply, _ = await asyncio.wait_for(
                            wire.recv_msg(self._reader), self.timeout
                        )
                    except (ConnectionError,
                            asyncio.IncompleteReadError,
                            asyncio.TimeoutError, OSError,
                            wire.WireError):
                        self._drop_connection()
                        raise
            except (ConnectionError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, OSError, wire.WireError):
                self._fail_until = (
                    _time.monotonic() + self.FAIL_FAST_S
                )
                raise
            self._fail_until = 0.0
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "cache server error"))
        return reply

    async def lookup(self, hashes: list[int]) -> int:
        """Prefix-hit depth (blocks) of `hashes` in the shared cache."""
        return int((await self._call(
            {"type": "lookup", "hashes": hashes}
        )).get("depth", 0))

    async def stats(self) -> dict:
        return await self._call({"type": "stats"})

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
