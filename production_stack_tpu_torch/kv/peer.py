"""Inter-engine KV peer tier: the zero-stall consumer side of
disaggregated prefill/decode serving.

Copy of ``production_stack_tpu/kv/peer.py`` on the port's host blocks
(CPU tensors, kv/offload.py). It pulls from a JAX engine's transfer
server or cache server as well as a port one: the frames, the block
bytes and the chain hashes are the same.

A `PeerTier` pulls content-addressed KV block chains over the wire.py
frames from one or more peers — a prefill engine's `KVTransferServer`
or, address-interchangeably, a standalone `kv.cache_server` (both speak
`get_chain`). It replaces the old `KVTransferClient`, whose blocking
`get_chain` ran on the decode engine's SCHEDULER THREAD inside the
admission path (the exact stall the stackcheck hot-path gate forbids).

The tier itself is still a blocking socket client — by design: it is
only ever driven from the `KVOffloadManager` worker thread through the
pending-READ map (`request_chain_reads` -> `_do_chain_read`), so the
engine step loop sees the same contract as every other tier: enqueue
the read at add_request, poll for completion, stage the h2d when the
fetch lands, and fall back to local recompute on chain break or peer
death — never a stall, never a socket on the scheduler thread. The one
sanctioned blocking caller is the `--sync-kv-offload` attribution
control (`LLMEngine._pd_transfer_restore`), which documents itself as
the synchronous path.

Multiple peer addresses are walked in order: the chain hash IS the
address, so asking a peer that does not hold the chain costs one small
round-trip (`n: 0`) and the walk moves on. A router running the `pd`
policy can therefore fan decode engines out over several prefill
engines without per-request rendezvous plumbing.
"""

from __future__ import annotations

import socket
import threading

import torch

from production_stack_tpu_torch.kv import wire
from production_stack_tpu_torch.kv.offload import (
    deserialize_block,
    own_block,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

#: default KVTransferServer port (kept in sync with kv/transfer.py)
DEFAULT_PEER_PORT = 8200


def parse_peer_addrs(spec) -> list[tuple[str, int]]:
    """Accept 'host:port', 'host', ':port', a comma list, or a list of
    such strings -> [(host, port), ...]."""
    if spec is None:
        return []
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",") if p.strip()]
    else:
        parts = [str(p).strip() for p in spec if str(p).strip()]
    return [wire.parse_addr(p, DEFAULT_PEER_PORT) for p in parts]


class _PeerConn:
    """One peer's cached blocking connection (reconnect on next use)."""

    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: socket.socket | None = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
            self._sock.settimeout(self.timeout)
        return self._sock

    def call(self, msg: dict, payload: bytes = b"") -> tuple[dict, bytes]:
        s = self._ensure()
        wire.sync_send(s, msg, payload)
        return wire.sync_recv(s)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class PeerTier:
    """Chain-addressed KV pulls from prefill peers / remote caches.

    Thread-safety: one lock serializes pulls — the tier is driven from
    the single offload worker thread (async mode) or the scheduler
    thread (sync attribution mode), never both at once, but the lock
    keeps a stats() reader or a late close() safe regardless.
    """

    name = "peer"

    def __init__(self, peers, timeout: float = 5.0):
        addrs = parse_peer_addrs(peers)
        if not addrs:
            raise ValueError("PeerTier needs at least one peer address")
        self._conns = [_PeerConn(h, p, timeout) for h, p in addrs]
        self._lock = threading.Lock()
        # lifetime counters (tpu:kv_peer_* — GIL-atomic int adds, read
        # unlocked by the engine's stats snapshot)
        self.pulls = 0           # get_chain round-trips issued
        self.hits = 0            # blocks served by a peer
        self.misses = 0          # blocks requested but not served
        self.read_bytes = 0
        self.fallbacks = 0       # failed pulls (dead peer / bad frame)

    @property
    def peer_addrs(self) -> list[str]:
        return [c.addr for c in self._conns]

    def get_chain(
        self, hashes: list[int]
    ) -> tuple[list[torch.Tensor], str | None]:
        """Longest run of `hashes` any peer holds.

        Returns (per-block wire arrays [(2, L, nkv, bs, d), ...], the
        serving peer's "host:port") — ([], None) when no peer serves
        anything. Peers are walked in order; every failure mode (dead
        peer, mid-frame death, corrupt payload) degrades to the next
        peer and ultimately to local recompute, never an exception."""
        if not hashes:
            return [], None
        with self._lock:
            for conn in self._conns:
                self.pulls += 1
                try:
                    reply, payload = conn.call(
                        {"type": "get_chain", "hashes": hashes}
                    )
                except (OSError, RuntimeError, ValueError) as e:
                    # OSError: network; WireError(RuntimeError): peer
                    # died mid-frame; ValueError: corrupt frame — all
                    # must degrade, never escape into the worker loop
                    conn.close()
                    self.fallbacks += 1
                    logger.warning(
                        "kv peer pull from %s failed: %s", conn.addr, e
                    )
                    continue
                if not reply.get("ok") or not reply.get("n"):
                    continue  # this peer has no run; try the next
                try:
                    data = deserialize_block(payload)
                except ValueError as e:
                    self.fallbacks += 1
                    logger.warning(
                        "kv peer payload from %s corrupt: %s", conn.addr, e
                    )
                    continue
                n = int(data.shape[2])
                # per-block contiguous copies: a view of the batched
                # payload would pin the WHOLE transfer alive for as
                # long as any single block is parked in the
                # pending-read map
                blocks = [own_block(data, i) for i in range(n)]
                self.hits += n
                self.misses += max(0, len(hashes) - n)
                self.read_bytes += sum(int(b.nbytes) for b in blocks)
                return blocks, conn.addr
            self.misses += len(hashes)
            return [], None

    def ping(self) -> bool:
        """True when any peer answers."""
        with self._lock:
            for conn in self._conns:
                try:
                    reply, _ = conn.call({"type": "ping"})
                    if reply.get("ok"):
                        return True
                except (OSError, RuntimeError, ValueError):
                    conn.close()
        return False

    def counters(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "read_bytes": self.read_bytes, "fallbacks": self.fallbacks,
            "pulls": self.pulls,
        }

    def stats(self) -> dict:
        return {"tier": self.name, "peers": self.peer_addrs,
                **self.counters()}

    def close(self) -> None:
        with self._lock:
            for conn in self._conns:
                conn.close()
