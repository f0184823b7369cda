"""Disaggregated-prefill KV transfer: the prefill engine serves KV
block chains, decode engines pull them by content hash.

Replaces the reference's NIXL/UCX side channel (reference: helm env
LMCACHE_NIXL_ROLE/PEER/BUFFER + UCX_TLS, deployment-vllm-multi.yaml:273-305;
examples/disaggregated_prefill/pd.yaml) with a TPU-native design: KV blocks
are content-addressed by the same chained block hash the prefix cache and
KV controller use, so the decoder simply asks the prefiller "give me the
longest run of this hash chain" in ONE round-trip, then lands the blocks
through its staged-restore path. No rendezvous or transfer-id plumbing:
the prompt itself is the address. If the prefiller has already evicted
the blocks, the decoder recomputes the prefill locally — graceful
degradation, never a stall.

Copy of ``production_stack_tpu/kv/transfer.py``. The producer side runs
inside the prefill engine's server process and uses the runner's export
primitives end to end: a pull takes the engine step-loop lock ONLY for
the cheap host-map resolve + `pin_for_export` + `stage_export_blocks`
ENQUEUE, then releases it before the blocking d2h materialization runs
on the executor thread. The pull runs on an executor thread, not the
step thread, so the runner enqueues the gather on its named compute
stream (the stream every dispatch runs on) and records an event after
it: a later dispatch that overwrites the slots is ordered behind the
gather and can never reach the snapshot.

Consumer side is `kv.peer.PeerTier`, driven through the offload
manager's pending-READ map — see peer.py for the zero-stall contract.
"""

from __future__ import annotations

import asyncio

from production_stack_tpu_torch.kv import wire
from production_stack_tpu_torch.kv.offload import serialize_block
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

DEFAULT_PORT = 8200


class KVTransferServer:
    """Serves `get_chain` requests from the prefill engine's KV cache."""

    def __init__(self, async_engine):
        # async_engine: engine.async_engine.AsyncLLMEngine — its _lock is
        # the engine state lock (held by the step loop per step and by
        # add_request); we take it only for resolve/pin/enqueue
        self.async_engine = async_engine
        self._server: asyncio.AbstractServer | None = None
        self.chains_served = 0
        self.blocks_served = 0

    # stackcheck: hot-path — runs UNDER the engine step-loop lock (the
    # step thread is excluded while we hold it): cheap host-map walk +
    # pin + gather ENQUEUE only; the blocking d2h materialization
    # happens in _export_chain AFTER the lock is released
    def _snapshot_chain(self, hashes: list[int]):
        """Resolve the longest resident run of `hashes` and enqueue its
        device-side snapshot. Returns (n_blocks, handle) or None.

        Pin + unpin bracket the gather enqueue exactly like
        `LLMEngine._flush_kv_exports`: once the gather is enqueued,
        device-op ordering protects the snapshot, so the pins release
        before the lock does."""
        eng = self.async_engine.engine
        with self.async_engine._lock:
            bm = eng.block_manager
            bids = []
            for h in hashes:
                bid = bm.cached_blocks.get(h)
                if bid is None:
                    break
                bids.append(bid)
            if not bids:
                return None
            bm.pin_for_export(bids)
            try:
                handle = eng.runner.stage_export_blocks(bids)
            finally:
                bm.unpin_exported(bids)
        return len(bids), handle

    def _export_chain(self, hashes: list[int]):
        """Executor-thread body of one pull: snapshot under the lock,
        materialize (blocking d2h) outside it."""
        snap = self._snapshot_chain(hashes)
        if snap is None:
            return None
        n, handle = snap
        # the d2h fetch + wire relayout run WITHOUT the engine lock —
        # the prefill engine keeps stepping while the pull drains
        data = self.async_engine.engine.runner.materialize_export(handle)
        self.chains_served += 1
        self.blocks_served += n
        return data

    async def start(self, host: str = "0.0.0.0",
                    port: int = DEFAULT_PORT) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)
        logger.info("kv-transfer server (prefill role) on %s:%d", host, port)

    @property
    def port(self) -> int | None:
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    msg, _ = await wire.recv_msg(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if msg.get("type") == "get_chain":
                    data = await asyncio.get_running_loop().run_in_executor(
                        None, self._export_chain, msg["hashes"]
                    )
                    if data is None:
                        await wire.send_msg(writer, {"ok": True, "n": 0})
                    else:
                        await wire.send_msg(
                            writer, {"ok": True, "n": int(data.shape[2])},
                            serialize_block(data),
                        )
                elif msg.get("type") == "ping":
                    await wire.send_msg(writer, {"ok": True})
                else:
                    await wire.send_msg(
                        writer,
                        {"ok": False, "error": f"unknown {msg.get('type')!r}"},
                    )
        finally:
            writer.close()
