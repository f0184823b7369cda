"""The port's smallest engine server on the CPU, for the tests that talk
to it over HTTP (no jax here: tests that hold the port to the JAX
package import this beside their own jax imports)."""

from __future__ import annotations

import asyncio
import threading
from contextlib import contextmanager

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import EngineServer

CFG = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=4, num_kv_blocks=256,
           max_num_seqs=4, max_prefill_chunk=32, seed=0)


@contextmanager
def serving(params=None, **overrides):
    """Start an EngineServer of CFG (with `overrides`) on the CPU on an
    event loop of its own thread; yield its port, stop it on exit."""
    server = EngineServer(EngineConfig(**{**CFG, **overrides}, device="cpu"),
                          params=params)
    loop = asyncio.new_event_loop()
    box = []
    ready = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        box.append(loop.run_until_complete(server.start("127.0.0.1", 0)))
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(60)
    try:
        yield box[0]
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
