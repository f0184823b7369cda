"""The port's whole stack on the CPU: its router in front of port engines.

Four port EngineServers of ``pst-tiny-debug`` (float32, random weights
from one seed, so every engine computes the same tokens): two both-role
engines behind the port's router under ``session`` routing, then a
prefill-role and a decode-role engine (the decode one pulling the
prefill one's KV chains) behind it under ``pd`` routing. Every greedy
stream through the router, completions and chat, equals the same
request sent straight to an engine; one session's requests land on one
engine; the PD request prefills on the prefill engine and decodes on the
decode engine after one chain pull.
"""

from __future__ import annotations

import asyncio
import json

import aiohttp
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.router import parsers
from production_stack_tpu_torch.router import routing_logic as rl
from production_stack_tpu_torch.router import service_discovery as sd
from production_stack_tpu_torch.router.app import build_app
from production_stack_tpu_torch.router.stats import health
from production_stack_tpu_torch.utils import web

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

BASE = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
            cache_dtype="float32", seed=0, block_size=4, num_kv_blocks=128,
            max_num_seqs=4, max_prefill_chunk=32, device="cpu")
PROMPTS = [f"request {i}: a prompt that spans a few kv blocks of four"
           for i in range(4)]


def _reset() -> None:
    rl._reset_routing_logic()
    sd._reset_service_discovery()
    health._reset_engine_health_board()


async def _stream(session, url: str, prompt: str, chat: bool,
                  headers=None) -> tuple[int, str, int]:
    """(status, text, events) of one greedy streamed request."""
    body = {"model": "pst-tiny-debug", "max_tokens": 6, "temperature": 0.0,
            "stream": True}
    if chat:
        path = "/v1/chat/completions"
        body["messages"] = [{"role": "user", "content": prompt}]
    else:
        path = "/v1/completions"
        body["prompt"] = prompt
    async with session.post(url + path, json=body,
                            headers=headers or {}) as r:
        raw = await r.read()
    text, n = "", 0
    for block in raw.decode().split("\n\n"):
        if not block.startswith("data: ") or block == "data: [DONE]":
            continue
        ch = json.loads(block[6:])["choices"][0]
        text += ch.get("text") or ch.get("delta", {}).get("content") or ""
        n += 1
    return r.status, text, n


async def _router(argv: list[str]):
    _reset()
    app = build_app(parsers.parse_args([
        "--service-discovery", "static", "--engine-stats-interval", "30",
        "--kv-controller-url", "", *argv]))
    runner = web.AppRunner(app.app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site.port}"


def test_router_streams_equal_direct_under_session_and_pd():
    async def run():
        servers: list[EngineServer] = []

        async def serve(**kw) -> str:
            srv = EngineServer(EngineConfig(**BASE, **kw))
            servers.append(srv)
            return f"http://127.0.0.1:{await srv.start('127.0.0.1', 0)}"

        try:
            a_url, b_url = await serve(), await serve()
            async with aiohttp.ClientSession() as s:
                want = [await _stream(s, a_url, p, i % 2 == 1)
                        for i, p in enumerate(PROMPTS)]
                assert all(st == 200 and n > 1 for st, _, n in want)

                runner, url = await _router([
                    "--static-backends", f"{a_url},{b_url}",
                    "--static-models", "pst-tiny-debug,pst-tiny-debug",
                    "--routing-logic", "session",
                    "--session-key", "x-user-id"])
                before = [srv.engine.engine._finished_total
                          for srv in servers]
                try:
                    got = [await _stream(s, url, p, i % 2 == 1,
                                         {"x-user-id": "alice"})
                           for i, p in enumerate(PROMPTS)]
                finally:
                    await runner.cleanup()
                assert got == want
                served = [srv.engine.engine._finished_total - n
                          for srv, n in zip(servers, before)]
                assert sorted(served) == [0, len(PROMPTS)]

                pf_url = await serve(
                    kv_role="prefill",
                    kv_transfer_config={"listen": "127.0.0.1:0"})
                kv_port = servers[-1]._kv_transfer_server.port
                dc_url = await serve(kv_role="decode", kv_transfer_config={
                    "peer": f"127.0.0.1:{kv_port}"})
                prompt = PROMPTS[0] * 3
                want = await _stream(s, a_url, prompt, False)
                runner, url = await _router([
                    "--static-backends", f"{pf_url},{dc_url}",
                    "--static-models", "pst-tiny-debug,pst-tiny-debug",
                    "--routing-logic", "pd"])
                try:
                    got = await _stream(s, url, prompt, False)
                finally:
                    await runner.cleanup()
                assert got == want
                pf, dc = (srv.engine.engine for srv in servers[2:])
                assert pf._finished_total == 1 and dc._finished_total == 1
                n_full = len(dc.tokenizer.encode(prompt)) // 4
                assert dc.kv_peer.hits == n_full
                assert dc.kv_peer.fallbacks == 0
        finally:
            for srv in reversed(servers):  # decode before its prefill peer
                await srv.stop()
            _reset()

    asyncio.run(run())


def test_dead_backend_is_dropped_by_its_failure_streak():
    """The JAX router's dead-backend scenario
    (tests/test_router_loadbench.py) on the port's router, without a
    timing gate: one live engine and one listed-but-dead backend under
    the health-aware `latency` policy, requests one at a time. Every
    client request succeeds (the proxy's connect retry covers a dead
    pick), and the dead backend is tried at most as often as the health
    board's failure streak allows (3) before it is never picked again."""
    import random
    import socket

    from tests.fake_engine import FakeEngine

    random.seed(0)  # the picks among unmeasured ties
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"

    async def run():
        live = FakeEngine(model="fake-model")
        await live.start()
        runner, url = await _router([
            "--static-backends", f"{live.url},{dead}",
            "--static-models", "fake-model,fake-model",
            "--routing-logic", "latency"])
        try:
            async with aiohttp.ClientSession() as s:
                statuses = []
                for _ in range(24):
                    async with s.post(f"{url}/v1/completions", json={
                            "model": "fake-model", "prompt": "x",
                            "max_tokens": 1}) as r:
                        statuses.append(r.status)
                async with s.get(f"{url}/debug/engines") as r:
                    rows = {e["url"]: e for e in (await r.json())["engines"]}
        finally:
            await runner.cleanup()
            await live.stop()
            _reset()
        assert statuses == [200] * 24
        assert len(live.requests_seen) == 24
        assert 1 <= rows[dead]["errors_total"] <= 3
        assert rows[dead]["healthy"] is (rows[dead]["errors_total"] < 3)
        assert rows[live.url]["errors_total"] == 0

    asyncio.run(run())
