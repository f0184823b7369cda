"""Connection reuse in the port's HTTP: the servers keep connections
alive as aiohttp's server does, and ``utils/http.ClientSession`` pools
them as aiohttp's ``TCPConnector(limit=0)`` does.

- Through one pooled client connection a sequence of requests (whole
  bodies, a server-sent event stream, a 404) gets from the port's
  router what the JAX router (aiohttp) answers, and the port's router
  serves them all on that one connection.
- A pooled session opens one socket for N sequential requests (the
  accepts of a utils/web.py server and of the port's engine server).
- A streamed body arrives piece by piece and ends with chunked
  encoding's last chunk, the connection open for the next request.
- A connection the server closed while it sat idle is retried once on a
  fresh one; a cut stream, an error or a body left unread closes the
  connection; ``Connection: close``, HTTP/1.0 and the idle timeout
  close it on the server's side.
"""

from __future__ import annotations

import asyncio
import json
import time

import pytest

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.utils import http, web
from tests.test_torch_router_app import MODEL, Stack, _events, _json


# -- a utils/web.py server ---------------------------------------------------
def _app() -> web.Application:
    """Whole bodies, a stream written piece by piece with pauses, a
    stream cut by force_close, and a 500."""
    app = web.Application()

    async def whole(request):
        return web.json_response({"n": int(request.query.get("n", "0"))})

    async def stream(request):
        resp = web.StreamResponse(headers={"Content-Type": "text/plain"})
        await resp.prepare(request)
        for i in range(3):
            await resp.write(f"piece {i};".encode())
            await asyncio.sleep(0.05)
        await resp.write_eof()
        return resp

    async def cut(request):
        resp = web.StreamResponse()
        await resp.prepare(request)
        await resp.write(b"half")
        resp.force_close()
        return resp

    async def boom(request):
        raise RuntimeError("boom")

    app.router.add_get("/whole", whole)
    app.router.add_get("/stream", stream)
    app.router.add_get("/cut", cut)
    app.router.add_get("/boom", boom)
    return app


async def _serve(app: web.Application):
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site.port}"


def test_one_socket_for_sequential_requests():
    """N requests through one pooled session: one accept, N answers."""

    async def main():
        app = _app()
        runner, url = await _serve(app)
        try:
            async with http.ClientSession() as s:
                for n in range(6):
                    async with s.get(f"{url}/whole", params={"n": n}) as r:
                        assert (await r.json()) == {"n": n}
                    assert "Connection" not in r.headers
                assert s.connections_opened == 1
        finally:
            await runner.cleanup()
        assert app.connections_accepted == 1

    asyncio.run(main())


def test_stream_arrives_piece_by_piece_and_keeps_the_connection():

    async def main():
        app = _app()
        runner, url = await _serve(app)
        try:
            async with http.ClientSession() as s:
                async with s.get(f"{url}/stream") as r:
                    assert r.headers["Transfer-Encoding"] == "chunked"
                    t0 = time.monotonic()
                    pieces = [(time.monotonic() - t0, p)
                              async for p in r.content.iter_any()]
                assert [p for _, p in pieces] == [
                    b"piece 0;", b"piece 1;", b"piece 2;"]
                # the first piece came before the handler's pauses ended
                assert pieces[0][0] < pieces[-1][0] - 0.05
                async with s.get(f"{url}/whole", params={"n": 1}) as r:
                    assert (await r.json()) == {"n": 1}
                assert s.connections_opened == 1
        finally:
            await runner.cleanup()
        assert app.connections_accepted == 1

    asyncio.run(main())


def test_cut_stream_error_and_unread_body_close_the_connection():
    """force_close cuts the stream (the client sees the payload break),
    and such a connection, like one whose body was left unread, is not
    pooled; a 500 is a whole response, so its connection is."""

    async def main():
        app = _app()
        runner, url = await _serve(app)
        try:
            async with http.ClientSession() as s:
                with pytest.raises(http.ClientPayloadError):
                    async with s.get(f"{url}/cut") as r:
                        await r.read()
                async with s.get(f"{url}/stream") as r:
                    assert (await r.content.readany()) == b"piece 0;"
                assert s.connections_opened == 2
                async with s.get(f"{url}/boom") as r:
                    assert r.status == 500
                    await r.read()
                async with s.get(f"{url}/whole") as r:
                    await r.read()
                assert s.connections_opened == 3
        finally:
            await runner.cleanup()

    asyncio.run(main())


def test_a_connection_closed_while_idle_is_retried_once():
    """A server that closes a connection when its second request comes
    (as one does whose idle timeout meets the request): the pooled
    connection's request fails before any byte of a response and goes
    once more on a fresh connection. When the fresh one fails too, or a
    fresh connection fails first, the error is raised."""

    async def main():
        accepts = []
        answer_fresh = [True]

        async def handle(reader, writer):
            accepts.append(1)
            try:
                await http.read_request(reader)
                if answer_fresh[0]:
                    writer.write(http.head(200, "text/plain", 2) + b"ok")
                    await writer.drain()
                    await http.read_request(reader)
            except asyncio.IncompleteReadError:
                pass
            finally:
                writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
        try:
            async with http.ClientSession() as s:
                for _ in range(3):
                    async with s.get(url) as r:
                        assert (await r.read()) == b"ok"
                assert len(accepts) == s.connections_opened == 3
                answer_fresh[0] = False
                with pytest.raises(http.ServerDisconnectedError):
                    async with s.get(url):
                        pass
                assert len(accepts) == 4  # the pooled one, once more
                with pytest.raises(http.ServerDisconnectedError):
                    async with s.get(url):
                        pass
                assert len(accepts) == 5  # a fresh one: no retry
        finally:
            server.close()
            await server.wait_closed()

    asyncio.run(main())


async def _raw(port: int, data: bytes) -> tuple[bytes, bool]:
    """Send `data` on a fresh socket -> (what came back within 1 s,
    whether the server closed the connection)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    got = b""
    closed = False
    while True:
        try:
            chunk = await asyncio.wait_for(reader.read(65536), 1.0)
        except asyncio.TimeoutError:
            break
        if not chunk:
            closed = True
            break
        got += chunk
    writer.close()
    return got, closed


def test_server_closes_on_request_http10_and_idle(monkeypatch):
    """Two pipelined requests on one socket get two responses and the
    connection stays; `Connection: close` and HTTP/1.0 get
    `Connection: close` and a closed connection; an idle connection
    closes after the keep-alive timeout."""
    monkeypatch.setattr(web, "KEEPALIVE_TIMEOUT_S", 0.3)

    async def main():
        app = _app()
        runner, url = await _serve(app)
        port = int(url.rsplit(":", 1)[1])
        try:
            req = b"GET /whole?n=%d HTTP/1.1\r\nHost: x\r\n\r\n"
            got, closed = await _raw(port, req % 1 + req % 2)
            assert got.count(b"HTTP/1.1 200 OK") == 2
            assert b'{"n": 2}' in got and b"Connection: close" not in got
            # the idle timeout closed it (within the 1 s read window)
            assert closed
            got, closed = await _raw(
                port, b"GET /whole HTTP/1.1\r\nHost: x\r\n"
                      b"Connection: close\r\n\r\n")
            assert b"Connection: close" in got and closed
            got, closed = await _raw(port, b"GET /whole HTTP/1.0\r\n\r\n")
            assert b"Connection: close" in got and closed
        finally:
            await runner.cleanup()

    asyncio.run(main())


# -- the routers -------------------------------------------------------------------
@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = Stack(tmp_path_factory.mktemp("keepalive"))
    yield s
    s.close()


REQUESTS = [
    ("GET", "/v1/models", None),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": "hello",
                                 "max_tokens": 4}),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": "stream me",
                                 "max_tokens": 5, "stream": True}),
    ("POST", "/v1/chat/completions", {"model": MODEL, "max_tokens": 3,
                                      "messages": [{"role": "user",
                                                    "content": "hi"}]}),
    ("GET", "/no/such/path", None),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": "again",
                                 "max_tokens": 2, "stream": True}),
]


async def _sequence(base: str, tag: str) -> tuple[list, int]:
    """REQUESTS through one pooled session -> (status, normalized body)
    each, and the sockets the session opened."""
    out = []
    async with http.ClientSession() as s:
        for i, (method, path, body) in enumerate(REQUESTS):
            kw = {"json": body} if body is not None else {}
            async with s.request(method, base + path, headers={
                    "x-request-id": f"{tag}-{i}"}, **kw) as r:
                raw = {"body": await r.read()}
            parse = (_events if body and body.get("stream")
                     else _json if r.status == 200 else
                     lambda x: x["body"])
            out.append((r.status, parse(raw)))
        return out, s.connections_opened


def test_requests_over_one_connection_equal_jax_router(stack):
    """The same requests, each through one client connection to the JAX
    router and to the port's: the same answers; the port's router saw
    one connection and reached the engines over pooled ones."""
    jax, jax_conns = stack.run(_sequence(stack.urls["jax"], "ka"))
    port, port_conns = stack.run(_sequence(stack.urls["port"], "ka"))
    assert jax_conns == port_conns == 1
    assert [s for s, _ in port] == [s for s, _ in jax] == [
        200, 200, 200, 200, 404, 200]
    for (_, a), (_, b) in zip(jax, port):
        assert a == b
    app = stack.port_runner.app
    before = app.connections_accepted
    stack.run(_sequence(stack.urls["port"], "ka2"))
    assert app.connections_accepted == before + 1


# -- the engine server -------------------------------------------------------------
def test_engine_server_serves_a_pooled_session_on_one_connection():
    """A CPU engine server: whole and streamed completions through one
    pooled session take one accept; the stream is chunked and ends with
    its last chunk; /debug/connections counts it."""

    async def main():
        server = EngineServer(EngineConfig(
            model="pst-tiny-debug", tokenizer="byte", device="cpu",
            dtype="float32", cache_dtype="float32", block_size=8,
            num_kv_blocks=64, max_num_seqs=2, max_model_len=64, seed=0))
        port = await server.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        try:
            async with http.ClientSession() as s:
                body = {"prompt": [5, 6, 7], "max_tokens": 4,
                        "temperature": 0, "ignore_eos": True}
                async with s.post(f"{base}/v1/completions", json=body) as r:
                    whole = (await r.json())["choices"][0]["text"]
                async with s.post(f"{base}/v1/completions",
                                  json={**body, "stream": True}) as r:
                    assert r.headers["Transfer-Encoding"] == "chunked"
                    events = [line async for line in r.content
                              if line.startswith(b"data: ")]
                assert events[-1] == b"data: [DONE]\n"
                text = "".join(json.loads(e[6:])["choices"][0]["text"]
                               for e in events[:-1])
                assert text == whole
                async with s.get(f"{base}/debug/connections") as r:
                    counts = await r.json()
                assert s.connections_opened == 1
            assert counts == {"accepted": 1, "requests": 2}
        finally:
            await server.drain(5)
            await server.stop()

    asyncio.run(main())
