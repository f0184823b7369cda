"""The router's standard-library pieces against the packages they stand
in for: utils/prometheus.py against prometheus_client (exposition and
parser), utils/http.py's client and utils/web.py's server against
aiohttp (bodies by Content-Length, chunked encoding and connection close,
server-sent events relayed as they arrive, errors and their texts), and
the router's metric registry against the JAX router's.
"""

from __future__ import annotations

import asyncio
import math
import re

import aiohttp
import prometheus_client as pc
import pytest
from aiohttp import web as aioweb
from prometheus_client.parser import text_string_to_metric_families as pc_parse

from production_stack_tpu_torch.utils import http
from production_stack_tpu_torch.utils import prometheus as pm
from production_stack_tpu_torch.utils import web


def _registry(mod):
    r = mod.CollectorRegistry()
    c = mod.Counter("a:req", "doc \\ with\nnewline", ["server", "outcome"],
                    registry=r)
    g = mod.Gauge("b:g", "gauge", ["server"], registry=r)
    g0 = mod.Gauge("b:g0", "gauge0", registry=r)
    h = mod.Histogram("c:h", "hist", ["server"], registry=r,
                      buckets=(0.001, 0.5, 1.0, 1e7))
    h0 = mod.Histogram("c:h0", "hist0", registry=r)
    mod.Counter("d:empty_total", "no child yet", ["x"], registry=r)
    c.labels(server='http://a"\\b\n', outcome="ok").inc()
    c.labels("s2", "err").inc(2.5)
    g.labels(server="u").set(3)
    g.labels(server="u2").set(1.5e21)
    g.labels(server="u3").set(123456789.0)
    g.labels(server="u4").set(float("nan"))
    g.remove("u2")
    g0.set(-1)
    h.labels(server="x").observe(0.0003)
    h.labels(server="x").observe(2)
    h.labels(server="y").observe(float("inf"))
    h0.observe(0.07)
    return r


def _strip_created(text: str) -> str:
    return re.sub(r"(_created(\{[^}]*\})?) \S+", r"\1 T", text)


def test_exposition_equals_prometheus_client():
    want = pc.generate_latest(_registry(pc)).decode()
    got = pm.generate_latest(_registry(pm)).decode()
    assert _strip_created(got) == _strip_created(want)


@pytest.mark.parametrize("text", [
    "reg", "foo 1\nbar{x=\"1\"} 2 1000\n# TYPE z counter\nz 3\n"
    "# HELP q a\\\\b\n# TYPE q_total counter\nq_total 4\nq_created 5\n"
    "last{a=\"b,c\",d=\"}\"} NaN\n# TYPE s summary\ns_sum 1\ns_count 2\n"
    "s{quantile=\"0.5\"} +Inf\n",
], ids=["registry", "handwritten"])
def test_parser_equals_prometheus_client(text):
    if text == "reg":
        text = pc.generate_latest(_registry(pc)).decode()

    def fams(parse):
        return [(f.name, f.type, f.documentation,
                 [(s.name, s.labels, repr(s.value), s.timestamp)
                  for s in f.samples]) for f in parse(text)]

    assert fams(pm.text_string_to_metric_families) == fams(pc_parse)


def test_router_registry_families_equal_jax():
    """Every family the JAX router registers, with its type and help, in
    the same order."""
    from production_stack_tpu.router.services import metrics_service as jms
    from production_stack_tpu_torch.router.services import (
        metrics_service as pms,
    )

    want = [(m.name, m.type, m.documentation) for m in
            jms.ROUTER_REGISTRY.collect()]
    got = [(m.name, m.type, m.documentation) for m in
           pms.ROUTER_REGISTRY.metrics()]
    assert got == want
    assert len(got) > 40


@pytest.mark.parametrize("value", [0.0, 1.0, -2.5, 1e-7, 0.25, 1234567.0,
                                   12345678.9, 1e21, math.inf, -math.inf])
def test_float_text_equals_prometheus_client(value):
    from prometheus_client.utils import floatToGoString

    assert pm.float_to_go_string(value) == floatToGoString(value)


# -- HTTP: a server on aiohttp, read by the stdlib client ---------------------
async def _aiohttp_server(handlers: dict) -> tuple[aioweb.AppRunner, str]:
    app = aioweb.Application()
    for (method, path), h in handlers.items():
        app.router.add_route(method, path, h)
    runner = aioweb.AppRunner(app)
    await runner.setup()
    site = aioweb.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, f"http://127.0.0.1:{port}"


def test_client_reads_every_body_framing_and_streams():
    gates: list[asyncio.Event] = []

    async def sse(request):
        resp = aioweb.StreamResponse(headers={
            "Content-Type": "text/event-stream"})
        await resp.prepare(request)
        for i in range(3):
            await resp.write(f"data: {i}\n\n".encode())
            await gates[i].wait()
        await resp.write_eof()
        return resp

    async def not_found(request):
        return aioweb.Response(status=404)

    async def echo(request):
        return aioweb.json_response({
            "body": await request.json(), "q": dict(request.query),
            "h": request.headers.get("X-Test")})

    async def close_ended(reader, writer):
        # the port engine's streams: no length, no chunks, ended by close
        await reader.readuntil(b"\r\n\r\n")
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/plain\r\n"
                     b"\r\nline one\nline two\n")
        await writer.drain()
        writer.close()

    async def run():
        runner, url = await _aiohttp_server({
            ("GET", "/sse"): sse, ("POST", "/echo"): echo,
            ("GET", "/404"): not_found})
        raw = await asyncio.start_server(close_ended, "127.0.0.1", 0)
        raw_url = f"http://127.0.0.1:{raw.sockets[0].getsockname()[1]}"
        gates[:] = [asyncio.Event() for _ in range(3)]
        try:
            async with http.ClientSession() as s:
                async with s.post(f"{url}/echo?a=1", json={"x": [1, 2]},
                                  params={"b": "2"},
                                  headers={"X-Test": "t"}) as r:
                    assert r.status == 200
                    assert await r.json() == {
                        "body": {"x": [1, 2]}, "q": {"a": "1", "b": "2"},
                        "h": "t"}
                async with s.get(f"{url}/sse") as r:
                    assert r.headers["transfer-encoding"] == "chunked"
                    seen = []
                    async for chunk in r.content.iter_any():
                        seen.append(chunk)
                        # the next event is written only after this one
                        # was read: a buffering client would hang here
                        gates[len(seen) - 1].set()
                    assert seen == [b"data: 0\n\n", b"data: 1\n\n",
                                    b"data: 2\n\n"]
                async with s.get(f"{raw_url}/close") as r:
                    assert [ln async for ln in r.content] == [
                        b"line one\n", b"line two\n"]
                async with s.get(f"{url}/404") as r:
                    with pytest.raises(http.ClientResponseError):
                        r.raise_for_status()
            gates[:] = [asyncio.Event() for _ in range(3)]
            with pytest.raises(asyncio.TimeoutError):
                async with http.ClientSession(
                        timeout=http.ClientTimeout(total=0.2)) as s:
                    async with s.get(f"{url}/sse") as r:
                        await r.read()
        finally:
            for g in gates:
                g.set()
            raw.close()
            await runner.cleanup()

    asyncio.run(run())


def test_client_connect_error_text_equals_aiohttp():
    async def run():
        texts = []
        for session in (aiohttp.ClientSession(), http.ClientSession()):
            async with session as s:
                try:
                    async with s.get("http://127.0.0.1:1/x"):
                        pass
                except Exception as e:  # noqa: BLE001
                    texts.append((isinstance(e, OSError), str(e)))
        return texts

    jax_text, port_text = asyncio.run(run())
    assert port_text == jax_text


# -- the server: utils/web.py against aiohttp.web, read by aiohttp ------------
def _app(mod):
    app = mod.Application()

    async def item(request):
        return mod.json_response({"id": request.match_info["item_id"],
                                  "q": request.query.get("q")})

    async def upload(request):
        parts = {}
        async for part in await request.multipart():
            parts[part.name] = [part.filename,
                                (await part.read(decode=False)).decode()]
        return mod.json_response(parts)

    async def big(request):
        return mod.Response(body=await request.read())

    async def boom(request):
        raise RuntimeError("handler bug")

    app.router.add_get("/items/{item_id}", item)
    app.router.add_post("/upload", upload)
    app.router.add_post("/big", big)
    app.router.add_get("/boom", boom)
    return app


@pytest.mark.parametrize("method,path,kw", [
    ("GET", "/items/abc?q=1", {}),
    ("HEAD", "/items/abc", {}),
    ("GET", "/missing", {}),
    ("POST", "/items/abc", {}),
    ("POST", "/upload", {"multipart": True}),
    ("POST", "/big", {"data": b"x" * (2**20 + 1)}),
    ("GET", "/boom", {}),
], ids=["route", "head", "404", "405", "multipart", "413", "500"])
def test_server_answers_as_aiohttp(method, path, kw):
    async def serve(mod):
        app = _app(mod)
        runner = mod.AppRunner(app)
        await runner.setup()
        if mod is web:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            return runner, site.port
        site = aioweb.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, site._server.sockets[0].getsockname()[1]

    async def one(mod):
        runner, port = await serve(mod)
        try:
            data = kw.get("data")
            if kw.get("multipart"):
                data = aiohttp.FormData()
                data.add_field("purpose", "batch")
                data.add_field("file", b"a\r\nb\n", filename="in.jsonl")
            async with aiohttp.ClientSession() as s:
                async with s.request(method, f"http://127.0.0.1:{port}"
                                     f"{path}", data=data) as r:
                    return (r.status, r.headers.get("Content-Type"),
                            r.headers.get("Allow"), await r.read())
        finally:
            await runner.cleanup()

    want = asyncio.run(one(aioweb))
    got = asyncio.run(one(web))
    assert got == want
