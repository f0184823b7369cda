"""The port's router app against the JAX router's, over HTTP.

Both routers stand in front of the same fake backends (tests/
fake_engine.py): two live engines serving ``fake-model`` and one dead
backend listed for ``dead-model``, with the batch and files APIs, a
tenant budget (admission) and SLO objectives from one JSON dynamic
config. They run in one event loop on a thread (the JAX one on aiohttp,
the port's on utils/web.py) and get the same requests in the same order,
each with a fixed x-request-id, from one aiohttp client: status codes,
bodies (timestamps and generated ids aside), streamed server-sent events
and the deltas of their /metrics (family names, types, label sets,
counter values and histogram counts; timings aside) must be equal.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time

import aiohttp
import pytest
from aiohttp import web as aioweb
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.router import parsers as jax_parsers
from production_stack_tpu.router.app import build_app as jax_build_app
from production_stack_tpu_torch.router import parsers as port_parsers
from production_stack_tpu_torch.router.app import build_app as port_build_app
from production_stack_tpu_torch.utils import prometheus as port_prom
from production_stack_tpu_torch.utils import web as port_web
from tests.fake_engine import FakeEngine

MODEL = "fake-model"
# the series a router exports for an engine only once its stats scraper
# has read that engine's /metrics (gauges, kept from then on)
SCRAPED = ("tpu_router:engine_last_scrape_age_seconds",
           "vllm:num_requests_running", "vllm:num_requests_waiting",
           "vllm:gpu_cache_usage_perc", "vllm:gpu_prefix_cache_hit_rate")
# values that differ between two runs of the same request
VOLATILE = {"created", "created_at", "in_progress_at", "finalizing_at",
            "completed_at", "expires_at", "id", "input_file_id",
            "output_file_id", "error_file_id", "retry_after_s", "first_id",
            "last_id"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _norm(x):
    if isinstance(x, dict):
        return {k: ("<v>" if k in VOLATILE else _norm(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _reset_singletons() -> None:
    import production_stack_tpu.router.routing_logic as j_rl
    import production_stack_tpu.router.service_discovery as j_sd
    import production_stack_tpu.router.stats.health as j_h
    import production_stack_tpu_torch.router.routing_logic as p_rl
    import production_stack_tpu_torch.router.service_discovery as p_sd
    import production_stack_tpu_torch.router.stats.health as p_h

    for rl, sd, h in ((j_rl, j_sd, j_h), (p_rl, p_sd, p_h)):
        rl._reset_routing_logic()
        sd._reset_service_discovery()
        h._reset_engine_health_board()


class Stack:
    """Fake engines and both routers on a loop in a thread."""

    def __init__(self, tmp) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.tmp = tmp
        self.run(self._start())

    def run(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def _argv(self, name: str) -> list[str]:
        return [
            "--service-discovery", "static",
            "--static-backends", ",".join(
                [e.url for e in self.engines] + [self.dead]),
            "--static-models", f"{MODEL},{MODEL},dead-model",
            "--routing-logic", "roundrobin",
            "--engine-stats-interval", "0.2",
            "--enable-batch-api",
            "--file-storage-path", str(self.tmp / name),
            "--dynamic-config-json", str(self.tmp / "dyn.json"),
            "--tracing-exporter", "memory",
        ]

    async def _start(self) -> None:
        (self.tmp / "dyn.json").write_text(json.dumps({
            "admission": {"tenants": {
                "team-a": {"rate": 0.001, "burst": 2.0}}},
            "slo": {"objectives": {
                "strict": {"ttft_p99_s": 1e-9, "availability": 0.999},
                "lenient": {"ttft_p99_s": 30.0}}},
        }))
        self.engines = [FakeEngine(model=MODEL, engine_id=f"fake-{i}")
                        for i in range(2)]
        for e in self.engines:
            await e.start()
        self.dead = f"http://127.0.0.1:{_free_port()}"  # nothing listens
        _reset_singletons()
        jax_app = jax_build_app(jax_parsers.parse_args(self._argv("jax")))
        self.jax_runner = aioweb.AppRunner(jax_app.app)
        await self.jax_runner.setup()
        jport = _free_port()
        await aioweb.TCPSite(self.jax_runner, "127.0.0.1", jport).start()
        port_app = port_build_app(port_parsers.parse_args(
            self._argv("port")))
        self.port_runner = port_web.AppRunner(port_app.app)
        await self.port_runner.setup()
        site = port_web.TCPSite(self.port_runner, "127.0.0.1", 0)
        await site.start()
        self.urls = {"jax": f"http://127.0.0.1:{jport}",
                     "port": f"http://127.0.0.1:{site.port}"}
        self.session = aiohttp.ClientSession()
        self.n = 0

    async def _stop(self) -> None:
        await self.session.close()
        await self.port_runner.cleanup()
        await self.jax_runner.cleanup()
        for e in self.engines:
            await e.stop()

    def close(self) -> None:
        try:
            self.run(self._stop())
        finally:
            _reset_singletons()
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)

    async def _one(self, which: str, method: str, path: str,
                   headers: dict, **kw) -> dict:
        async with self.session.request(
                method, self.urls[which] + path, headers=headers,
                **kw) as r:
            chunks = [c async for c in r.content.iter_any()]
            body = b"".join(chunks)
            return {"status": r.status,
                    "content_type": r.headers.get("Content-Type", ""),
                    "retry_after": r.headers.get("Retry-After"),
                    "request_id": r.headers.get("x-request-id"),
                    "body": body, "chunks": len(chunks)}

    def both(self, method: str, path: str, headers: dict | None = None,
             **kw) -> tuple[dict, dict]:
        """The same request to the JAX router, then to the port's."""
        self.n += 1
        h = {"x-request-id": f"req-{self.n}", **(headers or {})}
        return tuple(self.run(self._one(w, method, path, h, **kw))
                     for w in ("jax", "port"))

    def metrics(self) -> dict[str, str]:
        return {w: self.run(self._one(w, "GET", "/metrics", {}))[
            "body"].decode() for w in ("jax", "port")}

    def scraped_metrics(self, timeout: float = 60.0) -> dict[str, str]:
        """Both routers' /metrics once each has scraped every live
        engine. The scrapers run every 0.2 s with a 0.2 s timeout on the
        loop that serves everything here, so on a loaded host a router
        can go several rounds without a scrape, and its /metrics then
        lacks the SCRAPED series (or holds them while the other's does
        not)."""
        want = {(name, (("server", e.url),))
                for name in SCRAPED for e in self.engines}
        deadline = time.monotonic() + timeout
        while True:
            text = self.metrics()
            missing = {w: want - {key for _, samples in _families(
                t, text_string_to_metric_families).values()
                for key in samples} for w, t in text.items()}
            if not any(missing.values()):
                return text
            assert time.monotonic() < deadline, (
                f"no scrape of every engine in {timeout}s: {missing}")
            time.sleep(0.05)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = Stack(tmp_path_factory.mktemp("router_app"))
    s.metrics_before = s.scraped_metrics()
    yield s
    s.close()


def _json(r: dict):
    return _norm(json.loads(r["body"]))


def _events(r: dict) -> list:
    out = []
    for block in r["body"].decode().split("\n\n"):
        if block.startswith("data: "):
            data = block[6:]
            out.append(data if data == "[DONE]" else _norm(json.loads(data)))
    return out


def _same(a: dict, b: dict, parse=_json) -> None:
    assert a["status"] == b["status"]
    assert a["content_type"] == b["content_type"]
    assert a["request_id"] == b["request_id"]
    assert a["retry_after"] == b["retry_after"]
    assert parse(a) == parse(b)


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 4}),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "hi"}], "max_tokens": 3}),
    ("/tokenize", {"prompt": "tokens please"}),
], ids=["completions", "chat", "tokenize"])
def test_whole_responses_equal(stack, path, body):
    a, b = stack.both("POST", path, json={"model": MODEL, **body})
    assert a["status"] == 200
    _same(a, b)


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 6}),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "hi"}], "max_tokens": 5,
        "stream_options": {"include_usage": True}}),
], ids=["completions", "chat"])
def test_streams_equal(stack, path, body):
    a, b = stack.both("POST", path,
                      json={"model": MODEL, "stream": True, **body})
    assert a["status"] == 200
    assert a["content_type"].startswith("text/event-stream")
    _same(a, b, parse=_events)
    assert _events(b)[-1] == "[DONE]"
    assert b["chunks"] > 1  # relayed as it came, not in one piece


@pytest.mark.parametrize("method,path", [
    ("GET", "/health"), ("GET", "/v1/models"), ("GET", "/nowhere"),
    ("POST", "/health"), ("GET", "/is_sleeping"),
    ("GET", "/debug/requests?limit=0"),
])
def test_service_endpoints_equal(stack, method, path):
    a, b = stack.both(method, path)
    if a["content_type"].startswith("application/json"):
        _same(a, b)
    else:
        _same(a, b, parse=lambda r: r["body"])


@pytest.mark.parametrize("body,status", [
    ({"model": "other-model", "prompt": "x"}, 503),
    ({"model": "dead-model", "prompt": "x"}, 502),
    ({"model": MODEL, "prompt": [1] * 10, "max_tokens": 1}, 200),
], ids=["unknown-model", "no-live-backend", "token-ids"])
def test_errors_equal(stack, body, status):
    a, b = stack.both("POST", "/v1/completions", json=body)
    assert a["status"] == status
    _same(a, b)


def test_invalid_json_equal(stack):
    a, b = stack.both("POST", "/v1/completions", data=b"{not json",
                      headers={"Content-Type": "application/json"})
    assert a["status"] == 400
    _same(a, b)


def test_trace_context_forwarded_as_jax(stack):
    """x-request-id and the client's trace reach the engine from both
    routers, and both record the same spans for the request."""
    trace = "4bf92f3577b34da6a3ce929d0e0e4736"
    seen = []
    for which in ("jax", "port"):
        n_before = sum(len(e.headers_seen) for e in stack.engines)
        r = stack.run(stack._one(which, "POST", "/v1/completions", {
            "x-request-id": f"traced-{which}",
            "traceparent": f"00-{trace}-00f067aa0ba902b7-01"},
            json={"model": MODEL, "prompt": "t", "max_tokens": 2,
                  "stream": True}))
        assert r["status"] == 200
        assert sum(len(e.headers_seen) for e in stack.engines) == (
            n_before + 1)
        h = max((e.headers_seen[-1] for e in stack.engines
                 if e.headers_seen),
                key=lambda h: h.get("x-request-id") == f"traced-{which}")
        seen.append(h)
        assert h["x-request-id"] == f"traced-{which}"
        assert h["traceparent"].split("-")[1] == trace
    spans = []
    for which in ("jax", "port"):
        body = json.loads(stack.run(stack._one(
            which, "GET", "/debug/requests?limit=64", {}))["body"])
        mine = [sp for sp in body["requests"]
                if sp["attributes"].get("request_id") == f"traced-{which}"]
        spans.append(sorted((sp["name"], sp["trace_id"], sp["status"],
                             sorted(sp["attributes"]),
                             [e["name"] for e in sp["events"]])
                            for sp in mine))
    assert spans[0] and spans[1] == spans[0]


def test_admission_refusals_equal(stack):
    got = [stack.both("POST", "/v1/completions",
                      json={"model": MODEL, "prompt": "t", "max_tokens": 1},
                      headers={"x-tenant-id": "team-a"})
           for _ in range(3)]
    assert [a["status"] for a, _ in got] == [200, 200, 429]
    for a, b in got:
        _same(a, b)
    a, b = stack.both("GET", "/debug/admission")
    totals = lambda r: {k: json.loads(r["body"])[k] for k in (
        "admitted_total", "shed_total", "refunded_total")}
    assert totals(a) == totals(b)
    assert sorted(json.loads(a["body"])["tenants"]) == sorted(
        json.loads(b["body"])["tenants"])


def test_slo_counters_equal(stack):
    for tenant in ("strict", "strict", "lenient"):
        a, b = stack.both("POST", "/v1/completions", json={
            "model": MODEL, "prompt": "hello", "max_tokens": 3,
            "stream": True}, headers={"x-tenant-id": tenant})
        _same(a, b, parse=_events)
    a, b = stack.both("GET", "/debug/slo")
    rows = lambda r: {row["tenant"]: row["violations_total"]
                      for row in json.loads(r["body"])["tenants"]}
    assert rows(a) == rows(b)
    assert rows(b)["strict"]["ttft"] == 2 and rows(b)["lenient"] == {}


def test_files_and_batches_equal(stack):
    lines = "\n".join(json.dumps({
        "custom_id": f"c{i}", "method": "POST", "url": "/v1/completions",
        "body": {"model": MODEL, "prompt": f"p{i}", "max_tokens": 2}})
        for i in range(3)).encode()

    def upload():
        form = aiohttp.FormData()
        form.add_field("purpose", "batch")
        form.add_field("file", lines, filename="in.jsonl",
                       content_type="application/jsonl")
        return form

    got = []
    for which in ("jax", "port"):  # a FormData is read once
        got.append(stack.run(stack._one(
            which, "POST", "/v1/files", {"x-request-id": "up"},
            data=upload())))
    a, b = got
    assert a["status"] == 200
    _same(a, b)
    fids = [json.loads(r["body"])["id"] for r in got]
    a, b = stack.both("GET", "/v1/files")
    _same(a, b)
    for path in ("/v1/files/{}", "/v1/files/{}/content"):
        got = [stack.run(stack._one(w, "GET", path.format(f), {}))
               for w, f in zip(("jax", "port"), fids)]
        _same(*got, parse=(_json if "content" not in path
                           else lambda r: r["body"]))
    batches = [json.loads(stack.run(stack._one(
        w, "POST", "/v1/batches", {}, json={
            "input_file_id": f, "endpoint": "/v1/completions"}))["body"])
        for w, f in zip(("jax", "port"), fids)]
    assert _norm(batches[0]) == _norm(batches[1])

    async def done(which: str, bid: str) -> dict:
        for _ in range(100):
            r = await stack._one(which, "GET", f"/v1/batches/{bid}", {})
            info = json.loads(r["body"])
            if info["status"] in ("completed", "failed", "cancelled"):
                return info
            await asyncio.sleep(0.1)
        raise AssertionError(f"batch {bid} never finished")

    infos = [stack.run(done(w, b["id"]), timeout=30)
             for w, b in zip(("jax", "port"), batches)]
    assert infos[0]["status"] == "completed"
    assert _norm(infos[0]) == _norm(infos[1])
    outs = [stack.run(stack._one(
        w, "GET", f"/v1/files/{i['output_file_id']}/content", {}))["body"]
        for w, i in zip(("jax", "port"), infos)]
    rows = [sorted((json.loads(ln) for ln in o.decode().splitlines()),
                   key=lambda d: d["custom_id"]) for o in outs]
    assert _norm(rows[0]) == _norm(rows[1])
    a, b = stack.both("GET", "/v1/batches?limit=5")
    _same(a, b)
    got = [stack.run(stack._one(w, "DELETE", f"/v1/files/{f}", {}))
           for w, f in zip(("jax", "port"), fids)]
    _same(*got)
    a, b = stack.both("GET", "/v1/files/file-none")
    assert a["status"] == 404
    _same(a, b)


def _families(text: str, parse) -> dict:
    out = {}
    for f in parse(text):
        out[f.name] = (f.type, {(s.name, tuple(sorted(s.labels.items()))):
                                s.value for s in f.samples})
    return out


# timing-valued samples: only their names, types and label sets compare
# (a histogram's count compares, its buckets and sum do not)
# (and scraped or instantaneous gauges: what an engine ran at a scrape)
TIMED = ("_seconds", "latency", "ttft", "itl", "relay_tokens", "_usage_",
         "_created", "age", "qps", "avg_", "load_score", "burn_rate",
         "compliance", "budget", "occupancy", "desired_replicas",
         "num_requests_", "gpu_", "num_prefill", "num_decoding",
         "inflight")


def test_metrics_families_equal(stack):
    """Run last in this file: the deltas of both routers' /metrics over
    every request above."""
    after = stack.scraped_metrics()
    assert (_families(after["port"], port_prom.text_string_to_metric_families)
            == _families(after["port"], text_string_to_metric_families))
    delta = {}
    for which in ("jax", "port"):
        before = _families(stack.metrics_before[which],
                           text_string_to_metric_families)
        now = _families(after[which], text_string_to_metric_families)
        rows = {}
        for name, (typ, samples) in now.items():
            old = before.get(name, (typ, {}))[1]
            for (sname, labels), v in samples.items():
                d = v - old.get((sname, labels), 0.0)
                # a backend port differs run to run: key by its role
                labels = tuple((k, _role(stack, val)) for k, val in labels)
                timed = (not sname.endswith("_count")
                         if typ == "histogram"
                         else any(t in sname for t in TIMED))
                rows[(name, typ, sname, labels)] = None if timed else d
        delta[which] = rows
    assert delta["port"].keys() == delta["jax"].keys()
    assert delta["port"] == delta["jax"]
    names = {k[0] for k in delta["port"]}
    assert {"tpu_router:requests", "tpu_router:admission_sheds",
            "tpu_router:slo_violations", "vllm:num_requests_running",
            "tpu_router:request_e2e_seconds"} <= names


def _role(stack, value: str) -> str:
    for i, e in enumerate(stack.engines):
        if value == e.url:
            return f"engine-{i}"
    return "dead" if value == stack.dead else value
