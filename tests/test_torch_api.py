"""The port's OpenAI request surface against the JAX server, on the CPU.

A port EngineServer and a JAX EngineServer (aiohttp) serve the same
numpy weights (pst-tiny-ctx1k-debug, byte tokenizer, float32) on
loopback and take the same requests; their responses are compared with
the ids and timestamps left out.

- Tool calling: parse_tool_calls / inject_tools equal the JAX module's
  on the texts of tests/test_tools.py; a chat with `tools` and a named
  `tool_choice` (the call forced by a guided_regex, since random weights
  never write one) returns the OpenAI tool_calls shape; `auto` without
  --enable-auto-tool-choice is a 400.
- n = 3 and best_of, batched prompts of strings and of token lists
  (choice index = prompt * n + sample), echo.
- /tokenize, /detokenize, /version; /sleep -> /is_sleeping -> /wake_up
  around a request in flight, which waits the sleep out.
- The request timeline: /debug/requests, the ordered event kinds of each
  request equal a JAX engine's (times left out), the traceparent header
  carried into the timeline, and the kv_restore event of a host-tier
  restore.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web

from production_stack_tpu.engine import tools as jtools
from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.engine.server import EngineServer as JServer
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine import tools
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

MODEL = "pst-tiny-ctx1k-debug"
CFG = dict(model=MODEL, tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=4, num_kv_blocks=512,
           max_num_seqs=4, max_prefill_chunk=32, seed=0)
WEATHER = {
    "type": "function",
    "function": {
        "name": "get_weather",
        "description": "Get current weather",
        "parameters": {
            "type": "object",
            "properties": {"city": {"type": "string"}},
            "required": ["city"],
        },
    },
}
TIME_TOOL = {
    "type": "function",
    "function": {"name": "get_time", "parameters": {"type": "object"}},
}
NAMED = {"type": "function", "function": {"name": "get_weather"}}
TOOL_RE = (r'<tool_call>\{"name": "get_weather", "arguments": '
           r'\{"city": "(Oslo|Paris)"\}\}</tool_call>')
GREEDY = dict(max_tokens=6, temperature=0, ignore_eos=True)
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


@pytest.fixture(scope="module")
def np_params():
    params = jllama.init_params(get_model_config(MODEL), jax.random.key(0),
                                jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def servers(np_params):
    """{"port": port, "jax": port, "port_srv": EngineServer} on one
    event loop in a thread."""
    port_srv = EngineServer(EngineConfig(**CFG, device="cpu"),
                            params=params_from_numpy(np_params, "cpu"))
    jax_srv = JServer(JConfig(**CFG, attention_impl="xla"),
                      params=jax.tree_util.tree_map(jnp.asarray, np_params))
    loop = asyncio.new_event_loop()
    box, ready = {}, threading.Event()

    async def start():
        box["port"] = await port_srv.start("127.0.0.1", 0)
        runner = web.AppRunner(jax_srv.app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        box["runner"] = runner
        box["jax"] = site._server.sockets[0].getsockname()[1]

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(start())
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(120)
    yield {"port": box["port"], "jax": box["jax"], "port_srv": port_srv}
    asyncio.run_coroutine_threadsafe(port_srv.stop(), loop).result(30)
    asyncio.run_coroutine_threadsafe(box["runner"].cleanup(),
                                     loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    th.join(30)


def call(port, path, body=None, method=None, headers=None):
    """(status, response headers, parsed JSON body or the raw text)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method=method or ("GET" if body is None else "POST"),
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, hdrs, text = r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        status, hdrs, text = e.code, e.headers, e.read().decode()
    try:
        return status, hdrs, json.loads(text)
    except json.JSONDecodeError:
        return status, hdrs, text


def both(servers, path, body=None, method=None, headers=None):
    """The same request to the port and to the JAX server."""
    return [call(servers[k], path, body, method, headers)
            for k in ("port", "jax")]


def _strip(resp: dict) -> dict:
    """A response without its ids and timestamps."""
    out = {k: v for k, v in resp.items() if k not in ("id", "created")}
    for c in out.get("choices", []):
        for call_ in (c.get("message") or {}).get("tool_calls") or []:
            call_.pop("id", None)
    return out


# -- tools ---------------------------------------------------------------------
TOOL_TEXTS = [
    'I will check.\n<tool_call>{"name": "get_weather", '
    '"arguments": {"city": "Paris"}}</tool_call>',
    '<tool_call>{"name": "a", "arguments": {}}</tool_call>'
    '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>',
    '{"name": "get_time", "arguments": {}}',
    "just an answer",
    "<tool_call>{not json}</tool_call>trailing",
]


@pytest.mark.parametrize("text", TOOL_TEXTS)
def test_parse_tool_calls_equals_jax(text):
    got, want = tools.parse_tool_calls(text), jtools.parse_tool_calls(text)
    assert got[0] == want[0]
    assert ([{k: v for k, v in c.items() if k != "id"} for c in got[1]]
            == [{k: v for k, v in c.items() if k != "id"} for c in want[1]])
    assert all(c["id"].startswith("call_") for c in got[1])


INJECT_CASES = [
    ([{"role": "system", "content": "Be helpful."},
      {"role": "user", "content": "weather?"}], [WEATHER], "auto"),
    ([{"role": "user", "content": "hi"}], [WEATHER, TIME_TOOL],
     {"type": "function", "function": {"name": "get_time"}}),
    ([{"role": "user", "content": "weather?"},
      {"role": "assistant", "content": None, "tool_calls": [
          {"id": "call_1", "type": "function",
           "function": {"name": "get_weather",
                        "arguments": '{"city": "Paris"}'}}]},
      {"role": "tool", "tool_call_id": "call_1", "content": '{"temp": 21}'}],
     [WEATHER], "auto"),
]


@pytest.mark.parametrize("case", range(len(INJECT_CASES)))
def test_inject_tools_equals_jax(case):
    msgs, tls, choice = INJECT_CASES[case]
    assert (tools.inject_tools(msgs, tls, choice)
            == jtools.inject_tools(msgs, tls, choice))
    with pytest.raises(ValueError, match="unknown tool"):
        tools.inject_tools(msgs, tls, {"type": "function",
                                       "function": {"name": "nope"}})


def test_chat_named_tool_choice_equals_jax(servers):
    body = {"messages": [{"role": "user", "content": "weather in oslo?"}],
            "tools": [WEATHER], "tool_choice": NAMED, "max_tokens": 80,
            "temperature": 0, "guided_regex": TOOL_RE}
    (ps, _, got), (js, _, want) = both(servers, "/v1/chat/completions",
                                       body)
    assert ps == js == 200, got
    choice = got["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    assert choice["message"]["content"] is None
    (call_,) = choice["message"]["tool_calls"]
    assert call_["id"].startswith("call_") and call_["type"] == "function"
    assert call_["function"]["name"] == "get_weather"
    assert json.loads(call_["function"]["arguments"])["city"] in (
        "Oslo", "Paris")
    assert _strip(got) == _strip(want)


def test_auto_tool_choice_needs_the_flag(servers):
    body = {"messages": [{"role": "user", "content": "hi"}],
            "tools": [WEATHER]}
    (ps, _, got), (js, _, want) = both(servers, "/v1/chat/completions",
                                       body)
    assert ps == js == 400
    assert got["error"]["message"] == want["error"]["message"]
    assert "enable-auto-tool-choice" in got["error"]["message"]


# -- n, best_of, batched prompts, echo -----------------------------------------
@pytest.mark.parametrize("path,extra", [
    ("/v1/completions", {"prompt": "hello there"}),
    ("/v1/completions", {"prompt": "hello there", "best_of": 3}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}]}),
])
def test_n3_equals_jax(servers, path, extra):
    body = {**extra, "n": 3, **GREEDY}
    (ps, hdr, got), (js, _, want) = both(servers, path, body)
    assert ps == js == 200, got
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    key = "text" if "prompt" in extra else "message"
    assert len({json.dumps(c[key]) for c in got["choices"]}) == 1  # greedy
    assert _strip(got) == _strip(want)
    assert hdr["x-request-id"] == got["id"]


def test_best_of_other_than_n_is_refused(servers):
    body = {"prompt": "x", "n": 2, "best_of": 3, **GREEDY}
    (ps, _, got), (js, _, want) = both(servers, "/v1/completions", body)
    assert ps == js == 400
    assert got["error"]["message"] == want["error"]["message"]


@pytest.mark.parametrize("prompt", [
    ["one", "two words", "three", "four!"],
    [[5, 6, 7], [8, 9], [10, 11, 12, 13], [14]],
])
def test_batched_prompts_equal_jax(servers, prompt):
    body = {"prompt": prompt, "n": 2, **GREEDY, "temperature": 0.8,
            "seed": 3}
    (ps, _, got), (js, _, want) = both(servers, "/v1/completions",
                                       {**body, "temperature": 0})
    assert ps == js == 200, got
    assert [c["index"] for c in got["choices"]] == list(range(8))
    assert _strip(got) == _strip(want)
    # sampled with a seed: sample j gets seed + j, so a prompt's two
    # choices differ but a repeat reproduces them
    first = call(servers["port"], "/v1/completions", body)[2]
    again = call(servers["port"], "/v1/completions", body)[2]
    assert [c["text"] for c in first["choices"]] == [
        c["text"] for c in again["choices"]]


@pytest.mark.parametrize("stream", [False, True])
def test_echo_equals_jax(servers, stream):
    body = {"prompt": "echo me", "echo": True, "stream": stream, **GREEDY}
    (ps, _, got), (js, _, want) = both(servers, "/v1/completions", body)
    assert ps == js == 200
    if stream:
        def text(sse):
            return "".join(
                json.loads(line[6:])["choices"][0]["text"]
                for line in sse.splitlines()
                if line.startswith("data: {"))
        assert text(got) == text(want) and text(got).startswith("echo me")
    else:
        assert got["choices"][0]["text"].startswith("echo me")
        assert _strip(got) == _strip(want)


# -- utility endpoints ---------------------------------------------------------
@pytest.mark.parametrize("body", [
    {"prompt": "Hello, world"},
    {"messages": [{"role": "user", "content": "hi"}]},
])
def test_tokenize_detokenize_round_trip_equals_jax(servers, body):
    (ps, _, got), (js, _, want) = both(servers, "/tokenize", body)
    assert ps == js == 200 and got == want
    (ps, _, text), (js, _, jtext) = both(servers, "/detokenize",
                                         {"tokens": got["tokens"]})
    assert ps == js == 200 and text == jtext
    if "prompt" in body:
        assert text["prompt"] == body["prompt"]


def test_version(servers):
    (ps, _, got), (js, _, want) = both(servers, "/version")
    assert ps == js == 200 and got == want == {"version": "0.1.0"}


def test_sleep_wake_around_a_request_in_flight(servers):
    """A request in flight when /sleep lands makes no progress while the
    engine sleeps and finishes after /wake_up; new requests get 503
    meanwhile. The endpoints answer as the JAX server's do."""
    port, eng = servers["port"], servers["port_srv"].engine.engine
    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "r", call(port, "/v1/completions", {
            "prompt": "sleepy", "max_tokens": 400, "temperature": 0,
            "ignore_eos": True})))
    th.start()
    deadline = time.time() + 30
    while not eng._seqs and time.time() < deadline:
        time.sleep(0.005)
    (seq,) = eng._seqs.values()
    (ps, _, got), (js, _, want) = both(servers, "/sleep", method="POST")
    assert ps == js == 200 and got == want
    (ps, _, got), (js, _, want) = both(servers, "/is_sleeping")
    assert got == want == {"is_sleeping": True}
    time.sleep(0.1)  # a step already under way ends
    n = len(seq.generated_token_ids)
    time.sleep(0.3)
    assert len(seq.generated_token_ids) == n < 400
    st, _, err = call(port, "/v1/completions", {"prompt": "x", **GREEDY})
    assert st == 503 and err["error"]["code"] == 503
    (ps, _, got), (js, _, want) = both(servers, "/wake_up", method="POST")
    assert ps == js == 200 and got == want
    th.join(120)
    status, _, resp = box["r"]
    assert status == 200 and resp["usage"]["completion_tokens"] == 400
    assert both(servers, "/is_sleeping")[0][2] == {"is_sleeping": False}


# -- request timeline ----------------------------------------------------------
def _kinds(tl: dict) -> list[str]:
    return [e["name"] for e in tl["events"]]


def test_debug_requests_equal_jax(servers):
    """Requests with the same x-request-id on both servers: each one's
    ordered event kinds equal the JAX engine's, the id is echoed, the
    traceparent lands in the timeline, and every timeline ends in
    finish."""
    rng = np.random.RandomState(2)
    reqs = [("tl-short", rng.randint(1, 250, size=9).tolist(), 4),
            ("tl-chunked", rng.randint(1, 250, size=70).tolist(), 20)]
    for rid, prompt, n in reqs:
        for k in ("port", "jax"):
            st, hdr, _ = call(servers[k], "/v1/completions", {
                "prompt": prompt, "max_tokens": n, "temperature": 0,
                "ignore_eos": True}, headers={
                    "x-request-id": rid, "traceparent": TRACEPARENT})
            assert st == 200 and hdr["x-request-id"] == rid
    (ps, _, got), (js, _, want) = both(servers, "/debug/requests?limit=64")
    assert ps == js == 200 and got["enabled"] and want["enabled"]
    g = {t["request_id"]: t for t in got["requests"]}
    w = {t["request_id"]: t for t in want["requests"]}
    for rid, _, _ in reqs:
        assert _kinds(g[rid]) == _kinds(w[rid])
        assert _kinds(g[rid])[0] == "enqueue"
        assert _kinds(g[rid])[-1] == "finish"
        assert g[rid]["trace_id"] == TRACEPARENT.split("-")[1]
        assert g[rid]["parent_span_id"] == TRACEPARENT.split("-")[2]
        chunks = [e["attributes"] for e in g[rid]["events"]
                  if e["name"] == "prefill_chunk"]
        jchunks = [e["attributes"] for e in w[rid]["events"]
                   if e["name"] == "prefill_chunk"]
        keys = ("chunk_start", "chunk_len", "last", "staged_hit",
                "chained", "group_size")
        assert ([{k: c[k] for k in keys} for c in chunks]
                == [{k: c[k] for k in keys} for c in jchunks])
    st, _, one = call(servers["port"], "/debug/requests?limit=1")
    assert st == 200 and len(one["requests"]) >= 1


def _engine(pkg, np_params, **cfg):
    cfg = {**CFG, **cfg}
    if pkg == "jax":
        return JEngine(JConfig(**cfg, attention_impl="xla"),
                       params=jax.tree_util.tree_map(jnp.asarray, np_params))
    return LLMEngine(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _preempt_scenario(pkg, np_params):
    """tests/test_request_timeline.py's scenario on an engine: a 12-block
    pool, priority scheduling, A's 17-token prompt in three chunks, B
    preempted mid-decode and resumed. Returns {rid: event kinds}."""
    eng = _engine(pkg, np_params, block_size=8, num_kv_blocks=12,
                  max_prefill_chunk=8, scheduling_policy="priority")
    cls = JSampling if pkg == "jax" else SamplingParams
    rng = np.random.RandomState(3)
    sp = cls(max_tokens=40, temperature=0.0, ignore_eos=True)
    eng.add_request("req-a", prompt_token_ids=rng.randint(
        0, 384, size=17).tolist(), sampling_params=sp)
    eng.step()
    eng.add_request("req-b", prompt_token_ids=rng.randint(
        0, 384, size=17).tolist(), sampling_params=sp, priority=1)
    while eng.has_unfinished():
        eng.step()
    return {t["request_id"]: _kinds(t) for t in eng.timeline.snapshot()}


def test_preempted_timelines_equal_jax(np_params):
    got = _preempt_scenario("port", np_params)
    assert got == _preempt_scenario("jax", np_params)
    assert "preempt" in got["req-b"] and "resume" in got["req-b"]


def _restore_timeline(pkg, np_params):
    """A prompt evicted from HBM into the host tier, then asked again:
    (its second timeline's event kinds, the kv_restore event's blocks and
    tiers)."""
    eng = _engine(pkg, np_params, num_kv_blocks=12, max_num_seqs=2,
                  cpu_offload_bytes=64 * 2**20)
    cls = JSampling if pkg == "jax" else SamplingParams
    sp = cls(max_tokens=4, temperature=0.0, ignore_eos=True)
    try:
        eng.generate(["a" * 24], sp)
        deadline = time.time() + 10
        while not eng.offload.tiers[0].hashes() and time.time() < deadline:
            time.sleep(0.01)
        for i in range(4):
            eng.generate([chr(ord("b") + i) * 24], sp)
        eng.add_request("again", prompt="a" * 24, sampling_params=sp)
        while eng.has_unfinished():
            eng.step()
        (tl,) = [t for t in eng.timeline.snapshot()
                 if t["request_id"] == "again"]
        (ev,) = [e["attributes"] for e in tl["events"]
                 if e["name"] == "kv_restore"]
        return _kinds(tl), ev["blocks"], ev["tiers"]
    finally:
        eng.shutdown()


def test_kv_restore_event_equals_jax(np_params):
    got = _restore_timeline("port", np_params)
    assert got[1] > 0 and got[2] == {"cpu": got[1]}
    assert got == _restore_timeline("jax", np_params)
