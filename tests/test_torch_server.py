"""The PyTorch port's OpenAI server on loopback, on the CPU: health,
models, completions (plain and streamed), chat, metrics, and the
refusals of malformed requests. Random weights give
gibberish text: the checks are on token counts, finish reasons, usage
and the wire format."""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import EngineServer

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port():
    server = EngineServer(EngineConfig(
        model="pst-tiny-debug", tokenizer="byte", device="cpu",
        dtype="float32", cache_dtype="float32", block_size=4,
        num_kv_blocks=256, max_num_seqs=4, max_prefill_chunk=32,
    ))
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
    yield box[0]
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    th.join(30)


def call(port, path, body=None, method=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method=method,
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def test_health_and_models(port):
    st, _, body = call(port, "/health")
    assert st == 200 and json.loads(body) == {"status": "healthy"}
    st, _, body = call(port, "/v1/models")
    card = json.loads(body)["data"][0]
    assert st == 200 and card["id"] == "pst-tiny-debug"
    assert card["max_model_len"] == 256
    assert "kv_role" not in card  # no PD role configured


def test_completion(port):
    st, _, body = call(port, "/v1/completions", {
        "prompt": "hello world", "max_tokens": 7, "temperature": 0,
        "ignore_eos": True})
    r = json.loads(body)
    assert st == 200 and r["object"] == "text_completion"
    assert r["choices"][0]["finish_reason"] == "length"
    assert r["usage"] == {"prompt_tokens": 12, "completion_tokens": 7,
                          "total_tokens": 19}


def test_token_id_prompt_is_deterministic_when_greedy(port):
    body = {"prompt": [1, 2, 3, 4], "max_tokens": 5, "temperature": 0,
            "ignore_eos": True}
    a = json.loads(call(port, "/v1/completions", body)[2])
    b = json.loads(call(port, "/v1/completions", body)[2])
    assert a["choices"][0]["text"] == b["choices"][0]["text"]
    assert a["usage"]["prompt_tokens"] == 4


@pytest.mark.parametrize("chat", [False, True])
def test_stream(port, chat):
    path = "/v1/chat/completions" if chat else "/v1/completions"
    body = {"max_tokens": 6, "temperature": 0.7, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}}
    if chat:
        body["messages"] = [{"role": "user", "content": "hi"}]
    else:
        body["prompt"] = "stream this"
    st, ctype, text = call(port, path, body)
    assert st == 200 and ctype.startswith("text/event-stream")
    events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    reasons = [c["choices"][0]["finish_reason"] for c in chunks
               if c["choices"]]
    assert reasons[-1] == "length" and set(reasons[:-1]) <= {None}
    assert chunks[-1]["usage"]["completion_tokens"] == 6
    kind = "chat.completion.chunk" if chat else "text_completion"
    assert all(c["object"] == kind for c in chunks)


def test_chat(port):
    st, _, body = call(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Say hi."}],
        "max_tokens": 4, "temperature": 0, "ignore_eos": True})
    r = json.loads(body)
    assert st == 200 and r["object"] == "chat.completion"
    assert r["choices"][0]["message"]["role"] == "assistant"
    assert r["usage"]["completion_tokens"] == 4


def test_concurrent_requests(port):
    results = []

    def one(i):
        results.append(call(port, "/v1/completions", {
            "prompt": f"request {i} " * 8, "max_tokens": 5,
            "temperature": 0, "ignore_eos": True}))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(results) == 4
    for st, _, body in results:
        assert st == 200
        assert json.loads(body)["usage"]["completion_tokens"] == 5


def test_metrics_gauges(port):
    st, ctype, text = call(port, "/metrics")
    assert st == 200 and ctype.startswith("text/plain")
    lines = {ln.split("{")[0]: float(ln.rsplit(" ", 1)[1])
             for ln in text.splitlines() if ln and not ln.startswith("#")}
    for gauge in ("vllm:num_requests_running", "vllm:num_requests_waiting",
                  "vllm:gpu_cache_usage_perc"):
        assert gauge in lines
    assert 0.0 <= lines["vllm:gpu_cache_usage_perc"] <= 1.0


def test_kernel_launch_report_reads_and_resets(port):
    """The CPU runs the plain versions, so no kernel launch is counted;
    the forward dispatches are, and DELETE zeroes both."""
    st, _, body = call(port, "/debug/kernel_launches", method="DELETE")
    zero = {"launches": {"decode": 0, "prefill": 0, "ragged": 0},
            "dispatches": {"prefill": 0, "prefill_batch": 0, "decode": 0,
                           "decode_multi": 0, "ragged": 0,
                           "decode_iterations": 0, "verify_batch": 0,
                           "prefill_lanes": 0}}
    assert st == 200 and json.loads(body) == zero
    call(port, "/v1/completions", {"prompt": "count me", "max_tokens": 3,
                                   "temperature": 0, "ignore_eos": True})
    st, _, body = call(port, "/debug/kernel_launches")
    r = json.loads(body)
    assert st == 200 and r["launches"] == zero["launches"]
    assert r["dispatches"]["decode"] == 2
    assert r["dispatches"]["prefill"] + r["dispatches"]["prefill_batch"] >= 1


@pytest.mark.parametrize("path,body,status", [
    ("/v1/completions", {"prompt": "x", "n": 2, "best_of": 3}, 400),
    ("/v1/completions", {"prompt": "x", "prompt_logprobs": 21}, 400),
    ("/v1/completions", {"prompt": ["a", 1]}, 400),
    ("/v1/completions", {"prompt": "x", "model": "other"}, 404),
    ("/v1/completions", {"prompt": "x", "max_tokens": "many"}, 400),
    ("/v1/chat/completions", {"messages": []}, 400),
    ("/v1/embeddings", {"input": []}, 400),
    ("/v1/embeddings", {"input": "x", "model": "other"}, 404),
])
def test_refusals(port, path, body, status):
    st, _, text = call(port, path, body)
    assert st == status
    assert "error" in json.loads(text)


def test_metrics_tpu_counters(port):
    """The JAX engine's decode and ragged-round families, under its own
    names: counters written as prometheus_client writes them (x_total in
    the TYPE line and the sample), the decode_k histogram."""
    st, _, text = call(port, "/metrics")
    samples = {ln.split("{")[0]: float(ln.rsplit(" ", 1)[1])
               for ln in text.splitlines() if ln and not ln.startswith("#")}
    for family in ("tpu:decode_rounds", "tpu:ragged_rounds",
                   "tpu:ragged_split_rounds", "tpu:decode_early_exit_rounds",
                   "tpu:decode_overshoot_tokens"):
        assert f"# TYPE {family}_total counter" in text
        assert samples[f"{family}_total"] >= 0
    assert "# TYPE tpu:decode_k histogram" in text
    assert samples["tpu:decode_k_count"] == samples["tpu:decode_rounds_total"]
    assert 'tpu:decode_k_bucket{model_name="pst-tiny-debug",le="+Inf"}' in text


# -- the request head and the API key, against the JAX server --------------------
KEY = "sk-port-test"


@pytest.fixture(scope="module")
def keyed():
    """The port server and the JAX aiohttp server, both with --api-key,
    on one event loop in a thread: {"port": port, "jax": port}."""
    from aiohttp import web

    from production_stack_tpu.engine.config import EngineConfig as JConfig
    from production_stack_tpu.engine.server import EngineServer as JServer

    cfg = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
               cache_dtype="float32", block_size=4, num_kv_blocks=64,
               max_num_seqs=2, max_prefill_chunk=16, api_key=KEY)
    port_srv = EngineServer(EngineConfig(**cfg, device="cpu"))
    jax_srv = JServer(JConfig(**cfg, attention_impl="xla"))
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
    yield box
    asyncio.run_coroutine_threadsafe(port_srv.stop(), loop).result(30)
    asyncio.run_coroutine_threadsafe(box["runner"].cleanup(),
                                     loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    th.join(30)


def raw(port, head: bytes, body: bytes = b""):
    """Send one raw HTTP/1.1 request (`head`: the request line and its
    header lines, CRLF-separated, no blank line) and read the answer to
    the end: (status, body bytes)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(head + b"\r\nHost: x\r\nConnection: close\r\n\r\n"
                  + body)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    head_part, _, payload = data.partition(b"\r\n\r\n")
    status = int(head_part.split(b" ", 2)[1])
    if b"transfer-encoding: chunked" in head_part.lower():
        out = b""
        while payload:
            size, _, rest = payload.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, payload = out + rest[:n], rest[n + 2:]
        payload = out
    return status, payload


def both_raw(keyed, head, body=b""):
    return [raw(keyed[k], head, body) for k in ("port", "jax")]


@pytest.mark.parametrize("auth", [
    None, b"Bearer wrong", b"Bearer sk-p\xc3\xa9rt", b"Basic " + KEY.encode(),
    "Bearer sk-port-tesé".encode("latin-1"),
], ids=["missing", "wrong", "non_ascii_utf8", "not_bearer", "non_ascii_latin1"])
@pytest.mark.parametrize("path", [b"POST /v1/completions", b"GET /v1/models",
                                  b"GET /v1/no-such-route",
                                  b"DELETE /v1/completions",
                                  b"POST /tokenize"])
def test_api_key_refusals_equal_jax_server(keyed, auth, path):
    """401 with the reference's body for a missing, wrong or non-ASCII
    key, on every /v1/ path (an unknown one, and a known one under
    another method, too: the check runs before the route lookup) and
    the listed non-/v1 paths."""
    head = path + b" HTTP/1.1"
    if auth is not None:
        head += b"\r\nAuthorization: " + auth
    got, want = both_raw(keyed, head + b"\r\nContent-Length: 2", b"{}")
    assert got[0] == want[0] == 401
    assert json.loads(got[1]) == json.loads(want[1])
    assert json.loads(got[1])["error"]["message"] == "invalid API key"


def test_api_key_open_paths_and_right_key_equal_jax_server(keyed):
    """/health stays open; with the key a request is served."""
    for head in (b"GET /health HTTP/1.1",
                 b"GET /v1/models HTTP/1.1\r\nAuthorization: Bearer " +
                 KEY.encode()):
        got, want = both_raw(keyed, head)
        assert got[0] == want[0] == 200, head


def test_api_key_check_is_compare_digest_on_bytes(monkeypatch):
    from production_stack_tpu_torch.engine import server as srv

    seen = []

    def spy(a, b):
        seen.append((a, b))
        return a == b

    monkeypatch.setattr(srv.hmac, "compare_digest", spy)
    assert srv._key_matches("Bearer k\udcc3", "k") is False
    assert srv._key_matches("Bearer k", "k") is True
    assert seen == [(b"Bearer k\xc3", b"Bearer k"), (b"Bearer k", b"Bearer k")]


@pytest.mark.parametrize("length", [b"abc", b"-3", b"+3", b"1_0", b"3 4"])
def test_malformed_content_length_answers_400_as_jax(keyed, length):
    """A Content-Length that is not ASCII digits: 400 with aiohttp's
    plain-text body, on both servers (no dropped connection)."""
    got, want = both_raw(
        keyed, b"POST /health HTTP/1.1\r\nContent-Length: " + length,
        b"abc")
    assert got == want and got[0] == 400


def test_chunked_body_is_decoded_as_jax(keyed):
    body = json.dumps({"prompt": "chunked hello"}).encode()
    parts = [body[:7], body[7:20], body[20:]]
    wire = b"".join(b"%x;ext=1\r\n%s\r\n" % (len(p), p) for p in parts)
    wire += b"0\r\nX-Trailer: 1\r\n\r\n"
    head = (b"POST /tokenize HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
            b"Content-Type: application/json\r\nAuthorization: Bearer "
            + KEY.encode())
    got, want = both_raw(keyed, head, wire)
    assert got[0] == want[0] == 200
    assert json.loads(got[1]) == json.loads(want[1])
    assert json.loads(got[1])["count"] == len("chunked hello") + 1


CHUNKED_HEAD = (b"POST /tokenize HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
                b"Content-Type: application/json\r\nAuthorization: Bearer "
                + KEY.encode())
CHUNK = b"a" * 26


@pytest.mark.parametrize("wire", [
    b"0x1a\r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b"+1a\r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b" 1a\r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b"1a \r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b"1a ;x\r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b"-1\r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b"1_a\r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b"\r\n" + CHUNK + b"\r\n0\r\n\r\n",
    b"1a\r\n" + CHUNK + b"XY\r\n0\r\n\r\n",
], ids=["0x_prefix", "plus_sign", "leading_space", "trailing_space",
        "space_before_extension", "negative", "underscore", "empty",
        "no_crlf_after_chunk"])
def test_malformed_chunked_body_answers_400_as_jax(keyed, wire):
    """A chunk size that is not hex digits before ';', or a chunk not
    followed by CRLF: aiohttp's 400 and plain-text body, byte for
    byte, on both servers."""
    got, want = both_raw(keyed, CHUNKED_HEAD, wire)
    assert got == want and got[0] == 400


@pytest.mark.parametrize("wire", [
    b"1a\r\n" + CHUNK + b"XY0\r\n\r\n",
    b"1a\n" + CHUNK + b"\n0\n\n",
], ids=["no_crlf_after_chunk_then_data", "bare_lf_after_size"])
def test_malformed_chunked_body_names_the_fault_as_jax(keyed, wire):
    """Where aiohttp's excerpt runs on through its receive buffer to
    the next CRLF, past the bytes the port's reader has read: the same
    400 and the same reason line."""
    got, want = both_raw(keyed, CHUNKED_HEAD, wire)
    assert got[0] == want[0] == 400
    assert got[1].split(b":\n")[0] == want[1].split(b":\n")[0]
