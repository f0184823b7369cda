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
