"""Embeddings, rerank and score in the port against the JAX package, on
the CPU in float32 with the same weights.

- ModelRunner.embed (a mean-pooled, L2-normalised final hidden state over
  a scratch cache of its own) within 1e-5 of the JAX runner's on short,
  padded and multi-chunk inputs, with and without a LoRA adapter; chunked
  against one chunk within tests/test_engine_edge_cases.py's tolerance,
  and the over-length refusal with the JAX message.
- The port server's /v1/embeddings, /v1/rerank (/rerank) and /v1/score
  (/score) against the JAX server's with embed_one stubbed on both to the
  canned vectors of tests/test_rerank_score.py: the same status codes,
  rankings, scores and shapes; --api-key guards the unversioned aliases.
- A real tiny-model round trip: both servers on the same weights, the
  vectors and scores within 1e-5. The port server runs with
  --num-speculative-tokens, and its /metrics carries both
  vllm:spec_decode_* families after a completion.
- The router's semantic cache (EngineEmbedder) pointed at the port
  server: stable, normalised, deterministic vectors and a hit on a
  repeated query.
"""

import asyncio
import json
import math
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.model_runner import ModelRunner as JRunner
from production_stack_tpu.engine.server import EngineServer as JServer
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu.router.experimental.semantic_cache import (
    EngineEmbedder,
    SemanticCache,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.lora import save_adapter_npz
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
MODEL = "pst-tiny-ctx1k-debug"
MC = get_model_config(MODEL)
CFG = dict(model=MODEL, tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=4, num_kv_blocks=256,
           max_num_seqs=4, max_prefill_chunk=16, seed=0)
LONG_TEXT = "a longer text that runs over several prefill chunks. " * 2


def _vec(angle: float) -> np.ndarray:
    return np.asarray([math.cos(angle), math.sin(angle)], np.float32)


# tests/test_rerank_score.py's canned unit vectors
TEXT_VECS = {"query": _vec(0.0), "close": _vec(0.1), "mid": _vec(0.8),
             "far": _vec(2.5)}


def _canned(text, lora_name=None):
    return TEXT_VECS[text], len(text)


@pytest.fixture(scope="module")
def np_params():
    params = jllama.init_params(MC, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def servers(np_params):
    """The port server (speculative decoding on) and the JAX server on
    one event loop in a thread: {"port": port, "jax": port, "port_srv",
    "jax_srv"}."""
    port_srv = EngineServer(EngineConfig(**CFG, num_speculative_tokens=4,
                                         device="cpu"),
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
    yield {"port": box["port"], "jax": box["jax"], "port_srv": port_srv,
           "jax_srv": jax_srv}
    asyncio.run_coroutine_threadsafe(port_srv.stop(), loop).result(30)
    asyncio.run_coroutine_threadsafe(box["runner"].cleanup(),
                                     loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    th.join(30)


def call(port, path, body=None, headers=None):
    """(status, parsed JSON body or the raw text)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="GET" if body is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    try:
        return status, json.loads(text)
    except json.JSONDecodeError:
        return status, text


def _strip(body):
    """A response without its id (fresh on every call)."""
    return ({k: v for k, v in body.items() if k != "id"}
            if isinstance(body, dict) else body)


# -- the runner ------------------------------------------------------------------
def _adapter(seed):
    rng = np.random.RandomState(seed)
    L, h = MC.num_layers, MC.hidden_size
    dims = {"wq": (h, MC.q_size), "wk": (h, MC.kv_size),
            "wv": (h, MC.kv_size), "wo": (MC.q_size, h)}
    w = {"scaling": np.float32(0.5)}
    for t, (din, dout) in dims.items():
        w[f"{t}_A"] = rng.randn(L, din, 2).astype(np.float32) * 0.2
        w[f"{t}_B"] = rng.randn(L, 2, dout).astype(np.float32) * 0.2
    return w


@pytest.mark.parametrize("n,lora", [
    (3, False), (11, False), (40, False), (40, True), (5, True),
])
def test_embed_matches_jax(np_params, tmp_path, n, lora):
    """Short (one 8-row bucket), padded (11 rows in 16) and multi-chunk
    (40 tokens in chunks of 16, the last padded) inputs, base and with an
    adapter: vectors within 1e-5, unit norm."""
    cfg = dict(CFG)
    if lora:
        cfg.update(enable_lora=True, max_loras=2, max_lora_rank=2)
    jr = JRunner(JConfig(**cfg, attention_impl="xla"),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    tr = ModelRunner(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    slot = 0
    if lora:
        path = str(tmp_path / "a.npz")
        save_adapter_npz(path, _adapter(3))
        slot = tr.lora_manager.load("a", path)
        assert jr.lora_manager.load("a", path) == slot
    ids = np.random.RandomState(n).randint(1, 384, size=n).tolist()
    got = tr.embed(ids, lora_slot=slot)
    want = np.asarray(jr.embed(ids, lora_slot=slot))
    assert got.shape == want.shape == (MC.hidden_size,)
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL)
    assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
    if lora:
        assert not np.allclose(got, tr.embed(ids), atol=1e-3)


def test_chunked_equals_one_chunk_and_overlength_refused():
    """tests/test_engine_edge_cases.py: five chunks of 8 against one of
    64 within its tolerance; 101 tokens past max_model_len=64 refused
    with the JAX engine's message."""
    def build(chunk, cls=LLMEngine, cfg_cls=EngineConfig, **kw):
        return cls(cfg_cls(
            model="pst-tiny-debug", tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=4, num_kv_blocks=16,
            max_num_seqs=2, max_prefill_chunk=chunk, max_model_len=64,
            **kw))

    text = "chunked embedding correctness check!"
    one_chunk = build(64, device="cpu").embed([text])[0]
    many_chunks = build(8, device="cpu").embed([text])[0]
    np.testing.assert_allclose(one_chunk, many_chunks, rtol=2e-4,
                               atol=2e-5)
    with pytest.raises(ValueError) as mine:
        build(64, device="cpu").embed(["x" * 100])
    with pytest.raises(ValueError) as ref:
        build(64, JEngine, JConfig, attention_impl="xla").embed(["x" * 100])
    assert str(mine.value) == str(ref.value)
    assert "exceeds max_model_len" in str(mine.value)
    with pytest.raises(ValueError, match="require --enable-lora"):
        build(64, device="cpu").embed_one("x", lora_name="a")


# -- the servers with canned vectors ---------------------------------------------
CANNED_CASES = [
    ("/v1/rerank", {"query": "query", "documents": ["mid", "close", "far"]}),
    ("/rerank", {"query": "query", "documents": ["mid", "close", "far"],
                 "top_n": 1}),
    ("/v1/rerank", {"query": "query", "documents": []}),
    ("/v1/rerank", {"documents": ["mid"]}),
    ("/v1/rerank", {"query": "query", "documents": ["mid", "far"],
                    "top_n": True}),
    ("/v1/rerank", {"query": "query", "documents": ["mid"], "top_n": -1}),
    ("/v1/rerank", {"query": "query", "documents": ["mid"],
                    "model": "other"}),
    ("/v1/score", {"text_1": "query", "text_2": "close"}),
    ("/score", {"text_1": "query", "text_2": ["close", "far"]}),
    ("/v1/score", {"text_1": "query", "text_2": "query"}),
    ("/v1/score", {"text_1": ["query", "mid"], "text_2": ["close", "far"]}),
    ("/v1/score", {"text_1": ["query", "mid"], "text_2": "far"}),
    ("/v1/score", {"text_1": ["query", "mid"],
                   "text_2": ["close", "far", "mid"]}),
    ("/v1/score", {"text_1": "query", "text_2": []}),
    ("/v1/rerank", [1, 2, 3]),
    ("/v1/score", [1, 2, 3]),
    ("/v1/embeddings", {"input": ["query", "far"]}),
    ("/v1/embeddings", {"input": "mid"}),
    ("/v1/embeddings", {"input": []}),
    ("/v1/embeddings", {"input": [1, 2]}),
    ("/v1/embeddings", {"input": "mid", "model": "other"}),
]


@pytest.mark.parametrize("path,body", CANNED_CASES)
def test_canned_responses_equal_jax(servers, monkeypatch, path, body):
    """embed_one stubbed on both servers: the same status, and for a 200
    the same body (ids aside), values to 1e-6."""
    monkeypatch.setattr(servers["port_srv"].engine.engine, "embed_one",
                        _canned)
    monkeypatch.setattr(servers["jax_srv"].engine.engine, "embed_one",
                        _canned)
    st, got = call(servers["port"], path, body)
    jst, want = call(servers["jax"], path, body)
    assert st == jst, (got, want)
    if st != 200:
        assert "error" in got
        return
    assert _close(_strip(got), _strip(want)), (got, want)
    if path.endswith("rerank"):
        assert got["results"][0]["document"]["text"] == "close"


def _close(a, b):
    """Equal JSON values, floats to 1e-6."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return abs(a - b) <= 1e-6
    return a == b


def test_api_key_guards_rerank_and_score(servers, monkeypatch):
    """--api-key: /rerank, /score and their /v1 paths and /v1/embeddings
    answer 401 without the key and 200 with it."""
    srv = servers["port_srv"]
    monkeypatch.setattr(srv.engine.engine, "embed_one", _canned)
    monkeypatch.setattr(srv.config, "api_key", "sk-x")
    bodies = {"rerank": {"query": "query", "documents": ["far"]},
              "score": {"text_1": "query", "text_2": "far"},
              "embeddings": {"input": "far"}}
    for path in ("/rerank", "/v1/rerank", "/score", "/v1/score",
                 "/v1/embeddings"):
        body = bodies[path.rsplit("/", 1)[1]]
        assert call(servers["port"], path, body)[0] == 401, path
        assert call(servers["port"], path, body,
                    {"Authorization": "Bearer sk-x"})[0] == 200, path


# -- the real tiny model ----------------------------------------------------------
def test_round_trip_equals_jax_server(servers):
    """Both servers embed with their own engines on the same weights: the
    vectors (one text over several chunks), rerank and score within
    1e-5, the same ranking and usage."""
    texts = ["the cat sat on the mat", "a kitten naps on a rug", LONG_TEXT]
    outs = []
    for port in (servers["port"], servers["jax"]):
        st, emb = call(port, "/v1/embeddings", {"input": texts})
        st2, rr = call(port, "/v1/rerank", {"query": texts[0],
                                            "documents": texts[1:]})
        st3, sc = call(port, "/v1/score", {"text_1": texts[0],
                                           "text_2": texts[1:]})
        assert (st, st2, st3) == (200, 200, 200)
        outs.append((emb, rr, sc))
    (emb, rr, sc), (jemb, jrr, jsc) = outs
    assert emb["usage"] == jemb["usage"]
    assert emb["usage"]["prompt_tokens"] > 2 * CFG["max_prefill_chunk"]
    for a, b in zip(emb["data"], jemb["data"]):
        np.testing.assert_allclose(a["embedding"], b["embedding"],
                                   rtol=REL, atol=REL)
    assert ([r["index"] for r in rr["results"]]
            == [r["index"] for r in jrr["results"]])
    for a, b in zip(rr["results"] + sc["data"], jrr["results"] + jsc["data"]):
        key = "relevance_score" if "relevance_score" in a else "score"
        assert a[key] == pytest.approx(b[key], abs=REL)


def test_spec_server_reports_spec_counters(servers):
    """The port server runs with num_speculative_tokens=4: a repetitive
    greedy completion moves both vllm:spec_decode_* counters on
    /metrics."""
    st, r = call(servers["port"], "/v1/completions", {
        "prompt": "abcabcabcabcabcab", "max_tokens": 24, "temperature": 0,
        "ignore_eos": True})
    assert st == 200 and r["usage"]["completion_tokens"] == 24
    text = call(servers["port"], "/metrics")[1]
    vals = {ln.split("{")[0]: float(ln.rsplit(" ", 1)[1])
            for ln in text.splitlines() if ln.startswith("vllm:spec")}
    assert "# TYPE vllm:spec_decode_num_draft_tokens_total counter" in text
    assert vals["vllm:spec_decode_num_draft_tokens_total"] > 0
    assert 0 <= vals["vllm:spec_decode_num_accepted_tokens_total"] <= (
        vals["vllm:spec_decode_num_draft_tokens_total"])


def test_semantic_cache_embedder_on_port_server(servers):
    """The router's EngineEmbedder against the port's /v1/embeddings:
    stable dim, unit norm, deterministic per text; SemanticCache with it
    hits on a repeated chat query and misses on another."""
    url = f"http://127.0.0.1:{servers['port']}"

    class FakeReq:
        def __init__(self, body):
            self._b = body

        async def json(self):
            return self._b

    def chat(text):
        return {"messages": [{"role": "user", "content": text}]}

    async def run():
        emb = EngineEmbedder(url)
        cache = SemanticCache(model_name=MODEL, embedder_url=url,
                              threshold=0.999)
        try:
            v1 = await emb.encode_async("hello semantic world")
            v2 = await emb.encode_async("hello semantic world")
            v3 = await emb.encode_async("completely different text")
            assert v1 is not None and emb.dim == v1.shape[0] == MC.hidden_size
            np.testing.assert_array_equal(v1, v2)
            assert abs(float(np.linalg.norm(v1)) - 1.0) < 1e-5
            assert not np.allclose(v1, v3)
            q1 = chat("What is the capital of France?")
            assert await cache.check(FakeReq(q1)) is None
            cache.store(q1, {"id": "r1", "answer": "Paris"})
            hit = await cache.check(FakeReq(q1))
            assert hit is not None and hit.headers["x-semantic-cache"] == "hit"
            assert await cache.check(FakeReq(chat("x" * 40))) is None
            assert cache.stats() == {"entries": 1, "hits": 1, "misses": 2,
                                     "stores": 1}
        finally:
            await emb.close()
            await cache.embedder.close()
            cache.close()

    asyncio.run(run())
