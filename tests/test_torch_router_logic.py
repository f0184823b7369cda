"""The port's routing algorithms against the JAX router's.

Every algorithm of ``RoutingLogic`` runs one scenario on both packages:
the same endpoints, engine stats, request stats, health-board
observations and requests (session keys and prefix texts whose xxh64
hashes decide the pick, kvaware matches on each package's own KV
controller), with ``random`` seeded alike so ties break alike. The
chosen URLs must be equal pick for pick. Also here: the hash ring and
trie hashes equal xxhash's, and the controller-backed kvaware picks.
"""

from __future__ import annotations

import asyncio
import importlib
import random
import socket
import types

import pytest
import xxhash

import production_stack_tpu.router.routing_logic  # noqa: F401
import production_stack_tpu_torch.router.routing_logic  # noqa: F401

PKGS = ("production_stack_tpu", "production_stack_tpu_torch")
ALGORITHMS = ("roundrobin", "session", "kvaware", "prefixaware",
              "disaggregated_prefill", "ttft", "latency", "pd")


def _ns(pkg: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    return types.SimpleNamespace(
        rl=m("router.routing_logic"), proto=m("router.protocols"),
        es=m("router.stats.engine_stats"), rs=m("router.stats.request_stats"),
        health=m("router.stats.health"), bm=m("engine.block_manager"),
        tok=m("engine.tokenizer"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


URLS = [f"http://10.0.0.{i}:8000" for i in range(1, 5)]
PREFIX = "".join(chr(97 + (7 * j) % 26) for j in range(600))


def _eps(ns, urls=URLS, **kw) -> list:
    return [ns.proto.EndpointInfo(url=u, model_names=["m"], **kw)
            for u in urls]


def _req(ns, headers=None, body=None, endpoint="/v1/completions"):
    return ns.proto.RouterRequest(headers=headers or {}, body=body or {},
                                  endpoint=endpoint)


def _observe(ns, url: str, lat: float, ok: bool = True, n: int = 1,
             in_flight: int = 0) -> None:
    board = ns.health.get_engine_health_board()
    for _ in range(n):
        board.on_request_start(url)
        board.observe(url, {}, lat, ok=ok, ttft_s=lat / 2,
                      error_kind=None if ok else "connect")
    for _ in range(in_flight):
        board.on_request_start(url)


# -- one scenario an algorithm: picks from one package ---------------------
async def _roundrobin(ns) -> list:
    r = ns.rl.RoundRobinRouter()
    eps = _eps(ns)
    picks = [await r.route_request(eps, {}, {}, _req(ns)) for _ in range(6)]
    eps = eps[1:] + _eps(ns, ["http://10.0.0.9:8000"])
    picks += [await r.route_request(eps, {}, {}, _req(ns))
              for _ in range(6)]
    return picks


async def _session(ns) -> list:
    r = ns.rl.SessionRouter(session_key="x-user-id")
    eps = _eps(ns)
    picks = [await r.route_request(eps, {}, {}, _req(
        ns, {"X-User-Id": f"user-{i}"})) for i in range(48)]
    # a key in the body, a removed node, then the QPS fallback
    picks.append(await r.route_request(eps, {}, {}, _req(
        ns, body={"x-user-id": "from-the-body"})))
    picks += [await r.route_request(eps[:3], {}, {}, _req(
        ns, {"x-user-id": f"user-{i}"})) for i in range(16)]
    stats = {u: ns.rs.RequestStats(qps=q) for u, q in
             zip(URLS, (5.0, 1.0, 1.0, 9.0))}
    picks += [await r.route_request(eps, {}, stats, _req(ns))
              for _ in range(8)]
    return picks


async def _kvaware(ns) -> list:
    port = _free_port()
    r = ns.rl.KvawareRouter(kv_controller_url=f"127.0.0.1:{port}",
                            session_key="x-user-id", kv_min_match_tokens=64)
    await r.start()
    try:
        ctl = r._client.controller
        eps = _eps(ns)
        eps[2].kv_instance_id = "engine-c"
        tok = ns.tok.ByteTokenizer()
        # engine-c holds PREFIX's chain; 10.0.0.4:8000 (by the host:port
        # convention) a shorter one; engine-x is no endpoint
        for inst, url, text in (
                ("engine-c", URLS[2], PREFIX),
                ("10.0.0.4:8000", URLS[3], PREFIX[:200]),
                ("engine-x", "http://elsewhere:1", PREFIX)):
            ctl.register(inst, url, 16)
            ctl.admit(inst, "hbm", list(ns.bm.iter_chain_hashes(
                tok.encode(text), 16)))
        picks = []
        for text, hdr in ((PREFIX + " more", {}),
                          (PREFIX[:250] + " tail", {}),
                          (PREFIX[:100], {"x-user-id": "s1"}),
                          ("cold prompt " * 20, {"x-user-id": "s2"})):
            picks.append(await r.route_request(eps, {}, {}, _req(
                ns, hdr, {"prompt": text})))
        picks.append(await r.route_request(eps, {}, {}, _req(
            ns, body={"messages": [{"role": "user", "content": PREFIX}]},
            endpoint="/v1/chat/completions")))
        # the controller decided: the longest holder, then the shorter
        assert picks[:2] == [URLS[2], URLS[2]], picks
        return picks
    finally:
        await r.close()


async def _prefixaware(ns) -> list:
    r = ns.rl.PrefixAwareRouter(prefix_chunk_size=128)
    eps = _eps(ns)
    stats = {u: ns.rs.RequestStats(qps=q) for u, q in
             zip(URLS, (3.0, 3.0, 1.0, 2.0))}
    picks = []
    for i in range(12):
        text = (PREFIX if i % 3 else PREFIX[::-1]) + f" turn {i}"
        picks.append(await r.route_request(eps, {}, stats, _req(
            ns, body={"prompt": text})))
    r.on_endpoint_removed(picks[1])
    picks += [await r.route_request(eps, {}, {}, _req(
        ns, body={"prompt": PREFIX + f" again {i}"})) for i in range(4)]
    picks.append(await r.route_request(eps, {}, {}, _req(
        ns, body={"messages": [{"role": "user", "content": PREFIX}]})))
    return picks


async def _disaggregated(ns) -> list:
    r = ns.rl.DisaggregatedPrefillRouter()
    eps = _eps(ns)
    for e, label in zip(eps, ("prefill-a", "decode-a", "prefill-b",
                              "decode-b")):
        e.model_label = label
    picks = []
    for _ in range(5):
        picks.append(await r.route_prefill_decode(eps))
    picks.append(await r.route_request(eps, {}, {}, _req(ns)))
    with pytest.raises(RuntimeError):
        await r.route_prefill_decode(eps[:1])
    return picks


async def _ttft(ns) -> list:
    r = ns.rl.TtftRouter(default_prefill_tps=4000.0)
    eps = _eps(ns)
    es = {URLS[0]: ns.es.EngineStats(num_queuing_requests=3),
          URLS[1]: ns.es.EngineStats(num_queuing_requests=0),
          URLS[2]: ns.es.EngineStats(num_queuing_requests=1)}
    rs = {URLS[0]: ns.rs.RequestStats(prefill_tps=9000.0,
                                      uncomputed_prefix_tokens=100),
          URLS[1]: ns.rs.RequestStats(prefill_tps=2000.0,
                                      uncomputed_prefix_tokens=4000),
          URLS[3]: ns.rs.RequestStats(prefill_tps=6000.0)}
    _observe(ns, URLS[2], 0.1, ok=False, n=4)  # unhealthy: skipped
    picks = []
    for n in (10, 400, 4000, 40000, 64):
        picks.append(await r.route_request(eps, es, rs, _req(
            ns, body={"prompt": "x" * n})))
    picks.append(await r.route_request(eps, es, {}, _req(
        ns, body={"messages": [{"role": "user", "content": "hi " * 50}]})))
    return picks


async def _latency(ns) -> list:
    r = ns.rl.LeastLatencyRouter()
    eps = _eps(ns)
    picks = [await r.route_request(eps, {}, {}, _req(ns))
             for _ in range(4)]  # unmeasured: random ties
    _observe(ns, URLS[0], 0.05, n=3)
    _observe(ns, URLS[1], 0.02, n=3, in_flight=4)
    _observe(ns, URLS[2], 0.2, n=2)
    _observe(ns, URLS[3], 0.01, ok=False, n=5)
    picks += [await r.route_request(eps, {}, {}, _req(ns))
              for _ in range(4)]
    _observe(ns, URLS[0], 0.5, n=10)
    picks += [await r.route_request(eps, {}, {}, _req(ns))
              for _ in range(4)]
    return picks


async def _pd(ns) -> list:
    r = ns.rl.PDRouter(prefix_chunk_size=64)
    eps = _eps(ns)
    for e, role in zip(eps, ("prefill", "decode", "decode", "both")):
        e.pd_role = role
    _observe(ns, URLS[1], 0.03, n=2)
    _observe(ns, URLS[2], 0.01, n=2)
    picks = []
    for i in range(4):  # cold prompts split, then their resumes
        text = f"session {i}: " + PREFIX[i * 50:i * 50 + 300]
        picks.append(await r.plan(eps, _req(ns, body={"prompt": text})))
        picks.append(await r.plan(eps, _req(
            ns, body={"prompt": text + " and the next turn"})))
    picks.append(await r.route_request(eps, {}, {}, _req(
        ns, body={"prompt": "a new one " * 40})))
    both_only = eps[3:]
    picks.append(await r.plan(both_only, _req(
        ns, body={"prompt": "degenerate fleet " * 10})))
    return picks


SCENARIOS = {"roundrobin": _roundrobin, "session": _session,
             "kvaware": _kvaware, "prefixaware": _prefixaware,
             "disaggregated_prefill": _disaggregated, "ttft": _ttft,
             "latency": _latency, "pd": _pd}


def _picks(pkg: str, algo: str) -> list:
    ns = _ns(pkg)
    ns.health._reset_engine_health_board()
    random.seed(1234)
    try:
        return asyncio.run(SCENARIOS[algo](ns))
    finally:
        ns.health._reset_engine_health_board()


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_routing_picks_equal_jax(algo):
    want = _picks(PKGS[0], algo)
    got = _picks(PKGS[1], algo)
    assert got == want
    # the scenario decides something: not every pick the same
    assert len({str(p) for p in want}) > 1


def test_every_routing_logic_has_a_scenario():
    jax_rl = importlib.import_module("production_stack_tpu.router."
                                     "routing_logic")
    port_rl = importlib.import_module("production_stack_tpu_torch.router."
                                      "routing_logic")
    assert [m.value for m in port_rl.RoutingLogic] == [
        m.value for m in jax_rl.RoutingLogic] == list(ALGORITHMS)
    assert {k.value: v.__name__ for k, v in port_rl._ROUTERS.items()} == {
        k.value: v.__name__ for k, v in jax_rl._ROUTERS.items()}


@pytest.mark.parametrize("text", ["", "a", "héllo wörld ✓", PREFIX,
                                  "x" * 129])
def test_ring_and_trie_hashes_equal_xxhash(text):
    from production_stack_tpu_torch.router import hashring, hashtrie

    assert hashring._hash(text) == xxhash.xxh64_intdigest(text)
    trie = hashtrie.HashTrie(chunk_size=7)
    assert list(trie._chunk_hashes(text)) == [
        xxhash.xxh64_intdigest(text[i:i + 7])
        for i in range(0, len(text), 7)]


def test_shared_cache_hints_hash_the_engine_chain():
    """SharedCacheHints folds tokens into the engines' block chain
    (block_manager.iter_chain_hashes), capped at MAX_PROBE_TOKENS; the
    hashes equal the JAX router's."""
    jax_rl, port_rl = (_ns(p).rl for p in PKGS)
    toks = list(range(1, 5000))
    want = jax_rl.SharedCacheHints("127.0.0.1:1", 32)
    got = port_rl.SharedCacheHints("127.0.0.1:1", 32)
    assert got.chain_hashes(toks) == want.chain_hashes(toks)
    assert got.max_depth_tokens(toks) == want.max_depth_tokens(toks) == 4096
    assert asyncio.run(got.depth_tokens(toks[:20])) == 0  # no full block
