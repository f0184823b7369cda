"""Request routing algorithms.

Parity with the reference's six algorithms behind one interface (reference:
src/vllm_router/routers/routing_logic.py — RoutingLogic enum:77-84,
RoundRobinRouter:155, SessionRouter:198, KvawareRouter:250,
PrefixAwareRouter:379, DisaggregatedPrefillRouter:432, TtftRouter:475), with
the KV-aware path speaking to the port's KV controller
(production_stack_tpu_torch.kv), the stand-in for the LMCache controller
the reference imports. Counterpart of production_stack_tpu/router/
routing_logic.py: the same picks on the same inputs.

All algorithms are async; route_request returns the chosen engine URL.
"""

from __future__ import annotations

import abc
import enum
import random

from production_stack_tpu_torch.router.hashring import HashRing
from production_stack_tpu_torch.router.hashtrie import HashTrie
from production_stack_tpu_torch.router.protocols import EndpointInfo, RouterRequest
from production_stack_tpu_torch.router.stats.engine_stats import EngineStats
from production_stack_tpu_torch.router.stats.request_stats import RequestStats
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class RoutingLogic(str, enum.Enum):
    ROUND_ROBIN = "roundrobin"
    SESSION_BASED = "session"
    KVAWARE = "kvaware"
    PREFIXAWARE = "prefixaware"
    DISAGGREGATED_PREFILL = "disaggregated_prefill"
    TTFT = "ttft"
    # health-aware least-EWMA-latency (consumes the health scoreboard)
    LEAST_LATENCY = "latency"
    # PD-role, prefix-affine data plane: cold prompts split across
    # prefill-/decode-role engines (health-scoreboard load-aware),
    # multi-turn resumes go to the engine already holding the session
    # chain (PPD) — see PDRouter
    PD = "pd"


class RoutingInterface(abc.ABC):
    @abc.abstractmethod
    async def route_request(
        self,
        endpoints: list[EndpointInfo],
        engine_stats: dict[str, EngineStats],
        request_stats: dict[str, RequestStats],
        request: RouterRequest,
    ) -> str:
        """Pick the engine URL to serve this request."""

    async def start(self) -> None:
        pass

    async def close(self) -> None:
        pass

    def on_endpoint_removed(self, url: str) -> None:
        pass

    # -- shared helper: drop scoreboard-unhealthy backends ---------------
    @staticmethod
    def _healthy_endpoints(
        endpoints: list[EndpointInfo],
    ) -> list[EndpointInfo]:
        """Filter out backends the EngineHealthBoard marks unhealthy
        (a running consecutive-failure streak — dead pod, wedged
        engine). Degrades to the FULL list when everything looks
        unhealthy: routing somewhere beats routing nowhere, and the
        proxy's connect-retry still covers the request. The board
        auto-creates empty (is_healthy defaults True), so this is safe
        before any traffic has been observed."""
        from production_stack_tpu_torch.router.stats.health import (
            get_engine_health_board,
        )

        board = get_engine_health_board()
        healthy = [e for e in endpoints if board.is_healthy(e.url)]
        return healthy or list(endpoints)

    # -- shared helper: least-QPS endpoint (reference: routing_logic.py:88)
    @staticmethod
    def _qps_routing(
        endpoints: list[EndpointInfo],
        request_stats: dict[str, RequestStats],
    ) -> str:
        qps_of = lambda ep: (
            request_stats[ep.url].qps if ep.url in request_stats else 0.0
        )
        best = min(qps_of(ep) for ep in endpoints)
        # ties (cold start: every engine at 0 QPS) spread randomly instead
        # of herding onto the first endpoint
        tied = [ep.url for ep in endpoints if qps_of(ep) == best]
        return random.choice(tied)


class RoundRobinRouter(RoutingInterface):
    """reference: routing_logic.py:155"""

    def __init__(self, **kwargs):
        self._counter = 0
        # cached sorted view: endpoints only change on discovery events,
        # so re-sorting per request is wasted work on the hot path
        self._sorted_urls: list[str] = []
        self._key: tuple[str, ...] = ()

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        if not endpoints:
            raise RuntimeError("no available endpoints")
        key = tuple(e.url for e in endpoints)
        if key != self._key:
            self._sorted_urls = sorted(key)
            self._key = key
        url = self._sorted_urls[self._counter % len(self._sorted_urls)]
        self._counter += 1
        return url


class SessionRouter(RoutingInterface):
    """Session-sticky via consistent hash ring with least-QPS fallback
    (reference: routing_logic.py:198)."""

    def __init__(self, session_key: str | None = "x-user-id", **kwargs):
        self.session_key = session_key
        self.ring = HashRing()

    def _update_ring(self, endpoints: list[EndpointInfo]) -> None:
        self.ring.set_nodes([e.url for e in endpoints])

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        if not endpoints:
            raise RuntimeError("no available endpoints")
        session_id = request.session_id(self.session_key)
        if session_id is None:
            return self._qps_routing(endpoints, request_stats)
        self._update_ring(endpoints)
        url = self.ring.get_node(str(session_id))
        assert url is not None
        return url


def _hostport(url_or_instance: str) -> str:
    """Normalize an endpoint url or kv instance id to "host:port".

    kv instance ids are free-form strings; anything urlparse cannot treat
    as host:port (e.g. "engine-a:dev0") is compared verbatim instead of
    crashing the routing path."""
    from urllib.parse import urlparse

    s = url_or_instance
    try:
        p = urlparse(s if "//" in s else f"//{s}")
        host = p.hostname or s
        return f"{host}:{p.port}" if p.port else host
    except ValueError:
        return s


def _match_instance_to_url(
    inst: str, endpoints: list[EndpointInfo]
) -> str | None:
    """Map a KV controller instance id to an endpoint url.

    Preference order: the engine-advertised kv_instance_id carried on
    EndpointInfo (the handshake — robust to ids that are not host:port),
    then the id == url host:port convention. Exact comparisons only:
    substring matching would let instance "host:80" claim endpoint
    "http://host:8000"."""
    for ep in endpoints:
        if ep.kv_instance_id and inst == ep.kv_instance_id:
            return ep.url
    inst_hp = _hostport(inst)
    for ep in endpoints:
        if inst == ep.url or inst_hp == _hostport(ep.url):
            return ep.url
    return None


def _engine_prompt_text(request, tokenizer=None) -> str:
    """Render the request exactly as the engine will (chat template applied)
    so chained block hashes line up with engine-side prefix hashes — the
    reference gets this for free by sharing vLLM's tokenizer
    (reference: routing_logic.py:324)."""
    body = request.body
    msgs = body.get("messages")
    if isinstance(msgs, list):
        tok = tokenizer
        if tok is None:
            from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

            tok = ByteTokenizer()
        if hasattr(tok, "apply_chat_template"):
            try:
                return tok.apply_chat_template(msgs)
            except Exception as e:  # noqa: BLE001 — fall back to flat text
                logger.debug(
                    "chat template render failed (%s); routing on flat "
                    "text (prefix hashes may miss engine-side matches)", e,
                )
    return request.request_text()


class SharedCacheHints:
    """Cluster-cache prefix-depth probe feeding KV-aware routing.

    Wraps the cache server's payload-free `lookup` verb
    (kv.cache_client.AsyncCacheClient): tokens are folded into the SAME
    chained block hashes the engines' BlockManager computes (so a depth
    here IS a depth the RemoteTier restore will serve), and the answer
    is matched-prefix TOKENS in the shared cache. A cold-on-every-
    engine prompt with a cluster hit is cheaper to restore ANYWHERE
    than to recompute somewhere — the caller turns that into a
    load-aware pick instead of a sticky/QPS fallback. Every failure
    mode degrades to depth 0 (routing must never depend on the cache
    being up)."""

    #: circuit-breaker cooldown after a failed lookup: routing must
    #: never serialize behind a dead cache server's connect timeouts
    #: (the client lock admits one request at a time), so after one
    #: failure every probe short-circuits to depth 0 until the window
    #: passes and ONE request retries
    DOWN_COOLDOWN_S = 15.0

    #: probe depth cap (tokens): prompts are hashed only this deep —
    #: bounds the per-request tokenize+hash cost on huge prompts (a
    #: multi-thousand-token cluster hit already decides the routing)
    MAX_PROBE_TOKENS = 4096

    def __init__(self, url: str, block_size: int = 32,
                 timeout: float = 2.0, tokenizer=None):
        from production_stack_tpu_torch.kv.cache_client import AsyncCacheClient

        self.url = url
        self.block_size = block_size
        self.tokenizer = tokenizer
        self.client = AsyncCacheClient(url, timeout=timeout)
        self._down_until = 0.0  # monotonic

    def chain_hashes(self, tokens: list[int]) -> list[int]:
        from production_stack_tpu_torch.engine.block_manager import (
            iter_chain_hashes,
        )

        return list(iter_chain_hashes(tokens, self.block_size))

    def max_depth_tokens(self, tokens: list[int]) -> int:
        """The deepest answer a lookup could possibly return (full
        blocks only, probe cap applied) — callers skip the round-trip
        entirely when an engine-local match already covers this."""
        n = min(len(tokens), self.MAX_PROBE_TOKENS)
        return (n // self.block_size) * self.block_size

    async def depth_tokens(self, tokens: list[int]) -> int:
        """Matched-prefix depth in TOKENS (0 on miss or any failure —
        a dead cache server must not fail OR slow routing: failures
        trip a cooldown during which probes short-circuit)."""
        import time as _time

        if _time.monotonic() < self._down_until:
            return 0
        hashes = self.chain_hashes(tokens[: self.MAX_PROBE_TOKENS])
        if not hashes:
            return 0
        try:
            depth = await self.client.lookup(hashes)
        except Exception as e:  # noqa: BLE001 — the estimate degrades
            self._down_until = _time.monotonic() + self.DOWN_COOLDOWN_S
            logger.warning(
                "shared-cache lookup failed (%s); skipping probes for "
                "%.0fs", e, self.DOWN_COOLDOWN_S,
            )
            return 0
        self._down_until = 0.0
        self._note(hit=depth > 0)
        return depth * self.block_size

    async def probe_text(self, text: str) -> int:
        """depth_tokens for raw text: the tokenize + per-block hashing
        run in an EXECUTOR (a 100KB trie-cold prompt must not stall the
        router event loop for every concurrent request) and only the
        capped prefix is processed. The breaker check runs first so a
        down server costs nothing at all."""
        import asyncio
        import time as _time

        if _time.monotonic() < self._down_until:
            return 0
        # ~4 chars/token upper bound keeps the executor job itself
        # bounded before the token-level cap applies
        capped = text[: self.MAX_PROBE_TOKENS * 4]
        tokens = await asyncio.get_running_loop().run_in_executor(
            None, _tokenize_with, self.tokenizer, capped
        )
        return await self.depth_tokens(tokens)

    def note_routed(self) -> None:
        self._note(hit=False, routed=True, lookup=False)

    def _note(self, hit: bool, routed: bool = False,
              lookup: bool = True) -> None:
        try:
            from production_stack_tpu_torch.router.services.metrics_service import (
                note_shared_cache_lookup,
            )
        except ImportError:  # metrics unavailable: hints still work
            return
        note_shared_cache_lookup(
            self.url, hit=hit, routed=routed, lookup=lookup
        )

    async def close(self) -> None:
        await self.client.close()


def _tokenize_with(tokenizer, text: str) -> list[int]:
    """Tokenize the way the target engines do: the provided model
    tokenizer, else the hermetic byte tokenizer (incl. BOS) matching
    engines running tokenizer="byte" — hashes must line up with
    engine-side block hashes."""
    if tokenizer is not None:
        return tokenizer.encode(text)
    from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

    return ByteTokenizer().encode(text)


class KvawareRouter(RoutingInterface):
    """Route to the engine already holding the longest KV prefix, via the KV
    controller (reference: routing_logic.py:250 asks the LMCache controller;
    ours asks production_stack_tpu_torch.kv.controller). With a shared cache
    server configured, a prompt no engine holds locally but the CLUSTER
    cache does routes load-aware (any engine restores it via RemoteTier
    at transfer cost) instead of falling back to session routing."""

    def __init__(
        self,
        kv_controller_url: str = "127.0.0.1:9000",
        session_key: str | None = "x-user-id",
        kv_min_match_tokens: int = 1,
        tokenizer=None,
        kv_cache_server_url: str | None = None,
        kv_cache_block_size: int = 32,
        **kwargs,
    ):
        self.controller_url = kv_controller_url
        self.min_match = kv_min_match_tokens
        self.fallback = SessionRouter(session_key)
        self.tokenizer = tokenizer
        self._client = None
        self.cache_hints = (
            SharedCacheHints(kv_cache_server_url, kv_cache_block_size,
                             tokenizer=tokenizer)
            if kv_cache_server_url else None
        )

    async def start(self) -> None:
        # the router embeds the KV controller (engines report to it over
        # TCP, reference: routing_logic.py:282 starts the LMCache manager
        # in-process); falls back to client mode if one is already running
        from production_stack_tpu_torch.kv.controller import start_or_connect

        host, _, port = self.controller_url.rpartition(":")
        self._client = await start_or_connect(host or "127.0.0.1", int(port))

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()
        if self.cache_hints is not None:
            await self.cache_hints.close()

    def _tokenize(self, text: str) -> list[int]:
        return _tokenize_with(self.tokenizer, text)

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        if not endpoints:
            raise RuntimeError("no available endpoints")
        text = _engine_prompt_text(request, self.tokenizer)
        if self._client is None or not text:
            return await self.fallback.route_request(
                endpoints, engine_stats, request_stats, request
            )
        try:
            tokens = self._tokenize(text)
            matches = await self._client.lookup(tokens)
        except Exception as e:
            logger.warning("kv controller lookup failed: %s", e)
            return await self.fallback.route_request(
                endpoints, engine_stats, request_stats, request
            )
        by_instance = {
            inst: n for inst, n in matches.items() if n >= self.min_match
        }
        best_engine_tokens = 0
        best_engine_url = None
        if by_instance:
            best = sorted(
                by_instance.items(), key=lambda kv: -kv[1]
            )
            for inst, n in best:
                url = _match_instance_to_url(inst, endpoints)
                if url is not None:
                    best_engine_url, best_engine_tokens = url, n
                    break
        cluster_tokens = 0
        if (self.cache_hints is not None
                and best_engine_tokens
                < self.cache_hints.max_depth_tokens(tokens)):
            # only probe when the cluster could possibly answer DEEPER
            # than the best engine-local match — a fully-covered prompt
            # routes to its holder without a round-trip
            cluster_tokens = await self.cache_hints.depth_tokens(tokens)
        if (best_engine_url is not None
                and best_engine_tokens >= cluster_tokens):
            # an engine-local hit at least as deep as the cluster's
            # beats paying the restore transfer
            return best_engine_url
        if cluster_tokens > 0 and cluster_tokens >= self.min_match:
            # cluster hit beats recompute: EVERY engine can restore the
            # chain from the shared cache, so pick load-aware instead
            # of herding onto the session fallback
            self.cache_hints.note_routed()
            return _health_scored_pick(endpoints)
        if best_engine_url is not None:
            return best_engine_url
        return await self.fallback.route_request(
            endpoints, engine_stats, request_stats, request
        )


class PrefixAwareRouter(RoutingInterface):
    """HashTrie longest-prefix-match routing (reference:
    routing_logic.py:379). With a shared cache server configured, a
    trie-cold prompt (this router never saw it — restart, or another
    router replica served the session) probes the cluster cache: a hit
    means ANY engine restores the chain via RemoteTier, so the pick
    goes load-aware off the health scoreboard instead of blind QPS."""

    def __init__(self, prefix_chunk_size: int = 128, tokenizer=None,
                 kv_cache_server_url: str | None = None,
                 kv_cache_block_size: int = 32, **kwargs):
        self.trie = HashTrie(chunk_size=prefix_chunk_size)
        self.tokenizer = tokenizer
        self.cache_hints = (
            SharedCacheHints(kv_cache_server_url, kv_cache_block_size,
                             tokenizer=tokenizer)
            if kv_cache_server_url else None
        )

    async def close(self) -> None:
        if self.cache_hints is not None:
            await self.cache_hints.close()

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        if not endpoints:
            raise RuntimeError("no available endpoints")
        text = request.request_text()
        available = {e.url for e in endpoints}
        matched_chars, candidates = await self.trie.longest_prefix_match(
            text, available
        )
        if candidates and matched_chars > 0:
            cand_eps = [e for e in endpoints if e.url in candidates]
            url = self._qps_routing(cand_eps, request_stats)
        elif (self.cache_hints is not None and text
              and await self.cache_hints.probe_text(
                  _engine_prompt_text(request, self.tokenizer)
              ) > 0):
            # trie-cold but cluster-hot: the chain is one RemoteTier
            # pull away on whichever engine is least loaded
            self.cache_hints.note_routed()
            url = _health_scored_pick(endpoints)
        else:
            url = self._qps_routing(endpoints, request_stats)
        await self.trie.insert(text, url)
        return url

    def on_endpoint_removed(self, url: str) -> None:
        self.trie.remove_endpoint(url)


class DisaggregatedPrefillRouter(RoutingInterface):
    """Pick (prefiller, decoder) pair among labeled endpoints (reference:
    routing_logic.py:432; the two-phase request flow lives in
    services/request_service.py like the reference's request.py:349)."""

    def __init__(self, **kwargs):
        self._prefill_counter = 0
        self._decode_counter = 0

    def _select(self, endpoints: list[EndpointInfo], role: str,
                counter: int) -> EndpointInfo:
        labeled = [
            e for e in endpoints
            if (e.model_label or "").startswith(role)
        ]
        if not labeled:
            raise RuntimeError(f"no {role} endpoints available")
        return sorted(labeled, key=lambda e: e.url)[counter % len(labeled)]

    async def route_prefill_decode(
        self, endpoints: list[EndpointInfo]
    ) -> tuple[str, str]:
        p = self._select(endpoints, "prefill", self._prefill_counter)
        d = self._select(endpoints, "decode", self._decode_counter)
        self._prefill_counter += 1
        self._decode_counter += 1
        return p.url, d.url

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        # non-PD-aware callers get the decode endpoint
        _, decode = await self.route_prefill_decode(endpoints)
        return decode


def _health_scored_pick(endpoints: list[EndpointInfo]) -> str:
    """Health-gated, load-aware pick off the health scoreboard: backends
    with a running consecutive-failure streak (`is_healthy()` False —
    dead pod, wedged engine) are skipped outright, and among the
    healthy rest the lowest EWMA e2e latency wins, scaled by in-flight
    count so a fast-but-loaded backend does not absorb the whole fleet.
    A backend with no completed request yet (fresh pod among measured
    peers) is costed at the FASTEST measured peer's EWMA — it attracts
    traffic until measured, but its in-flight multiplier still engages
    so concurrent picks cannot thundering-herd it; an entirely
    unmeasured fleet ties at 0 and spreads randomly (same cold-start
    behavior as _qps_routing). Shared by the `latency` policy and the
    `pd` policy's per-role pool picks (FlowKV-style load-aware
    scheduling)."""
    from production_stack_tpu_torch.router.stats.health import (
        get_engine_health_board,
    )

    board = get_engine_health_board()
    cands = RoutingInterface._healthy_endpoints(endpoints)
    rows = {ep.url: board.get(ep.url) for ep in cands}
    measured = [
        r.ewma_latency_s for r in rows.values()
        if r is not None and r.ewma_latency_s >= 0
    ]
    # unmeasured backends assume peer speed (TtftRouter's fleet-EWMA
    # philosophy): the in-flight multiplier then still bites
    floor = min(measured) if measured else 0.0

    def score(ep: EndpointInfo) -> tuple[float, int]:
        eng = rows.get(ep.url)
        if eng is None:
            return (floor, 0)
        lat = (
            eng.ewma_latency_s if eng.ewma_latency_s >= 0 else floor
        )
        # expected wait ~ latency x (queue depth + me): prefers an
        # idle slightly-slower backend over a piled-up fast one
        return (lat * (1 + eng.in_flight), eng.in_flight)

    best = min(score(ep) for ep in cands)
    tied = [ep.url for ep in cands if score(ep) == best]
    return random.choice(tied)


class LeastLatencyRouter(RoutingInterface):
    """Health-aware least-latency routing:
    the first policy that actually CONSUMES the EngineHealthBoard the
    proxy hot path feeds — see _health_scored_pick for the scoring."""

    def __init__(self, **kwargs):
        pass

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        if not endpoints:
            raise RuntimeError("no available endpoints")
        return _health_scored_pick(endpoints)


class PDRouter(RoutingInterface):
    """PD-role, prefix-affine data plane ("pd" policy).

    Three routing regimes, per request:

    - **Multi-turn resume (PPD):** the request's text shares a trie
      prefix with an earlier request — the engine that served (and
      therefore holds the session's KV chain in its prefix cache /
      tiers) gets the WHOLE request, single-phase. Its resume prefill
      is a prefix-cache hit, so splitting it across a prefill engine
      would pay a transfer for KV the decode engine already has.
    - **Cold prompt, split fleet:** prefill goes to a prefill-role
      engine, the decode phase to a decode-role engine — each pool
      picked load-aware off the health scoreboard (FlowKV). The decode
      engine pulls the chain from its PD peer via the zero-stall
      PeerTier restore (kv/peer.py).
    - **Cold prompt, degenerate fleet:** when both picks land on the
      same engine (everything "both"-role, or a one-engine pool), the
      handoff is a no-op — serve single-phase.

    The trie maps session text to the engine that ends the turn holding
    the FULL chain (prompt + generated tokens): the decode engine on a
    split, the serving engine otherwise. Roles come from
    EndpointInfo.role (engine-advertised --kv-role, falling back to
    prefill*/decode* model labels)."""

    def __init__(self, prefix_chunk_size: int = 128, **kwargs):
        self.trie = HashTrie(chunk_size=prefix_chunk_size)

    @staticmethod
    def _pool(
        endpoints: list[EndpointInfo], role: str
    ) -> list[EndpointInfo]:
        """Endpoints that can run `role` ("both" engines qualify for
        either); degrades to the full list when nothing is labeled for
        the role — routing somewhere beats routing nowhere."""
        pool = [e for e in endpoints if e.role in (role, "both")]
        return pool or list(endpoints)

    async def plan(
        self, endpoints: list[EndpointInfo], request: RouterRequest
    ) -> tuple[str | None, str]:
        """-> (prefill_url | None, serve_url). None prefill means
        single-phase: serve_url takes the whole request."""
        if not endpoints:
            raise RuntimeError("no available endpoints")
        text = request.request_text()
        available = {e.url for e in endpoints}
        matched, cands = await self.trie.longest_prefix_match(
            text, available
        )
        if matched > 0 and cands:
            # PPD resume: prefix-affine, single-phase (load-aware only
            # among the engines that actually hold the chain)
            aff = [e for e in endpoints if e.url in cands]
            url = _health_scored_pick(aff)
            await self.trie.insert(text, url)
            return None, url
        prefill = _health_scored_pick(self._pool(endpoints, "prefill"))
        decode = _health_scored_pick(self._pool(endpoints, "decode"))
        await self.trie.insert(text, decode)
        if prefill == decode:
            return None, decode
        return prefill, decode

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        # non-PD-aware callers (execute_internal, tests) get the engine
        # that would serve the decode phase
        _, serve = await self.plan(endpoints, request)
        return serve

    def on_endpoint_removed(self, url: str) -> None:
        self.trie.remove_endpoint(url)


class TtftRouter(RoutingInterface):
    """Estimate time-to-first-token per engine and pick the minimum
    (reference: routing_logic.py:475, _estimate_ttft:612, transfer-time
    correction:649). Estimate = queue_drain + uncomputed_tokens/prefill_tps,
    where uncomputed tokens subtract the engine's prefix-cache hit rate."""

    def __init__(
        self,
        kv_controller_url: str | None = None,
        tokenizer=None,
        kv_transfer_gbps: float = 10.0,
        kv_bytes_per_token: int = 114688,
        default_prefill_tps: float = 8000.0,
        **kwargs,
    ):
        self.tokenizer = tokenizer
        self.kv_controller_url = kv_controller_url
        self._kv_client = None
        # bootstrap-only constant: used until the FIRST measured
        # prefill-TPS sample arrives, after which the fleet EWMA below
        # replaces it for engines that lack their own measurement
        # (reference derives prefill TPS from measured request stats,
        # request_stats.py:363-390; ours does too — these fallbacks only
        # cover the cold-start window)
        self.default_prefill_tps = default_prefill_tps
        # fleet-wide EWMA of measured per-engine prefill TPS: a fresh or
        # stat-less engine is assumed to prefill like its (identically
        # provisioned) peers, not like a hardcoded guess
        self._fleet_tps: float | None = None
        # EWMA of routed prompt sizes: a queued request is costed at the
        # measured average prompt / measured TPS instead of a constant
        self._avg_prompt_tokens: float | None = None
        self._ewma_alpha = 0.1
        # transfer-time correction (reference: routing_logic.py:649-676):
        # a prefix cached on a DIFFERENT instance can be pulled over the
        # KV transfer link instead of recomputed; 0 Gbps disables it
        self.kv_transfer_gbps = kv_transfer_gbps
        self.kv_bytes_per_token = kv_bytes_per_token

    async def start(self) -> None:
        if self.kv_controller_url:
            try:
                from production_stack_tpu_torch.kv.controller import (
                    start_or_connect,
                )

                host, _, port = self.kv_controller_url.rpartition(":")
                self._kv_client = await start_or_connect(
                    host or "127.0.0.1", int(port)
                )
            except Exception as e:  # pragma: no cover
                logger.warning(
                    "kv controller connect failed (%s); ttft routing "
                    "continues without kv-match credit", e,
                )
                self._kv_client = None

    async def close(self) -> None:
        if self._kv_client is not None:
            await self._kv_client.close()

    def _count_tokens(self, text: str) -> int:
        if self.tokenizer is not None:
            return len(self.tokenizer.encode(text))
        return max(1, len(text) // 4)  # ~4 chars/token heuristic

    async def _estimate_ttft(
        self,
        ep: EndpointInfo,
        n_tokens: int,
        matched_tokens: int,
        engine_stats: dict[str, EngineStats],
        request_stats: dict[str, RequestStats],
        matched_elsewhere: int = 0,
    ) -> float:
        rs = request_stats.get(ep.url)
        es = engine_stats.get(ep.url)
        if rs and rs.prefill_tps > 0:
            tps = rs.prefill_tps
            # fold every fresh measurement into the fleet estimate
            self._fleet_tps = (
                tps
                if self._fleet_tps is None
                else (1 - self._ewma_alpha) * self._fleet_tps
                + self._ewma_alpha * tps
            )
        elif self._fleet_tps is not None:
            tps = self._fleet_tps  # stat-less engine: assume peer speed
        else:
            tps = self.default_prefill_tps  # cold start, nothing measured
        backlog = rs.uncomputed_prefix_tokens if rs else 0
        queued = es.num_queuing_requests if es else 0
        new_tokens = max(1, n_tokens - matched_tokens)
        # queued requests cost their (measured) average prompt at the
        # engine's (measured) prefill speed; 0.05 s/request only covers
        # the window before any prompt has been observed
        per_queued_s = (
            self._avg_prompt_tokens / tps
            if self._avg_prompt_tokens is not None
            else 0.05
        )
        est = (backlog + new_tokens) / tps + per_queued_s * queued
        # transfer-time correction: tokens cached on another instance can
        # be pulled over the KV link instead of recomputed — credit the
        # cheaper of the two (reference: routing_logic.py:649-676)
        transferable = max(0, matched_elsewhere - matched_tokens)
        if transferable > 0 and self.kv_transfer_gbps > 0:
            compute_s = transferable / tps
            transfer_s = (
                transferable * self.kv_bytes_per_token * 8
                / (self.kv_transfer_gbps * 1e9)
            )
            if transfer_s < compute_s:
                est = est - compute_s + transfer_s
        return est

    async def route_request(self, endpoints, engine_stats, request_stats,
                            request) -> str:
        if not endpoints:
            raise RuntimeError("no available endpoints")
        # health-aware: a TTFT estimate is
        # meaningless for a backend that will refuse the connection —
        # skip scoreboard-unhealthy backends before estimating
        endpoints = self._healthy_endpoints(endpoints)
        text = _engine_prompt_text(request, self.tokenizer)
        n_tokens = self._count_tokens(text)
        # self-observed prompt-size EWMA calibrates the queued-request
        # cost in _estimate_ttft
        self._avg_prompt_tokens = (
            float(n_tokens)
            if self._avg_prompt_tokens is None
            else (1 - self._ewma_alpha) * self._avg_prompt_tokens
            + self._ewma_alpha * n_tokens
        )
        matches: dict[str, int] = {}
        if self._kv_client is not None and text:
            try:
                if self.tokenizer:
                    tokens = self.tokenizer.encode(text)
                else:
                    from production_stack_tpu_torch.engine.tokenizer import (
                        ByteTokenizer,
                    )

                    tokens = ByteTokenizer().encode(text)
                raw = await self._kv_client.lookup(tokens)
                for inst, n in raw.items():
                    url = _match_instance_to_url(inst, endpoints)
                    if url is not None:
                        matches[url] = max(matches.get(url, 0), n)
            except Exception as e:  # noqa: BLE001 — estimate degrades
                logger.debug(
                    "kv lookup failed during ttft estimate (%s); "
                    "estimating without cached-prefix credit", e,
                )
        best_url, best_ttft = None, float("inf")
        for ep in endpoints:
            elsewhere = max(
                (n for url, n in matches.items() if url != ep.url),
                default=0,
            )
            est = await self._estimate_ttft(
                ep, n_tokens, matches.get(ep.url, 0),
                engine_stats, request_stats,
                matched_elsewhere=elsewhere,
            )
            if est < best_ttft:
                best_url, best_ttft = ep.url, est
        assert best_url is not None
        return best_url


# -- singleton lifecycle (reference: routing_logic.py:680-749) --------------
_router: RoutingInterface | None = None

_ROUTERS = {
    RoutingLogic.ROUND_ROBIN: RoundRobinRouter,
    RoutingLogic.SESSION_BASED: SessionRouter,
    RoutingLogic.KVAWARE: KvawareRouter,
    RoutingLogic.PREFIXAWARE: PrefixAwareRouter,
    RoutingLogic.DISAGGREGATED_PREFILL: DisaggregatedPrefillRouter,
    RoutingLogic.TTFT: TtftRouter,
    RoutingLogic.LEAST_LATENCY: LeastLatencyRouter,
    RoutingLogic.PD: PDRouter,
}


def initialize_routing_logic(
    routing_logic: RoutingLogic | str, **kwargs
) -> RoutingInterface:
    global _router
    logic = RoutingLogic(routing_logic)
    _router = _ROUTERS[logic](**kwargs)
    logger.info("initialized routing logic: %s", logic.value)
    return _router


async def reconfigure_routing_logic(
    routing_logic: RoutingLogic | str, **kwargs
) -> RoutingInterface:
    global _router
    old = _router
    new = initialize_routing_logic(routing_logic, **kwargs)
    await new.start()
    if old is not None:
        await old.close()
    return new


def get_routing_logic() -> RoutingInterface:
    if _router is None:
        raise RuntimeError("routing logic not initialized")
    return _router


def _reset_routing_logic() -> None:
    global _router
    _router = None
