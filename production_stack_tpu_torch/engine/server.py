"""OpenAI-compatible HTTP server for the PyTorch engine, on stdlib asyncio.

Counterpart of ``production_stack_tpu/engine/server.py`` for the
endpoints the port serves: ``/health``, ``/version``, ``/v1/models``
(with ``max_model_len`` and the PD role, then one card a loaded LoRA
adapter), ``/v1/completions`` (a string, a token-id list, or a batch of
either; ``n``, ``best_of`` = n, ``echo``, ``prompt_logprobs``) and
``/v1/chat/completions`` (``tools`` with a named ``tool_choice``, or
``auto`` under ``--enable-auto-tool-choice``, parsed into OpenAI
``tool_calls``; ``n``), both with ``stream`` and the guided-decoding
fields (``guided_json`` / ``guided_regex`` / ``guided_choice`` /
``guided_grammar`` / ``response_format``); a ``model`` naming a loaded
adapter is served with it. ``/v1/embeddings`` (mean-pooled, normalised
final hidden states), ``/v1/rerank`` (also ``/rerank``) and ``/v1/score``
(also ``/score``), which score by the cosine of those embeddings; each
text is embedded under the step lock on its own, off the event loop.
``/tokenize`` and ``/detokenize``; ``/sleep``,
``/wake_up`` and ``/is_sleeping`` (the router's service discovery probes
them); ``/debug/requests`` (the per-request lifecycle timelines);
``POST /v1/load_lora_adapter`` and ``/v1/unload_lora_adapter`` (the
operator's LoraAdapter controller calls them), ``/metrics`` (the JAX
engine's families the port serves, written by engine/metrics.py: the
``vllm:*`` families the router scrapes, request latency histograms and
the ``tpu:*`` prefill, staging, decode, ragged-round and compile-event
families), and
``/debug/kernel_launches``, which reads (GET) or zeroes (DELETE) the
attention kernels' launch counts and the runner's forward dispatches. A
router-supplied ``x-request-id`` becomes the engine's request id and is
echoed on the response; ``traceparent`` rides into the request's
timeline. A prefill (or both-role) engine with
``kv_transfer_config["listen"]`` also serves its KV block chains to
decode peers (kv/transfer.py), and a watched stats task feeds the KV and
lane-mix histograms. ``precompile_serving`` runs every serving program
once at construction, before the server listens. Over a rank set
(``tensor_parallel_size`` x ``pipeline_parallel_size`` N > 1) the
server, scheduler and metrics live on rank 0 (this process; the engine
starts ranks 1..N-1, or process 0's share of a multi-host job's), a
watched task
logs a follower's death, ``/health`` answers 503 from then on, and
``stop`` stops the followers. The Prometheus text is written by hand and
HTTP/1.1 is parsed by hand (``asyncio.start_server``, the reader in
``utils/http.py``, which the router shares): the port needs neither
aiohttp nor prometheus_client. A connection serves requests one after
another, as aiohttp's server does, until the client asks to close it
or sits idle for ``http.KEEPALIVE_TIMEOUT_S``; streamed bodies are
server-sent events in chunked encoding, ended by its last chunk, and
``/debug/connections`` counts the connections accepted and the requests
served on them. ``run`` serves until SIGINT or SIGTERM, then
stops as aiohttp's ``web.run_app`` does: it stops listening, lets the
requests in flight finish within ``SHUTDOWN_TIMEOUT_S`` (cancelling what
is left after it), and runs ``stop``, which ends in the engine's
shutdown.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hmac
import json
import signal
import time

import production_stack_tpu_torch
from production_stack_tpu_torch.engine import protocol as proto
from production_stack_tpu_torch.engine import tools
from production_stack_tpu_torch.engine.async_engine import (
    AsyncLLMEngine,
    EngineSleepingError,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.metrics import EngineMetrics
from production_stack_tpu_torch.engine.sampling_params import (
    SamplingParams,
    truncate_prompt,
)
from production_stack_tpu_torch.ops import paged_attention
from production_stack_tpu_torch.tracing import (
    REQUEST_ID_HEADER,
    TRACEPARENT_HEADER,
    debug_requests_payload,
    log_otlp_payload,
    otlp_flush_loop,
    valid_request_id,
)
from production_stack_tpu_torch.utils import init_logger
from production_stack_tpu_torch.utils.http import (
    KEEPALIVE_TIMEOUT_S,
    BadHttpMessage,
    HttpError,
    HttpRequest,
    head,
    read_request,
)
from production_stack_tpu_torch.utils.tasks import spawn_watched

logger = init_logger(__name__)

STATS_UPDATE_INTERVAL_S = 1.0
# how often the tensor-parallel follower watch looks at the rank set
TP_WATCH_INTERVAL_S = 1.0
# how long a signalled stop waits for the requests in flight (aiohttp's
# run_app default shutdown_timeout)
SHUTDOWN_TIMEOUT_S = 60.0
# paths behind --api-key besides /v1/* (the JAX server's list)
_AUTH_PATHS = ("/tokenize", "/detokenize", "/sleep", "/wake_up", "/rerank",
               "/score")


def _key_matches(auth: str, api_key: str) -> bool:
    """The reference's bearer check: bytes compared in constant time
    (compare_digest refuses non-ASCII str; the header's bytes come back
    through utf-8 with surrogateescape, as they were read)."""
    return hmac.compare_digest(auth.encode("utf-8", "surrogateescape"),
                               f"Bearer {api_key}".encode())


class EngineServer:
    def __init__(self, config: EngineConfig, params: dict | None = None):
        self.config = config
        self.engine = AsyncLLMEngine(config, params=params)
        if config.precompile_serving:
            # before the step loop starts and before anything listens, so
            # /health turns ok only once every serving program ran
            t0 = time.perf_counter()
            eng = self.engine.engine
            n = eng.precompile_serving()
            rnr = eng.runner
            if eng.tp_group is not None:
                # a rank-set runner is eager: its sweeps build nothing
                logger.info(
                    "serving precompile: %d dispatches in %.1fs on each "
                    "of the %d ranks; the eager programs warmed, no "
                    "program variant built and no CUDA graph captured (a "
                    "rank set runs eagerly)",
                    n, time.perf_counter() - t0, eng.tp_group.world_size,
                )
            else:
                logger.info(
                    "serving precompile: %d dispatches in %.1fs; program "
                    "variants built %s, graph pool %.1f MiB, static "
                    "inputs %.1f MiB, pool reserve %.1f MiB (only "
                    "request-dependent variants can still build lazily)",
                    n, time.perf_counter() - t0, rnr.compile_events,
                    rnr.graph_pool_bytes() / 2**20,
                    rnr.static_input_bytes() / 2**20,
                    rnr._graph_pool_reserve() / 2**20,
                )
        self.model_name = config.served_model_name or config.model
        self.max_model_len = config.resolved_max_model_len()
        self.metrics = EngineMetrics(self.model_name)
        self.lora_adapters: dict[str, str] = {}  # name -> path
        self._server: asyncio.AbstractServer | None = None
        self._stats_task: asyncio.Task | None = None
        self._trace_flush_task: asyncio.Task | None = None
        self._tp_watch_task: asyncio.Task | None = None
        self._kv_transfer_server = None
        # the connections serving a request (a signalled stop drains
        # them), the ones waiting for their next request (a stop closes
        # them), and the counts /debug/connections reads
        self._inflight: set[asyncio.Task] = set()
        self._idle: set[asyncio.StreamWriter] = set()
        self._closing = False
        self.connections_accepted = 0
        self.requests_served = 0
        self._routes = {
            ("GET", "/health"): self.handle_health,
            ("GET", "/version"): self.handle_version,
            ("GET", "/v1/models"): self.handle_models,
            ("GET", "/metrics"): self.handle_metrics,
            ("POST", "/v1/completions"): self.handle_completions,
            ("POST", "/v1/chat/completions"): self.handle_chat,
            ("POST", "/v1/embeddings"): self.handle_embeddings,
            ("POST", "/v1/rerank"): self.handle_rerank,
            ("POST", "/rerank"): self.handle_rerank,
            ("POST", "/v1/score"): self.handle_score,
            ("POST", "/score"): self.handle_score,
            ("POST", "/tokenize"): self.handle_tokenize,
            ("POST", "/detokenize"): self.handle_detokenize,
            ("GET", "/debug/requests"): self.handle_debug_requests,
            ("POST", "/sleep"): self.handle_sleep,
            ("POST", "/wake_up"): self.handle_wake,
            ("GET", "/is_sleeping"): self.handle_is_sleeping,
            ("POST", "/v1/load_lora_adapter"): self.handle_load_lora,
            ("POST", "/v1/unload_lora_adapter"): self.handle_unload_lora,
            ("GET", "/debug/kernel_launches"): self.handle_kernel_launches,
            ("DELETE", "/debug/kernel_launches"):
                self.handle_reset_kernel_launches,
            ("GET", "/debug/connections"): self.handle_connections,
        }

    # -- lifecycle ---------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the step loop and listen; returns the bound port."""
        self.engine.start(asyncio.get_running_loop())
        self._stats_task = spawn_watched(self._stats_loop(), "engine-stats")
        if self.engine.engine.tp_group is not None:
            self._tp_watch_task = spawn_watched(self._tp_watch_loop(),
                                                "tp-follower-watch")
        if self.engine.tracer.exporter == "otlp":
            self._trace_flush_task = spawn_watched(
                otlp_flush_loop(self.engine.tracer), "engine-trace-flush")
        # disaggregated prefill producer: serve KV block chains to decode
        # peers. prefill AND both roles serve — a both-role engine can
        # hand its chains to any peer.
        listen = (self.config.kv_transfer_config or {}).get("listen")
        if listen and self.config.pd_role() in ("prefill", "both"):
            from production_stack_tpu_torch.kv import transfer
            from production_stack_tpu_torch.kv.wire import parse_addr

            kv_host, kv_port = parse_addr(listen, transfer.DEFAULT_PORT)
            self._kv_transfer_server = transfer.KVTransferServer(self.engine)
            await self._kv_transfer_server.start(kv_host or "0.0.0.0",
                                                 kv_port)
        self._server = await asyncio.start_server(self._handle, host, port)
        bound = self._server.sockets[0].getsockname()[1]
        logger.info("serving %s on http://%s:%d", self.model_name, host,
                    bound)
        return bound

    async def stop(self) -> None:
        if self._stats_task is not None:
            self._stats_task.cancel()
            self._stats_task = None
        if self._tp_watch_task is not None:
            self._tp_watch_task.cancel()
            self._tp_watch_task = None
        if self._trace_flush_task is not None:
            self._trace_flush_task.cancel()
            self._trace_flush_task = None
            # final drain: spans still buffered must not be dropped
            log_otlp_payload(self.engine.tracer)
        if self._server is not None:
            self._server.close()
            self._close_idle()
            await self._server.wait_closed()
        if self._kv_transfer_server is not None:
            # its stop waits for the peers' connections to close; a decode
            # engine that stays up must not hold this server's shutdown
            try:
                await asyncio.wait_for(self._kv_transfer_server.stop(), 5)
            except asyncio.TimeoutError:
                logger.warning("kv-transfer server: peers still connected "
                               "at shutdown")
            self._kv_transfer_server = None
        self.engine.shutdown()

    def _drain_observations(self) -> None:
        self.metrics.observe_kv(*self.engine.drain_kv_observations())
        self.metrics.observe_ragged(self.engine.drain_ragged_observations())

    async def _stats_loop(self) -> None:
        """Drain the engine's KV export / restore and ragged lane-mix
        observations into their histograms (the snapshot families are
        rendered at each scrape)."""
        while True:
            self._drain_observations()
            await asyncio.sleep(STATS_UPDATE_INTERVAL_S)

    async def _tp_watch_loop(self) -> None:
        """Log once when the tensor-parallel rank set fails (a follower
        died, or a broadcast dispatch raised); /health reads the same
        state on every probe."""
        while self.engine.engine.tp_alive():
            await asyncio.sleep(TP_WATCH_INTERVAL_S)
        logger.error("tensor-parallel rank set failed: /health now "
                     "answers 503")

    async def drain(self, timeout: float = SHUTDOWN_TIMEOUT_S) -> int:
        """Stop accepting connections and let the requests in flight
        finish within `timeout` seconds; the ones still running then are
        cancelled. Returns how many were cancelled."""
        if self._server is not None:
            self._server.close()
        self._close_idle()
        pending = {t for t in self._inflight if not t.done()}
        if pending:
            logger.info("stopping: %d request(s) in flight, waiting up to "
                        "%.0fs", len(pending), timeout)
            _, pending = await asyncio.wait(pending, timeout=timeout)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.wait(pending)
        return len(pending)

    def run(self, host: str = "0.0.0.0", port: int = 8000,
            shutdown_timeout: float = SHUTDOWN_TIMEOUT_S) -> None:
        """Serve until SIGINT or SIGTERM, then drain and stop (aiohttp's
        web.run_app order)."""

        async def main():
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            try:
                await self.start(host, port)
                await stop.wait()
                await self.drain(shutdown_timeout)
            finally:
                await self.stop()
            logger.info("engine server stopped")

        asyncio.run(main())

    def _close_idle(self) -> None:
        """Serve no further request: idle connections close now, busy
        ones after their response."""
        self._closing = True
        for writer in list(self._idle):
            writer.close()

    # -- HTTP plumbing -----------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """One client connection: requests one after another while the
        client keeps it alive (idle connections close at a stop)."""
        self.connections_accepted += 1
        conn = _Conn(writer)
        try:
            while not self._closing:
                self._idle.add(writer)
                try:
                    method, path, req = await read_request(
                        reader, idle_timeout=KEEPALIVE_TIMEOUT_S)
                except BadHttpMessage as e:
                    await _send(conn, 400, str(e).encode(),
                                "text/plain; charset=utf-8")
                    return
                except HttpError as e:
                    await _send_json(conn, e.status, proto.error_json(
                        str(e), code=e.status))
                    return
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionError):
                    return
                finally:
                    self._idle.discard(writer)
                conn.keep = req.keep_alive and not self._closing
                task = asyncio.current_task()
                self._inflight.add(task)
                try:
                    await self._serve(method, path, req, conn)
                finally:
                    self._inflight.discard(task)
                self.requests_served += 1
                if conn.open or not conn.keep:
                    return
        except ConnectionError:
            pass  # the client went away mid-response
        except Exception:  # noqa: BLE001 — one request, not the server
            logger.exception("request failed")
        finally:
            self._idle.discard(writer)
            writer.close()

    async def _serve(self, method: str, path: str, req: HttpRequest,
                     conn: "_Conn") -> None:
        """Answer one request on `conn`. An error after a streamed
        response began cannot be answered: the connection then closes."""
        if self.config.api_key and (
            path.startswith("/v1/") or path in _AUTH_PATHS
        ) and not _key_matches(req.headers.get("authorization", ""),
                               self.config.api_key):
            # before the route lookup: an unknown /v1/ path answers
            # 401 too, as the reference's middleware does
            await _send_json(conn, 401, proto.error_json(
                "invalid API key", "authentication_error", 401))
            return
        handler = self._routes.get((method, path))
        if handler is None:
            known = any(p == path for _, p in self._routes)
            status = 405 if known else 404
            await _send_json(conn, status, proto.error_json(
                f"{method} {path} not served", code=status))
            return
        try:
            await handler(req, conn)
        except HttpError as e:
            await _send_json(conn, e.status, proto.error_json(
                str(e), e.err_type, e.status))
        except proto.ProtocolError as e:
            await _send_json(conn, 400, proto.error_json(str(e)))
        except NotImplementedError as e:
            await _send_json(conn, 501, proto.error_json(
                str(e), "not_implemented", 501))
        except EngineSleepingError as e:
            await _send_json(conn, 503, proto.error_json(
                str(e), "service_unavailable", 503))
        except ValueError as e:
            await _send_json(conn, 400, proto.error_json(str(e)))
        except KeyError as e:  # an adapter unloaded since the check
            await _send_json(conn, 404, proto.error_json(
                str(e.args[0]) if e.args else str(e), code=404))

    async def handle_connections(self, req, writer) -> None:
        """The connections this server accepted and the requests it
        served on them (a client that keeps its connections alive makes
        fewer of the first)."""
        await _send_json(writer, 200, {
            "accepted": self.connections_accepted,
            "requests": self.requests_served})

    # -- endpoints ---------------------------------------------------------
    async def handle_health(self, req, writer) -> None:
        if not self.engine.engine.tp_alive():
            await _send_json(writer, 503, {
                "status": "unhealthy",
                "reason": "a tensor-parallel rank failed"})
            return
        await _send_json(writer, 200, {"status": "healthy"})

    async def handle_version(self, req, writer) -> None:
        await _send_json(writer, 200, {
            "version": production_stack_tpu_torch.__version__})

    async def handle_models(self, req, writer) -> None:
        card = proto.model_card(
            self.model_name, root=self.config.model,
            kv_instance_id=self.config.kv_instance_id,
            kv_role=self.config.pd_role(),
            max_model_len=self.max_model_len,
            # the ring size, while the long-prefill lane is live
            sp_size=(self.config.context_parallel_size
                     if self.engine.engine.long_prefill is not None
                     else None),
        )
        cards = [card] + [proto.model_card(name, root=path)
                          for name, path in self.lora_adapters.items()]
        await _send_json(writer, 200, {"object": "list", "data": cards})

    async def handle_metrics(self, req, writer) -> None:
        self._drain_observations()
        payload = self.metrics.render(self.engine.stats()).encode()
        await _send(writer, 200, payload,
                    "text/plain; version=0.0.4; charset=utf-8")

    async def handle_tokenize(self, req, writer) -> None:
        body = _json(req.body)
        tok = self.engine.tokenizer
        if "prompt" in body:
            text = body["prompt"]
        elif "messages" in body:
            text = tok.apply_chat_template(body["messages"])
        else:
            raise HttpError(400, "missing 'prompt' or 'messages'")
        ids = tok.encode(text)
        await _send_json(writer, 200, {"tokens": ids, "count": len(ids),
                                       "max_model_len": self.max_model_len})

    async def handle_detokenize(self, req, writer) -> None:
        tokens = _json(req.body).get("tokens")
        if tokens is None:
            raise HttpError(400, "missing 'tokens'")
        await _send_json(writer, 200, {
            "prompt": self.engine.tokenizer.decode(tokens)})

    async def handle_debug_requests(self, req, writer) -> None:
        """Recent request lifecycle timelines (a bounded ring) and the
        in-flight ones: enqueue -> admit -> prefill chunks (staged /
        chained flags) -> first token -> sampled decode rounds ->
        preempt / resume -> finish. ?limit=N caps the finished ones."""
        recorder = self.engine.timeline
        await _send_json(writer, 200, debug_requests_payload(
            req.query.get("limit"),
            enabled=recorder.enabled,
            snapshot=lambda n: recorder.snapshot(limit=n),
            hint="start the engine with request_timeline=True (drop "
                 "--no-request-timeline) to record per-request "
                 "lifecycle timelines",
        ))

    # -- sleep / wake (the router's service discovery probes these) --------
    async def handle_sleep(self, req, writer) -> None:
        try:
            level = int(req.query.get("level", "1"))
        except ValueError:
            raise HttpError(400, "level must be an integer") from None
        self.engine.sleep(level)
        await _send_json(writer, 200, {"status": "sleeping",
                                       "level": level})

    async def handle_wake(self, req, writer) -> None:
        self.engine.wake_up()
        await _send_json(writer, 200, {"status": "awake"})

    async def handle_is_sleeping(self, req, writer) -> None:
        await _send_json(writer, 200,
                         {"is_sleeping": self.engine.is_sleeping()})

    def _launch_report(self) -> dict:
        return {
            "launches": paged_attention.launch_counts(),
            "dispatches": dict(self.engine.engine.runner.dispatch_counts),
        }

    async def handle_kernel_launches(self, req, writer) -> None:
        """Kernel launches (counted only where a CUDA kernel launched) and
        forward dispatches since boot or the last DELETE: shows a driver
        which kernels served its requests."""
        await _send_json(writer, 200, self._launch_report())

    async def handle_reset_kernel_launches(self, req, writer) -> None:
        paged_attention.reset_launch_counts()
        counts = self.engine.engine.runner.dispatch_counts
        for k in counts:
            counts[k] = 0
        await _send_json(writer, 200, self._launch_report())

    # -- request identity + trace context ----------------------------------
    def _request_identity(self, req: HttpRequest,
                          prefix: str) -> tuple[str, str | None]:
        """(request_id, traceparent) of one HTTP request. A
        router-supplied x-request-id becomes the engine's request id (and
        is echoed on the response) so logs, spans and timelines join on
        one id; an id that fails the charset / length gate, or is still
        in flight (alone or as an n > 1 request's `<id>-c<i>`), falls
        back to a fresh one. The traceparent passes through verbatim
        (the timeline recorder validates it)."""
        rid = req.headers.get(REQUEST_ID_HEADER)
        if (not valid_request_id(rid) or self.engine.has_request(rid)
                or self.engine.has_request_prefix(rid)):
            rid = proto.make_id(prefix)
        return rid, req.headers.get(TRACEPARENT_HEADER)

    def _prompt_ids(self, ids: list[int], sp: SamplingParams) -> list[int]:
        """vLLM truncate_prompt_tokens, then the context-length gate:
        a prompt the KV layout cannot hold is refused before admission
        with vLLM's wording and error type."""
        ids = truncate_prompt(ids, sp, self.max_model_len)
        if len(ids) >= self.max_model_len:
            raise HttpError(
                400, f"This model's maximum context length is "
                f"{self.max_model_len} tokens. However, your request has "
                f"{len(ids)} prompt tokens; please reduce the length of "
                "the messages or prompt.", "context_length_exceeded")
        return ids

    def _lora_name(self, req: dict) -> str | None:
        model = req.get("model")
        return model if model in self.lora_adapters else None

    @staticmethod
    def _priority(req: dict) -> int:
        try:
            return int(req.get("priority", 0))
        except (TypeError, ValueError):
            raise HttpError(400, "priority must be an integer") from None

    async def handle_completions(self, req, writer) -> None:
        body = _json(req.body)
        self._check_model(body)
        prompt = body.get("prompt")
        if prompt is None:
            raise HttpError(400, "missing 'prompt'")
        # OpenAI batches: one string, one token-id list, or a list of
        # either (choice index = prompt_idx * n + sample)
        if isinstance(prompt, str):
            raw_prompts: list = [prompt]
        elif isinstance(prompt, list) and prompt and all(
            isinstance(x, int) for x in prompt
        ):
            raw_prompts = [prompt]
        elif isinstance(prompt, list) and prompt and all(
            isinstance(x, str) or (isinstance(x, list) and x and all(
                isinstance(t, int) for t in x))
            for x in prompt
        ):
            raw_prompts = list(prompt)
        else:
            raise HttpError(400, "'prompt' must be a string, a token-id "
                            "list, or a non-empty list of either")
        sp = proto.sampling_params_from_request(body)
        if body.get("suffix"):
            raise HttpError(400, "suffix is not supported")
        best_of = body.get("best_of")
        try:
            best_of = int(best_of) if best_of is not None else None
        except (TypeError, ValueError):
            raise HttpError(400, "best_of must be an integer") from None
        if best_of is not None and best_of != sp.n:
            raise HttpError(
                400, "best_of != n is not supported (use n-way sampling)")
        priority = self._priority(body)
        echo = bool(body.get("echo", False))
        if echo and sp.logprobs is not None:
            raise HttpError(400, "echo with logprobs is not supported; "
                            "request prompt_logprobs for per-prompt-token "
                            "logprobs")
        request_id, traceparent = self._request_identity(req, "cmpl")
        ids_list = [
            self._prompt_ids(list(p) if isinstance(p, list)
                             else self.engine.tokenizer.encode(p), sp)
            for p in raw_prompts
        ]
        # OpenAI echo: the text leads with the prompt the engine
        # processed (a string prompt echoes verbatim unless truncated)
        echoes = None
        if echo:
            echoes = [
                p if (isinstance(p, str)
                      and sp.truncate_prompt_tokens is None)
                else self.engine.tokenizer.decode(list(ids))
                for p, ids in zip(raw_prompts, ids_list)
            ]
        job = _Job(request_id, body.get("model") or self.model_name,
                   chat=False, sp=sp, lora_name=self._lora_name(body),
                   priority=priority, traceparent=traceparent,
                   as_ids=bool(body.get("return_tokens_as_token_ids")))
        if len(ids_list) * sp.n > 1:
            await self._multi_completion(
                job, ids_list, writer, bool(body.get("stream")),
                _wants_usage(body), echoes=echoes)
        elif body.get("stream"):
            await self._stream_completion(
                job, ids_list[0], writer, _wants_usage(body),
                echo=echoes[0] if echoes else None)
        else:
            await self._blocking_completion(
                job, ids_list[0], writer,
                echo=echoes[0] if echoes else None)

    async def handle_chat(self, req, writer) -> None:
        body = _json(req.body)
        self._check_model(body)
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise HttpError(400, "'messages' must be a non-empty list")
        req_tools = body.get("tools")
        tool_choice = body.get("tool_choice",
                               "auto" if req_tools else "none")
        use_tools = bool(req_tools) and tool_choice != "none"
        if (use_tools and tool_choice == "auto"
                and not self.config.enable_auto_tool_choice):
            raise HttpError(400, "tools require --enable-auto-tool-choice "
                            "(or a named tool_choice)")
        if use_tools:
            messages = tools.inject_tools(messages, req_tools, tool_choice)
        try:
            prompt = self.engine.tokenizer.apply_chat_template(messages)
        except Exception as e:  # noqa: BLE001 — a template error is the
            # request's fault, whatever the template raised
            raise HttpError(400, f"chat template error: {e}") from None
        sp = proto.sampling_params_from_request(body)
        if body.get("logprobs") is True:
            # chat form: logprobs: true + top_logprobs: N
            top_n = int(body.get("top_logprobs", 0) or 0)
            if not 0 <= top_n <= 20:
                raise HttpError(400, "top_logprobs must be in [0, 20]")
            sp = dataclasses.replace(sp, logprobs=top_n)
        request_id, traceparent = self._request_identity(req, "chatcmpl")
        ids = self._prompt_ids(self.engine.tokenizer.encode(prompt), sp)
        job = _Job(request_id, body.get("model") or self.model_name,
                   chat=True, sp=sp, lora_name=self._lora_name(body),
                   priority=self._priority(body), traceparent=traceparent,
                   parse_tools=use_tools)
        if sp.n > 1:
            await self._multi_completion(
                job, [ids], writer, bool(body.get("stream")),
                _wants_usage(body))
        elif body.get("stream"):
            # a streamed response passes tool-call text through verbatim
            # (the client parses it); the blocking one parses
            await self._stream_completion(job, ids, writer,
                                          _wants_usage(body))
        else:
            await self._blocking_completion(job, ids, writer)

    # -- embeddings, rerank and score ----------------------------------------
    # A decoder engine embeds by mean-pooling its final hidden state
    # (LLMEngine.embed_one) and scores rerank / score pairs by the cosine
    # of those embeddings, as the JAX server does: the API contract and
    # the ordering hold; a cross-encoder would give calibrated scores.
    def _embed_texts(self, texts: list[str], lora_name: str | None):
        """-> (vectors, prompt tokens). One text per acquisition of the
        step lock, so an in-flight decode batch waits for one embedding
        forward at most, never for the whole list. Runs off the event
        loop (run_in_executor)."""
        vecs, n_tokens = [], 0
        for t in texts:
            with self.engine._lock:
                vec, count = self.engine.engine.embed_one(t, lora_name)
            vecs.append(vec)
            n_tokens += count
        return vecs, n_tokens

    async def _embed(self, texts: list[str], model: str):
        lora_name = model if model in self.lora_adapters else None
        return await asyncio.get_running_loop().run_in_executor(
            None, self._embed_texts, texts, lora_name)

    async def handle_embeddings(self, req, writer) -> None:
        body = _json(req.body)
        self._check_model(body)
        model = body.get("model", self.model_name)
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if (not isinstance(inputs, list) or not inputs
                or not all(isinstance(x, str) for x in inputs)):
            raise HttpError(400, "'input' must be a non-empty string or "
                            "list of strings")
        vecs, n_tokens = await self._embed(inputs, model)
        await _send_json(writer, 200, {
            "object": "list",
            "model": model,
            "data": [{"object": "embedding", "index": i,
                      "embedding": v.tolist()}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        })

    async def handle_rerank(self, req, writer) -> None:
        """Jina / Cohere-style rerank: query + documents -> the documents
        by descending score, the first top_n."""
        body = _json(req.body)
        self._check_model(body)
        query, docs = body.get("query"), body.get("documents")
        if (not isinstance(query, str) or not isinstance(docs, list)
                or not docs or not all(isinstance(d, str) for d in docs)):
            raise HttpError(400, "'query' must be a string and "
                            "'documents' a non-empty list of strings")
        model = body.get("model", self.model_name)
        top_n = body.get("top_n", len(docs))
        if isinstance(top_n, bool) or not isinstance(top_n, int) \
                or top_n < 0:
            raise HttpError(400, "'top_n' must be a non-negative integer")
        vecs, n_tokens = await self._embed([query] + docs, model)
        q = vecs[0]
        scored = sorted(
            ({"index": i, "relevance_score": float(q @ v),
              "document": {"text": docs[i]}}
             for i, v in enumerate(vecs[1:])),
            key=lambda r: -r["relevance_score"],
        )[:top_n]
        await _send_json(writer, 200, {
            "id": proto.make_id("rerank"),
            "model": model,
            "results": scored,
            "usage": {"total_tokens": n_tokens},
        })

    async def handle_score(self, req, writer) -> None:
        """vLLM-style /v1/score: text_1 x text_2 similarity, broadcast
        1xM, Nx1 or paired NxN; each distinct text is embedded once."""
        body = _json(req.body)
        self._check_model(body)
        t1, t2 = body.get("text_1"), body.get("text_2")
        t1 = [t1] if isinstance(t1, str) else t1
        t2 = [t2] if isinstance(t2, str) else t2
        if not (isinstance(t1, list) and isinstance(t2, list) and t1 and t2
                and all(isinstance(x, str) for x in t1 + t2)
                and (len(t1) == 1 or len(t2) == 1 or len(t1) == len(t2))):
            raise HttpError(400, "'text_1'/'text_2' must be strings or "
                            "lists of strings with broadcastable lengths "
                            "(1xM, Nx1, NxN)")
        if len(t1) == 1:
            pairs = [(t1[0], x) for x in t2]
        elif len(t2) == 1:
            pairs = [(x, t2[0]) for x in t1]
        else:
            pairs = list(zip(t1, t2))
        model = body.get("model", self.model_name)
        uniq = list(dict.fromkeys(t for p in pairs for t in p))
        vecs, n_tokens = await self._embed(uniq, model)
        by_text = dict(zip(uniq, vecs))
        await _send_json(writer, 200, {
            "id": proto.make_id("score"),
            "object": "list",
            "model": model,
            "data": [{"object": "score", "index": i,
                      "score": float(by_text[a] @ by_text[b])}
                     for i, (a, b) in enumerate(pairs)],
            "usage": {"total_tokens": n_tokens},
        })

    # -- LoRA hot-load (reference: loraadapter_controller.go:582-598 POSTs) -
    async def handle_load_lora(self, req, writer) -> None:
        body = _json(req.body)
        name, path = body.get("lora_name"), body.get("lora_path")
        if not name or not path:
            raise HttpError(400, "need lora_name and lora_path")
        loop = asyncio.get_running_loop()
        try:
            # the file read and the slot write wait for the step lock:
            # off the event loop
            await loop.run_in_executor(None, self.engine.load_lora, name,
                                       path)
        except (OSError, ValueError, RuntimeError, KeyError) as e:
            # a missing or malformed file, a full slot table
            raise HttpError(500, f"failed to load adapter: {e}") from None
        self.lora_adapters[name] = path
        logger.info("loaded LoRA adapter %s from %s", name, path)
        await _send_json(writer, 200, {"status": "success"})

    async def handle_unload_lora(self, req, writer) -> None:
        name = _json(req.body).get("lora_name")
        if name not in self.lora_adapters:
            raise HttpError(404, f"adapter {name!r} not loaded")
        await asyncio.get_running_loop().run_in_executor(
            None, self.engine.unload_lora, name)
        del self.lora_adapters[name]
        await _send_json(writer, 200, {"status": "success"})

    # -- shared generation paths -------------------------------------------
    def _check_model(self, req: dict) -> None:
        model = req.get("model")
        if model is not None and model not in (
            self.model_name, self.config.model
        ) and model not in self.lora_adapters:
            raise HttpError(404, f"model {model!r} is not served here")

    def _generate(self, job: "_Job", request_id: str, ids: list[int],
                  sp: SamplingParams):
        return self.engine.generate(
            request_id, prompt_token_ids=ids, sampling_params=sp,
            lora_name=job.lora_name, priority=job.priority,
            traceparent=job.traceparent,
        )

    def _choice(self, job: "_Job", index: int, final, echo: str = "") -> dict:
        """One finished choice in the response's wire shape (chat message
        with parsed tool calls, or completion text), logprobs and
        prompt_logprobs attached."""
        if job.chat:
            text, calls = final.text, None
            if job.parse_tools:
                text, calls = tools.parse_tool_calls(final.text)
            choice = proto.chat_message_choice(
                index, text, final.finish_reason, calls)
            choice["logprobs"] = self._chat_logprobs(final.logprobs)
        else:
            choice = {
                "index": index, "text": echo + final.text,
                "logprobs": self._completion_logprobs(final.logprobs,
                                                      job.as_ids),
                "finish_reason": final.finish_reason,
            }
        if final.prompt_logprobs is not None:
            # vLLM field: one entry a prompt position, None first
            choice["prompt_logprobs"] = final.prompt_logprobs
        return choice

    async def _blocking_completion(self, job: "_Job", ids: list[int],
                                   writer, echo: str | None = None) -> None:
        arrival = time.time()
        final = None
        async for out in self._generate(job, job.request_id, ids, job.sp):
            final = out
        self.metrics.observe_finish(final, arrival)
        if final.finish_reason == "error":
            raise HttpError(500, "engine step failed")
        resp = proto.multi_choice_response(
            job.request_id, job.model, job.chat,
            [self._choice(job, 0, final, echo or "")],
            len(final.prompt_token_ids), len(final.token_ids))
        await _send_json(writer, 200, resp, job.headers())

    async def _multi_completion(self, job: "_Job", ids_list, writer,
                                stream: bool, include_usage: bool,
                                echoes: list[str] | None = None) -> None:
        """Batched prompts and / or n > 1: every choice is an engine
        sub-request `<id>-c<index>` (continuous batching runs them
        together), index = prompt_idx * n + sample_idx; an explicit seed
        gives sample j the seed + j, so samples differ but reproduce."""
        arrival = time.time()
        sp, n = job.sp, job.sp.n
        plan = []
        for pi, ids in enumerate(ids_list):
            for j in range(n):
                sp_j = (dataclasses.replace(sp, seed=sp.seed + j)
                        if n > 1 and sp.seed is not None else sp)
                plan.append((pi * n + j, sp_j, ids))
        n_prompt = sum(len(ids) for ids in ids_list)

        if not stream:
            async def run_one(idx, sp_i, ids):
                final = None
                async for out in self._generate(
                        job, f"{job.request_id}-c{idx}", ids, sp_i):
                    final = out
                return final

            tasks = [asyncio.ensure_future(run_one(*p)) for p in plan]
            try:
                finals = await asyncio.gather(*tasks)
            except BaseException:
                # any failure cancels the siblings: their generate()
                # finalizers abort the engine requests, so no orphan
                # keeps decoding after the error response
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
            choices = []
            for (idx, _, _), final in zip(plan, finals):
                self.metrics.observe_finish(final, arrival)
                choices.append(self._choice(
                    job, idx, final, echoes[idx // n] if echoes else ""))
            await _send_json(writer, 200, proto.multi_choice_response(
                job.request_id, job.model, job.chat, choices, n_prompt,
                sum(len(f.token_ids) for f in finals)), job.headers())
            return

        # streamed: per-choice chunks tagged with their index
        queue: asyncio.Queue = asyncio.Queue()

        async def pump(idx, sp_i, ids):
            try:
                final = None
                async for out in self._generate(
                        job, f"{job.request_id}-c{idx}", ids, sp_i):
                    final = out
                    if out.delta_text or out.new_logprobs:
                        await queue.put(("delta", idx, out))
                await queue.put(("finish", idx, final))
            except Exception as e:  # noqa: BLE001 — surfaced as a chunk
                await queue.put(("error", idx, e))

        _stream_head(writer, job.headers())
        tasks = [asyncio.ensure_future(pump(*p)) for p in plan]
        try:
            if echoes and not job.chat:
                # OpenAI echo: each choice's stream leads with its prompt
                for idx, _, _ in plan:
                    await _event(writer, proto.completion_chunk(
                        job.request_id, job.model, echoes[idx // n], None,
                        index=idx))
            if job.chat:
                for idx, _, _ in plan:
                    await _event(writer, proto.chat_chunk(
                        job.request_id, job.model, {"role": "assistant"},
                        None, index=idx))
            n_out, lp_pos, remaining = 0, {}, len(plan)
            while remaining:
                kind, idx, payload = await queue.get()
                if kind == "delta":
                    chunk, lp_pos[idx] = self._stream_chunk(
                        job, payload.delta_text, payload.new_logprobs, idx,
                        lp_pos.get(idx, 0))
                    await _event(writer, chunk)
                    continue
                remaining -= 1
                if kind == "finish":
                    self.metrics.observe_finish(payload, arrival)
                    n_out += len(payload.token_ids)
                    await _event(writer, self._finish_chunk(
                        job, idx, payload.finish_reason,
                        payload.prompt_logprobs))
                else:
                    await _event(writer, proto.error_json(str(payload)))
                    # close the choice: clients wait for a finish_reason
                    # on every index
                    await _event(writer, self._finish_chunk(
                        job, idx, "stop", None))
            if include_usage:
                await _event(writer, proto.usage_tail_chunk(
                    job.request_id, job.model, job.chat, n_prompt, n_out))
            await _stream_end(writer)
        finally:
            for t in tasks:
                t.cancel()

    def _stream_chunk(self, job: "_Job", text: str, new_lps, index: int,
                      lp_start: int) -> tuple[dict, int]:
        """One streamed content chunk with its logprobs; returns (chunk,
        the next text_offset seed)."""
        if job.chat:
            chunk = proto.chat_chunk(job.request_id, job.model,
                                     {"content": text}, None, index=index)
        else:
            chunk = proto.completion_chunk(job.request_id, job.model, text,
                                           None, index=index)
        if new_lps:
            if job.chat:
                chunk["choices"][0]["logprobs"] = self._chat_logprobs(
                    new_lps)
            else:
                fmt = self._completion_logprobs(new_lps, job.as_ids,
                                                lp_start)
                chunk["choices"][0]["logprobs"] = fmt
                if fmt["tokens"]:
                    lp_start = fmt["text_offset"][-1] + len(
                        fmt["tokens"][-1])
        return chunk, lp_start

    def _finish_chunk(self, job: "_Job", index: int, reason,
                      prompt_lps) -> dict:
        """The chunk that ends a choice; prompt_logprobs ride it."""
        fin = (proto.chat_chunk(job.request_id, job.model, {}, reason,
                                index=index) if job.chat
               else proto.completion_chunk(job.request_id, job.model, "",
                                           reason, index=index))
        if prompt_lps is not None:
            fin["choices"][0]["prompt_logprobs"] = prompt_lps
        return fin

    async def _stream_completion(self, job: "_Job", ids: list[int], writer,
                                 include_usage: bool,
                                 echo: str | None = None) -> None:
        arrival = time.time()
        gen = self._generate(job, job.request_id, ids, job.sp)
        # the first output comes before the headers, so a request the
        # engine refuses still gets a plain error response
        out = await anext(gen)
        _stream_head(writer, job.headers())
        if echo and not job.chat:
            # OpenAI echo streams the prompt text as the first chunk
            await _event(writer, proto.completion_chunk(
                job.request_id, job.model, echo, None))
        if job.chat:
            await _event(writer, proto.chat_chunk(
                job.request_id, job.model,
                {"role": "assistant", "content": ""}, None))
        lp_pos = 0
        while True:
            if out.delta_text or out.new_logprobs:
                chunk, lp_pos = self._stream_chunk(
                    job, out.delta_text, out.new_logprobs, 0, lp_pos)
                await _event(writer, chunk)
            if out.finished:
                break
            out = await anext(gen)
        self.metrics.observe_finish(out, arrival)
        await _event(writer, self._finish_chunk(
            job, 0, out.finish_reason, out.prompt_logprobs))
        if include_usage:
            await _event(writer, proto.usage_tail_chunk(
                job.request_id, job.model, job.chat,
                len(out.prompt_token_ids), len(out.token_ids)))
        await _stream_end(writer)

    # -- logprobs in the OpenAI wire shapes ----------------------------------
    def _completion_logprobs(self, entries: list[dict] | None,
                             as_ids: bool = False, start: int = 0
                             ) -> dict | None:
        """OpenAI completions logprobs (tokens, token_logprobs,
        top_logprobs, text_offset); `start` seeds text_offset (a
        streamed chunk passes the text already sent). `as_ids` renders
        each token as "token_id:N" (vLLM's return_tokens_as_token_ids),
        and so does a top entry whose string another entry of its row
        already took."""
        if entries is None:
            return None

        def tok(token_id: int) -> str:
            return (f"token_id:{token_id}" if as_ids
                    else self.engine.tokenizer.decode([token_id]))

        tokens, lps, tops, offsets, pos = [], [], [], [], start
        for e in entries:
            s = tok(e["token_id"])
            tokens.append(s)
            lps.append(e["logprob"])
            top: dict = {}
            for t in e["top_logprobs"]:
                key = tok(t["token_id"])
                top[key if key not in top
                    else f"token_id:{t['token_id']}"] = t["logprob"]
            tops.append(top)
            offsets.append(pos)
            pos += len(s)
        return {"tokens": tokens, "token_logprobs": lps,
                "top_logprobs": tops, "text_offset": offsets}

    def _chat_logprobs(self, entries: list[dict] | None) -> dict | None:
        """Chat shape: {"content": [{token, logprob, bytes,
        top_logprobs: [...]}]}."""
        if entries is None:
            return None

        def one(token_id: int, lp: float) -> dict:
            s = self.engine.tokenizer.decode([token_id])
            return {"token": s, "logprob": lp,
                    "bytes": list(s.encode("utf-8", "replace"))}

        return {"content": [
            {**one(e["token_id"], e["logprob"]),
             "top_logprobs": [one(t["token_id"], t["logprob"])
                              for t in e["top_logprobs"]]}
            for e in entries
        ]}


@dataclasses.dataclass
class _Job:
    """What every choice of one HTTP generation request shares."""
    request_id: str
    model: str
    chat: bool
    sp: SamplingParams
    lora_name: str | None = None
    priority: int = 0
    traceparent: str | None = None
    parse_tools: bool = False
    as_ids: bool = False

    def headers(self) -> dict[str, str]:
        # the (possibly router-supplied) engine request id, echoed
        return {REQUEST_ID_HEADER: self.request_id}


def _wants_usage(req: dict) -> bool:
    opts = req.get("stream_options") or {}
    return bool(isinstance(opts, dict) and opts.get("include_usage"))


def _json(body: bytes) -> dict:
    try:
        req = json.loads(body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise HttpError(400, f"invalid JSON body: {e}") from None
    if not isinstance(req, dict):
        raise HttpError(400, "JSON body must be an object")
    return req


class _Conn:
    """A client connection's writer, as the handlers write to it: a
    response goes out whole (`_send`) or as a chunked event stream
    (`_stream_head`, `_event`, `_stream_end`). `keep`: the connection
    serves another request after this one; `open`: a streamed body has
    begun and not ended."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.keep = False
        self.open = False

    def write(self, data: bytes) -> None:
        if self.open:
            data = b"%x\r\n%s\r\n" % (len(data), data)
        self.writer.write(data)

    async def drain(self) -> None:
        await self.writer.drain()


def _stream_head(conn: _Conn, extra: dict[str, str]) -> None:
    """Begin a server-sent event stream (chunked)."""
    conn.write(head(200, "text/event-stream", None, extra,
                    close=not conn.keep))
    conn.open = True


async def _stream_end(conn: _Conn) -> None:
    """The stream's [DONE] event, then chunked encoding's last chunk."""
    conn.write(b"data: [DONE]\n\n")
    conn.open = False
    conn.writer.write(b"0\r\n\r\n")
    await conn.drain()


async def _event(writer, data: dict) -> None:
    writer.write(b"data: " + json.dumps(data).encode() + b"\n\n")
    await writer.drain()


async def _send(conn: _Conn, status: int, payload: bytes, content_type: str,
                extra: dict[str, str] | None = None) -> None:
    if conn.open:
        # a streamed response already began: no second head on it
        conn.keep = False
        return
    conn.write(head(status, content_type, len(payload), extra,
                    close=not conn.keep) + payload)
    await conn.drain()


async def _send_json(writer, status: int, obj: dict,
                     extra: dict[str, str] | None = None) -> None:
    await _send(writer, status, json.dumps(obj).encode(),
                "application/json", extra)
