"""Semantic cache: answer repeated (semantically similar) chat requests
from the router without hitting an engine.

Capability parity with the reference's semantic cache (reference:
src/vllm_router/experimental/semantic_cache/semantic_cache.py:16 —
SentenceTransformer embeddings + FAISS inner-product index persisted via
pickle; integration check-before-route / store-after-response at
semantic_cache_integration.py:181/74). This environment has neither
sentence-transformers nor faiss, so both layers are pluggable:

- Embedder: SentenceTransformer when importable, else a hermetic
  hashed-character-ngram embedding (deterministic, dependency-free —
  cosine over ngram profiles is a solid lexical-similarity proxy).
- Index: exact inner-product search over L2-normalised vectors in numpy
  (FAISS IndexFlatIP equivalent at router-cache scale), persisted with
  np.savez + a JSON sidecar instead of pickle.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np
from production_stack_tpu_torch.utils import web

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

DEFAULT_DIM = 512


class HashedNgramEmbedder:
    """Hermetic text embedder: hashed character n-gram profile, L2-normed."""

    def __init__(self, dim: int = DEFAULT_DIM, ngram: tuple[int, ...] = (3, 4)):
        self.dim = dim
        self.ngram = ngram

    def encode(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        t = text.lower()
        for n in self.ngram:
            for i in range(max(0, len(t) - n + 1)):
                g = t[i: i + n]
                hh = int.from_bytes(
                    hashlib.blake2b(g.encode(), digest_size=8).digest(),
                    "little",
                )
                v[hh % self.dim] += 1.0
        norm = float(np.linalg.norm(v))
        return v / norm if norm > 0 else v


class EngineEmbedder:
    """True semantic embeddings without extra deps: embed via a serving
    engine's /v1/embeddings endpoint (the engine's own hidden states).

    This is the production-grade default for deployments that want real
    paraphrase recall but don't ship sentence-transformers: the router
    already fronts engines, and one of them (or a dedicated small
    embedding engine) supplies the vectors. Async-only — check() awaits
    it; store() reuses the vector check() computed (see _vec_memo)."""

    def __init__(self, url: str, model: str | None = None,
                 timeout_s: float = 10.0):
        self.url = url.rstrip("/")
        self.model = model
        self.timeout_s = timeout_s
        self.dim: int | None = None  # discovered on first embedding
        self._session = None

    async def encode_async(self, text: str) -> np.ndarray | None:
        """Returns an L2-normalised vector, or None when the engine is
        unreachable (the cache silently bypasses)."""
        from production_stack_tpu_torch.utils import http

        if self._session is None or self._session.closed:
            self._session = http.ClientSession(
                timeout=http.ClientTimeout(total=self.timeout_s)
            )
        body: dict = {"input": text}
        if self.model:
            body["model"] = self.model
        try:
            async with self._session.post(
                f"{self.url}/v1/embeddings", json=body
            ) as r:
                if r.status != 200:
                    return None
                data = await r.json()
            v = np.asarray(
                data["data"][0]["embedding"], dtype=np.float32
            )
        except Exception as e:  # noqa: BLE001 — engine down => cache bypass
            logger.debug("embedder unreachable (%s); bypassing cache", e)
            return None
        norm = float(np.linalg.norm(v))
        v = v / norm if norm > 0 else v
        if self.dim is None:
            self.dim = int(v.shape[0])
        return v

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()


class SentenceTransformerEmbedder:  # pragma: no cover - heavy optional dep
    def __init__(self, model_name: str):
        # zero-egress guard: only use a locally cached model — without this
        # the HF hub download can hang indefinitely instead of erroring
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from sentence_transformers import SentenceTransformer

        self._m = SentenceTransformer(model_name, local_files_only=True)
        self.dim = self._m.get_sentence_embedding_dimension()

    def encode(self, text: str) -> np.ndarray:
        v = np.asarray(self._m.encode([text])[0], dtype=np.float32)
        norm = float(np.linalg.norm(v))
        return v / norm if norm > 0 else v


class VectorIndex:
    """Exact inner-product index (FAISS IndexFlatIP stand-in) + payloads."""

    def __init__(self, dim: int):
        self.dim = dim
        self.vectors = np.zeros((0, dim), dtype=np.float32)
        self.payloads: list[dict] = []

    def add(self, vec: np.ndarray, payload: dict) -> None:
        self.vectors = np.vstack([self.vectors, vec[None, :]])
        self.payloads.append(payload)

    def search(self, vec: np.ndarray) -> tuple[float, dict | None]:
        if len(self.payloads) == 0:
            return 0.0, None
        sims = self.vectors @ vec
        i = int(np.argmax(sims))
        return float(sims[i]), self.payloads[i]

    def __len__(self) -> int:
        return len(self.payloads)

    def trim_to(self, keep: int) -> None:
        """FIFO eviction: keep only the newest `keep` entries (bounds the
        exact scan and the memory footprint)."""
        self.vectors = self.vectors[-keep:]
        self.payloads = self.payloads[-keep:]

    # -- persistence (np.savez + json, reference pickles FAISS + db:
    #    db_adapters/faiss_adapter.py:47-70) ------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "vectors.npz"), v=self.vectors)
        with open(os.path.join(directory, "payloads.json"), "w") as f:
            json.dump(self.payloads, f)

    @classmethod
    def load(cls, directory: str, dim: int) -> "VectorIndex":
        idx = cls(dim)
        try:
            data = np.load(os.path.join(directory, "vectors.npz"))
            with open(os.path.join(directory, "payloads.json")) as f:
                payloads = json.load(f)
            if data["v"].shape[1] == dim and len(payloads) == len(data["v"]):
                idx.vectors = data["v"].astype(np.float32)
                idx.payloads = payloads
        except (OSError, ValueError, KeyError):
            pass
        return idx


class FaissVectorIndex(VectorIndex):
    """FAISS-accelerated inner-product index behind the VectorIndex
    interface (reference: db_adapters/faiss_adapter.py:14-70 uses
    IndexFlatIP the same way). Falls back is handled by the caller:
    constructing this class without faiss installed raises ImportError.

    Vectors are mirrored in the numpy array (the source of truth for
    persistence and trim); faiss only serves the search. At router-cache
    scale the mirror is tiny, and it keeps save/load/trim_to semantics
    identical to the exact index."""

    def __init__(self, dim: int):
        import faiss  # noqa: F401 — ImportError => caller falls back

        super().__init__(dim)
        self._faiss = faiss
        self._index = faiss.IndexFlatIP(dim)

    def add(self, vec: np.ndarray, payload: dict) -> None:
        super().add(vec, payload)
        self._index.add(vec[None, :].astype(np.float32))

    def search(self, vec: np.ndarray) -> tuple[float, dict | None]:
        if len(self.payloads) == 0:
            return 0.0, None
        sims, ids = self._index.search(
            vec[None, :].astype(np.float32), 1
        )
        i = int(ids[0, 0])
        if i < 0:
            return 0.0, None
        return float(sims[0, 0]), self.payloads[i]

    def _rebuild(self) -> None:
        self._index = self._faiss.IndexFlatIP(self.dim)
        if len(self.vectors):
            self._index.add(self.vectors.astype(np.float32))

    def trim_to(self, keep: int) -> None:
        super().trim_to(keep)
        self._rebuild()

    @classmethod
    def load(cls, directory: str, dim: int) -> "FaissVectorIndex":
        idx = cls(dim)
        base = VectorIndex.load(directory, dim)
        idx.vectors, idx.payloads = base.vectors, base.payloads
        idx._rebuild()
        return idx


def make_vector_index(
    dim: int, cache_dir: str | None = None, backend: str = "auto"
) -> VectorIndex:
    """backend: "auto" (faiss if importable), "faiss", or "exact"."""
    cls: type[VectorIndex] = VectorIndex
    if backend in ("auto", "faiss"):
        try:
            FaissVectorIndex(1)  # probe the import cheaply
            cls = FaissVectorIndex
        except ImportError:
            if backend == "faiss":
                raise
            logger.info("faiss not installed; exact index")
    return cls.load(cache_dir, dim) if cache_dir else cls(dim)


def _chat_request_text(body: dict) -> str | None:
    msgs = body.get("messages")
    if not isinstance(msgs, list):
        return None
    parts = []
    for m in msgs:
        c = m.get("content") if isinstance(m, dict) else None
        if isinstance(c, str):
            parts.append(f"{m.get('role', 'user')}: {c}")
    return "\n".join(parts) if parts else None


class SemanticCache:
    """check() before routing; store() after a completed response."""

    def __init__(self, model_name: str = "all-MiniLM-L6-v2",
                 cache_dir: str | None = None, threshold: float = 0.95,
                 max_entries: int = 4096, index_backend: str = "auto",
                 embedder_url: str | None = None):
        self.threshold = threshold
        self.cache_dir = cache_dir
        self.max_entries = max_entries
        self.index_backend = index_backend
        self.index: VectorIndex | None = None
        if embedder_url:
            # real semantic embeddings from a serving engine; dim is
            # discovered on the first embedding, so the index is built
            # lazily
            self.embedder = EngineEmbedder(embedder_url, model_name)
            logger.info("semantic cache: engine embedder at %s",
                        embedder_url)
        else:
            try:
                self.embedder = SentenceTransformerEmbedder(model_name)
                logger.info(
                    "semantic cache: sentence-transformers %s", model_name
                )
            except Exception:  # noqa: BLE001 — not installed on this image
                self.embedder = HashedNgramEmbedder()
                logger.info("semantic cache: hermetic hashed-ngram embedder")
        if self.embedder.dim is not None:
            self.index = make_vector_index(
                self.embedder.dim, cache_dir, index_backend
            )
        # check()-computed vectors parked for the sync store() call that
        # follows the response (async embedders cannot re-embed there)
        self._vec_memo: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        # deferred persistence: a full index rewrite per store would stall
        # the event loop; a background thread flushes dirty state instead
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._flusher: threading.Thread | None = None
        if cache_dir:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="semantic-cache-flush",
                daemon=True,
            )
            self._flusher.start()

    # -- integration points ------------------------------------------------
    async def check(self, request: web.Request) -> web.Response | None:
        """Early-return a cached response on a similarity hit (reference:
        semantic_cache_integration.py:181 check_semantic_cache)."""
        try:
            body = await request.json()
        # stackcheck: disable=silent-except — non-JSON bodies are not
        # cacheable chat requests; skipping them is the designed fast path
        except Exception:  # noqa: BLE001
            return None
        if body.get("stream"):
            return None  # only whole-response caching
        text = _chat_request_text(body)
        if not text:
            return None
        if isinstance(self.embedder, EngineEmbedder):
            vec = await self.embedder.encode_async(text)
            if vec is None:
                return None  # embedding engine unreachable: bypass cache
        else:
            vec = self.embedder.encode(text)
        with self._lock:
            if self.index is None:  # dim just discovered (engine embedder)
                self.index = make_vector_index(
                    self.embedder.dim, self.cache_dir, self.index_backend
                )
            # park the vector for the sync store() after the response
            self._vec_memo[text] = vec
            while len(self._vec_memo) > 1024:
                self._vec_memo.pop(next(iter(self._vec_memo)))
            sim, payload = self.index.search(vec)
        if payload is not None and sim >= self.threshold:
            self.hits += 1
            logger.info("semantic cache HIT (sim=%.3f)", sim)
            resp = dict(payload["response"])
            resp["served_by"] = "semantic-cache"
            return web.json_response(
                resp, headers={"x-semantic-cache": "hit",
                               "x-semantic-cache-similarity": f"{sim:.4f}"}
            )
        self.misses += 1
        return None

    def store(self, body: dict, response: dict) -> None:
        """Store a completed chat response (reference:
        semantic_cache_integration.py:74 store_in_semantic_cache)."""
        text = _chat_request_text(body)
        if not text:
            return
        with self._lock:
            vec = self._vec_memo.pop(text, None)
        if vec is None:
            if isinstance(self.embedder, EngineEmbedder):
                # no vector captured at check() time (engine was down or
                # check was skipped): nothing to store
                return
            vec = self.embedder.encode(text)
        with self._lock:
            if self.index is None:
                self.index = make_vector_index(
                    self.embedder.dim, self.cache_dir, self.index_backend
                )
            sim, _ = self.index.search(vec)
            if sim >= self.threshold:
                return  # near-duplicate already cached
            if len(self.index) >= self.max_entries:
                # simple FIFO trim: drop the oldest half
                self.index.trim_to(self.max_entries // 2)
            self.index.add(vec, {"request_text": text, "response": response})
            self.stores += 1
        self._dirty.set()

    def stats(self) -> dict:
        with self._lock:
            n = len(self.index) if self.index is not None else 0
            return {"entries": n, "hits": self.hits,
                    "misses": self.misses, "stores": self.stores}

    def close(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
        if isinstance(self.embedder, EngineEmbedder):
            # best-effort: close the HTTP session if a loop is running
            # (process teardown reclaims it otherwise)
            import asyncio

            from production_stack_tpu_torch.utils.tasks import spawn_watched

            try:
                asyncio.get_running_loop()
                # handle stored on self: the loop keeps only a weak ref,
                # so an unreferenced task can be GC'd before it runs
                self._close_task = spawn_watched(
                    self.embedder.close(), "semantic-cache-embedder-close"
                )
            except RuntimeError:
                pass

    # -- background persistence -------------------------------------------
    def _flush_loop(self, interval_s: float = 5.0) -> None:
        while not self._stop.is_set():
            self._dirty.wait(timeout=0.5)
            if not self._dirty.is_set():
                continue
            self._stop.wait(interval_s)  # coalesce a burst of stores
            self._dirty.clear()
            self._flush_once()
        if self._dirty.is_set():  # final flush on shutdown
            self._flush_once()

    def _flush_once(self) -> None:
        with self._lock:
            if self.index is None:
                return  # engine embedder, nothing embedded yet
            vectors = self.index.vectors.copy()
            payloads = list(self.index.payloads)
        snap = VectorIndex(self.embedder.dim)
        snap.vectors, snap.payloads = vectors, payloads
        try:
            snap.save(self.cache_dir)
        except OSError as e:
            logger.warning("semantic cache persist failed: %s", e)
