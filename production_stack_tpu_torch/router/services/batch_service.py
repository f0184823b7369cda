"""OpenAI Batch API: SQLite-backed queue + background execution loop.

Capability parity with the reference's batch service (reference:
src/vllm_router/services/batch_service/batch.py:19,53 dataclasses,
processor.py:21 ABC, local_processor.py:32,170 SQLite processor,
routers/batches_router.py:23-113 HTTP surface) — with one upgrade: the
reference's local processor stubs execution, ours actually runs every
batch line through the router's routing + proxy machinery
(RequestService.execute_internal) and writes a real output file.

Uses stdlib sqlite3 on the default executor (no aiosqlite dependency).
"""

from __future__ import annotations

import abc
import asyncio
import json
import sqlite3
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field

from production_stack_tpu_torch.utils import web

from production_stack_tpu_torch.router.services.files_service import (
    FileNotFoundStorageError,
    Storage,
)
from production_stack_tpu_torch.utils.log import init_logger
from production_stack_tpu_torch.utils.tasks import spawn_watched

logger = init_logger(__name__)

VALID_ENDPOINTS = (
    "/v1/chat/completions", "/v1/completions", "/v1/embeddings",
)


class BatchStatus:
    VALIDATING = "validating"
    FAILED = "failed"
    IN_PROGRESS = "in_progress"
    FINALIZING = "finalizing"
    COMPLETED = "completed"
    EXPIRED = "expired"
    CANCELLING = "cancelling"
    CANCELLED = "cancelled"


@dataclass
class BatchRequestCounts:
    total: int = 0
    completed: int = 0
    failed: int = 0


@dataclass
class BatchInfo:
    """Mirror of the OpenAI batch object."""

    id: str
    input_file_id: str
    endpoint: str
    completion_window: str = "24h"
    status: str = BatchStatus.VALIDATING
    object: str = "batch"
    errors: dict | None = None
    output_file_id: str | None = None
    error_file_id: str | None = None
    created_at: int = 0
    in_progress_at: int | None = None
    expires_at: int | None = None
    finalizing_at: int | None = None
    completed_at: int | None = None
    failed_at: int | None = None
    expired_at: int | None = None
    cancelling_at: int | None = None
    cancelled_at: int | None = None
    request_counts: BatchRequestCounts = field(
        default_factory=BatchRequestCounts
    )
    metadata: dict | None = None

    def to_dict(self) -> dict:
        d = asdict(self)
        return d


class BatchProcessor(abc.ABC):
    @abc.abstractmethod
    async def initialize_batch(self, input_file_id: str, endpoint: str,
                               completion_window: str,
                               metadata: dict | None) -> BatchInfo:
        ...

    @abc.abstractmethod
    async def retrieve_batch(self, batch_id: str) -> BatchInfo | None:
        ...

    @abc.abstractmethod
    async def list_batches(self, limit: int = 20,
                           after: str | None = None) -> list[BatchInfo]:
        ...

    @abc.abstractmethod
    async def cancel_batch(self, batch_id: str) -> BatchInfo | None:
        ...


class LocalBatchProcessor(BatchProcessor):
    """SQLite queue + asyncio worker executing batches via the router."""

    def __init__(self, db_dir: str, storage: Storage, request_service,
                 poll_interval_s: float = 1.0,
                 max_concurrency: int = 16):
        import os

        os.makedirs(db_dir, exist_ok=True)
        self.db_path = os.path.join(db_dir, "batches.sqlite")
        self.storage = storage
        self.request_service = request_service
        self.poll_interval_s = poll_interval_s
        self.max_concurrency = max_concurrency
        self._db_lock = threading.Lock()
        self._db = sqlite3.connect(self.db_path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS batches ("
            "id TEXT PRIMARY KEY, created_at INTEGER, data TEXT)"
        )
        self._db.commit()
        self._task: asyncio.Task | None = None
        self._stopping = False

    # -- persistence -------------------------------------------------------
    def _save(self, info: BatchInfo) -> None:
        with self._db_lock:
            self._db.execute(
                "INSERT OR REPLACE INTO batches VALUES (?, ?, ?)",
                (info.id, info.created_at, json.dumps(info.to_dict())),
            )
            self._db.commit()

    def _load(self, batch_id: str) -> BatchInfo | None:
        with self._db_lock:
            row = self._db.execute(
                "SELECT data FROM batches WHERE id = ?", (batch_id,)
            ).fetchone()
        if row is None:
            return None
        return self._from_dict(json.loads(row[0]))

    def _load_all(self) -> list[BatchInfo]:
        with self._db_lock:
            rows = self._db.execute(
                "SELECT data FROM batches ORDER BY created_at DESC"
            ).fetchall()
        return [self._from_dict(json.loads(r[0])) for r in rows]

    @staticmethod
    def _from_dict(d: dict) -> BatchInfo:
        d = dict(d)
        rc = d.pop("request_counts", None) or {}
        info = BatchInfo(**d, request_counts=BatchRequestCounts(**rc))
        return info

    # -- API ---------------------------------------------------------------
    async def initialize_batch(self, input_file_id: str, endpoint: str,
                               completion_window: str,
                               metadata: dict | None) -> BatchInfo:
        now = int(time.time())
        info = BatchInfo(
            id=f"batch_{uuid.uuid4().hex}",
            input_file_id=input_file_id,
            endpoint=endpoint,
            completion_window=completion_window or "24h",
            status=BatchStatus.VALIDATING,
            created_at=now,
            expires_at=now + 24 * 3600,
            metadata=metadata,
        )
        await asyncio.get_running_loop().run_in_executor(
            None, self._save, info
        )
        return info

    async def retrieve_batch(self, batch_id: str) -> BatchInfo | None:
        return await asyncio.get_running_loop().run_in_executor(
            None, self._load, batch_id
        )

    async def list_batches(self, limit: int = 20,
                           after: str | None = None) -> list[BatchInfo]:
        all_ = await asyncio.get_running_loop().run_in_executor(
            None, self._load_all
        )
        if after is not None:
            ids = [b.id for b in all_]
            if after in ids:
                all_ = all_[ids.index(after) + 1:]
        return all_[:limit]

    async def cancel_batch(self, batch_id: str) -> BatchInfo | None:
        info = await self.retrieve_batch(batch_id)
        if info is None:
            return None
        if info.status in (BatchStatus.VALIDATING, BatchStatus.IN_PROGRESS):
            info.status = BatchStatus.CANCELLING
            info.cancelling_at = int(time.time())
            await asyncio.get_running_loop().run_in_executor(
                None, self._save, info
            )
        return info

    # -- worker loop (reference: local_processor.py:170) -------------------
    async def start(self) -> None:
        self._task = spawn_watched(self._poll_loop(), "batch-poll")

    async def close(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        with self._db_lock:
            self._db.close()

    async def _poll_loop(self) -> None:
        while not self._stopping:
            try:
                batches = await asyncio.get_running_loop().run_in_executor(
                    None, self._load_all
                )
                for info in batches:
                    if info.status == BatchStatus.VALIDATING:
                        await self._process_batch(info)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — keep the queue alive
                logger.exception("batch poll loop error")
            await asyncio.sleep(self.poll_interval_s)

    async def _is_cancelling(self, batch_id: str) -> bool:
        cur = await self.retrieve_batch(batch_id)
        return cur is not None and cur.status == BatchStatus.CANCELLING

    async def _process_batch(self, info: BatchInfo) -> None:
        loop = asyncio.get_running_loop()
        try:
            content = await self.storage.get_file_content(info.input_file_id)
        except FileNotFoundStorageError:
            info.status = BatchStatus.FAILED
            info.failed_at = int(time.time())
            info.errors = {"message":
                           f"input file {info.input_file_id!r} not found"}
            await loop.run_in_executor(None, self._save, info)
            return

        lines = [ln for ln in content.decode().splitlines() if ln.strip()]
        info.status = BatchStatus.IN_PROGRESS
        info.in_progress_at = int(time.time())
        info.request_counts = BatchRequestCounts(total=len(lines))
        await loop.run_in_executor(None, self._save, info)

        sem = asyncio.Semaphore(self.max_concurrency)
        results: list[dict | None] = [None] * len(lines)
        errors: list[dict] = []

        async def run_one(i: int, line: str) -> None:
            async with sem:
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    errors.append({"line": i + 1, "message": str(e)})
                    info.request_counts.failed += 1
                    return
                custom_id = req.get("custom_id", f"line-{i + 1}")
                endpoint = req.get("url") or info.endpoint
                try:
                    status, payload = (
                        await self.request_service.execute_internal(
                            req.get("body") or {}, endpoint,
                            request_id=f"{info.id}-{custom_id}",
                        )
                    )
                except Exception as e:  # noqa: BLE001 — one bad line must
                    # never wedge the whole batch in in_progress forever
                    status, payload = 500, {"error": {"message": str(e)}}
                ok = 200 <= status < 300
                results[i] = {
                    "id": f"batch_req_{uuid.uuid4().hex}",
                    "custom_id": custom_id,
                    "response": {"status_code": status, "body": payload},
                    "error": None if ok else {
                        "code": str(status),
                        "message": json.dumps(payload)[:512],
                    },
                }
                if ok:
                    info.request_counts.completed += 1
                else:
                    info.request_counts.failed += 1

        chunk = 64  # checkpoint progress + honor cancellation between chunks
        for start in range(0, len(lines), chunk):
            if await self._is_cancelling(info.id):
                info.status = BatchStatus.CANCELLED
                info.cancelled_at = int(time.time())
                await loop.run_in_executor(None, self._save, info)
                return
            await asyncio.gather(*(
                run_one(i, lines[i])
                for i in range(start, min(start + chunk, len(lines)))
            ))
            await loop.run_in_executor(None, self._save, info)

        info.status = BatchStatus.FINALIZING
        info.finalizing_at = int(time.time())
        await loop.run_in_executor(None, self._save, info)

        out_lines = [json.dumps(r) for r in results if r is not None]
        out_meta = await self.storage.save_file(
            ("\n".join(out_lines) + "\n").encode(),
            filename=f"{info.id}_output.jsonl", purpose="batch_output",
        )
        info.output_file_id = out_meta.id
        if errors:
            err_meta = await self.storage.save_file(
                ("\n".join(json.dumps(e) for e in errors) + "\n").encode(),
                filename=f"{info.id}_errors.jsonl", purpose="batch_output",
            )
            info.error_file_id = err_meta.id
        info.status = BatchStatus.COMPLETED
        info.completed_at = int(time.time())
        await loop.run_in_executor(None, self._save, info)
        logger.info(
            "batch %s completed: %d/%d ok",
            info.id, info.request_counts.completed, info.request_counts.total,
        )


# -- HTTP routes (reference: routers/batches_router.py:23-113) --------------
def add_batch_routes(router: web.UrlDispatcher,
                     processor: BatchProcessor) -> None:
    async def create(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _bad_request("invalid JSON body")
        input_file_id = body.get("input_file_id")
        endpoint = body.get("endpoint")
        if not input_file_id:
            return _bad_request("input_file_id is required")
        if endpoint not in VALID_ENDPOINTS:
            return _bad_request(
                f"endpoint must be one of {list(VALID_ENDPOINTS)}"
            )
        info = await processor.initialize_batch(
            input_file_id, endpoint,
            body.get("completion_window", "24h"), body.get("metadata"),
        )
        return web.json_response(info.to_dict())

    async def list_(request: web.Request) -> web.Response:
        limit = int(request.query.get("limit", "20"))
        after = request.query.get("after")
        batches = await processor.list_batches(limit=limit, after=after)
        return web.json_response({
            "object": "list",
            "data": [b.to_dict() for b in batches],
            "first_id": batches[0].id if batches else None,
            "last_id": batches[-1].id if batches else None,
            "has_more": len(batches) == limit,
        })

    async def retrieve(request: web.Request) -> web.Response:
        info = await processor.retrieve_batch(request.match_info["batch_id"])
        if info is None:
            return _not_found(request.match_info["batch_id"])
        return web.json_response(info.to_dict())

    async def cancel(request: web.Request) -> web.Response:
        info = await processor.cancel_batch(request.match_info["batch_id"])
        if info is None:
            return _not_found(request.match_info["batch_id"])
        return web.json_response(info.to_dict())

    def _bad_request(msg: str) -> web.Response:
        return web.json_response(
            {"error": {"message": msg, "type": "invalid_request_error"}},
            status=400,
        )

    def _not_found(bid: str) -> web.Response:
        return web.json_response(
            {"error": {"message": f"batch {bid!r} not found",
                       "type": "invalid_request_error"}}, status=404)

    router.add_post("/v1/batches", create)
    router.add_get("/v1/batches", list_)
    router.add_get("/v1/batches/{batch_id}", retrieve)
    router.add_post("/v1/batches/{batch_id}/cancel", cancel)
