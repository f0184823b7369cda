"""OpenAI Files API: storage abstraction + local-FS impl + HTTP routes.

Capability parity with the reference's files service (reference:
src/vllm_router/services/files_service/storage.py:20,155,
file_storage.py:27, openai_files.py:19, routers/files_router.py:23-81).
Async file IO rides the default thread-pool executor instead of aiofiles
so the router has no extra dependency.
"""

from __future__ import annotations

import abc
import asyncio
import json
import os
import time
import uuid
from dataclasses import asdict, dataclass, field

from production_stack_tpu_torch.utils import web

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

DEFAULT_STORAGE_PATH = "/tmp/production_stack_tpu/files"


@dataclass
class OpenAIFile:
    """Mirror of the OpenAI file object."""

    id: str
    bytes: int
    created_at: int
    filename: str
    purpose: str
    object: str = "file"
    status: str = "uploaded"
    status_details: str | None = None

    def to_dict(self) -> dict:
        return asdict(self)


class Storage(abc.ABC):
    @abc.abstractmethod
    async def save_file(self, content: bytes, filename: str,
                        purpose: str, file_id: str | None = None) -> OpenAIFile:
        ...

    @abc.abstractmethod
    async def get_file(self, file_id: str) -> OpenAIFile:
        ...

    @abc.abstractmethod
    async def get_file_content(self, file_id: str) -> bytes:
        ...

    @abc.abstractmethod
    async def list_files(self) -> list[OpenAIFile]:
        ...

    @abc.abstractmethod
    async def delete_file(self, file_id: str) -> bool:
        ...


class FileNotFoundStorageError(KeyError):
    pass


class FileStorage(Storage):
    """Local-filesystem storage: <base>/<file_id> + <file_id>.meta.json."""

    def __init__(self, base_path: str = DEFAULT_STORAGE_PATH):
        self.base = base_path
        os.makedirs(base_path, exist_ok=True)

    def _data_path(self, file_id: str) -> str:
        safe = file_id.replace("/", "_")
        return os.path.join(self.base, safe)

    def _meta_path(self, file_id: str) -> str:
        return self._data_path(file_id) + ".meta.json"

    async def save_file(self, content: bytes, filename: str,
                        purpose: str, file_id: str | None = None) -> OpenAIFile:
        file_id = file_id or f"file-{uuid.uuid4().hex}"
        meta = OpenAIFile(
            id=file_id, bytes=len(content), created_at=int(time.time()),
            filename=filename, purpose=purpose,
        )

        def write() -> None:
            with open(self._data_path(file_id), "wb") as f:
                f.write(content)
            with open(self._meta_path(file_id), "w") as f:
                json.dump(meta.to_dict(), f)

        await asyncio.get_running_loop().run_in_executor(None, write)
        return meta

    async def get_file(self, file_id: str) -> OpenAIFile:
        def read() -> OpenAIFile:
            try:
                with open(self._meta_path(file_id)) as f:
                    return OpenAIFile(**json.load(f))
            except FileNotFoundError:
                raise FileNotFoundStorageError(file_id) from None

        return await asyncio.get_running_loop().run_in_executor(None, read)

    async def get_file_content(self, file_id: str) -> bytes:
        def read() -> bytes:
            try:
                with open(self._data_path(file_id), "rb") as f:
                    return f.read()
            except FileNotFoundError:
                raise FileNotFoundStorageError(file_id) from None

        return await asyncio.get_running_loop().run_in_executor(None, read)

    async def list_files(self) -> list[OpenAIFile]:
        def scan() -> list[OpenAIFile]:
            out = []
            for fn in os.listdir(self.base):
                if fn.endswith(".meta.json"):
                    try:
                        with open(os.path.join(self.base, fn)) as f:
                            out.append(OpenAIFile(**json.load(f)))
                    except (OSError, ValueError):
                        continue
            out.sort(key=lambda m: m.created_at, reverse=True)
            return out

        return await asyncio.get_running_loop().run_in_executor(None, scan)

    async def delete_file(self, file_id: str) -> bool:
        def rm() -> bool:
            found = False
            for p in (self._data_path(file_id), self._meta_path(file_id)):
                try:
                    os.remove(p)
                    found = True
                except FileNotFoundError:
                    pass
            return found

        return await asyncio.get_running_loop().run_in_executor(None, rm)


# -- HTTP routes (reference: routers/files_router.py:23-81) -----------------
def add_file_routes(router: web.UrlDispatcher, storage: Storage) -> None:
    async def upload(request: web.Request) -> web.Response:
        purpose = "batch"
        filename = "upload"
        content = None
        if request.content_type.startswith("multipart/"):
            reader = await request.multipart()
            async for part in reader:
                if part.name == "file":
                    filename = part.filename or filename
                    content = await part.read(decode=False)
                elif part.name == "purpose":
                    purpose = (await part.text()).strip()
        else:
            content = await request.read()
        if not content:
            return web.json_response(
                {"error": {"message": "no file content",
                           "type": "invalid_request_error"}}, status=400)
        meta = await storage.save_file(content, filename, purpose)
        return web.json_response(meta.to_dict())

    async def list_(request: web.Request) -> web.Response:
        files = await storage.list_files()
        return web.json_response(
            {"object": "list", "data": [f.to_dict() for f in files]}
        )

    async def retrieve(request: web.Request) -> web.Response:
        try:
            meta = await storage.get_file(request.match_info["file_id"])
        except FileNotFoundStorageError:
            return _not_found(request.match_info["file_id"])
        return web.json_response(meta.to_dict())

    async def content(request: web.Request) -> web.Response:
        try:
            data = await storage.get_file_content(
                request.match_info["file_id"]
            )
        except FileNotFoundStorageError:
            return _not_found(request.match_info["file_id"])
        return web.Response(body=data,
                            content_type="application/octet-stream")

    async def delete(request: web.Request) -> web.Response:
        fid = request.match_info["file_id"]
        deleted = await storage.delete_file(fid)
        if not deleted:
            return _not_found(fid)
        return web.json_response(
            {"id": fid, "object": "file", "deleted": True}
        )

    def _not_found(fid: str) -> web.Response:
        return web.json_response(
            {"error": {"message": f"file {fid!r} not found",
                       "type": "invalid_request_error"}}, status=404)

    router.add_post("/v1/files", upload)
    router.add_get("/v1/files", list_)
    router.add_get("/v1/files/{file_id}", retrieve)
    router.add_get("/v1/files/{file_id}/content", content)
    router.add_delete("/v1/files/{file_id}", delete)
