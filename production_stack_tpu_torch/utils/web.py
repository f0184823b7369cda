"""A small HTTP application server on stdlib asyncio: the subset of
``aiohttp.web`` the router is written against.

The machine with the card has no aiohttp, so the router's app, its
handlers and its services (router/) run on this module. Names and
behaviour follow aiohttp's so each router file reads like its JAX
counterpart:

- ``Application(middlewares=[...])`` with ``router.add_get`` (GET and
  HEAD) / ``add_post`` / ``add_delete`` / ``add_route`` (paths may hold ``{name}`` parts, read from
  ``request.match_info``) and ``on_startup`` / ``on_shutdown`` /
  ``on_cleanup`` callbacks; ``middleware`` marks a middleware.
- ``Request``: ``method``, ``path``, ``query``, case-insensitive
  ``headers``, ``remote``, ``content_type``, ``read`` / ``text`` /
  ``json`` (a body past ``client_max_size``, 1 MiB as in aiohttp, is its
  413) and ``multipart``.
- ``Response`` / ``json_response`` (a whole body) and ``StreamResponse``
  (``prepare``, then ``write`` each piece as it comes, chunked encoding,
  and ``write_eof``; ``force_close`` ends the connection without the
  last chunk, so the client sees the stream cut).
- ``HTTPException`` and the subclasses the router raises; an unknown path
  is ``HTTPNotFound`` and a known path under another method
  ``HTTPMethodNotAllowed``, raised through the middlewares as aiohttp
  does, with aiohttp's ``"404: Not Found"`` text bodies.
- ``AppRunner`` / ``TCPSite`` and ``run_app`` (which stops on SIGINT or
  SIGTERM, running the cleanup callbacks).

One request per connection (``Connection: close``); a request head or
body the parser refuses is answered 400 before any handler runs.
"""

from __future__ import annotations

import asyncio
import functools
import json
import re
import signal

from production_stack_tpu_torch.utils.http import (
    REASONS,
    BadHttpMessage,
    Headers,
    HttpError,
    http_date,
    read_request,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

SERVER = "production-stack-tpu-torch"
CLIENT_MAX_SIZE = 2**20


# -- responses -------------------------------------------------------------------
class StreamResponse:
    def __init__(self, *, status: int = 200, reason: str | None = None,
                 headers=None):
        self.status = status
        self.reason = reason or REASONS.get(status, "")
        self.headers = Headers(headers or {})
        self._writer: asyncio.StreamWriter | None = None
        self._chunked = False
        self._eof = False
        self.force_closed = False

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    def force_close(self) -> None:
        self.force_closed = True

    def _head(self, length: int | None) -> bytes:
        h = Headers(self.headers)
        if length is not None:
            h["Content-Length"] = str(length)
        elif "Content-Length" not in h:
            h["Transfer-Encoding"] = "chunked"
            self._chunked = True
        h.setdefault("Date", http_date())
        h.setdefault("Server", SERVER)
        h["Connection"] = "close"
        lines = [f"HTTP/1.1 {self.status} {self.reason}"]
        lines += [f"{k}: {v}" for k, v in h.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode(
            "utf-8", "surrogateescape")

    async def prepare(self, request: "Request") -> "StreamResponse":
        if self._writer is None:
            self._writer = request._writer
            await self._send(self._head(None))
        return self

    async def _send(self, data: bytes) -> None:
        w = self._writer
        if w is None or w.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        w.write(data)
        await w.drain()

    async def write(self, data: bytes) -> None:
        if self._eof:
            raise RuntimeError("Cannot call write() after write_eof()")
        if not data:
            return
        if self._chunked:
            data = b"%x\r\n%s\r\n" % (len(data), data)
        await self._send(data)

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof:
            return
        if data:
            await self.write(data)
        self._eof = True
        if self._chunked:
            await self._send(b"0\r\n\r\n")


class Response(StreamResponse):
    def __init__(self, *, body: bytes | None = None, status: int = 200,
                 reason: str | None = None, text: str | None = None,
                 headers=None, content_type: str | None = None,
                 charset: str | None = None):
        super().__init__(status=status, reason=reason, headers=headers)
        if text is not None:
            charset = charset or "utf-8"
            body = text.encode(charset)
            content_type = content_type or "text/plain"
        self.body = body if body is not None else b""
        if content_type is not None:
            self.headers["Content-Type"] = (
                f"{content_type}; charset={charset}" if charset
                else content_type)
        elif "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"

    async def _render(self, writer, head_only: bool = False) -> None:
        self._writer = writer
        await self._send(self._head(len(self.body))
                         + (b"" if head_only else self.body))
        self._eof = True


def json_response(data=None, *, text: str | None = None, status: int = 200,
                  headers=None, content_type: str = "application/json",
                  dumps=json.dumps) -> Response:
    if text is None:
        text = dumps(data)
    return Response(text=text, status=status, headers=headers,
                    content_type=content_type)


class HTTPException(Response, Exception):
    status_code = 500

    def __init__(self, *, headers=None, reason: str | None = None,
                 text: str | None = None, content_type: str | None = None):
        reason = reason or REASONS.get(self.status_code, "")
        if text is None:
            text = f"{self.status_code}: {reason}"
        Response.__init__(self, status=self.status_code, reason=reason,
                          text=text, headers=headers,
                          content_type=content_type)
        Exception.__init__(self, text)


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, method: str, allowed_methods, **kw):
        allow = ",".join(sorted(allowed_methods))
        super().__init__(headers={"Allow": allow}, **kw)
        self.method = method
        self.allowed_methods = set(allowed_methods)


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int, **kw):
        kw.setdefault("text", (
            f"Maximum request body size {max_size} exceeded, "
            f"actual body size {actual_size}"))
        super().__init__(**kw)


class HTTPInternalServerError(HTTPException):
    status_code = 500


# -- requests --------------------------------------------------------------------
class BodyPart:
    """One part of a multipart/form-data body."""

    def __init__(self, headers: Headers, data: bytes):
        self.headers = headers
        self._data = data
        disp = headers.get("Content-Disposition", "")
        params = dict(
            (k.strip().lower(), v.strip().strip('"'))
            for k, _, v in (p.partition("=") for p in disp.split(";")[1:]))
        self.name = params.get("name")
        self.filename = params.get("filename")

    async def read(self, *, decode: bool = False) -> bytes:
        return self._data

    async def text(self) -> str:
        return self._data.decode("utf-8")


class MultipartReader:
    def __init__(self, parts: list[BodyPart]):
        self._parts = parts

    def __aiter__(self):
        self._it = iter(self._parts)
        return self

    async def __anext__(self) -> BodyPart:
        try:
            return next(self._it)
        except StopIteration:
            raise StopAsyncIteration from None


def _multipart_parts(body: bytes, content_type: str) -> list[BodyPart]:
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise HTTPBadRequest(text="multipart body without a boundary")
    sep = b"--" + m.group(1).encode()
    parts = []
    for chunk in body.split(sep)[1:]:
        if chunk.startswith(b"--"):
            break  # the closing delimiter
        chunk = chunk[2:] if chunk.startswith(b"\r\n") else chunk
        head, _, data = chunk.partition(b"\r\n\r\n")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        hdrs = Headers()
        for line in head.decode("utf-8", "surrogateescape").split("\r\n"):
            k, _, v = line.partition(":")
            if k.strip():
                hdrs[k.strip()] = v.strip()
        parts.append(BodyPart(hdrs, data))
    return parts


class Request:
    def __init__(self, method: str, path: str, raw, writer, app,
                 match_info: dict[str, str]):
        self.method = method
        self.path = path
        self.headers = Headers(raw.raw_headers)
        self.query = raw.query
        self.match_info = match_info
        self.app = app
        self._body = raw.body
        self._writer = writer
        peer = writer.get_extra_info("peername")
        self.remote = peer[0] if isinstance(peer, tuple) else None
        self.client_max_size = app._client_max_size

    @property
    def content_type(self) -> str:
        return self.headers.get("Content-Type", "application/octet-stream"
                                ).split(";")[0].strip().lower()

    @property
    def charset(self) -> str | None:
        for part in self.headers.get("Content-Type", "").split(";")[1:]:
            k, _, v = part.strip().partition("=")
            if k.lower() == "charset":
                return v.strip('"') or None
        return None

    async def read(self) -> bytes:
        if self.client_max_size and len(self._body) > self.client_max_size:
            raise HTTPRequestEntityTooLarge(self.client_max_size,
                                            len(self._body))
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self, *, loads=json.loads):
        return loads(await self.text())

    async def multipart(self) -> MultipartReader:
        return MultipartReader(_multipart_parts(
            await self.read(), self.headers.get("Content-Type", "")))


# -- routing and the application -------------------------------------------------
def middleware(f):
    f.__middleware_version__ = 1
    return f


class _Route:
    def __init__(self, method: str, path: str, handler):
        self.method = method
        self.path = path
        self.handler = handler
        names: list[str] = []

        def part(m: re.Match) -> str:
            names.append(m.group(1))
            return f"(?P<{m.group(1)}>[^{{}}/]+)"

        pattern = re.sub(r"\\\{(\w+)\\\}", part, re.escape(path))
        self.regex = re.compile(f"^{pattern}$") if names else None

    def match(self, path: str) -> dict[str, str] | None:
        if self.regex is None:
            return {} if path == self.path else None
        m = self.regex.match(path)
        return m.groupdict() if m else None


class UrlDispatcher:
    def __init__(self) -> None:
        self.routes: list[_Route] = []

    def add_route(self, method: str, path: str, handler) -> _Route:
        r = _Route(method.upper(), path, handler)
        self.routes.append(r)
        return r

    def add_get(self, path: str, handler, allow_head: bool = True):
        if allow_head:
            self.add_route("HEAD", path, handler)
        return self.add_route("GET", path, handler)

    def add_post(self, path: str, handler):
        return self.add_route("POST", path, handler)

    def add_delete(self, path: str, handler):
        return self.add_route("DELETE", path, handler)

    def resolve(self, method: str, path: str):
        """-> (handler, match_info); a handler raising 404 or 405 when
        nothing serves the request."""
        allowed = set()
        for r in self.routes:
            info = r.match(path)
            if info is None:
                continue
            if r.method == method or r.method == "*":
                return r.handler, info
            allowed.add(r.method)
        if allowed:
            async def not_allowed(request):
                raise HTTPMethodNotAllowed(method, allowed)
            return not_allowed, {}

        async def not_found(request):
            raise HTTPNotFound()
        return not_found, {}


class Application:
    def __init__(self, *, middlewares=(), client_max_size: int =
                 CLIENT_MAX_SIZE):
        self.router = UrlDispatcher()
        self.middlewares = list(middlewares)
        self.on_startup: list = []
        self.on_shutdown: list = []
        self.on_cleanup: list = []
        self._client_max_size = client_max_size

    async def _call(self, request: Request, handler):
        for mw in reversed(self.middlewares):
            handler = functools.partial(mw, handler=handler)
        return await handler(request)

    async def handle_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, raw = await read_request(reader, writer)
            except BadHttpMessage as e:
                await Response(status=400, text=str(e))._render(writer)
                return
            except HttpError as e:
                await Response(status=e.status, text=str(e))._render(writer)
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            handler, info = self.router.resolve(method, path)
            request = Request(method, path, raw, writer, self, info)
            try:
                resp = await self._call(request, handler)
            except HTTPException as e:
                resp = e
            except Exception:  # noqa: BLE001 — one request, not the server
                logger.exception("Error handling request %s", path)
                resp = HTTPInternalServerError(
                    text="500 Internal Server Error\n\n"
                         "Server got itself in trouble")
            if resp is None:
                raise RuntimeError(f"handler for {path} returned None")
            if resp.prepared:
                if not resp._eof and not resp.force_closed:
                    await resp.write_eof()
            elif isinstance(resp, Response):
                await resp._render(writer, head_only=method == "HEAD")
            else:
                await resp.prepare(request)
                await resp.write_eof()
        except ConnectionError:
            pass  # the client went away mid-response
        except Exception:  # noqa: BLE001
            logger.exception("request failed")
        finally:
            writer.close()


class AppRunner:
    def __init__(self, app: Application):
        self.app = app
        self.sites: list[TCPSite] = []

    async def setup(self) -> None:
        for cb in self.app.on_startup:
            await cb(self.app)

    async def cleanup(self) -> None:
        for site in self.sites:
            await site.stop()
        for cb in self.app.on_shutdown:
            await cb(self.app)
        for cb in self.app.on_cleanup:
            await cb(self.app)


class TCPSite:
    def __init__(self, runner: AppRunner, host: str = "0.0.0.0",
                 port: int = 8080):
        self.runner = runner
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        runner.sites.append(self)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self.runner.app.handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


def run_app(app: Application, host: str = "0.0.0.0", port: int = 8080,
            print=None) -> None:
    """Serve until SIGINT or SIGTERM, then run the cleanup callbacks."""

    async def main() -> None:
        runner = AppRunner(app)
        await runner.setup()
        site = TCPSite(runner, host, port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            await site.start()
            logger.info("listening on http://%s:%d", host, site.port)
            if print is not None:
                print(f"======== Running on http://{host}:{site.port} "
                      "========")
            await stop.wait()
        finally:
            await runner.cleanup()

    asyncio.run(main())
