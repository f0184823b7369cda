"""HTTP/1.1 on stdlib asyncio, shared by the engine server and the router.

The machine with the card has neither aiohttp nor any other HTTP package,
so the port speaks HTTP/1.1 itself:

- **Server side:** ``read_request`` parses one request (head, then a
  ``Content-Length`` or chunked body, with aiohttp's 400 texts for the
  framings it refuses), ``head`` writes a response head (a body of
  unknown length is sent chunked). A connection serves request after
  request, as aiohttp's server does, until the client sends
  ``Connection: close`` (or speaks HTTP/1.0 without keep-alive) or sits
  idle for ``KEEPALIVE_TIMEOUT_S`` (aiohttp's 75 s).
- **Client side:** ``ClientSession`` is the subset of aiohttp's client
  the router uses: ``get`` / ``post`` / ``patch`` / ``delete`` as async
  context managers (``json=``, ``data=``, ``params=``, ``headers=``,
  ``ssl=``, ``timeout=``), a response with ``status``, case-insensitive
  ``headers``, ``read`` / ``text`` / ``json`` / ``raise_for_status`` and
  ``content``, whose ``iter_any()`` yields the body as it arrives (chunked
  encoding decoded, ``Content-Length`` or connection close ended) and
  whose async iteration yields lines. A server-sent event stream is
  relayed chunk by chunk this way, never buffered to its end. The
  session pools connections per (host, port, ssl) with no limit, as
  aiohttp's ``TCPConnector(limit=0)`` does: a connection goes back to
  the pool once its response body was read to its end and the server
  did not ask to close it; a body left unread, a cut stream, an error or
  a timeout closes it. A pooled connection idle past
  ``POOL_KEEPALIVE_S`` (the connector's 15 s) is closed, and a request
  whose pooled connection the server closed while it sat idle is sent
  once more on a fresh one, as aiohttp retries. Failures raise
  ``ClientError`` subclasses; timeouts raise ``asyncio.TimeoutError``, as
  aiohttp's do.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import ssl as _ssl
import time
from collections.abc import Iterator, Mapping, MutableMapping
from urllib.parse import parse_qs, urlencode, urlsplit

REASONS = {
    100: "Continue", 200: "OK", 201: "Created", 204: "No Content",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway", 503: "Service Unavailable",
    504: "Gateway Timeout",
}
MAX_BODY_BYTES = 64 * 2**20
# a server connection idle this long between requests is closed
# (aiohttp's server keepalive_timeout)
KEEPALIVE_TIMEOUT_S = 75.0
# a pooled client connection idle this long is closed rather than reused
# (aiohttp's TCPConnector keepalive_timeout)
POOL_KEEPALIVE_S = 15.0
_HEX_DIGITS = b"0123456789abcdefABCDEF"


# -- server side ---------------------------------------------------------------
class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type


class BadHttpMessage(HttpError):
    """A request head the HTTP parser refuses: 400 with aiohttp's plain
    text body (the reference server's parser answers these before any
    handler runs)."""

    def __init__(self, message: str):
        super().__init__(400, message)


@dataclasses.dataclass
class HttpRequest:
    body: bytes
    headers: dict[str, str]  # lower-cased names
    query: dict[str, str]
    # (name, value) as sent, in order (a proxy forwards these)
    raw_headers: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)
    version: str = "HTTP/1.1"

    @property
    def keep_alive(self) -> bool:
        """Whether the client lets the connection serve another request
        after this one: HTTP/1.1 unless it sent ``Connection: close``,
        HTTP/1.0 only with ``Connection: keep-alive``."""
        tokens = {t.strip().lower() for t in
                  self.headers.get("connection", "").split(",")}
        if self.version.upper() == "HTTP/1.0":
            return "keep-alive" in tokens
        return "close" not in tokens


async def read_request(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter | None = None,
                       idle_timeout: float | None = None):
    """One request off the connection -> (METHOD, path, HttpRequest).
    With a writer, an ``Expect: 100-continue`` is answered before the
    body is read (curl sends it for bodies past 1 KiB). `idle_timeout`
    bounds the wait for the request line (asyncio.TimeoutError)."""
    line = await (reader.readline() if idle_timeout is None
                  else asyncio.wait_for(reader.readline(), idle_timeout))
    if not line:
        raise asyncio.IncompleteReadError(b"", None)
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise HttpError(400, "malformed request line") from None
    headers: dict[str, str] = {}
    lines: dict[str, bytes] = {}
    raw: list[tuple[str, str]] = []
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        # header bytes as aiohttp reads them: utf-8, surrogateescape
        name, _, value = h.decode("utf-8", "surrogateescape").partition(":")
        headers[name.strip().lower()] = value.strip()
        lines[name.strip().lower()] = h.rstrip(b"\r\n")
        raw.append((name.strip(), value.strip()))
    if (writer is not None
            and headers.get("expect", "").lower() == "100-continue"):
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await read_chunked(reader)
    else:
        length = content_length(headers.get("content-length"),
                                lines.get("content-length"))
        if length > MAX_BODY_BYTES:
            raise HttpError(413, "request body too large")
        body = await reader.readexactly(length) if length else b""
    path, _, qs = target.partition("?")
    query = {k: v[-1] for k, v in parse_qs(qs).items()}
    return method.upper(), path, HttpRequest(body, headers, query, raw,
                                             version)


def content_length(value: str | None, line: bytes | None) -> int:
    """The body length of a Content-Length value: ASCII digits only, as
    aiohttp's parser takes it (no sign, no underscore, whitespace only
    after the digits); any other value is its 400 with its message, a
    caret under the first character it refuses."""
    if value is None:
        return 0
    bad, gap = (None if value else 0), False
    for i, c in enumerate(value):
        if c in " \t":
            gap = True  # whitespace may only trail the digits
        elif c not in "0123456789" or gap:
            bad = i
            break
    if bad is None:
        return int(value)
    col = line.index(b":") + 1
    while line[col:col + 1] in (b" ", b"\t"):
        col += 1
    # the repr's "b'" and the two spaces of indent before the caret
    raise BadHttpMessage(
        f"Invalid character in Content-Length:\n\n  {line!r}\n"
        + " " * (col + bad + 4) + "^")


async def read_chunked(reader: asyncio.StreamReader) -> bytes:
    """A Transfer-Encoding: chunked body (sizes in hex digits only,
    extensions after ';' ignored, trailers skipped), capped at
    MAX_BODY_BYTES. A size line or a chunk end that aiohttp's parser
    refuses is its 400 with its message (_chunk_error)."""
    parts: list[bytes] = []
    total = 0
    while True:
        size_line = await reader.readline()
        if not size_line:
            raise asyncio.IncompleteReadError(b"", None)
        line = size_line.rstrip(b"\r\n")
        digits = len(line) - len(line.lstrip(_HEX_DIGITS))
        after = line[digits:digits + 1]
        if digits == 0 or after not in (b"", b";"):
            # aiohttp places the caret past a blank after the digits
            raise _chunk_error("Invalid character in chunk size", line,
                               digits + (digits > 0 and after in b" \t"))
        if not size_line.endswith(b"\r\n"):
            raise _chunk_error("Missing expected CR after chunk size",
                               size_line, len(size_line))
        size = int(line[:digits], 16)
        if size == 0:
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass  # trailers
            return b"".join(parts)
        total += size
        if total > MAX_BODY_BYTES:
            raise HttpError(413, "request body too large")
        parts.append(await reader.readexactly(size))
        end = await reader.readexactly(2)
        if end != b"\r\n":
            # the excerpt: the chunk since its last CRLF, then the two
            # bytes read after it (aiohttp's runs on through its
            # receive buffer to the next CRLF)
            tail = parts[-1].rsplit(b"\r\n", 1)[-1]
            raise _chunk_error("Expected LF after chunk data",
                               tail + end.split(b"\r")[0], len(tail))


def _chunk_error(reason: str, data: bytes, at: int) -> BadHttpMessage:
    """aiohttp's 400 text for a chunked body its parser refuses at byte
    `at` of `data`: the reason, the excerpt's repr and a caret under
    that byte."""
    return BadHttpMessage(f"{reason}:\n\n  {data!r}\n"
                          + " " * (len(repr(data[:at])) + 1) + "^")


def http_date() -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())


def head(status: int, content_type: str, length: int | None,
         extra: dict[str, str] | None = None, close: bool = False) -> bytes:
    """A response head: a body of `length` bytes, or (None) a chunked
    one; `close` says the connection ends after this response."""
    lines = [
        f"HTTP/1.1 {status} {REASONS.get(status, 'Error')}",
        f"Content-Type: {content_type}",
        f"Date: {http_date()}",
    ]
    if close:
        lines.append("Connection: close")
    if length is not None:
        lines.append(f"Content-Length: {length}")
    else:
        lines += ["Transfer-Encoding: chunked", "Cache-Control: no-cache"]
    lines += [f"{k}: {v}" for k, v in (extra or {}).items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


# -- headers ---------------------------------------------------------------------
class Headers(MutableMapping):
    """Case-insensitive header map that keeps each name as it was first
    set (``dict(h)`` and ``h.items()`` give those names), as aiohttp's
    CIMultiDict does for single-valued headers."""

    def __init__(self, items=None):
        self._d: dict[str, tuple[str, str]] = {}
        if items is not None:
            pairs = items.items() if isinstance(items, Mapping) else items
            for k, v in pairs:
                self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value: str) -> None:
        low = key.lower()
        old = self._d.get(low)
        self._d[low] = (old[0] if old else key, str(value))

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __iter__(self) -> Iterator[str]:
        return (k for k, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.lower() in self._d

    def __repr__(self) -> str:
        return f"Headers({dict(self)!r})"


# -- client side -----------------------------------------------------------------
class ClientError(Exception):
    """Base of every client failure (aiohttp.ClientError's role)."""


class ClientConnectionError(ClientError):
    pass


class ClientOSError(ClientConnectionError, OSError):
    pass


class ClientConnectorError(ClientOSError):
    """The connection could not be opened (aiohttp's text)."""

    def __init__(self, host: str, port: int, ssl, err: OSError):
        super().__init__(err.errno, err.strerror or str(err))
        self.host, self.port, self.ssl = host, port, ssl

    def __str__(self) -> str:
        ssl = "default" if self.ssl in (None, True) else self.ssl
        return (f"Cannot connect to host {self.host}:{self.port} "
                f"ssl:{ssl} [{self.strerror}]")


class ServerDisconnectedError(ClientConnectionError):
    def __init__(self, message: str = "Server disconnected"):
        super().__init__(message)


class ClientPayloadError(ClientError):
    """The response body broke off or was malformed."""


class ClientResponseError(ClientError):
    def __init__(self, status: int, message: str = "", url: str = ""):
        super().__init__(f"{status}, message={message!r}, url={url!r}")
        self.status = status
        self.message = message
        self.url = url


class ContentTypeError(ClientResponseError):
    pass


@dataclasses.dataclass
class ClientTimeout:
    """aiohttp's timeout fields: ``total`` bounds the whole request,
    body included; ``connect`` / ``sock_connect`` the connect;
    ``sock_read`` each read."""
    total: float | None = None
    connect: float | None = None
    sock_read: float | None = None
    sock_connect: float | None = None


class _Clock:
    def __init__(self, timeout: ClientTimeout):
        self.t = timeout
        self.deadline = (time.monotonic() + timeout.total
                         if timeout.total else None)

    def _left(self) -> float | None:
        return (None if self.deadline is None
                else max(0.0, self.deadline - time.monotonic()))

    def bound(self, *limits: float | None) -> float | None:
        vals = [v for v in (self._left(), *limits) if v is not None]
        return min(vals) if vals else None

    async def run(self, coro, *limits: float | None):
        t = self.bound(*limits)
        return await (coro if t is None else asyncio.wait_for(coro, t))


class StreamBody:
    """A response body read off its connection as it arrives."""

    def __init__(self, reader: asyncio.StreamReader, mode: str,
                 length: int, clock: _Clock):
        self._reader = reader
        self._mode = mode  # "length" | "chunked" | "close" | "none"
        self._left = length  # bytes left of the body or of the chunk
        self._clock = clock
        self._eof = mode == "none" or (mode == "length" and length == 0)
        self._lines = b""

    async def _read(self, coro):
        try:
            return await self._clock.run(coro, self._clock.t.sock_read)
        except asyncio.IncompleteReadError as e:
            raise ClientPayloadError(
                "Response payload is not completed") from e
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ServerDisconnectedError(str(e)) from e

    async def readany(self) -> bytes:
        """The next bytes of the body as they arrive; b"" at its end."""
        if self._lines:
            data, self._lines = self._lines, b""
            return data
        if self._eof:
            return b""
        r = self._reader
        if self._mode == "length":
            data = await self._read(r.read(min(self._left, 2**16)))
            if not data:
                raise ClientPayloadError(
                    "Response payload is not completed: "
                    f"{self._left} bytes short")
            self._left -= len(data)
            self._eof = self._left == 0
            return data
        if self._mode == "close":
            data = await self._read(r.read(2**16))
            self._eof = not data
            return data
        # chunked
        if self._left == 0:
            size_line = await self._read(r.readline())
            if not size_line:
                raise ClientPayloadError("Response payload is not completed")
            digits = size_line.split(b";", 1)[0].strip()
            try:
                self._left = int(digits, 16)
            except ValueError:
                raise ClientPayloadError(
                    f"invalid chunk size {digits!r}") from None
            if self._left == 0:
                while (await self._read(r.readline())) not in (
                        b"\r\n", b"\n", b""):
                    pass  # trailers
                self._eof = True
                return b""
        data = await self._read(r.read(min(self._left, 2**16)))
        if not data:
            raise ClientPayloadError("Response payload is not completed")
        self._left -= len(data)
        if self._left == 0:
            await self._read(r.readexactly(2))  # the chunk's CRLF
        return data

    async def iter_any(self):
        while True:
            data = await self.readany()
            if not data:
                return
            yield data

    async def read(self) -> bytes:
        parts = [data async for data in self.iter_any()]
        return b"".join(parts)

    async def readline(self) -> bytes:
        while b"\n" not in self._lines:
            if self._eof:
                line, self._lines = self._lines, b""
                return line
            pending, self._lines = self._lines, b""
            self._lines = pending + await self.readany()
        line, _, self._lines = self._lines.partition(b"\n")
        return line + b"\n"

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        line = await self.readline()
        if not line:
            raise StopAsyncIteration
        return line


class ClientResponse:
    def __init__(self, method: str, url: str, status: int, reason: str,
                 headers: Headers, content: StreamBody, writer,
                 release=None):
        self.method = method
        self.url = url
        self.status = status
        self.reason = reason
        self.headers = headers
        self.content = content
        self._writer = writer
        # hands the connection back to its session's pool (None: the
        # connection closes with the response)
        self._release = release
        self._body: bytes | None = None

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
        if self._body is None:
            self._body = await self.content.read()
        return self._body

    async def text(self, encoding: str | None = None) -> str:
        return (await self.read()).decode(
            encoding or self.charset or "utf-8")

    async def json(self, *, content_type: str | None = "application/json",
                   loads=json.loads):
        body = await self.read()
        if content_type and content_type not in self.content_type:
            raise ContentTypeError(
                self.status, "Attempt to decode JSON with unexpected "
                f"mimetype: {self.content_type}", self.url)
        if not body.strip():
            return None
        return loads(body.decode(self.charset or "utf-8"))

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise ClientResponseError(self.status, self.reason, self.url)

    def close(self) -> None:
        """Done with the response: its connection goes back to the pool
        when the body was read to its end and the server keeps it open,
        and closes otherwise."""
        if self._writer is not None:
            if self._release is not None and self.content._eof:
                self._release()
            else:
                self._writer.close()
            self._writer = None


class _RequestContext:
    def __init__(self, coro):
        self._coro = coro
        self._resp: ClientResponse | None = None

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            self._resp.close()


def _ssl_context(value) -> _ssl.SSLContext | None:
    if isinstance(value, _ssl.SSLContext):
        return value
    if value is False:
        ctx = _ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = _ssl.CERT_NONE
        return ctx
    return _ssl.create_default_context()


class ClientSession:
    """aiohttp.ClientSession's subset on stdlib asyncio (see the module
    docstring), its connections pooled per (host, port, ssl)."""

    def __init__(self, timeout: ClientTimeout | None = None,
                 headers: dict | None = None, **_ignored):
        self.timeout = timeout or ClientTimeout(total=300.0)
        self.headers = dict(headers or {})
        self._closed = False
        # idle connections by (host, port, ssl): (reader, writer, since)
        self._pool: dict[tuple, list] = {}
        # connections this session opened
        self.connections_opened = 0

    @property
    def closed(self) -> bool:
        return self._closed

    async def close(self) -> None:
        self._closed = True
        for conns in self._pool.values():
            for _, writer, _ in conns:
                writer.close()
        self._pool.clear()

    def _acquire(self, key: tuple):
        """An idle pooled connection of `key` the server has not closed,
        or None."""
        conns = self._pool.get(key)
        now = time.monotonic()
        while conns:
            reader, writer, since = conns.pop()
            if (now - since > POOL_KEEPALIVE_S or reader.at_eof()
                    or writer.is_closing()):
                writer.close()
                continue
            return reader, writer
        return None

    def _put_back(self, key: tuple, reader, writer) -> None:
        if self._closed or writer.is_closing() or reader.at_eof():
            writer.close()
            return
        self._pool.setdefault(key, []).append(
            (reader, writer, time.monotonic()))

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def get(self, url: str, **kw) -> _RequestContext:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> _RequestContext:
        return self.request("POST", url, **kw)

    def patch(self, url: str, **kw) -> _RequestContext:
        return self.request("PATCH", url, **kw)

    def delete(self, url: str, **kw) -> _RequestContext:
        return self.request("DELETE", url, **kw)

    def request(self, method: str, url: str, **kw) -> _RequestContext:
        return _RequestContext(self._request(method, url, **kw))

    async def _request(self, method: str, url: str, *, json=None,
                       data=None, params=None, headers=None, ssl=None,
                       timeout: ClientTimeout | None = None
                       ) -> ClientResponse:
        if self._closed:
            raise ClientError("Session is closed")
        clock = _Clock(timeout or self.timeout)
        parts = urlsplit(url)
        secure = parts.scheme == "https"
        host = parts.hostname or "127.0.0.1"
        port = parts.port or (443 if secure else 80)
        target = parts.path or "/"
        query = parts.query
        if params:
            extra = urlencode({k: str(v) for k, v in params.items()})
            query = f"{query}&{extra}" if query else extra
        if query:
            target += "?" + query
        hdrs = Headers(self.headers)
        for k, v in (headers or {}).items():
            hdrs[k] = v
        body = b""
        if json is not None:
            import json as _json

            body = _json.dumps(json).encode()
            hdrs.setdefault("Content-Type", "application/json")
        elif data is not None:
            body = data.encode() if isinstance(data, str) else bytes(data)
        host_hdr = f"{host}:{port}" if parts.port else host
        if ":" in host and not host.startswith("["):
            host_hdr = f"[{host}]:{port}"
        hdrs.setdefault("Host", host_hdr)
        hdrs.setdefault("Accept", "*/*")
        hdrs["Content-Length"] = str(len(body))
        for k in [k for k in hdrs if k.lower() == "transfer-encoding"]:
            del hdrs[k]
        lines = [f"{method} {target} HTTP/1.1"] + [
            f"{k}: {v}" for k, v in hdrs.items()]
        data = ("\r\n".join(lines) + "\r\n\r\n").encode(
            "utf-8", "surrogateescape") + body
        key = (host, port, secure, ssl if secure else None)
        pooled = self._acquire(key)
        while True:
            if pooled is not None:
                reader, writer = pooled
            else:
                try:
                    reader, writer = await clock.run(
                        asyncio.open_connection(
                            host, port,
                            ssl=_ssl_context(ssl) if secure else None,
                            server_hostname=host if secure else None),
                        clock.t.sock_connect, clock.t.connect)
                except asyncio.TimeoutError:
                    raise
                except OSError as e:
                    raise ClientConnectorError(host, port, ssl, e) from e
                self.connections_opened += 1
            try:
                writer.write(data)
                await clock.run(writer.drain())
                resp = await self._read_head(
                    method, url, reader, writer, clock,
                    release=lambda r=reader, w=writer: self._put_back(
                        key, r, w))
            except (ServerDisconnectedError, ConnectionResetError,
                    BrokenPipeError):
                writer.close()
                if pooled is None:
                    raise
                # the server closed the pooled connection while it sat
                # idle: once more on a fresh one
                pooled = None
                continue
            except BaseException:
                writer.close()
                raise
            return resp

    async def _read_head(self, method, url, reader, writer, clock,
                         release=None) -> ClientResponse:
        async def readline() -> bytes:
            try:
                return await clock.run(reader.readline(),
                                       clock.t.sock_read)
            except (ConnectionResetError, BrokenPipeError) as e:
                raise ServerDisconnectedError(str(e)) from e

        while True:
            status_line = await readline()
            if not status_line:
                raise ServerDisconnectedError()
            try:
                version, code, *rest = status_line.decode("latin-1").split(
                    None, 2)
                status = int(code)
            except ValueError:
                raise ClientPayloadError(
                    f"bad status line {status_line!r}") from None
            hdrs = Headers()
            while True:
                h = await readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                name, _, value = h.decode(
                    "utf-8", "surrogateescape").partition(":")
                hdrs[name.strip()] = value.strip()
            if status != 100:
                break  # an interim 100 Continue is skipped
        reason = rest[0].strip() if rest else ""
        if (method == "HEAD" or status in (204, 304)
                or 100 <= status < 200):
            mode, length = "none", 0
        elif "chunked" in hdrs.get("Transfer-Encoding", "").lower():
            mode, length = "chunked", 0
        elif "Content-Length" in hdrs:
            mode, length = "length", int(hdrs["Content-Length"])
        else:
            mode, length = "close", 0
        conn = {t.strip().lower()
                for t in hdrs.get("Connection", "").split(",")}
        # reusable once its body is read: HTTP/1.1, framed, not closing
        keep = (version.upper() == "HTTP/1.1" and mode != "close"
                and "close" not in conn)
        return ClientResponse(method, url, status, reason, hdrs,
                              StreamBody(reader, mode, length, clock),
                              writer, release=release if keep else None)
