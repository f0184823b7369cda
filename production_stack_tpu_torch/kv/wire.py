"""Framing for the KV controller / cache-server TCP protocols.

One message = 8-byte header (two big-endian u32: meta_len, payload_len),
then meta_len bytes of UTF-8 JSON, then payload_len raw bytes. The JSON
carries the command and small fields; bulk KV block data rides in the raw
payload so it is never base64'd (role equivalent of LMCache's msgpack
protocol, reference routing_logic.py:32-37).
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct

_HDR = struct.Struct(">II")

# a KV block of a 70B-class model is ~MBs; cap frames defensively
MAX_META = 64 * 2**20
MAX_PAYLOAD = 1 * 2**30


class WireError(RuntimeError):
    pass


def parse_addr(addr: str, default_port: int) -> tuple[str, int]:
    """'host:port' / 'host' / ':port' -> (host, port) with defaults."""
    host, sep, port = addr.rpartition(":")
    if not sep:  # no colon: the whole string is the host
        return (addr or "127.0.0.1", default_port)
    return (host or "127.0.0.1", int(port))


def encode_msg(obj: dict, payload: bytes = b"") -> bytes:
    meta = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    return _HDR.pack(len(meta), len(payload)) + meta + payload


# -- asyncio side -----------------------------------------------------------
async def send_msg(
    writer: asyncio.StreamWriter, obj: dict, payload: bytes = b""
) -> None:
    writer.write(encode_msg(obj, payload))
    await writer.drain()


async def recv_msg(reader: asyncio.StreamReader) -> tuple[dict, bytes]:
    hdr = await reader.readexactly(_HDR.size)
    meta_len, payload_len = _HDR.unpack(hdr)
    if meta_len > MAX_META or payload_len > MAX_PAYLOAD:
        raise WireError(f"oversized frame: meta={meta_len} payload={payload_len}")
    meta = await reader.readexactly(meta_len)
    payload = await reader.readexactly(payload_len) if payload_len else b""
    return json.loads(meta), payload


# -- blocking-socket side (engine reporter / offload worker threads) --------
def sync_send(sock: socket.socket, obj: dict, payload: bytes = b"") -> None:
    sock.sendall(encode_msg(obj, payload))


def _recvexact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WireError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def sync_recv(sock: socket.socket) -> tuple[dict, bytes]:
    meta_len, payload_len = _HDR.unpack(_recvexact(sock, _HDR.size))
    if meta_len > MAX_META or payload_len > MAX_PAYLOAD:
        raise WireError(f"oversized frame: meta={meta_len} payload={payload_len}")
    meta = _recvexact(sock, meta_len)
    payload = _recvexact(sock, payload_len) if payload_len else b""
    return json.loads(meta), payload
