"""XXH64 in pure Python: ``xxh64(data, seed)`` equals
``xxhash.xxh64(data, seed).intdigest()``.

The chain hash of a prefix-cache block is the content address every KV
tier, peer pull, cache server and controller keys blocks by, so it must
be the JAX package's xxh64 bit for bit: a block reported under another
hash would never be matched across engines. The machine with the card
has no ``xxhash`` package, hence this copy. Streaming xxh64 over a
sequence of ``update`` calls equals one-shot xxh64 of their
concatenation, so callers build the bytes first and hash them once.

It works on Python ints with explicit 64-bit masks, reading 8-byte lanes
with ``struct``: a 32-token block (136 bytes: four 32-byte stripes and an
8-byte tail) costs a few tens of microseconds.
"""

from __future__ import annotations

import struct

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M = 0xFFFFFFFFFFFFFFFF

_STRIPE = struct.Struct("<4Q")
_LANE = struct.Struct("<Q")
_WORD = struct.Struct("<I")


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    acc = ((acc << 31) | (acc >> 33)) & _M
    return (acc * _P1) & _M


def _merge(h: int, acc: int) -> int:
    h ^= _round(0, acc)
    return (h * _P1 + _P4) & _M


def xxh64(data: bytes, seed: int = 0) -> int:
    """The XXH64 digest of `data` as an unsigned 64-bit int."""
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        unpack = _STRIPE.unpack_from
        while p + 32 <= n:
            a, b, c, d = unpack(data, p)
            v1 = (v1 + a * _P2) & _M
            v1 = (((v1 << 31) | (v1 >> 33)) * _P1) & _M
            v2 = (v2 + b * _P2) & _M
            v2 = (((v2 << 31) | (v2 >> 33)) * _P1) & _M
            v3 = (v3 + c * _P2) & _M
            v3 = (((v3 << 31) | (v3 >> 33)) * _P1) & _M
            v4 = (v4 + d * _P2) & _M
            v4 = (((v4 << 31) | (v4 >> 33)) * _P1) & _M
            p += 32
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M
        h = _merge(h, v1)
        h = _merge(h, v2)
        h = _merge(h, v3)
        h = _merge(h, v4)
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while p + 8 <= n:
        h ^= _round(0, _LANE.unpack_from(data, p)[0])
        h = ((((h << 27) | (h >> 37)) & _M) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        h ^= (_WORD.unpack_from(data, p)[0] * _P1) & _M
        h = ((((h << 23) | (h >> 41)) & _M) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M
        h = ((((h << 11) | (h >> 53)) & _M) * _P1) & _M
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h
