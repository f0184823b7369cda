"""Chunked hash trie for prefix-aware routing.

Capability parity with the reference's HashTrie (reference:
src/vllm_router/prefix/hashtrie.py): request text is split into fixed-size
chunks, each chunk is hashed with xxh64 (utils/xxh64.py, equal to the
JAX router's xxhash.xxh64_intdigest of the chunk's UTF-8 bytes), and the
hash sequence forms a trie path.
Each node remembers which endpoints have served that prefix; routing walks
the trie for the longest prefix match restricted to currently-available
endpoints. Per-node asyncio locks keep concurrent inserts/lookups safe.
"""

from __future__ import annotations

import asyncio

from production_stack_tpu_torch.utils.xxh64 import xxh64

DEFAULT_CHUNK_SIZE = 128


class TrieNode:
    __slots__ = ("children", "endpoints", "lock")

    def __init__(self) -> None:
        self.children: dict[int, TrieNode] = {}
        self.endpoints: set[str] = set()
        self.lock = asyncio.Lock()


class HashTrie:
    def __init__(self, chunk_size: int = DEFAULT_CHUNK_SIZE):
        self.chunk_size = chunk_size
        self.root = TrieNode()

    def _chunk_hashes(self, text: str):
        for i in range(0, len(text), self.chunk_size):
            yield xxh64(text[i : i + self.chunk_size].encode("utf-8"))

    async def insert(self, text: str, endpoint: str) -> None:
        node = self.root
        for h in self._chunk_hashes(text):
            async with node.lock:
                nxt = node.children.get(h)
                if nxt is None:
                    nxt = TrieNode()
                    node.children[h] = nxt
            node = nxt
            async with node.lock:
                node.endpoints.add(endpoint)

    async def longest_prefix_match(
        self, text: str, available: set[str]
    ) -> tuple[int, set[str]]:
        """Returns (matched_chars, endpoints at the deepest matched node
        intersected with `available`). matched_chars counts whole chunks."""
        node = self.root
        matched = 0
        best: set[str] = set()
        for h in self._chunk_hashes(text):
            async with node.lock:
                nxt = node.children.get(h)
            if nxt is None:
                break
            candidates = nxt.endpoints & available
            if not candidates:
                break
            node = nxt
            best = candidates
            matched += self.chunk_size
        return min(matched, len(text)), best

    def remove_endpoint(self, endpoint: str) -> None:
        """Drop an endpoint everywhere (called when a pod dies)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            node.endpoints.discard(endpoint)
            stack.extend(node.children.values())
