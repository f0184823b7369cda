"""Consistent hash ring for session-sticky routing.

Replaces the reference's external `uhashring` dependency (reference:
src/vllm_router/routers/routing_logic.py:112 `_update_hash_ring`) with a
self-contained implementation: ketama-style virtual nodes on a sorted ring,
stable under endpoint add/remove (only ~1/n of keys move).
"""

from __future__ import annotations

import bisect

from production_stack_tpu_torch.utils.xxh64 import xxh64


def _hash(key: str) -> int:
    # xxhash.xxh64_intdigest(key) of the JAX router: xxh64 of the UTF-8
    # bytes, seed 0, so a session lands where the JAX router sends it
    return xxh64(key.encode("utf-8"))


class HashRing:
    def __init__(self, nodes: list[str] | None = None, vnodes: int = 100):
        self.vnodes = vnodes
        self._ring: list[tuple[int, str]] = []
        self._keys: list[int] = []
        self._nodes: set[str] = set()
        for n in nodes or []:
            self.add_node(n)

    @property
    def nodes(self) -> set[str]:
        return set(self._nodes)

    def add_node(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.vnodes):
            self._ring.append((_hash(f"{node}#{i}"), node))
        self._ring.sort()
        self._keys = [h for h, _ in self._ring]

    def remove_node(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]
        self._keys = [h for h, _ in self._ring]

    def set_nodes(self, nodes: list[str]) -> None:
        target = set(nodes)
        for n in self._nodes - target:
            self.remove_node(n)
        for n in target - self._nodes:
            self.add_node(n)

    def get_node(self, key: str) -> str | None:
        if not self._ring:
            return None
        h = _hash(key)
        idx = bisect.bisect(self._keys, h) % len(self._ring)
        return self._ring[idx][1]
