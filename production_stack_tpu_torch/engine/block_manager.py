"""Paged KV block manager with hash-based prefix caching.

TPU-native equivalent of the KV-block bookkeeping the reference stack gets
from vLLM + LMCache (the router scrapes its effects as
`vllm:gpu_cache_usage_perc` / `vllm:gpu_prefix_cache_hit_rate`, reference:
src/vllm_router/stats/engine_stats.py:63-76). Pure host-side Python: the
device only ever sees flat slot indices, so this logic never enters jit.

Prefix caching: a *full* block of block_size tokens is content-addressed by
the chain hash of all tokens up to and including that block. Blocks with
ref_count 0 stay in an LRU "evictable" pool and can be resurrected on a hash
hit (same design as vLLM's prefix caching / LMCache's local backend).

Block 0 is reserved as the null/trash block: padded batch lanes write their
garbage K/V there, so it is never handed to a sequence.
"""

from __future__ import annotations

import struct
from collections import OrderedDict

from production_stack_tpu_torch.utils.xxh64 import xxh64

NULL_BLOCK = 0


def hash_block(prev_hash: int, token_ids: tuple[int, ...],
               extra: tuple = ()) -> int:
    """Chain hash for a full block given the previous block's hash: the
    JAX package's xxh64 over the 8-byte little-endian previous hash, each
    token as 4 little-endian bytes, then str(e) of each extra."""
    data = prev_hash.to_bytes(8, "little", signed=False) + struct.pack(
        f"<{len(token_ids)}I", *token_ids)
    if extra:
        data += b"".join(str(e).encode() for e in extra)
    return xxh64(data)


def iter_chain_hashes(token_ids, block_size: int, seed: int = 0):
    """Chain hashes for each *full* block of token_ids, lazily.

    THE one token->block-hash folding, shared by the BlockManager, the
    KV controller's prefix matcher, and the router's shared-cache
    lookup hints — every copy of this loop that drifts (seed, chunk
    boundary, partial-block handling) makes cross-component prefix
    matches miss silently, so there is exactly one. Lazy so matchers
    can stop hashing at the first miss."""
    prev = seed
    for i in range(len(token_ids) // block_size):
        prev = hash_block(
            prev, tuple(token_ids[i * block_size:(i + 1) * block_size])
        )
        yield prev


class Block:
    __slots__ = ("block_id", "ref_count", "block_hash")

    def __init__(self, block_id: int):
        self.block_id = block_id
        self.ref_count = 0
        self.block_hash: int | None = None


class BlockManager:
    """Allocator for a fixed pool of KV blocks, with prefix caching."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
    ):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching

        self.blocks = [Block(i) for i in range(num_blocks)]
        # bumped on every free(): see the note there
        self.free_epoch = 0
        # block 0 reserved as null/trash
        self.free_blocks: list[int] = list(range(num_blocks - 1, 0, -1))
        # hash -> block_id for cached full blocks (ref>=0)
        self.cached_blocks: dict[int, int] = {}
        # block_id -> None, LRU order, for ref_count==0 cached blocks
        self.evictable: OrderedDict[int, None] = OrderedDict()

        # token-level prefix-cache counters (engine /metrics contract)
        self.prefix_queries = 0
        self.prefix_hits = 0

        # KV offload hooks (wired by LLMEngine when offload is configured):
        # on_admit(hashes)      -> new cached blocks live in HBM
        # on_evict(hashes)      -> cached blocks dropped from HBM
        # on_freed_cached(pairs)-> [(block_id, hash)] just became evictable;
        #                          contents still intact, safe to d2h-export
        self.on_admit = None
        self.on_evict = None
        self.on_freed_cached = None
        # deferred-export pins: freed-but-cached blocks whose device-side
        # snapshot has not been enqueued yet (see pin_for_export)
        self._export_pins: set[int] = set()

    # -- capacity ---------------------------------------------------------
    @property
    def num_free_blocks(self) -> int:
        return len(self.free_blocks) + len(self.evictable)

    @property
    def usage(self) -> float:
        """Fraction of blocks actively referenced (the vllm:gpu_cache_usage_perc)."""
        usable = self.num_blocks - 1
        return (usable - self.num_free_blocks) / max(1, usable)

    def can_allocate(self, num_new_blocks: int) -> bool:
        return self.num_free_blocks >= num_new_blocks

    # -- low-level alloc --------------------------------------------------
    def _pop_free_block(self) -> int:
        if self.free_blocks:
            return self.free_blocks.pop()
        if self.evictable:
            bid, _ = self.evictable.popitem(last=False)  # LRU
            blk = self.blocks[bid]
            if blk.block_hash is not None:
                self.cached_blocks.pop(blk.block_hash, None)
                if self.on_evict is not None:
                    self.on_evict([blk.block_hash])
                blk.block_hash = None
            return bid
        raise RuntimeError("out of KV blocks")

    def _take(self, bid: int) -> None:
        blk = self.blocks[bid]
        if blk.ref_count == 0 and bid in self.evictable:
            del self.evictable[bid]
        blk.ref_count += 1

    # -- sequence-level API ----------------------------------------------
    def block_hashes_for(self, token_ids: list[int],
                         seed: int = 0) -> list[int]:
        """Chain hashes for each *full* block of token_ids.

        `seed` starts the chain (0 = base model; LoRA requests pass a
        per-adapter seed so adapters never share KV blocks)."""
        return list(
            iter_chain_hashes(token_ids, self.block_size, seed)
        )

    def contains_hash(self, h: int) -> bool:
        return h in self.cached_blocks

    def match_prefix(self, token_ids: list[int],
                     seed: int = 0) -> tuple[list[int], int]:
        """Longest cached prefix: returns (block_ids, num_cached_tokens).

        Does NOT take references; pairs with allocate_prompt.
        """
        if not self.enable_prefix_caching:
            return [], 0
        matched: list[int] = []
        for h in self.block_hashes_for(token_ids, seed):
            bid = self.cached_blocks.get(h)
            if bid is None:
                break
            matched.append(bid)
        return matched, len(matched) * self.block_size

    def allocate_prompt(
        self, token_ids: list[int], seed: int = 0,
        reuse_cache: bool = True,
    ) -> tuple[list[int], int] | None:
        """Allocate the block table for a prompt, reusing cached prefix blocks.

        Returns (block_table, num_cached_tokens) or None if out of blocks.
        num_cached_tokens is capped at len(token_ids)-1 so at least one token
        is computed (we need its logits to start decoding).

        `reuse_cache=False` skips prefix matching (the computed blocks
        still REGISTER afterwards): prompt_logprobs needs every position
        actually computed — a cache hit would skip its rows."""
        n = len(token_ids)
        self.prefix_queries += n
        if not reuse_cache:
            matched, cached_tokens = [], 0
        else:
            matched, cached_tokens = self.match_prefix(token_ids, seed)
        cached_tokens = min(cached_tokens, n - 1)
        num_matched_blocks = cached_tokens // self.block_size
        matched = matched[:num_matched_blocks]
        # re-floor to the adopted block boundary: after the n-1 cap the
        # token count must match the blocks actually taken, otherwise a
        # fully-cached prompt whose length is a block multiple starts
        # computing at a position whose preceding KV was never adopted
        # (attention over zero blocks => corrupt logits)
        cached_tokens = num_matched_blocks * self.block_size

        total_blocks = (n + self.block_size - 1) // self.block_size
        need_new = total_blocks - len(matched)
        # matched blocks sitting in the evictable pool stop being free the
        # moment we take them, so they must not count toward need_new
        evictable_matched = sum(1 for b in matched if b in self.evictable)
        if self.num_free_blocks - evictable_matched < need_new:
            self.prefix_queries -= n  # admission failed; don't skew stats
            return None

        self.prefix_hits += cached_tokens
        table = []
        for bid in matched:
            self._take(bid)
            table.append(bid)
        for _ in range(need_new):
            bid = self._pop_free_block()
            self._take(bid)
            table.append(bid)
        return table, cached_tokens

    def ensure_capacity(
        self, num_tokens: int, block_table: list[int]
    ) -> bool:
        """Grow block_table (in place) until it covers num_tokens positions.

        Returns False if a new block was needed but none was available.
        """
        while len(block_table) * self.block_size < num_tokens:
            if self.num_free_blocks == 0:
                return False
            bid = self._pop_free_block()
            self._take(bid)
            block_table.append(bid)
        return True

    def register_block(
        self, prev_hash: int, token_ids: tuple[int, ...], block_id: int
    ) -> int:
        """Incrementally content-address one full block; returns its hash."""
        h = hash_block(prev_hash, token_ids)
        if not self.enable_prefix_caching:
            return h
        blk = self.blocks[block_id]
        if blk.block_hash is None and h not in self.cached_blocks:
            blk.block_hash = h
            self.cached_blocks[h] = block_id
            if self.on_admit is not None:
                self.on_admit([h])
        return h

    def adopt_cached_block(self, h: int) -> int | None:
        """Claim a free block to hold offload-restored contents for hash h.

        The block enters the cache ref_count==0 and evictable, exactly like
        a block left behind by a finished sequence; the caller must import
        the KV contents before the next model step. Returns None when no
        block can be claimed (restore is best-effort, admission continues
        with whatever prefix is already in HBM).
        """
        if not self.enable_prefix_caching or h in self.cached_blocks:
            return None
        if not self.free_blocks and not self.evictable:
            return None
        bid = self._pop_free_block()
        blk = self.blocks[bid]
        blk.block_hash = h
        self.cached_blocks[h] = bid
        self.evictable[bid] = None
        if self.on_admit is not None:
            self.on_admit([h])
        return bid

    def can_adopt_another(self, n_adopted: int) -> bool:
        """True while one more adopt_cached_block cannot cannibalize the
        caller's own freshly-adopted blocks. Adopted blocks enter the
        evictable pool (newest end), so _pop_free_block only reaches
        them once free_blocks is empty AND every OLDER evictable entry
        is consumed — i.e. when the caller's n_adopted blocks are all
        that remains. Evicting one would hand its block id out twice in
        the same restore: a donated scatter with duplicate destination
        indices has undefined write order, leaving a live cache hash
        holding another hash's KV."""
        return len(self.free_blocks) + len(self.evictable) > n_adopted

    def drop_cached_block(self, h: int) -> None:
        """Remove an UNREFERENCED cached block from the cache and return
        it to the free pool (a restore landing failed AFTER adoption —
        leaving the entry would serve never-written garbage KV to every
        later prefix hit on this hash)."""
        bid = self.cached_blocks.pop(h, None)
        if bid is None:
            return
        blk = self.blocks[bid]
        assert blk.ref_count == 0, "drop_cached_block on a live block"
        blk.block_hash = None
        if bid in self.evictable:
            del self.evictable[bid]
        self.free_blocks.append(bid)
        if self.on_evict is not None:
            self.on_evict([h])

    # -- deferred-export pinning -------------------------------------------
    def pin_for_export(self, block_ids: list[int]) -> None:
        """Take freed-but-cached blocks out of the reusable pools until
        their deferred d2h export snapshot is enqueued (unpin_exported).

        A pinned block keeps its cache entry — prefix hits may still
        re-take it (contents are immutable for a registered hash) — it
        just stops being allocatable, so no later dispatch can overwrite
        it before the export's device-side copy is ordered. Idempotent:
        re-pinning an already-pinned or re-taken block is a no-op."""
        for bid in block_ids:
            blk = self.blocks[bid]
            if blk.ref_count == 0 and bid in self.evictable:
                del self.evictable[bid]
                self._export_pins.add(bid)

    def unpin_exported(self, block_ids: list[int]) -> None:
        """The export snapshot is enqueued (device-ordered before any
        later write): return still-free pinned blocks to their pools."""
        for bid in block_ids:
            if bid not in self._export_pins:
                continue
            self._export_pins.discard(bid)
            blk = self.blocks[bid]
            if blk.ref_count == 0 and bid not in self.evictable:
                if blk.block_hash is not None:
                    self.evictable[bid] = None
                else:
                    self.free_blocks.append(bid)

    def free(self, block_table: list[int]) -> None:
        """Release a sequence's references; cached blocks become evictable."""
        # table-identity epoch: freed block ids may be handed to another
        # sequence, so anything caching a snapshot of LIVE page tables
        # (the staged h2d prefetch, llm_engine._stage_fingerprint) must
        # observe a bump and rebuild — a same-length re-allocated table
        # is indistinguishable by shape alone
        self.free_epoch += 1
        freed_cached: list[tuple[int, int]] = []
        for bid in block_table:
            blk = self.blocks[bid]
            blk.ref_count -= 1
            assert blk.ref_count >= 0, f"double free of block {bid}"
            if blk.ref_count == 0:
                if blk.block_hash is not None:
                    if bid not in self._export_pins:
                        # keep contents, LRU-evictable; a still-pinned
                        # block stays out of the pool until its export
                        # snapshot is enqueued (unpin_exported)
                        self.evictable[bid] = None
                    freed_cached.append((bid, blk.block_hash))
                else:
                    self.free_blocks.append(bid)
        if freed_cached and self.on_freed_cached is not None:
            # one batched d2h export per freed sequence (see kv/offload.py)
            self.on_freed_cached(freed_cached)
