"""Long-context prefill: one full prompt, sequence-sharded over a ring.

Counterpart of ``production_stack_tpu/parallel/long_context.py``. The
KV cache of a single long prompt is split over the ``sp`` ranks of a
ring (a list of torch devices, ``make_sp_ring``), attention runs as a
ring (parallel/ring_attention.py), and the largest prompt grows with
the ring: each rank holds S_pad / sp rows of the full-sequence cache
(JAX pins ``P(None, None, "sp", None)``). On one card the ranks are
that card repeated, and the shards are slices of its memory.

The model math is not written twice: the forward is models/llama.forward
(the one serving uses) with the ring supplied through its ``attn_fn``
seam. Its cache arguments are ``SeqShardedCache`` objects. The forward
writes the new rows' K/V into ``kc[layer][:, write_slots]`` before it
calls ``attn_fn``; a sharded cache takes that write as an index copy
into every shard from the device positions, each row outside a shard
sent to a spare row past that shard's end, so the chunk's start never
has to be known on the host. The serving paths pass plain tensors and
compute exactly what they did.

The forward runs on the ring's first device, where the params live;
each rank's attention runs on its own device. Two entry points:

- ``prefill(token_ids)``: the whole prompt in one forward (offline use).
- the chunked serving API (``begin_cache`` / ``stage_tokens`` /
  ``prefill_chunk``): the prompt runs as C-token ring chunks against
  the growing full-sequence cache, so a serving engine can run decode
  rounds for other users between chunks, and chunk N+1's token buffer
  copies on a side stream while chunk N rings. The padded length is
  chunk x pow2 (the JAX program ladder). Each chunk attends over all
  S_pad rows (the unwritten tail is causally masked), as in JAX.

A *captured* prefiller (``captured=True``: a ring whose ranks share one
device, outside a rank set) runs each chunk as the program variant
(engine/programs.py) of its ``(C, S_pad)`` key, as JAX jit-caches
``_chunk_fns``: the chunk's tokens, start and last row are the variant's
static inputs, and the full-sequence caches are one pair of flat
buffers kept at the largest S_pad reached, each key's caches a view of
it (a CUDA graph bakes in addresses). ``begin_cache`` zeroes that view
in place, so one prompt rings on the pair at a time. On the card the
key's first chunk runs eagerly as the warm-up, and the chunk is then
captured into the prefiller's own graph pool and replayed; on the CPU
each chunk runs the function eagerly on the same buffers. A capture or
replay that fails raises. Otherwise (a ring over several cards, a rank
set, an eager runner) each chunk is one enqueue-only eager forward on
caches allocated for its prompt.

Under tensor parallelism (``tp_group``) each tp rank holds a ring of
its own over its shard of the params: its cache shards hold the rank's
kv heads, and the forward's all-reduces and vocab gather run over the
tp group, as the serving forward's do (JAX: one ("tp", "sp") mesh, heads
on "tp"). The tp ranks run their rings in step.

Scope: Llama-family decoders (dense and MoE), batch 1, no LoRA.
Sliding-window models ride the ring's window mask.
"""

from __future__ import annotations

import math

import torch

from production_stack_tpu_torch.engine.programs import ProgramVariant
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel.ring_attention import (
    ring_attention_blocks,
)

SP_AXIS = "sp"


def make_sp_ring(sp_size: int, devices: list) -> list[torch.device]:
    """The ring's devices: the first sp_size entries of `devices` (a
    device may repeat: ranks that share a card)."""
    if sp_size < 1:
        raise ValueError(f"sp_size must be >= 1, got {sp_size}")
    if sp_size > len(devices):
        raise ValueError(
            f"sp={sp_size} > available devices {len(devices)}")
    return [torch.device(d) for d in devices[:sp_size]]


class SeqShardedCache:
    """A full-sequence head-major cache (L, nkv, S_pad, d) held as sp
    shards of R = S_pad / sp rows, shard i (rows [i*R, (i+1)*R)) on the
    ring's device i.

    Each shard is the leading R rows of its storage tensor; a storage of
    R + 1 rows takes writes, its last row the ones of chunk rows another
    shard holds (a cache of R-row storages is read-only: a rank set's
    gathered cache). It stands in for the cache tensor in
    models/llama.forward: ``cache[layer][:, write_slots] = rows`` copies
    the rows into every shard by their device positions;
    ``layer_blocks`` hands the ring one (1, R, nkv, d) block a rank."""

    def __init__(self, storage: list[torch.Tensor], rows: int | None = None):
        self.storage = list(storage)
        self.rows = rows if rows is not None else storage[0].shape[2]
        self.shards = [s[:, :, :self.rows] for s in self.storage]
        self.dtype = storage[0].dtype
        # (the forward's write positions, each storage's row indices)
        self._slots: tuple | None = None

    def __getitem__(self, layer: int) -> "_LayerWriter":
        return _LayerWriter(self, layer)

    def layer_blocks(self, layer: int) -> list[torch.Tensor]:
        return [s[layer].transpose(0, 1)[None] for s in self.shards]

    def gather(self, device=None) -> torch.Tensor:
        """The whole (L, nkv, S_pad, d) cache on one device (tests and
        checks; serving moves the shards)."""
        dev = device if device is not None else self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], dim=2)

    def storage_rows(self, positions: torch.Tensor) -> list[torch.Tensor]:
        """Each storage's row of every global position: its own rows,
        or the spare row R for a position another shard holds. Computed
        once a forward (every layer writes the same positions)."""
        if self._slots is None or self._slots[0] is not positions:
            R = self.rows
            if self.storage[0].shape[2] <= R:
                raise RuntimeError(
                    "a read-only sequence-sharded cache was written")
            rows = []
            for i, st in enumerate(self.storage):
                local = positions.to(st.device, non_blocking=True) - i * R
                rows.append(torch.where((local >= 0) & (local < R),
                                        local, R))
            self._slots = (positions, rows)
        return self._slots[1]


class _LayerWriter:
    __slots__ = ("cache", "layer")

    def __init__(self, cache: SeqShardedCache, layer: int):
        self.cache = cache
        self.layer = layer

    def __setitem__(self, index, value: torch.Tensor) -> None:
        """index: (slice, the rows' global positions (n,) on the device);
        value: (nkv, n, d) rows (llama.decoder_layer's head-major
        write)."""
        positions = index[1] if isinstance(index, tuple) else index
        c = self.cache
        for st, rows in zip(c.storage, c.storage_rows(positions)):
            st[self.layer].index_copy_(
                1, rows, value.to(st.device, non_blocking=True))


class StagedTokens:
    """One chunk's token ids on the forward device, their copy from a
    pinned host buffer started on a side stream (`event` fires when it
    is done; None on the CPU)."""

    __slots__ = ("dev", "host", "event")

    def __init__(self, dev: torch.Tensor, host=None, event=None):
        self.dev = dev
        self.host = host
        self.event = event

    def take(self) -> torch.Tensor:
        """The device tensor, for a forward on the current stream: that
        stream waits for the copy and the tensor is marked used by it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.dev.device)
            stream.wait_event(self.event)
            self.dev.record_stream(stream)
        return self.dev


def _forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
             kc: SeqShardedCache, vc: SeqShardedCache, start, last_row,
             tp_group=None
             ) -> tuple[torch.Tensor, SeqShardedCache, SeqShardedCache]:
    """One forward of C tokens at global rows [start, start + C) through
    llama.forward with the ring as attn_fn. `last_row` is the row (local
    to the chunk) whose logits are returned. `start` and `last_row` are
    host ints or 0-d device tensors (a captured chunk's inputs): the
    positions, the write rows and the logits row are built on the
    device either way. Returns (that row's logits (V,) f32, kc, vc): the
    caches are written in place. `tp_group`: the params (and `cfg`) are
    a tp rank's shard."""
    C = tokens.shape[0]
    dev = tokens.device
    positions = start + torch.arange(C, device=dev)
    rows = (torch.arange(last_row, last_row + 1, device=dev)
            if isinstance(last_row, int) else last_row.reshape(1))
    scale = llama.attention_scale(cfg)

    def attn_fn(q, layer, kcc, vcc):
        # q covers rows [start, start+C); the cache covers the whole
        # padded sequence: q_offset anchors the causal mask at the
        # chunk's global positions, and rows the earlier chunks have not
        # written yet sit above every query position, so the mask
        # already excludes them
        return ring_attention_blocks(
            q[None], kcc.layer_blocks(layer), vcc.layer_blocks(layer),
            start, causal=True, scale=scale, window=cfg.sliding_window,
        )[0]

    logits, kc, vc = llama.forward(
        cfg, params, tokens, positions, kc, vc, write_slots=positions,
        attn_fn=attn_fn, logits_rows=rows, tp_group=tp_group,
    )
    return logits[0], kc, vc


def chunk_to(sp: int, chunk: int, align: int = 1) -> int:
    """`chunk` rounded up to a multiple of the ring size and `align`."""
    m = sp
    while m % align:
        m += sp  # lcm walk: sp and align are tiny
    return -(-chunk // m) * m


def seq_pad(n: int, chunk: int) -> int:
    """An n-token prompt's padded length in `chunk`-token ring chunks:
    chunk x pow2(chunks)."""
    c = max(1, -(-n // chunk))
    p = 1
    while p < c:
        p *= 2
    return p * chunk


# a captured chunk's graph pool: float32 score bytes of one hop (bounded
# by ring_attention.RING_SCORE_BYTES), float32 copies of a K and a V
# block (and their contiguous operands), the chunk's per-row forward
# activations, and the pool's slack over one capture's peak (captures of
# two keys fragment it)
RING_POOL_KV_COPIES = 4
RING_POOL_SLACK = 2


def ring_reserve_bytes(cfg: ModelConfig, sp: int, chunk: int, s_pad: int,
                       itemsize: int) -> tuple[int, int]:
    """(the cache pair's bytes, the graph pool's bytes) a captured ring
    holds at padded length `s_pad` in `chunk`-row chunks: what a serving
    runner keeps back from its KV pool for the lane."""
    from production_stack_tpu_torch.parallel.ring_attention import (
        RING_SCORE_BYTES,
    )

    lq, lk = chunk // sp, s_pad // sp
    pair = (2 * sp * cfg.num_layers * cfg.num_kv_heads * (lk + 1)
            * cfg.head_dim * itemsize)
    score_rows = min(lq, max(1, RING_SCORE_BYTES // (4 * cfg.num_heads * lk)))
    hop = (4 * cfg.num_heads * score_rows * lk + 2 * score_rows * lk
           + RING_POOL_KV_COPIES * 4 * lk * cfg.num_kv_heads * cfg.head_dim)
    per_row = 4 * (4 * cfg.hidden_size
                   + 3 * cfg.intermediate_size * max(1, cfg.num_experts)
                   + 2 * (cfg.num_heads + 2 * cfg.num_kv_heads)
                   * cfg.head_dim)
    return pair, RING_POOL_SLACK * (hop + chunk * per_row)


class LongContextPrefiller:
    """Sequence-parallel prefill over a fixed ring of devices.

    Pad prompts to a multiple of the ring size (`pad_to`); K/V rows of
    the padding are garbage and must be dropped by the caller (the token
    count is returned alongside). `cache_dtype` sets the ring cache's
    storage dtype so a serving caller matches its paged cache exactly
    (the K/V a chunked prefill would have written is rounded through the
    same cast); default: the params dtype.

    `params` on the ring's first device are used as they are (a serving
    runner's tensors: no second copy); elsewhere they are copied there.
    With `tp_group`, `cfg` and `params` are a tp rank's view and shard
    (ModelConfig.tp_local, parallel/sharding.shard_params).

    `captured`: the chunks run as program variants on one shared cache
    pair (module docstring); `pool` is the CUDA graph pool their
    captures share (made at the first capture when None).
    """

    def __init__(self, cfg: ModelConfig, params: dict, devices: list,
                 cache_dtype: torch.dtype | None = None, tp_group=None,
                 captured: bool = False, pool=None):
        self.devices = [_resolved(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError(f"the ring needs an '{SP_AXIS}' axis: no "
                             "devices")
        if captured and (tp_group is not None
                         or len(set(self.devices)) > 1):
            raise ValueError("a captured ring runs on one device, outside "
                             "a rank set")
        dev = self.devices[0]
        if params["embed"].device != dev:
            params = _to_device(params, dev)
        self.cfg = cfg
        self.params = params
        self.tp_group = tp_group
        self.sp = len(self.devices)
        self.window = cfg.sliding_window
        self.cache_dtype = (cache_dtype if cache_dtype is not None
                            else params["embed"].dtype)
        self._copy_stream = None
        self.captured = captured
        self.pool = pool
        # the chunk programs by (C, S_pad) (JAX's _chunk_fns), the one
        # pair of flat cache buffers they write, and the pool bytes of
        # the variants rebuilt when the pair grew
        self.variants: dict[tuple[int, int], ProgramVariant] = {}
        self._pair: tuple[torch.Tensor, torch.Tensor] | None = None
        self._dropped_pool_bytes = 0

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def pad_to(self, n: int) -> int:
        return -(-n // self.sp) * self.sp

    def prefill(self, token_ids) -> tuple[
            torch.Tensor, SeqShardedCache, SeqShardedCache, int]:
        """token_ids: list of ints. Returns (logits, k, v, n) with k/v
        (L, nkv, S_pad, d) head-major, sharded on the sequence; rows
        >= n are padding (``k.gather()[:, :, :n]``)."""
        n = len(token_ids)
        S = self.pad_to(n)
        kc, vc = self.begin_cache(S)
        tokens = self.stage_tokens(list(token_ids), S)
        logits, kc, vc = self.prefill_chunk(kc, vc, tokens, 0, n - 1)
        return logits, kc, vc, n

    # -- chunked serving API ------------------------------------------------
    def chunk_to(self, chunk: int, align: int = 1) -> int:
        """Round a requested chunk length UP to a multiple of the ring
        size and `align` (the engine passes its KV block size so a
        chunk-multiple sequence pad always covers whole paged blocks)."""
        return chunk_to(self.sp, chunk, align)

    def seq_pad(self, n: int, chunk: int) -> int:
        """Padded sequence length for an n-token prompt served in
        `chunk`-token ring chunks: chunk x pow2(chunks)."""
        return seq_pad(n, chunk)

    def begin_cache(self, s_pad: int
                    ) -> tuple[SeqShardedCache, SeqShardedCache]:
        """A zeroed sequence-sharded full-sequence K/V cache for one
        prompt: sp shards of s_pad / sp rows (enqueue-only). A captured
        prefiller zeroes its pair's view of s_pad in place (the prompt
        that rang on it before must be done with it); otherwise each
        prompt gets shards of its own."""
        if s_pad % self.sp:
            raise ValueError(
                f"padded length {s_pad} is not divisible by the ring "
                f"size {self.sp}")
        if self.captured:
            caches = self._views(s_pad)
            n = math.prod(caches[0].storage[0].shape) * self.sp
            for flat in self._pair:
                flat[:n].zero_()
            return caches
        cfg = self.cfg
        rows = s_pad // self.sp
        shape = (cfg.num_layers, cfg.num_kv_heads, rows + 1, cfg.head_dim)
        return tuple(
            SeqShardedCache([torch.zeros(shape, dtype=self.cache_dtype,
                                         device=d) for d in self.devices],
                            rows)
            for _ in range(2))

    def _views(self, s_pad: int) -> tuple[SeqShardedCache, SeqShardedCache]:
        """The pair's caches at s_pad: the leading part of the two flat
        buffers. A larger s_pad than the pair holds replaces the pair
        and rebuilds every variant over the new one (their graphs baked
        in the old addresses); the keys stay."""
        cfg = self.cfg
        rows = s_pad // self.sp
        shape = (self.sp, cfg.num_layers, cfg.num_kv_heads, rows + 1,
                 cfg.head_dim)
        n = math.prod(shape)
        if self._pair is None or self._pair[0].numel() < n:
            keys = list(self.variants)
            self._dropped_pool_bytes += sum(
                v.pool_bytes for v in self.variants.values())
            self.variants.clear()
            self._pair = None
            self._pair = tuple(
                torch.empty((n,), dtype=self.cache_dtype,
                            device=self.device) for _ in range(2))
            for key in keys:
                self.variants[key] = self._build(*key)
        return tuple(SeqShardedCache(list(f[:n].view(shape)), rows)
                     for f in self._pair)

    def pool_bytes(self) -> int:
        """Device memory the chunk captures added to the prefiller's
        graph pool (a rebuilt variant's share stays in the pool)."""
        return self._dropped_pool_bytes + sum(
            v.pool_bytes for v in self.variants.values())

    def pair_bytes(self) -> int:
        """Device memory of the captured ring's cache pair."""
        return 0 if self._pair is None else sum(
            f.numel() * f.element_size() for f in self._pair)

    def _build(self, C: int, s_pad: int) -> ProgramVariant:
        """The program variant of one (C, S_pad) chunk key: its static
        tokens, start and last row, and the pair's caches at s_pad."""
        dev = self.device
        kc, vc = self._views(s_pad)
        rows = kc.rows
        cfg, params = self.cfg, self.params
        if dev.type == "cuda" and self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()

        # stackcheck: hot-path — one ring chunk (eager on the CPU and at
        # a key's first dispatch, then captured and replayed)
        def fn(inp):
            logits, _, _ = _forward(
                cfg, params, inp["tokens"],
                SeqShardedCache(inp["k"], rows),
                SeqShardedCache(inp["v"], rows),
                inp["start"], inp["last_row"])
            return (logits,)

        inputs = {"tokens": torch.zeros((C,), dtype=torch.int32,
                                        device=dev),
                  "start": torch.zeros((), dtype=torch.int64, device=dev),
                  "last_row": torch.zeros((), dtype=torch.int64,
                                          device=dev),
                  "k": kc.storage, "v": vc.storage}
        return ProgramVariant(
            "long_prefill", (C, s_pad), fn, inputs, dev, self.pool,
            guard=lambda: tuple(f.data_ptr() for f in self._pair))

    # stackcheck: hot-path — staged h2d of a ring chunk's token buffer:
    # a pinned copy on a side stream, no sync (chunk N+1's upload rides
    # out chunk N's compute)
    def stage_tokens(self, ids: list[int], chunk: int) -> StagedTokens:
        """Start the upload of one chunk's token ids (padded with 0 to
        `chunk`) ahead of its dispatch."""
        host = torch.zeros((chunk,), dtype=torch.int32)
        host[:len(ids)] = torch.as_tensor(ids, dtype=torch.int32)
        dev = self.device
        if dev.type != "cuda":
            return StagedTokens(host.to(dev))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            buf = host.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return StagedTokens(buf, host, event)

    # stackcheck: hot-path — one ring chunk on the engine step thread,
    # enqueue-only: a replay of its captured program (its inputs filled
    # on the device) or one eager forward; no device fetch (the final
    # logits are pulled by the long-prefill worker, never here)
    def prefill_chunk(
        self, kc: SeqShardedCache, vc: SeqShardedCache,
        tokens: StagedTokens, start: int, last_row: int,
    ) -> tuple[torch.Tensor, SeqShardedCache, SeqShardedCache]:
        """Run one C-token chunk at global offset `start` against the
        full-sequence cache. `tokens` comes from stage_tokens. Returns
        (last_row's logits (V,) f32, kc, vc): the caches are written in
        place and returned for symmetry with the JAX signature."""
        if not self.captured:
            return _forward(self.cfg, self.params, tokens.take(), kc, vc,
                            start, last_row, self.tp_group)
        key = (int(tokens.dev.shape[0]), kc.rows * self.sp)
        var = self.variants.get(key)
        if var is None:
            var = self.variants[key] = self._build(*key)
        inp = var.inputs
        if kc.storage[0].data_ptr() != inp["k"][0].data_ptr():
            raise ValueError("a captured ring chunk writes the caches "
                             "begin_cache returned")
        inp["tokens"].copy_(tokens.take())
        inp["start"].fill_(start)
        inp["last_row"].fill_(last_row)
        (logits,) = var.run()
        # a replay's output lives in the pool: the next replay rewrites it
        return logits.clone(), kc, vc


def _resolved(dev: torch.device) -> torch.device:
    """`cuda` names the current card: compare with an indexed device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(tree: dict, device: torch.device) -> dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
