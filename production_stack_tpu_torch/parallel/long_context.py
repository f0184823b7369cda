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
calls ``attn_fn``; a sharded cache takes that write and sends each row
of the chunk's contiguous span [start, start + C) to the shard that
holds it, with host slice arithmetic only. The serving paths pass plain
tensors and compute exactly what they did.

The forward runs on the ring's first device, where the params live;
each rank's attention runs on its own device. Two entry points:

- ``prefill(token_ids)``: the whole prompt in one forward (offline use).
- the chunked serving API (``begin_cache`` / ``stage_tokens`` /
  ``prefill_chunk``): the prompt runs as C-token ring chunks against
  the growing full-sequence cache, each chunk one enqueue-only eager
  forward, so a serving engine can run decode rounds for other users
  between chunks, and chunk N+1's token buffer copies on a side
  stream while chunk N rings. The padded length is chunk x pow2 (the
  JAX program ladder). Each chunk attends over all S_pad rows (the
  unwritten tail is causally masked), as in JAX.

Under tensor parallelism (``tp_group``) each tp rank holds a ring of
its own over its shard of the params: its cache shards hold the rank's
kv heads, and the forward's all-reduces and vocab gather run over the
tp group, as the serving forward's do (JAX: one ("tp", "sp") mesh, heads
on "tp"). The tp ranks run their rings in step.

Scope: Llama-family decoders (dense and MoE), batch 1, no LoRA.
Sliding-window models ride the ring's window mask.
"""

from __future__ import annotations

import torch

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
    shards of S_pad / sp rows, shard i (rows [i*R, (i+1)*R)) on the
    ring's device i.

    It stands in for the cache tensor in models/llama.forward:
    ``cache[layer][:, write_slots] = rows`` writes the chunk's rows, which
    cover the span set by ``write_span`` (the caller's positions), into
    the shards that hold them; ``layer_blocks`` hands the ring one
    (1, R, nkv, d) block a rank."""

    def __init__(self, shards: list[torch.Tensor]):
        self.shards = shards
        self.rows = shards[0].shape[2]
        self.dtype = shards[0].dtype
        self._span: tuple[int, int] | None = None

    def write_span(self, start: int, n: int) -> None:
        """The rows [start, start + n) the next forward writes."""
        self._span = (start, n)

    def __getitem__(self, layer: int) -> "_LayerWriter":
        return _LayerWriter(self, layer)

    def layer_blocks(self, layer: int) -> list[torch.Tensor]:
        return [s[layer].transpose(0, 1)[None] for s in self.shards]

    def gather(self, device=None) -> torch.Tensor:
        """The whole (L, nkv, S_pad, d) cache on one device (tests and
        checks; serving moves the shards)."""
        dev = device if device is not None else self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], dim=2)


class _LayerWriter:
    __slots__ = ("cache", "layer")

    def __init__(self, cache: SeqShardedCache, layer: int):
        self.cache = cache
        self.layer = layer

    def __setitem__(self, index, value: torch.Tensor) -> None:
        """value: (nkv, n, d) rows of the span set by write_span, in
        order (llama.decoder_layer's head-major write)."""
        c = self.cache
        if c._span is None:
            raise RuntimeError("SeqShardedCache written with no span set")
        start, n = c._span
        if value.shape[1] != n:
            raise ValueError(
                f"{value.shape[1]} rows written into a span of {n}")
        R = c.rows
        for i, shard in enumerate(c.shards):
            lo, hi = max(start, i * R), min(start + n, (i + 1) * R)
            if lo < hi:
                shard[self.layer][:, lo - i * R:hi - i * R] = value[
                    :, lo - start:hi - start].to(shard.device,
                                                 non_blocking=True)


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
             kc: SeqShardedCache, vc: SeqShardedCache, start: int,
             last_row: int, tp_group=None
             ) -> tuple[torch.Tensor, SeqShardedCache, SeqShardedCache]:
    """One forward of C tokens at global rows [start, start + C) through
    llama.forward with the ring as attn_fn. `last_row` is the row (local
    to the chunk) whose logits are returned. Returns (that row's logits
    (V,) f32, kc, vc): the caches are written in place. `tp_group`: the
    params (and `cfg`) are a tp rank's shard."""
    C = tokens.shape[0]
    dev = tokens.device
    positions = start + torch.arange(C, device=dev)
    kc.write_span(start, C)
    vc.write_span(start, C)
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
        attn_fn=attn_fn,
        logits_rows=torch.arange(last_row, last_row + 1, device=dev),
        tp_group=tp_group,
    )
    return logits[0], kc, vc


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
    """

    def __init__(self, cfg: ModelConfig, params: dict, devices: list,
                 cache_dtype: torch.dtype | None = None, tp_group=None):
        self.devices = [_resolved(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError(f"the ring needs an '{SP_AXIS}' axis: no "
                             "devices")
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
        m = self.sp
        while m % align:
            m += self.sp  # lcm walk: sp and align are tiny
        return -(-chunk // m) * m

    def seq_pad(self, n: int, chunk: int) -> int:
        """Padded sequence length for an n-token prompt served in
        `chunk`-token ring chunks: chunk x pow2(chunks)."""
        c = max(1, -(-n // chunk))
        p = 1
        while p < c:
            p *= 2
        return p * chunk

    def begin_cache(self, s_pad: int
                    ) -> tuple[SeqShardedCache, SeqShardedCache]:
        """A fresh sequence-sharded full-sequence K/V cache for one
        prompt: sp zeroed shards of s_pad / sp rows (enqueue-only)."""
        if s_pad % self.sp:
            raise ValueError(
                f"padded length {s_pad} is not divisible by the ring "
                f"size {self.sp}")
        cfg = self.cfg
        shape = (cfg.num_layers, cfg.num_kv_heads, s_pad // self.sp,
                 cfg.head_dim)
        return tuple(
            SeqShardedCache([torch.zeros(shape, dtype=self.cache_dtype,
                                         device=d) for d in self.devices])
            for _ in range(2))

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

    # stackcheck: hot-path — one enqueue-only eager ring chunk on the
    # engine step thread; no device fetch (the final logits are pulled
    # by the long-prefill worker, never here)
    def prefill_chunk(
        self, kc: SeqShardedCache, vc: SeqShardedCache,
        tokens: StagedTokens, start: int, last_row: int,
    ) -> tuple[torch.Tensor, SeqShardedCache, SeqShardedCache]:
        """Run one C-token chunk at global offset `start` against the
        full-sequence cache. `tokens` comes from stage_tokens. Returns
        (last_row's logits (V,) f32, kc, vc): the caches are written in
        place and returned for symmetry with the JAX signature."""
        return _forward(self.cfg, self.params, tokens.take(), kc, vc,
                        start, last_row, self.tp_group)


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
