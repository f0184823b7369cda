"""Model runner: owns params + the paged KV cache on the device and runs
the prefill / packed-prefill / decode forwards.

Counterpart of ``production_stack_tpu/engine/model_runner.py`` without
its guided, prompt-logprob and export paths: single-sequence
``prefill``, packed ``prefill_batch``, single-step ``decode``, the fused
K-step ``decode_multi``, the unified lane-typed round
``ragged_dispatch``, and the staging of each (``stage_prefill``,
``stage_prefill_batch``, ``stage_decode_multi``, ``stage_ragged``).
Host-side padding keeps the JAX buckets — chunks pad to a power of two
>= 8, contexts to a power-of-two block count, decode to max_num_seqs
lanes, ragged-round prefill rows to a power of two — so the kernels see
the same padded tables and metadata as the Pallas kernels do. PyTorch
runs eagerly: there is no jit and no program cache.

Every dispatch of the default configuration ships its inputs as ONE
packed int32 host buffer (pinned, one non_blocking copy on the card;
f32 fields bit-viewed): the fused paths always, prefill under
``prefill_pipeline`` (packed groups then run the ragged-rows layout on
the ragged kernel). A ``stage_*`` call builds the buffer of a FUTURE
dispatch and starts its copy on a side stream (``StagedBuffer``); the
dispatch that consumes it makes its stream wait for the copy. A staged
buffer whose bucket key or total length does not match the dispatch is
ignored and the dispatch builds its own. The fused K-step loop is a
Python loop whose per-iteration inputs are computed on the device from
the carried tensors: the only host read inside it is the early-exit
test of the device-stop variant. A chained round takes its tokens from
the previous round's device output instead of the buffer.

Attention goes through one seam, ``_attn(kind, ...)``: on a CUDA device
the wrappers in ops/paged_attention.py launch the hand-written kernels,
on the CPU they compute the plain versions. The impl follows the device
the runner was built for; there is no fallback between the two.

Weights: a checkpoint that ``--model`` resolves to is loaded at boot
(models/weights.py), straight onto the device; only a preset name draws
random ones. Multi-LoRA (``enable_lora``): every dispatch takes its
lanes' adapter slots; ``_lora_key`` turns them into no adapter math
(all base), one slot for every row, or a per-row slot vector that rides
the dispatch's packed buffer. The key is part of every staged buffer's
key, so a stage is never consumed under another slot assignment.
"""

from __future__ import annotations

import collections
import functools
import math
import time

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.lora import LoraManager
from production_stack_tpu_torch.engine.sampler import (
    LOGPROB_CAP,
    RAGGED_IDLE_TOKEN,
    STOP_PAD_TOKEN,
    TOP_CAP,
    apply_penalties,
    gumbel_noise,
    round_noise,
    sample_tokens,
    stop_hit,
    token_logprobs,
)
from production_stack_tpu_torch.models import llama, weights
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.ops import paged_attention
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}

# Row-block height of the ragged kernel's flattened query-row space.
RAGGED_TQ = paged_attention.RAGGED_TQ

# lane types of a unified ragged round's packed header
RAGGED_LANE_IDLE = 0
RAGGED_LANE_PREFILL = 1
RAGGED_LANE_DECODE = 2


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _ceil_tq(n: int) -> int:
    return -(-n // RAGGED_TQ) * RAGGED_TQ


def decode_segments(ctx: np.ndarray):
    """The ragged kernel's row space for a decode step of len(ctx) lanes:
    (r_pad, blk_seg, seg_meta), lane i one single-row segment at row i
    (position ctx[i] - 1), RAGGED_TQ lanes to a row block."""
    b = len(ctx)
    r_pad = _ceil_tq(b)
    n_blk = r_pad // RAGGED_TQ
    blk_seg = np.minimum(
        np.arange(n_blk + 1, dtype=np.int32) * RAGGED_TQ, b
    ).astype(np.int32)
    lanes = np.arange(b, dtype=np.int32)
    seg_meta = np.stack([
        lanes, lanes % RAGGED_TQ, np.ones((b,), np.int32),
        np.asarray(ctx, np.int32) - 1,
    ], axis=1).astype(np.int32)
    return r_pad, blk_seg, seg_meta


def decode_seg_meta(ctx: torch.Tensor) -> torch.Tensor:
    """decode_segments' seg_meta built where `ctx` lives (the fused loop
    keeps its context lengths on the device)."""
    lanes = torch.arange(ctx.shape[0], dtype=torch.int32, device=ctx.device)
    return torch.stack([
        lanes, lanes % RAGGED_TQ, torch.ones_like(lanes),
        ctx.to(torch.int32) - 1,
    ], dim=1)


def resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name!r}")
    return DTYPES[name]


class StagedBuffer:
    """The packed buffer of a future dispatch, its copy already started.

    `key` names the bucket it was built for (the dispatch compares it
    with its own). On the card, `dev` was allocated and filled on the
    runner's copy stream from the pinned `host` tensor, and `event`
    fires when the copy is done: ModelRunner._take makes the consuming
    stream wait on it. On the CPU `dev` is the host buffer itself and
    `event` is None."""

    __slots__ = ("key", "dev", "host", "event")

    def __init__(self, key, dev: torch.Tensor,
                 host: torch.Tensor | None = None, event=None):
        self.key = key
        self.dev = dev
        self.host = host
        self.event = event


class ModelRunner:
    def __init__(self, config: EngineConfig, params: dict | None = None):
        self.config = config
        self.model_config: ModelConfig = config.model_config()
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' (--device cpu) to run the plain versions"
            )
        self.dtype = resolve_dtype(config.dtype)
        self.cache_dtype = resolve_dtype(config.cache_dtype)
        self.max_model_len = config.resolved_max_model_len()
        self.block_size = config.block_size
        mc = self.model_config
        if self.device.type == "cuda":
            # refuse at boot what the card kernels are not built for: the
            # prefill tile (prefill and ragged kernels) runs on every path,
            # the decode kernel under --no-ragged-kernel
            g = mc.num_heads // mc.num_kv_heads
            try:
                paged_attention.check_kernel_shapes(
                    mc.head_dim, self.block_size,
                    None if config.ragged_kernel else g)
            except ValueError as e:
                raise ValueError(
                    f"model {mc.name} (head_dim {mc.head_dim}, {g} query "
                    f"heads per kv head) at block_size {self.block_size} "
                    f"cannot run on the card: {e}") from None

        if params is None:
            # a checkpoint that resolves loads (or raises); only a preset
            # name, which resolves to none, draws random weights
            params = weights.maybe_load(config.model, mc, self.dtype,
                                        self.device)
        if params is None:
            logger.info(
                "initializing random %s params (%.2fB params, %s, %s)",
                mc.name, mc.num_params() / 1e9, config.dtype, self.device,
            )
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = llama.init_params(mc, gen, self.dtype, self.device)
        else:
            params = _to_device(params, self.device)
        self.params = params

        self.num_blocks = self._resolve_num_blocks()
        num_slots = self.num_blocks * self.block_size
        # head-major (L, nkv, slots, d): the layout the kernels walk
        cache_shape = (mc.num_layers, mc.num_kv_heads, num_slots,
                       mc.head_dim)
        logger.info(
            "allocating KV cache: %d blocks x %d slots (%.2f GiB)",
            self.num_blocks, self.block_size,
            2 * math.prod(cache_shape) * self.cache_dtype.itemsize / 2**30,
        )
        self.k_cache = torch.zeros(cache_shape, dtype=self.cache_dtype,
                                   device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)

        self._scale = mc.head_dim**-0.5
        self.attention_impl = "cuda" if self.device.type == "cuda" else "torch"
        self.ragged_kernel = bool(config.ragged_kernel)
        # pipelined prefill: one packed buffer a prefill dispatch (packed
        # groups on the ragged-rows layout under the ragged kernel)
        self.prefill_pipeline = bool(config.prefill_pipeline)
        # staged copies: a side stream (made at the first stage), and the
        # pinned sources of copies that may still be in flight, held
        # until their event fires even when the handle is dropped
        self._copy_stream = None
        self._inflight: collections.deque = collections.deque()
        logger.info(
            "attention impl: %s%s", self.attention_impl,
            " (ragged kernel)" if self.ragged_kernel else "",
        )
        # per-phase prefill wall time (seconds), read by the
        # engine's stats: prep = host array build, h2d = upload enqueue,
        # dispatch = forward enqueue, fetch = device->host reads
        self.prefill_phase_s = {
            "prep": 0.0, "h2d": 0.0, "dispatch": 0.0, "fetch": 0.0,
        }
        # forwards run per entry point (packed prefill included), so a
        # run can show which paths it took
        # (decode_iterations: forwards the fused K-step loops ran, so a
        # run can see a round that exited before its K)
        self._blk_seg_cache: dict[int, torch.Tensor] = {}
        # sampler candidates (and noise columns) per row
        self._top_cap = min(TOP_CAP, self.model_config.vocab_size)
        self.dispatch_counts = {"prefill": 0, "prefill_batch": 0,
                                "decode": 0, "decode_multi": 0,
                                "ragged": 0, "decode_iterations": 0}
        # multi-LoRA: stacked adapter buffers applied in the forwards
        # (engine/lora.py); None when --enable-lora is off, so no
        # dispatch carries adapter math
        self.lora_manager = None
        if config.enable_lora:
            self.lora_manager = LoraManager(
                mc, config.max_loras, config.max_lora_rank, self.dtype,
                self.device)

    # -- sizing -----------------------------------------------------------
    def _resolve_num_blocks(self) -> int:
        cfg, mc = self.config, self.model_config
        if cfg.num_kv_blocks is not None:
            return cfg.num_kv_blocks
        bytes_per_block = (
            2 * mc.num_layers * cfg.block_size * mc.num_kv_heads
            * mc.head_dim * self.cache_dtype.itemsize
        )
        if self.device.type == "cuda":
            # the params already sit on the card, so free memory excludes
            # them; keep (1 - utilization) of the card unclaimed
            free, total = torch.cuda.mem_get_info(self.device)
            budget = int(free - total * (1.0 - cfg.hbm_utilization))
        else:
            param_bytes = mc.num_params() * self.dtype.itemsize
            budget = int(16 * 2**30 * cfg.hbm_utilization) - param_bytes
        num = max(2, budget // bytes_per_block)
        # cap: no point holding more than max_model_len * max_num_seqs * 2
        cap = (
            2 * (self.max_model_len // cfg.block_size + 1)
            * max(1, cfg.max_num_seqs)
        )
        return int(min(num, max(cap, 2)))

    # -- buckets ----------------------------------------------------------
    def _ctx_bucket(self, num_tokens: int) -> int:
        """Context bucket in tokens: whole blocks, pow2 block count."""
        blocks = max(1, -(-num_tokens // self.block_size))
        blocks = next_pow2(blocks)
        max_blocks = -(-self.max_model_len // self.block_size)
        return min(blocks, next_pow2(max_blocks)) * self.block_size

    def _prefill_bucket(self, chunk_len: int) -> int:
        return min(
            next_pow2(max(chunk_len, 8)),
            next_pow2(self.config.max_prefill_chunk),
        )

    # -- the attention seam -------------------------------------------------
    def _attn(self, kind: str, q, layer, kc, vc, *args):
        """Route one attention call to the paged kernel for `kind`
        ("prefill" | "decode" | "ragged"), filling block size, scale and
        window from the runner's config. The wrapper launches the CUDA
        kernel for tensors on the card and the plain version for CPU
        tensors."""
        fn = {
            "prefill": paged_attention.paged_prefill_attention,
            "decode": paged_attention.paged_decode_attention,
            "ragged": paged_attention.ragged_paged_attention,
        }[kind]
        return fn(
            q, kc, vc, layer, *args,
            block_size=self.block_size, scale=self._scale,
            window=self.model_config.sliding_window,
        )

    # -- multi-LoRA -----------------------------------------------------------
    def _lora_key(self, *slot_lists):
        """The adapter assignment of a dispatch, from its lanes' slots
        (one list per lane set, None = all base): None when no lane uses
        an adapter (slot 0 adds an exact zero, so the forward skips the
        adapter math), one int when every lane shares one slot (the
        uniform path), else a tuple of the lists (the per-token path,
        whose slot vector rides the dispatch's packed buffer). Part of
        every staged buffer's key: a stage built for another assignment
        is rebuilt."""
        flat = [int(x) for sl in slot_lists for x in (sl or ())]
        if self.lora_manager is None or not any(flat):
            return None
        if len(set(flat)) == 1:
            return flat[0]
        return tuple(tuple(int(x) for x in (sl or ()))
                     for sl in slot_lists)

    def _lora_kw(self, key, vec=None) -> dict:
        """forward() kwargs for a dispatch's adapter assignment `key`:
        none, the uniform slot, or the per-row slot vector `vec` (on the
        device) of a per-token key."""
        if key is None:
            return {}
        return {"lora": self.lora_manager.buffers,
                "lora_slots": vec if isinstance(key, tuple) else key}

    @staticmethod
    # stackcheck: not-hot — numpy over the host slot lists the engine
    # built; no device tensor reaches it
    def _rows_slot_vector(chunks, slots, r_pad: int) -> np.ndarray:
        """Per-row adapter slots of a ragged-rows prefill pack: lane i's
        rows carry its slot, alignment and tail rows 0."""
        per_row = np.zeros((r_pad,), np.int32)
        row = 0
        for ids, slot in zip(chunks, slots or [0] * len(chunks)):
            per_row[row:row + len(ids)] = slot
            row += _ceil_tq(len(ids))
        return per_row

    @staticmethod
    # stackcheck: not-hot — numpy over the host slot lists the engine
    # built; no device tensor reaches it
    def _packed_slot_vector(slots, n: int, s_pad: int,
                            t_pad: int) -> np.ndarray:
        """Per-row adapter slots of an (s_pad, t_pad) packed group."""
        per_tok = np.zeros((s_pad, t_pad), np.int32)
        per_tok[:n] = np.asarray(slots or [0] * n, np.int32)[:, None]
        return per_tok.reshape(-1)

    # -- host-side helpers -------------------------------------------------
    # stackcheck: not-hot — numpy over host lists (block tables,
    # positions); no device tensor reaches it
    def _slots_for_positions(
        self, block_table: list[int], positions: np.ndarray
    ) -> np.ndarray:
        """Cache slots for absolute positions; positions beyond the table
        map to the trash slot 0."""
        bt = np.asarray(block_table, dtype=np.int32)
        max_pos = len(bt) * self.block_size
        safe = np.clip(positions, 0, max_pos - 1) if len(bt) else positions * 0
        slots = (
            bt[safe // self.block_size] * self.block_size
            + safe % self.block_size
        ).astype(np.int32)
        slots[positions >= max_pos] = 0
        slots[positions < 0] = 0
        return slots

    # stackcheck: not-hot — numpy over a host block-table list
    def _padded_block_table(
        self, block_table: list[int], n_pages: int
    ) -> np.ndarray:
        """Block table padded/truncated to n_pages; padding pages point at
        the null block 0."""
        bt = np.zeros((n_pages,), dtype=np.int32)
        use = min(len(block_table), n_pages)
        if use:
            bt[:use] = np.asarray(block_table[:use], dtype=np.int32)
        return bt

    @staticmethod
    # stackcheck: not-hot — pads the host sampling arrays the engine
    # built; no device tensor reaches it
    def _sampling_args(
        n: int, sampling=None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
               np.ndarray]:
        """Pad per-sequence sampling params to n rows (greedy defaults)."""
        temps = np.zeros((n,), np.float32)
        top_ps = np.ones((n,), np.float32)
        top_ks = np.full((n,), -1, np.int32)
        min_ps = np.zeros((n,), np.float32)
        keys = np.zeros((n, 2), np.uint32)
        if sampling is not None:
            t, p, k, mp, kd = sampling
            m = len(np.asarray(t).reshape(-1))
            temps[:m] = np.asarray(t, np.float32).reshape(-1)
            top_ps[:m] = np.asarray(p, np.float32).reshape(-1)
            top_ks[:m] = np.asarray(k, np.int32).reshape(-1)
            min_ps[:m] = np.asarray(mp, np.float32).reshape(-1)
            keys[:m] = np.asarray(kd, np.uint32).reshape(m, 2)
        return temps, top_ps, top_ks, min_ps, keys

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def sample(self, logits: torch.Tensor, temps, top_ps, top_ks, min_ps,
               keys) -> torch.Tensor:
        """On-device sampling of one token per row of `logits` with
        per-row (seed, step) keys; returns (rows,) int32 on the device."""
        return sample_tokens(
            logits, self._dev(temps), self._dev(top_ps), self._dev(top_ks),
            self._dev(gumbel_noise(keys, self._top_cap)),
            min_p=self._dev(min_ps),
        )

    def _phase_add(self, name: str, dt: float) -> None:
        self.prefill_phase_s[name] += dt

    # -- pipelined prefill: one packed buffer a dispatch ---------------------
    def _prefill_pack_layout(self, t_pad: int, c_pad: int):
        """Layout of the ONE int32 buffer a single-sequence prefill ships
        under the pipeline; the sampler noise (1, cap) takes the place of
        the JAX keys. The chunk's start position stays a host argument
        of the dispatch (the prefill kernel takes it as a scalar)."""
        return self._layout_of([
            ("tokens", (t_pad,)),
            ("positions", (t_pad,)),
            ("write_slots", (t_pad,)),
            ("table", (c_pad // self.block_size,)),
            ("last_row", (1,)),
            ("temps", (1,)),
            ("top_ps", (1,)),
            ("top_ks", (1,)),
            ("min_ps", (1,)),
            ("noise", (1, self._top_cap)),
        ])

    def _packed_prefill_pack_layout(self, s_pad: int, t_pad: int,
                                    c_pad: int, lora_rows: bool = False):
        """The (s_pad, t_pad) packed-group variant (the pipeline without
        the ragged kernel): lane s holds rows [s * t_pad, (s+1) * t_pad).
        `lora_rows` adds the per-row adapter slots."""
        return self._layout_of([
            ("tokens", (s_pad * t_pad,)),
            ("positions", (s_pad * t_pad,)),
            ("write_slots", (s_pad * t_pad,)),
            ("tables", (s_pad, c_pad // self.block_size)),
            ("last_rows", (s_pad,)),
            ("temps", (s_pad,)),
            ("top_ps", (s_pad,)),
            ("top_ks", (s_pad,)),
            ("min_ps", (s_pad,)),
            ("noise", (s_pad, self._top_cap)),
        ] + ([("lora_rows", (s_pad * t_pad,))] if lora_rows else []))

    def _put_sampling(self, put, n: int, sampling) -> None:
        """The sampling fields of a prefill pack for n lanes: the
        parameters and one row of noise a lane (zeros for greedy)."""
        temps, top_ps, top_ks, min_ps, keys = self._sampling_args(
            n, sampling
        )
        put("temps", temps)
        put("top_ps", top_ps)
        put("top_ks", top_ks)
        put("min_ps", min_ps)
        put("noise", round_noise(keys, temps, 1, self._top_cap)[0])

    def _prefill_host_prep(self, token_ids: list[int], start_pos: int,
                           block_table: list[int], total_len: int):
        """Host arrays of one prefill chunk, shared by the packed and the
        per-array paths: (t_pad, c_pad, tokens, positions, write_slots,
        table). Padded rows carry position 0 (rope of 0) and write the
        trash slot."""
        t = len(token_ids)
        t_pad = self._prefill_bucket(t)
        c_pad = self._ctx_bucket(total_len)
        tokens = np.zeros((t_pad,), dtype=np.int32)
        tokens[:t] = token_ids
        positions = np.full((t_pad,), -1, dtype=np.int32)
        positions[:t] = np.arange(start_pos, start_pos + t)
        write_slots = self._slots_for_positions(block_table, positions)
        table = self._padded_block_table(
            block_table, c_pad // self.block_size
        )
        return (t_pad, c_pad, tokens, np.maximum(positions, 0), write_slots,
                table)

    # stackcheck: hot-path — host build of a prefill dispatch's one h2d
    # buffer (dispatch and staging); no device work
    def _fill_prefill_pack(
        self, token_ids: list[int], start_pos: int,
        block_table: list[int], total_len: int, sampling=None,
    ) -> tuple[int, int, np.ndarray]:
        """Host build of the single-sequence prefill pack; returns (t_pad,
        c_pad, packed)."""
        t_pad, c_pad, tokens, positions, write_slots, table = (
            self._prefill_host_prep(token_ids, start_pos, block_table,
                                    total_len))
        layout, size = self._prefill_pack_layout(t_pad, c_pad)
        packed = np.zeros((size,), np.int32)
        put = functools.partial(self._pack_put, packed, layout)
        put("tokens", tokens)
        put("positions", positions)
        put("write_slots", write_slots)
        put("table", table)
        put("last_row", np.full((1,), len(token_ids) - 1, np.int32))
        self._put_sampling(put, 1, sampling)
        return t_pad, c_pad, packed

    # stackcheck: hot-path — host build of a packed prefill group's one
    # h2d buffer; one pass over the lanes, no device work
    def _fill_packed_prefill_pack(
        self, chunks, start_positions, block_tables, total_lens,
        sampling=None, lora_slots=None,
    ) -> tuple[int, int, int, np.ndarray]:
        """Host build of the (s_pad, t_pad) packed prefill pack; returns
        (s_pad, t_pad, c_pad, packed)."""
        per_tok = isinstance(self._lora_key(lora_slots), tuple)
        (s_pad, t_pad, c_pad, tokens, positions_dev, write_slots,
         _q_starts, tables) = self._packed_host_prep(
            chunks, start_positions, block_tables, total_lens
        )
        last_rows = np.arange(s_pad, dtype=np.int32) * t_pad
        for s, ids in enumerate(chunks):
            last_rows[s] += len(ids) - 1
        layout, size = self._packed_prefill_pack_layout(s_pad, t_pad, c_pad,
                                                        per_tok)
        packed = np.zeros((size,), np.int32)
        put = functools.partial(self._pack_put, packed, layout)
        put("tokens", tokens)
        put("positions", positions_dev)
        put("write_slots", write_slots)
        put("tables", tables)
        put("last_rows", last_rows)
        self._put_sampling(put, s_pad, sampling)
        if per_tok:
            put("lora_rows", self._packed_slot_vector(
                lora_slots, len(chunks), s_pad, t_pad))
        return s_pad, t_pad, c_pad, packed

    def _single_prefill_step(self, t_pad: int, c_pad: int, lora=None):
        """`step(packed, start_pos)` -> (token, logits (vocab,)): the
        single-sequence prefill forward on its packed buffer (`lora`: a
        _lora_key, uniform or None for one sequence)."""
        mc = self.model_config
        layout, _ = self._prefill_pack_layout(t_pad, c_pad)

        def step(packed, start_pos):
            seg = functools.partial(self._pack_seg, packed, layout)
            table = seg("table")

            def attn(q, l, kc, vc):
                return self._attn("prefill", q, l, kc, vc, table, start_pos)

            logits, _, _ = llama.forward(
                mc, self.params, seg("tokens"), seg("positions"),
                self.k_cache, self.v_cache, seg("write_slots"), attn,
                logits_rows=seg("last_row"), **self._lora_kw(lora),
            )
            token = sample_tokens(
                logits, seg("temps").view(torch.float32),
                seg("top_ps").view(torch.float32), seg("top_ks"),
                seg("noise").view(torch.float32),
                min_p=seg("min_ps").view(torch.float32),
            )[0]
            return token, logits[0]

        return step

    def _packed_prefill_step(self, s_pad: int, t_pad: int, c_pad: int,
                             lora=None):
        """`step(packed, q_starts)` -> (sampled (s_pad,), logits (s_pad,
        vocab)): the (s_pad, t_pad) packed group on the composed prefill
        kernel, one launch a lane a layer (`lora`: its _lora_key)."""
        mc = self.model_config
        per_tok = isinstance(lora, tuple)
        layout, _ = self._packed_prefill_pack_layout(s_pad, t_pad, c_pad,
                                                     per_tok)

        def step(packed, q_starts):
            seg = functools.partial(self._pack_seg, packed, layout)
            # padding lanes start at 0 over the null table
            starts = list(q_starts) + [0] * (s_pad - len(q_starts))
            attn = self._packed_attn(s_pad, t_pad, seg("tables"), starts)
            logits, _, _ = llama.forward(
                mc, self.params, seg("tokens"), seg("positions"),
                self.k_cache, self.v_cache, seg("write_slots"), attn,
                logits_rows=seg("last_rows"), **self._lora_kw(
                    lora, seg("lora_rows") if per_tok else None),
            )
            sampled = sample_tokens(
                logits, seg("temps").view(torch.float32),
                seg("top_ps").view(torch.float32), seg("top_ks"),
                seg("noise").view(torch.float32),
                min_p=seg("min_ps").view(torch.float32),
            )
            return sampled, logits

        return step

    # -- staged buffers ----------------------------------------------------------
    def _stage(self, key, packed: np.ndarray) -> StagedBuffer:
        """Start the copy of a future dispatch's packed buffer: pinned,
        non_blocking on the runner's copy stream, an event recorded
        after it. Enqueue only: nothing here waits on the card."""
        host = torch.from_numpy(packed)
        if self.device.type != "cuda":
            return StagedBuffer(key, host)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        # pinned sources whose copies are done can go
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._inflight.append((event, host))
        return StagedBuffer(key, dev, host, event)

    def _take(self, staged: StagedBuffer) -> torch.Tensor:
        """The device buffer of a staged handle, for a dispatch on the
        current stream: that stream waits for the copy, and the tensor is
        marked used by it, so the allocator does not hand its memory out
        while the dispatch still reads it."""
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            staged.dev.record_stream(stream)
        return staged.dev

    # stackcheck: hot-path — staging must overlap the dispatch in flight:
    # a host-device sync here would serialize the prefill pipeline
    def stage_prefill(
        self, token_ids: list[int], start_pos: int,
        block_table: list[int], total_len: int, sampling=None,
        lora_slot: int = 0,
    ) -> StagedBuffer:
        """Build the packed buffer of a FUTURE single-sequence prefill
        chunk and start its copy, so the upload overlaps the dispatch in
        flight; returns a handle for prefill(staged=...). The caller
        (engine) validates its fingerprint before use."""
        t0 = time.perf_counter()
        t_pad, c_pad, packed = self._fill_prefill_pack(
            token_ids, start_pos, block_table, total_len, sampling=sampling,
        )
        t1 = time.perf_counter()
        self._phase_add("prep", t1 - t0)
        handle = self._stage(
            ("single", t_pad, c_pad, self._lora_key([lora_slot])), packed)
        self._phase_add("h2d", time.perf_counter() - t1)
        return handle

    # stackcheck: hot-path
    def stage_prefill_batch(
        self,
        chunks: list[list[int]],
        start_positions: list[int],
        block_tables: list[list[int]],
        total_lens: list[int],
        sampling=None,
        lora_slots: list[int] | None = None,
    ) -> StagedBuffer:
        """Packed-group variant of stage_prefill (the ragged-rows layout
        under the ragged kernel)."""
        t0 = time.perf_counter()
        lora = self._lora_key(lora_slots)
        if self.ragged_kernel:
            r_pad, pc_pad, packed = self._fill_rows_prefill_pack(
                chunks, start_positions, block_tables, total_lens,
                sampling=sampling, lora_slots=lora_slots,
                lora_rows=isinstance(lora, tuple),
            )
            key = ("rows", r_pad, pc_pad, lora)
        else:
            s_pad, t_pad, c_pad, packed = self._fill_packed_prefill_pack(
                chunks, start_positions, block_tables, total_lens,
                sampling=sampling, lora_slots=lora_slots,
            )
            key = ("packed", s_pad, t_pad, c_pad, lora)
        t1 = time.perf_counter()
        self._phase_add("prep", t1 - t0)
        handle = self._stage(key, packed)
        self._phase_add("h2d", time.perf_counter() - t1)
        return handle

    # -- public API --------------------------------------------------------
    @torch.inference_mode()
    def prefill(
        self,
        token_ids: list[int],
        start_pos: int,
        block_table: list[int],
        total_len: int,
        sampling=None,
        staged: StagedBuffer | None = None,
        lora_slot: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run one prefill chunk; returns (token, logits) on the device:
        the first generated token sampled from the chunk's last actual
        row, and that row's f32 (vocab,) logits. K/V for the chunk is
        written into the cache.

        `staged` = a stage_prefill handle whose copy is already under
        way; used only when its bucket key matches (the CALLER guarantees
        its content equals what these arguments build).

        `lora_slot`: the sequence's adapter slot (0 = base model); the
        whole chunk takes the uniform path."""
        lora = self._lora_key([lora_slot])
        if self.prefill_pipeline:
            t_pad = self._prefill_bucket(len(token_ids))
            c_pad = self._ctx_bucket(total_len)
            packed_dev = None
            if staged is not None and staged.key == ("single", t_pad,
                                                     c_pad, lora):
                packed_dev = self._take(staged)
            if packed_dev is None:
                t0 = time.perf_counter()
                t_pad, c_pad, packed = self._fill_prefill_pack(
                    token_ids, start_pos, block_table, total_len,
                    sampling=sampling,
                )
                t1 = time.perf_counter()
                self._phase_add("prep", t1 - t0)
                packed_dev = self._upload(packed)
                self._phase_add("h2d", time.perf_counter() - t1)
            t2 = time.perf_counter()
            out = self._single_prefill_step(t_pad, c_pad, lora)(
                packed_dev, start_pos)
            self.dispatch_counts["prefill"] += 1
            self._phase_add("dispatch", time.perf_counter() - t2)
            return out
        t0 = time.perf_counter()
        _, _, tokens, positions_dev, write_slots, table = (
            self._prefill_host_prep(token_ids, start_pos, block_table,
                                    total_len))
        temps, top_ps, top_ks, min_ps, keys = self._sampling_args(
            1, sampling
        )
        t1 = time.perf_counter()
        self._phase_add("prep", t1 - t0)
        tokens_d, pos_d, slots_d, table_d = (
            self._dev(tokens), self._dev(positions_dev),
            self._dev(write_slots), self._dev(table),
        )
        t2 = time.perf_counter()
        self._phase_add("h2d", t2 - t1)

        # q row 0 is always a real token, so start_pos is the chunk's
        # absolute start position
        def attn(q, l, kc, vc):
            return self._attn("prefill", q, l, kc, vc, table_d, start_pos)

        logits, _, _ = llama.forward(
            self.model_config, self.params, tokens_d, pos_d, self.k_cache,
            self.v_cache, slots_d, attn,
            logits_rows=torch.tensor([len(token_ids) - 1],
                                     device=self.device),
            **self._lora_kw(lora),
        )
        token = self.sample(logits, temps, top_ps, top_ks, min_ps, keys)[0]
        self.dispatch_counts["prefill"] += 1
        self._phase_add("dispatch", time.perf_counter() - t2)
        return token, logits[0]

    def _packed_host_prep(
        self,
        chunks: list[list[int]],
        start_positions: list[int],
        block_tables: list[list[int]],
        total_lens: list[int],
    ):
        """Host-side packing for prefill_batch: bucket n ragged chunks to
        (s_pad, t_pad), build per-row positions/write-slots (padded rows
        park at position 0 writing the trash slot) and per-lane padded
        block tables. Returns (s_pad, t_pad, c_pad, tokens,
        positions_dev, write_slots, q_starts, tables)."""
        n = len(chunks)
        s_pad = next_pow2(max(n, 1))
        t_pad = self._prefill_bucket(max(len(c) for c in chunks))
        c_pad = max(self._ctx_bucket(tl) for tl in total_lens)

        tokens = np.zeros((s_pad, t_pad), dtype=np.int32)
        positions = np.full((s_pad, t_pad), -1, dtype=np.int32)
        write_slots = np.zeros((s_pad, t_pad), dtype=np.int32)
        q_starts = np.zeros((s_pad,), dtype=np.int32)
        for s, (ids, start) in enumerate(zip(chunks, start_positions)):
            t = len(ids)
            tokens[s, :t] = ids
            positions[s, :t] = np.arange(start, start + t)
            write_slots[s] = self._slots_for_positions(
                block_tables[s], positions[s]
            )
            q_starts[s] = start
        positions_dev = np.where(positions < 0, 0, positions).astype(
            np.int32
        )
        n_pages = c_pad // self.block_size
        tables = np.stack([
            self._padded_block_table(
                block_tables[s] if s < n else [], n_pages
            )
            for s in range(s_pad)
        ])
        return (s_pad, t_pad, c_pad, tokens, positions_dev, write_slots,
                q_starts, tables)

    def _packed_attn(self, s_pad: int, t_pad: int, tables_d: torch.Tensor,
                     q_starts):
        """Attention over s_pad back-to-back chunks on one flat token axis
        (row s*t_pad + r is row r of chunk s); `tables_d` on the device,
        `q_starts` each lane's start position on the host."""
        mc = self.model_config
        if self.ragged_kernel:
            # ONE ragged-kernel launch per layer: every block of t_pad
            # (pow2 >= RAGGED_TQ) belongs to exactly one lane, so each
            # block is one full segment of its lane
            tq = RAGGED_TQ
            n_blk = (s_pad * t_pad) // tq
            lane_of = np.arange(n_blk, dtype=np.int32) * tq // t_pad
            off_in = (np.arange(n_blk, dtype=np.int32) * tq) % t_pad
            seg_meta = np.stack([
                lane_of,
                np.zeros((n_blk,), np.int32),
                np.full((n_blk,), tq, np.int32),
                np.asarray(q_starts, np.int32)[lane_of] + off_in,
            ], axis=1).astype(np.int32)
            blk_seg_d = self._dev(np.arange(n_blk + 1, dtype=np.int32))
            seg_meta_d = self._dev(seg_meta)

            def attn(q, l, kc, vc):
                return self._attn(
                    "ragged", q, l, kc, vc, tables_d, blk_seg_d, seg_meta_d
                )
            return attn

        starts = [int(x) for x in q_starts]

        def attn(q, l, kc, vc):
            qs = q.reshape(s_pad, t_pad, mc.num_heads, mc.head_dim)
            return torch.cat([
                self._attn("prefill", qs[s], l, kc, vc, tables_d[s],
                           starts[s])
                for s in range(s_pad)
            ], dim=0)
        return attn

    @torch.inference_mode()
    def prefill_batch(
        self,
        chunks: list[list[int]],
        start_positions: list[int],
        block_tables: list[list[int]],
        total_lens: list[int],
        sampling=None,
        staged: StagedBuffer | None = None,
        lora_slots: list[int] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run one prompt chunk for EACH of n sequences in a single packed
        forward; returns (tokens, logits) on the device — tokens (s,)
        sampled from each chunk's last actual row, logits (s, vocab)
        (rows >= n are padding; s = the lane cap on the ragged-rows
        layout, s_pad otherwise). K/V for every chunk is written.

        `staged` = a stage_prefill_batch handle (see prefill).
        `lora_slots`: each sequence's adapter slot (None = all base)."""
        lora = self._lora_key(lora_slots)
        if self.prefill_pipeline:
            if self.ragged_kernel:
                # ragged-rows layout: one ragged launch a layer over the
                # group's rows, whatever the lane mix
                r_pad, pc_pad = self._rows_dims(chunks, total_lens)
                key = ("rows", r_pad, pc_pad, lora)
                fill = functools.partial(self._fill_rows_prefill_pack,
                                         lora_rows=isinstance(lora, tuple))
            else:
                s_pad = next_pow2(max(len(chunks), 1))
                t_pad = self._prefill_bucket(max(len(c) for c in chunks))
                c_pad = max(self._ctx_bucket(tl) for tl in total_lens)
                key = ("packed", s_pad, t_pad, c_pad, lora)
                fill = self._fill_packed_prefill_pack
            packed_dev = None
            if staged is not None and staged.key == key:
                packed_dev = self._take(staged)
            if packed_dev is None:
                t0 = time.perf_counter()
                packed = fill(chunks, start_positions, block_tables,
                              total_lens, sampling=sampling,
                              lora_slots=lora_slots)[-1]
                t1 = time.perf_counter()
                self._phase_add("prep", t1 - t0)
                packed_dev = self._upload(packed)
                self._phase_add("h2d", time.perf_counter() - t1)
            t2 = time.perf_counter()
            if self.ragged_kernel:
                out = self._make_prefill_rows_step(r_pad, pc_pad, lora)(
                    packed_dev)
            else:
                out = self._packed_prefill_step(s_pad, t_pad, c_pad, lora)(
                    packed_dev, start_positions)
            self.dispatch_counts["prefill_batch"] += 1
            self._phase_add("dispatch", time.perf_counter() - t2)
            return out
        t0 = time.perf_counter()
        (s_pad, t_pad, c_pad, tokens, positions_dev, write_slots,
         q_starts, tables) = self._packed_host_prep(
            chunks, start_positions, block_tables, total_lens
        )
        last_rows = np.arange(s_pad, dtype=np.int32) * t_pad
        for s, ids in enumerate(chunks):
            last_rows[s] += len(ids) - 1
        temps, top_ps, top_ks, min_ps, keys = self._sampling_args(
            s_pad, sampling
        )
        t1 = time.perf_counter()
        self._phase_add("prep", t1 - t0)
        attn = self._packed_attn(s_pad, t_pad, self._dev(tables), q_starts)
        tokens_d = self._dev(tokens.reshape(-1))
        pos_d = self._dev(positions_dev.reshape(-1))
        slots_d = self._dev(write_slots.reshape(-1))
        rows_d = self._dev(last_rows)
        lora_kw = self._lora_kw(lora, self._dev(self._packed_slot_vector(
            lora_slots, len(chunks), s_pad, t_pad)) if isinstance(
                lora, tuple) else None)
        t2 = time.perf_counter()
        self._phase_add("h2d", t2 - t1)
        logits, _, _ = llama.forward(
            self.model_config, self.params, tokens_d, pos_d, self.k_cache,
            self.v_cache, slots_d, attn, logits_rows=rows_d, **lora_kw,
        )
        sampled = self.sample(logits, temps, top_ps, top_ks, min_ps, keys)
        self.dispatch_counts["prefill_batch"] += 1
        self._phase_add("dispatch", time.perf_counter() - t2)
        return sampled, logits

    def _decode_blk_seg(self, b: int) -> torch.Tensor:
        """The CSR row-block offsets of a b-lane decode step (shapes
        alone, so built once per b and kept on the device)."""
        blk = self._blk_seg_cache.get(b)
        if blk is None:
            _, blk_np, _ = decode_segments(np.ones((b,), np.int32))
            blk = self._blk_seg_cache[b] = self._dev(blk_np)
        return blk

    def _decode_attn(self, b: int, tables_d: torch.Tensor,
                     ctx_d: torch.Tensor):
        """Decode-shaped attention over b lanes whose page tables and
        context lengths are device tensors: the ragged kernel with one
        single-row segment per lane (blocks hold up to RAGGED_TQ lanes;
        the segment metadata is built on the device from ctx_d, so a
        fused loop reads nothing back), or the per-sequence decode
        kernel with --no-ragged-kernel."""
        if self.ragged_kernel:
            r_pad = _ceil_tq(b)
            blk_seg_d = self._decode_blk_seg(b)
            seg_meta_d = decode_seg_meta(ctx_d)

            def attn(q, l, kc, vc):
                qp = q
                if r_pad != b:
                    qp = q.new_zeros((r_pad,) + tuple(q.shape[1:]))
                    qp[:b] = q
                out = self._attn(
                    "ragged", qp, l, kc, vc, tables_d, blk_seg_d, seg_meta_d
                )
                return out[:b]
            return attn

        def attn(q, l, kc, vc):
            return self._attn("decode", q, l, kc, vc, tables_d, ctx_d)
        return attn

    @torch.inference_mode()
    def decode(
        self,
        token_ids: list[int],
        positions: list[int],
        block_tables: list[list[int]],
        context_lens: list[int],
        lora_slots: list[int] | None = None,
    ) -> torch.Tensor:
        """One decode step for a batch; returns f32 logits (b, vocab) on
        the device where rows beyond len(token_ids) are padded lanes.
        `lora_slots`: each lane's adapter slot (None = all base)."""
        b_actual = len(token_ids)
        b = self.config.max_num_seqs
        c_pad = self._ctx_bucket(max(context_lens))

        tokens = np.zeros((b,), dtype=np.int32)
        tokens[:b_actual] = token_ids
        pos = np.zeros((b,), dtype=np.int32)
        pos[:b_actual] = positions
        ctx = np.ones((b,), dtype=np.int32)
        ctx[:b_actual] = context_lens
        write_slots = np.zeros((b,), dtype=np.int32)
        for i in range(b_actual):
            write_slots[i] = self._slots_for_positions(
                block_tables[i], np.asarray([positions[i]])
            )[0]
        n_pages = c_pad // self.block_size
        tables = np.stack([
            self._padded_block_table(
                block_tables[i] if i < b_actual else [], n_pages
            )
            for i in range(b)
        ])
        attn = self._decode_attn(b, self._dev(tables), self._dev(ctx))
        lora = self._lora_key(lora_slots)
        vec = None
        if isinstance(lora, tuple):
            vec = np.zeros((b,), np.int32)
            vec[:b_actual] = lora_slots
            vec = self._dev(vec)
        logits, _, _ = llama.forward(
            self.model_config, self.params, self._dev(tokens),
            self._dev(pos), self.k_cache, self.v_cache,
            self._dev(write_slots), attn,
            logits_rows=torch.arange(b, device=self.device),
            **self._lora_kw(lora, vec),
        )
        self.dispatch_counts["decode"] += 1
        return logits

    # -- packed host->device buffers -----------------------------------------
    @staticmethod
    def _layout_of(fields: list[tuple[str, tuple[int, ...]]]):
        """{name: (offset, shape)} and the total length of a packed
        int32 buffer holding `fields` back to back."""
        layout: dict[str, tuple[int, tuple[int, ...]]] = {}
        off = 0
        for name, shape in fields:
            layout[name] = (off, shape)
            off += int(np.prod(shape))
        return layout, off

    @staticmethod
    def _pack_put(packed: np.ndarray, layout: dict, name: str,
                  arr: np.ndarray) -> None:
        """Write one field; f32/u32 fields travel as their int32 bits."""
        off, shape = layout[name]
        n = int(np.prod(shape))
        packed[off:off + n] = np.ascontiguousarray(arr).reshape(-1).view(
            np.int32)

    @staticmethod
    def _pack_seg(packed: torch.Tensor, layout: dict, name: str):
        """Device-side read of one field (the mirror of _pack_put); an
        f32 field is `.view(torch.float32)` of it."""
        off, shape = layout[name]
        n = int(np.prod(shape))
        return packed[off:off + n].reshape(shape)

    def _upload(self, packed: np.ndarray) -> torch.Tensor:
        """The ONE host->device copy of a dispatch: pinned and
        non_blocking on the card."""
        t = torch.from_numpy(packed)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- fused K-step decode ----------------------------------------------------
    def _decode_pack_layout(self, b: int, c_pad: int, k_steps: int,
                            stop_cap: int | None = None,
                            use_penalties: bool = False,
                            bias_cap: int = 0, chained: bool = False,
                            lora_lanes: bool = False):
        """Layout of the ONE int32 buffer a fused decode round ships.
        `noise` is the round's (k, b, cap) sampler noise, drawn on the
        host from each lane's (seed, step + i) key. `stop_cap` None = the
        fixed-trip loop; an int adds the per-lane EOS id, min_tokens gate
        and remaining budget, and when > 0 a (b, stop_cap) stop-id
        matrix. Penalties add the generated-id history (b, c_pad), -1
        padded; logit bias its (b, bias_cap) ids and values. A `chained`
        round has no tokens field: its tokens are the previous round's
        last row, on the device. `lora_lanes` adds each lane's adapter
        slot (a per-token dispatch)."""
        n_pages = c_pad // self.block_size
        fields = [] if chained else [("tokens", (b,))]
        fields += [
            ("positions", (b,)),
            ("ctx", (b,)),
            ("temps", (b,)),
            ("top_ps", (b,)),
            ("top_ks", (b,)),
            ("min_ps", (b,)),
            ("noise", (k_steps, b, self._top_cap)),
            ("page_tables", (b, n_pages)),
        ]
        if stop_cap is not None:
            fields += [
                ("stop_eos", (b,)),
                ("stop_min", (b,)),
                ("stop_budget", (b,)),
            ]
            if stop_cap > 0:
                fields.append(("stop_ids", (b, stop_cap)))
        if use_penalties:
            fields += [
                ("gen_ids", (b, c_pad)),
                ("presence", (b,)),
                ("frequency", (b,)),
                ("repetition", (b,)),
            ]
        if bias_cap:
            fields += [("lb_ids", (b, bias_cap)), ("lb_vals", (b, bias_cap))]
        if lora_lanes:
            fields.append(("lora_slots", (b,)))
        return self._layout_of(fields)

    @staticmethod
    def _stop_cap(stop: tuple | None) -> int | None:
        if stop is None:
            return None
        return 0 if stop[3] is None else int(stop[3].shape[1])

    # stackcheck: hot-path — host build of the fused decode round's one
    # h2d buffer: one pass over the lanes, no device work
    def _fill_decode_pack(
        self, c_pad: int, k_steps: int, token_ids, positions, block_tables,
        context_lens, temps, top_ps, top_ks, keys, min_ps=None,
        stop: tuple | None = None, penalties: tuple | None = None,
        logit_bias: tuple | None = None, chained: bool = False,
        lora_slots=None, lora_lanes: bool = False,
    ) -> np.ndarray:
        """Build the packed buffer of a fused decode round (layout:
        _decode_pack_layout) for len(positions) real lanes, padded to
        max_num_seqs. Padded lanes ship token 0, context 1, the zero
        table (trash block 0), EOS -1 and budget 0, so under device stops
        they are done from iteration 0. Shared by the dispatch
        (decode_multi, ragged_dispatch) and the staging (stage_*)."""
        b = self.config.max_num_seqs
        n = len(positions)
        stop_cap = self._stop_cap(stop)
        bias_cap = 0 if logit_bias is None else int(logit_bias[0].shape[1])
        layout, total = self._decode_pack_layout(
            b, c_pad, k_steps, stop_cap, penalties is not None, bias_cap,
            chained, lora_lanes,
        )
        packed = np.zeros((total,), np.int32)
        put = functools.partial(self._pack_put, packed, layout)

        def lanes(vals, fill, dtype, tail=()):
            full = np.full((b,) + tail, fill, dtype)
            if vals is not None:
                full[:n] = vals
            return full

        if not chained:
            put("tokens", lanes(token_ids, 0, np.int32))
        put("positions", lanes(positions, 0, np.int32))
        put("ctx", lanes(context_lens, 1, np.int32))
        t_full = lanes(temps, 0.0, np.float32)
        put("temps", t_full)
        put("top_ps", lanes(top_ps, 1.0, np.float32))
        put("top_ks", lanes(top_ks, -1, np.int32))
        put("min_ps", lanes(min_ps, 0.0, np.float32))
        put("noise", round_noise(lanes(keys, 0, np.uint32, (2,)), t_full,
                                 k_steps, self._top_cap))
        n_pages = c_pad // self.block_size
        put("page_tables", np.stack([
            self._padded_block_table(
                block_tables[i] if i < n else [], n_pages
            )
            for i in range(b)
        ]))
        if stop is not None:
            eos, min_rem, budget, stop_ids = stop
            put("stop_eos", lanes(eos, -1, np.int32))
            put("stop_min", lanes(min_rem, 0, np.int32))
            put("stop_budget", lanes(budget, 0, np.int32))
            if stop_cap:
                put("stop_ids", lanes(stop_ids, -1, np.int32, (stop_cap,)))
        if penalties is not None:
            gen_lists, presence, frequency, repetition = penalties
            # generated tokens are part of the context: c_pad holds them
            gen = np.full((b, c_pad), -1, np.int32)
            for i, g in enumerate(gen_lists):
                gen[i, :len(g)] = g
            put("gen_ids", gen)
            put("presence", lanes(presence, 0.0, np.float32))
            put("frequency", lanes(frequency, 0.0, np.float32))
            put("repetition", lanes(repetition, 1.0, np.float32))
        if bias_cap:
            # padding adds 0.0 to token 0: a no-op
            put("lb_ids", lanes(logit_bias[0], 0, np.int32, (bias_cap,)))
            put("lb_vals", lanes(logit_bias[1], 0.0, np.float32,
                                 (bias_cap,)))
        if lora_lanes:
            # padded lanes: the base model (their rows are discarded)
            put("lora_slots", lanes(lora_slots, 0, np.int32))
        return packed

    def _decode_round_core(self, b: int, c_pad: int, k_steps: int,
                           use_penalties: bool = False,
                           want_logprobs: bool = False,
                           bias_cap: int = 0,
                           stop_cap: int | None = None,
                           chained: bool = False, lora=None,
                           lora_lanes: bool = False):
        """The fused K-step decode round as four closures shared by
        decode_multi and the unified ragged round (whose step-0 decode
        forward is welded to the prefill rows): `unpack` (packed buffer ->
        consts, carry), `fwd_args` (one forward's tokens, positions, write
        slots, context lengths from the carry), `post` (sample and advance
        the stop/penalty state from one iteration's logits) and
        `run(first_logits=...)` (the loop; with first_logits it applies
        iteration 0's post half to externally computed logits and loops
        from iteration 1).

        The carry is (tokens, positions, ctx, counts, done, valid), all on
        the device. Under device stops (`stop_cap` not None) a lane is
        done once its append count reaches its budget or it samples its
        EOS / a stop id at or past its min_tokens gate; a done lane
        freezes: its sampled slot is pinned to STOP_PAD_TOKEN, its KV
        write goes to the trash slot 0, its position and context stop
        advancing, its penalty counts stop updating. The loop then reads
        one flag per iteration, `done.all()`, and exits when it is set;
        the round returns each lane's valid count last. Tokens below a
        lane's valid count equal the fixed-trip loop's.

        `lora` is the decode lanes' _lora_key; `lora_lanes` says the pack
        holds their slot vector (a per-token round). The slots are
        constant across the K iterations."""
        mc = self.model_config
        bs = self.block_size
        n_pages = c_pad // bs
        use_stop = stop_cap is not None
        layout, _ = self._decode_pack_layout(
            b, c_pad, k_steps, stop_cap, use_penalties, bias_cap, chained,
            lora_lanes,
        )
        lane = torch.arange(b, device=self.device)

        def unpack(packed, chained_tokens=None):
            """Packed buffer -> (consts, carry0); a chained round's
            tokens are `chained_tokens`, (b,) int32 on the device."""
            seg = functools.partial(self._pack_seg, packed, layout)

            def f32(name):
                return seg(name).view(torch.float32)

            consts = {
                "temps": f32("temps"),
                "top_ps": f32("top_ps"),
                "top_ks": seg("top_ks"),
                "min_ps": f32("min_ps"),
                "noise": f32("noise"),
                "page_tables": seg("page_tables"),
            }
            if lora_lanes:
                consts["lora_slots"] = seg("lora_slots")
            counts0 = None
            if use_penalties:
                # per-lane generated-token counts, kept on the device
                # through the loop
                gen_ids = seg("gen_ids")
                counts0 = torch.zeros(
                    (b, mc.vocab_size), dtype=torch.float32,
                    device=packed.device,
                ).scatter_add_(1, gen_ids.clamp_min(0).long(),
                               (gen_ids >= 0).float())
                consts.update(presence=f32("presence"),
                              frequency=f32("frequency"),
                              repetition=f32("repetition"))
            if bias_cap:
                consts.update(lb_ids=seg("lb_ids").long(),
                              lb_vals=f32("lb_vals"))
            if use_stop:
                consts.update(
                    eos_ids=seg("stop_eos"), min_need=seg("stop_min"),
                    budget=seg("stop_budget"),
                    s_ids=seg("stop_ids") if stop_cap else None,
                )
                # padded lanes ship budget 0: done from iteration 0
                done0 = consts["budget"] <= 0
            else:
                done0 = torch.zeros((b,), dtype=torch.bool,
                                    device=packed.device)
            valid0 = torch.zeros((b,), dtype=torch.int32,
                                 device=packed.device)
            tokens = chained_tokens if chained else seg("tokens")
            carry0 = (tokens, seg("positions"), seg("ctx"), counts0, done0,
                      valid0)
            return consts, carry0

        def fwd_args(carry, consts):
            """(tokens, positions, write_slots, ctx) of one decode forward,
            computed on the device: each lane's slot from its block table
            (idle lanes carry the zero table, so they write the trash
            block 0, and K <= block_size keeps them inside it)."""
            tokens, positions, ctx, _, done, _ = carry
            page = torch.clamp(positions // bs, max=n_pages - 1).long()
            write_slots = (consts["page_tables"][lane, page] * bs
                           + positions % bs)
            if use_stop:
                # a frozen lane's overshoot KV never lands past its end
                write_slots = torch.where(
                    done, torch.zeros_like(write_slots), write_slots)
            return tokens, positions, write_slots, ctx

        def fwd(carry, consts):
            tokens, positions, write_slots, ctx = fwd_args(carry, consts)
            attn = self._decode_attn(b, consts["page_tables"], ctx)
            logits, _, _ = llama.forward(
                mc, self.params, tokens, positions, self.k_cache,
                self.v_cache, write_slots, attn, logits_rows=lane,
                **self._lora_kw(lora, consts.get("lora_slots")),
            )
            return logits

        def post(logits, carry, i, consts):
            """Sample iteration i from its logits and advance the stop
            and penalty state; returns (carry', ys_i)."""
            tokens, positions, ctx, counts, done, valid = carry
            if use_penalties:
                logits = apply_penalties(
                    logits, counts > 0, counts, consts["presence"],
                    consts["frequency"], consts["repetition"],
                )
            if bias_cap:
                # OpenAI logit_bias, after penalties (the host path's
                # order)
                logits = logits.scatter_add(1, consts["lb_ids"],
                                            consts["lb_vals"])
            nxt = sample_tokens(
                logits, consts["temps"], consts["top_ps"],
                consts["top_ks"], consts["noise"][i],
                min_p=consts["min_ps"],
            )
            live = ~done
            if use_stop:
                nxt = torch.where(done, torch.full_like(nxt, STOP_PAD_TOKEN),
                                  nxt)
            if use_penalties:
                inc = live.float() if use_stop else torch.ones_like(
                    counts[:, 0])
                counts = counts.scatter_add(1, nxt.long()[:, None],
                                            inc[:, None])
            valid = valid + live.to(torch.int32)
            adv = 1
            if use_stop:
                # the stop token itself is appended; the lane freezes
                # from the next iteration (budget first, then the
                # min_tokens-gated EOS/stop-id check: check_stop's order)
                hit = stop_hit(nxt, consts["eos_ids"], consts["s_ids"])
                done = done | (valid >= consts["budget"]) | (
                    live & hit & (valid >= consts["min_need"]))
                adv = (~done).to(torch.int32)
            ys = (nxt, *token_logprobs(logits, nxt)) if want_logprobs else (
                nxt,)
            return (nxt, positions + adv, ctx + adv, counts, done,
                    valid), ys

        def run(consts, carry0, first_logits=None):
            dev = self.device
            toks = torch.full((k_steps, b), STOP_PAD_TOKEN,
                              dtype=torch.int32, device=dev)
            bufs = [toks]
            if want_logprobs:
                bufs += [
                    torch.zeros((k_steps, b), dtype=torch.float32,
                                device=dev),
                    torch.zeros((k_steps, b, LOGPROB_CAP),
                                dtype=torch.float32, device=dev),
                    torch.zeros((k_steps, b, LOGPROB_CAP),
                                dtype=torch.int32, device=dev),
                ]
            carry, i = carry0, 0
            if first_logits is not None:
                carry, ys = post(first_logits, carry, 0, consts)
                for buf, y in zip(bufs, ys):
                    buf[0] = y
                i = 1
            while i < k_steps:
                # the loop's one host read: a 1-byte flag (real lanes
                # enter with budget >= 1, so iteration 0 always runs)
                if use_stop and i > 0 and bool(carry[4].all()):
                    break
                carry, ys = post(fwd(carry, consts), carry, i, consts)
                for buf, y in zip(bufs, ys):
                    buf[i] = y
                i += 1
            self.dispatch_counts["decode_iterations"] += i
            if use_stop:
                bufs.append(carry[5])
            return bufs[0] if len(bufs) == 1 else tuple(bufs)

        return {"unpack": unpack, "fwd_args": fwd_args, "run": run}

    # stackcheck: hot-path — speculative prefetch of the NEXT chained
    # fused round: enqueue only, no device fetch
    def stage_decode_multi(
        self, positions, block_tables, context_lens, steps,
        temps, top_ps, top_ks, keys, min_ps=None, stop=None,
        lora_slots=None,
    ) -> StagedBuffer:
        """Build the packed buffer of the next fused round on the same
        lanes (chained: its tokens will be this round's last row) and
        start its copy, so the upload overlaps the round in flight and
        its fetch. The engine stages with PREDICTED state (positions,
        contexts, keys and the stop countdowns advanced by K) and
        validates the prediction before dispatching on it; a stale stage
        (context-bucket or length mismatch) is ignored by decode_multi.
        Returns a handle for decode_multi(staged=...)."""
        c_pad = self._ctx_bucket(max(context_lens) + max(0, steps - 1))
        lora = self._lora_key(lora_slots)
        packed = self._fill_decode_pack(
            c_pad, steps, None, positions, block_tables, context_lens,
            temps, top_ps, top_ks, keys, min_ps=min_ps, stop=stop,
            chained=True, lora_slots=lora_slots,
            lora_lanes=isinstance(lora, tuple),
        )
        return self._stage((c_pad, lora), packed)

    # stackcheck: hot-path — one packed upload, the fused loop; fetches
    # stay with the caller
    @torch.inference_mode()
    def decode_multi(
        self,
        token_ids: list[int],
        positions: list[int],
        block_tables: list[list[int]],
        context_lens: list[int],
        steps: int,
        temps: np.ndarray,      # (b_actual,) float32
        top_ps: np.ndarray,
        top_ks: np.ndarray,
        keys: np.ndarray,       # (b_actual, 2) uint32
        min_ps: np.ndarray | None = None,
        penalties: tuple | None = None,
        want_logprobs: bool = False,
        logit_bias: tuple | None = None,  # ((b_actual, cap) i32 ids,
                                          #  (b_actual, cap) f32 vals)
        stop: tuple | None = None,  # (eos (b_actual,) i32, -1 = ignore,
                                    #  min_rem, budget (b_actual,) i32,
                                    #  stop_ids (b_actual, cap) i32 | None)
        staged: StagedBuffer | None = None,  # from stage_decode_multi
        lora_slots: list[int] | None = None,  # per lane, None = all base
    ):
        """`steps` fused decode+sample iterations, one packed upload;
        returns (steps, b) int32 sampled tokens on the device, or with
        `want_logprobs` (tokens, chosen (k, b) f32, top_vals (k, b, CAP)
        f32, top_ids (k, b, CAP) i32). With `stop` the return is always a
        tuple whose last element is the (b,) int32 per-lane valid count:
        rows at or past valid[lane] are pad and the loop exits once every
        lane is done. Iteration i samples with key (seed, step + i), so K
        fused steps give the tokens of K single steps. The caller has
        grown each block table to cover context_len + steps - 1.

        `penalties`: (gen_id lists, presence, frequency, repetition);
        token counts then ride the loop on the device.

        `token_ids` may be a full-lane (b,) int32 DEVICE tensor instead
        of a host list: the round is then chained on the previous
        round's sampled tokens, and a `staged` buffer (stage_decode_multi)
        is used when its context bucket and total length match this
        dispatch's layout; otherwise the buffer is built here."""
        if steps > self.block_size:
            raise ValueError(
                f"num_scheduler_steps={steps} > block_size="
                f"{self.block_size}: idle lanes would overrun the trash "
                "block"
            )
        b = self.config.max_num_seqs
        chained = isinstance(token_ids, torch.Tensor)
        c_pad = self._ctx_bucket(max(context_lens) + steps - 1)
        bias_cap = 0 if logit_bias is None else int(logit_bias[0].shape[1])
        stop_cap = self._stop_cap(stop)
        lora = self._lora_key(lora_slots)
        lora_lanes = isinstance(lora, tuple)
        packed_dev = None
        if staged is not None and chained and staged.key == (c_pad, lora):
            # the stop fields vary with the batch's stop-id cap: a total
            # length that differs is a stale stage, rebuilt here
            _, want_total = self._decode_pack_layout(
                b, c_pad, steps, stop_cap, penalties is not None, bias_cap,
                chained, lora_lanes,
            )
            if staged.dev.shape[0] == want_total:
                packed_dev = self._take(staged)
        if packed_dev is None:
            packed_dev = self._upload(self._fill_decode_pack(
                c_pad, steps, token_ids, positions, block_tables,
                context_lens, temps, top_ps, top_ks, keys, min_ps=min_ps,
                stop=stop, penalties=penalties, logit_bias=logit_bias,
                chained=chained, lora_slots=lora_slots,
                lora_lanes=lora_lanes,
            ))
        core = self._decode_round_core(
            b, c_pad, steps, use_penalties=penalties is not None,
            want_logprobs=want_logprobs, bias_cap=bias_cap,
            stop_cap=stop_cap, chained=chained, lora=lora,
            lora_lanes=lora_lanes,
        )
        consts, carry0 = core["unpack"](
            packed_dev, chained_tokens=token_ids if chained else None)
        ys = core["run"](consts, carry0)
        self.dispatch_counts["decode_multi"] += 1
        return ys

    # -- ragged-rows prefill -----------------------------------------------------
    # In a unified round the prefill lanes' chunk rows pack back to back on
    # one flat row axis, RAGGED_TQ-aligned, one segment a row block; lane
    # offsets ride per-lane metadata at a static lane cap.
    def _rows_lane_cap(self) -> int:
        """Prefill-lane capacity of a ragged-rows pack."""
        return next_pow2(max(self.config.max_prefill_seqs, 1))

    def _rows_bucket(self, n_rows: int) -> int:
        return next_pow2(max(n_rows, RAGGED_TQ))

    def _rows_dims(self, chunks: list[list[int]],
                   total_lens: list[int]) -> tuple[int, int]:
        """(r_pad, pc_pad) row and context buckets of a prefill group."""
        r_pad = self._rows_bucket(sum(_ceil_tq(len(c)) for c in chunks))
        pc_pad = max(self._ctx_bucket(tl) for tl in total_lens)
        return r_pad, pc_pad

    def _rows_prefill_pack_layout(self, r_pad: int, pc_pad: int,
                                  lora_rows: bool = False):
        """Flat row-axis fields + per-lane metadata at the lane cap; the
        sampler noise (s_cap, cap) takes the place of the JAX keys.
        `lora_rows` adds the per-row adapter slots."""
        s_cap = self._rows_lane_cap()
        fields = [
            ("tokens", (r_pad,)),
            ("positions", (r_pad,)),
            ("write_slots", (r_pad,)),
            ("tables", (s_cap, pc_pad // self.block_size)),
            ("lane_row0", (s_cap,)),
            ("lane_rows", (s_cap,)),
            ("q_starts", (s_cap,)),
            ("last_rows", (s_cap,)),
            ("temps", (s_cap,)),
            ("top_ps", (s_cap,)),
            ("top_ks", (s_cap,)),
            ("min_ps", (s_cap,)),
            ("noise", (s_cap, self._top_cap)),
        ]
        if lora_rows:
            fields.append(("lora_rows", (r_pad,)))
        return self._layout_of(fields)

    # stackcheck: hot-path — host build of the ragged-rows prefill pack;
    # one pass over the lanes, no device work
    def _fill_rows_prefill_pack(
        self,
        chunks: list[list[int]],
        start_positions: list[int],
        block_tables: list[list[int]],
        total_lens: list[int],
        sampling=None,
        lora_slots: list[int] | None = None,
        lora_rows: bool = False,
    ) -> tuple[int, int, np.ndarray]:
        """Host build of the ragged-rows prefill pack; returns (r_pad,
        pc_pad, packed). Lane i's chunk occupies rows [lane_row0[i],
        lane_row0[i] + len(chunk)); alignment and bucket tail rows carry
        position -1 -> rope 0 and write the trash slot. `lora_rows`
        writes the lanes' adapter slots per row (a per-token dispatch)."""
        n = len(chunks)
        s_cap = self._rows_lane_cap()
        r_pad, pc_pad = self._rows_dims(chunks, total_lens)
        n_pages = pc_pad // self.block_size
        tokens = np.zeros((r_pad,), np.int32)
        positions = np.full((r_pad,), -1, np.int32)
        write_slots = np.zeros((r_pad,), np.int32)
        tables = np.zeros((s_cap, n_pages), np.int32)
        lane_row0 = np.zeros((s_cap,), np.int32)
        lane_rows = np.zeros((s_cap,), np.int32)
        q_starts = np.zeros((s_cap,), np.int32)
        last_rows = np.zeros((s_cap,), np.int32)
        row = 0
        for i, (ids, start) in enumerate(zip(chunks, start_positions)):
            t = len(ids)
            tokens[row:row + t] = ids
            pos = np.arange(start, start + t, dtype=np.int32)
            positions[row:row + t] = pos
            write_slots[row:row + t] = self._slots_for_positions(
                block_tables[i], pos
            )
            tables[i] = self._padded_block_table(block_tables[i], n_pages)
            lane_row0[i] = row
            lane_rows[i] = _ceil_tq(t)
            q_starts[i] = start
            last_rows[i] = row + t - 1
            row += _ceil_tq(t)
        # idle lanes: empty row ranges past the packed region (they cover
        # no block), last row 0 (the round pins their sample)
        lane_row0[n:] = row
        layout, size = self._rows_prefill_pack_layout(r_pad, pc_pad,
                                                      lora_rows)
        packed = np.zeros((size,), np.int32)
        put = functools.partial(self._pack_put, packed, layout)
        put("tokens", tokens)
        put("positions", np.maximum(positions, 0))
        put("write_slots", write_slots)
        put("tables", tables)
        put("lane_row0", lane_row0)
        put("lane_rows", lane_rows)
        put("q_starts", q_starts)
        put("last_rows", last_rows)
        self._put_sampling(put, s_cap, sampling)
        if lora_rows:
            put("lora_rows", self._rows_slot_vector(chunks, lora_slots,
                                                    r_pad))
        return r_pad, pc_pad, packed

    @staticmethod
    def _rows_pf_seg_meta(r_pad: int, lane_row0: torch.Tensor,
                          lane_rows: torch.Tensor,
                          q_starts: torch.Tensor) -> torch.Tensor:
        """Per-block segment metadata of the ragged-rows prefill region,
        built on the device: each RAGGED_TQ block belongs to at most one
        lane (lanes pack TQ-aligned) and carries one segment [lane, 0,
        TQ, q_pos of its first row]; a block outside every lane carries a
        zero-row segment the kernel walks past."""
        tq = RAGGED_TQ
        blk0 = torch.arange(r_pad // tq, dtype=torch.int32,
                            device=lane_row0.device) * tq
        ends = lane_row0 + lane_rows
        cover = ((blk0[:, None] >= lane_row0[None, :])
                 & (blk0[:, None] < ends[None, :]))
        has = cover.any(dim=1)
        # first covering lane (0 where none), as jnp.argmax of a bool
        lane_of = cover.to(torch.int32).argmax(dim=1)
        qpos0 = q_starts[lane_of] + (blk0 - lane_row0[lane_of])
        return torch.stack([
            lane_of.to(torch.int32), torch.zeros_like(blk0),
            has.to(torch.int32) * tq,
            torch.where(has, qpos0, torch.zeros_like(qpos0)),
        ], dim=1).to(torch.int32)

    def _make_prefill_rows_step(self, r_pad: int, pc_pad: int, lora=None):
        """Ragged-rows packed prefill: chunks of up to max_prefill_seqs
        sequences on ONE flat row axis, the group's chunk attention ONE
        ragged kernel launch a layer. `step(packed)` -> (sampled (s_cap,)
        int32, logits (s_cap, vocab)); `step.unpack` is shared with the
        unified round (_build_ragged_rows). `lora`: the dispatch's
        _lora_key (a tuple: the pack carries per-row slots)."""
        mc = self.model_config
        per_tok = isinstance(lora, tuple)
        layout, _ = self._rows_prefill_pack_layout(r_pad, pc_pad, per_tok)

        def unpack(packed):
            seg = functools.partial(self._pack_seg, packed, layout)
            pf = {name: seg(name) for name in (
                "tokens", "positions", "write_slots", "tables", "lane_row0",
                "lane_rows", "q_starts", "last_rows", "top_ks")}
            if per_tok:
                pf["lora_rows"] = seg("lora_rows")
            for name in ("temps", "top_ps", "min_ps", "noise"):
                pf[name] = seg(name).view(torch.float32)
            return pf

        def sample(pf, logits):
            return sample_tokens(logits, pf["temps"], pf["top_ps"],
                                 pf["top_ks"], pf["noise"],
                                 min_p=pf["min_ps"])

        def step(packed):
            pf = unpack(packed)
            seg_meta = self._rows_pf_seg_meta(
                r_pad, pf["lane_row0"], pf["lane_rows"], pf["q_starts"])
            blk_seg = torch.arange(r_pad // RAGGED_TQ + 1,
                                   dtype=torch.int32, device=packed.device)

            def attn(q, l, kc, vc):
                return self._attn("ragged", q, l, kc, vc, pf["tables"],
                                  blk_seg, seg_meta)

            logits, _, _ = llama.forward(
                mc, self.params, pf["tokens"], pf["positions"],
                self.k_cache, self.v_cache, pf["write_slots"], attn,
                logits_rows=pf["last_rows"],
                **self._lora_kw(lora, pf.get("lora_rows")),
            )
            return sample(pf, logits), logits

        step.unpack = unpack
        step.sample = sample
        return step

    # -- unified ragged rounds ---------------------------------------------------
    # ONE lane-typed engine round: one packed buffer whose lanes mix
    # prefill chunks and decode steps, one forward over [prefill rows |
    # decode rows] with one ragged kernel launch a layer, then decode
    # iterations 1..K-1 on the shared decode core. The two lane sets are
    # different sequences with disjoint block tables, so the tokens equal
    # a split prefill round followed by a decode round.
    def _ragged_rows_pack_sizes(
        self, r_pad: int, pc_pad: int, b: int, c_pad: int, k_steps: int,
        stop_cap: int | None = None, use_penalties: bool = False,
        bias_cap: int = 0, chained: bool = False, lora_rows: bool = False,
    ) -> tuple[int, int, int]:
        """(meta, prefill, decode) segment lengths of a ragged round's
        packed buffer: the lane-type header (lane cap + b lanes), the
        ragged-rows prefill pack, the decode pack (`lora_rows`: both
        packs carry their rows' adapter slots). A staged buffer whose
        total differs from the dispatch's is stale."""
        meta = self._rows_lane_cap() + b
        _, pf = self._rows_prefill_pack_layout(r_pad, pc_pad, lora_rows)
        _, dec = self._decode_pack_layout(b, c_pad, k_steps, stop_cap,
                                          use_penalties, bias_cap, chained,
                                          lora_rows)
        return meta, pf, dec

    # stackcheck: hot-path — host build of the ragged round's one h2d
    # buffer; one pass over the lanes, no device work
    def _fill_ragged_rows_pack(
        self,
        pf_chunks, pf_start_positions, pf_block_tables, pf_total_lens,
        pf_sampling, c_pad, token_ids, positions, block_tables,
        context_lens, steps, temps, top_ps, top_ks, keys, min_ps=None,
        stop=None, penalties=None, logit_bias=None, chained=False,
        pf_lora_slots=None, lora_slots=None, lora_rows=False,
    ) -> tuple[int, int, np.ndarray]:
        """Lane-type header + ragged-rows prefill pack + decode pack, one
        int32 buffer (dispatch and staging). Returns (r_pad, pc_pad,
        packed)."""
        b = self.config.max_num_seqs
        s_cap = self._rows_lane_cap()
        r_pad, pc_pad, pf_packed = self._fill_rows_prefill_pack(
            pf_chunks, pf_start_positions, pf_block_tables, pf_total_lens,
            sampling=pf_sampling, lora_slots=pf_lora_slots,
            lora_rows=lora_rows,
        )
        dec_packed = self._fill_decode_pack(
            c_pad, steps, token_ids, positions, block_tables, context_lens,
            temps, top_ps, top_ks, keys, min_ps=min_ps, stop=stop,
            penalties=penalties, logit_bias=logit_bias, chained=chained,
            lora_slots=lora_slots, lora_lanes=lora_rows,
        )
        types = np.full((s_cap + b,), RAGGED_LANE_IDLE, np.int32)
        types[:len(pf_chunks)] = RAGGED_LANE_PREFILL
        types[s_cap:s_cap + len(positions)] = RAGGED_LANE_DECODE
        packed = np.concatenate([types, pf_packed, dec_packed])
        return r_pad, pc_pad, packed

    def _ragged_rows_meta(self, r_pad: int, pf: dict,
                          dec_tables: torch.Tensor, d_ctx: torch.Tensor,
                          n_pages: int):
        """(tables, blk_seg, seg_meta) of a ragged round's step-0 forward,
        built on the device. Rows: [prefill rows (r_pad) | decode rows
        (b, padded to RAGGED_TQ)]. seg_meta: the prefill blocks' segments,
        then one single-row segment a decode lane, [s_cap + lane,
        lane % TQ, 1, ctx - 1]; blk_seg: arange(n_pf_blk + 1), then
        n_pf_blk + min((j + 1) * TQ, b); tables: prefill lanes then decode
        lanes, padded to the wider page count with the null block."""
        tq = RAGGED_TQ
        b = dec_tables.shape[0]
        pf_tab = pf["tables"]
        s_cap = pf_tab.shape[0]
        dev = dec_tables.device
        tables = torch.cat([
            torch.nn.functional.pad(pf_tab, (0, n_pages - pf_tab.shape[1])),
            torch.nn.functional.pad(dec_tables,
                                    (0, n_pages - dec_tables.shape[1])),
        ])
        pf_seg = self._rows_pf_seg_meta(
            r_pad, pf["lane_row0"], pf["lane_rows"], pf["q_starts"])
        dl = torch.arange(b, dtype=torch.int32, device=dev)
        dec_seg = torch.stack([
            s_cap + dl, dl % tq, torch.ones_like(dl),
            d_ctx.to(torch.int32) - 1,
        ], dim=1)
        n_pf_blk = r_pad // tq
        blk_seg = torch.cat([
            torch.arange(n_pf_blk + 1, dtype=torch.int32, device=dev),
            n_pf_blk + torch.clamp(
                (torch.arange(_ceil_tq(b) // tq, dtype=torch.int32,
                              device=dev) + 1) * tq, max=b),
        ])
        return tables, blk_seg, torch.cat([pf_seg, dec_seg])

    def _build_ragged_rows(self, r_pad: int, pc_pad: int, b: int,
                           c_pad: int, k_steps: int,
                           use_penalties: bool = False,
                           want_logprobs: bool = False,
                           bias_cap: int = 0,
                           stop_cap: int | None = None,
                           chained: bool = False, lora=None):
        """The unified round as `step(packed, chained_tokens=None)` ->
        (pf_sampled (s_cap,)
        int32, RAGGED_IDLE_TOKEN on non-prefill lanes; pf_logits (s_cap,
        vocab); decode ys as decode_multi returns them). The prefill
        lanes' rows and the decode lanes' step-0 rows share one row space
        and one forward, whose attention is one ragged kernel launch a
        layer; decode iterations 1..K-1 continue on the decode core.

        `lora` is the round's _lora_key over (prefill lanes, decode
        lanes): the step-0 forward takes it whole (per-token: the prefill
        rows' slots then the decode lanes'), the decode loop the decode
        lanes' share of it."""
        mc = self.model_config
        s_cap = self._rows_lane_cap()
        b_pad = _ceil_tq(b)
        per_tok = isinstance(lora, tuple)
        pf_step = self._make_prefill_rows_step(r_pad, pc_pad, lora)
        core = self._decode_round_core(
            b, c_pad, k_steps, use_penalties=use_penalties,
            want_logprobs=want_logprobs, bias_cap=bias_cap,
            stop_cap=stop_cap, chained=chained,
            lora=self._lora_key(lora[1]) if per_tok else lora,
            lora_lanes=per_tok,
        )
        meta_n, pf_n, _ = self._ragged_rows_pack_sizes(
            r_pad, pc_pad, b, c_pad, k_steps, stop_cap, use_penalties,
            bias_cap, chained, per_tok,
        )
        n_pages = max(pc_pad, c_pad) // self.block_size

        def step(packed, chained_tokens=None):
            lane_types = packed[:s_cap]
            pf = pf_step.unpack(packed[meta_n:meta_n + pf_n])
            consts, carry0 = core["unpack"](packed[meta_n + pf_n:],
                                            chained_tokens=chained_tokens)
            # decode write slots / ctx from the shared core, so frozen-
            # lane trash redirection matches the loop's
            d_tokens, d_positions, d_ws, d_ctx = core["fwd_args"](
                carry0, consts)
            tables, blk_seg, seg_meta = self._ragged_rows_meta(
                r_pad, pf, consts["page_tables"], d_ctx, n_pages)
            n_rows = r_pad + b

            def attn(q, l, kc, vc):
                qp = q
                if b_pad != b:
                    qp = q.new_zeros((r_pad + b_pad,) + tuple(q.shape[1:]))
                    qp[:n_rows] = q
                out = self._attn("ragged", qp, l, kc, vc, tables, blk_seg,
                                 seg_meta)
                return out[:n_rows]

            logits, _, _ = llama.forward(
                mc, self.params, torch.cat([pf["tokens"], d_tokens]),
                torch.cat([pf["positions"], d_positions]), self.k_cache,
                self.v_cache, torch.cat([pf["write_slots"], d_ws]), attn,
                logits_rows=torch.cat([
                    pf["last_rows"],
                    r_pad + torch.arange(b, dtype=torch.int32,
                                         device=packed.device),
                ]),
                **self._lora_kw(lora, torch.cat([
                    pf["lora_rows"], consts["lora_slots"]])
                    if per_tok else None),
            )
            pf_logits = logits[:s_cap]
            pf_sampled = torch.where(
                lane_types == RAGGED_LANE_PREFILL,
                pf_step.sample(pf, pf_logits),
                torch.full_like(lane_types, RAGGED_IDLE_TOKEN),
            )
            ys = core["run"](consts, carry0, first_logits=logits[s_cap:])
            return pf_sampled, pf_logits, ys

        return step

    # stackcheck: hot-path — speculative prefetch of the NEXT ragged
    # round's buffer: enqueue only, no device fetch
    def stage_ragged(
        self,
        pf_chunks: list[list[int]],
        pf_start_positions: list[int],
        pf_block_tables: list[list[int]],
        pf_total_lens: list[int],
        pf_sampling,
        positions, block_tables, context_lens, steps,
        temps, top_ps, top_ks, keys,
        min_ps=None, stop=None, pf_lora_slots=None, lora_slots=None,
    ) -> StagedBuffer:
        """Build the predicted next ragged round's packed buffer (its
        decode half chained: the tokens ride on the device from the
        current round) and start its copy. Returns a handle for
        ragged_dispatch(staged=...); the caller validates its
        fingerprint, and the dispatch its bucket key and total length."""
        t0 = time.perf_counter()
        c_pad = self._ctx_bucket(max(context_lens) + max(0, steps - 1))
        lora = self._lora_key(pf_lora_slots, lora_slots)
        r_pad, pc_pad, packed = self._fill_ragged_rows_pack(
            pf_chunks, pf_start_positions, pf_block_tables, pf_total_lens,
            pf_sampling, c_pad, None, positions, block_tables,
            context_lens, steps, temps, top_ps, top_ks, keys,
            min_ps=min_ps, stop=stop, chained=True,
            pf_lora_slots=pf_lora_slots, lora_slots=lora_slots,
            lora_rows=isinstance(lora, tuple),
        )
        t1 = time.perf_counter()
        self._phase_add("prep", t1 - t0)
        handle = self._stage(("rows", r_pad, pc_pad, c_pad, lora), packed)
        self._phase_add("h2d", time.perf_counter() - t1)
        return handle

    # stackcheck: hot-path — ONE packed upload serves the whole lane-typed
    # round; fetches stay with the caller
    @torch.inference_mode()
    def ragged_dispatch(
        self,
        pf_chunks: list[list[int]],
        pf_start_positions: list[int],
        pf_block_tables: list[list[int]],
        pf_total_lens: list[int],
        token_ids: list[int],
        positions: list[int],
        block_tables: list[list[int]],
        context_lens: list[int],
        steps: int,
        temps, top_ps, top_ks, keys,
        min_ps=None,
        pf_sampling=None,
        penalties: tuple | None = None,
        want_logprobs: bool = False,
        logit_bias: tuple | None = None,
        stop: tuple | None = None,
        staged: StagedBuffer | None = None,
        pf_lora_slots: list[int] | None = None,
        lora_slots: list[int] | None = None,
    ) -> tuple:
        """One lane-typed round: prefill chunk lanes + fused decode lanes.
        Returns (pf_sampled (s_cap,) int32 on the device, RAGGED_IDLE_TOKEN
        on non-prefill lanes; pf_logits (s_cap, vocab); dec_ys) where
        dec_ys has decode_multi's return shape for the same flags.
        `token_ids` may be a device tensor (chained decode half, see
        decode_multi); `staged` = a stage_ragged handle, used only when
        its bucket key AND total length match this dispatch (a lane-mix
        or stop-cap change since the stage rebuilds here: a counted miss
        for the engine, never an error). `pf_lora_slots` / `lora_slots`:
        the prefill and decode lanes' adapter slots (None = all base)."""
        if steps > self.block_size:
            raise ValueError(
                f"num_scheduler_steps={steps} > block_size="
                f"{self.block_size}: idle lanes would overrun the trash "
                "block"
            )
        if not self.ragged_kernel:
            raise NotImplementedError(
                "the composed-kernel ragged round is not ported to the "
                "PyTorch engine yet: pass --no-ragged-dispatch"
            )
        b = self.config.max_num_seqs
        chained = isinstance(token_ids, torch.Tensor)
        c_pad = self._ctx_bucket(max(context_lens) + steps - 1)
        bias_cap = 0 if logit_bias is None else int(logit_bias[0].shape[1])
        stop_cap = self._stop_cap(stop)
        r_pad, pc_pad = self._rows_dims(pf_chunks, pf_total_lens)
        lora = self._lora_key(pf_lora_slots, lora_slots)
        per_tok = isinstance(lora, tuple)
        packed_dev = None
        if (staged is not None and chained
                and staged.key == ("rows", r_pad, pc_pad, c_pad, lora)):
            want_total = sum(self._ragged_rows_pack_sizes(
                r_pad, pc_pad, b, c_pad, steps, stop_cap,
                penalties is not None, bias_cap, chained, per_tok,
            ))
            if staged.dev.shape[0] == want_total:
                packed_dev = self._take(staged)
        if packed_dev is None:
            t0 = time.perf_counter()
            r_pad, pc_pad, packed = self._fill_ragged_rows_pack(
                pf_chunks, pf_start_positions, pf_block_tables,
                pf_total_lens, pf_sampling, c_pad, token_ids, positions,
                block_tables, context_lens, steps, temps, top_ps, top_ks,
                keys, min_ps=min_ps, stop=stop, penalties=penalties,
                logit_bias=logit_bias, chained=chained,
                pf_lora_slots=pf_lora_slots, lora_slots=lora_slots,
                lora_rows=per_tok,
            )
            t1 = time.perf_counter()
            self._phase_add("prep", t1 - t0)
            packed_dev = self._upload(packed)
            self._phase_add("h2d", time.perf_counter() - t1)
        t2 = time.perf_counter()
        step = self._build_ragged_rows(
            r_pad, pc_pad, b, c_pad, steps,
            use_penalties=penalties is not None,
            want_logprobs=want_logprobs, bias_cap=bias_cap,
            stop_cap=stop_cap, chained=chained, lora=lora,
        )
        out = step(packed_dev,
                   chained_tokens=token_ids if chained else None)
        self.dispatch_counts["ragged"] += 1
        self._phase_add("dispatch", time.perf_counter() - t2)
        return out


def _to_device(tree: dict, device: torch.device) -> dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
