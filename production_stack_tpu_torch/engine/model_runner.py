"""Model runner: owns params + the paged KV cache on the device and runs
the prefill / packed-prefill / decode forwards.

Counterpart of the split-round slice of
``production_stack_tpu/engine/model_runner.py``: single-sequence
``prefill``, packed ``prefill_batch`` (the raw-args variant) and
single-step ``decode``. Host-side padding keeps the JAX buckets — chunks
pad to a power of two >= 8, contexts to a power-of-two block count,
decode to max_num_seqs lanes — so the kernels see the same padded tables
and metadata as the Pallas kernels do. PyTorch runs eagerly: there is no
jit and no program cache.

Attention goes through one seam, ``_attn(kind, ...)``: on a CUDA device
the wrappers in ops/paged_attention.py launch the hand-written kernels,
on the CPU they compute the plain versions. The impl follows the device
the runner was built for; there is no fallback between the two.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sampler import (
    TOP_CAP,
    gumbel_noise,
    sample_tokens,
)
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig, list_presets
from production_stack_tpu_torch.ops import paged_attention
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}

# Row-block height of the ragged kernel's flattened query-row space.
RAGGED_TQ = paged_attention.RAGGED_TQ


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _ceil_tq(n: int) -> int:
    return -(-n // RAGGED_TQ) * RAGGED_TQ


def resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name!r}")
    return DTYPES[name]


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

        if params is None:
            if config.model not in list_presets():
                raise NotImplementedError(
                    f"model {config.model!r}: checkpoint loading is not "
                    "ported to the PyTorch engine yet (presets run on "
                    "random weights)"
                )
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
        self.dispatch_counts = {"prefill": 0, "prefill_batch": 0,
                                "decode": 0}

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

    # -- host-side helpers -------------------------------------------------
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
        cap = min(TOP_CAP, self.model_config.vocab_size)
        return sample_tokens(
            logits, self._dev(temps), self._dev(top_ps), self._dev(top_ks),
            self._dev(gumbel_noise(keys, cap)), min_p=self._dev(min_ps),
        )

    def _phase_add(self, name: str, dt: float) -> None:
        self.prefill_phase_s[name] += dt

    # -- public API --------------------------------------------------------
    @torch.inference_mode()
    def prefill(
        self,
        token_ids: list[int],
        start_pos: int,
        block_table: list[int],
        total_len: int,
        sampling=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run one prefill chunk; returns (token, logits) on the device:
        the first generated token sampled from the chunk's last actual
        row, and that row's f32 (vocab,) logits. K/V for the chunk is
        written into the cache."""
        t0 = time.perf_counter()
        t = len(token_ids)
        t_pad = self._prefill_bucket(t)
        c_pad = self._ctx_bucket(total_len)
        tokens = np.zeros((t_pad,), dtype=np.int32)
        tokens[:t] = token_ids
        positions = np.full((t_pad,), -1, dtype=np.int32)
        positions[:t] = np.arange(start_pos, start_pos + t)
        write_slots = self._slots_for_positions(block_table, positions)
        # padded rows carry position -1 -> rope of 0, write to trash
        positions_dev = np.where(positions < 0, 0, positions)
        table = self._padded_block_table(
            block_table, c_pad // self.block_size
        )
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
            logits_rows=torch.tensor([t - 1], device=self.device),
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

    def _packed_attn(self, s_pad: int, t_pad: int, tables: np.ndarray,
                     q_starts: np.ndarray):
        """Attention over s_pad back-to-back chunks on one flat token axis
        (row s*t_pad + r is row r of chunk s)."""
        mc = self.model_config
        tables_d = self._dev(tables)
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
                q_starts[lane_of] + off_in,
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
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run one prompt chunk for EACH of n sequences in a single packed
        forward; returns (tokens, logits) on the device — tokens (s_pad,)
        sampled from each chunk's last actual row, logits (s_pad, vocab)
        (rows >= n are padding). K/V for every chunk is written."""
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
        attn = self._packed_attn(s_pad, t_pad, tables, q_starts)
        tokens_d = self._dev(tokens.reshape(-1))
        pos_d = self._dev(positions_dev.reshape(-1))
        slots_d = self._dev(write_slots.reshape(-1))
        rows_d = self._dev(last_rows)
        t2 = time.perf_counter()
        self._phase_add("h2d", t2 - t1)
        logits, _, _ = llama.forward(
            self.model_config, self.params, tokens_d, pos_d, self.k_cache,
            self.v_cache, slots_d, attn, logits_rows=rows_d,
        )
        sampled = self.sample(logits, temps, top_ps, top_ks, min_ps, keys)
        self.dispatch_counts["prefill_batch"] += 1
        self._phase_add("dispatch", time.perf_counter() - t2)
        return sampled, logits

    def _decode_attn(self, b: int, tables: np.ndarray, ctx: np.ndarray):
        """Decode-shaped attention: the ragged kernel with one single-row
        segment per lane (blocks hold up to RAGGED_TQ lanes), or the
        per-sequence decode kernel with --no-ragged-kernel."""
        tables_d = self._dev(tables)
        if self.ragged_kernel:
            tq = RAGGED_TQ
            r_pad = _ceil_tq(b)
            n_blk = r_pad // tq
            blk_seg = np.minimum(
                np.arange(n_blk + 1, dtype=np.int32) * tq, b
            ).astype(np.int32)
            lanes = np.arange(b, dtype=np.int32)
            seg_meta = np.stack([
                lanes, lanes % tq, np.ones((b,), np.int32), ctx - 1,
            ], axis=1).astype(np.int32)
            blk_seg_d, seg_meta_d = self._dev(blk_seg), self._dev(seg_meta)

            def attn(q, l, kc, vc):
                qp = torch.zeros((r_pad,) + tuple(q.shape[1:]),
                                 dtype=q.dtype, device=q.device)
                qp[:b] = q
                out = self._attn(
                    "ragged", qp, l, kc, vc, tables_d, blk_seg_d, seg_meta_d
                )
                return out[:b]
            return attn

        ctx_d = self._dev(ctx)

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
    ) -> torch.Tensor:
        """One decode step for a batch; returns f32 logits (b, vocab) on
        the device where rows beyond len(token_ids) are padded lanes."""
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
        attn = self._decode_attn(b, tables, ctx)
        logits, _, _ = llama.forward(
            self.model_config, self.params, self._dev(tokens),
            self._dev(pos), self.k_cache, self.v_cache,
            self._dev(write_slots), attn,
            logits_rows=torch.arange(b, device=self.device),
        )
        self.dispatch_counts["decode"] += 1
        return logits


def _to_device(tree: dict, device: torch.device) -> dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
