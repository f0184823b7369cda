"""Model runner: owns params + the paged KV cache on the device and runs
the prefill / packed-prefill / decode forwards.

Counterpart of ``production_stack_tpu/engine/model_runner.py``:
single-sequence ``prefill`` (with ``prompt_lp_targets``, every row's
target logprob and top-LOGPROB_CAP alternatives computed on the device),
packed ``prefill_batch``, the packed speculative ``verify_batch`` (every
row sampled on the device), single-step ``decode``, the fused K-step
``decode_multi`` and the unified lane-typed round ``ragged_dispatch``
(both evaluate guided lanes' TokenDFA tables inside the loop), the
staging of each (``stage_prefill``, ``stage_prefill_batch``,
``stage_decode_multi``, ``stage_ragged``), and the KV export and import
of whole blocks in the wire layout the tiers, peers and cache server
share (``stage_export_blocks`` / ``materialize_export``,
``stage_import_blocks`` / ``import_staged_blocks``), and ``embed`` (a
mean-pooled final hidden state over a scratch cache of its own).
Host-side padding keeps the JAX buckets — chunks pad to a power of two
>= 8, contexts to a power-of-two block count, decode to max_num_seqs
lanes, ragged-round prefill rows to a power of two — so the kernels see
the same padded tables and metadata as the Pallas kernels do.

Compiled programs (engine/programs.py): the JAX runner jits one program
per padded key and counts each build (``_note_compile``,
``compile_events``). Here every program it jit-caches is a variant of
the same kind, with static buffers and, on the card, a CUDA graph
captured over them (``_dispatch_program``): single ``prefill`` per
(t_pad, c_pad, prompt logprobs, adapter key); packed prefill per
("prefill_rows", r_pad, pc_pad) on the ragged-rows layout or
("prefill_batch", s_pad, t_pad, c_pad) per lane; the ragged round's
step 0 per ("ragged_rows", r_pad, the wider context bucket's pages,
flags) or, composed, its prefill half per ("ragged", s_pad, t_pad,
pc_pad); ``verify`` per (s_pad, t_pad, c_pad); ``embed`` per chunk
(t_pad, c_pad), its scratch cache the variant's static buffer;
``kv_import`` per (n_pad, n_pad); the single-step ``decode`` per
(b, c_pad); and ONE iteration of the fused K-step loop per (b, c_pad,
sampling / stop / guided / LoRA flags, chained) (``decode_multi``, the
ragged round's iterations 1..K-1 and the composed round's loop replay
the same iteration graph). A dispatch copies its packed buffer (or its
fields) into the variant's static buffers; every per-dispatch value,
the prefill kernel's chunk start included, reaches the program that
way. Building a variant is a compile event. The long-prefill ring's
chunk, which JAX jit-caches per (C, S_pad) in its prefiller's
``_chunk_fns`` and does not count as a runner compile event, is a
variant of the prefiller's own (parallel/long_context.py), in a graph
pool of its own (``build_long_prefiller``). ``ModelRunner(eager=True)``
runs every dispatch eagerly (the comparison control). The
``precompile_*`` methods run the JAX runner's trash dispatches at the
top of the block pool, and ``precompile_cover`` what those leave to a
live dispatch, building every variant a serving config reaches.

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
the carried tensors; it reads nothing back: under device stops the host
enqueues iterations up to the largest remaining budget, and on the card
a captured iteration skips its forward once every lane is done (a CUDA
graph conditional node, programs.GatedProgramVariant). A chained round
takes its tokens from the previous round's device output instead of the
buffer.

Every dispatch runs on the runner's named ``compute_stream`` (the
device's default stream; ``LLMEngine.step`` enters it). A KV export may
be enqueued from another thread (a PD pull), so its gather is enqueued
on that stream by name, with an event after it: a later dispatch that
overwrites the blocks is ordered behind the gather.

Attention goes through one seam, ``_attn(kind, ...)``, whose functions
the attention impl picks at boot (``attention_impl``, the JAX package's
names): ``pallas``, the wrappers in ops/paged_attention.py, which launch
the hand-written kernels on a CUDA device and compute their plain
versions on the CPU; ``xla``, the gather path of ops/attention.py on the
same page tables. ``auto`` is pallas, except on the card for a head_dim
the kernels are not built for (logged). Under xla, or with
``--no-ragged-kernel``, every round composes per-lane prefill and decode
calls: the ragged round too (``_build_ragged``). The choice is made from
shapes alone; no build or launch failure changes it.

A rank-set runner (``group``) holds its stage's layers and its tp
shard; under pipeline parallelism its forward is
parallel/pp_serving.forward_pp and its attention the gather path (the
JAX runner's rule: pp serves on XLA, ``pallas`` refused at boot,
``validate_parallel``).

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
import contextlib
import functools
import math
import threading
import time

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.lora import LoraManager
from production_stack_tpu_torch.engine.programs import (
    GatedProgramVariant,
    ProgramVariant,
)
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
from production_stack_tpu_torch.ops.attention import (
    block_table_slots,
    context_attention_prefill,
    paged_decode_attention_gather,
    paged_prefill_attention_gather,
)
from production_stack_tpu_torch.parallel import sharding
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

# prompt-logprob rows projected to the vocab at once: a 512-row chunk's
# (512, V) f32 logits at V = 128256 would be 262 MB
PROMPT_LP_ROW_CHUNK = 128
# an embed chunk's plain attention scores rows in pieces of at most this
# many bytes of (rows, nq, context) float32 scores, so a captured embed
# holds a bounded share of the graphs' pool at any context bucket
EMBED_SCORE_BYTES = 64 * 2**20

# device memory kept back from the KV pool for the CUDA graphs' shared
# pool: at least this, GRAPH_POOL_ROWS (b, V) float32 tensors (an
# iteration's logits, penalty counts, guided mask and sampler
# temporaries live at once), and the largest prefill-shaped program's
# activations (ModelRunner._graph_pool_reserve)
GRAPH_POOL_RESERVE_MIN = 256 * 2**20
GRAPH_POOL_ROWS = 32
# vocab-wide float32 rows a prefill-shaped program holds at once per
# PROMPT_LP_ROW_CHUNK rows scored (logits, log-softmax, sampler scratch)
GRAPH_POOL_VOCAB_COPIES = 3
# the pool's size over one program's peak: captures of many shapes
# fragment it (the 3B's K=8 sweep left 1.9x the estimate on an H100)
GRAPH_POOL_SLACK = 2

# the fused decode loop's carry, all on the device: (b,) int32 tokens,
# positions and context lengths, (b, V) f32 penalty counts or None, (b,)
# bool done, (b,) int32 valid counts, (b,) int32 guided DFA states
DecodeCarry = collections.namedtuple(
    "DecodeCarry",
    ["tokens", "positions", "ctx", "counts", "done", "valid", "g_state"],
)


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _ceil_tq(n: int) -> int:
    return -(-n // RAGGED_TQ) * RAGGED_TQ


# stackcheck: not-hot — numpy over host lane lengths
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


def resolve_attention_impl(requested: str, head_dim: int,
                           device_type: str) -> str:
    """The attention impl a runner serves with, from shapes alone and
    never changed after boot (no build or launch failure moves it):
    "xla" or "pallas" as asked; "auto" is pallas, except on the card for
    a head_dim the kernels are not built for, where it is xla and says
    so (the JAX package's rule, on its accelerator only)."""
    if requested != "auto":
        return requested
    if (device_type == "cuda"
            and head_dim not in paged_attention.KERNEL_HEAD_DIMS):
        logger.warning("attention impl: xla (head_dim %d not in %s)",
                       head_dim, paged_attention.KERNEL_HEAD_DIMS)
        return "xla"
    return "pallas"


def validate_parallel(config: EngineConfig, mc: ModelConfig) -> None:
    """The JAX runner's boot checks of a meshed engine, message for
    message: the tensor-parallel split, then the pipeline's (divisible
    layers, no MoE, no LoRA) and its refusal of the kernels (pp serves
    on the gather path)."""
    tp = config.tensor_parallel_size
    pp = config.pipeline_parallel_size
    if tp * pp > 1:
        sharding.validate_tp(mc, tp)
    if pp > 1:
        from production_stack_tpu_torch.parallel import pp_serving

        pp_serving.validate_pp_serving(mc, pp, config)
        if config.attention_impl == "pallas":
            raise ValueError(
                "attention_impl=pallas does not compose with "
                "pipeline_parallel_size>1 yet (the kernels' own "
                "shard_map cannot nest in the pp manual region); "
                "use auto or xla"
            )


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
    def __init__(self, config: EngineConfig, params: dict | None = None,
                 eager: bool = False, group=None):
        """`eager`: run every dispatch eagerly, with no program variant
        and no CUDA graph (the control the compiled path is held to; not
        a serving option).

        `group` (parallel/group.TPGroup, the JAX runner's `mesh`): this
        runner is one rank of a set of tensor_parallel_size x
        pipeline_parallel_size ranks, stage group.stage and tp index
        group.tp_rank. It runs on the group's device, holds its stage's
        layers and its rank's tp shard of the params
        (parallel/sharding.py) and its local KV cache (L/pp, nkv/tp,
        slots, d), runs the forward on the local config view with its
        stage's all-reduces (under pp the staged forward of
        parallel/pp_serving.py, on the gather path), and attention at
        pp=1 through the *_tp wrappers. A rank-set runner is eager: the
        gloo collectives cannot be captured in a CUDA graph."""
        self.config = config
        self.group = group
        self.tp_size = config.tensor_parallel_size
        self.pp_size = config.pipeline_parallel_size
        layout = ((group.world_size, group.pp_size) if group is not None
                  else (1, 1))
        if layout != (self.tp_size * self.pp_size, self.pp_size):
            raise ValueError(
                f"tensor_parallel_size={self.tp_size} x "
                f"pipeline_parallel_size={self.pp_size} but the runner's "
                f"group has {layout[0]} ranks in {layout[1]} stages"
            )
        # the stage's tp group: the Megatron all-reduces and the vocab
        # gather (the whole set at pp=1, None at tp=1)
        self._tp_comm = group.tp if group is not None else None
        if group is not None and not eager:
            logger.info("rank %d/%d (stage %d, tp index %d) runs eagerly "
                        "(no CUDA graphs in a rank set)", group.rank,
                        group.world_size, group.stage, group.tp_rank)
        self.eager = bool(eager) or group is not None
        # program variants by key (engine/programs.py), the graphs'
        # shared pool (made at the first capture), and the builds counted
        # per kind as the JAX runner's compile events
        self._variants: dict[tuple, ProgramVariant] = {}
        self._graph_pool = None
        # the captured dispatches' shared output buffers
        self._out_buffers: dict[tuple, torch.Tensor] = {}
        self.compile_events: dict[str, int] = {}
        self.compile_events_total = 0
        # the global config (sizing, the engine's vocab and lengths);
        # local_config is one rank's view for the forward and the cache
        self.model_config: ModelConfig = config.model_config()
        validate_parallel(config, self.model_config)
        self.local_config: ModelConfig = (
            self.model_config.tp_local(self.tp_size).pp_local(self.pp_size)
            if group is not None else self.model_config)
        self.device = (group.device if group is not None
                       else torch.device(config.device))
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
        if mc.is_moe and mc.moe_capacity_factor > 0:
            # serving pads decode lanes and prefill buckets, and the
            # capacity path has no per-row validity inside llama.forward:
            # padded rows would take expert capacity from real tokens
            raise ValueError(
                f"model {mc.name}: moe_capacity_factor="
                f"{mc.moe_capacity_factor} is not servable; the engine "
                "requires the exact dense MoE path (capacity_factor=0)"
            )
        impl = ("xla" if self.pp_size > 1 else  # see validate_parallel
                resolve_attention_impl(config.attention_impl, mc.head_dim,
                                       self.device.type))
        self.attention_impl = impl
        # the single ragged kernel serves pallas rounds only; off it (or
        # under xla) rounds compose the per-lane prefill and decode calls
        self.ragged_kernel = bool(config.ragged_kernel) and impl == "pallas"
        if self.device.type == "cuda" and impl == "pallas":
            # refuse at boot what the card kernels are not built for: the
            # prefill tile (prefill and ragged kernels) runs on every path,
            # the decode kernel without the ragged kernel
            g = mc.num_heads // mc.num_kv_heads
            try:
                paged_attention.check_kernel_shapes(
                    mc.head_dim, self.block_size,
                    None if self.ragged_kernel else g)
            except ValueError as e:
                raise ValueError(
                    f"model {mc.name} (head_dim {mc.head_dim}, {g} query "
                    f"heads per kv head) at block_size {self.block_size} "
                    f"cannot run on the card: {e}") from None

        shard = ((group.tp_rank, self.tp_size) if group is not None
                 else None)
        # the stage's layers (pipeline parallelism)
        layers = (sharding.stage_layers(mc.num_layers, group.stage,
                                        self.pp_size)
                  if self.pp_size > 1 else None)
        if params is not None:
            # the caller's full params: this rank's shard of them
            if shard is not None:
                params = sharding.shard_params(params, mc, *shard,
                                               layers=layers)
            params = _to_device(params, self.device)
        else:
            # a checkpoint that resolves loads (or raises), sliced to the
            # rank's shard as it is read; only a preset name, which
            # resolves to none, draws random weights
            params = weights.maybe_load(config.model, mc, self.dtype,
                                        self.device, shard=shard,
                                        layers=layers)
        if params is None:
            logger.info(
                "initializing random %s params (%.2fB params, %s, %s)",
                mc.name, mc.num_params() / 1e9, config.dtype, self.device,
            )
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = llama.init_params(mc, gen, self.dtype, self.device,
                                       shard=shard, layers=layers)
        self.params = params
        if self.pp_size > 1:
            from production_stack_tpu_torch.parallel import pp_serving

            self._forward = functools.partial(pp_serving.forward_pp,
                                              group=group)
        elif group is not None:
            self._forward = functools.partial(llama.forward,
                                              tp_group=self._tp_comm)
        else:
            self._forward = llama.forward

        self.num_blocks = self._resolve_num_blocks()
        num_slots = self.num_blocks * self.block_size
        # head-major (L, nkv, slots, d): the layout the kernels walk (a
        # stage's layers and a rank's kv heads in a rank set)
        cache_shape = sharding.local_cache_shape(mc, num_slots,
                                                 self.tp_size, self.pp_size)
        logger.info(
            "allocating KV cache: %d blocks x %d slots (%.2f GiB)",
            self.num_blocks, self.block_size,
            2 * math.prod(cache_shape) * self.cache_dtype.itemsize / 2**30,
        )
        self.k_cache = torch.zeros(cache_shape, dtype=self.cache_dtype,
                                   device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)

        self._scale = mc.head_dim**-0.5
        self._attn_fns = (
            {"prefill": paged_attention.paged_prefill_attention,
             "decode": paged_attention.paged_decode_attention,
             "ragged": paged_attention.ragged_paged_attention}
            if impl == "pallas" else
            {"prefill": paged_prefill_attention_gather,
             "decode": paged_decode_attention_gather}
        )
        if impl == "pallas" and group is not None:
            # the kernels on the rank's shard (the JAX runner's *_tp
            # branch of _attn); the gather path sees local heads as is
            tp_kw = dict(num_heads=mc.num_heads,
                         num_kv_heads=mc.num_kv_heads, tp_size=self.tp_size)
            self._attn_fns = {
                "prefill": functools.partial(
                    paged_attention.paged_prefill_attention_tp, **tp_kw),
                "decode": functools.partial(
                    paged_attention.paged_decode_attention_tp, **tp_kw),
                "ragged": functools.partial(
                    paged_attention.ragged_paged_attention_tp, **tp_kw),
            }
        # pipelined prefill: one packed buffer a prefill dispatch (packed
        # groups on the ragged-rows layout under the ragged kernel); a
        # rank-set runner keeps the per-array path, as the JAX meshed
        # runner does (precompile_serving's grid keys on this flag)
        self.prefill_pipeline = (bool(config.prefill_pipeline)
                                 and group is None)
        # staged copies: a side stream (made at the first stage), and the
        # pinned sources of copies that may still be in flight, held
        # until their event fires even when the handle is dropped
        self._copy_stream = None
        self._inflight: collections.deque = collections.deque()
        # the stream every dispatch runs on, named so a KV export
        # enqueued from another thread is ordered with the dispatches;
        # exports copy device->host on their own stream (made at the
        # first export, under the lock: several threads may export)
        self.compute_stream = (
            torch.cuda.default_stream(self.device)
            if self.device.type == "cuda" else None
        )
        self._d2h_stream = None
        self._d2h_lock = threading.Lock()
        # the card's index, for threads that export (set_device takes
        # an index; "cuda" names the device current at construction)
        self._device_index = (
            (self.device.index if self.device.index is not None
             else torch.cuda.current_device())
            if self.device.type == "cuda" else None
        )
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
        # (decode_iterations: iterations the fused K-step loops ran, so
        # a run can see a round that ended before its K; prefill_lanes:
        # the padded lanes of composed packed forwards, one prefill call
        # each a layer)
        self._blk_seg_cache: dict[int, torch.Tensor] = {}
        # sampler candidates (and noise columns) per row
        self._top_cap = min(TOP_CAP, self.model_config.vocab_size)
        self.dispatch_counts = {"prefill": 0, "prefill_batch": 0,
                                "decode": 0, "decode_multi": 0,
                                "ragged": 0, "decode_iterations": 0,
                                "verify_batch": 0, "prefill_lanes": 0}
        # fused rounds chained on the previous round's device tokens
        self.chained_rounds = 0
        # decode forwards the fused loop's `step` ran on the device (a
        # captured iteration skips its forward once every lane is done,
        # an eager one runs it); read only by measurements
        self.loop_forwards = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        # the embed programs' scratch caches: one pair of flat buffers at
        # the largest context bucket reached, viewed per bucket
        self._embed_scratch = None
        # pool bytes of the program variants dropped since their capture
        self._dropped_pool_bytes = 0
        # the DFA tables of the live constraints on the device, keyed by
        # the engine's cache token; how often they were uploaded, and the
        # fused rounds that ran guided lanes on them
        self._guided_dev = None
        self.guided_table_uploads = 0
        self.guided_rounds = 0
        # multi-LoRA: stacked adapter buffers applied in the forwards
        # (engine/lora.py); None when --enable-lora is off, so no
        # dispatch carries adapter math
        self.lora_manager = None
        if config.enable_lora:
            # a tp rank's manager holds its slice of each adapter (LoRA
            # under pp is refused at boot, the JAX package's rule)
            self.lora_manager = LoraManager(
                mc, config.max_loras, config.max_lora_rank, self.dtype,
                self.device, shard=shard)

    # -- sizing -----------------------------------------------------------
    def _resolve_num_blocks(self) -> int:
        cfg, mc = self.config, self.model_config
        if cfg.num_kv_blocks is not None:
            return cfg.num_kv_blocks
        # per-rank view: KV blocks and weights are both split ~1/(tp*pp)
        ways = self.tp_size * self.pp_size
        bytes_per_block = (
            2 * mc.num_layers * cfg.block_size * mc.num_kv_heads
            * mc.head_dim * self.cache_dtype.itemsize
        ) // ways
        if self.device.type == "cuda":
            # the params already sit on the card, so free memory excludes
            # them; keep (1 - utilization) of the card unclaimed, and
            # room for the graphs' pool
            free, total = torch.cuda.mem_get_info(self.device)
            budget = int(free - total * (1.0 - cfg.hbm_utilization))
            if not self.eager:
                budget -= self._graph_pool_reserve()
                budget -= sum(self._ring_reserve())
        else:
            param_bytes = mc.num_params() * self.dtype.itemsize // ways
            budget = int(16 * 2**30 * cfg.hbm_utilization) - param_bytes
        num = max(2, budget // bytes_per_block)
        # cap: no point holding more than max_model_len * max_num_seqs * 2
        cap = (
            2 * (self.max_model_len // cfg.block_size + 1)
            * max(1, cfg.max_num_seqs)
        )
        num = int(min(num, max(cap, 2)))
        if self.group is not None:
            # rank 0's scheduler hands out block ids for every rank: the
            # pool is the smallest any rank can hold (ranks sharing a card
            # also see each other's allocations in mem_get_info)
            num = self.group.agree_min(num)
        return num

    def _graph_pool_reserve(self) -> int:
        """Bytes kept back for the graphs' shared pool, sized to the
        largest captured program: the decode programs' GRAPH_POOL_ROWS
        (b, V) float32 tensors, or a prefill-shaped program's rows (the
        widest packed prefill or ragged round) times a row's live float32
        activations (residual and norms, q/k/v, the MLP's gate, up and
        product, every expert's under the dense MoE path) plus
        GRAPH_POOL_VOCAB_COPIES vocab rows for each of PROMPT_LP_ROW_CHUNK
        rows (prompt logprobs, verify's sampler). Captures share the pool
        and free their temporaries (a dispatch program's outputs go to
        buffers outside it), but captures of many shapes fragment it:
        GRAPH_POOL_SLACK times one program's peak."""
        cfg, mc = self.config, self.local_config
        decode = GRAPH_POOL_ROWS * cfg.max_num_seqs * mc.vocab_size * 4
        rows = max(
            self._rows_bucket(self._rows_lane_cap()
                              * _ceil_tq(cfg.max_prefill_chunk))
            + _ceil_tq(cfg.max_num_seqs),
            next_pow2(max(cfg.max_prefill_seqs, cfg.max_num_seqs))
            * self._prefill_bucket(cfg.max_prefill_chunk),
        )
        per_row = 4 * (4 * mc.hidden_size
                       + 3 * mc.intermediate_size * max(1, mc.num_experts)
                       + (mc.num_heads + 2 * mc.num_kv_heads) * mc.head_dim)
        vocab = (GRAPH_POOL_VOCAB_COPIES * PROMPT_LP_ROW_CHUNK
                 * mc.vocab_size * 4)
        return max(GRAPH_POOL_RESERVE_MIN, decode,
                   GRAPH_POOL_SLACK * (rows * per_row + vocab))

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

    # -- compiled programs --------------------------------------------------
    def _note_compile(self, kind: str) -> None:
        """Count one program-variant build (the JAX runner's jit cache
        miss)."""
        self.compile_events[kind] = self.compile_events.get(kind, 0) + 1
        self.compile_events_total += 1

    def _static_addresses(self) -> tuple:
        """Addresses a captured graph bakes in besides its own buffers:
        the KV caches and the LoRA buffers (both updated in place)."""
        bufs = [self.k_cache, self.v_cache]
        if self.lora_manager is not None:
            bufs += [self.lora_manager.buffers[k]
                     for k in sorted(self.lora_manager.buffers)]
        return tuple(t.data_ptr() for t in bufs)

    def _program(self, kind: str, key: tuple, make) -> ProgramVariant:
        """The variant of `key`, built on first use from `make()` ->
        (fn, inputs), or ((forward, post, done), inputs) for a gated one
        (programs.GatedProgramVariant), and counted as a compile event of
        `kind`."""
        var = self._variants.get(key)
        if var is None:
            self._note_compile(kind)
            fn, inputs = make()
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            # a (forward, post, done) triple makes a gated variant
            cls, fns = ((GatedProgramVariant, fn) if isinstance(fn, tuple)
                        else (ProgramVariant, (fn,)))
            var = self._variants[key] = cls(
                kind, key, *fns, inputs, self.device, self._graph_pool,
                self._static_addresses)
        return var

    @staticmethod
    def _program_lora(lora):
        """A _lora_key as a program key: none, the uniform slot (the
        graph bakes it in), or "lanes" (the slot vector is an input)."""
        return "lanes" if isinstance(lora, tuple) else lora

    def graph_pool_bytes(self) -> int:
        """Device memory the captures added to the graphs' shared pool
        (a dropped variant's share stays in the pool)."""
        return self._dropped_pool_bytes + sum(
            v.pool_bytes for v in self._variants.values())

    def static_input_bytes(self) -> int:
        """Device memory the variants' static buffers hold outside the
        graphs' pool: their inputs, the embed scratch caches and the
        shared output buffers."""
        seen: dict[int, int] = {}
        for t in _tensors([[v.inputs for v in self._variants.values()],
                           list(self._out_buffers.values()),
                           self._embed_scratch]):
            n = t.numel() * t.element_size()
            seen[t.data_ptr()] = max(n, seen.get(t.data_ptr(), 0))
        return sum(seen.values())

    def _out_buffer(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The shared output buffer of output position `i` shaped like
        `t` (made at a program's first, eager run, never inside a
        capture)."""
        key = (i, tuple(t.shape), t.dtype)
        buf = self._out_buffers.get(key)
        if buf is None:
            buf = self._out_buffers[key] = torch.empty_like(t)
        return buf

    # stackcheck: hot-path — every captured dispatch loads and runs here
    def _dispatch_program(self, kind: str, key: tuple, fn, inputs: dict,
                          wide: dict | None = None,
                          static: dict | None = None) -> tuple:
        """Run `fn(inputs)` -> tuple of tensors as the program variant of
        `key` (kind `kind`): each input is copied into the variant's
        static buffer of its name (a None input stays None), `wide`
        names inputs whose static buffer is wider in one dim (the copy
        fills its leading part and zeroes the rest), and `static`
        holds tensors the program reads in place (its scratch). On the
        card the program copies its outputs into output buffers the
        runner's variants share (by position, shape and dtype; outside
        the graphs' pool, so a capture's own tensors go back to the pool
        when it ends and the pool holds about one program's peak), and
        the dispatch copies them out, since the next run of a variant
        overwrites them. Under `eager` fn runs on the dispatch's own
        tensors. `fn` must read nothing the key does not fix: the first
        dispatch's closure serves every later one."""
        if self.eager:
            return fn({**inputs, **(static or {})})
        wide = wide or {}

        def make():
            bufs = {name: None if t is None else t.new_empty(
                wide.get(name, tuple(t.shape)))
                for name, t in inputs.items()}
            if self.device.type != "cuda":
                return fn, {**bufs, **(static or {})}

            def into_shared(inp):
                return tuple(None if t is None else
                             self._out_buffer(i, t).copy_(t)
                             for i, t in enumerate(fn(inp)))

            return into_shared, {**bufs, **(static or {})}

        var = self._program(kind, key, make)
        for name, t in inputs.items():
            if t is None:
                continue
            dst = var.inputs[name]
            if dst.shape == t.shape:
                dst.copy_(t)
            else:
                d = next(i for i, (m, n) in enumerate(zip(dst.shape,
                                                          t.shape)) if m != n)
                w = t.shape[d]
                dst.narrow(d, 0, w).copy_(t)
                dst.narrow(d, w, dst.shape[d] - w).zero_()
        out = var.run()
        if self.device.type == "cuda":
            out = tuple(None if t is None else t.clone() for t in out)
        return out

    # -- the attention seam -------------------------------------------------
    # stackcheck: hot-path — the ONE dispatch seam every paged attention
    # call goes through, once a layer of every forward
    def _attn(self, kind: str, q, layer, kc, vc, *args):
        """Route one attention call for `kind` ("prefill" | "decode" |
        "ragged", the last under the ragged kernel only) to the impl's
        function, filling block size, scale and window from the runner's
        config. pallas: the paged kernel's wrapper, which launches the
        CUDA kernel for tensors on the card and the plain version for CPU
        tensors; xla: the gather path on the same arguments."""
        fn = self._attn_fns[kind]
        return fn(
            q, kc, vc, layer, *args,
            block_size=self.block_size, scale=self._scale,
            window=self.model_config.sliding_window,
        )

    # -- multi-LoRA -----------------------------------------------------------
    # stackcheck: not-hot — host ints of the lanes' adapter slot lists
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

    def phase_snapshot(self) -> dict[str, float]:
        return dict(self.prefill_phase_s)

    def phase_delta(self, snapshot: dict[str, float]) -> dict[str, float]:
        """Per-phase seconds spent since `snapshot` (the timeline's
        group_phase_s attribution)."""
        return {
            k: round(v - snapshot.get(k, 0.0), 6)
            for k, v in self.prefill_phase_s.items()
            if v - snapshot.get(k, 0.0) > 0.0
        }

    # -- pipelined prefill: one packed buffer a dispatch ---------------------
    def _prefill_pack_layout(self, t_pad: int, c_pad: int,
                             want_plp: bool = False):
        """Layout of the ONE int32 buffer a single-sequence prefill ships
        under the pipeline; the sampler noise (1, cap) takes the place of
        the JAX keys. The chunk's start position rides it too: the
        prefill kernel reads it from device memory (the Pallas kernel's
        scalar prefetch). `want_plp` adds each row's prompt-logprob
        target (-1: none)."""
        return self._layout_of([
            ("tokens", (t_pad,)),
            ("positions", (t_pad,)),
            ("write_slots", (t_pad,)),
            ("table", (c_pad // self.block_size,)),
            ("q_start", (1,)),
            ("last_row", (1,)),
            ("temps", (1,)),
            ("top_ps", (1,)),
            ("top_ks", (1,)),
            ("min_ps", (1,)),
            ("noise", (1, self._top_cap)),
        ] + ([("targets", (t_pad,))] if want_plp else []))

    def _packed_prefill_pack_layout(self, s_pad: int, t_pad: int,
                                    c_pad: int, lora_rows: bool = False):
        """The (s_pad, t_pad) packed-group variant (the pipeline without
        the ragged kernel): lane s holds rows [s * t_pad, (s+1) * t_pad)
        and starts at q_starts[s]. `lora_rows` adds the per-row adapter
        slots."""
        return self._layout_of([
            ("tokens", (s_pad * t_pad,)),
            ("positions", (s_pad * t_pad,)),
            ("write_slots", (s_pad * t_pad,)),
            ("tables", (s_pad, c_pad // self.block_size)),
            ("q_starts", (s_pad,)),
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
        prompt_lp_targets: list[int] | None = None,
    ) -> tuple[int, int, np.ndarray]:
        """Host build of the single-sequence prefill pack; returns (t_pad,
        c_pad, packed)."""
        t_pad, c_pad, tokens, positions, write_slots, table = (
            self._prefill_host_prep(token_ids, start_pos, block_table,
                                    total_len))
        want_plp = prompt_lp_targets is not None
        layout, size = self._prefill_pack_layout(t_pad, c_pad, want_plp)
        packed = np.zeros((size,), np.int32)
        put = functools.partial(self._pack_put, packed, layout)
        put("tokens", tokens)
        put("positions", positions)
        put("write_slots", write_slots)
        put("table", table)
        put("q_start", np.full((1,), start_pos, np.int32))
        put("last_row", np.full((1,), len(token_ids) - 1, np.int32))
        self._put_sampling(put, 1, sampling)
        if want_plp:
            put("targets", self._plp_targets(t_pad, prompt_lp_targets))
        return t_pad, c_pad, packed

    @staticmethod
    def _plp_targets(t_pad: int, targets: list[int]) -> np.ndarray:
        tg = np.full((t_pad,), -1, np.int32)
        tg[:len(targets)] = targets
        return tg

    def _prompt_lp_scores(self, hidden: torch.Tensor, last_row: torch.Tensor,
                          targets: torch.Tensor):
        """Prompt logprobs of a chunk on the device, from its final-norm
        hidden rows (t_pad, hidden): row i scores targets[i] (-1: none,
        chosen 0); `last_row` is the chunk's last row, (1,) int32 on the
        device (gathered, never read back). The rows reach the vocab
        PROMPT_LP_ROW_CHUNK at a time, so only (t_pad,) + 2 x (t_pad,
        LOGPROB_CAP) values and the last row's (V,) logits come out. Returns (last_logits (V,),
        chosen (t_pad,) f32, top_vals (t_pad, CAP) f32, top_ids (t_pad,
        CAP) int32)."""
        lm = functools.partial(llama.lm_logits, self.local_config,
                               self.params, tp_group=self._tp_comm)
        h = hidden.to(self.dtype)
        chosen, vals, ids = [], [], []
        for r0 in range(0, h.shape[0], PROMPT_LP_ROW_CHUNK):
            rows = slice(r0, r0 + PROMPT_LP_ROW_CHUNK)
            tg = targets[rows]
            c, v, i = token_logprobs(lm(h[rows]), tg.clamp_min(0))
            chosen.append(torch.where(tg >= 0, c, torch.zeros_like(c)))
            vals.append(v)
            ids.append(i)
        last_logits = lm(h.index_select(0, last_row.long()))[0]
        return (last_logits, torch.cat(chosen), torch.cat(vals),
                torch.cat(ids))

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
         q_starts, tables) = self._packed_host_prep(
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
        put("q_starts", q_starts)
        put("last_rows", last_rows)
        self._put_sampling(put, s_pad, sampling)
        if per_tok:
            put("lora_rows", self._packed_slot_vector(
                lora_slots, len(chunks), s_pad, t_pad))
        return s_pad, t_pad, c_pad, packed

    def _unpack_fields(self, packed: torch.Tensor, layout: dict) -> dict:
        """A packed buffer's fields as device views, the f32 ones
        (sampling parameters and noise) bit-viewed back."""
        f = {name: self._pack_seg(packed, layout, name) for name in layout}
        for name in ("temps", "top_ps", "min_ps", "noise"):
            if name in f:
                f[name] = f[name].view(torch.float32)
        return f

    def _single_prefill_step(self, t_pad: int, c_pad: int, lora=None,
                             want_plp: bool = False):
        """`step(f)` -> (token, logits (vocab,)): the single-sequence
        prefill forward on its fields `f` (the pack's, unpacked, or the
        per-array path's uploads; `lora`: a _lora_key, uniform or None for
        one sequence). The chunk starts at f["q_start"], (1,) int32 on the
        device. `want_plp` scores every row against f["targets"] too:
        (token, logits, chosen (t_pad,), top_vals, top_ids (t_pad,
        LOGPROB_CAP))."""
        mc = self.local_config

        # stackcheck: hot-path — the single-sequence prefill forward, once a
        # prefill step
        def step(f):
            table, q_start = f["table"], f["q_start"]

            def attn(q, l, kc, vc):
                return self._attn("prefill", q, l, kc, vc, table, q_start)

            out, _, _ = self._forward(
                mc, self.params, f["tokens"], f["positions"],
                self.k_cache, self.v_cache, f["write_slots"], attn,
                logits_rows=(torch.arange(t_pad, device=table.device)
                             if want_plp else f["last_row"]),
                return_hidden=want_plp, **self._lora_kw(lora),
            )
            scores = ()
            if want_plp:
                logits, *scores = self._prompt_lp_scores(
                    out, f["last_row"], f["targets"])
                logits = logits[None]
            else:
                logits = out
            token = sample_tokens(
                logits, f["temps"], f["top_ps"], f["top_ks"], f["noise"],
                min_p=f["min_ps"],
            )[0]
            return (token, logits[0], *scores)

        return step

    def _packed_prefill_step(self, s_pad: int, t_pad: int, lora=None):
        """`step(f)` -> (sampled (s_pad,), logits (s_pad, vocab)): the
        (s_pad, t_pad) packed group on its fields `f` (a pack's, unpacked,
        or the per-array path's uploads): one ragged launch a layer under
        the ragged kernel, else one prefill launch a lane a layer (lane s
        starting at f["q_starts"][s]; padding lanes start at 0 over the
        null table). `lora`: its _lora_key."""
        mc = self.local_config
        per_tok = isinstance(lora, tuple)

        # stackcheck: hot-path — the packed prefill forward, once a prefill or
        # composed round
        def step(f):
            attn = self._packed_attn(s_pad, t_pad, f["tables"],
                                     f["q_starts"])
            logits, _, _ = self._forward(
                mc, self.params, f["tokens"], f["positions"],
                self.k_cache, self.v_cache, f["write_slots"], attn,
                logits_rows=f["last_rows"], **self._lora_kw(
                    lora, f["lora_rows"] if per_tok else None),
            )
            sampled = sample_tokens(
                logits, f["temps"], f["top_ps"], f["top_ks"], f["noise"],
                min_p=f["min_ps"],
            )
            return sampled, logits

        return step

    # -- staged buffers ----------------------------------------------------------
    def _stage(self, key, packed: np.ndarray | torch.Tensor
               ) -> StagedBuffer:
        """Start the copy of a future dispatch's packed buffer (or a
        restore's host blocks): pinned, non_blocking on the runner's copy
        stream, an event recorded after it. Enqueue only: nothing here
        waits on the card."""
        host = (packed if isinstance(packed, torch.Tensor)
                else torch.from_numpy(packed))
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
        prompt_lp_targets: list[int] | None = None,
    ) -> tuple:
        """Run one prefill chunk; returns (token, logits) on the device:
        the first generated token sampled from the chunk's last actual
        row, and that row's f32 (vocab,) logits. K/V for the chunk is
        written into the cache.

        `staged` = a stage_prefill handle whose copy is already under
        way; used only when its bucket key matches (the CALLER guarantees
        its content equals what these arguments build).

        `lora_slot`: the sequence's adapter slot (0 = base model); the
        whole chunk takes the uniform path.

        `prompt_lp_targets` (vLLM prompt_logprobs): each row's NEXT
        prompt token id; the return then adds (chosen (t_pad,) f32,
        top_vals (t_pad, LOGPROB_CAP) f32, top_ids (t_pad, LOGPROB_CAP)
        int32), row i scoring targets[i], all computed on the device."""
        lora = self._lora_key([lora_slot])
        want_plp = prompt_lp_targets is not None
        t_pad = self._prefill_bucket(len(token_ids))
        c_pad = self._ctx_bucket(total_len)
        key = ("prefill", t_pad, c_pad, want_plp, self._program_lora(lora))
        step = self._single_prefill_step(t_pad, c_pad, lora, want_plp)
        if self.prefill_pipeline:
            packed_dev = None
            if (staged is not None and not want_plp
                    and staged.key == ("single", t_pad, c_pad, lora)):
                packed_dev = self._take(staged)
            if packed_dev is None:
                t0 = time.perf_counter()
                t_pad, c_pad, packed = self._fill_prefill_pack(
                    token_ids, start_pos, block_table, total_len,
                    sampling=sampling, prompt_lp_targets=prompt_lp_targets,
                )
                t1 = time.perf_counter()
                self._phase_add("prep", t1 - t0)
                packed_dev = self._upload(packed)
                self._phase_add("h2d", time.perf_counter() - t1)
            layout, _ = self._prefill_pack_layout(t_pad, c_pad, want_plp)
            fn = (lambda inp: step(self._unpack_fields(inp["packed"],
                                                        layout)))
            inputs = {"packed": packed_dev}
        else:
            # the per-array path: one upload a field
            t0 = time.perf_counter()
            _, _, tokens, positions, write_slots, table = (
                self._prefill_host_prep(token_ids, start_pos, block_table,
                                        total_len))
            temps, top_ps, top_ks, min_ps, keys = self._sampling_args(
                1, sampling)
            host = {
                "tokens": tokens, "positions": positions,
                "write_slots": write_slots, "table": table,
                "q_start": np.full((1,), start_pos, np.int32),
                "last_row": np.full((1,), len(token_ids) - 1, np.int32),
                "temps": temps, "top_ps": top_ps, "top_ks": top_ks,
                "min_ps": min_ps,
                "noise": gumbel_noise(keys, self._top_cap),
            }
            if want_plp:
                host["targets"] = self._plp_targets(t_pad, prompt_lp_targets)
            t1 = time.perf_counter()
            self._phase_add("prep", t1 - t0)
            inputs = {name: self._dev(a) for name, a in host.items()}
            self._phase_add("h2d", time.perf_counter() - t1)
            key += ("arrays",)
            fn = step
        t2 = time.perf_counter()
        out = self._dispatch_program("prefill", key, fn, inputs)
        self.dispatch_counts["prefill"] += 1
        self._phase_add("dispatch", time.perf_counter() - t2)
        return out

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
                     q_starts_d: torch.Tensor):
        """Attention over s_pad back-to-back chunks on one flat token axis
        (row s*t_pad + r is row r of chunk s); `tables_d` and each lane's
        start position `q_starts_d` ((s_pad,) int32) on the device, so
        the metadata is built there (a captured program reads each
        dispatch's). Without the ragged kernel each lane is one prefill
        call; the dispatch counts its padded lanes (prefill_lanes)."""
        mc = self.local_config
        if self.ragged_kernel:
            # ONE ragged-kernel launch per layer: every block of t_pad
            # (pow2 >= RAGGED_TQ) belongs to exactly one lane, so each
            # block is one full segment of its lane
            tq = RAGGED_TQ
            n_blk = (s_pad * t_pad) // tq
            dev = tables_d.device
            row0 = torch.arange(n_blk, dtype=torch.int32, device=dev) * tq
            lane_of = row0 // t_pad
            seg_meta_d = torch.stack([
                lane_of, torch.zeros_like(lane_of),
                torch.full_like(lane_of, tq),
                q_starts_d[lane_of.long()] + row0 % t_pad,
            ], dim=1).to(torch.int32)
            blk_seg_d = torch.arange(n_blk + 1, dtype=torch.int32,
                                     device=dev)

            def attn(q, l, kc, vc):
                return self._attn(
                    "ragged", q, l, kc, vc, tables_d, blk_seg_d, seg_meta_d
                )
            return attn

        def attn(q, l, kc, vc):
            qs = q.reshape(s_pad, t_pad, mc.num_heads, mc.head_dim)
            return torch.cat([
                self._attn("prefill", qs[s], l, kc, vc, tables_d[s],
                           q_starts_d[s:s + 1])
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
        per_tok = isinstance(lora, tuple)
        plora = self._program_lora(lora)
        s_pad = next_pow2(max(len(chunks), 1))
        t_pad = self._prefill_bucket(max(len(c) for c in chunks))
        c_pad = max(self._ctx_bucket(tl) for tl in total_lens)
        if self.prefill_pipeline:
            if self.ragged_kernel:
                # ragged-rows layout: one ragged launch a layer over the
                # group's rows, whatever the lane mix
                r_pad, pc_pad = self._rows_dims(chunks, total_lens)
                key = ("rows", r_pad, pc_pad, lora)
                fill = functools.partial(self._fill_rows_prefill_pack,
                                         lora_rows=per_tok)
                prog = ("prefill_rows", ("prefill_rows", r_pad, pc_pad,
                                         plora))
                rows_step = self._make_prefill_rows_step(r_pad, pc_pad,
                                                         lora)
                fn = (lambda inp: rows_step(inp["packed"]))
            else:
                key = ("packed", s_pad, t_pad, c_pad, lora)
                fill = self._fill_packed_prefill_pack
                prog = ("prefill_batch", ("prefill_batch", s_pad, t_pad,
                                          c_pad, plora))
                layout, _ = self._packed_prefill_pack_layout(
                    s_pad, t_pad, c_pad, per_tok)
                step = self._packed_prefill_step(s_pad, t_pad, lora)
                fn = (lambda inp: step(self._unpack_fields(inp["packed"],
                                                            layout)))
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
            inputs = {"packed": packed_dev}
        else:
            # the per-array path: one upload a field
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
            host = {
                "tokens": tokens.reshape(-1),
                "positions": positions_dev.reshape(-1),
                "write_slots": write_slots.reshape(-1), "tables": tables,
                "q_starts": q_starts, "last_rows": last_rows,
                "temps": temps, "top_ps": top_ps, "top_ks": top_ks,
                "min_ps": min_ps,
                "noise": gumbel_noise(keys, self._top_cap),
            }
            if per_tok:
                host["lora_rows"] = self._packed_slot_vector(
                    lora_slots, len(chunks), s_pad, t_pad)
            t1 = time.perf_counter()
            self._phase_add("prep", t1 - t0)
            inputs = {name: self._dev(a) for name, a in host.items()}
            self._phase_add("h2d", time.perf_counter() - t1)
            prog = ("prefill_batch", ("prefill_batch", s_pad, t_pad, c_pad,
                                      plora, "arrays"))
            fn = self._packed_prefill_step(s_pad, t_pad, lora)
        if not self.ragged_kernel:
            self.dispatch_counts["prefill_lanes"] += s_pad
        t2 = time.perf_counter()
        out = self._dispatch_program(*prog, fn, inputs)
        self.dispatch_counts["prefill_batch"] += 1
        self._phase_add("dispatch", time.perf_counter() - t2)
        return out

    # -- speculative verification ------------------------------------------
    def _verify_pack_layout(self, s_pad: int, t_pad: int, c_pad: int,
                            lora_rows: bool = False):
        """Layout of the ONE int32 buffer a verify dispatch ships: the
        (s_pad, t_pad) packed group's rows, then per-ROW sampling fields
        (row (s, j) samples with lane s's parameters and its own noise).
        `lora_rows` adds the per-row adapter slots."""
        r = s_pad * t_pad
        return self._layout_of([
            ("tokens", (r,)),
            ("positions", (r,)),
            ("write_slots", (r,)),
            ("tables", (s_pad, c_pad // self.block_size)),
            ("q_starts", (s_pad,)),
            ("temps", (r,)),
            ("top_ps", (r,)),
            ("top_ks", (r,)),
            ("min_ps", (r,)),
            ("noise", (r, self._top_cap)),
        ] + ([("lora_rows", (r,))] if lora_rows else []))

    @torch.inference_mode()
    def verify_batch(
        self,
        chunks: list[list[int]],
        start_positions: list[int],
        block_tables: list[list[int]],
        total_lens: list[int],
        row_sampling: tuple,
        lora_slots: list[int] | None = None,
    ) -> np.ndarray:
        """One packed verification forward over n lanes' draft chunks
        [last_token, d_1..d_k]; returns (n, t_pad) int32, fetched once:
        row (s, j) is the token lane s's sampler picks after consuming
        chunk row j. `row_sampling` = per-lane (temps, top_ps, top_ks,
        min_ps, seeds, key_starts): row j of lane s samples with the noise
        of key (seeds[s], key_starts[s] + j), the key sequential step j
        would use (greedy lanes take zeros, never read). KV of every fed
        row is written; rejected rows' KV lies past every reader's
        context until real tokens overwrite it, and padding rows write
        the trash slot. Attention: one ragged launch a layer over the
        whole packed axis, or one prefill launch a lane a layer with
        --no-ragged-kernel. The LM head and the sampler run
        PROMPT_LP_ROW_CHUNK rows at a time."""
        n = len(chunks)
        lora = self._lora_key(lora_slots)
        per_tok = isinstance(lora, tuple)
        (s_pad, t_pad, c_pad, tokens, positions_dev, write_slots,
         q_starts, tables) = self._packed_host_prep(
            chunks, start_positions, block_tables, total_lens
        )
        l_temps, l_top_ps, l_top_ks, l_min_ps, l_seeds, l_starts = (
            row_sampling)

        def rows(vals, fill, dtype):
            out = np.full((s_pad, t_pad), fill, dtype)
            out[:n] = np.asarray(vals, dtype)[:, None]
            return out

        temps = rows(l_temps, 0.0, np.float32)
        keys = np.stack([np.asarray(l_seeds, np.uint64),
                         np.asarray(l_starts, np.uint64)], axis=1)
        noise = np.zeros((s_pad, t_pad, self._top_cap), np.float32)
        noise[:n] = round_noise(keys, temps[:n, 0], t_pad,
                                self._top_cap).transpose(1, 0, 2)
        layout, size = self._verify_pack_layout(s_pad, t_pad, c_pad,
                                                per_tok)
        packed = np.zeros((size,), np.int32)
        put = functools.partial(self._pack_put, packed, layout)
        put("tokens", tokens)
        put("positions", positions_dev)
        put("write_slots", write_slots)
        put("tables", tables)
        put("q_starts", q_starts)
        put("temps", temps)
        put("top_ps", rows(l_top_ps, 1.0, np.float32))
        put("top_ks", rows(l_top_ks, -1, np.int32))
        put("min_ps", rows(l_min_ps, 0.0, np.float32))
        put("noise", noise)
        if per_tok:
            put("lora_rows", self._packed_slot_vector(
                lora_slots, n, s_pad, t_pad))
        packed_dev = self._upload(packed)
        if not self.ragged_kernel:
            self.dispatch_counts["prefill_lanes"] += s_pad
        (sampled,) = self._dispatch_program(
            "verify", ("verify", s_pad, t_pad, c_pad,
                       self._program_lora(lora)),
            self._verify_step(s_pad, t_pad, c_pad, lora),
            {"packed": packed_dev})
        self.dispatch_counts["verify_batch"] += 1
        return sampled.cpu().numpy().reshape(s_pad, t_pad)[:n]

    def _verify_step(self, s_pad: int, t_pad: int, c_pad: int, lora=None):
        """`fn(inputs)` -> (sampled (s_pad * t_pad,) int32,): the packed
        verification forward on inputs["packed"], every row sampled (the
        LM head and the sampler PROMPT_LP_ROW_CHUNK rows at a time)."""
        per_tok = isinstance(lora, tuple)
        layout, _ = self._verify_pack_layout(s_pad, t_pad, c_pad, per_tok)
        r = s_pad * t_pad

        # stackcheck: hot-path — the packed verify forward, once a
        # speculative round
        def fn(inp):
            f = self._unpack_fields(inp["packed"], layout)
            attn = self._packed_attn(s_pad, t_pad, f["tables"],
                                     f["q_starts"])
            hidden, _, _ = self._forward(
                self.local_config, self.params, f["tokens"],
                f["positions"], self.k_cache, self.v_cache,
                f["write_slots"], attn,
                logits_rows=torch.arange(r, device=self.device),
                return_hidden=True,
                **self._lora_kw(lora, f["lora_rows"] if per_tok else None),
            )
            h = hidden.to(self.dtype)
            sampled = torch.cat([
                sample_tokens(
                    llama.lm_logits(self.local_config, self.params, h[b],
                                    self._tp_comm), f["temps"][b],
                    f["top_ps"][b], f["top_ks"][b], f["noise"][b],
                    min_p=f["min_ps"][b],
                )
                for b in (slice(r0, r0 + PROMPT_LP_ROW_CHUNK)
                          for r0 in range(0, r, PROMPT_LP_ROW_CHUNK))
            ])
            return (sampled,)

        return fn

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

    def _decode_step_layout(self, b: int, c_pad: int,
                            lora_lanes: bool = False):
        """Layout of the ONE int32 buffer a single-step decode ships;
        `lora_lanes` adds each lane's adapter slot (a per-token step)."""
        return self._layout_of([
            ("tokens", (b,)),
            ("positions", (b,)),
            ("ctx", (b,)),
            ("write_slots", (b,)),
            ("tables", (b, c_pad // self.block_size)),
        ] + ([("lora_slots", (b,))] if lora_lanes else []))

    def _decode_step(self, b: int, c_pad: int, lora=None):
        """`step(packed)` -> (logits (b, vocab) f32,): the single-step
        decode forward on its packed buffer (`lora`: its _lora_key)."""
        per_tok = isinstance(lora, tuple)
        layout, _ = self._decode_step_layout(b, c_pad, per_tok)
        rows = torch.arange(b, device=self.device)

        # stackcheck: hot-path — the single-step decode forward, once a K=1
        # decode round
        def step(packed):
            seg = functools.partial(self._pack_seg, packed, layout)
            attn = self._decode_attn(b, seg("tables"), seg("ctx"))
            logits, _, _ = self._forward(
                self.local_config, self.params, seg("tokens"),
                seg("positions"), self.k_cache, self.v_cache,
                seg("write_slots"), attn, logits_rows=rows,
                **self._lora_kw(lora,
                                seg("lora_slots") if per_tok else None),
            )
            return (logits,)

        return step

    # stackcheck: hot-path — dispatch-only: returns device logits without
    # waiting; the caller's sampler owns the fetch of the step
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
        `lora_slots`: each lane's adapter slot (None = all base). The
        step is the program variant of (b, c_pad, adapter key): its
        static buffer takes this step's packed upload, and on the card
        its CUDA graph replays."""
        b_actual = len(token_ids)
        b = self.config.max_num_seqs
        c_pad = self._ctx_bucket(max(context_lens))
        lora = self._lora_key(lora_slots)
        per_tok = isinstance(lora, tuple)
        layout, size = self._decode_step_layout(b, c_pad, per_tok)
        packed = np.zeros((size,), np.int32)
        put = functools.partial(self._pack_put, packed, layout)

        def lanes(vals, fill):
            full = np.full((b,), fill, np.int32)
            full[:b_actual] = vals
            return full

        put("tokens", lanes(token_ids, 0))
        put("positions", lanes(positions, 0))
        put("ctx", lanes(context_lens, 1))
        put("write_slots", lanes([
            self._slots_for_positions(block_tables[i],
                                      np.asarray([positions[i]]))[0]
            for i in range(b_actual)], 0))
        n_pages = c_pad // self.block_size
        put("tables", np.stack([
            self._padded_block_table(
                block_tables[i] if i < b_actual else [], n_pages
            )
            for i in range(b)
        ]))
        if per_tok:
            put("lora_slots", lanes(lora_slots, 0))
        packed_dev = self._upload(packed)
        self.dispatch_counts["decode"] += 1
        step = self._decode_step(b, c_pad, lora)
        return self._dispatch_program(
            "decode", ("decode", b, c_pad, self._program_lora(lora)),
            lambda inp: step(inp["packed"]), {"packed": packed_dev})[0]

    # -- packed host->device buffers -----------------------------------------
    @staticmethod
    # stackcheck: not-hot — host arithmetic over a packed buffer's field
    # shapes
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

    # stackcheck: not-hot — host arithmetic over a field's static shape;
    # the slice itself is a view
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
                            lora_lanes: bool = False, guided: bool = False):
        """Layout of the ONE int32 buffer a fused decode round ships.
        `noise` is the round's (k, b, cap) sampler noise, drawn on the
        host from each lane's (seed, step + i) key. `stop_cap` None = the
        fixed-trip loop; an int adds the per-lane EOS id, min_tokens gate
        and remaining budget, and when > 0 a (b, stop_cap) stop-id
        matrix. Penalties add the generated-id history (b, c_pad), -1
        padded; logit bias its (b, bias_cap) ids and values. A `chained`
        round has no tokens field: its tokens are the previous round's
        last row, on the device. `lora_lanes` adds each lane's adapter
        slot (a per-token dispatch); `guided` each lane's initial DFA
        state and machine row (the tables themselves stay resident on
        the device, _decode_guided_tables)."""
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
        if guided:
            fields += [("g_state", (b,)), ("g_lane", (b,))]
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
        lora_slots=None, lora_lanes: bool = False, guided_lanes=None,
    ) -> np.ndarray:
        """Build the packed buffer of a fused decode round (layout:
        _decode_pack_layout) for len(positions) real lanes, padded to
        max_num_seqs. Padded lanes ship token 0, context 1, the zero
        table (trash block 0), EOS -1 and budget 0, so under device stops
        they are done from iteration 0. `guided_lanes` = (init_states,
        lane_map) of a round with guided lanes (padded lanes: state 0 of
        machine row 0, never read). Shared by the dispatch (decode_multi,
        ragged_dispatch) and the staging (stage_*)."""
        b = self.config.max_num_seqs
        n = len(positions)
        stop_cap = self._stop_cap(stop)
        bias_cap = 0 if logit_bias is None else int(logit_bias[0].shape[1])
        layout, total = self._decode_pack_layout(
            b, c_pad, k_steps, stop_cap, penalties is not None, bias_cap,
            chained, lora_lanes, guided_lanes is not None,
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
        if guided_lanes is not None:
            init_states, lane_map = guided_lanes
            put("g_state", lanes(init_states, 0, np.int32))
            put("g_lane", lanes(lane_map, 0, np.int32))
        return packed

    # stackcheck: hot-path — a dict probe a round; the upload happens only
    # when the set of live constraints changes
    def _decode_guided_tables(self, guided: tuple | None):
        """The DFA tables of a round's `guided` tuple (the engine's
        _device_guided_tables) on the device: token_class (M, V) int32,
        class_mask (S, C) bool, class_trans (S, C) int64. They stay
        resident and are uploaded again only when the cache token (the
        set of live constraints) changes."""
        if guided is None:
            return None
        g_token, _, _, token_class, class_mask, class_trans = guided
        if self._guided_dev is None or self._guided_dev[0] != g_token:
            self._guided_dev = (
                g_token, self._dev(token_class), self._dev(class_mask),
                self._dev(class_trans.astype(np.int64)),
            )
            self.guided_table_uploads += 1
        return self._guided_dev[1:]

    def _decode_round_core(self, b: int, c_pad: int, k_steps: int,
                           use_penalties: bool = False,
                           want_logprobs: bool = False,
                           bias_cap: int = 0,
                           stop_cap: int | None = None,
                           chained: bool = False, lora=None,
                           lora_lanes: bool = False, guided: bool = False):
        """The fused K-step decode round as four closures shared by
        decode_multi and the unified ragged round (whose step-0 decode
        forward is welded to the prefill rows): `unpack` (packed buffer ->
        consts, carry), `fwd_args` (one forward's tokens, positions, write
        slots, context lengths from the carry), `post` (sample and advance
        the stop/penalty state from one iteration's logits) and `run`
        (the loop).

        The carry is a DecodeCarry, all on the device. Under device stops
        (`stop_cap` not None) a lane is done once its append count
        reaches its budget or it samples its EOS / a stop id at or past
        its min_tokens gate; a done lane freezes: its sampled slot is
        pinned to STOP_PAD_TOKEN, its KV write goes to the trash slot 0,
        its position and context stop advancing, its penalty counts and
        DFA state stop updating. The loop reads nothing back: the host
        enqueues iterations up to the largest real lane's budget (`iters`,
        which it knows), and an iteration whose lanes are all done is an
        idle one: frozen lanes do not change. On the card a captured
        iteration tests `done` itself: its decode forward sits in a CUDA
        graph conditional node that runs it only while a lane is live
        (programs.GatedProgramVariant, csrc/graph_gate.cu), so once the
        data has stopped every lane the replays left skip their forward.
        Run eagerly (the CPU, the eager control) an idle iteration runs
        its forward. The round returns
        each lane's valid count last. Tokens below a lane's valid count
        equal the fixed-trip loop's.

        `guided`: the pack holds each lane's DFA state and machine row,
        and `unpack` takes the device tables (token_class, class_mask,
        class_trans). Each iteration masks the logits to the classes its
        state allows (after penalties and bias, before sampling: the
        host path's order) and steps the state by the sampled token's
        class; unguided lanes sit on an allow-everything state.

        `lora` is the decode lanes' _lora_key; `lora_lanes` says the pack
        holds their slot vector (a per-token round). The slots are
        constant across the K iterations.

        One iteration (`fwd` then `post`) is the program variant of
        (b, c_pad, the flags above, chained; guided: the DFA tables'
        shape): `run` copies the round's consts and carry into its
        static buffers once, then runs it once an iteration with that
        iteration's noise row copied into its noise slot; the new carry
        is written back into the static carry inside the program, and
        each iteration's samples are copied out of its outputs. Under
        `eager` the loop runs the same iteration on the round's own
        tensors.

        `run(consts, carry0, first=(carry1, ys0))` starts from iteration
        1 with iteration 0 already run (the ragged round's step-0
        program). `iters` caps the iterations run: under device stops the
        largest real lane's budget."""
        mc = self.local_config
        bs = self.block_size
        n_pages = c_pad // bs
        use_stop = stop_cap is not None
        layout, _ = self._decode_pack_layout(
            b, c_pad, k_steps, stop_cap, use_penalties, bias_cap, chained,
            lora_lanes, guided,
        )
        lane = torch.arange(b, device=self.device)

        # stackcheck: hot-path — the fused round's packed buffer -> consts and
        # carry, once a round
        def unpack(packed, chained_tokens=None, guided_tables=None):
            """Packed buffer -> (consts, carry0); a chained round's
            tokens are `chained_tokens`, (b,) int32 on the device;
            `guided_tables` the device DFA tables of a guided round."""
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
            g_state0 = None
            if guided:
                token_class, class_mask, class_trans = guided_tables
                # each lane's (V,) token -> class row, gathered once a
                # dispatch (int64: the loop's gathers index with it)
                consts.update(
                    lane_tc=token_class[seg("g_lane").long()].long(),
                    g_class_mask=class_mask, g_class_trans=class_trans,
                )
                g_state0 = seg("g_state").long()
            tokens = chained_tokens if chained else seg("tokens")
            carry0 = DecodeCarry(tokens, seg("positions"), seg("ctx"),
                                 counts0, done0, valid0, g_state0)
            return consts, carry0

        def fwd_args(carry, consts):
            """(tokens, positions, write_slots, ctx) of one decode forward,
            computed on the device: each lane's slot from its block table
            (idle lanes carry the zero table, so they write the trash
            block 0, and K <= block_size keeps them inside it)."""
            tokens, positions, ctx, done = (carry.tokens, carry.positions,
                                            carry.ctx, carry.done)
            # the table's own width (a captured step-0 program holds its
            # tables padded to the round's wider bucket)
            page = torch.clamp(positions // bs,
                               max=consts["page_tables"].shape[1] - 1).long()
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
            logits, _, _ = self._forward(
                mc, self.params, tokens, positions, self.k_cache,
                self.v_cache, write_slots, attn, logits_rows=lane,
                **self._lora_kw(lora, consts.get("lora_slots")),
            )
            return logits

        # stackcheck: hot-path — sample and advance the carry, once an
        # iteration
        def post(logits, carry, noise, consts):
            """Sample one iteration from its logits with its (b, cap)
            noise row and advance the stop, penalty and DFA state;
            returns (carry', ys)."""
            positions, ctx, counts, done, valid, g_state = (
                carry.positions, carry.ctx, carry.counts, carry.done,
                carry.valid, carry.g_state)
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
            if guided:
                # the classes each lane's state allows, spread to its
                # tokens: (b, C) -> (b, V)
                allowed = torch.gather(consts["g_class_mask"][g_state], 1,
                                       consts["lane_tc"])
                logits = torch.where(allowed, logits,
                                     torch.full_like(logits, float("-inf")))
            nxt = sample_tokens(
                logits, consts["temps"], consts["top_ps"],
                consts["top_ks"], noise, min_p=consts["min_ps"],
            )
            live = ~done
            if use_stop:
                nxt = torch.where(done, torch.full_like(nxt, STOP_PAD_TOKEN),
                                  nxt)
            if guided:
                cls = torch.gather(consts["lane_tc"], 1,
                                   nxt.long()[:, None])[:, 0]
                new_g = consts["g_class_trans"][g_state, cls]
                # a frozen lane's state stops stepping (the pad token is
                # not part of its stream)
                g_state = torch.where(done, g_state, new_g) if use_stop \
                    else new_g
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
            return DecodeCarry(nxt, positions + adv, ctx + adv, counts,
                               done, valid, g_state), ys

        def forward(carry, consts):
            """The iteration's decode forward, counted in loop_forwards."""
            logits = fwd(carry, consts)
            self.loop_forwards += 1
            return logits

        # stackcheck: hot-path — one fused-loop iteration (eager, or captured
        # once and replayed)
        def step(carry, consts, noise):
            """One iteration: the decode forward, then `post`. Captured
            under device stops, the forward runs only while a lane is
            live (a gated variant); a skipped one leaves zero logits,
            which `post` turns into the pad token of every frozen lane."""
            return post(forward(carry, consts), carry, noise, consts)

        base_key = ("decode_multi", b, c_pad, use_penalties, want_logprobs,
                    bias_cap, stop_cap, chained, self._program_lora(lora),
                    lora_lanes)

        # stackcheck: hot-path — the fused decode loop of every K-step round
        def run(consts, carry0, first=None, iters=None):
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
            if first is not None:
                carry, ys = first
                for buf, y in zip(bufs, ys):
                    buf[0] = y
                i = 1
            var = None
            # under device stops no lane appends past its budget, which
            # the host knows: the loop stops there
            k_run = k_steps if iters is None else min(k_steps, iters)
            if not self.eager and i < k_run:
                key = base_key + ((tuple(consts["g_class_mask"].shape),)
                                  if guided else (None,))
                var = self._iteration_program(
                    key, step, consts, carry,
                    gate=(forward, post) if use_stop else None)
                carry = var.inputs["carry"]
            while i < k_run:
                if var is None:
                    carry, ys = step(carry, consts, consts["noise"][i])
                else:
                    var.inputs["noise"].copy_(consts["noise"][i])
                    ys = var.run()
                for buf, y in zip(bufs, ys):
                    buf[i] = y
                i += 1
            self.dispatch_counts["decode_iterations"] += i
            if guided:
                self.guided_rounds += 1
            if use_stop:
                # a variant's carry is overwritten by its next round
                bufs.append(carry.valid if var is None
                            else carry.valid.clone())
            return bufs[0] if len(bufs) == 1 else tuple(bufs)

        return {"unpack": unpack, "fwd_args": fwd_args, "post": post,
                "run": run}

    @staticmethod
    # stackcheck: not-hot — the host's own budget array, no device value
    def _budget_iters(stop: tuple | None) -> int | None:
        """The most iterations a device-stop round can use: its real
        lanes' largest remaining budget (None without device stops)."""
        if stop is None or len(stop[2]) == 0:
            return None
        return max(1, int(np.max(stop[2])))

    def _iteration_program(self, key: tuple, step, consts: dict,
                           carry: DecodeCarry,
                           gate: tuple | None = None) -> ProgramVariant:
        """The fused loop's iteration variant of `key`, its static consts
        and carry loaded with this round's (the noise row is loaded per
        iteration). Its program runs `step` on the static buffers and
        writes the new carry back into them. `gate` = (forward, post),
        the two halves of `step`, makes it a gated variant: on the card
        the forward runs only while a lane of the carry is live."""

        def make():
            inputs = {
                "consts": {name: None if t is None else torch.empty_like(t)
                           for name, t in consts.items() if name != "noise"},
                "carry": DecodeCarry(*(None if t is None
                                       else torch.empty_like(t)
                                       for t in carry)),
                "noise": torch.empty_like(consts["noise"][0]),
            }

            def write_back(inp, new, ys):
                for dst, src in zip(inp["carry"], new):
                    if dst is not None:
                        dst.copy_(src)
                return ys

            # stackcheck: hot-path — the iteration program's body, run or
            # replayed once an iteration
            def fn(inp):
                return write_back(inp, *step(inp["carry"], inp["consts"],
                                             inp["noise"]))

            if gate is None:
                return fn, inputs
            forward, post = gate
            return (lambda inp: forward(inp["carry"], inp["consts"]),
                    lambda inp, logits: write_back(inp, *post(
                        logits, inp["carry"], inp["noise"], inp["consts"])),
                    lambda inp: inp["carry"].done), inputs

        var = self._program("decode_multi", key, make)
        for name, t in var.inputs["consts"].items():
            if t is not None:
                t.copy_(consts[name])
        for dst, src in zip(var.inputs["carry"], carry):
            if dst is not None:
                dst.copy_(src)
        return var

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
        guided: tuple | None = None,  # the engine's _device_guided_tables
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
        dispatch's layout; otherwise the buffer is built here.

        `guided`: (cache_token, init_states (b_actual,), lane_map
        (b_actual,), token_class (M, V), class_mask (S, C), class_trans
        (S, C)): TokenDFA tables evaluated inside the loop, so guided
        lanes keep the fused round; the three tables are uploaded once
        per cache_token (_decode_guided_tables). A guided round is never
        staged."""
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
        guided_lanes = None if guided is None else (guided[1], guided[2])
        packed_dev = None
        if (staged is not None and chained and guided is None
                and staged.key == (c_pad, lora)):
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
                lora_lanes=lora_lanes, guided_lanes=guided_lanes,
            ))
        core = self._decode_round_core(
            b, c_pad, steps, use_penalties=penalties is not None,
            want_logprobs=want_logprobs, bias_cap=bias_cap,
            stop_cap=stop_cap, chained=chained, lora=lora,
            lora_lanes=lora_lanes, guided=guided is not None,
        )
        consts, carry0 = core["unpack"](
            packed_dev, chained_tokens=token_ids if chained else None,
            guided_tables=self._decode_guided_tables(guided))
        ys = core["run"](consts, carry0, iters=self._budget_iters(stop))
        self.dispatch_counts["decode_multi"] += 1
        self.chained_rounds += chained
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
        mc = self.local_config
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

        # stackcheck: hot-path — the prefill lanes' sampling, once a prefill or
        # mixed round
        def sample(pf, logits):
            return sample_tokens(logits, pf["temps"], pf["top_ps"],
                                 pf["top_ks"], pf["noise"],
                                 min_p=pf["min_ps"])

        # stackcheck: hot-path — the ragged-rows prefill forward, once a
        # prefill dispatch
        def step(packed):
            pf = unpack(packed)
            seg_meta = self._rows_pf_seg_meta(
                r_pad, pf["lane_row0"], pf["lane_rows"], pf["q_starts"])
            blk_seg = torch.arange(r_pad // RAGGED_TQ + 1,
                                   dtype=torch.int32, device=packed.device)

            def attn(q, l, kc, vc):
                return self._attn("ragged", q, l, kc, vc, pf["tables"],
                                  blk_seg, seg_meta)

            logits, _, _ = self._forward(
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
        guided: bool = False,
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
                                          lora_rows, guided)
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
        guided_lanes=None,
    ) -> tuple[int, int, np.ndarray]:
        """Lane-type header + ragged-rows prefill pack + decode pack, one
        int32 buffer (dispatch and staging). Returns (r_pad, pc_pad,
        packed). The decode pack carries the guided lanes' initial DFA
        states: the round's step 0 samples from the mixed forward's
        logits, so the states ride this buffer."""
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
            guided_lanes=guided_lanes,
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
                           chained: bool = False, lora=None,
                           guided: bool = False):
        """The unified round as `step(packed, chained_tokens=None,
        guided_tables=None)` ->
        (pf_sampled (s_cap,)
        int32, RAGGED_IDLE_TOKEN on non-prefill lanes; pf_logits (s_cap,
        vocab); decode ys as decode_multi returns them). The prefill
        lanes' rows and the decode lanes' step-0 rows share one row space
        and one forward, whose attention is one ragged kernel launch a
        layer; decode iterations 1..K-1 continue on the decode core.

        `lora` is the round's _lora_key over (prefill lanes, decode
        lanes): the step-0 forward takes it whole (per-token: the prefill
        rows' slots then the decode lanes'), the decode loop the decode
        lanes' share of it.

        Step 0 (from the unpacked fields to pf_sampled, the step-0
        logits and iteration 0's post half) is the program variant of
        ("ragged_rows", r_pad, the page count of the wider of the two
        context buckets, the flags): its static tables are that wide, so
        the tables the kernel sees equal the eager ones, and one variant
        serves every prefill and decode bucket pair under it and every K
        (the noise row of iteration 0 is its input). The packed buffer is
        unpacked outside it into views, which load its static buffers."""
        mc = self.local_config
        s_cap = self._rows_lane_cap()
        b_pad = _ceil_tq(b)
        per_tok = isinstance(lora, tuple)
        use_stop = stop_cap is not None
        pf_step = self._make_prefill_rows_step(r_pad, pc_pad, lora)
        core = self._decode_round_core(
            b, c_pad, k_steps, use_penalties=use_penalties,
            want_logprobs=want_logprobs, bias_cap=bias_cap,
            stop_cap=stop_cap, chained=chained,
            lora=self._lora_key(lora[1]) if per_tok else lora,
            lora_lanes=per_tok, guided=guided,
        )
        meta_n, pf_n, _ = self._ragged_rows_pack_sizes(
            r_pad, pc_pad, b, c_pad, k_steps, stop_cap, use_penalties,
            bias_cap, chained, per_tok, guided,
        )
        n_pages = max(pc_pad, c_pad) // self.block_size
        carry_names = [n for n in DecodeCarry._fields]

        # stackcheck: hot-path — the unified round's step 0 (run eagerly or
        # captured once a key and replayed)
        def step0(inp):
            lane_types = inp["lane_types"]
            pf = {name[3:]: t for name, t in inp.items()
                  if name.startswith("pf_")}
            consts = {name[2:]: t for name, t in inp.items()
                      if name.startswith("c_")}
            carry0 = DecodeCarry(*(inp["k_" + n] for n in carry_names))
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

            logits, _, _ = self._forward(
                mc, self.params, torch.cat([pf["tokens"], d_tokens]),
                torch.cat([pf["positions"], d_positions]), self.k_cache,
                self.v_cache, torch.cat([pf["write_slots"], d_ws]), attn,
                logits_rows=torch.cat([
                    pf["last_rows"],
                    r_pad + torch.arange(b, dtype=torch.int32,
                                         device=lane_types.device),
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
            carry1, ys0 = core["post"](logits[s_cap:], carry0,
                                       inp["noise0"], consts)
            if use_stop:
                ys0 = (*ys0, carry1.done.all())
            return (pf_sampled, pf_logits, *carry1, *ys0)

        key = ("ragged_rows", r_pad, n_pages, b, use_penalties,
               want_logprobs, bias_cap, stop_cap, self._program_lora(lora),
               per_tok)

        # stackcheck: hot-path — the unified ragged round, once a mixed round
        def step(packed, chained_tokens=None, guided_tables=None,
                 iters=None):
            pf = pf_step.unpack(packed[meta_n:meta_n + pf_n])
            consts, carry0 = core["unpack"](packed[meta_n + pf_n:],
                                            chained_tokens=chained_tokens,
                                            guided_tables=guided_tables)
            inputs = {"lane_types": packed[:s_cap],
                      "noise0": consts["noise"][0]}
            inputs.update(("pf_" + n, t) for n, t in pf.items())
            inputs.update(("c_" + n, t) for n, t in consts.items()
                          if n != "noise")
            inputs.update(("k_" + n, t) for n, t in zip(carry_names,
                                                        carry0))
            wide = {"pf_tables": (s_cap, n_pages),
                    "c_page_tables": (b, n_pages)}
            gkey = ((tuple(consts["g_class_mask"].shape),) if guided
                    else (None,))
            out = self._dispatch_program("ragged_rows", key + gkey, step0,
                                         inputs, wide=wide)
            pf_sampled, pf_logits = out[:2]
            n_carry = len(carry_names)
            carry1 = DecodeCarry(*out[2:2 + n_carry])
            ys0 = tuple(out[2 + n_carry:])
            ys = core["run"](consts, carry0, first=(carry1, ys0),
                             iters=iters)
            return pf_sampled, pf_logits, ys

        return step

    # -- composed ragged rounds --------------------------------------------------
    # Without the ragged kernel (--no-ragged-kernel, or the xla impl) a
    # lane-typed round is one packed buffer [lane types | packed prefill
    # pack | decode pack] and two forwards on it: the packed prefill step
    # over the prefill lanes (one prefill call a lane a layer), then the
    # fused decode loop over the decode lanes (one decode call a layer an
    # iteration). The lane sets hold disjoint block tables, so the order
    # changes no value.
    def _ragged_pack_sizes(
        self, s_pad: int, t_pad: int, pc_pad: int, b: int, c_pad: int,
        k_steps: int, stop_cap: int | None = None,
        use_penalties: bool = False, bias_cap: int = 0,
        chained: bool = False, pf_lora_rows: bool = False,
        lora_lanes: bool = False, guided: bool = False,
    ) -> tuple[int, int, int]:
        """(meta, prefill, decode) segment lengths of a composed round's
        packed buffer: the lane types (s_pad prefill lanes + b decode
        lanes), the (s_pad, t_pad) packed prefill pack, the decode pack.
        A staged buffer whose total differs from the dispatch's is
        stale."""
        _, pf = self._packed_prefill_pack_layout(s_pad, t_pad, pc_pad,
                                                 pf_lora_rows)
        _, dec = self._decode_pack_layout(b, c_pad, k_steps, stop_cap,
                                          use_penalties, bias_cap, chained,
                                          lora_lanes, guided)
        return s_pad + b, pf, dec

    def _ragged_dims(self, pf_chunks, pf_total_lens) -> tuple[int, int, int]:
        """(s_pad, t_pad, pc_pad) of a composed round's prefill lanes."""
        return (next_pow2(max(len(pf_chunks), 1)),
                self._prefill_bucket(max(len(c) for c in pf_chunks)),
                max(self._ctx_bucket(tl) for tl in pf_total_lens))

    # stackcheck: hot-path — host build of the composed round's one h2d
    # buffer; one pass over the lanes, no device work
    def _fill_ragged_pack(
        self,
        pf_chunks, pf_start_positions, pf_block_tables, pf_total_lens,
        pf_sampling, c_pad, token_ids, positions, block_tables,
        context_lens, steps, temps, top_ps, top_ks, keys, min_ps=None,
        stop=None, penalties=None, logit_bias=None, chained=False,
        pf_lora_slots=None, lora_slots=None, guided_lanes=None,
    ) -> tuple[int, int, int, np.ndarray]:
        """Lane types + packed prefill pack + decode pack, one int32
        buffer (dispatch and staging). Returns (s_pad, t_pad, pc_pad,
        packed). Each half carries its own lanes' adapter slots (the two
        forwards take their own _lora_key)."""
        b = self.config.max_num_seqs
        s_pad, t_pad, pc_pad, pf_packed = self._fill_packed_prefill_pack(
            pf_chunks, pf_start_positions, pf_block_tables, pf_total_lens,
            sampling=pf_sampling, lora_slots=pf_lora_slots,
        )
        dec_packed = self._fill_decode_pack(
            c_pad, steps, token_ids, positions, block_tables, context_lens,
            temps, top_ps, top_ks, keys, min_ps=min_ps, stop=stop,
            penalties=penalties, logit_bias=logit_bias, chained=chained,
            lora_slots=lora_slots,
            lora_lanes=isinstance(self._lora_key(lora_slots), tuple),
            guided_lanes=guided_lanes,
        )
        types = np.full((s_pad + b,), RAGGED_LANE_IDLE, np.int32)
        types[:len(pf_chunks)] = RAGGED_LANE_PREFILL
        types[s_pad:s_pad + len(positions)] = RAGGED_LANE_DECODE
        packed = np.concatenate([types, pf_packed, dec_packed])
        return s_pad, t_pad, pc_pad, packed

    def _build_ragged(self, s_pad: int, t_pad: int, pc_pad: int, b: int,
                      c_pad: int, k_steps: int, use_penalties: bool = False,
                      want_logprobs: bool = False, bias_cap: int = 0,
                      stop_cap: int | None = None, chained: bool = False,
                      pf_lora=None, lora=None, guided: bool = False):
        """The composed round as `step(packed, chained_tokens=None,
        guided_tables=None)` -> (pf_sampled (s_pad,) int32,
        RAGGED_IDLE_TOKEN on non-prefill lanes; pf_logits (s_pad, vocab);
        decode ys as decode_multi returns them). The prefill half (the
        packed prefill step, its lanes' starts read from the pack on the
        device) is the program variant of ("ragged", s_pad, t_pad,
        pc_pad, its adapter key); the decode loop replays the iteration
        variants. `pf_lora` / `lora`: the prefill and the decode lanes'
        _lora_key."""
        pf_step = self._packed_prefill_step(s_pad, t_pad, pf_lora)
        pf_layout, _ = self._packed_prefill_pack_layout(
            s_pad, t_pad, pc_pad, isinstance(pf_lora, tuple))
        lora_lanes = isinstance(lora, tuple)
        core = self._decode_round_core(
            b, c_pad, k_steps, use_penalties=use_penalties,
            want_logprobs=want_logprobs, bias_cap=bias_cap,
            stop_cap=stop_cap, chained=chained, lora=lora,
            lora_lanes=lora_lanes, guided=guided,
        )
        meta_n, pf_n, _ = self._ragged_pack_sizes(
            s_pad, t_pad, pc_pad, b, c_pad, k_steps, stop_cap,
            use_penalties, bias_cap, chained, isinstance(pf_lora, tuple),
            lora_lanes, guided,
        )

        # stackcheck: hot-path — the composed round's prefill half (run eagerly
        # or captured once a key and replayed)
        def pf_fn(inp):
            pf_sampled, pf_logits = pf_step(
                self._unpack_fields(inp["packed"], pf_layout))
            pf_sampled = torch.where(
                inp["lane_types"] == RAGGED_LANE_PREFILL, pf_sampled,
                torch.full_like(pf_sampled, RAGGED_IDLE_TOKEN),
            )
            return pf_sampled, pf_logits

        key = ("ragged", s_pad, t_pad, pc_pad, self._program_lora(pf_lora))

        # stackcheck: hot-path — the composed ragged round, once a mixed round
        def step(packed, chained_tokens=None, guided_tables=None,
                 iters=None):
            # prefill lanes first: their chunks' K/V lands before the
            # decode loop runs, the split rounds' order
            self.dispatch_counts["prefill_lanes"] += s_pad
            pf_sampled, pf_logits = self._dispatch_program(
                "ragged", key, pf_fn,
                {"packed": packed[meta_n:meta_n + pf_n],
                 "lane_types": packed[:s_pad]})
            consts, carry0 = core["unpack"](packed[meta_n + pf_n:],
                                            chained_tokens=chained_tokens,
                                            guided_tables=guided_tables)
            ys = core["run"](consts, carry0, iters=iters)
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
        args = (pf_chunks, pf_start_positions, pf_block_tables,
                pf_total_lens, pf_sampling, c_pad, None, positions,
                block_tables, context_lens, steps, temps, top_ps, top_ks,
                keys)
        kw = dict(min_ps=min_ps, stop=stop, chained=True,
                  pf_lora_slots=pf_lora_slots, lora_slots=lora_slots)
        if self.ragged_kernel:
            *dims, packed = self._fill_ragged_rows_pack(
                *args, lora_rows=isinstance(lora, tuple), **kw)
            key = ("rows", *dims, c_pad, lora)
        else:
            *dims, packed = self._fill_ragged_pack(*args, **kw)
            key = ("ragged", *dims, c_pad, lora)
        t1 = time.perf_counter()
        self._phase_add("prep", t1 - t0)
        handle = self._stage(key, packed)
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
        guided: tuple | None = None,
    ) -> tuple:
        """One lane-typed round: prefill chunk lanes + fused decode lanes,
        on the ragged kernel (_build_ragged_rows) or composed
        (_build_ragged: without the ragged kernel, or under xla).
        Returns (pf_sampled (s,) int32 on the device, RAGGED_IDLE_TOKEN on
        non-prefill lanes; pf_logits (s, vocab); dec_ys) where dec_ys has
        decode_multi's return shape for the same flags (s: the lane cap
        on the ragged kernel, the padded lane count composed).
        `token_ids` may be a device tensor (chained decode half, see
        decode_multi); `staged` = a stage_ragged handle, used only when
        its bucket key AND total length match this dispatch (a lane-mix
        or stop-cap change since the stage rebuilds here: a counted miss
        for the engine, never an error). `pf_lora_slots` / `lora_slots`:
        the prefill and decode lanes' adapter slots (None = all base).
        `guided`: the decode lanes' DFA tables, as decode_multi takes
        them (a guided round is never staged)."""
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
        lora = self._lora_key(pf_lora_slots, lora_slots)
        per_tok = isinstance(lora, tuple)
        pf_lora = self._lora_key(pf_lora_slots)
        dec_lora = self._lora_key(lora_slots)
        guided_lanes = None if guided is None else (guided[1], guided[2])
        if self.ragged_kernel:
            dims = self._rows_dims(pf_chunks, pf_total_lens)
            key = ("rows", *dims, c_pad, lora)
        else:
            dims = self._ragged_dims(pf_chunks, pf_total_lens)
            key = ("ragged", *dims, c_pad, lora)
        packed_dev = None
        if (staged is not None and chained and guided is None
                and staged.key == key):
            if self.ragged_kernel:
                sizes = self._ragged_rows_pack_sizes(
                    *dims, b, c_pad, steps, stop_cap, penalties is not None,
                    bias_cap, chained, per_tok)
            else:
                sizes = self._ragged_pack_sizes(
                    *dims, b, c_pad, steps, stop_cap, penalties is not None,
                    bias_cap, chained, isinstance(pf_lora, tuple),
                    isinstance(dec_lora, tuple))
            if staged.dev.shape[0] == sum(sizes):
                packed_dev = self._take(staged)
        if packed_dev is None:
            t0 = time.perf_counter()
            args = (pf_chunks, pf_start_positions, pf_block_tables,
                    pf_total_lens, pf_sampling, c_pad, token_ids, positions,
                    block_tables, context_lens, steps, temps, top_ps, top_ks,
                    keys)
            kw = dict(min_ps=min_ps, stop=stop, penalties=penalties,
                      logit_bias=logit_bias, chained=chained,
                      pf_lora_slots=pf_lora_slots, lora_slots=lora_slots,
                      guided_lanes=guided_lanes)
            if self.ragged_kernel:
                packed = self._fill_ragged_rows_pack(
                    *args, lora_rows=per_tok, **kw)[-1]
            else:
                packed = self._fill_ragged_pack(*args, **kw)[-1]
            t1 = time.perf_counter()
            self._phase_add("prep", t1 - t0)
            packed_dev = self._upload(packed)
            self._phase_add("h2d", time.perf_counter() - t1)
        t2 = time.perf_counter()
        flags = dict(use_penalties=penalties is not None,
                     want_logprobs=want_logprobs, bias_cap=bias_cap,
                     stop_cap=stop_cap, chained=chained,
                     guided=guided is not None)
        run_kw = dict(iters=self._budget_iters(stop),
                      chained_tokens=token_ids if chained else None,
                      guided_tables=self._decode_guided_tables(guided))
        if self.ragged_kernel:
            out = self._build_ragged_rows(
                *dims, b, c_pad, steps, lora=lora, **flags,
            )(packed_dev, **run_kw)
        else:
            out = self._build_ragged(
                *dims, b, c_pad, steps, pf_lora=pf_lora, lora=dec_lora,
                **flags,
            )(packed_dev, **run_kw)
        self.dispatch_counts["ragged"] += 1
        self._phase_add("dispatch", time.perf_counter() - t2)
        return out

    # -- precompile: the JAX runner's warm-up sweeps ---------------------------
    # Each sweep runs trash dispatches whose block tables point at the TOP
    # of the pool (the allocator hands out low ids first) and skips, with
    # a warning, an entry whose claim is not below half the pool plus 64
    # blocks of slack. Every dispatch builds (or replays) the variants it
    # reaches and warms the eager programs it runs: the allocator's
    # blocks, cuBLAS heuristics, the kernel library. Each returns the
    # dispatches it ran, as the JAX runner's do.
    def precompile_prefill(
        self,
        singles: list[tuple[int, int]] = (),
        groups: list[tuple[int, int, int]] = (),
    ) -> int:
        """`singles`: (chunk_len, total_len) pairs of the single-sequence
        path; `groups`: (group_size, chunk_len, total_len) of the packed
        path."""
        bs = self.block_size
        nb = self.num_blocks
        n = 0
        for chunk_len, total in singles:
            bp = (total + bs - 1) // bs
            if nb < 2 * bp + 64:
                logger.warning(
                    "prefill precompile: skipping single (%d, %d) — pool "
                    "of %d blocks too small", chunk_len, total, nb,
                )
                continue
            self.prefill([1] * chunk_len, total - chunk_len,
                         list(range(nb - bp, nb)), total)
            n += 1
        for s, chunk_len, total in groups:
            bp = (total + bs - 1) // bs
            if nb < 2 * s * bp + 64:
                logger.warning(
                    "prefill precompile: skipping group (%d, %d, %d) — "
                    "pool of %d blocks too small", s, chunk_len, total, nb,
                )
                continue
            tabs = [list(range(nb - (i + 1) * bp, nb - i * bp))
                    for i in range(s)]
            self.prefill_batch(
                [[1] * chunk_len] * s, start_positions=[total - chunk_len] * s,
                block_tables=tabs, total_lens=[total] * s,
            )
            n += 1
        return n

    def precompile_decode(self, context_lens: list[int], steps: int,
                          chained: bool = False, stop: bool = False) -> int:
        """The decode variant of every ctx bucket the context lengths
        reach: the fused loop's iteration at `steps` > 1 (with
        `chained`, the chained round's too; with `stop`, the device-stop
        loop at stop-id cap 0, budgets of `steps` so nothing freezes),
        the single-step decode at 1. Every lane shares one trash table."""
        b = self.config.max_num_seqs
        bs = self.block_size
        nb = self.num_blocks
        temps = np.zeros((b,), np.float32)
        top_ps = np.ones((b,), np.float32)
        top_ks = np.full((b,), -1, np.int32)
        keys = np.zeros((b, 2), np.uint32)
        seen: set[int] = set()
        n = 0
        for cl in context_lens:
            c_pad = self._ctx_bucket(cl + max(0, steps - 1))
            if c_pad in seen:
                continue
            seen.add(c_pad)
            npages = c_pad // bs
            if nb < 2 * npages + 64:
                logger.warning(
                    "decode precompile: skipping ctx %d — pool of %d "
                    "blocks too small", cl, nb,
                )
                continue
            table = list(range(nb - npages, nb))
            ctx = c_pad - max(0, steps - 1)
            if steps > 1:
                stop_kw = {}
                if stop:
                    stop_kw = {"stop": (
                        np.full((b,), -1, np.int32), np.zeros((b,), np.int32),
                        np.full((b,), steps, np.int32), None,
                    )}
                out = self.decode_multi(
                    [1] * b, [ctx - 1] * b, [table] * b, [ctx] * b, steps,
                    temps, top_ps, top_ks, keys, **stop_kw,
                )
                toks = out[0] if isinstance(out, tuple) else out
                n += 1
                if chained:
                    self.decode_multi(
                        toks[-1], [ctx - 1] * b, [table] * b, [ctx] * b,
                        steps, temps, top_ps, top_ks, keys, **stop_kw,
                    )
                    n += 1
            else:
                self.decode([1] * b, [ctx - 1] * b, [table] * b, [ctx] * b)
                n += 1
        return n

    def precompile_verify(self, context_lens: list[int], draft_len: int,
                          max_lanes: int) -> int:
        """The packed verify dispatch of every pow2 lane count up to
        max_lanes x the draft chunk's bucket x each ctx bucket (eager: it
        warms, it builds nothing)."""
        bs = self.block_size
        nb = self.num_blocks
        lanes: list[int] = []
        s = 1
        while s <= max_lanes:
            lanes.append(s)
            s *= 2
        seen: set[tuple] = set()
        n = 0
        for cl in context_lens:
            c_pad = self._ctx_bucket(cl)
            npages = c_pad // bs
            for s in lanes:
                key = (s, self._prefill_bucket(draft_len), c_pad)
                if key in seen:
                    continue
                seen.add(key)
                if nb < 2 * s * npages + 64:
                    logger.warning(
                        "verify precompile: skipping s=%d ctx=%d — pool "
                        "of %d blocks too small", s, c_pad, nb,
                    )
                    continue
                tabs = [list(range(nb - (i + 1) * npages, nb - i * npages))
                        for i in range(s)]
                row_sampling = (
                    np.zeros((s,), np.float32), np.ones((s,), np.float32),
                    np.full((s,), -1, np.int32), np.zeros((s,), np.float32),
                    np.zeros((s,), np.uint32), np.zeros((s,), np.int64),
                )
                self.verify_batch([[1] * draft_len] * s,
                                  [c_pad - draft_len] * s, tabs,
                                  [c_pad] * s, row_sampling)
                n += 1
        return n

    def precompile_ragged(
        self, context_lens: list[int], ks: list[int], max_groups: int,
        chunk_len: int, stop: bool = False, chained: bool = False,
    ) -> int:
        """The ragged round of every pow2 prefill-lane group up to
        max_groups x each fused-K bucket x each ctx bucket, the prefill
        lanes' context matched to the decode bucket. The JAX runner's
        program keys decide what repeats: under the ragged kernel the
        padded row bucket, so group sizes that pack to the same rows run
        once. `chained` runs the staged round's chained dispatch too.
        Their step-0 forwards run eagerly; their iterations build the
        iteration variants."""
        b = self.config.max_num_seqs
        bs = self.block_size
        nb = self.num_blocks
        temps = np.zeros((b,), np.float32)
        top_ps = np.ones((b,), np.float32)
        top_ks = np.full((b,), -1, np.int32)
        keys = np.zeros((b, 2), np.uint32)
        groups: list[int] = []
        s = 1
        while s <= max(1, max_groups):
            groups.append(s)
            s *= 2
        seen: set[tuple] = set()
        n = 0
        for cl in context_lens:
            for k in ks:
                c_pad = self._ctx_bucket(cl + max(0, k - 1))
                ctx = c_pad - max(0, k - 1)
                clen = min(chunk_len, c_pad)
                for s in groups:
                    if self.ragged_kernel:
                        key = (self._rows_bucket(s * _ceil_tq(clen)),
                               c_pad, k)
                    else:
                        key = (s, self._prefill_bucket(clen), c_pad, k)
                    if key in seen:
                        continue
                    seen.add(key)
                    npages = c_pad // bs
                    if nb < 2 * (s + 1) * npages + 64:
                        logger.warning(
                            "ragged precompile: skipping s=%d ctx=%d "
                            "k=%d — pool of %d blocks too small",
                            s, c_pad, k, nb,
                        )
                        continue
                    # decode lanes share the topmost trash table; prefill
                    # lanes stack below it, all above live KV
                    dec_table = list(range(nb - npages, nb))
                    pf_tabs = [list(range(nb - (i + 2) * npages,
                                          nb - (i + 1) * npages))
                               for i in range(s)]
                    stop_kw = {}
                    if stop:
                        stop_kw = {"stop": (
                            np.full((b,), -1, np.int32),
                            np.zeros((b,), np.int32),
                            np.full((b,), k, np.int32), None,
                        )}
                    pf_args = ([[1] * clen] * s, [c_pad - clen] * s,
                               pf_tabs, [c_pad] * s)
                    out = self.ragged_dispatch(
                        *pf_args, [1] * b, [ctx - 1] * b, [dec_table] * b,
                        [ctx] * b, k, temps, top_ps, top_ks, keys,
                        **stop_kw,
                    )
                    n += 1
                    if chained and k > 1:
                        ys = out[2]
                        toks = ys[0] if isinstance(ys, tuple) else ys
                        self.ragged_dispatch(
                            *pf_args, toks[-1], [ctx - 1] * b,
                            [dec_table] * b, [ctx] * b, k, temps, top_ps,
                            top_ks, keys, **stop_kw,
                        )
                        n += 1
        return n

    def _built(self, *prefix) -> bool:
        """Whether a variant whose key starts with `prefix` exists."""
        n = len(prefix)
        return any(k[:n] == prefix for k in self._variants)

    def precompile_cover(self, context_lens: list[int], chunk_len: int,
                         max_seqs: int, stop: bool = False,
                         ragged: bool = True) -> int:
        """Build what the JAX runner's sweeps leave to the first live
        dispatch: every prefill, packed-prefill and (with `ragged`)
        ragged step-0 variant a serving config reaches over the context
        buckets of `context_lens`, at chunks up to `chunk_len` and up to
        `max_seqs` lanes, not yet built. The JAX sweeps match the
        prefill lanes' context to the decode bucket, run one chunk
        bucket a context under the ragged round and skip entries the
        pool guard refuses; here every lane of a dispatch shares the one
        trash table at the top of the pool (so a bucket needs its pages
        plus 64 blocks of slack), and the ragged step-0 key (row bucket,
        page count of the wider context bucket) serves every prefill and
        decode bucket pair under it. Returns the dispatches run (none
        under `eager`: nothing is built there)."""
        if self.eager:
            return 0
        b = self.config.max_num_seqs
        bs = self.block_size
        nb = self.num_blocks
        zeros = (np.zeros((b,), np.float32), np.ones((b,), np.float32),
                 np.full((b,), -1, np.int32), np.zeros((b, 2), np.uint32))
        stop_kw = {}
        if stop:
            stop_kw = {"stop": (np.full((b,), -1, np.int32),
                                np.zeros((b,), np.int32),
                                np.ones((b,), np.int32), None)}
        tbs = []
        t = self._prefill_bucket(1)
        while True:
            tbs.append(t)
            if t >= self._prefill_bucket(chunk_len):
                break
            t = self._prefill_bucket(t + 1)
        seen: set[int] = set()
        n = 0
        for cl in context_lens:
            c = self._ctx_bucket(cl)
            if c in seen:
                continue
            seen.add(c)
            npages = c // bs
            if nb < npages + 64:
                logger.warning("cover precompile: skipping ctx %d — pool "
                               "of %d blocks too small", c, nb)
                continue
            table = list(range(nb - npages, nb))
            per = min(chunk_len, c)

            def lanes(lens):
                return ([[1] * x for x in lens], [c - x for x in lens],
                        [table] * len(lens), [c] * len(lens))

            # single prefill: every chunk bucket a chunk of this context
            # reaches
            for t in tbs:
                x = min(t, per)
                if (self._prefill_bucket(x) != t
                        or self._built("prefill", t, c, False, None)):
                    continue
                self.prefill(*(a[0] for a in lanes([x])))
                n += 1
            # lane mixes: (lanes, chunk) pairs a packed dispatch reaches
            mixes = []
            if self.ragged_kernel:
                q = _ceil_tq(per)
                r = RAGGED_TQ
                while r <= self._rows_bucket(max_seqs * q):
                    full, rem = divmod(r, q)
                    lens = [per] * full + ([rem] if rem else [])
                    if len(lens) <= max_seqs:
                        mixes.append(("rows", r, lens))
                    r *= 2
            else:
                sp = 1
                while sp <= next_pow2(max(1, max_seqs)):
                    for t in tbs:
                        x = min(t, per)
                        if self._prefill_bucket(x) == t:
                            mixes.append(
                                ("packed", (sp, t),
                                 [x] * min(sp, max(1, max_seqs))))
                    sp *= 2
            for kind, dims, lens in mixes:
                if len(lens) >= 2 and not self._built(*(
                        ("prefill_rows", dims, c) if kind == "rows" else
                        ("prefill_batch", *dims, c))):
                    self.prefill_batch(*lanes(lens))
                    n += 1
                if ragged and not (
                        self._built("ragged_rows", dims, npages)
                        if kind == "rows" else
                        self._built("ragged", *dims, c)):
                    self.ragged_dispatch(
                        *lanes(lens), [1] * b, [c - 1] * b, [table] * b,
                        [c] * b, 1, *zeros, **stop_kw)
                    n += 1
        return n

    def precompile_kv_import(self, max_blocks: int) -> int:
        """The KV import of every pow2 block count up to max_blocks (the
        JAX runner's (n, n) diagonal), zeros written into the null block
        0 (trash by design). Eager: it warms the copy path."""
        mc = self.model_config
        n = 0
        p = 1
        while p <= next_pow2(max(1, max_blocks)):
            data = torch.zeros(
                (2, mc.num_layers, p, mc.num_kv_heads, self.block_size,
                 mc.head_dim), dtype=self.cache_dtype)
            self.import_staged_blocks([0] * p, self.stage_import_blocks(data),
                                      list(range(p)))
            n += 1
            p *= 2
        return n


    # -- embeddings (stateless, /v1/embeddings) ------------------------------
    @torch.inference_mode()
    def embed(self, token_ids: list[int], lora_slot: int = 0) -> np.ndarray:
        """Mean-pooled, L2-normalised final hidden state -> (hidden,) f32
        (a decoder as embedder, the e5-mistral pattern). The input runs
        in chunks of max_prefill_chunk through llama.forward over a
        scratch cache, (L, nkv, c_pad + 1, d), zeroed for this call:
        cache row == absolute position, and padded chunk rows carry
        position c_pad, landing in the extra trash row and masked out of
        attention and pooling. Attention is the plain chunk x context one
        (ops/attention.py), as the JAX package computes it in XLA. Each
        chunk is the program variant of ("embed", t_pad, c_pad, its
        adapter key): its tokens, positions, the context length so far
        and the input's length are its inputs, the scratch of its c_pad
        (`_embed_cache`) its static buffer, and the chunk's pooled sum
        (hidden,) f32 its output, fetched per chunk. Its attention scores
        rows in pieces of EMBED_SCORE_BYTES.
        Under `eager` the scratch is allocated for the call. Inputs above
        max_model_len are refused, never truncated."""
        t = len(token_ids)
        if t > self.max_model_len:
            raise ValueError(
                f"embedding input has {t} tokens, exceeds max_model_len="
                f"{self.max_model_len}"
            )
        mc = self.local_config
        c_pad = self._ctx_bucket(t)
        chunk = self.config.max_prefill_chunk
        scratch = self._embed_cache(c_pad)
        lora = self._lora_key([lora_slot])
        pooled_sum = np.zeros((mc.hidden_size,), np.float64)
        for start in range(0, t, chunk):
            ids = token_ids[start: start + chunk]
            t_pad = self._prefill_bucket(len(ids))
            toks = np.zeros((t_pad,), np.int32)
            toks[: len(ids)] = ids
            positions = np.full((t_pad,), c_pad, np.int32)
            positions[: len(ids)] = np.arange(start, start + len(ids))
            inputs = {"tokens": self._dev(toks),
                      "positions": self._dev(positions),
                      "lens": self._dev(np.asarray(
                          [start + len(ids), t], np.int32))}
            (part,) = self._dispatch_program(
                "embed", ("embed", t_pad, c_pad, self._program_lora(lora)),
                self._embed_step(t_pad, lora), inputs,
                static={"kc": scratch[0], "vc": scratch[1]})
            pooled_sum += part.double().cpu().numpy()
        pooled = pooled_sum / max(t, 1)
        norm = float(np.linalg.norm(pooled))
        return (pooled / max(norm, 1e-12)).astype(np.float32)

    def _embed_cache(self, c_pad: int) -> tuple:
        """The zeroed (L, nkv, c_pad + 1, d) scratch caches of an embed
        call: the leading part of one pair of flat buffers kept at the
        largest bucket reached (the runner holds one input's scratch,
        as an eager call's allocation would). A larger bucket replaces
        the pair and drops the embed variants captured over the old one.
        Under `eager`, allocated for the call."""
        mc = self.local_config
        shape = (mc.num_layers, mc.num_kv_heads, c_pad + 1, mc.head_dim)
        if self.eager:
            kc = torch.zeros(shape, dtype=self.cache_dtype,
                             device=self.device)
            return kc, torch.zeros_like(kc)
        n = math.prod(shape)
        if self._embed_scratch is None or self._embed_scratch[0].numel() < n:
            for key in [k for k, v in self._variants.items()
                        if v.kind == "embed"]:
                self._dropped_pool_bytes += self._variants.pop(key).pool_bytes
            self._embed_scratch = None
            self._embed_scratch = tuple(
                torch.empty((n,), dtype=self.cache_dtype, device=self.device)
                for _ in range(2))
        views = tuple(f[:n].view(shape) for f in self._embed_scratch)
        for v in views:
            v.zero_()
        return views

    def _embed_step(self, t_pad: int, lora=None):
        """`fn(inputs)` -> (the chunk's pooled sum (hidden,) f32,): one
        embed chunk over the scratch inputs["kc"] / ["vc"]; inputs["lens"]
        = [context length with this chunk, the input's length] on the
        device."""
        mc = self.local_config
        lora_kw = self._lora_kw(lora)

        # stackcheck: hot-path — one embed chunk (eager, or captured once a
        # key and replayed)
        def fn(inp):
            pos_d, lens = inp["positions"], inp["lens"]
            c = inp["kc"].shape[2]
            rows = max(1, EMBED_SCORE_BYTES // (4 * mc.num_heads * c))

            def attn(q, l, kcache, vcache):
                k, v = kcache[l].transpose(0, 1), vcache[l].transpose(0, 1)
                return torch.cat([context_attention_prefill(
                    q[r:r + rows], k, v, pos_d[r:r + rows], lens[0],
                    self._scale, window=mc.sliding_window,
                ) for r in range(0, t_pad, rows)])

            h, _, _ = self._forward(
                mc, self.params, inp["tokens"], pos_d, inp["kc"],
                inp["vc"], pos_d, attn,
                logits_rows=torch.arange(t_pad, device=pos_d.device),
                return_hidden=True, **lora_kw,
            )  # (t_pad, hidden) f32
            keep = (pos_d < lens[1])[:, None].float()
            return ((h * keep).sum(0),)

        return fn

    # -- cache import/export (KV offload + PD transfer tiers) -------------
    def on_compute_stream(self):
        """Context that makes the runner's compute stream current (the
        engine steps inside it); nothing on the CPU."""
        if self.compute_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.compute_stream)

    def _index_to_device(self, idx: torch.Tensor) -> torch.Tensor:
        """A host index tensor on the device, enqueued: from pinned memory
        the copy does not wait for the stream's earlier work, from
        pageable memory it would."""
        if self.device.type == "cuda":
            idx = idx.pin_memory()
        return idx.to(self.device, non_blocking=True)

    def _block_slots(self, block_ids: list[int]) -> torch.Tensor:
        return self._index_to_device(block_table_slots(
            torch.as_tensor(block_ids, dtype=torch.long), self.block_size))

    # stackcheck: hot-path — the deferred-export snapshot is enqueued on
    # the engine step thread right after (or between) dispatches, and by
    # a PD pull's executor thread: it may only ENQUEUE the gather; the
    # blocking d2h belongs to the offload worker (materialize_export)
    def stage_export_blocks(self, block_ids: list[int]) -> tuple:
        """Enqueue the device-side snapshot of whole KV blocks, already
        in the wire layout (2, L, n, nkv, bs, d). Returns (n, snapshot,
        event): on the card the gather runs on the compute stream, whoever
        calls, and `event` is recorded after it, so a later dispatch that
        overwrites these slots cannot reach the snapshot and the caller
        may release the blocks the moment this returns. On the CPU the
        snapshot is taken here and `event` is None.

        In a rank set every rank runs this in step order (a broadcast
        step, engine/multihost_engine.py): each gathers its (layers,
        heads) slice, and each follower in turn broadcasts it to the set,
        so rank 0 assembles the whole wire on its device, byte for byte
        (no zero-fill sum: -0.0 + 0.0 is +0.0). A follower's snapshot is
        None."""
        n = len(block_ids)
        with self.on_compute_stream():
            idx = self._block_slots(block_ids)
            snap = self._gather_wire(idx, n)
            if self.group is not None:
                snap = self._assemble_wire(snap)
            event = None
            if self.compute_stream is not None and snap is not None:
                event = torch.cuda.Event()
                event.record(self.compute_stream)
        return n, snap, event

    def local_wire(self, block_ids: list[int]) -> torch.Tensor:
        """This rank's own (layers, kv heads) slice of the blocks' wire,
        gathered with no collective (a debug read; in a rank set the
        whole wire is stage_export_blocks')."""
        with self.on_compute_stream():
            return self._gather_wire(self._block_slots(block_ids),
                                     len(block_ids))

    def _gather_wire(self, idx: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's cache rows `idx` (n whole blocks) in the wire
        layout: (2, L, n, nkv, bs, d) of its local config."""
        lc = self.local_config
        snap = torch.empty(
            (2, lc.num_layers, n, lc.num_kv_heads, self.block_size,
             lc.head_dim), dtype=self.cache_dtype, device=self.device)
        for i, cache in enumerate((self.k_cache, self.v_cache)):
            # head-major (L, nkv, n*bs, d) -> wire (L, n, nkv, bs, d)
            snap[i].copy_(cache.index_select(2, idx).view(
                lc.num_layers, lc.num_kv_heads, n, self.block_size,
                lc.head_dim).transpose(1, 2))
        return snap

    def _wire_slice(self, rank: int) -> tuple[slice, slice]:
        """The (layers, kv heads) of the whole wire that `rank` of the
        set holds."""
        mc, tp = self.model_config, self.tp_size
        stage, tp_rank = sharding.rank_layout(rank, tp)
        lo, hi = sharding.stage_layers(mc.num_layers, stage, self.pp_size)
        nkv = mc.num_kv_heads // tp
        return slice(lo, hi), slice(tp_rank * nkv, (tp_rank + 1) * nkv)

    def _assemble_wire(self, local: torch.Tensor) -> torch.Tensor | None:
        """Rank 0: the whole wire from every rank's slice, each follower's
        broadcast to the set in rank order; a follower: None, after
        sending its own slice and receiving the others'."""
        g = self.group
        full = None
        if g.rank == 0:
            mc = self.model_config
            full = torch.empty(
                (2, mc.num_layers, local.shape[2], mc.num_kv_heads,
                 *local.shape[4:]), dtype=local.dtype, device=self.device)
        for r in range(g.world_size):
            part = local
            if r > 0:
                if r != g.rank:
                    part = torch.empty_like(local)
                g.broadcast(part, r)
            if full is not None:
                layers, heads = self._wire_slice(r)
                full[:, layers, :, heads].copy_(part)
        return full

    def _export_stream(self):
        with self._d2h_lock:
            if self._d2h_stream is None:
                self._d2h_stream = torch.cuda.Stream(self.device)
            return self._d2h_stream

    def materialize_export(self, handle: tuple) -> torch.Tensor:
        """Blocking half of the deferred export (the offload worker's or
        a PD pull's thread): the (2, L, n, nkv, bs, d) host tensor. On the
        card a copy stream waits on the gather's event and copies into a
        pinned buffer non_blocking; only that copy is waited for, never
        the step thread's work. The buffer comes from torch's pinned
        allocator and is not reused while the returned tensor lives; the
        tiers keep per-block copies of it (kv/offload.own_block)."""
        _, snap, event = handle
        if event is None:
            return snap
        torch.cuda.set_device(self._device_index)
        stream = self._export_stream()
        host = torch.empty(snap.shape, dtype=snap.dtype, pin_memory=True)
        stream.wait_event(event)
        with torch.cuda.stream(stream):
            # the snapshot was allocated on the compute stream: mark its
            # use here so its memory is not handed out mid-copy
            snap.record_stream(stream)
            host.copy_(snap, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host

    def export_blocks(self, block_ids: list[int]) -> torch.Tensor:
        """Synchronous device->host copy of whole KV blocks (the
        --sync-kv-offload path and the export backlog cap)."""
        return self.materialize_export(self.stage_export_blocks(block_ids))

    # stackcheck: hot-path — restore staging: START the h2d upload;
    # enqueue-only (no device fetch, no tier IO)
    def stage_import_blocks(self, data: torch.Tensor) -> StagedBuffer:
        """Begin the restore's host->device upload of wire-layout blocks
        (2, L, n, nkv, bs, d): a pinned source, the copy stream and an
        event, as every staged dispatch buffer (`_stage`). The JAX
        runner pads the block axis to a power of two and writes the
        padding into the null block, only to bound its XLA compiles;
        eager PyTorch compiles nothing, so the port copies exactly n."""
        return self._stage(None, data)

    # stackcheck: hot-path — the restore's device-side write on the
    # admission path: index copies on the compute stream, no host sync
    def import_staged_blocks(
        self, block_ids: list[int], handle: StagedBuffer,
        src_cols: list[int],
    ) -> None:
        """In-place scatter of staged blocks into the KV cache:
        `src_cols[i]` names the staged column holding block_ids[i]'s
        contents. An index_copy_ into k_cache / v_cache over the slots of
        block_table_slots(block_ids), cast to the cache dtype. These are
        index operations, not kernels (the JAX runner runs them in XLA
        outside any Pallas kernel).

        The scatter is the program variant of ("kv_import", n_pad, n_pad,
        wire dtype), n_pad the staged width's power of two (the JAX
        runner's (n_src_pad, n_dst_pad) diagonal): the chosen columns
        are copied into its static wire, and its padding columns write
        the null block 0, trash by design. A rank set imports eagerly
        (import_wire's broadcast)."""
        if not block_ids:
            return
        m = len(block_ids)
        wire = self.staged_wire(handle, src_cols, m)
        if self.eager:
            self.import_wire(block_ids, wire)
            return
        n_pad = next_pow2(max(handle.dev.shape[2], m))
        ids = list(block_ids) + [0] * (n_pad - m)
        with self.on_compute_stream():
            self._dispatch_program(
                "kv_import", ("kv_import", n_pad, n_pad, wire.dtype),
                self._import_step(n_pad),
                {"wire": wire, "slots": self._block_slots(ids)},
                wide={"wire": wire.shape[:2] + (n_pad,) + wire.shape[3:]})

    def staged_wire(self, handle: StagedBuffer, src_cols: list[int],
                    m: int) -> torch.Tensor:
        """The staged wire's columns `src_cols` (m blocks), in order."""
        staged = self._take(handle)
        cols = torch.as_tensor(src_cols, dtype=torch.long)
        if not torch.equal(cols, torch.arange(m)):
            staged = staged.index_select(2, self._index_to_device(cols))
        elif staged.shape[2] != m:
            staged = staged[:, :, :m]
        return staged

    def _import_step(self, n: int):
        """`fn(inputs)` -> (): scatter the static wire inputs["wire"] (2,
        L, n, nkv, bs, d) into the cache rows inputs["slots"]."""
        lc = self.local_config

        # stackcheck: hot-path — the KV import scatter (eager, or captured
        # once a key and replayed)
        def fn(inp):
            wire, idx = inp["wire"], inp["slots"]
            for i, cache in enumerate((self.k_cache, self.v_cache)):
                # wire (L, n, nkv, bs, d) -> head-major (L, nkv, n*bs, d)
                cache.index_copy_(2, idx, wire[i].transpose(1, 2).reshape(
                    lc.num_layers, lc.num_kv_heads, n * self.block_size,
                    lc.head_dim).to(self.cache_dtype))
            return ()

        return fn

    def import_wire(self, block_ids: list[int],
                    wire: torch.Tensor | None = None,
                    shape: tuple | None = None,
                    dtype: str | None = None) -> None:
        """Scatter whole-wire blocks (2, L, m, nkv, bs, d) into this
        rank's cache at `block_ids`. In a rank set (a broadcast step)
        rank 0 holds `wire` and broadcasts it to the set; a follower
        receives it (`shape`, `dtype`: the wire's) and each rank writes
        its own (layers, kv heads) slice."""
        lc = self.local_config
        m = len(block_ids)
        with self.on_compute_stream():
            if self.group is not None:
                if wire is None:
                    wire = torch.empty(shape, dtype=getattr(torch, dtype),
                                       device=self.device)
                else:
                    wire = wire.contiguous()
                self.group.broadcast(wire, 0)
                layers, heads = self._wire_slice(self.group.rank)
                wire = wire[:, layers, :, heads]
            idx = self._block_slots(block_ids)
            for i, cache in enumerate((self.k_cache, self.v_cache)):
                # wire (L, m, nkv, bs, d) -> head-major (L, nkv, m*bs, d)
                cache.index_copy_(2, idx, wire[i].transpose(1, 2).reshape(
                    lc.num_layers, lc.num_kv_heads, m * self.block_size,
                    lc.head_dim).to(self.cache_dtype))

    def import_blocks(self, block_ids: list[int],
                      data: torch.Tensor) -> None:
        """Host->device restore of whole KV blocks (inverse of
        export_blocks), through the staged upload and the same scatter."""
        self.import_staged_blocks(
            block_ids, self.stage_import_blocks(data),
            list(range(len(block_ids))))

    # -- LoRA (engine/lora.py) ---------------------------------------------
    def load_lora(self, name: str, path: str,
                  slot: int | None = None) -> int:
        """Load an adapter into this rank's manager (`slot`: the one rank
        0 assigned); returns its slot."""
        return self.lora_manager.load(name, path, slot)

    def unload_lora(self, name: str) -> bool:
        return self.lora_manager.unload(name)

    # -- long-context ring (engine/long_prefill.py) ------------------------
    def build_long_prefiller(self):
        """The ring prefiller of the long-prefill lane, sp =
        EngineConfig.context_parallel_size ranks. Its pool is the sp
        cards past the serving ones when the host has sp of them per
        serving rank (ring compute then does not queue behind decode on
        a serving card; the params are copied to the ring's first card);
        otherwise the serving card repeated sp times, and on the CPU the
        CPU repeated sp times. Repeated, the ring uses the runner's
        parameter tensors and makes no second copy.

        In a tensor-parallel rank set each rank builds its own ring on
        its shard of the params: its ring cache holds the rank's kv
        heads, and the forward reduces over the set's tp group as
        serving does (the JAX lane's ("tp", "sp") mesh, tp ranks of sp
        ring ranks each). Rank r of tp takes spare cards [r*sp,
        (r+1)*sp) past the tp serving cards.

        A ring on one card computes what a ring over sp cards computes
        (each rank holds S_pad / sp cache rows and the same hops run in
        the same order), but its ranks share that card: its times are
        not sp speeds. Such a ring, outside a rank set and under a
        runner that captures its programs, is captured
        (parallel/long_context.py): its chunk programs share a graph pool
        of their own, which the KV sizing kept back with the ring's cache
        pair (`_ring_reserve`). Raises for sp < 2 and under pipeline
        parallelism (the engine serves those prompts chunked, as JAX
        does)."""
        from production_stack_tpu_torch.parallel.long_context import (
            LongContextPrefiller,
            make_sp_ring,
        )

        sp = self.config.context_parallel_size
        if sp <= 1:
            raise ValueError("context_parallel_size must be > 1")
        if self.pp_size > 1:
            raise ValueError("the long-context ring does not run under "
                             "pipeline parallelism")
        pool = self._ring_devices()
        captured = self._ring_captured(pool)
        return LongContextPrefiller(
            self.local_config, self.params, make_sp_ring(sp, pool),
            cache_dtype=self.cache_dtype, tp_group=self._tp_comm,
            captured=captured,
            pool=(torch.cuda.graph_pool_handle()
                  if captured and self.device.type == "cuda" else None),
        )

    def _ring_devices(self) -> list[torch.device]:
        """The long-context ring's devices (build_long_prefiller)."""
        sp = self.config.context_parallel_size
        dev = self.device
        if dev.type == "cuda":
            serving = (dev.index if dev.index is not None
                       else torch.cuda.current_device())
            # the serving cards: cuda:0..tp-1 in a rank set (a set whose
            # ranks share a card has no spare one), this card at tp=1
            taken = (set(range(self.tp_size)) if self.group is not None
                     else {serving})
            spare = [i for i in range(torch.cuda.device_count())
                     if i not in taken]
            r = self.group.tp_rank if self.group is not None else 0
            mine = (spare[r * sp:(r + 1) * sp]
                    if len(spare) >= self.tp_size * sp else [])
            return ([torch.device("cuda", i) for i in mine]
                    or [torch.device("cuda", serving)] * sp)
        return [dev] * sp

    def _ring_captured(self, ring: list[torch.device]) -> bool:
        """A ring whose ranks share this runner's device, outside a rank
        set, runs captured unless the runner is eager."""
        here = self.device
        if here.type == "cuda" and here.index is None:
            here = torch.device("cuda", torch.cuda.current_device())
        return (not self.eager and self.group is None
                and all(d == here for d in ring))

    def _ring_reserve(self) -> tuple[int, int]:
        """(cache pair bytes, graph pool bytes) a captured long-prefill
        ring keeps on this card at its longest prompt (max_model_len,
        padded to the chunk ladder); (0, 0) with no captured ring here.
        The KV sizing keeps them back, so the lane's memory is taken at
        boot instead of failing a long prompt later."""
        from production_stack_tpu_torch.parallel import long_context

        cfg = self.config
        if (cfg.long_prefill_threshold is None
                or cfg.context_parallel_size <= 1 or cfg.multihost
                or self.pp_size > 1
                or not self._ring_captured(self._ring_devices())):
            return 0, 0
        sp = cfg.context_parallel_size
        chunk = long_context.chunk_to(
            sp, max(cfg.long_prefill_chunk, self.block_size),
            self.block_size)
        return long_context.ring_reserve_bytes(
            self.local_config, sp, chunk,
            long_context.seq_pad(self.max_model_len, chunk),
            self.cache_dtype.itemsize)

    def collect_ring_cache(self, kc, vc) -> tuple | None:
        """A tp rank set's ring cache on rank 0: every rank's kv heads of
        the full-sequence K/V (SeqShardedCache, (L, nkv/tp, R, d) a
        shard), each follower's broadcast to the set in rank order as
        stage_export_blocks assembles the wire (the bytes travel). Rank
        0 gets (kc, vc) of all the model's kv heads, its shards on this
        runner's device; a follower gets None."""
        from production_stack_tpu_torch.parallel.long_context import (
            SeqShardedCache,
        )

        g = self.group
        sp = len(kc.shards)
        with self.on_compute_stream():
            # (2 * sp, L, nkv / tp, R, d): the k shards, then the v
            local = torch.stack([t.to(self.device)
                                 for t in (*kc.shards, *vc.shards)])
            nkv = local.shape[2]
            full = None
            if g.rank == 0:
                full = local.new_empty((2 * sp, local.shape[1],
                                        nkv * g.world_size,
                                        *local.shape[3:]))
            for r in range(g.world_size):
                part = local
                if r > 0:
                    if r != g.rank:
                        part = torch.empty_like(local)
                    g.broadcast(part, r)
                if full is not None:
                    full[:, :, r * nkv:(r + 1) * nkv].copy_(part)
        if full is None:
            return None
        return (SeqShardedCache(list(full[:sp])),
                SeqShardedCache(list(full[sp:])))


def _tensors(tree):
    """The tensors of a nest of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _to_device(tree: dict, device: torch.device) -> dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
