#!/usr/bin/env python3
"""Drive the PyTorch port (production_stack_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile the three kernel sources (csrc/paged_attention.cu,
   paged_decode.cu, paged_prefill.cu; the first and last include the
   tile of paged_tile.cuh), one nvcc each, all at once, and link them
   into one library (route: plain C interface + ctypes); print the
   compiler's register/spill report;
2. kernels: random inputs from a seed at Llama-3.2-3B attention shapes
   (nq=24, nkv=8, d=128, bs=32, bf16, a 28-layer cache past 2^31
   elements) run through each kernel and its plain PyTorch version on
   the card, in bf16 and again in f32 on the same inputs; prints max
   error against the stated tolerance, the kernel's time (mean of 20
   calls, each after an L2 flush, CUDA events around the call: the
   card's work and whatever of the wrapper's host enqueue it waits for),
   beside it the device time per call from torch.profiler and the
   host's enqueue time per call, the plain version's time, the least
   time the card could take (bound) and one PyTorch library call on the
   same function as a yardstick, the fastest of those tried: for ragged
   and prefill one SDPA (enable_gqa) over each lane's context read once,
   the lanes' contexts end to end under a block-causal mask; for decode
   one SDPA of each lane's row over its context padded to the table
   width. For each kernel it also prints the grid (split count), shared
   memory, achieved GB/s or TFLOP/s and bound / kernel time. The ragged
   kernel is also checked and timed on the decode lanes alone, packed as
   the model runner packs a decode step (one single-row segment per
   lane), beside the decode kernel on the same lanes;
3. forward: the same random params through models/llama.forward on the
   CPU (plain versions) and on the card (kernels), 2 layers at full 3B
   width, bf16; logits held to a stated tolerance;
4. families: HF checkpoints of the published configs of Qwen2-7B (28
   query heads over 4 kv heads, qkv bias), Mistral-7B-v0.1 (a 4096-token
   window) and Llama-3.2-1B (head_dim 64, tied embeddings), cut to 2
   layers, written from seeded params (models/debug_checkpoint.py),
   read back through models/weights.py onto the card byte for byte,
   logits held to the CPU as in phase 3, and an engine booted on each
   directory generates; a 5000-token Mistral prompt (past its window,
   ten prefill chunks) on the prefill kernel is held to the same
   forward on the plain attention on the card; a Gemma-7B config
   (head_dim 256) is refused at boot with a message naming it;
5. serve: the port's CLI (python -m production_stack_tpu_torch.engine)
   starts its OpenAI server on loopback with llama-3.2-3b (all 28
   layers, random bf16 weights, byte tokenizer) on its default config
   (unified ragged rounds, prefill pipeline, decode prefetch) in a child
   process: /health, /v1/models, a greedy completion, a streamed
   completion, a chat request, 4 concurrent multi-chunk completions
   (packed prefill or mixed rounds, on the ragged kernel), then a
   ~1500-token prompt (three 512-token chunks) sent while four greedy
   requests decode, so its chunks ride mixed rounds (tpu:ragged_rounds
   > 0 on /metrics), then one prompt sent twice; checks token counts,
   finish reasons and usage, that /metrics (parsed with the standard
   library) has the four families the router parses with a prefix-cache
   hit rate above 0 and one scheduling delay per finished request, and
   that the ragged kernel launched 28 times a forward and the prefill
   kernel 28 times a single-sequence prefill; prints the staged prefill
   hits, misses and chained chunks;
6. decode kernel: one ModelRunner.decode step of the 28-layer model over
   the same cache state on the ragged kernel and on
   paged_decode_attention, logits held to a stated tolerance, which the
   same step with a planted fault (a lane longer than one split loses
   its last split) must exceed; then an in-process LLMEngine with
   --no-ragged-kernel drives paged_decode_attention, and its greedy
   tokens are compared with a ragged-kernel engine's: the two kernels
   sum in different orders, so a divergence passes only where the
   ragged engine's top-2 logprob gap at the first differing step is
   below the largest logit difference the direct step measured (the
   first divergence is printed);
7. pipeline: an in-process 28-layer bf16 engine on the default config
   takes a cold ~1500-token prompt alone and must chain its three
   512-token chunks in one engine step with one fetch; the buffers of
   stage_prefill, stage_prefill_batch, stage_decode_multi and
   stage_ragged, read back after their copy events, must equal byte for
   byte what the unstaged dispatch builds from the same arguments, and a
   packed prefill on a staged buffer must give the unstaged one's tokens
   and logits; prints the prefill phase seconds (prep, h2d, dispatch,
   fetch) of the same prompts on this engine and on one with
   --no-prefill-pipeline --no-prefetch-decode;
8. mixed rounds: in-process 28-layer bf16 engines with
   num_scheduler_steps=8 (unified ragged rounds, device stops, adaptive
   K), one on the default config and one without the prefill pipeline
   and the decode prefetch, and a split K=1 engine, serve four greedy
   requests and a ~1500-token prompt arriving while they decode; the
   default engine must consume staged decode and ragged rounds, and its
   greedy streams are held to both other engines' under the decode
   phase's near-tie rule, every engine's launches to 28 a forward. Then
   wall ms per generated token at batch 8 on each engine, the wall time
   of each mixed round, and a torch.profiler breakdown of one mixed
   round's device time (host clock; reported beside the card's name and
   power limit and the reads taken before staging existed, not
   claims);
9. checkpoint: the seeded llama-3.2-3b params (28 layers, bf16) written
   as an HF checkpoint (two shards, 6.4 GB) in a temporary directory
   under build/ that the phase removes, read back byte for byte (write
   and load seconds printed), then served by the CLI with --model <dir>
   --enable-lora --max-loras 4 --max-lora-rank 16 --num-scheduler-steps
   8; two PEFT adapters (rank 16 and 8, q/k/v/o) written by
   engine/lora.py are loaded over /v1/load_lora_adapter and listed by
   /v1/models; three short and three ~1100-token requests (base, each
   adapter) are sent at once, so prefill chunks and decode rows of
   different slots share ragged rounds (token ids read back through
   return_tokens_as_token_ids); launches held to 28 a forward; an
   unloaded adapter's name gets 404. In process on the same
   directory: one decode step with lanes [base, ad16, base, ad8] leaves
   the base lanes' logits bit-equal to the step without adapters; the
   base streams are held to an engine without LoRA and each adapter's
   to an engine on merged weights W + A @ B, under the near-tie rule
   (an adapter's tolerance is at least the LoRA vs merged forward's
   max|dlogit| over 256 rows).

Launch counts are reset just before the serve phase's requests (through
the server's /debug/kernel_launches), before the decode phase's
--no-ragged-kernel engine, before each pipeline-phase engine and before
each mixed-round engine and before the checkpoint phase's requests, and
read just after; a kernel launched 0 times on those paths fails the
run. The
servers' logs go to build/chip_smoke_serve.log and
build/chip_smoke_lora_serve.log. The last lines are the kernels JSON, the
card's name and power limit (nvidia-smi), and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
# kernel vs plain, per (row, head): |out - ref| <= TOL * max|ref| over d.
# bf16: the plain versions and the kernels round one f32 result once, so
# they differ by at most one bf16 step (<= 2^-7 of the row's largest
# value); the kernels also round P to bf16 (relative 2^-9 per weight) for
# the tensor-core PV product, which moves a row by a fraction of a step
# more. 2^-6 is two steps.
# f32: summation order only; a row that saw one key too many or too few
# moves by ~1e-3 of its largest value at these context lengths.
BF16_REL_TOL = 2.0**-6
F32_REL_TOL = 1e-4
LOGIT_REL_TOL = 5e-2       # forward, max|dlogit| / max|logit|, bf16
# decode phase: the same 28-layer bf16 decode step on two kernels that
# differ in summation order (both round P to bf16 for the tensor-core PV
# product), max|dlogit| / max|logit|: sound runs read 1.5e-2 to 1.6e-2,
# the same step with the last split of the longest lane skipped reads
# 0.35 (on an H100); the bound is about twice the sound reading, and the
# faulty step must land above it in every run
DECODE_LOGIT_REL_TOL = 3e-2
LAYERS_3B = 28
# the prompt that arrives while other requests decode: three 512-token
# chunks at the engine's default max_prefill_chunk
LONG_PROMPT_TOKENS = 1500


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list[str]:
    """Registers and spills per kernel instantiation from a -Xptxas -v
    log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


# -- timing --------------------------------------------------------------------
def time_cuda(torch, fn, iters: int, flush) -> float:
    """Mean ms per call over `iters` calls, each with a cold L2 (a 256 MB
    write between calls) and timed alone with CUDA events."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    evs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    for a, b in evs:
        total += a.elapsed_time(b)
    return total / iters


def device_breakdown(torch, fn, flush, names, n: int = 10) -> str:
    """Device time per call of each CUDA kernel whose name holds one of
    `names`, from torch.profiler over n calls, each after the 256 MB
    write that time_cuda flushes the L2 with ("not measured" where the
    profiler records no device time); beside it the host's time to
    enqueue one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        hit = [k for k in names if k in ev.key]
        if hit and dev_us:
            parts.append(f"{hit[0]} {dev_us / n:.1f} us")
    return (f"device {', '.join(parts) if parts else 'not measured'}; "
            f"host enqueue {host_us:.1f} us/call")


# -- kernel phase --------------------------------------------------------------
def kernel_phase(torch) -> list[tuple[str, dict]]:
    import numpy as np
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    L, nq, nkv, d, bs = 28, 24, 8, 128, 32
    g = nq // nkv
    num_blocks = 2560  # 81920 slots: offsets of layer 27 pass 2^31
    slots = num_blocks * bs
    layer = L - 1
    scale = d**-0.5
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k_cache = torch.randn((L, nkv, slots, d), generator=gen, device=dev,
                          dtype=dt)
    v_cache = torch.randn((L, nkv, slots, d), generator=gen, device=dev,
                          dtype=dt)
    assert (layer * nkv + nkv - 1) * slots * d > 2**31
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    # lanes: 8 decode lanes (page-straddling contexts) + 2 prefill chunks
    dec_ctx = [1, 31, 32, 33, 500, 1000, 1531, 2047]
    pf = [(0, 256), (700, 384)]  # (q_start, rows)
    lanes_ctx = dec_ctx + [qs + n for qs, n in pf]
    P = max(-(-c // bs) for c in lanes_ctx)
    perm = rng.permutation(num_blocks)
    tables = np.zeros((len(lanes_ctx), P), np.int32)
    for i in range(len(lanes_ctx)):
        tables[i] = perm[i * P:(i + 1) * P]
    tables_d = torch.from_numpy(tables).to(dev)

    # ragged row space: block 0 holds the 8 decode rows (+ an idle
    # segment), then each prefill chunk's tq-blocks
    tq = pa.RAGGED_TQ
    blk_seg, seg_meta = [0], []
    for i, c in enumerate(dec_ctx):
        seg_meta.append([i, i, 1, c - 1])
    seg_meta.append([0, 0, 0, 5])  # idle segment: stores nothing
    blk_seg.append(len(seg_meta))
    for j, (qs, n) in enumerate(pf):
        for r0 in range(0, n, tq):
            seg_meta.append([len(dec_ctx) + j, 0, tq, qs + r0])
            blk_seg.append(len(seg_meta))
    G = len(blk_seg) - 1
    R = G * tq
    q_r = torch.randn((R, nq, d), generator=gen, device=dev, dtype=dt)
    blk_seg_d = torch.tensor(blk_seg, dtype=torch.int32, device=dev)
    seg_meta_d = torch.tensor(seg_meta, dtype=torch.int32, device=dev)
    covered = [i for i in range(len(dec_ctx))] + list(range(tq, R))

    def padded_decode_sdpa_inputs(rows_q, qpos, tables):
        """One SDPA of each decode lane's row, (b, nq, 1, d), over its
        own context padded to the table width, (b, nq, P * bs, d) with
        K/V repeated over the g query heads, under a boolean visibility
        mask: for decode the fastest library call tried (one call over
        the lanes' contexts end to end, as for ragged, took twice as
        long)."""
        C = tables.shape[1] * bs
        slots_l = (tables.long()[:, :, None] * bs
                   + torch.arange(bs, device=dev)).reshape(len(qpos), C)
        k = k_cache[layer][:, slots_l].permute(1, 0, 2, 3)
        v = v_cache[layer][:, slots_l].permute(1, 0, 2, 3)
        mask = (torch.arange(C, device=dev)[None, :]
                <= torch.tensor(qpos, device=dev)[:, None])
        k = k.repeat_interleave(g, dim=1).contiguous()
        v = v.repeat_interleave(g, dim=1).contiguous()
        return (rows_q[:, :, None, :].contiguous(), k, v,
                mask[:, None, None, :].contiguous(), False)

    def fair_sdpa_inputs(rows_q, qpos, lane_of_row, tables):
        """One SDPA call that reads each lane's context once: the rows
        (1, nq, R, d) over the lanes' contexts (positions 0 .. the lane's
        last row) laid end to end, (1, nkv, sum ctx, d), GQA through
        enable_gqa, under a block-causal mask (a row sees its own lane's
        keys up to its position)."""
        lane_t = torch.tensor(lane_of_row, device=dev)
        qp = torch.tensor(qpos, device=dev)
        kslots, klane, kpos = [], [], []
        for lane in sorted(set(lane_of_row)):
            n = max(q for q, ln in zip(qpos, lane_of_row) if ln == lane) + 1
            pos = torch.arange(n, device=dev)
            kslots.append(tables[lane].long()[pos // bs] * bs + pos % bs)
            klane.append(torch.full_like(pos, lane))
            kpos.append(pos)
        sl = torch.cat(kslots)
        kl, kp = torch.cat(klane), torch.cat(kpos)
        mask = (kl[None, :] == lane_t[:, None]) & (kp[None, :] <= qp[:, None])
        return (rows_q.transpose(0, 1)[None].contiguous(),
                k_cache[layer][:, sl][None].contiguous(),
                v_cache[layer][:, sl][None].contiguous(),
                mask[None, None].contiguous(), True)

    def visible_keys(qpos):
        return sum(p + 1 for p in qpos)

    def bound(n_rows, qpos, kv_tokens):
        kv_bytes = 2 * kv_tokens * nkv * d * 2
        qo_bytes = 2 * n_rows * nq * d * 2
        ops = 4 * visible_keys(qpos) * nq * d
        t_bytes = (kv_bytes + qo_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                              "operations")

    def compare(name, out_k, out_p, rows_sel, rel_tol):
        """Max abs error of the kernel against the plain version over the
        covered rows, held per (row, head) to rel_tol * max|ref|."""
        torch.cuda.synchronize()
        o = out_k[rows_sel].float()
        r = out_p[rows_sel].float()
        err = (o - r).abs()
        tol = rel_tol * r.abs().amax(dim=-1, keepdim=True)
        worst = float((err / tol.clamp_min(1e-30)).max())
        max_err = float(err.max())
        print(f"kernel {name}: max_abs_err={max_err:.3e} worst err/tol="
              f"{worst:.3f} (tol {rel_tol:.3g} x max|ref| per row, head)",
              flush=True)
        if not worst <= 1.0:
            fail(f"{name}: kernel vs plain off by {worst:.3f}x the "
                 "tolerance")
        return max_err

    # f32 copies of the layer the checks read, at the same slots: the
    # same inputs through kernel and plain version with f32 arithmetic
    # only, where a masking or page-range fault cannot hide in rounding
    k32 = k_cache[layer:layer + 1].float()
    v32 = v_cache[layer:layer + 1].float()

    def sdpa_ms(args):
        q4, k4, v4, m4, gqa = args
        kw_gqa = {"enable_gqa": True} if gqa else {}
        return time_cuda(
            torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale, **kw_gqa),
            20, flush)

    def check(name, kern, plain, rows_sel, lib_args, n_rows, qpos,
              kv_tokens, f32_args, cuda_names, iters=20):
        err = compare(f"{name} bf16", kern(), plain(), rows_sel,
                      BF16_REL_TOL)
        kern32, plain32 = f32_args
        compare(f"{name} f32", kern32(), plain32(), rows_sel, F32_REL_TOL)
        ms = time_cuda(torch, kern, iters, flush)
        split = device_breakdown(torch, kern, flush, cuda_names)
        plain_ms = time_cuda(torch, plain, 3, flush)
        lib_ms = sdpa_ms(lib_args())
        torch.cuda.empty_cache()
        bms, by = bound(n_rows, qpos, kv_tokens)
        print(f"kernel {name}: kernel_ms={ms:.4f} (mean of {iters}; "
              f"profiler, per call: {split}) plain_ms={plain_ms:.3f} "
              f"bound_ms={bms:.4f} ({by}) library_ms={lib_ms:.4f}",
              flush=True)
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}

    def report(name, st, grid, smem, rate):
        """Grid, shared memory, achieved rate and roofline share of a
        redesigned kernel (registers and spills: the build phase's
        ptxas lines)."""
        print(f"kernel {name}: grid {grid}, dynamic shared memory {smem} "
              f"bytes, {rate}, bound/kernel = "
              f"{st['bound_ms'] / st['ms']:.3f}", flush=True)

    kw = dict(block_size=bs, scale=scale)
    # ragged: the decode rows + prefill chunks mix, full context
    qpos_r, lane_r = [], []
    for r in covered:
        if r < tq:
            qpos_r.append(dec_ctx[r] - 1)
            lane_r.append(r)
        else:
            lane = len(dec_ctx) + (0 if r < tq + pf[0][1] else 1)
            base = tq if lane == len(dec_ctx) else tq + pf[0][1]
            qpos_r.append(pf[lane - len(dec_ctx)][0] + r - base)
            lane_r.append(lane)
    kv_tok = sum(lanes_ctx)
    rows_t = torch.tensor(covered, device=dev)
    q_r32 = q_r.float()

    def ragged(fn, qq, kk, vv, ll, window=None):
        return lambda: fn(qq, kk, vv, ll, tables_d, blk_seg_d, seg_meta_d,
                          window=window, **kw)

    rag = check(
        "ragged_paged_attention",
        ragged(pa.ragged_paged_attention, q_r, k_cache, v_cache, layer),
        ragged(pa.ragged_paged_attention_plain, q_r, k_cache, v_cache,
               layer),
        rows_t,
        lambda: fair_sdpa_inputs(q_r[rows_t], qpos_r, lane_r, tables_d),
        len(covered), qpos_r, kv_tok,
        (ragged(pa.ragged_paged_attention, q_r32, k32, v32, 0),
         ragged(pa.ragged_paged_attention_plain, q_r32, k32, v32, 0)),
        ("ragged_tile_kernel",),
    )
    # one windowed case on the same mix (kernel vs plain only)
    w = 256
    werr = compare(
        f"ragged_paged_attention window={w} bf16",
        ragged(pa.ragged_paged_attention, q_r, k_cache, v_cache, layer,
               w)(),
        ragged(pa.ragged_paged_attention_plain, q_r, k_cache, v_cache,
               layer, w)(),
        rows_t, BF16_REL_TOL)
    compare(
        f"ragged_paged_attention window={w} f32",
        ragged(pa.ragged_paged_attention, q_r32, k32, v32, 0, w)(),
        ragged(pa.ragged_paged_attention_plain, q_r32, k32, v32, 0, w)(),
        rows_t, F32_REL_TOL)
    rag["max_abs_err"] = max(rag["max_abs_err"], werr)
    smem = pa._prefill_smem(d, 2, 2)  # the prefill tile: ragged too
    n_x, n_y = pa._ragged_grid(len(seg_meta), tq, g, nkv)
    rag_bytes = 2 * kv_tok * nkv * d * 2 + 2 * len(covered) * nq * d * 2
    report("ragged_paged_attention", rag,
           f"({n_x}, {n_y}) = {n_x * n_y} blocks, one per (segment, "
           f"{pa.PREFILL_BM}-fused-row tile, kv head), "
           f"{pa.PREFILL_BN}-key tiles", smem,
           f"{rag_bytes / rag['ms'] / 1e6:.1f} GB/s, "
           f"{4 * visible_keys(qpos_r) * nq * d / rag['ms'] / 1e9:.1f} "
           "TFLOP/s (bf16)")

    # prefill: one 512-row chunk at q_start 1024 over 48 shuffled pages
    t, qs = 512, 1024
    n_pf = -(-(qs + t) // bs)
    pf_table = torch.from_numpy(perm[:n_pf].astype(np.int32)).to(dev)
    q_p = torch.randn((t, nq, d), generator=gen, device=dev, dtype=dt)
    qpos_p = [qs + i for i in range(t)]

    q_p32 = q_p.float()
    pre = check(
        "paged_prefill_attention",
        lambda: pa.paged_prefill_attention(
            q_p, k_cache, v_cache, layer, pf_table, qs, **kw),
        lambda: pa.paged_prefill_attention_plain(
            q_p, k_cache, v_cache, layer, pf_table, qs, **kw),
        torch.arange(t, device=dev),
        lambda: fair_sdpa_inputs(q_p, qpos_p, [0] * t, pf_table[None]),
        t, qpos_p, qs + t,
        (lambda: pa.paged_prefill_attention(
            q_p32, k32, v32, 0, pf_table, qs, **kw),
         lambda: pa.paged_prefill_attention_plain(
            q_p32, k32, v32, 0, pf_table, qs, **kw)),
        ("prefill_kernel",),
    )

    n_tiles = -(-t * g // pa.PREFILL_BM)
    report("paged_prefill_attention", pre,
           f"({n_tiles}, {nkv}) = {n_tiles * nkv} blocks of "
           f"{pa.PREFILL_BM} fused rows x {pa.PREFILL_BN}-key tiles",
           smem,
           f"{4 * visible_keys(qpos_p) * nq * d / pre['ms'] / 1e9:.1f} "
           f"TFLOP/s (bf16)")

    # decode: the 8 decode lanes
    b = len(dec_ctx)
    q_d = torch.randn((b, nq, d), generator=gen, device=dev, dtype=dt)
    ctx_d = torch.tensor(dec_ctx, dtype=torch.int32, device=dev)
    tab_d = tables_d[:b].contiguous()
    qpos_d = [c - 1 for c in dec_ctx]
    q_d32 = q_d.float()
    dec = check(
        "paged_decode_attention",
        lambda: pa.paged_decode_attention(
            q_d, k_cache, v_cache, layer, tab_d, ctx_d, **kw),
        lambda: pa.paged_decode_attention_plain(
            q_d, k_cache, v_cache, layer, tab_d, ctx_d, **kw),
        torch.arange(b, device=dev),
        lambda: padded_decode_sdpa_inputs(q_d, qpos_d, tab_d),
        b, qpos_d, sum(dec_ctx),
        (lambda: pa.paged_decode_attention(
            q_d32, k32, v32, 0, tab_d, ctx_d, **kw),
         lambda: pa.paged_decode_attention_plain(
            q_d32, k32, v32, 0, tab_d, ctx_d, **kw)),
        ("decode_split_kernel", "decode_merge_kernel"),
    )
    pps, n_splits = pa._decode_split_plan(P, bs)
    kv_bytes = 2 * sum(dec_ctx) * nkv * d * 2 + 2 * b * nq * d * 2
    report("paged_decode_attention", dec,
           f"({b}, {nkv}, {n_splits}) = {b * nkv * n_splits} blocks "
           f"({n_splits} splits of {pps} pages) + merge ({b}, {nkv})",
           pa._decode_smem(g, d, 2, 2),
           f"{kv_bytes / dec['ms'] / 1e6:.1f} GB/s")

    # the ragged kernel on the same decode lanes alone, packed as the
    # model runner packs a decode step (one single-row segment a lane):
    # the launch the serving engine makes most
    from production_stack_tpu_torch.engine.model_runner import (
        decode_segments,
    )
    r_pad, dblk, dmeta = decode_segments(np.asarray(dec_ctx, np.int32))
    assert r_pad == b
    dblk_d = torch.from_numpy(dblk).to(dev)
    dmeta_d = torch.from_numpy(dmeta).to(dev)

    def ragged_dec(fn, qq, kk, vv, ll):
        return lambda: fn(qq, kk, vv, ll, tab_d, dblk_d, dmeta_d, **kw)

    rdec = check(
        "ragged_paged_attention decode-only",
        ragged_dec(pa.ragged_paged_attention, q_d, k_cache, v_cache, layer),
        ragged_dec(pa.ragged_paged_attention_plain, q_d, k_cache, v_cache,
                   layer),
        torch.arange(b, device=dev),
        lambda: padded_decode_sdpa_inputs(q_d, qpos_d, tab_d),
        b, qpos_d, sum(dec_ctx),
        (ragged_dec(pa.ragged_paged_attention, q_d32, k32, v32, 0),
         ragged_dec(pa.ragged_paged_attention_plain, q_d32, k32, v32, 0)),
        ("ragged_tile_kernel",),
    )
    n_x, n_y = pa._ragged_grid(len(dmeta), tq, g, nkv)
    report("ragged_paged_attention decode-only", rdec,
           f"({n_x}, {n_y}) = {n_x * n_y} blocks", smem,
           f"{kv_bytes / rdec['ms'] / 1e6:.1f} GB/s")
    print(f"decode lanes ({b}, contexts {dec_ctx}): ragged_paged_attention "
          f"kernel_ms={rdec['ms']:.4f} beside paged_decode_attention "
          f"kernel_ms={dec['ms']:.4f} (x{rdec['ms'] / dec['ms']:.2f})",
          flush=True)
    del k_cache, v_cache, k32, v32, flush
    torch.cuda.empty_cache()
    return [("ragged", rag), ("prefill", pre), ("decode", dec)]


# -- forward phase -------------------------------------------------------------
def two_step_logits(torch, pa, cfg, params, dev):
    """Logits of a 40-token prompt's last row (one 64-row prefill chunk on
    paged_prefill_attention) and of one decode step after it (a
    single-row segment on ragged_paged_attention), through
    models/llama.forward on `dev`'s params; (2, vocab) f32 on the CPU."""
    from production_stack_tpu_torch.models import llama

    bs, n_blocks = 32, 16
    scale = cfg.head_dim**-0.5
    t, first = 64, 40  # a 40-token prompt padded to a 64-row chunk
    shape = (cfg.num_layers, cfg.num_kv_heads, n_blocks * bs, cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    table = torch.arange(1, 4, dtype=torch.int32, device=dev)
    toks = torch.arange(t, device=dev) * 37 % cfg.vocab_size
    pos = torch.arange(t, device=dev)
    pos[first:] = 0
    slots = torch.arange(t, device=dev) + bs
    slots[first:] = 0

    def attn_pf(q, l, k, v):
        return pa.paged_prefill_attention(q, k, v, l, table, 0,
                                          block_size=bs, scale=scale,
                                          window=cfg.sliding_window)

    lg1, _, _ = llama.forward(
        cfg, params, toks, pos, kc, vc, slots, attn_pf,
        logits_rows=torch.tensor([first - 1], device=dev))
    blk = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    meta = torch.tensor([[0, 0, 1, first]], dtype=torch.int32, device=dev)

    def attn_dec(q, l, k, v):
        qp = torch.zeros((8,) + tuple(q.shape[1:]), dtype=q.dtype,
                         device=dev)
        qp[:1] = q
        return pa.ragged_paged_attention(
            qp, k, v, l, table[None, :], blk, meta, block_size=bs,
            scale=scale, window=cfg.sliding_window)[:1]

    lg2, _, _ = llama.forward(
        cfg, params, torch.tensor([5], device=dev),
        torch.tensor([first], device=dev), kc, vc,
        torch.tensor([bs + first], device=dev), attn_dec,
        logits_rows=torch.tensor([0], device=dev))
    return torch.cat([lg1, lg2]).float().cpu()


def tree_to(tree, dev):
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def card_vs_cpu(torch, pa, what, cfg, params_gpu) -> float:
    """two_step_logits on the card (kernels) against the CPU (plain
    versions) on the same params; fails above LOGIT_REL_TOL."""
    ref = two_step_logits(torch, pa, cfg, tree_to(params_gpu, "cpu"), "cpu")
    got = two_step_logits(torch, pa, cfg, params_gpu, "cuda")
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite logits on the card")
    rel = float((got - ref).abs().max() / ref.abs().max())
    print(f"{what}: logits {tuple(got.shape)} card vs CPU "
          f"max|d|/max|ref|={rel:.3e} tol={LOGIT_REL_TOL}", flush=True)
    if not rel <= LOGIT_REL_TOL:
        fail(f"{what}: relative logit error {rel} > {LOGIT_REL_TOL}")
    return rel


def forward_phase(torch) -> None:
    import dataclasses

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import paged_attention as pa

    cfg = dataclasses.replace(get_model_config("llama-3.2-3b"),
                              num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    card_vs_cpu(torch, pa, "forward llama-3.2-3b x2 layers bf16", cfg,
                params)
    del params
    torch.cuda.empty_cache()


# -- serve phase ---------------------------------------------------------------
def http(port: int, path: str, body: dict | None = None,
         timeout: float = 600.0, method: str | None = None
         ) -> tuple[int, str]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"}, method=method,
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(port: int, log_path: Path, model: str = "llama-3.2-3b",
                 extra: tuple = ()) -> subprocess.Popen:
    """The port's CLI in a child process, as a user starts it."""
    cmd = [
        sys.executable, "-m", "production_stack_tpu_torch.engine",
        "--model", model, "--tokenizer", "byte",
        "--block-size", "32", "--num-kv-blocks", "1024",
        "--max-num-seqs", "8", "--seed", str(SEED),
        "--host", "127.0.0.1", "--port", str(port), *extra,
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    print(f"serve: {' '.join(cmd[1:])}", flush=True)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "wb") as log:
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def stop_server(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(60)


def log_tail(log_path: Path, n: int = 40) -> str:
    return "\n".join(log_path.read_text(errors="replace").splitlines()[-n:])


def metric(port: int, name: str) -> float:
    """One sample of the server's /metrics text (the first with `name`)."""
    samples, _ = parse_metrics(http(port, "/metrics")[1])
    if name not in samples:
        fail(f"/metrics has no {name}")
    return samples[name][0][1]


def parse_metrics(text: str) -> tuple[dict, dict]:
    """Prometheus text exposition -> ({sample name: [(labels, value)]},
    {family: type}), with the standard library only (the card's machine
    has no prometheus_client)."""
    samples: dict[str, list] = {}
    types: dict[str, str] = {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, fam, kind = ln.split(" ", 3)
            types[fam] = kind
            continue
        if not ln or ln.startswith("#"):
            continue
        head, value = ln.rsplit(" ", 1)
        name, _, rest = head.partition("{")
        labels = {}
        for part in rest.rstrip("}").split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                labels[k] = v.strip('"')
        samples.setdefault(name, []).append((labels, float(value)))
    return samples, types


# the families the router parses (router/stats/engine_stats.py)
ROUTER_FAMILIES = {
    "vllm:gpu_prefix_cache_hit_rate": "gauge",
    "vllm:gpu_prefix_cache_hits_total": "gauge",
    "vllm:gpu_prefix_cache_queries_total": "gauge",
    "tpu:scheduling_delay_seconds": "histogram",
}


def check_launches(what: str, launches: dict, dispatches: dict) -> None:
    """Every ragged-kernel forward launches it once a layer (packed and
    single-step decode forwards, each iteration of a fused loop, each
    mixed round's step-0 forward), the prefill kernel once a layer per
    single-sequence prefill."""
    layers = LAYERS_3B
    fwd = (dispatches["prefill_batch"] + dispatches["decode"]
           + dispatches["decode_iterations"])
    want = {"ragged": layers * fwd, "prefill": layers * dispatches["prefill"]}
    got = {k: launches[k] for k in want}
    print(f"{what}: launches {got}, {layers} x forwards {want}", flush=True)
    if got != want:
        fail(f"{what}: kernel launches {got} are not {layers} a forward "
             f"{want}")


def wait_healthy(what: str, proc, port: int, log_path: Path,
                 t0: float) -> float:
    """Seconds from t0 until the server answers /health with 200."""
    while True:
        if proc.poll() is not None:
            fail(f"{what}: server exited with {proc.returncode}:\n"
                 f"{log_tail(log_path)}")
        if time.perf_counter() - t0 > 600:
            fail(f"{what}: server not healthy after 600 s:\n"
                 f"{log_tail(log_path)}")
        try:
            st, body = http(port, "/health", timeout=5)
            if st == 200 and json.loads(body)["status"] == "healthy":
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.5)


def serve_phase() -> dict:
    port = free_port()
    log_path = REPO / "build" / "chip_smoke_serve.log"
    t0 = time.perf_counter()
    proc = start_server(port, log_path)
    try:
        boot = wait_healthy("serve", proc, port, log_path, t0)
        print(f"serve: healthy {boot:.1f}s after start", flush=True)
        card = json.loads(http(port, "/v1/models")[1])["data"][0]
        assert card["id"] == "llama-3.2-3b" and card["max_model_len"], card
        assert "kv_role" not in card or card["kv_role"] is None, card

        sent = [0]

        def completion(prompt, n, **extra):
            sent[0] += 1
            st, body = http(port, "/v1/completions", {
                "prompt": prompt, "max_tokens": n, "temperature": 0,
                "ignore_eos": True, **extra})
            r = json.loads(body)
            u = r["usage"]
            ok = (st == 200 and r["choices"][0]["finish_reason"] == "length"
                  and u["completion_tokens"] == n
                  and u["prompt_tokens"] == len(prompt.encode()) + 1
                  and u["total_tokens"] == u["prompt_tokens"] + n)
            if not ok:
                fail(f"serve: bad completion response {body[:400]}")
            return r

        # the main path: launch counts from 0 just before it
        st, body = http(port, "/debug/kernel_launches", method="DELETE")
        zeroed = json.loads(body)
        if st != 200 or any(zeroed["launches"].values()):
            fail(f"serve: launch counts not reset: {body}")

        t1 = time.perf_counter()
        completion("The quick brown fox jumps over the lazy dog.", 32)
        print(f"serve: greedy completion (32 tokens) in "
              f"{time.perf_counter() - t1:.2f}s", flush=True)

        sent[0] += 2  # the streamed completion and the chat request
        st, body = http(port, "/v1/completions", {
            "prompt": "Stream me some tokens", "max_tokens": 16,
            "temperature": 0.8, "top_p": 0.9, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}})
        events = [ln[6:] for ln in body.splitlines()
                  if ln.startswith("data: ")]
        if st != 200 or events[-1] != "[DONE]":
            fail(f"serve: bad stream {body[:400]}")
        chunks = [json.loads(e) for e in events[:-1]]
        reasons = [c["choices"][0]["finish_reason"] for c in chunks
                   if c["choices"]]
        if reasons[-1] != "length" or chunks[-1]["usage"][
                "completion_tokens"] != 16:
            fail(f"serve: stream ended wrong {chunks[-2:]}")

        st, body = http(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hi."}],
            "max_tokens": 8, "temperature": 0, "ignore_eos": True})
        r = json.loads(body)
        if (st != 200 or r["choices"][0]["message"]["role"] != "assistant"
                or r["usage"]["completion_tokens"] != 8):
            fail(f"serve: bad chat response {body[:400]}")

        # 4 concurrent multi-chunk prompts: their chunks pack into
        # prefill_batch forwards, or into mixed rounds beside the lanes
        # already decoding (ragged kernel on prefill segments either way)
        before = json.loads(http(port, "/debug/kernel_launches")[1])
        prompts = [(f"request {i}: " + "lorem ipsum dolor sit amet " * 45)
                   for i in range(4)]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(lambda p: completion(p, 24), prompts))
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        packed = {k: report["dispatches"][k] - before["dispatches"][k]
                  for k in ("prefill_batch", "ragged")}
        print(f"serve: 4 concurrent completions in "
              f"{time.perf_counter() - t1:.2f}s, packed prefill and mixed "
              f"forwards {packed}; since the reset: dispatches "
              f"{report['dispatches']}, launches {report['launches']}",
              flush=True)
        if sum(packed.values()) < 1:
            fail("serve: no packed prefill or mixed forward ran")

        # a ~1500-token prompt (three 512-token chunks) arrives while four
        # greedy requests decode: its chunks ride unified ragged rounds
        gen0 = metric(port, "vllm:generation_tokens_total")
        rounds0 = metric(port, "tpu:ragged_rounds_total")
        t1 = time.perf_counter()
        with ThreadPoolExecutor(5) as ex:
            lanes = [ex.submit(completion, f"decoding lane {i}: " + "ab " * 9,
                               64) for i in range(4)]
            while metric(port, "vllm:generation_tokens_total") < gen0 + 4:
                if any(f.done() for f in lanes):
                    fail("serve: a decoding lane finished before the long "
                         "prompt was sent")
                time.sleep(0.01)
            long_req = ex.submit(completion, "long " + "x y z " * (
                (LONG_PROMPT_TOKENS - 6) // 6), 8)
            for f in lanes + [long_req]:
                f.result()
        rounds = metric(port, "tpu:ragged_rounds_total") - rounds0
        print(f"serve: a {LONG_PROMPT_TOKENS}-token prompt beside 4 decoding "
              f"lanes in "
              f"{time.perf_counter() - t1:.2f}s, {rounds:.0f} mixed rounds "
              "(tpu:ragged_rounds)", flush=True)
        if not rounds > 0:
            fail("serve: no mixed (ragged) round ran")
        metrics = http(port, "/metrics")[1]
        for gauge in ("vllm:num_requests_running",
                      "vllm:num_requests_waiting",
                      "vllm:gpu_cache_usage_perc", "tpu:ragged_rounds_total",
                      "tpu:decode_k_count"):
            if gauge not in metrics:
                fail(f"serve: /metrics lacks {gauge}")
        # one multi-chunk prompt sent twice: the second finds its blocks
        # in the prefix cache; then the router's families are read back
        repeat = "repeat " + "the same words again " * 40
        for _ in range(2):
            completion(repeat, 8)
        samples, types = parse_metrics(http(port, "/metrics")[1])
        for fam, kind in ROUTER_FAMILIES.items():
            if types.get(fam) != kind:
                fail(f"serve: /metrics has {fam} as {types.get(fam)}, not "
                     f"{kind}")

        def one(name):
            return samples[name][0][1]

        finished = sum(v for _, v in samples["vllm:request_success_total"])
        delay_n = one("tpu:scheduling_delay_seconds_count")
        rate = one("vllm:gpu_prefix_cache_hit_rate")
        print(f"serve: router families: prefix-cache hit rate {rate:.4f} "
              f"({one('vllm:gpu_prefix_cache_hits_total'):.0f} / "
              f"{one('vllm:gpu_prefix_cache_queries_total'):.0f} tokens), "
              f"scheduling delay count {delay_n:.0f} sum "
              f"{one('tpu:scheduling_delay_seconds_sum'):.4f} s over "
              f"{finished:.0f} finished requests ({sent[0]} sent); staged "
              f"prefill hits {one('tpu:prefill_staged_hits_total'):.0f}, "
              f"misses {one('tpu:prefill_staged_misses_total'):.0f}, "
              f"chained chunks "
              f"{one('tpu:prefill_chained_chunks_total'):.0f}", flush=True)
        if not rate > 0:
            fail("serve: prefix-cache hit rate 0 after a repeated prompt")
        if not delay_n == finished == sent[0]:
            fail(f"serve: scheduling delay count {delay_n}, finished "
                 f"{finished}, sent {sent[0]} differ")
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        print(f"serve: since the reset: dispatches {report['dispatches']}, "
              f"launches {report['launches']}", flush=True)
        check_launches("serve", report["launches"], report["dispatches"])
    finally:
        stop_server(proc)
    print(f"serve: server exited with {proc.returncode}; log tail:\n"
          f"{log_tail(log_path, 8)}", flush=True)
    return report["launches"]


# -- decode-kernel phase -------------------------------------------------------
def decode_step_check(torch, pa, runner, prompts) -> float:
    """One ModelRunner.decode step of the 28-layer model over the same
    cache state on the ragged kernel, on paged_decode_attention, and on
    paged_decode_attention with a planted fault: a lane longer than one
    split walks its keys only up to the start of its last split, so the
    merge misses that split. Fails unless the sound step is within
    DECODE_LOGIT_REL_TOL of the ragged one (max|dlogit| / max|logit|)
    and the faulty step is not; returns the sound step's max|dlogit|."""
    bs = runner.block_size
    tables, nxt = [], 1
    for p in prompts:
        n = -(-(len(p) + 1) // bs)
        tables.append(list(range(nxt, nxt + n)))
        nxt += n
    for p, tb in zip(prompts, tables):
        runner.prefill(p, 0, tb, len(p))
    args = ([11 * (i + 1) for i in range(len(prompts))],
            [len(p) for p in prompts], tables,
            [len(p) + 1 for p in prompts])
    keys = pa.DECODE_SPLIT_KEYS
    assert runner.ragged_kernel and max(args[3]) > keys
    attn = runner._attn

    def skip_last_split(kind, q, layer, kc, vc, tables, ctx):
        ctx = torch.where(ctx > keys, (ctx - 1) // keys * keys, ctx)
        return attn(kind, q, layer, kc, vc, tables, ctx)

    ragged = runner.decode(*args)[:len(prompts)].float()
    runner.ragged_kernel = False
    try:
        dec = runner.decode(*args)[:len(prompts)].float()
        runner._attn = skip_last_split
        bad = runner.decode(*args)[:len(prompts)].float()
    finally:
        runner.ragged_kernel = True
        del runner._attn
    torch.cuda.synchronize()
    if not (torch.isfinite(ragged).all() and torch.isfinite(dec).all()):
        fail("decode phase: non-finite logits")
    top = float(ragged.abs().max())
    dmax = float((dec - ragged).abs().max())
    rel, bad_rel = dmax / top, float((bad - ragged).abs().max()) / top
    print(f"decode phase: one {runner.model_config.num_layers}-layer decode "
          f"step, {len(prompts)} lanes, ragged vs decode kernel: "
          f"max|dlogit|={dmax:.4f}, /max|logit|={rel:.3e} (max|logit| "
          f"{top:.3f}, tol {DECODE_LOGIT_REL_TOL}); with the last split "
          f"of the longest lane skipped: {bad_rel:.3e}", flush=True)
    if not rel <= DECODE_LOGIT_REL_TOL:
        fail(f"decode phase: logits differ by {rel:.3e} of max|logit|")
    if not bad_rel > DECODE_LOGIT_REL_TOL:
        fail(f"decode phase: a skipped split moves the logits by only "
             f"{bad_rel:.3e} of max|logit|: the tolerance cannot see it")
    return dmax


def near_tie_check(what: str, ref, other, gap_tol: float) -> int:
    """Greedy streams of two engines (outputs with top-2 logprobs) that
    sum in different orders may part only where `ref`'s top-2 logprob gap
    at the first differing step is below gap_tol; returns how many are
    equal."""
    n_same = 0
    for i, (r, d) in enumerate(zip(ref, other)):
        if r.token_ids == d.token_ids:
            n_same += 1
            continue
        k = next(k for k, (a, b) in enumerate(zip(r.token_ids, d.token_ids))
                 if a != b)
        top2 = r.logprobs[k]["top_logprobs"]
        gap = top2[0]["logprob"] - top2[1]["logprob"]
        print(f"{what}: request {i} diverges at step {k}: "
              f"{r.token_ids[k]} vs {d.token_ids[k]}, top-2 logprob gap "
              f"{gap:.4f} (passes below {gap_tol:.4f})", flush=True)
        if not gap < gap_tol:
            fail(f"{what}: request {i} diverges at step {k} with a top-2 "
                 f"gap of {gap:.4f} >= {gap_tol:.4f}")
    return n_same


def decode_phase(torch, pa) -> tuple[dict, float]:
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    prompts = [[(7 * i + 3 * j) % 256 + 1 for j in range(n)]
               for i, n in enumerate((5, 33, 97, 300))]
    sp = SamplingParams(max_tokens=12, temperature=0, ignore_eos=True,
                        logprobs=2)
    outs, counts, gap_tol = {}, {}, None
    for ragged in (True, False):
        eng = LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=256, max_num_seqs=4, seed=SEED,
            ragged_kernel=ragged, ragged_dispatch=ragged,
        ))
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        outs[ragged] = eng.generate(prompts, sp)
        torch.cuda.synchronize()
        print(f"decode phase: {'ragged' if ragged else 'decode'}-kernel "
              f"engine generated {len(prompts)} x {sp.max_tokens} tokens in "
              f"{time.perf_counter() - t0:.3f}s (host clock, prefill "
              "included)", flush=True)
        if not ragged:
            counts = pa.launch_counts()
        else:
            # the direct check, on this engine's weights after its run: a
            # greedy parting passes only below its largest logit change
            gap_tol = decode_step_check(torch, pa, eng.runner, prompts)
        del eng
        torch.cuda.empty_cache()
    n_same = near_tie_check("decode phase", outs[True], outs[False],
                            gap_tol)
    print(f"decode phase: --no-ragged-kernel engine launches {counts}; "
          f"{n_same}/{len(prompts)} greedy token sequences equal to the "
          "ragged-kernel engine's", flush=True)
    return counts, gap_tol


# -- pipeline phase ------------------------------------------------------------
def stage_readback_check(torch, runner) -> None:
    """Each stage_* buffer, read back once its copy event has fired,
    equals byte for byte what the unstaged dispatch builds from the same
    arguments; and a packed prefill dispatch consuming a staged buffer
    gives the unstaged dispatch's tokens and logits."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    bs = runner.block_size
    blocks = iter(range(400, 1 << 20))

    def table(n_tok):
        return [next(blocks) for _ in range(-(-n_tok // bs))]

    b = runner.config.max_num_seqs
    temps = np.zeros(b, np.float32)
    top_ps, top_ks = np.ones(b, np.float32), np.full(b, -1, np.int32)
    keys = np.stack([np.arange(b), np.full(b, 7)], 1).astype(np.uint32)
    # the prefill tables first: the packed prefill below writes through
    # them, so they stay inside the cache; the decode lanes' are only
    # read back
    chunks = [rng.integers(1, 250, size=n).tolist() for n in (512, 300, 77)]
    starts = [0, 64, 0]
    pf_tabs = [table(s + len(c)) for s, c in zip(starts, chunks)]
    assert max(max(t) for t in pf_tabs) < runner.num_blocks
    totals = [s + len(c) for s, c in zip(starts, chunks)]
    ctx = [int(c) for c in rng.integers(20, 900, size=b)]
    dec_tabs = [table(c + 16) for c in ctx]
    pos = [c - 1 for c in ctx]
    stop = (np.full(b, 2, np.int32), np.zeros(b, np.int32),
            np.full(b, 20, np.int32), None)
    # (temps, top_ps, top_ks, min_ps, keys)
    sampling = (np.zeros(3, np.float32), np.ones(3, np.float32),
                np.full(3, -1, np.int32), np.zeros(3, np.float32),
                np.zeros((3, 2), np.uint32))
    c_pad = runner._ctx_bucket(max(ctx) + 7)
    cases = {
        "stage_prefill": (
            runner.stage_prefill(chunks[0], 0, pf_tabs[0], totals[0]),
            runner._fill_prefill_pack(chunks[0], 0, pf_tabs[0],
                                      totals[0])[-1]),
        "stage_prefill_batch": (
            runner.stage_prefill_batch(chunks, starts, pf_tabs, totals,
                                       sampling=sampling),
            runner._fill_rows_prefill_pack(chunks, starts, pf_tabs, totals,
                                           sampling=sampling)[-1]),
        "stage_decode_multi": (
            runner.stage_decode_multi(pos, dec_tabs, ctx, 8, temps, top_ps,
                                      top_ks, keys, stop=stop),
            runner._fill_decode_pack(c_pad, 8, None, pos, dec_tabs, ctx,
                                     temps, top_ps, top_ks, keys, stop=stop,
                                     chained=True)),
        "stage_ragged": (
            runner.stage_ragged(chunks[1:], starts[1:], pf_tabs[1:],
                                totals[1:], None, pos, dec_tabs, ctx, 8,
                                temps, top_ps, top_ks, keys, stop=stop),
            runner._fill_ragged_rows_pack(
                chunks[1:], starts[1:], pf_tabs[1:], totals[1:], None,
                c_pad, None, pos, dec_tabs, ctx, 8, temps, top_ps, top_ks,
                keys, stop=stop, chained=True)[-1]),
    }
    for name, (h, want) in cases.items():
        h.event.synchronize()
        got = h.dev.cpu().numpy()
        same = got.dtype == want.dtype and got.shape == want.shape and (
            got.tobytes() == want.tobytes())
        print(f"pipeline phase: {name}: {got.size * 4} bytes read back after "
              f"the copy event, {'equal' if same else 'DIFFERENT'} to the "
              f"unstaged build", flush=True)
        if not same:
            fail(f"pipeline phase: the {name} buffer differs from the "
                 "unstaged dispatch's")
    h = runner.stage_prefill_batch(chunks, starts, pf_tabs, totals,
                                   sampling=sampling)
    tok_s, lg_s = runner.prefill_batch(chunks, starts, pf_tabs, totals,
                                       sampling=sampling, staged=h)
    tok_u, lg_u = runner.prefill_batch(chunks, starts, pf_tabs, totals,
                                       sampling=sampling)
    torch.cuda.synchronize()
    if not (torch.equal(tok_s[:3], tok_u[:3])
            and torch.equal(lg_s[:3], lg_u[:3])):
        fail("pipeline phase: a staged packed prefill differs from the "
             "unstaged one")
    print("pipeline phase: packed prefill on a staged buffer: tokens and "
          "logits equal to the unstaged dispatch's", flush=True)


def pipeline_phase(torch, pa, smi: str) -> None:
    """In process, 28 layers, bf16: a cold ~1500-token prompt alone chains
    its three 512-token chunks in one engine step with one fetch; the
    staged buffers read back equal the unstaged builds; and the prefill
    phase seconds of the same work on the default (staged) engine and on
    one with --no-prefill-pipeline --no-prefetch-decode."""
    from production_stack_tpu_torch.engine import llm_engine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    cold = [(5 * j) % 250 + 1 for j in range(LONG_PROMPT_TOKENS)]
    group = [[(13 * i + 3 * j) % 250 + 1 for j in range(700)]
             for i in range(4)]
    sp = SamplingParams(max_tokens=4, temperature=0, ignore_eos=True)
    for staged in (True, False):
        name = "staged" if staged else "unstaged"
        eng = llm_engine.LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
            prefill_pipeline=staged, prefetch_decode=staged,
        ))
        phase0 = dict(eng.runner.prefill_phase_s)
        pa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_request("cold", prompt_token_ids=cold, sampling_params=sp)
        fetches = []
        to_numpy = llm_engine._to_numpy
        llm_engine._to_numpy = lambda t: (fetches.append(1), to_numpy(t))[1]
        try:
            eng.step()
        finally:
            llm_engine._to_numpy = to_numpy
        d = eng.runner.dispatch_counts
        print(f"pipeline phase: {name} engine, first step on the cold "
              f"{LONG_PROMPT_TOKENS}-token prompt: {eng.last_step_kind}, "
              f"{d['prefill']} prefill forwards, chained chunks "
              f"{eng._pf_chained_chunks_total}, {len(fetches)} fetch(es)",
              flush=True)
        if staged and not (eng.last_step_kind == "prefill"
                           and d["prefill"] == 3
                           and eng._pf_chained_chunks_total == 2
                           and len(fetches) == 1):
            fail("pipeline phase: the cold prompt's three chunks did not "
                 "chain in one step with one fetch")
        while eng.has_unfinished():
            eng.step()
        for i, p in enumerate(group):
            eng.add_request(f"g{i}", prompt_token_ids=p, sampling_params=sp)
        while eng.has_unfinished():
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = {k: round(v - phase0[k], 4)
                  for k, v in eng.runner.prefill_phase_s.items()}
        print(f"pipeline phase: {name} engine, the cold prompt then 4 "
              f"x 700-token prompts: {wall:.3f} s wall, prefill phase "
              f"seconds {phases}, staged prefill hits "
              f"{eng._pf_staged_hits_total} misses "
              f"{eng._pf_staged_misses_total}, chained chunks "
              f"{eng._pf_chained_chunks_total} (host clock) on {smi}",
              flush=True)
        check_launches(f"pipeline phase, {name} engine", pa.launch_counts(),
                       eng.runner.dispatch_counts)
        if staged:
            stage_readback_check(torch, eng.runner)
        del eng
        torch.cuda.empty_cache()


# -- mixed-round phase ---------------------------------------------------------
def profile_step(torch, step) -> str:
    """One engine step under torch.profiler: its wall time, the device
    time of the CUDA kernels it ran (busy share of the wall) and the
    kernels taking most of it ("not measured" without device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            kern.append((us / 1e3, ev.count, ev.key))
    if not kern:
        return f"wall {wall_ms:.2f} ms, device time not measured"
    kern.sort(reverse=True)
    dev_ms = sum(k[0] for k in kern)
    top = "; ".join(f"{name[:60]} x{n} {ms:.3f} ms ({ms / dev_ms:.1%})"
                    for ms, n, name in kern[:8])
    return (f"wall {wall_ms:.2f} ms, device {dev_ms:.3f} ms in "
            f"{sum(k[1] for k in kern)} kernels (busy {dev_ms / wall_ms:.1%} "
            f"of the wall); top: {top}")


# this phase's reads before the prefill pipeline and the decode prefetch
# existed, printed beside this run's: wall ms per generated token at
# batch 8 by K, and a mixed round's wall ms at K=8 (NVIDIA H100 80GB
# HBM3, 700 W; another machine, so they set a scale, not a baseline)
UNSTAGED_MS_PER_TOKEN = {1: 6.501, 8: 5.478}
UNSTAGED_MIXED_ROUND_MS = 414.83


def mixed_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """In-process 28-layer engines serve the same staggered mix (four
    greedy requests, then a ~1500-token prompt while they decode): K=8
    with unified ragged rounds on the default config (prefill pipeline
    and decode prefetch on), the same without them, and a split K=1
    engine; then decode at batch 8. The two K=8 engines take their turns
    twice, in the order default, unstaged, unstaged, default, each turn
    on prompts of its own (the prefix cache would serve a repeat).
    Returns the default K=8 engine's launch counts over its turns."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    # 32 tokens: at K=8 the decode lanes take 1 + 8 (step 1) and then
    # ride all three of the long prompt's chunks (steps 2-4, the last
    # round exiting after 7 iterations)
    sp = SamplingParams(max_tokens=32, temperature=0, ignore_eos=True,
                        logprobs=2)
    bsp = SamplingParams(max_tokens=33, temperature=0, ignore_eos=True)
    default, unstaged, split = ("K=8 ragged default", "K=8 ragged unstaged",
                                "K=1 split")
    specs = {default: (8, True), unstaged: (8, False), split: (1, True)}
    engines = {
        name: LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=512, max_num_seqs=8, seed=SEED,
            num_scheduler_steps=k, ragged_dispatch=k > 1,
            prefill_pipeline=staged, prefetch_decode=staged,
        )) for name, (k, staged) in specs.items()
    }
    launches = {name: dict.fromkeys(("decode", "prefill", "ragged"), 0)
                for name in specs}
    outs: dict = {}

    def mix(name: str, turn: int, profile: bool) -> None:
        """The staggered mix on prompts of this turn; its streams, the
        wall of each mixed round, launches held to 28 a forward."""
        eng = engines[name]
        k = specs[name][0]
        prompts = [[(11 * i + 5 * j + 17 * turn) % 250 + 1 for j in range(n)]
                   for i, n in enumerate((17, 40, 64, 90))]
        long_prompt = [(3 * j + 7 * turn) % 250 + 1
                       for j in range(LONG_PROMPT_TOKENS)]
        pa.reset_launch_counts()
        runs0 = dict(eng.runner.dispatch_counts)
        st0 = eng.stats()
        for i, p in enumerate(prompts):
            eng.add_request(f"t{turn}d{i}", prompt_token_ids=p,
                            sampling_params=sp)
        finals, mixed_ms, step, prof = {}, [], 0, None
        t0 = time.perf_counter()
        while eng.has_unfinished():
            if step == 2:
                eng.add_request(f"t{turn}long", prompt_token_ids=long_prompt,
                                sampling_params=sp)
            before = eng.stats().ragged_rounds_total
            ts = time.perf_counter()
            if profile and step == 4:
                # the third mixed round, under the profiler (the first
                # two are timed without it)
                prof = profile_step(torch, lambda: finals.update(
                    {o.request_id: o for o in eng.step() if o.finished}))
            else:
                finals.update({o.request_id: o for o in eng.step()
                               if o.finished})
                torch.cuda.synchronize()
                if eng.stats().ragged_rounds_total > before:
                    mixed_ms.append((time.perf_counter() - ts) * 1e3)
            step += 1
        st = eng.stats()
        runs = {key: v - runs0[key]
                for key, v in eng.runner.dispatch_counts.items()}
        got = pa.launch_counts()
        for key in launches[name]:
            launches[name][key] += got[key]
        hist = {kk: n - st0.decode_k_hist.get(kk, 0)
                for kk, n in sorted(st.decode_k_hist.items())}
        n_mixed = st.ragged_rounds_total - st0.ragged_rounds_total
        what = f"mixed phase {name}, turn {turn}"
        print(f"{what}: {step} steps in {time.perf_counter() - t0:.3f}s "
              f"(host clock), {n_mixed} mixed rounds, decode K histogram "
              f"{hist}; dispatches {runs}", flush=True)
        check_launches(what, got, runs)
        if k > 1:
            if not (n_mixed > 0 and hist.get(8)):
                fail(f"{what}: no mixed round or no K=8 round ran")
            print(f"{what}: mixed-round wall ms "
                  f"{[round(x, 2) for x in mixed_ms]} (host clock, step() "
                  f"to synchronize; before staging: "
                  f"{UNSTAGED_MIXED_ROUND_MS} ms) on {smi}",
                  flush=True)
            if profile:
                print(f"{what}: one mixed round under torch.profiler: "
                      f"{prof or 'step 4 did not run'}", flush=True)
        outs[name, turn] = [finals[f"t{turn}{r}"]
                            for r in ("d0", "d1", "d2", "d3", "long")]

    def decode8(name: str, turn: int) -> None:
        """Decode at batch 8: wall ms per generated token."""
        eng = engines[name]
        k = specs[name][0]
        for i in range(8):
            eng.add_request(
                f"t{turn}b{i}", prompt_token_ids=[
                    (7 * i + j + 13 * turn) % 250 + 1 for j in range(32)],
                sampling_params=bsp)
        eng.step()  # the packed prefill: one token each
        torch.cuda.synchronize()
        gen0, t0 = eng.stats().generation_tokens_total, time.perf_counter()
        while eng.has_unfinished():
            eng.step()
        torch.cuda.synchronize()
        n_tok = eng.stats().generation_tokens_total - gen0
        ms = (time.perf_counter() - t0) * 1e3
        print(f"mixed phase {name}, turn {turn}: decode at batch 8: {n_tok} "
              f"tokens in {ms:.1f} ms = {ms / n_tok:.3f} wall ms per "
              f"generated token (host clock; before staging at K={k}: "
              f"{UNSTAGED_MS_PER_TOKEN[k]}) on {smi}", flush=True)

    turns = [(default, 0), (unstaged, 0), (unstaged, 1), (default, 1)]
    for name, turn in turns:
        mix(name, turn, profile=(name, turn) == (default, 0))
    mix(split, 0, profile=False)
    for name, turn in turns + [(split, 0)]:
        decode8(name, turn)
    for name, eng in engines.items():
        hits = {"decode": (eng._staged_hits_total, eng._staged_misses_total),
                "ragged": (eng._ragged_staged_hits_total,
                           eng._ragged_staged_misses_total),
                "prefill": (eng._pf_staged_hits_total,
                            eng._pf_staged_misses_total)}
        print(f"mixed phase {name}: staged (hits, misses) {hits}",
              flush=True)
        if name == default and not (hits["decode"][0] > 0
                                    and hits["ragged"][0] > 0):
            fail(f"mixed phase {name}: no staged decode or ragged round "
                 "was consumed")
    for other, turn in ((unstaged, 0), (unstaged, 1), (split, 0)):
        ref = outs[default, turn]
        n_same = near_tie_check(f"mixed phase (vs {other}, turn {turn})",
                                ref, outs[other, turn], gap_tol)
        print(f"mixed phase: {n_same}/{len(ref)} greedy token sequences of "
              f"the default K=8 engine equal to the {other} engine's "
              f"(turn {turn})", flush=True)
    del engines
    torch.cuda.empty_cache()
    return launches[default]


# -- families phase ------------------------------------------------------------
# published config.json of each model (Hugging Face Hub, the model's main
# revision; fields the loader does not read left out), cut to 2 layers
FAMILY_CONFIGS = {
    # Qwen/Qwen2-7B: 28 query heads over 4 kv heads (g = 7), qkv bias;
    # its sliding_window is off (use_sliding_window false)
    "Qwen2-7B": {
        "architectures": ["Qwen2ForCausalLM"], "hidden_act": "silu",
        "hidden_size": 3584, "intermediate_size": 18944,
        "max_position_embeddings": 131072, "max_window_layers": 28,
        "num_attention_heads": 28, "num_hidden_layers": 28,
        "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
        "rope_theta": 1000000.0, "sliding_window": 131072,
        "tie_word_embeddings": False, "use_sliding_window": False,
        "vocab_size": 152064},
    # mistralai/Mistral-7B-v0.1: a 4096-token sliding window
    "Mistral-7B-v0.1": {
        "architectures": ["MistralForCausalLM"], "hidden_act": "silu",
        "hidden_size": 4096, "intermediate_size": 14336,
        "max_position_embeddings": 32768, "num_attention_heads": 32,
        "num_hidden_layers": 32, "num_key_value_heads": 8,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
        "sliding_window": 4096, "tie_word_embeddings": False,
        "vocab_size": 32000},
    # meta-llama/Llama-3.2-1B: head_dim 64, tied embeddings
    "Llama-3.2-1B": {
        "architectures": ["LlamaForCausalLM"], "head_dim": 64,
        "hidden_act": "silu", "hidden_size": 2048,
        "intermediate_size": 8192, "max_position_embeddings": 131072,
        "num_attention_heads": 32, "num_hidden_layers": 16,
        "num_key_value_heads": 8, "rms_norm_eps": 1e-05,
        "rope_theta": 500000.0, "tie_word_embeddings": True,
        "vocab_size": 128256},
}
# google/gemma-7b: head_dim 256, which the card kernels do not take
GEMMA_7B = {
    "architectures": ["GemmaForCausalLM"], "head_dim": 256,
    "hidden_act": "gelu", "hidden_size": 3072, "intermediate_size": 24576,
    "max_position_embeddings": 8192, "num_attention_heads": 16,
    "num_hidden_layers": 28, "num_key_value_heads": 16,
    "rms_norm_eps": 1e-06, "rope_theta": 10000.0, "vocab_size": 256000}
FAMILY_LAYERS = 2
# the Mistral prompt past its window: ten prefill chunks of <= 512 rows
WINDOW_PROMPT_TOKENS = 5000


def tree_equal(torch, got: dict, want: dict) -> bool:
    """Same keys and, leaf for leaf, the same dtype, shape and bytes."""
    if sorted(got) != sorted(want):
        return False
    return all(
        tree_equal(torch, got[k], want[k]) if isinstance(want[k], dict)
        else (got[k].dtype == want[k].dtype
              and torch.equal(got[k], want[k]))
        for k in want)


def chunked_logits(torch, pa, cfg, params, n_tok: int, plain: bool,
                   window="cfg"):
    """The last row's logits of each <= 512-row prefill chunk of an
    n_tok-token prompt on the card, attention through the prefill kernel
    or (`plain`) its plain version, with the config's window (or
    `window`)."""
    from production_stack_tpu_torch.models import llama

    bs, chunk = 32, 512
    win = cfg.sliding_window if window == "cfg" else window
    pages = -(-n_tok // bs)
    shape = (cfg.num_layers, cfg.num_kv_heads, (pages + 1) * bs,
             cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")
    ids = torch.arange(n_tok, device="cuda") * 7919 % cfg.vocab_size
    fn = (pa.paged_prefill_attention_plain if plain
          else pa.paged_prefill_attention)
    out = []
    for s0 in range(0, n_tok, chunk):
        t = min(chunk, n_tok - s0)
        pos = torch.arange(s0, s0 + t, device="cuda")

        def attn(q, l, k, v, s0=s0):
            return fn(q, k, v, l, table, s0, block_size=bs,
                      scale=cfg.head_dim**-0.5, window=win)

        lg, _, _ = llama.forward(
            cfg, params, ids[s0:s0 + t], pos, kc, vc, pos + bs, attn,
            logits_rows=torch.tensor([t - 1], device="cuda"))
        out.append(lg)
    return torch.cat(out).float()


def families_phase(torch, pa, smi: str) -> None:
    """HF checkpoints of published configs at full width, cut to 2
    layers: written from seeded params (qkv biases drawn too), read back
    byte for byte through models/weights.py onto the card, logits held
    to the CPU, a short greedy run through an engine booted on the
    directory; the Mistral prompt past its window held to the plain
    attention on the card; Gemma-7B's head_dim 256 refused at boot."""
    import shutil
    import tempfile

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        write_hf_checkpoint,
    )
    from production_stack_tpu_torch.models.weights import load_hf_weights

    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="families-", dir=REPO / "build"))
    try:
        for i, (name, published) in enumerate(FAMILY_CONFIGS.items()):
            d = root / name
            d.mkdir()
            hf = dict(published, num_hidden_layers=FAMILY_LAYERS)
            (d / "config.json").write_text(json.dumps(hf))
            cfg = get_model_config(str(d))
            g_heads = cfg.num_heads // cfg.num_kv_heads
            gen = torch.Generator(device="cuda").manual_seed(SEED + i)
            params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
            if cfg.qkv_bias:
                for b in ("bq", "bk", "bv"):
                    params["layers"][b] = (torch.randn(
                        params["layers"][b].shape, generator=gen,
                        device="cuda") * 0.5).bfloat16()
            t0 = time.perf_counter()
            write_hf_checkpoint(str(d), hf, params)
            t1 = time.perf_counter()
            loaded = load_hf_weights(cfg, str(d), torch.bfloat16, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"families phase {name}: head_dim {cfg.head_dim}, g "
                  f"{g_heads}, window {cfg.sliding_window}, qkv bias "
                  f"{cfg.qkv_bias}, tied {cfg.tie_word_embeddings}, "
                  f"{FAMILY_LAYERS} layers: wrote {t1 - t0:.2f}s, loaded "
                  f"{t2 - t1:.2f}s", flush=True)
            if not tree_equal(torch, loaded, params):
                fail(f"families phase {name}: the loaded params differ "
                     "from the written ones")
            del params
            card_vs_cpu(torch, pa, f"families phase {name}", cfg, loaded)
            if cfg.sliding_window:
                kern = chunked_logits(torch, pa, cfg, loaded,
                                      WINDOW_PROMPT_TOKENS, plain=False)
                plain = chunked_logits(torch, pa, cfg, loaded,
                                       WINDOW_PROMPT_TOKENS, plain=True)
                full = chunked_logits(torch, pa, cfg, loaded,
                                      WINDOW_PROMPT_TOKENS, plain=False,
                                      window=None)
                torch.cuda.synchronize()
                top = float(plain.abs().max())
                rel = float((kern - plain).abs().max()) / top
                rel_full = float((full[-1] - plain[-1]).abs().max()) / top
                print(f"families phase {name}: a {WINDOW_PROMPT_TOKENS}-"
                      f"token prompt past the {cfg.sliding_window}-token "
                      f"window, last rows of {kern.shape[0]} chunks, "
                      f"kernel vs plain on the card max|d|/max|ref|="
                      f"{rel:.3e} tol={LOGIT_REL_TOL} (the same kernel "
                      f"without the window moves the last chunk's row by "
                      f"{rel_full:.3e})", flush=True)
                if not (torch.isfinite(kern).all() and rel <= LOGIT_REL_TOL):
                    fail(f"families phase {name}: windowed prompt logits "
                         f"differ by {rel:.3e}")
            del loaded
            torch.cuda.empty_cache()
            eng = LLMEngine(EngineConfig(
                model=str(d), tokenizer="byte", device="cuda",
                block_size=32, num_kv_blocks=64, max_num_seqs=4, seed=SEED))
            outs = eng.generate(
                [[(5 * j + i) % 250 + 1 for j in range(n)] for n in (9, 77)],
                SamplingParams(max_tokens=8, temperature=0,
                               ignore_eos=True))
            if [len(o.token_ids) for o in outs] != [8, 8]:
                fail(f"families phase {name}: engine on the checkpoint "
                     f"gave {[o.token_ids for o in outs]}")
            print(f"families phase {name}: engine booted on the "
                  f"directory, greedy tokens {[o.token_ids for o in outs]}",
                  flush=True)
            del eng
            shutil.rmtree(d)
            torch.cuda.empty_cache()
        d = root / "gemma-7b"
        d.mkdir()
        (d / "config.json").write_text(json.dumps(GEMMA_7B))
        try:
            LLMEngine(EngineConfig(model=str(d), tokenizer="byte",
                                   device="cuda", num_kv_blocks=64))
        except ValueError as e:
            if "gemma-7b" not in str(e) or "head_dim 256" not in str(e):
                fail(f"families phase: Gemma-7B refused without naming "
                     f"it: {e}")
            print(f"families phase: Gemma-7B refused at boot: {e}",
                  flush=True)
        else:
            fail("families phase: Gemma-7B (head_dim 256) booted on the "
                 "card")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- checkpoint phase ----------------------------------------------------------
class Stream:
    """A greedy stream read over HTTP: token ids (vLLM's
    return_tokens_as_token_ids) for near_tie_check."""

    def __init__(self, token_ids):
        self.token_ids = token_ids


def lora_weights(torch, cfg, rank: int, seed: int) -> dict:
    """Seeded adapter arrays for q/k/v/o, ours (L, in, r) / (L, r, out),
    bf16: with scaling 1 each moves its projection by about half the
    base projection's spread (A ~ N(0, 1/in), B ~ N(0, 1/(4 r)))."""
    g = torch.Generator().manual_seed(seed)
    h, L = cfg.hidden_size, cfg.num_layers
    dims = {"wq": (h, cfg.q_size), "wk": (h, cfg.kv_size),
            "wv": (h, cfg.kv_size), "wo": (cfg.q_size, h)}
    w = {}
    for t, (din, dout) in dims.items():
        w[f"{t}_A"] = (torch.randn((L, din, rank), generator=g)
                       * din**-0.5).bfloat16()
        w[f"{t}_B"] = (torch.randn((L, rank, dout), generator=g)
                       * 0.5 * rank**-0.5).bfloat16()
    return w


def merged_params(torch, params: dict, w: dict) -> dict:
    """The base params with W + A @ B (scaling 1) in every target,
    summed in f32 and rounded to bf16 once."""
    layers = dict(params["layers"])
    for t in ("wq", "wk", "wv", "wo"):
        delta = torch.bmm(w[f"{t}_A"].cuda().float(),
                          w[f"{t}_B"].cuda().float())
        layers[t] = (layers[t].float() + delta).bfloat16()
    return {**params, "layers": layers}


def all_row_logits(torch, pa, cfg, params, ids, lora=None, slot=None):
    """f32 logits of every row of one prompt (one prefill chunk on the
    prefill kernel), optionally with one adapter slot."""
    from production_stack_tpu_torch.models import llama

    bs, T = 32, len(ids)
    pages = -(-T // bs)
    shape = (cfg.num_layers, cfg.num_kv_heads, (pages + 1) * bs,
             cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")
    pos = torch.arange(T, device="cuda")

    def attn(q, l, k, v):
        return pa.paged_prefill_attention(q, k, v, l, table, 0,
                                          block_size=bs,
                                          scale=cfg.head_dim**-0.5)

    kw = {} if lora is None else {"lora": lora, "lora_slots": slot}
    lg, _, _ = llama.forward(cfg, params, torch.tensor(ids, device="cuda"),
                             pos, kc, vc, pos + bs, attn, logits_rows=pos,
                             **kw)
    return lg


# the checkpoint phase's long prompts: three prefill chunks each
LORA_LONG_PROMPT_TOKENS = 1100


def checkpoint_phase(torch, pa, gap_tol: float, smi: str) -> dict:
    """llama-3.2-3b at full width and depth as an HF checkpoint: written
    from seeded bf16 params (sharded as HF shards it), read back byte for
    byte, served by the CLI with --enable-lora; two PEFT adapters (rank
    16 and 8) loaded over HTTP; base and adapter requests sent at once,
    so prefill chunks and decode rows of different slots share ragged
    rounds. The base streams are held to an engine without LoRA, each
    adapter's to an engine on merged weights, under the near-tie rule;
    one in-process decode step shows a base lane's logits unchanged to
    the bit by the adapters beside it. Returns the served run's kernel
    launches."""
    import shutil
    import tempfile
    import urllib.error

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.lora import write_peft_adapter
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.models.debug_checkpoint import (
        hf_config_of,
        write_hf_checkpoint,
    )
    from production_stack_tpu_torch.models.weights import load_hf_weights

    cfg = get_model_config("llama-3.2-3b")
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt-", dir=REPO / "build"))
    ckdir = str(root / "llama-3.2-3b")
    proc = None
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
        t0 = time.perf_counter()
        # HF ships Llama-3.2-3B in two shards of <= 5 GB
        shards = write_hf_checkpoint(ckdir, hf_config_of(cfg), params,
                                     shard_bytes=5 * 10**9)
        t1 = time.perf_counter()
        loaded = load_hf_weights(get_model_config(ckdir), ckdir,
                                 torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        size = sum(os.path.getsize(p) for p in shards)
        print(f"checkpoint phase: wrote {len(shards)} shards, "
              f"{size / 1e9:.2f} GB, in {t1 - t0:.2f}s; load_hf_weights "
              f"onto the card in {load_s:.2f}s ({size / load_s / 1e9:.2f} "
              f"GB/s) on {smi}", flush=True)
        if not tree_equal(torch, loaded, params):
            fail("checkpoint phase: the loaded params differ from the "
                 "written ones")
        del loaded, params
        torch.cuda.empty_cache()

        ranks = {"ad16": 16, "ad8": 8}
        weights = {name: lora_weights(torch, cfg, r, SEED + r)
                   for name, r in ranks.items()}
        for name, r in ranks.items():
            write_peft_adapter(str(root / name), weights[name],
                               lora_alpha=float(r))  # scaling 1

        port = free_port()
        log_path = REPO / "build" / "chip_smoke_lora_serve.log"
        t0 = time.perf_counter()
        proc = start_server(port, log_path, model=ckdir, extra=(
            "--enable-lora", "--max-loras", "4", "--max-lora-rank", "16",
            "--num-scheduler-steps", "8"))
        boot = wait_healthy("checkpoint phase", proc, port, log_path, t0)
        print(f"checkpoint phase: --model <dir> --enable-lora server "
              f"healthy {boot:.1f}s after start (the load included) on "
              f"{smi}", flush=True)
        for name in ranks:
            st, body = http(port, "/v1/load_lora_adapter", {
                "lora_name": name, "lora_path": str(root / name)})
            if st != 200:
                fail(f"checkpoint phase: loading {name}: {body}")
        ids = [c["id"] for c in json.loads(http(port, "/v1/models")[1])[
            "data"]]
        if ids != [ckdir, "ad16", "ad8"]:
            fail(f"checkpoint phase: /v1/models lists {ids}")

        models = [None, "ad16", "ad8"]
        short = {m: [(9 * i + 5 * j) % 250 + 1 for j in range(20 + 7 * i)]
                 for i, m in enumerate(models)}
        long = {m: [(11 * i + 3 * j) % 250 + 1
                    for j in range(LORA_LONG_PROMPT_TOKENS)]
                for i, m in enumerate(models)}
        n_short, n_long = 40, 8

        def completion(ids, n, model):
            body = {"prompt": ids, "max_tokens": n, "temperature": 0,
                    "ignore_eos": True, "logprobs": 1,
                    "return_tokens_as_token_ids": True}
            if model is not None:
                body["model"] = model
            st, text = http(port, "/v1/completions", body)
            r = json.loads(text)
            toks = r["choices"][0]["logprobs"]["tokens"]
            if st != 200 or len(toks) != n:
                fail(f"checkpoint phase: bad completion {text[:300]}")
            return Stream([int(t.split(":")[1]) for t in toks])

        http(port, "/debug/kernel_launches", method="DELETE")
        rounds0 = metric(port, "tpu:ragged_rounds_total")
        gen0 = metric(port, "vllm:generation_tokens_total")
        t1 = time.perf_counter()
        with ThreadPoolExecutor(6) as ex:
            lanes = {m: ex.submit(completion, short[m], n_short, m)
                     for m in models}
            while metric(port, "vllm:generation_tokens_total") < gen0 + 3:
                if any(f.done() for f in lanes.values()):
                    fail("checkpoint phase: a decoding lane finished "
                         "before the long prompts were sent")
                time.sleep(0.01)
            longs = {m: ex.submit(completion, long[m], n_long, m)
                     for m in models}
            served = {("short", m): f.result() for m, f in lanes.items()}
            served.update({("long", m): f.result()
                           for m, f in longs.items()})
        rounds = metric(port, "tpu:ragged_rounds_total") - rounds0
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        print(f"checkpoint phase: 3 short + 3 long requests over base, "
              f"ad16 and ad8 in {time.perf_counter() - t1:.2f}s, "
              f"{rounds:.0f} mixed rounds; dispatches "
              f"{report['dispatches']}, launches {report['launches']}",
              flush=True)
        if not rounds > 0:
            fail("checkpoint phase: no mixed round served the adapters")
        check_launches("checkpoint phase", report["launches"],
                       report["dispatches"])
        st, body = http(port, "/v1/unload_lora_adapter",
                        {"lora_name": "ad8"})
        try:
            http(port, "/v1/completions", {"prompt": "x", "max_tokens": 2,
                                           "model": "ad8"})
            fail("checkpoint phase: a request for an unloaded adapter "
                 "was served")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                fail(f"checkpoint phase: unloaded adapter gave {e.code}")
        print(f"checkpoint phase: ad8 unloaded ({st}); a request naming it "
              "gets 404", flush=True)
        stop_server(proc)
        proc = None

        # references in process, on the same checkpoint
        sp = SamplingParams(max_tokens=n_short, temperature=0,
                            ignore_eos=True, logprobs=2)
        sp_long = SamplingParams(max_tokens=n_long, temperature=0,
                                 ignore_eos=True, logprobs=2)
        base_cfg = dict(model=ckdir, tokenizer="byte", device="cuda",
                        block_size=32, num_kv_blocks=512, max_num_seqs=8,
                        seed=SEED)

        def reference(eng, model):
            return [eng.generate([short[model]], sp)[0],
                    eng.generate([long[model]], sp_long)[0]]

        lora_eng = LLMEngine(EngineConfig(**base_cfg, enable_lora=True,
                                          max_loras=4, max_lora_rank=16))
        for name in ranks:
            lora_eng.load_lora(name, str(root / name))
        r = lora_eng.runner
        base_params = r.params
        # one decode step, lanes [base, ad16, base, ad8], with and without
        # the adapters: the base lanes' logits must not move by a bit
        prompts = [short[None], short["ad16"], long[None][:300],
                   short["ad8"]]
        tables, nxt = [], 1
        for p in prompts:
            n = -(-(len(p) + 1) // 32)
            tables.append(list(range(nxt, nxt + n)))
            nxt += n
        for p, tb in zip(prompts, tables):
            r.prefill(p, 0, tb, len(p))
        step = ([7, 7, 7, 7], [len(p) for p in prompts], tables,
                [len(p) + 1 for p in prompts])
        with_ad = r.decode(*step, lora_slots=[0, 1, 0, 2])[:4]
        without = r.decode(*step)[:4]
        moved = float((with_ad[[1, 3]] - without[[1, 3]]).abs().max())
        exact = torch.equal(with_ad[[0, 2]], without[[0, 2]])
        print(f"checkpoint phase: one decode step with lanes [base, ad16, "
              f"base, ad8]: base lanes bit-equal without the adapters "
              f"{exact}; the adapters move their lanes' logits by up to "
              f"{moved:.3f}", flush=True)
        if not exact or not moved > 0:
            fail("checkpoint phase: slot 0 did not add an exact zero, or "
                 "an adapter changed nothing")
        probe = long[None][:256]
        tols = {}
        for slot, name in enumerate(ranks, start=1):
            merged = merged_params(torch, base_params, weights[name])
            via_lora = all_row_logits(torch, pa, cfg, base_params, probe,
                                      r.lora_manager.buffers, slot)
            via_merge = all_row_logits(torch, pa, cfg, merged, probe)
            tols[name] = float((via_lora - via_merge).abs().max())
            del via_lora, via_merge
            m_eng = LLMEngine(EngineConfig(**base_cfg), params=merged)
            del merged
            refs = reference(m_eng, name)
            del m_eng
            torch.cuda.empty_cache()
            tol = max(gap_tol, tols[name])
            n_same = near_tie_check(
                f"checkpoint phase ({name} vs merged weights)", refs,
                [served["short", name], served["long", name]], tol)
            print(f"checkpoint phase: {name}: {n_same}/2 served greedy "
                  f"streams equal to the merged-weight engine's; LoRA vs "
                  f"merged forward over 256 rows max|dlogit| "
                  f"{tols[name]:.4f}, near-tie tolerance {tol:.4f}",
                  flush=True)
        del lora_eng, r, base_params
        torch.cuda.empty_cache()
        base_eng = LLMEngine(EngineConfig(**base_cfg))
        refs = reference(base_eng, None)
        del base_eng
        n_same = near_tie_check(
            "checkpoint phase (base vs no-LoRA engine)", refs,
            [served["short", None], served["long", None]], gap_tol)
        print(f"checkpoint phase: base: {n_same}/2 served greedy streams "
              "equal to the engine without LoRA's", flush=True)
    finally:
        if proc is not None:
            stop_server(proc)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return report["launches"]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (REPO / "production_stack_tpu_torch").is_dir():
        fail(f"no production_stack_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from production_stack_tpu_torch.ops import cuda_build
    from production_stack_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.load()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f}s (one "
          "nvcc per source, in parallel, and one link)", flush=True)
    for line in ptxas_report(lib.with_suffix(".log").read_text()):
        print(f"  ptxas {line}", flush=True)

    stats = kernel_phase(torch)
    forward_phase(torch)
    families_phase(torch, pa, smi)
    serve_counts = serve_phase()
    decode_counts, gap_tol = decode_phase(torch, pa)
    pipeline_phase(torch, pa, smi)
    mixed_counts = mixed_phase(torch, pa, gap_tol, smi)
    lora_counts = checkpoint_phase(torch, pa, gap_tol, smi)
    launches = {
        "ragged": serve_counts["ragged"],
        "prefill": serve_counts["prefill"],
        "decode": decode_counts["decode"],
    }
    print(f"launches: serve path {serve_counts}, decode path "
          f"{decode_counts}, mixed-round path {mixed_counts}, loaded "
          f"checkpoint with adapters {lora_counts}; a served "
          f"mixed round launches the ragged kernel {LAYERS_3B} times a "
          "forward (its step-0 forward and each further decode iteration)",
          flush=True)
    src = {"ragged": "production_stack_tpu_torch/csrc/paged_attention.cu",
           "prefill": "production_stack_tpu_torch/csrc/paged_prefill.cu",
           "decode": "production_stack_tpu_torch/csrc/paged_decode.cu"}
    replaces = {
        "ragged": "production_stack_tpu/ops/pallas_attention.py:500",
        "prefill": "production_stack_tpu/ops/pallas_attention.py:641",
        "decode": "production_stack_tpu/ops/pallas_attention.py:816",
    }
    names = {"ragged": "ragged_paged_attention",
             "prefill": "paged_prefill_attention",
             "decode": "paged_decode_attention"}
    kernels = []
    for kind, st in stats:
        kernels.append({
            "name": names[kind], "route": "cuda", "source": src[kind],
            "replaces": replaces[kind], "launches": launches[kind], **st,
        })
    zero = [k["name"] for k in kernels if k["launches"] < 1]
    print(json.dumps({"kernels": kernels}), flush=True)
    if zero:
        fail(f"kernels never launched on the main paths: {zero}")
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
