#!/usr/bin/env python3
"""Drive the PyTorch port (production_stack_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile csrc/paged_attention.cu with nvcc (route: plain C
   interface + ctypes) and print the compiler's register/shared-memory
   report;
2. kernels: random inputs from a seed at Llama-3.2-3B attention shapes
   (nq=24, nkv=8, d=128, bs=32, bf16, a 28-layer cache past 2^31
   elements) run through each kernel and its plain PyTorch version on
   the card, in bf16 and again in f32 on the same inputs; prints max
   error against the stated tolerance, the kernel's time, the plain
   version's, the least time the card could take (bound) and one PyTorch
   library call on the same function (SDPA over the gathered context) as
   a yardstick;
3. forward: the same random params through models/llama.forward on the
   CPU (plain versions) and on the card (kernels), 2 layers at full 3B
   width, bf16; logits held to a stated tolerance;
4. serve: the port's CLI (python -m production_stack_tpu_torch.engine)
   starts its OpenAI server on loopback with llama-3.2-3b (all 28
   layers, random bf16 weights, byte tokenizer) in a child process:
   /health, /v1/models, a greedy completion, a streamed completion, a
   chat request and 4 concurrent multi-chunk completions (packed prefill
   on the ragged kernel); checks token counts, finish reasons and usage;
5. decode kernel: an in-process LLMEngine with --no-ragged-kernel drives
   paged_decode_attention; its greedy tokens must equal those of a
   ragged-kernel engine with the same weights (the two kernels run the
   same page walk per decode row, so the outputs are bit-identical).

Launch counts are reset just before the serve phase's requests (through
the server's /debug/kernel_launches) and before the decode phase, and
read just after; a kernel launched 0 times on those paths fails the run.
The server's log goes to build/chip_smoke_serve.log. The last lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}.
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
# bf16: both round one f32 result once, so they differ by at most one
# bf16 step (<= 2^-7 of the row's largest value); 2^-6 is two steps.
# f32: summation order only; a row that saw one key too many or too few
# moves by ~1e-3 of its largest value at these context lengths.
BF16_REL_TOL = 2.0**-6
F32_REL_TOL = 1e-4
LOGIT_REL_TOL = 5e-2       # forward, max|dlogit| / max|logit|, bf16


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

    def dense_sdpa_inputs(rows_q, qpos, lane_of_row, window=None):
        """Gathered dense context for SDPA: (rows, nq, 1, d) queries over
        each row's lane context, with a boolean visibility mask."""
        C = P * bs
        slots_l = (tables_d.long()[:, :, None] * bs
                   + torch.arange(bs, device=dev)).reshape(len(lanes_ctx), C)
        lane_t = torch.tensor(lane_of_row, device=dev)
        k = k_cache[layer][:, slots_l[lane_t]].permute(1, 0, 2, 3)
        v = v_cache[layer][:, slots_l[lane_t]].permute(1, 0, 2, 3)
        kpos = torch.arange(C, device=dev)[None, :]
        qp = torch.tensor(qpos, device=dev)[:, None]
        mask = kpos <= qp
        if window is not None:
            mask &= kpos > qp - window
        k = k.repeat_interleave(g, dim=1).contiguous()
        v = v.repeat_interleave(g, dim=1).contiguous()
        return (rows_q[:, :, None, :].contiguous(), k, v,
                mask[:, None, None, :].contiguous())

    def visible_keys(qpos, window=None):
        return sum(
            min(p + 1, window) if window is not None else p + 1
            for p in qpos
        )

    def bound(n_rows, qpos, kv_tokens, window=None):
        kv_bytes = 2 * kv_tokens * nkv * d * 2
        qo_bytes = 2 * n_rows * nq * d * 2
        ops = 4 * visible_keys(qpos, window) * nq * d
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

    def check(name, kern, plain, rows_sel, lib_args, n_rows, qpos,
              kv_tokens, f32_args, window=None, iters=20):
        err = compare(f"{name} bf16", kern(), plain(), rows_sel,
                      BF16_REL_TOL)
        kern32, plain32 = f32_args
        compare(f"{name} f32", kern32(), plain32(), rows_sel, F32_REL_TOL)
        ms = time_cuda(torch, kern, iters, flush)
        plain_ms = time_cuda(torch, plain, 3, flush)
        q4, k4, v4, m4 = lib_args
        lib_ms = time_cuda(
            torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale),
            iters, flush,
        )
        bms, by = bound(n_rows, qpos, kv_tokens, window)
        print(f"kernel {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bms:.4f} ({by}) library_ms={lib_ms:.4f}",
              flush=True)
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}

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
        rows_t, dense_sdpa_inputs(q_r[rows_t], qpos_r, lane_r),
        len(covered), qpos_r, kv_tok,
        (ragged(pa.ragged_paged_attention, q_r32, k32, v32, 0),
         ragged(pa.ragged_paged_attention_plain, q_r32, k32, v32, 0)),
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

    # prefill: one 512-row chunk at q_start 1024 over 48 shuffled pages
    t, qs = 512, 1024
    n_pf = -(-(qs + t) // bs)
    pf_table = torch.from_numpy(perm[:n_pf].astype(np.int32)).to(dev)
    q_p = torch.randn((t, nq, d), generator=gen, device=dev, dtype=dt)
    qpos_p = [qs + i for i in range(t)]

    def sdpa_prefill():
        C = pf_table.numel() * bs
        sl = (pf_table.long()[:, None] * bs
              + torch.arange(bs, device=dev)).reshape(-1)
        k = k_cache[layer][:, sl].repeat_interleave(g, dim=0)[None]
        v = v_cache[layer][:, sl].repeat_interleave(g, dim=0)[None]
        mask = (torch.arange(C, device=dev)[None, :]
                <= torch.tensor(qpos_p, device=dev)[:, None])
        return (q_p.transpose(0, 1)[None].contiguous(), k.contiguous(),
                v.contiguous(), mask[None, None])

    q_p32 = q_p.float()
    pre = check(
        "paged_prefill_attention",
        lambda: pa.paged_prefill_attention(
            q_p, k_cache, v_cache, layer, pf_table, qs, **kw),
        lambda: pa.paged_prefill_attention_plain(
            q_p, k_cache, v_cache, layer, pf_table, qs, **kw),
        torch.arange(t, device=dev), sdpa_prefill(), t, qpos_p, qs + t,
        (lambda: pa.paged_prefill_attention(
            q_p32, k32, v32, 0, pf_table, qs, **kw),
         lambda: pa.paged_prefill_attention_plain(
            q_p32, k32, v32, 0, pf_table, qs, **kw)),
    )

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
        dense_sdpa_inputs(q_d, qpos_d, list(range(b))), b, qpos_d,
        sum(dec_ctx),
        (lambda: pa.paged_decode_attention(
            q_d32, k32, v32, 0, tab_d, ctx_d, **kw),
         lambda: pa.paged_decode_attention_plain(
            q_d32, k32, v32, 0, tab_d, ctx_d, **kw)),
    )
    del k_cache, v_cache, k32, v32, flush
    torch.cuda.empty_cache()
    return [("ragged", rag), ("prefill", pre), ("decode", dec)]


# -- forward phase -------------------------------------------------------------
def forward_phase(torch) -> None:
    import dataclasses

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_model_config
    from production_stack_tpu_torch.ops import paged_attention as pa

    cfg = dataclasses.replace(get_model_config("llama-3.2-3b"),
                              num_layers=2)
    bs, n_blocks = 32, 16
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params_cpu = llama.init_params(cfg, gen, torch.bfloat16, "cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    params_gpu = to(params_cpu, "cuda")
    scale = cfg.head_dim**-0.5
    t, first = 64, 40  # a 40-token prompt padded to a 64-row chunk

    def run(dev, params):
        shape = (cfg.num_layers, cfg.num_kv_heads, n_blocks * bs,
                 cfg.head_dim)
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
                                              block_size=bs, scale=scale)

        lg1, _, _ = llama.forward(
            cfg, params, toks, pos, kc, vc, slots, attn_pf,
            logits_rows=torch.tensor([first - 1], device=dev))
        # one decode step on the ragged kernel (single-row segment)
        blk = torch.tensor([0, 1], dtype=torch.int32, device=dev)
        meta = torch.tensor([[0, 0, 1, first]], dtype=torch.int32,
                            device=dev)

        def attn_dec(q, l, k, v):
            qp = torch.zeros((8,) + tuple(q.shape[1:]), dtype=q.dtype,
                             device=dev)
            qp[:1] = q
            return pa.ragged_paged_attention(
                qp, k, v, l, table[None, :], blk, meta, block_size=bs,
                scale=scale)[:1]

        lg2, _, _ = llama.forward(
            cfg, params, torch.tensor([5], device=dev),
            torch.tensor([first], device=dev), kc, vc,
            torch.tensor([bs + first], device=dev), attn_dec,
            logits_rows=torch.tensor([0], device=dev))
        return torch.cat([lg1, lg2]).float().cpu()

    ref = run("cpu", params_cpu)
    got = run("cuda", params_gpu)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("forward: non-finite logits on the card")
    rel = float((got - ref).abs().max() / ref.abs().max())
    print(f"forward llama-3.2-3b x2 layers bf16: logits {tuple(got.shape)} "
          f"max|d|/max|ref|={rel:.3e} tol={LOGIT_REL_TOL}", flush=True)
    if not rel <= LOGIT_REL_TOL:
        fail(f"forward: relative logit error {rel} > {LOGIT_REL_TOL}")
    del params_gpu
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


def start_server(port: int, log_path: Path) -> subprocess.Popen:
    """The port's CLI in a child process, as a user starts it."""
    cmd = [
        sys.executable, "-m", "production_stack_tpu_torch.engine",
        "--model", "llama-3.2-3b", "--tokenizer", "byte",
        "--block-size", "32", "--num-kv-blocks", "1024",
        "--max-num-seqs", "8", "--seed", str(SEED),
        "--host", "127.0.0.1", "--port", str(port),
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


def serve_phase() -> dict:
    port = free_port()
    log_path = REPO / "build" / "chip_smoke_serve.log"
    t0 = time.perf_counter()
    proc = start_server(port, log_path)
    try:
        while True:
            if proc.poll() is not None:
                fail(f"serve: server exited with {proc.returncode}:\n"
                     f"{log_tail(log_path)}")
            if time.perf_counter() - t0 > 600:
                fail(f"serve: server not healthy after 600 s:\n"
                     f"{log_tail(log_path)}")
            try:
                st, body = http(port, "/health", timeout=5)
                if st == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        print(f"serve: healthy {time.perf_counter() - t0:.1f}s after "
              "start", flush=True)
        assert json.loads(body)["status"] == "healthy", body
        card = json.loads(http(port, "/v1/models")[1])["data"][0]
        assert card["id"] == "llama-3.2-3b" and card["max_model_len"], card
        assert "kv_role" not in card or card["kv_role"] is None, card

        def completion(prompt, n, **extra):
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
        # prefill_batch forwards (ragged kernel on prefill segments)
        before = json.loads(http(port, "/debug/kernel_launches")[1])
        prompts = [(f"request {i}: " + "lorem ipsum dolor sit amet " * 45)
                   for i in range(4)]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(lambda p: completion(p, 24), prompts))
        report = json.loads(http(port, "/debug/kernel_launches")[1])
        packed = (report["dispatches"]["prefill_batch"]
                  - before["dispatches"]["prefill_batch"])
        print(f"serve: 4 concurrent completions in "
              f"{time.perf_counter() - t1:.2f}s, {packed} packed prefill "
              f"forwards; since the reset: dispatches "
              f"{report['dispatches']}, launches {report['launches']}",
              flush=True)
        if packed < 1:
            fail("serve: no packed prefill forward ran")
        metrics = http(port, "/metrics")[1]
        for gauge in ("vllm:num_requests_running",
                      "vllm:num_requests_waiting",
                      "vllm:gpu_cache_usage_perc"):
            if gauge not in metrics:
                fail(f"serve: /metrics lacks {gauge}")
    finally:
        stop_server(proc)
    print(f"serve: server exited with {proc.returncode}; log tail:\n"
          f"{log_tail(log_path, 8)}", flush=True)
    return report["launches"]


# -- decode-kernel phase -------------------------------------------------------
def decode_phase(torch, pa) -> dict:
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    prompts = [[(7 * i + 3 * j) % 256 + 1 for j in range(n)]
               for i, n in enumerate((5, 33, 97, 300))]
    sp = SamplingParams(max_tokens=12, temperature=0, ignore_eos=True)
    tokens = {}
    counts = {}
    for ragged in (True, False):
        eng = LLMEngine(EngineConfig(
            model="llama-3.2-3b", tokenizer="byte", device="cuda",
            block_size=32, num_kv_blocks=256, max_num_seqs=4, seed=SEED,
            ragged_kernel=ragged,
        ))
        pa.reset_launch_counts()
        outs = eng.generate(prompts, sp)
        torch.cuda.synchronize()
        if not ragged:
            counts = pa.launch_counts()
        tokens[ragged] = [o.token_ids for o in outs]
        del eng
        torch.cuda.empty_cache()
    same = tokens[True] == tokens[False]
    print(f"decode phase: --no-ragged-kernel engine launches {counts}; "
          f"greedy tokens equal to the ragged-kernel engine: {same}",
          flush=True)
    if not same:
        fail(f"decode phase: tokens differ {tokens}")
    return counts


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
    lib = cuda_build.build("paged_attention")
    cuda_build.load("paged_attention")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    stats = kernel_phase(torch)
    forward_phase(torch)
    serve_counts = serve_phase()
    decode_counts = decode_phase(torch, pa)
    launches = {
        "ragged": serve_counts["ragged"],
        "prefill": serve_counts["prefill"],
        "decode": decode_counts["decode"],
    }
    print(f"launches: serve path {serve_counts}, decode path "
          f"{decode_counts}", flush=True)
    src = "production_stack_tpu_torch/csrc/paged_attention.cu"
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
            "name": names[kind], "route": "cuda", "source": src,
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
