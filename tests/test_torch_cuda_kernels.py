"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither jax nor the JAX package, so it runs on a machine with a
card and PyTorch alone:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda

Here, without a card, the cases skip. The input builders are shared with
tests/test_torch_paged_attention.py, which holds the plain versions
against the Pallas kernels on the CPU.
"""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops import paged_attention as tpa

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None else t


def _cache_pair(rng, layers, nkv, slots, d):
    return (rng.randn(layers, nkv, slots, d).astype(np.float32),
            rng.randn(layers, nkv, slots, d).astype(np.float32))


def decode_case(seed, b=4, pages=4, bs=8, nkv=2, g=2, d=32, layers=2):
    rng = np.random.RandomState(seed)
    nq = nkv * g
    num_blocks = 1 + b * pages  # block 0 is the null/trash block
    kc, vc = _cache_pair(rng, layers, nkv, num_blocks * bs, d)
    q = rng.randn(b, nq, d).astype(np.float32)
    tables = rng.permutation(np.arange(1, num_blocks))[: b * pages]
    tables = tables.reshape(b, pages).astype(np.int32)
    ctx = rng.randint(1, pages * bs + 1, size=b).astype(np.int32)
    ctx[0] = pages * bs  # one lane ends exactly on a page boundary
    return q, kc, vc, tables, ctx


def prefill_case(seed, t=16, prefix_pages=2, bs=8, nkv=2, g=2, d=32,
                 layers=2):
    rng = np.random.RandomState(seed)
    nq = nkv * g
    q_start = prefix_pages * bs - 3  # starts mid-page
    total = q_start + t
    pages = -(-total // bs)
    num_blocks = 1 + pages + 2
    kc, vc = _cache_pair(rng, layers, nkv, num_blocks * bs, d)
    q = rng.randn(t, nq, d).astype(np.float32)
    table = rng.permutation(np.arange(1, num_blocks))[:pages].astype(np.int32)
    return q, kc, vc, table, q_start



# Ragged row spaces of RAGGED_TQ = 8 rows to a block: (blk_seg, seg_meta
# rows [lane, row0, n_rows, qpos0]). Positions start mid-page at block
# sizes 8 and 32.
RAGGED_LAYOUTS = {
    # a 16-row prefill chunk (2 blocks), a block of 4 single-row decode
    # segments (contexts 1, 9, 33, 70) and an idle segment, a block with
    # no segment
    "mixed": ([0, 1, 2, 7, 7],
              [[0, 0, 8, 37], [0, 0, 8, 45],
               [1, 0, 1, 0], [2, 1, 1, 8], [3, 2, 1, 32], [4, 3, 1, 69],
               [0, 4, 0, 0]]),
    # two lanes' segments sharing one row block (rows 0-2 and 3-7)
    "shared": ([0, 2, 3], [[0, 0, 3, 40], [1, 3, 5, 61], [2, 0, 8, 5]]),
    # segments clipped at the block's edges: rows 5.. run past tq, rows
    # ..2 of a segment whose row0 is -2
    "clipped": ([0, 2, 3], [[0, 5, 8, 30], [1, -2, 5, 50], [2, 0, 8, 90]]),
    # seg_meta rows past blk_seg[G] belong to no block and store nothing
    "trailing": ([0, 1, 2],
                 [[0, 0, 8, 20], [1, 0, 8, 44], [1, 0, 8, 3], [0, 2, 4, 60]]),
}
# (layout, block_size, nkv, g) of the ragged parity cases on the CPU (vs
# Pallas) and on the card (vs the plain version); g = 16 at nkv = 1 gives
# 128 fused rows a block, two 64-row kernel tiles a segment
RAGGED_CASES = [
    (layout, bs, 2, 3 if layout == "shared" else 2)
    for layout in RAGGED_LAYOUTS for bs in (8, 32)
] + [("mixed", 8, 1, 16), ("mixed", 32, 1, 16)]


def ragged_case(seed, layout="mixed", bs=8, nkv=2, g=2, d=32):
    """Random q, caches and per-lane page tables for RAGGED_LAYOUTS[layout]:
    (q, kc, vc, tables, blk_seg, seg_meta, rows), rows the rows some
    segment covers (the others are undefined in the kernel contract)."""
    rng = np.random.RandomState(seed)
    blk_seg, seg = (np.asarray(x, np.int32) for x in RAGGED_LAYOUTS[layout])
    tq = 8
    n_blk = len(blk_seg) - 1
    lanes = int(seg[:, 0].max()) + 1
    pages = max(-(-int(qpos0 + n) // bs) for _, _, n, qpos0 in seg)
    num_blocks = 1 + lanes * pages  # block 0 is the null/trash block
    kc, vc = _cache_pair(rng, 2, nkv, num_blocks * bs, d)
    tables = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    tables = tables.reshape(lanes, pages)
    q = rng.randn(n_blk * tq, nkv * g, d).astype(np.float32)
    rows = set()
    for i in range(n_blk):
        for _, row0, n, _ in seg[blk_seg[i]:blk_seg[i + 1]]:
            rows.update(range(i * tq + max(row0, 0),
                              i * tq + min(row0 + n, tq)))
    return q, kc, vc, tables, blk_seg, seg, sorted(rows)


# -- on the card -------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _run_case(kind, dev, dtype, d):
    """(kernel output, plain output, rows to compare) for one kernel."""
    kw = dict(block_size=8, scale=0.1)

    def put(*arrays):
        return [_t(x).to(dev, dtype) for x in arrays]

    if kind == "decode":
        q, kc, vc, tables, ctx = decode_case(11, d=d)
        args = put(q, kc, vc) + [1, _t(tables).to(dev), _t(ctx).to(dev)]
        return (tpa.paged_decode_attention(*args, **kw),
                tpa.paged_decode_attention_plain(*args, **kw),
                slice(None))
    if kind == "prefill":
        q, kc, vc, table, q_start = prefill_case(12, t=32, d=d)
        args = put(q, kc, vc) + [0, _t(table).to(dev), q_start]
        return (tpa.paged_prefill_attention(*args, **kw),
                tpa.paged_prefill_attention_plain(*args, **kw),
                slice(None))
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(13, d=d)
    args = put(q, kc, vc) + [1] + [_t(x).to(dev)
                                   for x in (tables, blk_seg, seg)]
    return (tpa.ragged_paged_attention(*args, window=7, **kw),
            tpa.ragged_paged_attention_plain(*args, window=7, **kw), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256])
def test_kernel_matches_plain_on_card(cuda_device, kind, dtype, d):
    # f32: summation order only; bf16: one output rounding (2^-6 at |x|<4)
    tol = 1e-5 if dtype == torch.float32 else 2**-6
    before = tpa.launch_counts()[kind]
    out, ref, rows = _run_case(kind, cuda_device, dtype, d)
    torch.cuda.synchronize()
    assert tpa.launch_counts()[kind] == before + 1
    torch.testing.assert_close(out[rows].float(), ref[rows].float(), rtol=0,
                               atol=tol)


def _assert_rel(out, ref, rel):
    """|out - ref| <= rel * max|ref| per (row, head), over d."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    tol = rel * r.abs().amax(dim=-1, keepdim=True)
    worst = float((err / tol.clamp_min(1e-30)).max())
    assert worst <= 1.0, f"worst err / tol = {worst:.3f}"


# f32: summation order only. bf16: the prefill kernel rounds P to bf16
# for the tensor-core PV product and both round the output once; the
# card check's per-(row, head) tolerance.
_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}


@pytest.mark.cuda
@pytest.mark.parametrize("bs,d", [(8, 64), (8, 128), (32, 64), (32, 128),
                                  (8, 256), (32, 256)])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_many_splits(cuda_device, bs, d, window, dtype):
    """Contexts up to 2048 keys: up to 2048 / DECODE_SPLIT_KEYS splits per
    sequence merged by the second kernel, a context ending on a split
    boundary, and with a window whole splits left empty."""
    q, kc, vc, tables, ctx = decode_case(17, b=5, pages=2048 // bs, bs=bs,
                                         g=3, d=d)
    ctx[1], ctx[2], ctx[3] = tpa.DECODE_SPLIT_KEYS, 1, 700
    args = [_t(x).to(cuda_device, dtype) for x in (q, kc, vc)]
    args += [1, _t(tables).to(cuda_device), _t(ctx).to(cuda_device)]
    kw = dict(block_size=bs, scale=d**-0.5, window=window)
    before = tpa.launch_counts()["decode"]
    out = tpa.paged_decode_attention(*args, **kw)
    ref = tpa.paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launch_counts()["decode"] == before + 1
    assert tpa._decode_split_plan(tables.shape[1], bs)[1] == 2048 // 256
    _assert_rel(out, ref, _REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 8, 12, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256])
def test_decode_kernel_head_groups(cuda_device, g, dtype, d):
    """1 to 16 query heads per kv head fill the kernel's 16-row tile (rows
    8..15 hold heads only from g = 9); at head_dim 256 too (Gemma-7B's
    g = 1, Gemma-2B's g = 8)."""
    q, kc, vc, tables, ctx = decode_case(21, b=3, pages=1024 // 16, bs=16,
                                         nkv=2, g=g, d=d)
    args = [_t(x).to(cuda_device, dtype) for x in (q, kc, vc)]
    args += [0, _t(tables).to(cuda_device), _t(ctx).to(cuda_device)]
    kw = dict(block_size=16, scale=0.088, window=300)
    out = tpa.paged_decode_attention(*args, **kw)
    ref = tpa.paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_rel(out, ref, _REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [40, 72])
@pytest.mark.parametrize("bs,d", [(8, 64), (32, 128), (8, 128), (32, 64),
                                  (8, 256), (32, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_partial_tiles(cuda_device, t, bs, d, dtype):
    """t * g fused rows not a multiple of the 64-row tile (the last tile
    is partly filled), q_start mid-page, g = 3 (tiles cut query rows)."""
    q, kc, vc, table, q_start = prefill_case(
        18, t=t, prefix_pages=300 // bs, bs=bs, g=3, d=d)
    args = [_t(x).to(cuda_device, dtype) for x in (q, kc, vc)]
    args += [0, _t(table).to(cuda_device), q_start]
    kw = dict(block_size=bs, scale=d**-0.5)
    out = tpa.paged_prefill_attention(*args, **kw)
    ref = tpa.paged_prefill_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_rel(out, ref, _REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 50, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_window(cuda_device, window, dtype):
    q, kc, vc, table, q_start = prefill_case(19, t=72, prefix_pages=40,
                                             bs=8, g=3, d=128)
    args = [_t(x).to(cuda_device, dtype) for x in (q, kc, vc)]
    args += [1, _t(table).to(cuda_device), q_start]
    kw = dict(block_size=8, scale=0.09, window=window)
    out = tpa.paged_prefill_attention(*args, **kw)
    ref = tpa.paged_prefill_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_rel(out, ref, _REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("layout,bs,nkv,g", RAGGED_CASES)
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256])
def test_ragged_kernel_layouts(cuda_device, layout, bs, nkv, g, window,
                               dtype, d):
    """Segments sharing a row block, clipped at its edges, past
    blk_seg[G], two kernel tiles to a segment (g = 16), windows that skip
    the first pages: one launch, kernel against plain on covered rows."""
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(
        24, layout, bs=bs, nkv=nkv, g=g, d=d)
    args = [_t(x).to(cuda_device, dtype) for x in (q, kc, vc)]
    args += [1] + [_t(x).to(cuda_device) for x in (tables, blk_seg, seg)]
    kw = dict(block_size=bs, scale=d**-0.5, window=window)
    before = tpa.launch_counts()["ragged"]
    out = tpa.ragged_paged_attention(*args, **kw)
    ref = tpa.ragged_paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launch_counts()["ragged"] == before + 1
    _assert_rel(out[rows], ref[rows], _REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("d", [64, 256])
def test_mixed_dtypes_take_the_fma_path(cuda_device, q_dtype, cache_dtype,
                                        d):
    """q and cache of different types: the f32 CUDA-core path of the three
    kernels (same ring and masks; 32-key tiles at head_dim 256); output in
    q's type."""
    q, kc, vc, tables, ctx = decode_case(22, b=3, pages=64, bs=8, g=3, d=d)
    args = [_t(q).to(cuda_device, q_dtype)]
    args += [_t(x).to(cuda_device, cache_dtype) for x in (kc, vc)]
    args += [1, _t(tables).to(cuda_device), _t(ctx).to(cuda_device)]
    kw = dict(block_size=8, scale=0.125)
    out = tpa.paged_decode_attention(*args, **kw)
    ref = tpa.paged_decode_attention_plain(*args, **kw)
    q, kc, vc, table, q_start = prefill_case(23, t=40, prefix_pages=30,
                                             bs=8, g=3, d=d)
    pargs = [_t(q).to(cuda_device, q_dtype)]
    pargs += [_t(x).to(cuda_device, cache_dtype) for x in (kc, vc)]
    pargs += [0, _t(table).to(cuda_device), q_start]
    pout = tpa.paged_prefill_attention(*pargs, **kw)
    pref = tpa.paged_prefill_attention_plain(*pargs, **kw)
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(25, "shared", g=3,
                                                        d=d)
    rargs = [_t(q).to(cuda_device, q_dtype)]
    rargs += [_t(x).to(cuda_device, cache_dtype) for x in (kc, vc)]
    rargs += [1] + [_t(x).to(cuda_device) for x in (tables, blk_seg, seg)]
    rout = tpa.ragged_paged_attention(*rargs, **kw)
    rref = tpa.ragged_paged_attention_plain(*rargs, **kw)
    torch.cuda.synchronize()
    assert out.dtype == pout.dtype == rout.dtype == q_dtype
    _assert_rel(out, ref, _REL[q_dtype])
    _assert_rel(pout, pref, _REL[q_dtype])
    _assert_rel(rout[rows], rref[rows], _REL[q_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96])
def test_card_wrappers_reject_unbuilt_shapes(cuda_device, d):
    """head_dims the kernels lack (Phi-3-mini's 96 among them) raise
    before any launch; 256 is built (the cases above)."""
    q, kc, vc, tables, ctx = decode_case(20, d=d)
    args = [_t(x).to(cuda_device) for x in (q, kc, vc)]
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode_attention(
            *args, 0, _t(tables).to(cuda_device), _t(ctx).to(cuda_device),
            block_size=8, scale=0.1)
    q, kc, vc, tables, blk_seg, seg, _ = ragged_case(20, d=d)
    args = [_t(x).to(cuda_device) for x in (q, kc, vc, tables, blk_seg, seg)]
    with pytest.raises(ValueError, match="head_dim"):
        tpa.ragged_paged_attention(*args[:3], 0, *args[3:], block_size=8,
                                   scale=0.1)


@pytest.mark.cuda
def test_matmul_f32_on_card_keeps_the_f32_accumulator(cuda_device):
    """bf16 GEMM with a float32 output against the float32 product of the
    same (widened) operands: summation order only, far below the 2^-8
    relative step a bf16-rounded output would show."""
    from production_stack_tpu_torch.ops.layers import matmul_f32

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((64, 3072), generator=g, device=cuda_device)
    w = torch.randn((3072, 1024), generator=g, device=cuda_device) * 0.02
    xb, wb = x.bfloat16(), w.bfloat16()
    ref = xb.double() @ wb.double()
    got = matmul_f32(xb, wb)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_card_wrapper_rejects_host_metadata(cuda_device):
    q, kc, vc, tables, ctx = decode_case(14, d=64)
    args = [_t(x).to(cuda_device) for x in (q, kc, vc)]
    with pytest.raises(ValueError, match="CPU or all on one"):
        tpa.paged_decode_attention(*args, 0, _t(tables), _t(ctx),
                                   block_size=8, scale=0.1)


@pytest.mark.cuda
def test_staged_buffers_on_busy_streams(cuda_device, monkeypatch):
    """The staged copies of the prefill pipeline and the decode prefetch
    run on the runner's side stream: a buffer consumed right after
    stage_* — with the compute stream busy, and with the copy queued
    behind a large transfer so that only the event orders it — gives the
    unstaged dispatch's tokens and logits, and a handle dropped with its
    copy in flight leaves the next dispatch correct."""
    import dataclasses

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.models.config import get_model_config

    small = dataclasses.replace(get_model_config("pst-tiny-debug"),
                                num_heads=4, num_kv_heads=2, head_dim=64,
                                hidden_size=256)
    monkeypatch.setattr(EngineConfig, "model_config", lambda self: small)
    cfg = EngineConfig(model="pst-tiny-debug", tokenizer="byte",
                       dtype="float32", cache_dtype="float32", block_size=8,
                       num_kv_blocks=64, max_num_seqs=4, max_prefill_chunk=64,
                       num_scheduler_steps=4, device="cuda")
    staged, ref = ModelRunner(cfg), ModelRunner(cfg)
    rng = np.random.RandomState(40)
    big = torch.empty(64 * 2**20, dtype=torch.float32).pin_memory()

    def hold_back_copies():
        """The compute stream busy, and the copy stream busy with 256 MB
        ahead of whatever is staged next."""
        x = torch.randn((2048, 2048), device=cuda_device)
        for _ in range(8):
            x = x @ x * 1e-3
        staged._stage(None, np.zeros(1, np.int32))  # makes the stream
        with torch.cuda.stream(staged._copy_stream):
            big.to(cuda_device, non_blocking=True)

    ids = rng.randint(0, 384, size=40).tolist()
    args = (ids, 0, [1, 2, 3, 4, 5], len(ids))
    hold_back_copies()
    h = staged.stage_prefill(*args)
    tok, logits = staged.prefill(*args, staged=h)
    want_tok, want_logits = ref.prefill(*args)
    torch.cuda.synchronize()
    assert int(tok) == int(want_tok)
    assert torch.equal(logits, want_logits)

    # a dropped stage: its pinned source stays held until its copy is done
    hold_back_copies()
    dropped = staged.stage_prefill(*args)
    held = dropped.host.data_ptr()
    del dropped
    assert any(src.data_ptr() == held for _, src in staged._inflight)
    args2 = (ids[:17], 0, [6, 7, 8], 17)
    tok, logits = staged.prefill(*args2)
    want_tok, want_logits = ref.prefill(*args2)
    torch.cuda.synchronize()
    assert int(tok) == int(want_tok) and torch.equal(logits, want_logits)

    # a chained fused decode round on a staged buffer
    tables, pos, ctx = [[1, 2, 3, 4, 5, 9, 10]], [40], [41]
    sampling = (np.zeros(1, np.float32), np.ones(1, np.float32),
                np.full(1, -1, np.int32), np.zeros((1, 2), np.uint32))
    first = staged.decode_multi([int(tok)], pos, tables, ctx, 4, *sampling)
    ref.decode_multi([int(tok)], pos, tables, ctx, 4, *sampling)
    nxt = ([44], tables, [45])
    hold_back_copies()
    h = staged.stage_decode_multi(*nxt, 4, *sampling)
    got = staged.decode_multi(first[-1], *nxt, 4, *sampling, staged=h)
    want = ref.decode_multi([int(first[-1][0])], *nxt, 4, *sampling)
    assert torch.equal(got[:, 0].cpu(), want[:, 0].cpu())


@pytest.mark.cuda
def test_safetensors_bf16_round_trip_through_the_card(cuda_device,
                                                      tmp_path):
    """A bf16 tensor written from the card and read back onto it through
    models/safetensors_io.py comes back bit for bit."""
    from production_stack_tpu_torch.models import safetensors_io

    g = torch.Generator(device=cuda_device).manual_seed(0)
    t = torch.randn((3, 1024, 129), generator=g,
                    device=cuda_device).bfloat16()
    path = str(tmp_path / "t.safetensors")
    safetensors_io.save_file({"t": t, "tt": t[0].t()}, path)
    got = {k: v.to(cuda_device) for k, v in
           safetensors_io.load_file(path).items()}
    assert got["t"].dtype == torch.bfloat16
    assert torch.equal(got["t"], t) and torch.equal(got["tt"], t[0].t())


@pytest.mark.cuda
def test_per_token_lora_projection_on_card(cuda_device):
    """One per-token LoRA projection (llama.lora_delta over every slot
    at once) at 3B widths in bf16 on the card, held to its value on the
    CPU: float32 accumulations in another order only."""
    from production_stack_tpu_torch.models import llama

    g = torch.Generator().manual_seed(0)
    n, din, dout, S, r = 96, 3072, 1024, 5, 16
    x = torch.randn((n, din), generator=g).bfloat16()
    A = (torch.randn((1, S, din, r), generator=g) * 0.02).bfloat16()
    B = (torch.randn((1, S, r, dout), generator=g) * 0.02).bfloat16()
    A[:, 0] = 0
    B[:, 0] = 0
    scaling = torch.tensor([0.0, 2.0, 1.0, 0.5, 0.25])
    slots = torch.randint(0, S, (n,), generator=g)

    def delta(dev):
        w = llama.lora_row_weights(scaling.to(dev), slots.to(dev))
        lz = {"wq_A": A.to(dev).permute(0, 2, 1, 3).flatten(2)[0],
              "wq_B": B.to(dev)[0], "scaling": scaling.to(dev)}
        return llama.lora_delta(x.to(dev), (lz, w), "wq").cpu()

    ref, got = delta("cpu"), delta(cuda_device)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(got[slots == 0], torch.zeros_like(got[slots == 0]))


def _kv_runner(monkeypatch, cache_dtype, device):
    """A runner at a narrow width (head_dim 64) on `device`."""
    import dataclasses

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.models.config import get_model_config

    small = dataclasses.replace(get_model_config("pst-tiny-debug"),
                                num_heads=4, num_kv_heads=2, head_dim=64,
                                hidden_size=256)
    monkeypatch.setattr(EngineConfig, "model_config", lambda self: small)
    return ModelRunner(EngineConfig(
        model="pst-tiny-debug", tokenizer="byte", dtype="float32",
        cache_dtype=cache_dtype, block_size=32, num_kv_blocks=64,
        device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_kv_export_import_byte_equal_on_card(cuda_device, monkeypatch,
                                             cache_dtype):
    """KV blocks exported from the card (gather on the compute stream,
    d2h into pinned memory on the export stream) equal the CPU runner's
    export of the same cache byte for byte; imported into other blocks
    through the staged upload they read back byte-equal, and the
    serialized bytes round-trip."""
    from production_stack_tpu_torch.kv import offload

    card = _kv_runner(monkeypatch, cache_dtype, "cuda")
    host = _kv_runner(monkeypatch, cache_dtype, "cpu")
    g = torch.Generator().manual_seed(1)
    for c in ("k_cache", "v_cache"):
        x = torch.randn(getattr(host, c).shape, generator=g)
        getattr(host, c).copy_(x)
        getattr(card, c).copy_(x)
    bids = [5, 1, 33, 17, 2, 60]
    data = card.export_blocks(bids)
    assert data.is_pinned() and data.dtype == card.cache_dtype
    want = host.export_blocks(bids)
    assert torch.equal(data, want)
    dst = [40, 41, 42, 50, 51, 52]
    wire = offload.deserialize_block(offload.serialize_block(data))
    card.import_blocks(dst, wire)
    assert torch.equal(card.export_blocks(dst), want)
    h = card.stage_import_blocks(wire)
    card.import_staged_blocks([7, 8], h, [3, 0])
    back = card.export_blocks([7, 8])
    assert torch.equal(back[:, :, 0], want[:, :, 3])
    assert torch.equal(back[:, :, 1], want[:, :, 0])


@pytest.mark.cuda
def test_export_from_a_second_thread_keeps_the_snapshot(cuda_device,
                                                        monkeypatch):
    """A PD pull enqueues the export from an executor thread whose
    current stream is another one, while the compute stream is busy; the
    step thread then overwrites the same slots. The gather runs on the
    runner's compute stream by name, so it is ordered before the write:
    the snapshot holds the old values."""
    import threading

    r = _kv_runner(monkeypatch, "bfloat16", "cuda")
    g = torch.Generator().manual_seed(2)
    r.k_cache.copy_(torch.randn(r.k_cache.shape, generator=g))
    r.v_cache.copy_(torch.randn(r.v_cache.shape, generator=g))
    bids = [3, 4, 9]
    old = r.export_blocks(bids)
    slots = torch.cat([torch.arange(b * 32, (b + 1) * 32) for b in bids])
    box = {}

    def pull():
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            box["handle"] = r.stage_export_blocks(bids)

    with r.on_compute_stream():
        x = torch.randn((4096, 4096), device=cuda_device)
        for _ in range(16):  # keep the compute stream busy
            x = x @ x * 1e-3
        th = threading.Thread(target=pull)
        th.start()
        th.join()
        r.k_cache[:, :, slots.to(cuda_device)] = 7.0
        r.v_cache[:, :, slots.to(cuda_device)] = -7.0
    got = {}
    th = threading.Thread(
        target=lambda: got.setdefault(
            "data", r.materialize_export(box["handle"])))
    th.start()
    th.join()
    assert torch.equal(got["data"], old)
    now = r.export_blocks(bids)
    assert bool((now[0] == 7.0).all()) and bool((now[1] == -7.0).all())


# -- guided DFA lanes and prompt logprobs on the card -------------------------
GUIDED_CASES = {
    "json": {"guided_json": {
        "type": "object",
        "properties": {"age": {"type": "integer"},
                       "mood": {"enum": ["happy", "sad"]}},
        "required": ["age", "mood"]}},
    "regex": {"guided_regex": r"(yes|no), [0-9]{2}"},
    "choice": {"guided_choice": ["alpha", "beta", "betamax"]},
}


def _small_engine(monkeypatch, device, params, eager=False, **over):
    """An engine at a narrow width (head_dim 64, the card kernels' least)
    on `device`, on the given params (`eager`: the runner's control)."""
    import dataclasses

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.models.config import get_model_config

    small = dataclasses.replace(get_model_config("pst-tiny-debug"),
                                num_heads=4, num_kv_heads=2, head_dim=64,
                                hidden_size=256)
    monkeypatch.setattr(EngineConfig, "model_config", lambda self: small)
    cfg = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
               cache_dtype="float32", block_size=32, num_kv_blocks=64,
               max_num_seqs=4, seed=0, device=device)
    return LLMEngine(EngineConfig(**{**cfg, **over}), params=params,
                     eager=eager)


def _small_params(monkeypatch, dtype=torch.float32):
    from production_stack_tpu_torch.models import llama

    eng = _small_engine(monkeypatch, "cpu", None)
    gen = torch.Generator().manual_seed(3)
    return llama.init_params(eng.runner.model_config, gen, dtype, "cpu")


def _guided_streams(eng):
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    sps = [SamplingParams(max_tokens=48, temperature=0.0, **kw)
           for kw in GUIDED_CASES.values()]
    sps.append(SamplingParams(max_tokens=20, temperature=0.0,
                              ignore_eos=True))
    prompts = [[3, 4, 5], [9, 8, 7, 6], [1, 2], [40, 41, 42, 43, 44]]
    return [o.token_ids for o in eng.generate(prompts, sps)]


@pytest.mark.cuda
def test_guided_dfa_lanes_on_card_equal_cpu(cuda_device, monkeypatch):
    """K=8 with three guided lanes beside a free one, f32: the fused
    rounds' DFA mask and state step on the card give the CPU run's
    streams, and they did run on the device tables."""
    params = _small_params(monkeypatch)
    card = _small_engine(monkeypatch, "cuda", params, num_scheduler_steps=8)
    got = _guided_streams(card)
    assert card.runner.guided_rounds > 0
    want = _guided_streams(_small_engine(monkeypatch, "cpu", params,
                                         num_scheduler_steps=8))
    assert got == want


@pytest.mark.cuda
def test_guided_k8_on_card_equals_k1_host_mask(cuda_device, monkeypatch):
    """On the card, K=8 device lanes give the K=1 host-masked streams."""
    params = _small_params(monkeypatch)
    k8 = _small_engine(monkeypatch, "cuda", params, num_scheduler_steps=8)
    k1 = _small_engine(monkeypatch, "cuda", params, num_scheduler_steps=1)
    assert _guided_streams(k8) == _guided_streams(k1)
    assert k8.runner.guided_rounds > 0 and k1.runner.guided_rounds == 0


@pytest.mark.cuda
def test_prompt_logprobs_on_card_match_one_shot(cuda_device, monkeypatch):
    """bf16: a 100-token prompt's prompt logprobs in 32-row chunks (the
    single-sequence prefill scoring every row on the card) against the
    log-softmax of one forward over the whole prompt, within 5e-2 of
    max|logit| (the bf16 forward tolerance of chip_smoke.py)."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import llama

    params = _small_params(monkeypatch, torch.bfloat16)
    eng = _small_engine(monkeypatch, "cuda", params, dtype="bfloat16",
                        cache_dtype="bfloat16", max_prefill_chunk=32)
    ids = [(7 * j + 3) % 250 + 1 for j in range(100)]
    out = eng.generate([ids], SamplingParams(
        max_tokens=1, temperature=0.0, prompt_logprobs=5))[0]
    r = eng.runner
    mc = r.model_config
    kc = torch.zeros_like(r.k_cache)
    vc = torch.zeros_like(r.v_cache)
    # the kernel takes whole 8-row tiles: 4 pad rows after the prompt
    # (causal, so they change no real row)
    pos = torch.arange(104, device=cuda_device)
    table = torch.arange(1, 5, dtype=torch.int32, device=cuda_device)

    def attn(q, l, k, v):
        return tpa.paged_prefill_attention(q, k, v, l, table, 0,
                                           block_size=32,
                                           scale=mc.head_dim**-0.5)

    logits, _, _ = llama.forward(mc, r.params,
                                 torch.tensor(ids + [0] * 4,
                                              device=cuda_device), pos,
                                 kc, vc, pos + 32, attn, logits_rows=pos)
    logits = logits[:len(ids)]
    lp = torch.log_softmax(logits, dim=-1).cpu()
    top = float(logits.abs().max())
    plp = out.prompt_logprobs
    assert len(plp) == len(ids) and plp[0] is None
    for i, e in enumerate(plp[1:]):
        assert e["token_id"] == ids[i + 1]
        assert abs(e["logprob"] - float(lp[i, ids[i + 1]])) <= 5e-2 * top
        for t in e["top_logprobs"]:
            assert abs(t["logprob"] - float(lp[i, t["token_id"]])) <= (
                5e-2 * top)


def _runner_pair(monkeypatch, dtype):
    """A compiled runner and its eager control on the same small-model
    params, each with the same three prompts prefilled (the compiled
    runner through its prefill variants)."""
    params = _small_params(monkeypatch, getattr(torch, dtype))
    runners = []
    for eager in (False, True):
        r = _small_engine(monkeypatch, "cuda", params, eager=eager,
                          dtype=dtype, cache_dtype=dtype).runner
        for i, n in enumerate((5, 40, 70)):
            r.prefill([(3 * i + j) % 250 + 1 for j in range(n)], 0,
                      [1 + 4 * i + p for p in range(4)], n)
        runners.append(r)
    return runners


def _round(r, tokens, ctx, k=4):
    """One sampled K-step round with logprobs and device stops (lane 1's
    budget ends mid-round) over the three prefilled lanes."""
    b = len(ctx)
    return r.decode_multi(
        tokens, [c - 1 for c in ctx],
        [[1 + 4 * i + p for p in range(4)] for i in range(b)], ctx, k,
        np.full(b, 0.7, np.float32), np.full(b, 0.9, np.float32),
        np.full(b, 40, np.int32),
        np.stack([np.arange(b), ctx], 1).astype(np.uint32),
        stop=(np.full(b, -1, np.int32), np.zeros(b, np.int32),
              np.array([k, 2, k], np.int32), None),
        want_logprobs=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replay_equals_eager_iteration(cuda_device, monkeypatch,
                                             dtype):
    """The fused loop's iteration replayed from its CUDA graph gives the
    eager iteration's tokens, logprobs, valid counts and KV bit for bit:
    the first round builds the variant (iteration 0 runs eagerly on a
    side stream, then the capture; 1..3 replay), the second (chained on
    the first's device tokens) is its own variant."""
    runners = _runner_pair(monkeypatch, dtype)
    tokens = [[7, 8, 9]] * 2
    ctx = [6, 41, 71]
    for _ in range(2):
        outs = [_round(r, t, ctx) for r, t in zip(runners, tokens)]
        for got, want in zip(*outs):
            assert torch.equal(got, want)
        tokens = [ys[0][-1] for ys in outs]
        ctx = [c + 4 for c in ctx]
        compiled, eager = runners
        assert torch.equal(compiled.k_cache, eager.k_cache)
        assert torch.equal(compiled.v_cache, eager.v_cache)
    loop = [v for v in compiled._variants.values()
            if v.kind == "decode_multi"]
    assert [v.replays for v in loop] == [3, 3]
    assert compiled.compile_events["decode_multi"] == 2
    assert eager.compile_events == {} and not eager._variants


@pytest.mark.cuda
def test_graph_replays_count_their_launches(cuda_device, monkeypatch):
    """A replay adds the launches its capture recorded: the compiled
    engine's launch and dispatch counts equal the eager engine's, one
    ragged launch a layer a forward; a single-step decode graph records
    one ragged launch a layer."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    params = _small_params(monkeypatch)
    counts = []
    for eager in (False, True):
        eng = _small_engine(monkeypatch, "cuda", params, eager=eager,
                            num_scheduler_steps=4)
        tpa.reset_launch_counts()
        runs0 = dict(eng.runner.dispatch_counts)
        out = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8]], SamplingParams(
            max_tokens=13, temperature=0.0, ignore_eos=True))
        runs = {k: v - runs0[k] for k, v in eng.runner.dispatch_counts.items()}
        got = tpa.launch_counts()
        counts.append((got, runs, [o.token_ids for o in out]))
        layers = eng.runner.model_config.num_layers
        assert got["ragged"] == layers * (
            runs["prefill_batch"] + runs["decode"] + runs["decode_iterations"])
        assert got["prefill"] == layers * runs["prefill"]
        assert bool(eng.runner._variants) != eager
    assert counts[0] == counts[1]
    r = _small_engine(monkeypatch, "cuda", params).runner
    for _ in range(2):
        r.decode([1, 2], [3, 4], [[1], [2]], [4, 5])
    (var,) = r._variants.values()
    assert var.kind == "decode" and var.replays == 1
    assert var.launches == {"ragged": r.model_config.num_layers}


@pytest.mark.cuda
def test_captured_programs_equal_eager_on_card(cuda_device, monkeypatch):
    """Every program kind the JAX runner jit-caches, captured and
    replayed on the card, gives the eager engine's tokens, launches and
    dispatches: single prefill (with prompt logprobs), the ragged-rows
    packed prefill, the mixed round's step 0, verify (n-gram drafts),
    embed and KV import; each kind is built once and replayed."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    params = _small_params(monkeypatch)
    got = []
    for eager in (False, True):
        eng = _small_engine(monkeypatch, "cuda", params, eager=eager,
                            num_scheduler_steps=4, max_prefill_chunk=32,
                            num_speculative_tokens=3)
        r = eng.runner
        tpa.reset_launch_counts()
        runs0 = dict(r.dispatch_counts)
        prompts = [[5, 6, 7] * 4, list(range(1, 40)), [9, 8, 7, 6] * 5]
        sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
        outs = [o.token_ids for o in eng.generate(prompts, sp)]
        # staggered: a prompt beside decoding lanes makes mixed rounds
        eng.add_request("late0", prompt_token_ids=[3] * 50,
                        sampling_params=sp)
        eng.step()
        eng.add_request("late1", prompt_token_ids=list(range(60, 90)),
                        sampling_params=SamplingParams(
                            max_tokens=6, temperature=0.0, ignore_eos=True,
                            prompt_logprobs=2))
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    outs.append(o.token_ids)
        # two inputs in one context bucket, one in a larger bucket (the
        # scratch grows, the embed variants are rebuilt), then the first
        emb = [r.embed(list(range(1, n))) for n in (20, 27, 70, 20)]
        wire = r.export_blocks([1, 2, 3])
        r.import_blocks([40, 41, 42], wire)
        r.import_blocks([43, 44], wire[:, :, :2].contiguous())
        kv = torch.cat([r.k_cache[:, :, 40 * 32:45 * 32],
                        r.v_cache[:, :, 40 * 32:45 * 32]]).cpu()
        runs = {k: v - runs0[k] for k, v in r.dispatch_counts.items()}
        got.append((outs, runs, tpa.launch_counts(), emb, kv))
        if not eager:
            kinds = {v.kind for v in r._variants.values()}
            assert {"prefill", "prefill_rows", "ragged_rows", "verify",
                    "embed", "kv_import", "decode_multi"} <= kinds, kinds
            assert sum(v.replays for v in r._variants.values()
                       if v.kind in ("prefill", "embed", "kv_import",
                                     "verify", "ragged_rows")) > 0
            assert r.graph_pool_bytes() > 0
    (g_outs, g_runs, g_launch, g_emb, g_kv), (e_outs, e_runs, e_launch,
                                              e_emb, e_kv) = got
    assert g_outs == e_outs and g_runs == e_runs and g_launch == e_launch
    for a, b in zip(g_emb, e_emb):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(g_kv, e_kv)


@pytest.mark.cuda
def test_captured_loop_skips_forwards_once_all_done(cuda_device,
                                                    monkeypatch):
    """Lanes stopped by the data (a stop token id each lane samples at a
    different step) before the host's budget cap: the captured K=8 loop
    skips its forward in the iterations after the last lane is done
    (fewer loop forwards than the eager control's, which runs every
    iteration it enqueues), and the streams are the eager engine's."""
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    params = _small_params(monkeypatch)
    prompts = [[3 + i, 5, 7 + 2 * i] * 3 for i in range(3)]
    got = []
    for eager in (False, True):
        eng = _small_engine(monkeypatch, "cuda", params, eager=eager,
                            num_scheduler_steps=8)
        probe = [o.token_ids for o in eng.generate(prompts, SamplingParams(
            max_tokens=24, temperature=0.0, ignore_eos=True))]
        # lane i stops on the token it sampled at step 2, 4, 3, gated
        # by min_tokens so an earlier copy of it does not stop the lane
        sps = [SamplingParams(max_tokens=24, temperature=0.0,
                              ignore_eos=True, stop_token_ids=[pr[lo]],
                              min_tokens=lo + 1)
               for pr, lo in zip(probe, (2, 4, 3))]
        r = eng.runner
        f0, i0 = int(r.loop_forwards), r.dispatch_counts["decode_iterations"]
        outs = []
        for p, sp in zip(prompts, sps):
            eng.add_request(f"s{len(outs)}", prompt_token_ids=p,
                            sampling_params=sp)
            outs.append(f"s{len(outs)}")
        done = {}
        while eng.has_unfinished():
            done.update({o.request_id: o.token_ids for o in eng.step()
                         if o.finished})
        got.append(([done[k] for k in outs], int(r.loop_forwards) - f0,
                    r.dispatch_counts["decode_iterations"] - i0))
    (g_out, g_fwd, g_it), (e_out, e_fwd, e_it) = got
    assert g_out == e_out and [len(o) for o in g_out] == [3, 5, 4]
    assert g_it == e_it
    assert g_fwd < e_fwd, (g_fwd, e_fwd)


@pytest.mark.cuda
def test_moved_cache_stops_the_replay(cuda_device, monkeypatch):
    """No fallback: a graph whose captured KV cache was reallocated
    raises instead of replaying on stale addresses or running eagerly."""
    r = _small_engine(monkeypatch, "cuda", _small_params(monkeypatch)).runner
    for _ in range(2):
        r.decode([1], [3], [[1]], [4])
    r.k_cache = r.k_cache.clone()
    with pytest.raises(RuntimeError, match="in place"):
        r.decode([1], [3], [[1]], [4])


# -- tensor parallelism: the kernels on one rank's shard ---------------------
def _tp_case(kind, dev, dtype):
    """Llama-3.2-3B's attention at tp=2, one rank's local shape: 12 q
    heads over 4 kv heads (one GQA group of 3), d=128, bs=32."""
    nq, nkv, d, bs = 12, 4, 128, 32
    rng = np.random.RandomState(31)
    kw = dict(block_size=bs, scale=d**-0.5)
    tp_kw = dict(num_heads=2 * nq, num_kv_heads=2 * nkv, tp_size=2)
    num_blocks = 1 + 4 * 16
    kc, vc = _cache_pair(rng, 2, nkv, num_blocks * bs, d)
    tables = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    tables = tables[:4 * 16].reshape(4, 16)
    put = [_t(x).to(dev, dtype) for x in (kc, vc)]
    if kind == "decode":
        q = rng.randn(4, nq, d).astype(np.float32)
        args = [_t(q).to(dev, dtype), *put, 1, _t(tables).to(dev),
                _t(np.asarray([1, 33, 300, 512], np.int32)).to(dev)]
        return (tpa.paged_decode_attention_tp(*args, **kw, **tp_kw),
                tpa.paged_decode_attention_plain(*args, **kw))
    if kind == "prefill":
        q = rng.randn(64, nq, d).astype(np.float32)
        args = [_t(q).to(dev, dtype), *put, 1, _t(tables[0]).to(dev), 100]
        return (tpa.paged_prefill_attention_tp(*args, **kw, **tp_kw),
                tpa.paged_prefill_attention_plain(*args, **kw))
    # 4 decode lanes as the runner packs a decode step
    q = rng.randn(8, nq, d).astype(np.float32)
    blk_seg = np.asarray([0, 4], np.int32)
    seg = np.asarray([[i, i, 1, c - 1] for i, c in
                      enumerate([1, 33, 300, 512])], np.int32)
    args = [_t(q).to(dev, dtype), *put, 1] + [
        _t(x).to(dev) for x in (tables, blk_seg, seg)]
    out = tpa.ragged_paged_attention_tp(*args, **kw, **tp_kw)
    return out[:4], tpa.ragged_paged_attention_plain(*args, **kw)[:4]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_wrappers_launch_the_kernels_at_the_tp2_shape(cuda_device, kind,
                                                         dtype):
    before = tpa.launch_counts()[kind]
    out, ref = _tp_case(kind, cuda_device, dtype)
    torch.cuda.synchronize()
    assert tpa.launch_counts()[kind] == before + 1
    _assert_rel(out, ref, _REL[dtype])


@pytest.mark.cuda
def test_tp2_engine_on_one_card_equals_tp1(cuda_device, monkeypatch):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device): the tp=2 engine's greedy streams equal the tp=1 engine's in
    float32, each rank launched the ragged kernel on its shard, and no
    collective took a host tensor."""
    import dataclasses

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )
    from production_stack_tpu_torch.models import config as mconfig
    from production_stack_tpu_torch.parallel.launch import start_tp_ranks

    cfg = dataclasses.replace(mconfig.get_model_config("pst-tiny-debug"),
                              name="pst-tiny-tp-card", head_dim=64,
                              hidden_size=256)
    monkeypatch.setitem(mconfig._PRESETS, cfg.name, cfg)
    base = dict(model=cfg.name, tokenizer="byte", dtype="float32",
                cache_dtype="float32", block_size=32, num_kv_blocks=64,
                max_num_seqs=4, seed=0, num_scheduler_steps=4)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    sp = SamplingParams(max_tokens=13, temperature=0.0, ignore_eos=True)
    want = [o.token_ids for o in LLMEngine(EngineConfig(**base)).generate(
        prompts, sp)]
    tp_cfg = EngineConfig(**base, tensor_parallel_size=2)
    group = start_tp_ranks(tp_cfg, devices=["cuda:0", "cuda:0"],
                           backend="gloo")
    eng = LLMEngine(tp_cfg, tp_group=group)
    try:
        eng.runner.reset_counts()
        got = [o.token_ids for o in eng.generate(prompts, sp)]
        reports = eng.runner.reports()
    finally:
        eng.shutdown()
    assert got == want
    for r in reports:
        runs = r["dispatch_counts"]
        assert r["launches"]["ragged"] == cfg.num_layers * (
            runs["prefill_batch"] + runs["decode"]
            + runs["decode_iterations"])
        assert r["tensor_devices"] == ["cuda:0"]
        assert r["host_collectives"] == 0 and r["all_reduces"] > 0
