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


def _run_case(kind, dev, dtype):
    """(kernel output, plain output, rows to compare) for one kernel."""
    kw = dict(block_size=8, scale=0.1)

    def put(*arrays):
        return [_t(x).to(dev, dtype) for x in arrays]

    if kind == "decode":
        q, kc, vc, tables, ctx = decode_case(11, d=128)
        args = put(q, kc, vc) + [1, _t(tables).to(dev), _t(ctx).to(dev)]
        return (tpa.paged_decode_attention(*args, **kw),
                tpa.paged_decode_attention_plain(*args, **kw),
                slice(None))
    if kind == "prefill":
        q, kc, vc, table, q_start = prefill_case(12, t=32, d=128)
        args = put(q, kc, vc) + [0, _t(table).to(dev), q_start]
        return (tpa.paged_prefill_attention(*args, **kw),
                tpa.paged_prefill_attention_plain(*args, **kw),
                slice(None))
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(13, d=128)
    args = put(q, kc, vc) + [1] + [_t(x).to(dev)
                                   for x in (tables, blk_seg, seg)]
    return (tpa.ragged_paged_attention(*args, window=7, **kw),
            tpa.ragged_paged_attention_plain(*args, window=7, **kw), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, kind, dtype):
    # f32: summation order only; bf16: one output rounding (2^-6 at |x|<4)
    tol = 1e-5 if dtype == torch.float32 else 2**-6
    before = tpa.launch_counts()[kind]
    out, ref, rows = _run_case(kind, cuda_device, dtype)
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
@pytest.mark.parametrize("bs,d", [(8, 64), (8, 128), (32, 64), (32, 128)])
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
def test_decode_kernel_head_groups(cuda_device, g, dtype):
    """1 to 16 query heads per kv head fill the kernel's 16-row tile (rows
    8..15 hold heads only from g = 9)."""
    q, kc, vc, tables, ctx = decode_case(21, b=3, pages=1024 // 16, bs=16,
                                         nkv=2, g=g, d=128)
    args = [_t(x).to(cuda_device, dtype) for x in (q, kc, vc)]
    args += [0, _t(tables).to(cuda_device), _t(ctx).to(cuda_device)]
    kw = dict(block_size=16, scale=0.088, window=300)
    out = tpa.paged_decode_attention(*args, **kw)
    ref = tpa.paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_rel(out, ref, _REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [40, 72])
@pytest.mark.parametrize("bs,d", [(8, 64), (32, 128), (8, 128), (32, 64)])
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
def test_ragged_kernel_layouts(cuda_device, layout, bs, nkv, g, window,
                               dtype):
    """Segments sharing a row block, clipped at its edges, past
    blk_seg[G], two kernel tiles to a segment (g = 16), windows that skip
    the first pages: one launch, kernel against plain on covered rows."""
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(
        24, layout, bs=bs, nkv=nkv, g=g, d=128)
    args = [_t(x).to(cuda_device, dtype) for x in (q, kc, vc)]
    args += [1] + [_t(x).to(cuda_device) for x in (tables, blk_seg, seg)]
    kw = dict(block_size=bs, scale=128**-0.5, window=window)
    before = tpa.launch_counts()["ragged"]
    out = tpa.ragged_paged_attention(*args, **kw)
    ref = tpa.ragged_paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launch_counts()["ragged"] == before + 1
    _assert_rel(out[rows], ref[rows], _REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_mixed_dtypes_take_the_fma_path(cuda_device, q_dtype, cache_dtype):
    """q and cache of different types: the f32 CUDA-core path of the three
    kernels (same tiles, ring and masks); output in q's type."""
    q, kc, vc, tables, ctx = decode_case(22, b=3, pages=64, bs=8, g=3, d=64)
    args = [_t(q).to(cuda_device, q_dtype)]
    args += [_t(x).to(cuda_device, cache_dtype) for x in (kc, vc)]
    args += [1, _t(tables).to(cuda_device), _t(ctx).to(cuda_device)]
    kw = dict(block_size=8, scale=0.125)
    out = tpa.paged_decode_attention(*args, **kw)
    ref = tpa.paged_decode_attention_plain(*args, **kw)
    q, kc, vc, table, q_start = prefill_case(23, t=40, prefix_pages=30,
                                             bs=8, g=3, d=64)
    pargs = [_t(q).to(cuda_device, q_dtype)]
    pargs += [_t(x).to(cuda_device, cache_dtype) for x in (kc, vc)]
    pargs += [0, _t(table).to(cuda_device), q_start]
    pout = tpa.paged_prefill_attention(*pargs, **kw)
    pref = tpa.paged_prefill_attention_plain(*pargs, **kw)
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(25, "shared", g=3,
                                                        d=64)
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
def test_card_wrappers_reject_unbuilt_shapes(cuda_device):
    q, kc, vc, tables, ctx = decode_case(20, d=32)
    args = [_t(x).to(cuda_device) for x in (q, kc, vc)]
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode_attention(
            *args, 0, _t(tables).to(cuda_device), _t(ctx).to(cuda_device),
            block_size=8, scale=0.1)
    q, kc, vc, tables, blk_seg, seg, _ = ragged_case(20, d=32)
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
