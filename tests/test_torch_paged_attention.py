"""The PyTorch port's paged attention against the JAX package's.

Each case builds its inputs from a seed with numpy and feeds the same
arrays to a Pallas kernel (interpret mode on the CPU, as
tests/test_pallas_attention.py runs it) and to the port's wrapper, which
on CPU tensors computes the kernel's plain PyTorch version. Float32
throughout: outputs agree within 1e-5 (summation order differs between
the online softmax and the one-shot softmax, nothing else).

tests/test_torch_cuda_kernels.py holds each CUDA kernel against its plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops import attention as jax_attn
from production_stack_tpu.ops import pallas_attention as jpa
from production_stack_tpu_torch.ops import attention as torch_attn
from production_stack_tpu_torch.ops import paged_attention as tpa
from test_torch_cuda_kernels import (
    RAGGED_CASES,
    _np,
    _t,
    decode_case,
    prefill_case,
    ragged_case,
)

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5  # f32, order of summation only


# -- decode ----------------------------------------------------------------
@pytest.mark.parametrize("seed,layer,window", [
    (0, 0, None), (1, 1, None), (2, 0, 3), (3, 1, 13), (4, 0, 100),
])
def test_decode_plain_matches_pallas(seed, layer, window):
    q, kc, vc, tables, ctx = decode_case(seed)
    scale = q.shape[-1] ** -0.5
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(layer),
        jnp.asarray(tables), jnp.asarray(ctx), block_size=8, scale=scale,
        interpret=True, window=window,
    )
    out = tpa.paged_decode_attention(
        _t(q), _t(kc), _t(vc), layer, _t(tables), _t(ctx), block_size=8,
        scale=scale, window=window,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_decode_bf16_cache_matches_pallas():
    """bf16 q and cache (the serving types): both sides read the same
    bf16 values and round the f32 result to bf16 once."""
    q, kc, vc, tables, ctx = decode_case(5, d=64)
    scale = 0.125
    ref = jpa.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.int32(1), jnp.asarray(tables),
        jnp.asarray(ctx), block_size=8, scale=scale, interpret=True,
    )
    out = tpa.paged_decode_attention(
        _t(q, torch.bfloat16), _t(kc, torch.bfloat16),
        _t(vc, torch.bfloat16), 1, _t(tables), _t(ctx), block_size=8,
        scale=scale,
    )
    # one bf16 rounding of values |x| < 4: at most 2 ulp apart (2^-6)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=2**-6)


# -- decode split plan (the card kernel's split-K) ----------------------------
def _rel_close(out, ref, rel):
    """|out - ref| <= rel * max|ref| per (row, head), over d."""
    o, r = out.float(), torch.as_tensor(np.asarray(ref, np.float32))
    tol = rel * r.abs().amax(dim=-1, keepdim=True)
    assert bool(((o - r).abs() <= tol).all()), float(
        ((o - r).abs() / tol.clamp_min(1e-30)).max())


@pytest.mark.parametrize("pps,window,ctx,pages", [
    (1, None, [16, 32, 9, 1], 4),    # one page per split
    (2, None, [16, 32, 9, 1], 4),    # 16 and 32 end on split boundaries
    (2, None, [64, 48, 33, 0], 8),   # ctx 0 walks nothing: 0
    (1, 5, [32, 30, 17, 8], 4),      # window: the first splits are empty
    (2, 13, [64, 48, 33, 2], 8),     # window empties whole 2-page splits
    (None, 20, [64, 31, 40, 7], 8),  # the kernel's own plan: one split
])
def test_decode_split_plan_matches_pallas(pps, window, ctx, pages):
    q, kc, vc, tables, _ = decode_case(15, pages=pages)
    ctx = np.asarray(ctx, np.int32)
    scale = q.shape[-1] ** -0.5
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(tables), jnp.asarray(ctx), block_size=8, scale=scale,
        interpret=True, window=window,
    )
    out = tpa.paged_decode_attention_plain(
        _t(q), _t(kc), _t(vc), 1, _t(tables), _t(ctx), block_size=8,
        scale=scale, window=window, pages_per_split=pps,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pps", [1, 2])
def test_decode_split_plan_bf16_cache_matches_pallas(pps):
    """bf16 q and cache over many splits: both sides read the same bf16
    values and round the f32 result once, held per (row, head) to the
    card check's 2^-6 * max|ref|."""
    q, kc, vc, tables, ctx = decode_case(16, pages=8, d=64)
    scale = 0.125
    ref = jpa.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.int32(0), jnp.asarray(tables),
        jnp.asarray(ctx), block_size=8, scale=scale, interpret=True,
        window=17,
    )
    out = tpa.paged_decode_attention_plain(
        _t(q, torch.bfloat16), _t(kc, torch.bfloat16),
        _t(vc, torch.bfloat16), 0, _t(tables), _t(ctx), block_size=8,
        scale=scale, window=17, pages_per_split=pps,
    )
    _rel_close(out, _np(ref), 2.0**-6)


def test_decode_split_plan_sizes_from_the_table_width():
    assert tpa._decode_split_plan(64, 32) == (8, 8)     # 256 keys a split
    assert tpa._decode_split_plan(65, 32) == (8, 9)
    assert tpa._decode_split_plan(4, 8) == (32, 1)
    assert tpa._decode_split_plan(0, 8) == (32, 1)      # never an empty grid
    assert tpa._decode_split_plan(5, 8, pages_per_split=2) == (2, 3)
    assert tpa._decode_split_plan(1, 128) == (2, 1)


def test_merge_of_no_split_is_zero_and_masked_splits_weigh_nothing():
    like = torch.ones((1, 2, 4))
    torch.testing.assert_close(tpa._merge_splits([], like),
                               torch.zeros_like(like))
    m = torch.tensor([[0.5, tpa.MASK_VALUE]])
    real = (m, torch.tensor([[2.0, 3.0]]), torch.ones((1, 2, 4)))
    masked = (torch.full((1, 2), tpa.MASK_VALUE), torch.tensor([[5.0, 0.0]]),
              torch.full((1, 2, 4), 7.0))
    out = tpa._merge_splits([real, masked], like)
    # head 0: the split that saw only masked keys weighs e^-1e30 = 0;
    # head 1: both maxima are MASK_VALUE, so both count (uniform average)
    torch.testing.assert_close(out[0, 0], torch.full((4,), 0.5))
    torch.testing.assert_close(out[0, 1], torch.full((4,), 8.0 / 3.0))


@pytest.mark.parametrize("d,bs,g,match", [
    (96, 32, 3, "head_dim"), (16, 4, 2, "head_dim"), (128, 4, 3, "block_size"),
    (128, 256, 3, "block_size"), (64, 8, 17, "query heads"),
])
def test_card_kernels_reject_unbuilt_shapes(d, bs, g, match):
    with pytest.raises(ValueError, match=match):
        tpa.check_kernel_shapes(d, bs, g)


def test_card_kernel_shared_memory_mirrors():
    # bf16 3B shapes: decode 106 KB, prefill 85 KB (two blocks per SM)
    assert tpa._decode_smem(3, 128, 2, 2) == 16 * 272 + 128 + 6 * 64 * 272
    # f32 decode: two stages and the P buffer of the FMA path
    assert (tpa._decode_smem(16, 128, 4, 4)
            == 16 * 528 + 128 + 4 * 64 * 528 + 4096)
    assert tpa._prefill_smem(128, 2, 2) == 64 * 272 + 4 * 64 * 272
    # f32 adds the per-warp P buffer of the FMA path
    assert tpa._prefill_smem(128, 4, 4) == 64 * 528 + 4 * 64 * 528 + 16384
    # head_dim 256 in bf16 (Gemma): 64-key tiles, one block an SM
    assert tpa._prefill_smem(256, 2, 2) == 64 * 528 + 4 * 64 * 528
    assert tpa._prefill_smem(256, 2, 2) == 168960
    assert tpa._decode_smem(1, 256, 2, 2) == 16 * 528 + 128 + 6 * 64 * 528
    assert tpa._decode_smem(16, 256, 2, 2) == 211328
    # head_dim 256 on the FMA path: 32-key tiles (64 would need 349,184
    # bytes for the prefill tile and 287,104 for decode), its P buffers
    # 16 x 32 a warp in the tile and 16 x 8 in decode
    assert tpa._key_tile(256, 4, 4) == tpa._key_tile(256, 4, 2) == 32
    assert tpa._key_tile(256, 2, 2) == tpa._key_tile(128, 4, 4) == 64
    assert (tpa._prefill_smem(256, 4, 4)
            == 64 * 1040 + 4 * 32 * 1040 + 8192 == 207872)
    assert tpa._prefill_smem(256, 4, 2) == 64 * 1040 + 4 * 32 * 528 + 8192
    assert tpa._prefill_smem(256, 2, 4) == 64 * 528 + 4 * 32 * 1040 + 8192
    assert (tpa._decode_smem(16, 256, 4, 4)
            == 16 * 1040 + 128 + 4 * 32 * 1040 + 2048 == 151936)
    assert (tpa._decode_smem(16, 256, 4, 2)
            == 16 * 1040 + 128 + 6 * 32 * 528 + 2048)
    for qi in (2, 4):
        for ci in (2, 4):
            assert tpa._prefill_smem(256, qi, ci) <= tpa.MAX_SMEM_BYTES
            assert tpa._decode_smem(16, 256, qi, ci) <= tpa.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tpa._prefill_smem(512, 4, 4)
    # the ragged kernel runs on the prefill tile: its blocks keep two to
    # an SM at 3B bf16 (228 KB an SM, 1 KB of it reserved per block)
    assert 2 * (tpa._prefill_smem(128, 2, 2) + 1024) <= 228 * 1024
    assert not hasattr(tpa, "_ragged_smem")
    with pytest.raises(ValueError, match="head_dim"):
        tpa._prefill_plan(96, 2, 2, 32)


# -- prefill ---------------------------------------------------------------
@pytest.mark.parametrize("seed,t,window", [
    (0, 16, None), (1, 32, None), (2, 16, 5), (3, 32, 21), (4, 8, 100),
])
def test_prefill_plain_matches_pallas(seed, t, window):
    q, kc, vc, table, q_start = prefill_case(seed, t=t)
    scale = q.shape[-1] ** -0.5
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(table), jnp.int32(q_start), block_size=8, scale=scale,
        interpret=True, window=window,
    )
    out = tpa.paged_prefill_attention(
        _t(q), _t(kc), _t(vc), 1, _t(table), q_start, block_size=8,
        scale=scale, window=window,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


# -- head_dim 256 (Gemma-7B: 16 query heads over 16 kv heads; Gemma-2B: 8
# over 1) -------------------------------------------------------------------
D256 = 256


@pytest.mark.parametrize("nkv,g,window", [
    (1, 8, None), (2, 1, None), (1, 8, 13), (2, 1, 100),
])
def test_decode_plain_matches_pallas_d256(nkv, g, window):
    q, kc, vc, tables, ctx = decode_case(30, nkv=nkv, g=g, d=D256)
    scale = D256 ** -0.5
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(tables), jnp.asarray(ctx), block_size=8, scale=scale,
        interpret=True, window=window,
    )
    out = tpa.paged_decode_attention(
        _t(q), _t(kc), _t(vc), 1, _t(tables), _t(ctx), block_size=8,
        scale=scale, window=window,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_decode_bf16_cache_matches_pallas_d256():
    """bf16 q and cache at Gemma-2B's grouping (8 query heads over one kv
    head): one bf16 rounding of the same f32 result on both sides."""
    q, kc, vc, tables, ctx = decode_case(31, nkv=1, g=8, d=D256)
    scale = D256 ** -0.5
    ref = jpa.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.int32(0), jnp.asarray(tables),
        jnp.asarray(ctx), block_size=8, scale=scale, interpret=True,
    )
    out = tpa.paged_decode_attention(
        _t(q, torch.bfloat16), _t(kc, torch.bfloat16),
        _t(vc, torch.bfloat16), 0, _t(tables), _t(ctx), block_size=8,
        scale=scale,
    )
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=2**-6)


@pytest.mark.parametrize("nkv,g,t,window", [
    (1, 8, 16, None), (2, 1, 32, None), (1, 8, 24, 21),
])
def test_prefill_plain_matches_pallas_d256(nkv, g, t, window):
    q, kc, vc, table, q_start = prefill_case(32, t=t, nkv=nkv, g=g, d=D256)
    scale = D256 ** -0.5
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(table), jnp.int32(q_start), block_size=8, scale=scale,
        interpret=True, window=window,
    )
    out = tpa.paged_prefill_attention(
        _t(q), _t(kc), _t(vc), 1, _t(table), q_start, block_size=8,
        scale=scale, window=window,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout,nkv,g", [
    ("mixed", 1, 8), ("mixed", 2, 1), ("shared", 1, 8),
])
@pytest.mark.parametrize("window", [None, 12])
def test_ragged_plain_matches_pallas_d256(layout, nkv, g, window):
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(
        33, layout, nkv=nkv, g=g, d=D256)
    scale = D256 ** -0.5
    ref = jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(tables), jnp.asarray(blk_seg), jnp.asarray(seg),
        block_size=8, scale=scale, interpret=True, window=window,
    )
    out = tpa.ragged_paged_attention(
        _t(q), _t(kc), _t(vc), 1, _t(tables), _t(blk_seg), _t(seg),
        block_size=8, scale=scale, window=window,
    )
    np.testing.assert_allclose(out.numpy()[rows], _np(ref)[rows],
                               rtol=RTOL, atol=ATOL)


# -- ragged ----------------------------------------------------------------
@pytest.mark.parametrize("layer,window", [
    (0, None), (1, None), (0, 7), (1, 100),
])
def test_ragged_plain_matches_pallas(layer, window):
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(layer)
    scale = q.shape[-1] ** -0.5
    ref = jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(layer),
        jnp.asarray(tables), jnp.asarray(blk_seg), jnp.asarray(seg),
        block_size=8, scale=scale, interpret=True, window=window,
    )
    out = tpa.ragged_paged_attention(
        _t(q), _t(kc), _t(vc), layer, _t(tables), _t(blk_seg), _t(seg),
        block_size=8, scale=scale, window=window,
    )
    # rows no segment covers are undefined in the kernel contract
    np.testing.assert_allclose(out.numpy()[rows], _np(ref)[rows],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout,bs,nkv,g", RAGGED_CASES)
@pytest.mark.parametrize("window", [None, 12])
def test_ragged_layouts_match_pallas(layout, bs, nkv, g, window):
    """The card tests' ragged row spaces (segments sharing a row block,
    clipped at its edges, past blk_seg[G], g = 16 at nkv = 1, windows that
    skip the first pages) through Pallas interpret and the plain version."""
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(
        24, layout, bs=bs, nkv=nkv, g=g)
    scale = q.shape[-1] ** -0.5
    ref = jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(tables), jnp.asarray(blk_seg), jnp.asarray(seg),
        block_size=bs, scale=scale, interpret=True, window=window,
    )
    out = tpa.ragged_paged_attention(
        _t(q), _t(kc), _t(vc), 1, _t(tables), _t(blk_seg), _t(seg),
        block_size=bs, scale=scale, window=window,
    )
    np.testing.assert_allclose(out.numpy()[rows], _np(ref)[rows],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_segs,tq,g,nkv,grid", [
    (89, 8, 3, 8, (89, 8)),    # 3B (nq 24, nkv 8): 24 fused rows, one tile
    (8, 8, 3, 8, (8, 8)),      # a 3B decode step of 8 lanes
    (10, 8, 16, 1, (20, 1)),   # g = 16: 128 fused rows, two tiles
    (3, 64, 3, 8, (9, 8)),     # 192 fused rows, three tiles
    (5, 8, 8, 4, (5, 4)),      # exactly one 64-row tile
])
def test_ragged_grid_plan(n_segs, tq, g, nkv, grid):
    """One block per (segment, 64-fused-row tile, kv head), sized from
    shapes alone."""
    assert tpa._ragged_grid(n_segs, tq, g, nkv) == grid


def test_decode_segments_pack_lanes_into_row_blocks():
    """The runner's decode step on the ragged kernel: lane i is a one-row
    segment at row i, position ctx - 1, RAGGED_TQ lanes to a row block."""
    from production_stack_tpu_torch.engine.model_runner import (
        decode_segments,
    )

    ctx = np.arange(1, 11, dtype=np.int32) * 7
    r_pad, blk_seg, seg = decode_segments(ctx)
    assert r_pad == 16
    assert blk_seg.tolist() == [0, 8, 10]
    assert seg.tolist() == [[i, i % 8, 1, int(c) - 1]
                            for i, c in enumerate(ctx)]
    assert seg.dtype == blk_seg.dtype == np.int32


def test_ragged_decode_rows_equal_decode_kernel_plain():
    """Decode lanes as single-row ragged segments give the decode
    kernel's rows: both walk the same pages with the same masks, and
    these contexts fit one decode split, whose merge is the ragged
    version's arithmetic."""
    q, kc, vc, tables, ctx = decode_case(6, b=5)
    r_pad = 8
    blk_seg = np.asarray([0, 5], np.int32)
    lanes = np.arange(5, dtype=np.int32)
    seg = np.stack([lanes, lanes, np.ones(5, np.int32), ctx - 1], axis=1)
    qp = np.zeros((r_pad,) + q.shape[1:], np.float32)
    qp[:5] = q
    kw = dict(block_size=8, scale=0.2)
    out = tpa.ragged_paged_attention(
        _t(qp), _t(kc), _t(vc), 0, _t(tables), _t(blk_seg), _t(seg), **kw)
    ref = tpa.paged_decode_attention(
        _t(q), _t(kc), _t(vc), 0, _t(tables), _t(ctx), **kw)
    torch.testing.assert_close(out[:5], ref, rtol=0, atol=0)


# -- gather oracle ---------------------------------------------------------
@pytest.mark.parametrize("window", [None, 5])
def test_gather_oracle_matches_jax(window):
    q, kc, vc, tables, ctx = decode_case(7)
    scale = 0.3
    slots_j = jax_attn.block_table_slots(jnp.asarray(tables), 8)
    k_j = jnp.asarray(kc)[0][:, slots_j].transpose(1, 2, 0, 3)
    v_j = jnp.asarray(vc)[0][:, slots_j].transpose(1, 2, 0, 3)
    ref = jax_attn.context_attention_decode(
        jnp.asarray(q), k_j, v_j, jnp.asarray(ctx), scale, window=window)
    slots_t = torch_attn.block_table_slots(_t(tables), 8)
    k_t = _t(kc)[0][:, slots_t].permute(1, 2, 0, 3)
    v_t = _t(vc)[0][:, slots_t].permute(1, 2, 0, 3)
    out = torch_attn.context_attention_decode(
        _t(q), k_t, v_t, _t(ctx), scale, window=window)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)
    # the paged plain version agrees with the oracle too
    paged = tpa.paged_decode_attention(
        _t(q), _t(kc), _t(vc), 0, _t(tables), _t(ctx), block_size=8,
        scale=scale, window=window)
    torch.testing.assert_close(paged, out, rtol=RTOL, atol=ATOL)


def test_prefill_gather_oracle_matches_jax():
    q, kc, vc, table, q_start = prefill_case(8)
    t = q.shape[0]
    scale = 0.25
    pos = np.arange(q_start, q_start + t, dtype=np.int32)
    slots_j = jax_attn.block_table_slots(jnp.asarray(table), 8)
    ref = jax_attn.context_attention_prefill(
        jnp.asarray(q), jnp.asarray(kc)[1][:, slots_j].transpose(1, 0, 2),
        jnp.asarray(vc)[1][:, slots_j].transpose(1, 0, 2), jnp.asarray(pos),
        jnp.int32(q_start + t), scale)
    slots_t = torch_attn.block_table_slots(_t(table), 8)
    out = torch_attn.context_attention_prefill(
        _t(q), _t(kc)[1][:, slots_t].permute(1, 0, 2),
        _t(vc)[1][:, slots_t].permute(1, 0, 2), _t(pos), q_start + t, scale)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


# -- wrapper input checks (run here on CPU tensors, same as on the card) ----
def _decode_args():
    q, kc, vc, tables, ctx = decode_case(9)
    return [_t(q), _t(kc), _t(vc), 0, _t(tables), _t(ctx)]


@pytest.mark.parametrize("mutate,match", [
    (lambda a: a.__setitem__(0, a[0].to(torch.float16)), "float32 or bfloat16"),
    (lambda a: a.__setitem__(0, a[0][:, :, :12].contiguous()), "head dims"),
    (lambda a: a.__setitem__(4, a[4].long()), "int32"),
    (lambda a: a.__setitem__(5, a[5][:2]), "disagree on batch"),
    (lambda a: a.__setitem__(0, a[0].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "contiguous"),
    (lambda a: a.__setitem__(3, 5), "layer"),
    (lambda a: a.__setitem__(4, a[4].to("meta")), "CPU or all on one"),
])
def test_decode_wrapper_rejects_bad_inputs(mutate, match):
    args = _decode_args()
    mutate(args)
    with pytest.raises(ValueError, match=match):
        tpa.paged_decode_attention(*args, block_size=8, scale=0.1)


def test_wrappers_reject_unsupported_head_dim_and_tiles():
    q, kc, vc, table, q_start = prefill_case(10, d=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        tpa.paged_prefill_attention(_t(q), _t(kc), _t(vc), 0, _t(table),
                                    q_start, block_size=8, scale=0.1)
    q, kc, vc, table, q_start = prefill_case(10)
    with pytest.raises(ValueError, match="multiple of"):
        tpa.paged_prefill_attention(_t(q[:12]), _t(kc), _t(vc), 0,
                                    _t(table), q_start, block_size=8,
                                    scale=0.1)
    q, kc, vc, tables, blk_seg, seg, _ = ragged_case(0)
    with pytest.raises(ValueError, match="tile into"):
        tpa.ragged_paged_attention(_t(q[:30]), _t(kc), _t(vc), 0,
                                   _t(tables), _t(blk_seg), _t(seg),
                                   block_size=8, scale=0.1)
    with pytest.raises(ValueError, match=r"\(SC, 4\)"):
        tpa.ragged_paged_attention(_t(q), _t(kc), _t(vc), 0, _t(tables),
                                   _t(blk_seg), _t(seg[:, :3].copy()),
                                   block_size=8, scale=0.1)


def test_plain_versions_count_no_launches():
    tpa.reset_launch_counts()
    tpa.paged_decode_attention(*_decode_args(), block_size=8, scale=0.1)
    assert tpa.launch_counts() == {"decode": 0, "prefill": 0, "ragged": 0}


