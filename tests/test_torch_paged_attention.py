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
    _np,
    _t,
    decode_case,
    prefill_case,
    ragged_case,
)

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


def test_ragged_decode_rows_equal_decode_kernel_plain():
    """Decode lanes as single-row ragged segments give the decode
    kernel's rows: both walk the same pages with the same masks."""
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


