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



def ragged_case(seed, window_pages=2):
    """One 16-row prefill chunk starting mid-page + 4 decode lanes with
    page-straddling contexts in one row space: 2 prefill blocks, 1 decode
    block holding the 4 single-row segments and an idle segment, and a
    trailing block with no segment."""
    rng = np.random.RandomState(seed)
    bs, nkv, g, d = 8, 2, 2, 32
    nq = nkv * g
    q_start, t = 13, 16
    pf_pages = -(-(q_start + t) // bs)
    dec_ctx = np.asarray([1, 7, 9, 16], np.int32)
    b, pages = len(dec_ctx), 2
    num_blocks = 1 + pf_pages + b * pages
    kc, vc = _cache_pair(rng, 2, nkv, num_blocks * bs, d)
    perm = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    n_pages = max(pf_pages, pages)
    tables = np.zeros((1 + b, n_pages), np.int32)
    tables[0, :pf_pages] = perm[:pf_pages]
    tables[1:, :pages] = perm[pf_pages:].reshape(b, pages)
    seg = [[0, 0, 8, q_start], [0, 0, 8, q_start + 8]]
    seg += [[1 + i, i, 1, int(c) - 1] for i, c in enumerate(dec_ctx)]
    seg += [[0, 4, 0, 0]]  # idle segment: stores nothing
    blk_seg = np.asarray([0, 1, 2, 7, 7], np.int32)
    q = rng.randn(32, nq, d).astype(np.float32)
    return (q, kc, vc, tables, blk_seg, np.asarray(seg, np.int32),
            list(range(16)) + list(range(16, 16 + b)))


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
    q, kc, vc, tables, blk_seg, seg, rows = ragged_case(13)
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
