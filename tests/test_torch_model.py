"""The PyTorch port's layers, sampler and Llama forward against the JAX
package's, on the same inputs made from a seed with numpy.

Float32 throughout; tolerances: 1e-5 relative for layers, attention and
logits (summation order differs between XLA's CPU kernels and
PyTorch's), exact equality for sampled token ids (the same logits and
the same gumbel noise pick the same candidate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampler as jsampler
from production_stack_tpu.models import config as jcfg
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops import attention as jattn
from production_stack_tpu.ops import layers as jlayers
from production_stack_tpu_torch.engine import sampler as tsampler
from production_stack_tpu_torch.models import config as tcfg
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops import layers as tlayers
from production_stack_tpu_torch.ops import paged_attention as tpa

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# -- layers ----------------------------------------------------------------
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                            offset),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset))


def test_rope():
    rng = np.random.RandomState(1)
    pos = np.asarray([0, 3, 17, 250, 4095], np.int32)
    q = rng.randn(5, 4, 16).astype(np.float32)
    k = rng.randn(5, 2, 16).astype(np.float32)
    cj, sj = jlayers.rope_cos_sin(jnp.asarray(pos), 16, 500000.0)
    ct, st = tlayers.rope_cos_sin(torch.from_numpy(pos), 16, 500000.0)
    _close(ct, cj)
    _close(st, sj)
    qj, kj = jlayers.apply_rope(jnp.asarray(q), jnp.asarray(k), cj, sj)
    qt, kt = tlayers.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                                ct, st)
    _close(qt, qj)
    _close(kt, kj)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_swiglu(act):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 32).astype(np.float32)
    wg, wu = (rng.randn(32, 48).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.randn(48, 32).astype(np.float32) * 0.2
    t = [torch.from_numpy(a) for a in (x, wg, wu, wd)]
    j = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    _close(tlayers.swiglu(*t, act=act), jlayers.swiglu(*j, act=act))


@pytest.mark.parametrize("shape", [(3, 32, 48), (2, 5, 64, 24)])
def test_matmul_f32_keeps_bf16_products_unrounded(shape):
    """bf16 operands, float32 result: the float32 sum of exact products,
    as jnp.dot(..., preferred_element_type=f32) gives it, not a result
    rounded to bf16 and widened."""
    rng = np.random.RandomState(6)
    x = rng.randn(*shape[:-1]).astype(np.float32)
    w = rng.randn(*shape[-2:]).astype(np.float32)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    want = jnp.dot(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    got = tlayers.matmul_f32(xb, wb)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


# -- sampler ---------------------------------------------------------------
def _jax_gumbel(keys, cap):
    """The noise JAX's sample_tokens draws from each row's key."""
    return np.asarray(jax.vmap(
        lambda kd: jax.random.gumbel(
            jax.random.wrap_key_data(kd, impl="threefry2x32"), (cap,))
    )(jnp.asarray(keys)))


@pytest.mark.parametrize("temp,top_p,top_k,min_p", [
    (0.0, 1.0, -1, 0.0),   # greedy
    (1.0, 1.0, 5, 0.0),    # top-k
    (0.8, 0.7, -1, 0.0),   # top-p
    (1.2, 1.0, -1, 0.2),   # min-p
    (0.7, 0.9, 20, 0.05),  # all three
])
def test_sample_tokens_match_jax(temp, top_p, top_k, min_p):
    rng = np.random.RandomState(3)
    b, vocab = 16, 300
    logits = (rng.randn(b, vocab) * 3).astype(np.float32)
    keys = np.stack([np.arange(b) + 7, np.arange(b) * 3], 1).astype(
        np.uint32)
    temps = np.full(b, temp, np.float32)
    tps = np.full(b, top_p, np.float32)
    tks = np.full(b, top_k, np.int32)
    mps = np.full(b, min_p, np.float32)
    want = np.asarray(jsampler.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tps),
        jnp.asarray(tks), jnp.asarray(keys), min_p=jnp.asarray(mps)))
    got = tsampler.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(tps), torch.from_numpy(tks),
        torch.from_numpy(_jax_gumbel(keys, tsampler.TOP_CAP).copy()),
        min_p=torch.from_numpy(mps))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_noise_is_per_row():
    """A row's noise depends on its own (seed, step) key only, never on
    the batch around it."""
    keys = np.asarray([[1, 2], [3, 4], [1, 2]], np.uint32)
    n = tsampler.gumbel_noise(keys)
    assert n.shape == (3, tsampler.TOP_CAP)
    np.testing.assert_array_equal(n[0], n[2])
    np.testing.assert_array_equal(tsampler.gumbel_noise(keys[1:2])[0], n[1])
    assert not np.array_equal(n[0], n[1])


def test_apply_penalties_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 40).astype(np.float32)
    counts = rng.randint(0, 3, size=(3, 40)).astype(np.float32)
    pres = np.asarray([0.0, 0.5, 1.0], np.float32)
    freq = np.asarray([0.2, 0.0, 0.3], np.float32)
    rep = np.asarray([1.0, 1.3, 0.8], np.float32)
    want = jsampler.apply_penalties(
        jnp.asarray(logits), jnp.asarray(counts > 0), jnp.asarray(counts),
        jnp.asarray(pres), jnp.asarray(freq), jnp.asarray(rep))
    got = tsampler.apply_penalties(
        *(torch.from_numpy(a) for a in (logits, counts > 0, counts, pres,
                                        freq, rep)))
    _close(got, want)


# -- llama.forward -----------------------------------------------------------
GQA_BIAS = dict(
    name="pst-tiny-gqa-bias", vocab_size=320, hidden_size=96,
    intermediate_size=160, num_layers=3, num_heads=6, num_kv_heads=2,
    head_dim=16, max_model_len=256, rope_theta=10000.0, qkv_bias=True,
)


def _configs(which):
    if which == "pst-tiny-debug":
        return jcfg.get_model_config(which), tcfg.get_model_config(which)
    return jcfg.ModelConfig(**GQA_BIAS), tcfg.ModelConfig(**GQA_BIAS)


def _jax_params(jc, seed):
    params = jllama.init_params(jc, jax.random.key(seed), jnp.float32)
    if jc.qkv_bias:  # zeros at init: give the biases values to test
        rng = np.random.RandomState(seed)
        for name in ("bq", "bk", "bv"):
            shape = params["layers"][name].shape
            params["layers"][name] = jnp.asarray(
                rng.randn(*shape).astype(np.float32) * 0.1)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("which", ["pst-tiny-debug", "gqa-bias"])
def test_forward_matches_jax(which):
    """A 12-token prefill chunk (padded to 16 rows) then one decode step,
    through the paged cache: logits and the written KV agree."""
    jc, tc = _configs(which)
    np_params = _jax_params(jc, 0)
    tparams = params_from_numpy(np_params, "cpu")
    bs, n_blocks, t, n = 4, 12, 16, 12
    table = np.asarray([3, 7, 1, 9, 5], np.int32)  # 20 slots of context
    rng = np.random.RandomState(5)
    toks = np.zeros(t, np.int32)
    toks[:n] = rng.randint(0, jc.vocab_size, n)
    pos = np.zeros(t, np.int32)
    pos[:n] = np.arange(n)
    slots = np.zeros(t, np.int32)
    slots[:n] = table[np.arange(n) // bs] * bs + np.arange(n) % bs
    shape = (jc.num_layers, jc.num_kv_heads, n_blocks * bs, jc.head_dim)
    scale = jc.head_dim ** -0.5
    gather = jattn.block_table_slots(jnp.asarray(table), bs)

    def j_attn_pf(q, l, kc, vc):
        return jattn.context_attention_prefill(
            q, kc[l, :, gather], vc[l, :, gather], jnp.asarray(pos), n,
            scale)

    lj, kcj, vcj = jllama.forward(
        jc, np_params, jnp.asarray(toks), jnp.asarray(pos),
        jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(slots), j_attn_pf,
        logits_rows=jnp.asarray([n - 1]))

    kct, vct = torch.zeros(shape), torch.zeros(shape)
    table_t = torch.from_numpy(table)

    def t_attn_pf(q, l, kc, vc):
        return tpa.paged_prefill_attention(q, kc, vc, l, table_t, 0,
                                           block_size=bs, scale=scale)

    lt, _, _ = tllama.forward(
        tc, tparams, torch.from_numpy(toks), torch.from_numpy(pos), kct,
        vct, torch.from_numpy(slots), t_attn_pf,
        logits_rows=torch.tensor([n - 1]))
    _close(lt, lj)
    # block 0 holds the trash slot: padded rows all write slot 0, and
    # which of them lands there is unspecified on both sides
    _close(kct[:, :, bs:], np.asarray(kcj)[:, :, bs:])
    _close(vct[:, :, bs:], np.asarray(vcj)[:, :, bs:])

    # decode step at position n
    ctx = n + 1
    slot = np.asarray([table[n // bs] * bs + n % bs], np.int32)

    def j_attn_dec(q, l, kc, vc):
        return jattn.context_attention_decode(
            q, kc[l, :, gather][None], vc[l, :, gather][None],
            jnp.asarray([ctx]), scale)

    lj2, _, _ = jllama.forward(
        jc, np_params, jnp.asarray([42]), jnp.asarray([n]), kcj, vcj,
        jnp.asarray(slot), j_attn_dec, logits_rows=jnp.asarray([0]))
    blk = torch.tensor([0, 1], dtype=torch.int32)
    meta = torch.tensor([[0, 0, 1, n]], dtype=torch.int32)

    def t_attn_dec(q, l, kc, vc):
        qp = torch.zeros((8,) + tuple(q.shape[1:]))
        qp[:1] = q
        return tpa.ragged_paged_attention(
            qp, kc, vc, l, table_t[None], blk, meta, block_size=bs,
            scale=scale)[:1]

    lt2, _, _ = tllama.forward(
        tc, tparams, torch.tensor([42]), torch.tensor([n]), kct, vct,
        torch.from_numpy(slot), t_attn_dec, logits_rows=torch.tensor([0]))
    _close(lt2, lj2)


def test_forward_return_hidden_and_untied_head():
    jc, tc = _configs("gqa-bias")
    jc = dataclasses.replace(jc, tie_word_embeddings=False)
    tc = dataclasses.replace(tc, tie_word_embeddings=False)
    np_params = _jax_params(jc, 1)
    assert "lm_head" in np_params
    tparams = params_from_numpy(np_params, "cpu")
    toks = np.asarray([5, 6, 7, 8, 9, 10, 11, 12], np.int32)
    pos = np.arange(8, dtype=np.int32)
    slots = np.arange(8, dtype=np.int32) + 4
    shape = (jc.num_layers, jc.num_kv_heads, 16, jc.head_dim)
    scale = jc.head_dim ** -0.5
    gather = jattn.block_table_slots(jnp.asarray([1, 2]), 4)  # slots 4..11

    def j_attn(q, l, kc, vc):
        return jattn.context_attention_prefill(
            q, kc[l, :, gather], vc[l, :, gather], jnp.asarray(pos), 8,
            scale)

    def t_attn(q, l, kc, vc):
        return tpa.paged_prefill_attention(
            q, kc, vc, l, torch.tensor([1, 2], dtype=torch.int32), 0,
            block_size=4, scale=scale)

    for hidden in (False, True):
        want, _, _ = jllama.forward(
            jc, np_params, jnp.asarray(toks), jnp.asarray(pos),
            jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(slots), j_attn,
            logits_rows=jnp.asarray([3, 7]), return_hidden=hidden)
        got, _, _ = tllama.forward(
            tc, tparams, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.zeros(shape), torch.zeros(shape), torch.from_numpy(slots),
            t_attn, logits_rows=torch.tensor([3, 7]), return_hidden=hidden)
        _close(got, want)


def test_params_from_numpy_keeps_bf16():
    jc, _ = _configs("pst-tiny-debug")
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jc, jax.random.key(2), jnp.bfloat16))
    t = params_from_numpy(params, "cpu")
    assert t["embed"].dtype == torch.bfloat16
    assert t["layers"]["wq"].shape == tuple(params["layers"]["wq"].shape)
    np.testing.assert_array_equal(
        t["layers"]["wk"].float().numpy(),
        np.asarray(params["layers"]["wk"], np.float32))
    assert params_from_numpy(params, "cpu", torch.float32)["embed"].dtype == (
        torch.float32)


def test_init_params_layout_and_refusals():
    tc = tcfg.get_model_config("pst-tiny-debug")
    p = tllama.init_params(tc, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    assert p["layers"]["wq"].shape == (2, 64, 64)
    assert p["layers"]["wk"].shape == (2, 64, 32)
    assert "lm_head" not in p  # tied
    moe = tcfg.get_model_config("pst-tiny-moe-debug")
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.init_params(moe, torch.Generator(), torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        tllama.forward(tc, p, torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 8, 16),
                       torch.zeros(1, dtype=torch.int32), None,
                       torch.zeros(1, dtype=torch.int32), lora={})
