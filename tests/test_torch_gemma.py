"""Gemma's head_dim 256 through the port's paged-attention path against
the JAX package's, on the CPU in float32.

A tiny GemmaForCausalLM config.json (2 layers, 2 query heads over 1 kv
head of head_dim 256, GeGLU, zero-centred norms, scaled and tied
embeddings) is read by both packages, and the same numpy weights feed
both: a JAX runner and engine on attention_impl "pallas" (its Pallas
kernels in interpret mode, as tests/test_pallas_attention.py runs them)
and a port runner and engine under the default "auto", which is
"pallas" (on the CPU the kernels' plain versions; on the card the
kernels themselves, which take head_dim 256).

- Each dispatch (prefill, decode, the unified ragged round) on one cache
  state: greedy tokens equal, logits and the written KV within 1e-5
  relative.
- Engines on the default unified ragged rounds serve a multi-chunk prompt
  arriving beside decoding lanes: greedy streams equal and each token's
  logprob within 1e-5 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.model_runner import ModelRunner as JRunner
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import (
    get_model_config as j_get_config,
)
from production_stack_tpu_torch.engine import model_runner
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models.config import get_model_config
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
# google/gemma-2b's shape of attention (one kv head, head_dim 256) at a
# tiny width
GEMMA_TINY = {
    "architectures": ["GemmaForCausalLM"], "head_dim": 256,
    "hidden_act": "gelu", "hidden_size": 64, "intermediate_size": 128,
    "max_position_embeddings": 256, "num_attention_heads": 2,
    "num_hidden_layers": 2, "num_key_value_heads": 1,
    "rms_norm_eps": 1e-06, "rope_theta": 10000.0, "vocab_size": 384}
BASE = dict(tokenizer="byte", dtype="float32", cache_dtype="float32",
            block_size=8, num_kv_blocks=64, max_num_seqs=3,
            max_prefill_chunk=16, seed=0)
PROMPTS = [list(range(1, 12)), [50, 60, 70, 80, 90],
           [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19]]
TABLES = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]


@pytest.fixture(scope="module")
def gemma_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma-tiny")
    (d / "config.json").write_text(json.dumps(GEMMA_TINY))
    return str(d)


@pytest.fixture(scope="module")
def np_params(gemma_dir):
    params = jllama.init_params(j_get_config(gemma_dir), jax.random.key(3),
                                jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _close(mine, ref, what=""):
    ref = np.asarray(ref, np.float32)
    mine = np.asarray(mine, np.float32)
    assert mine.shape == ref.shape, what
    assert np.abs(mine - ref).max() <= REL * max(np.abs(ref).max(), 1e-30), \
        what


def test_config_and_impl_resolve_as_jax(gemma_dir):
    """Both packages read the config alike; under auto the port serves
    head_dim 256 on the kernels, on the card as on the CPU."""
    cfg = get_model_config(gemma_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_get_config(gemma_dir))
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads) == (256, 2, 1)
    for dev in ("cuda", "cpu"):
        assert model_runner.resolve_attention_impl(
            "auto", cfg.head_dim, dev) == "pallas"


def _greedy_args(n):
    return (np.zeros(n, np.float32), np.ones(n, np.float32),
            np.full(n, -1, np.int32), np.zeros((n, 2), np.uint32))


def _dispatch(kind, runner):
    """One dispatch of `kind` on `runner` (either package) after the
    shared prefills; its outputs as numpy arrays."""
    starts = [len(p) for p in PROMPTS]
    ctx = [s + 1 for s in starts]
    if kind == "prefill":
        # a chunk over a cached prefix: positions 16..24 over 3 pages
        tok, logits = runner.prefill([5, 6, 7, 8, 9, 10, 11, 12, 13], 16,
                                     [20, 21, 22, 23], 25)
        return [tok, logits]
    if kind == "decode":
        return [runner.decode([3, 9, 27], starts, TABLES, ctx)]
    assert kind == "ragged"
    pf_sampled, pf_logits, ys = runner.ragged_dispatch(
        [list(range(40, 51)), [7, 7, 7]], [0, 0], [[20, 21], [22]], [11, 3],
        [3, 9], starts[:2], TABLES[:2], ctx[:2], 4, *_greedy_args(2),
        want_logprobs=True)
    # lane 2 of the decode side is padding
    return [pf_sampled[:2], pf_logits[:2], *(y[:, :2] for y in ys)]


@pytest.fixture(scope="module")
def runners(gemma_dir, np_params):
    cfg = {**BASE, "model": gemma_dir}
    jr = JRunner(JConfig(**cfg, attention_impl="pallas"),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    tr = ModelRunner(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    assert tr.attention_impl == "pallas" and tr.ragged_kernel
    for p, tb in zip(PROMPTS, TABLES):
        tr.prefill(p, 0, tb, len(p))
    return jr, tr, (tr.k_cache.clone(), tr.v_cache.clone())


@pytest.mark.parametrize("kind", ["prefill", "decode", "ragged"])
def test_dispatch_matches_jax_pallas(runners, kind):
    jr, tr, (kc0, vc0) = runners
    tr.k_cache.copy_(kc0)
    tr.v_cache.copy_(vc0)
    jr.k_cache = jnp.asarray(kc0.numpy())
    jr.v_cache = jnp.asarray(vc0.numpy())
    calls = []
    attn = tr._attn

    def spy(k, *a):
        calls.append(k)
        return attn(k, *a)

    tr._attn = spy
    try:
        got = [np.asarray(x) for x in _dispatch(kind, tr)]
    finally:
        del tr._attn
    want = [np.asarray(x) for x in _dispatch(kind, jr)]
    # the port ran the kernels' path: the ragged kernel for a decode step
    # and a mixed round, the prefill kernel for a single prefill
    assert set(calls) == {"prefill" if kind == "prefill" else "ragged"}
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w.astype(g.dtype))
        else:
            _close(g, w, kind)
    # block 0 is the null block every padding row writes
    bs = BASE["block_size"]
    for mine, ref in ((tr.k_cache, jr.k_cache), (tr.v_cache, jr.v_cache)):
        _close(mine.numpy()[:, :, bs:], np.asarray(ref)[:, :, bs:], "kv")


def _serve(engine, sampling_cls):
    """Two short greedy lanes, then a 4-chunk prompt arriving at step 2
    while they decode (its chunks ride mixed rounds): each request's
    (token ids, per-token logprobs)."""
    sp = sampling_cls(max_tokens=8, temperature=0.0, ignore_eos=True,
                      logprobs=1)
    engine.add_request("a", prompt_token_ids=[1, 2, 3, 4, 5],
                       sampling_params=sp)
    engine.add_request("b", prompt_token_ids=[50, 60, 70, 80, 90, 91, 92],
                       sampling_params=sp)
    out, steps = {}, 0
    while engine.has_unfinished() or steps < 3:
        if steps == 2:
            engine.add_request("c", prompt_token_ids=list(range(1, 60)),
                               sampling_params=sp)
        for o in engine.step():
            if o.finished:
                out[o.request_id] = (list(o.token_ids),
                                     [lp["logprob"] for lp in o.logprobs])
        steps += 1
        assert steps < 500, "engine wedged"
    return out


def test_engine_streams_match_jax_pallas(gemma_dir, np_params):
    jeng = JEngine(JConfig(**BASE, model=gemma_dir, attention_impl="pallas"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))
    peng = LLMEngine(EngineConfig(**BASE, model=gemma_dir, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    assert peng.runner.attention_impl == "pallas"
    want = _serve(jeng, JSampling)
    got = _serve(peng, SamplingParams)
    assert sorted(got) == sorted(want) == ["a", "b", "c"]
    assert peng.runner.dispatch_counts["ragged"] > 0
    for rid in want:
        assert got[rid][0] == want[rid][0], rid
        _close(got[rid][1], want[rid][1], rid)
