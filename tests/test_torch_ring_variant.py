"""The long-prefill ring chunk as a captured program, against the JAX
package's jit-cached chunk programs, on the CPU in float32.

JAX's ``LongContextPrefiller`` jit-caches one chunk program per
``(C, S_pad)`` in ``_chunk_fns``; a captured port prefiller runs each
chunk as the program variant (engine/programs.py) of that key, on one
pair of full-sequence caches kept at the largest S_pad reached. On the
CPU a variant runs its function eagerly on its static buffers, so two
prompts of one key go through the closures and buffers a CUDA graph
captures on the card: a value the first chunk's closure took would show
at the second prompt.

- The prefiller: each chunk's logits and both caches equal JAX's
  ``prefill_chunk`` within 1e-5 relative; two prompts of one key share a
  variant, a prompt of a larger S_pad adds one (the pair grows and the
  first key's variant is rebuilt over it), and the variants are keyed as
  JAX's ``_chunk_fns`` are, as many.
- The lane: a port engine whose ring is captured against a JAX lane
  engine on the same params: greedy streams and top-2 logprobs, the
  runner's compile events (JAX's ring builds are not runner compile
  events, and neither are the port's), one long prompt beside a short
  one, then two long prompts at once. The port rings them one after the
  other on its one pair: the second prompt's cache is zeroed only after
  the worker enqueued its copies off the pair.

One JAX lane engine and one port lane engine serve the file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import config as jmcfg
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel import long_context as jlc
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models import config as tmcfg
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.parallel import long_context as tlc

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
SP, CHUNK, BS, THRESHOLD = 2, 16, 8, 32
MODEL = jmcfg.ModelConfig(
    name="pst-ring-variant", vocab_size=256, hidden_size=32,
    intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, max_model_len=512, rope_theta=10000.0,
    tie_word_embeddings=True,
)
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True, logprobs=2)


def _tcfg(jcfg):
    return tmcfg.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tmcfg.ModelConfig)})


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale)


def _prompt(n: int, seed: int) -> list[int]:
    return np.random.RandomState(seed).randint(1, 256, n).tolist()


@pytest.fixture(scope="module")
def np_params():
    jmcfg._PRESETS[MODEL.name] = MODEL
    tmcfg._PRESETS[MODEL.name] = _tcfg(MODEL)
    yield jax.tree_util.tree_map(
        np.asarray, jllama.init_params(MODEL, jax.random.key(0), jnp.float32))
    jmcfg._PRESETS.pop(MODEL.name, None)
    tmcfg._PRESETS.pop(MODEL.name, None)


# -- the prefiller -----------------------------------------------------------
def _ring_chunks(pre, ids, check=None):
    """Every chunk of `ids` through prefill_chunk -> (each chunk's
    logits, the final caches); `check(i, logits, kc, vc)` after each."""
    S = pre.seq_pad(len(ids), CHUNK)
    kc, vc = pre.begin_cache(S)
    out = []
    for i, start in enumerate(range(0, len(ids), CHUNK)):
        last = min(len(ids) - 1 - start, CHUNK - 1)
        logits, kc, vc = pre.prefill_chunk(
            kc, vc, pre.stage_tokens(ids[start:start + CHUNK], CHUNK),
            start, last)
        out.append(logits)
        if check is not None:
            check(i, logits, kc, vc)
    return out, kc, vc


def test_captured_chunks_equal_jax_chunk_programs(np_params):
    jpre = jlc.LongContextPrefiller(
        MODEL, jax.tree_util.tree_map(jnp.asarray, np_params),
        jlc.make_sp_mesh(1, SP))
    tpre = tlc.LongContextPrefiller(
        _tcfg(MODEL), params_from_numpy(np_params, "cpu"), ["cpu"] * SP,
        captured=True)
    # 50 and 60 tokens: four chunks over S_pad 64 (one key); 100
    # tokens: seven over S_pad 128 (a second key, a larger pair)
    prompts = [_prompt(50, 1), _prompt(60, 2), _prompt(100, 3)]
    firsts = []
    for p in prompts:
        S = jpre.seq_pad(len(p), CHUNK)
        state = dict(zip("kv", jpre.begin_cache(S)))
        want = []

        def check(i, logits, kc, vc, p=p, state=state, want=want):
            start = i * CHUNK
            jl, state["k"], state["v"] = jpre.prefill_chunk(
                state["k"], state["v"],
                jpre.stage_tokens(p[start:start + CHUNK], CHUNK), start,
                min(len(p) - 1 - start, CHUNK - 1))
            want.append(np.asarray(jl))
            _close(logits, jl)
            _close(kc.gather(), state["k"])
            _close(vc.gather(), state["v"])

        got, _, _ = _ring_chunks(tpre, p, check)
        firsts.append(got)
    assert set(tpre.variants) == set(jpre._chunk_fns) == {
        (CHUNK, 64), (CHUNK, 128)}
    # the second prompt of the first key replayed its variant: the
    # first key's variant was rebuilt over the grown pair since, and
    # still serves its key
    got, _, _ = _ring_chunks(tpre, prompts[0])
    for a, b in zip(got, firsts[0]):
        _close(a, b)
    assert len(tpre.variants) == len(jpre._chunk_fns) == 2
    assert tpre.pair_bytes() == 2 * 4 * SP * MODEL.num_layers * (
        MODEL.num_kv_heads * (128 // SP + 1) * MODEL.head_dim)


def test_each_key_is_one_variant_and_the_pair_is_shared(np_params):
    """Two prompts of one key reuse one variant and one pair; the
    caches begin_cache returns are the pair's views, zeroed."""
    tpre = tlc.LongContextPrefiller(
        _tcfg(MODEL), params_from_numpy(np_params, "cpu"), ["cpu"] * SP,
        captured=True)
    _ring_chunks(tpre, _prompt(40, 4))
    (var,) = tpre.variants.values()
    pair = tuple(f.data_ptr() for f in tpre._pair)
    kc, vc = tpre.begin_cache(64)
    assert kc.storage[0].data_ptr() == pair[0]
    assert vc.storage[0].data_ptr() == pair[1]
    assert not any(s.any() for s in (*kc.storage, *vc.storage))
    _ring_chunks(tpre, _prompt(45, 5))
    assert list(tpre.variants.values()) == [var]
    with pytest.raises(ValueError, match="captured ring runs on one"):
        tlc.LongContextPrefiller(
            _tcfg(MODEL), params_from_numpy(np_params, "cpu"),
            ["cpu"] * SP, captured=True, tp_group=object())


# -- the lane ------------------------------------------------------------------
LANE = dict(model=MODEL.name, tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=BS, num_kv_blocks=160,
            max_num_seqs=4, max_prefill_chunk=32, seed=0,
            long_prefill_threshold=THRESHOLD, context_parallel_size=SP,
            long_prefill_chunk=CHUNK)


@pytest.fixture(scope="module")
def engines(np_params):
    jeng = JEngine(JConfig(**LANE, attention_impl="xla"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))
    teng = LLMEngine(EngineConfig(**LANE, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    assert teng.long_prefill.prefiller.captured
    yield jeng, teng
    for e in (jeng, teng):
        e.shutdown()


def _drive(eng, reqs, sp_cls):
    """Add `reqs` ({id: prompt}) at step 0 and step to the end ->
    {id: final output}."""
    for rid, prompt in reqs.items():
        eng.add_request(rid, prompt_token_ids=prompt,
                        sampling_params=sp_cls(**GREEDY))
    finals, step = {}, 0
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                finals[o.request_id] = o
        step += 1
        assert step < 2000
    return finals


def _same(got, want):
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid].token_ids == want[rid].token_ids, rid
        rows = [[[e["logprob"] for e in r["top_logprobs"]]
                 for r in o.logprobs] for o in (got[rid], want[rid])]
        _close(*rows)


def _long(eng):
    st = eng.stats()
    return (st.long_prefill_requests_total, st.long_prefill_chunks_total,
            st.long_prefill_fallbacks_total)


def test_lane_streams_and_compile_events_equal_jax(engines):
    """An 80-token prompt (five ring chunks over S_pad 128) beside a
    short one: the JAX lane engine's streams and compile events, and
    one variant of the port's ring."""
    jeng, teng = engines
    reqs = {"long": _prompt(80, 6), "short": _prompt(12, 7)}
    want = _drive(jeng, reqs, JSampling)
    got = _drive(teng, reqs, SamplingParams)
    _same(got, want)
    assert _long(teng) == _long(jeng) == (1, 5, 0)
    assert teng.runner.compile_events == jeng.runner.compile_events
    assert teng.stats().compile_events_total == (
        jeng.stats().compile_events_total)
    pre = teng.long_prefill.prefiller
    assert set(pre.variants) == {(CHUNK, 128)}


def test_two_long_prompts_back_to_back(engines):
    """Two long prompts at once (70 and 95 tokens): the JAX lane rings
    them side by side, the port's one after the other on its pair; the
    streams are JAX's, the port's second cache is zeroed only after the
    first prompt's copies off the pair were enqueued, and no fallback."""
    jeng, teng = engines
    mgr = teng.long_prefill
    pre = mgr.prefiller
    begins = []
    begin = pre.begin_cache

    def spy(s_pad):
        # the other jobs' state when a prompt claims the pair
        begins.append([(r["rid"], r["state"], r["d2h_done"] is not None)
                       for r in mgr._jobs.values()])
        return begin(s_pad)

    pre.begin_cache = spy
    reqs = {"a": _prompt(70, 8), "b": _prompt(95, 9)}
    j0, t0 = _long(jeng), _long(teng)
    try:
        want = _drive(jeng, reqs, JSampling)
        got = _drive(teng, reqs, SamplingParams)
    finally:
        del pre.begin_cache
    _same(got, want)
    jd = tuple(a - b for a, b in zip(_long(jeng), j0))
    td = tuple(a - b for a, b in zip(_long(teng), t0))
    assert td == jd == (2, 5 + 6, 0)
    assert len(begins) == 2
    # the first claims a free pair; when the second claims it, the
    # first has left the ring and its copies are enqueued
    first = [s for s in begins[1] if s[0] == "a"]
    assert all(state not in ("queued", "ringing") and copied
               for _, state, copied in first)
    assert set(pre.variants) == {(CHUNK, 128)}
    assert teng.runner.compile_events == jeng.runner.compile_events
