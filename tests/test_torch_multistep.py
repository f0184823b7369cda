"""The port's fused K-step decode (ModelRunner.decode_multi on the shared
decode core) against the JAX package's, both on the CPU in float32.

- decode_multi on ONE cache state (the port's cache after its prefills,
  copied into the JAX runner): greedy tokens and per-lane valid counts
  equal, KV and logprobs within 1e-5 relative (the reference's own
  ragged-vs-split KV gap is 1.07e-6 on this tree).
- Engine scenarios of tests/test_multistep.py and
  tests/test_elastic_decode.py on the split path (--no-ragged-dispatch),
  K > 1: greedy streams equal to the JAX engine's. The JAX streams come
  from one shared engine in its split single-step configuration: a
  sequence's greedy stream does not depend on the round shapes around it
  (the JAX package's own tests hold its K-step and ragged paths to it),
  and one engine keeps the XLA compiles to one set.
- Sampled streams: the port draws its noise with numpy from the same
  (seed, step) keys, so they are held to the port's own K=1 stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.model_runner import ModelRunner as JRunner
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.scheduler import Scheduler
from production_stack_tpu_torch.models.convert import params_from_numpy

BASE = dict(
    model="pst-tiny-debug", tokenizer="byte", dtype="float32",
    cache_dtype="float32", block_size=8, num_kv_blocks=96, max_num_seqs=3,
    max_prefill_chunk=16, seed=0,
)
PROMPTS = [
    list(range(1, 12)),
    [50, 60, 70, 80, 90],
    [7, 8, 9, 10, 11, 12, 13, 14, 15],
]
REL = 1e-5


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_outputs(np_params):
    """Final outputs of the JAX engine (split, single step, no prefix
    caching) for a prompt list and a list of SamplingParams kwargs."""
    eng = JEngine(JConfig(
        **BASE, attention_impl="xla", ragged_dispatch=False,
        prefill_pipeline=False, num_scheduler_steps=1,
        enable_prefix_caching=False,
    ), params=jax.tree_util.tree_map(jnp.asarray, np_params))
    return lambda prompts, kws: eng.generate(
        prompts, [JSampling(**kw) for kw in kws])


@pytest.fixture(scope="module")
def jax_streams(jax_outputs):
    return lambda prompts, kws: [
        o.token_ids for o in jax_outputs(prompts, kws)]


def _engine(np_params, k, **over):
    cfg = {**BASE, "ragged_dispatch": False, "num_scheduler_steps": k,
           **over}
    return LLMEngine(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _generate(eng, prompts, kws):
    return [o.token_ids for o in eng.generate(
        prompts, [SamplingParams(**kw) for kw in kws])]


def test_config_defaults_follow_jax():
    """The port's EngineConfig() serves the JAX engine's default single-
    device path: unified ragged rounds, device stops, adaptive K; K up
    to block_size is accepted, above it refused."""
    mine, ref = EngineConfig(), JConfig()
    for name in ("ragged_dispatch", "device_stop", "adaptive_decode_k",
                 "num_scheduler_steps", "ragged_kernel"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert EngineConfig(**{**BASE, "num_scheduler_steps": 8},
                        device="cpu").num_scheduler_steps == 8
    with pytest.raises(ValueError, match="block_size"):
        EngineConfig(**{**BASE, "num_scheduler_steps": 9}, device="cpu")


def _runners(np_params):
    cfg = {**BASE, "num_kv_blocks": 64}
    jr = JRunner(JConfig(**cfg, attention_impl="xla"),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    tr = ModelRunner(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    return jr, tr


@pytest.mark.parametrize("k", [1, 4])
def test_decode_multi_matches_jax(np_params, k):
    """decode_multi on one cache: three lanes with device stops (one lane
    whose budget ends mid-round, one with a stop id), penalties on one
    lane, logprobs on all; tokens below each valid count and the valid
    counts equal, KV and logprobs within 1e-5 relative."""
    jr, tr = _runners(np_params)
    tables = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    for p, tb in zip(PROMPTS, tables):
        tr.prefill(p, 0, tb, len(p))
    jr.k_cache = jnp.asarray(tr.k_cache.numpy())
    jr.v_cache = jnp.asarray(tr.v_cache.numpy())
    args = ([3, 9, 27], [len(p) for p in PROMPTS], tables,
            [len(p) + 1 for p in PROMPTS], k,
            np.zeros(3, np.float32), np.ones(3, np.float32),
            np.full(3, -1, np.int32), np.zeros((3, 2), np.uint32))
    stop = (np.full(3, -1, np.int32), np.zeros(3, np.int32),
            np.array([k, 2, k], np.int32),
            np.array([[-1] * 4, [-1] * 4, [300, -1, -1, -1]], np.int32))
    pen = ([[], [5, 5, 9], []], np.zeros(3, np.float32),
           np.array([0, 0.4, 0], np.float32),
           np.array([1, 1.3, 1], np.float32))
    kw = dict(stop=stop, penalties=pen, want_logprobs=True)
    want = [np.asarray(a) for a in jr.decode_multi(*args, **kw)]
    got = [a.numpy() for a in tr.decode_multi(*args, **kw)]
    valid = want[-1]
    np.testing.assert_array_equal(got[-1], valid)
    assert valid[:2].tolist() == [k, min(k, 2)]
    for lane in range(3):
        n = valid[lane]
        np.testing.assert_array_equal(got[0][:n, lane], want[0][:n, lane])
        for g, w in zip(got[1:3], want[1:3]):  # chosen, top values
            np.testing.assert_allclose(g[:n, lane], w[:n, lane],
                                       rtol=REL, atol=REL)
    for mine, ref in ((tr.k_cache, jr.k_cache), (tr.v_cache, jr.v_cache)):
        ref = np.asarray(ref)
        assert np.abs(mine.numpy() - ref).max() <= REL * np.abs(ref).max()
    assert tr.dispatch_counts["decode_multi"] == 1


def test_early_exit_runs_fewer_iterations(np_params):
    """Once every lane is done the loop stops: budgets 2 and 3 at K=8
    run three forwards, the padded lane is done from the start, and the
    rows past each valid count hold the pad token."""
    _, tr = _runners(np_params)
    tables = [[1, 2], [3, 4]]
    for p, tb in zip(PROMPTS[1:], tables):
        tr.prefill(p, 0, tb, len(p))
    toks, valid = tr.decode_multi(
        [3, 9], [5, 9], tables, [6, 10], 8, np.zeros(2, np.float32),
        np.ones(2, np.float32), np.full(2, -1, np.int32),
        np.zeros((2, 2), np.uint32),
        stop=(np.full(2, -1, np.int32), np.zeros(2, np.int32),
              np.array([2, 3], np.int32), None),
    )
    assert valid.tolist() == [2, 3, 0]
    assert tr.dispatch_counts["decode_iterations"] == 3
    assert (toks[3:] == 0).all() and (toks[2:, 0] == 0).all()
    with pytest.raises(ValueError, match="block_size"):
        tr.decode_multi([3], [5], [[1]], [6], 9, *(np.zeros(1),) * 3,
                        np.zeros((1, 2), np.uint32))


@pytest.mark.parametrize("k", [2, 4])
def test_greedy_streams_match_jax(np_params, jax_streams, k):
    """test_multistep: fused K-step greedy streams, a max_tokens that is
    not a multiple of K, EOS inside a round (device stops: nothing is
    discarded on the host)."""
    kws = [dict(max_tokens=10, temperature=0.0, ignore_eos=True),
           dict(max_tokens=7, temperature=0.0, ignore_eos=True),
           dict(max_tokens=12, temperature=0.0)]
    want = jax_streams(PROMPTS, kws)
    eng = _engine(np_params, k)
    assert _generate(eng, PROMPTS, kws) == want
    assert [len(t) for t in want[:2]] == [10, 7]
    assert eng.runner.dispatch_counts["decode_multi"] > 0
    assert eng.stats().decode_overshoot_tokens_total == 0


def test_stop_ids_min_tokens_and_penalties_match_jax(np_params,
                                                     jax_streams):
    """test_elastic_decode: a stop id landing mid-round, a min_tokens
    gate, presence/frequency/repetition penalties and logit bias ride
    the loop on the device."""
    free = jax_streams(PROMPTS[:1], [dict(max_tokens=12, temperature=0.0,
                                          ignore_eos=True)])[0]
    kws = [dict(max_tokens=12, temperature=0.0, ignore_eos=True,
                stop_token_ids=[free[5]]),
           dict(max_tokens=12, temperature=0.0, min_tokens=6,
                repetition_penalty=1.3, logit_bias={7: 2.0}),
           dict(max_tokens=12, temperature=0.0, ignore_eos=True,
                presence_penalty=0.5, frequency_penalty=0.2)]
    want = jax_streams(PROMPTS, kws)
    eng = _engine(np_params, 4)
    assert _generate(eng, PROMPTS, kws) == want
    assert want[0][-1] == free[5] and len(want[0]) < 12
    assert len(want[1]) >= 6


def test_logprobs_match_jax(np_params, jax_outputs):
    """On-device logprobs of the fused loop equal the JAX engine's host
    entries: the chosen token, its logprob, the top alternatives."""
    kw = dict(max_tokens=9, temperature=0.0, ignore_eos=True, logprobs=3)
    [want] = jax_outputs(PROMPTS[:1], [kw])
    [got] = _engine(np_params, 4).generate(PROMPTS[:1], SamplingParams(**kw))
    assert got.token_ids == want.token_ids
    assert len(got.logprobs) == len(want.logprobs) == 9
    for a, b in zip(got.logprobs, want.logprobs):
        assert a["token_id"] == b["token_id"]
        assert abs(a["logprob"] - b["logprob"]) < 1e-4
        assert [t["token_id"] for t in a["top_logprobs"]] == [
            t["token_id"] for t in b["top_logprobs"]]


def test_sampled_streams_equal_single_step(np_params):
    """Iteration i of a fused round samples with key (seed, step + i):
    seeded sampled streams at K=4 (penalties on one lane) are the port's
    K=1 streams."""
    kws = [dict(max_tokens=10, temperature=0.8, top_p=0.9, seed=7,
                ignore_eos=True),
           dict(max_tokens=10, temperature=0.7, top_k=20, seed=3,
                repetition_penalty=1.2, ignore_eos=True),
           dict(max_tokens=10, temperature=0.0, ignore_eos=True)]
    single = _generate(_engine(np_params, 1), PROMPTS, kws)
    assert _generate(_engine(np_params, 4), PROMPTS, kws) == single


def test_adaptive_k_shrinks_under_cold_prefill(np_params, jax_streams):
    """test_elastic_decode: on the split path a cold multi-chunk arrival
    clamps the round size while its chunks drain, and rounds grow back
    to the cap afterwards; streams equal the JAX engine's and the
    fixed-K engine's."""
    kw = dict(max_tokens=40, temperature=0.0, ignore_eos=True)
    long_prompt = list(range(1, 30))

    def run(adaptive):
        # without the prefill pipeline, as the reference's test runs it:
        # its staged bypass drains the cold chunks before any decode
        # round sees the backlog
        eng = _engine(np_params, 8, max_num_seqs=2, num_kv_blocks=128,
                      max_prefill_chunk=8, adaptive_decode_k=adaptive,
                      prefill_pipeline=False)
        eng.ks = []  # every round's K, in order
        note = eng._note_decode_round
        eng._note_decode_round = lambda seqs, k: (eng.ks.append(k),
                                                  note(seqs, k))
        outs, steps = {}, 0
        eng.add_request("a", prompt_token_ids=PROMPTS[0],
                        sampling_params=SamplingParams(**kw))
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.token_ids
            steps += 1
            if steps == 3:
                eng.add_request("b", prompt_token_ids=long_prompt,
                                sampling_params=SamplingParams(**kw))
        return eng, outs

    eng, outs = run(True)
    ks = eng.ks
    clamp = Scheduler.ADMISSION_K_CLAMP
    assert 8 in ks and clamp in ks
    last_clamped = max(i for i, k in enumerate(ks) if k == clamp)
    assert 8 in ks[last_clamped + 1:]
    assert eng.stats().decode_k_hist[8] == ks.count(8)
    _, fixed = run(False)
    assert outs == fixed
    assert [outs["a"], outs["b"]] == jax_streams(
        [PROMPTS[0], long_prompt], [kw, kw])
