"""Speculative decoding in the port (n-gram prompt-lookup drafts, one
packed verify forward a round) against the JAX package, on the CPU in
float32 with the same weights (tests/test_spec_decode.py's scenarios).

- Engines at the JAX defaults (unified ragged rounds, the prefill
  pipeline) with num_speculative_tokens=4: greedy streams equal the JAX
  spec engine's and the port's plain engine's, the draft and accepted
  counts equal the JAX engine's (drafts depend only on the tokens), and
  the spec engine needs fewer decode + verify dispatches than plain
  decode. Sampled lanes: the port draws its noise with numpy from the
  same (seed, step) keys as its sequential decode, so they are held to
  the port's own plain streams (the JAX package's threefry draws other
  numbers).
- _ngram_drafts equal the JAX engine's on the same sequences.
- verify_batch on ONE cache state (the port's after its prefills, copied
  into the JAX runner): greedy rows' tokens equal, the written KV within
  1e-5 relative, on the ragged kernel's seam and composed
  (--no-ragged-kernel), without and with a LoRA adapter, uniform and
  per lane.
- A decode stage built before a spec round misses by its fingerprint
  (counted, as in the JAX engine) and is never chained after a verify.
- The vllm:spec_decode_* families of a spec engine, rendered by the
  port, equal the JAX EngineMetrics' through prometheus_client.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.metrics import EngineMetrics as JMetrics
from production_stack_tpu.engine.model_runner import ModelRunner as JRunner
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.engine.sequence import Sequence as JSequence
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine.__main__ import (
    build_parser,
    config_from_args,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.lora import save_adapter_npz
from production_stack_tpu_torch.engine.metrics import EngineMetrics
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.sequence import Sequence
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
MC = get_model_config("pst-tiny-debug")
# tests/test_spec_decode.py's engine
BASE = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=8, num_kv_blocks=64,
            max_num_seqs=2, max_prefill_chunk=32, seed=0)
# a prompt whose greedy continuation is repetitive, so prompt lookup has
# material to draft from
PROMPT = [65, 66, 67, 65, 66, 67, 65, 66, 67, 65, 66]
B8_PROMPTS = [[b, b + 1, b + 2, b, b + 1, b + 2, b, b + 1]
              for b in range(60, 68)]


@pytest.fixture(scope="module")
def np_params():
    params = jllama.init_params(MC, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _port(np_params, spec=4, **over):
    return LLMEngine(EngineConfig(**{**BASE, **over},
                                  num_speculative_tokens=spec, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _jax(np_params, spec=4, **over):
    return JEngine(JConfig(**{**BASE, **over}, num_speculative_tokens=spec,
                           attention_impl="xla"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))


def _run(eng, prompts, kws, sp_cls):
    outs = eng.generate(prompts, [sp_cls(**kw) for kw in kws])
    return [o.token_ids for o in outs]


def _rounds(eng) -> int:
    """Decode + verify dispatches (the round trips spec decode saves)."""
    c = eng.runner.dispatch_counts
    return c["decode"] + c["decode_multi"] + c["verify_batch"]


def _counts(eng) -> tuple[int, int]:
    st = eng.stats()
    return st.spec_draft_tokens_total, st.spec_accepted_tokens_total


def _greedy(n, **kw):
    return dict(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


# -- config and CLI -------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", [(1, 3), (2, 2), (0, 3), (3, 2), (1, 1)])
def test_ngram_bounds_check_matches_jax(lo, hi):
    """EngineConfig(num_speculative_tokens=4) constructs, and the 1 <= min <= max check refuses what the JAX
    config refuses, with its message."""
    kw = dict(BASE, num_speculative_tokens=4, ngram_prompt_lookup_min=lo,
              ngram_prompt_lookup_max=hi)
    try:
        JConfig(**kw)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        assert EngineConfig(**kw, device="cpu").num_speculative_tokens == 4
    else:
        with pytest.raises(ValueError) as e:
            EngineConfig(**kw, device="cpu")
        assert str(e.value) == want


def test_cli_flags_reach_the_config():
    cfg = config_from_args(build_parser().parse_args([
        "--device", "cpu", "--num-speculative-tokens", "4",
        "--ngram-prompt-lookup-max", "5", "--ngram-prompt-lookup-min", "2"]))
    assert (cfg.num_speculative_tokens, cfg.ngram_prompt_lookup_max,
            cfg.ngram_prompt_lookup_min) == (4, 5, 2)


# -- drafts ------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_drafts_equal_jax(np_params, seed):
    """The same sequences (tests/test_spec_decode.py's two and random
    ones over a small alphabet) draft the same tokens at each k and
    n-gram range."""
    rng = np.random.RandomState(seed)
    seqs = [[1, 2, 3, 9, 1, 2, 3], [5, 6, 7, 8]] + [
        rng.randint(1, 6, size=n).tolist() for n in (3, 12, 40)]
    for lo, hi in ((1, 3), (2, 4)):
        port = _port(np_params, ngram_prompt_lookup_min=lo,
                     ngram_prompt_lookup_max=hi)
        jeng = JEngine.__new__(JEngine)  # the method reads config only
        jeng.config = JConfig(**BASE, num_speculative_tokens=4,
                              ngram_prompt_lookup_min=lo,
                              ngram_prompt_lookup_max=hi)
        for ids in seqs:
            for k in (1, 4):
                mine = port._ngram_drafts(
                    Sequence("s", ids, SamplingParams(), None), k)
                ref = jeng._ngram_drafts(
                    JSequence("s", ids, JSampling(), None), k)
                assert mine == ref, (ids, k, lo, hi)
    assert port._ngram_drafts(
        Sequence("s", [1, 2, 3, 9, 1, 2, 3], SamplingParams(), None),
        4) == [9, 1, 2, 3]


# -- engine scenarios (tests/test_spec_decode.py) ---------------------------------
@pytest.mark.parametrize("case", [
    "greedy", "batch2", "max_tokens", "multistep", "batch8"])
def test_greedy_spec_streams_equal_jax_and_plain(np_params, case):
    """Greedy streams equal the JAX spec engine's and the port's plain
    engine's; drafts and accepted drafts equal the JAX engine's; fewer
    decode + verify dispatches than plain decode."""
    over, prompts, kws = {}, [PROMPT], [_greedy(32)]
    if case == "batch2":
        prompts = [PROMPT, [70, 71, 72, 70, 71, 72, 70]]
        kws = [_greedy(10)] * 2
    elif case == "max_tokens":
        kws = [_greedy(7)]
    elif case == "multistep":
        over, kws = {"num_scheduler_steps": 4}, [_greedy(20)]
    elif case == "batch8":
        over, prompts, kws = {"max_num_seqs": 8}, B8_PROMPTS, [_greedy(16)] * 8
    # the plain reference decodes one token a round (K=1), as in
    # tests/test_spec_decode.py's multistep case
    spec = _port(np_params, **over)
    plain = _port(np_params, 0, **{**over, "num_scheduler_steps": 1})
    jeng = _jax(np_params, **over)
    got = _run(spec, prompts, kws, SamplingParams)
    assert got == _run(jeng, prompts, kws, JSampling)
    assert got == _run(plain, prompts, kws, SamplingParams)
    assert _counts(spec) == (jeng._spec_drafts_total,
                             jeng._spec_accepted_total)
    assert _counts(spec)[1] > 0
    assert _rounds(spec) < _rounds(plain)
    if case == "max_tokens":
        assert len(got[0]) == 7


def test_stop_token_mid_acceptance_equals_plain(np_params):
    """A stop token accepted mid-draft ends the stream exactly where
    plain decode ends it."""
    probe = _run(_port(np_params, 0), [PROMPT], [_greedy(24)],
                 SamplingParams)[0]
    kws = [_greedy(24, stop_token_ids=[probe[10]])]
    got = _run(_port(np_params), [PROMPT], kws, SamplingParams)
    assert got == _run(_port(np_params, 0), [PROMPT], kws, SamplingParams)
    assert got == _run(_jax(np_params), [PROMPT], kws, JSampling)
    assert got[0][-1] == probe[10] and len(got[0]) <= 11


def test_sampled_lanes_equal_sequential(np_params):
    """temperature > 0: every verify row samples with the key its
    sequential step uses, so a sampled spec stream is the port's plain
    stream; beside a greedy lane in one packed verify, the greedy lane
    also equals the JAX engine's."""
    kw = dict(max_tokens=12, temperature=0.9, seed=5, ignore_eos=True)
    spec = _port(np_params)
    assert (_run(spec, [PROMPT], [kw], SamplingParams)
            == _run(_port(np_params, 0), [PROMPT], [kw], SamplingParams))
    assert spec.runner.dispatch_counts["verify_batch"] > 0
    prompts = [PROMPT, [70, 71, 72, 70, 71, 72, 70, 71]]
    kws = [_greedy(10), dict(max_tokens=10, temperature=0.8, seed=11,
                             ignore_eos=True)]
    got = _run(_port(np_params), prompts, kws, SamplingParams)
    assert got == _run(_port(np_params, 0), prompts, kws, SamplingParams)
    assert got[0] == _run(_jax(np_params), prompts, kws, JSampling)[0]


def test_ineligible_lane_sends_batch_to_plain_path(np_params):
    """A lane with logprobs (or penalties, bias, a guided mask) makes the
    whole batch decode plainly: no verify dispatch, no draft counted."""
    eng = _port(np_params)
    prompts = [PROMPT, [70, 71, 72, 70, 71, 72, 70]]
    got = _run(eng, prompts, [_greedy(8), _greedy(8, logprobs=1)],
               SamplingParams)
    assert eng.runner.dispatch_counts["verify_batch"] == 0
    assert _counts(eng) == (0, 0)
    assert got == _run(_port(np_params, 0), prompts,
                       [_greedy(8), _greedy(8, logprobs=1)], SamplingParams)


def test_stale_decode_stage_misses_after_spec_round(np_params):
    """K=4 with the decode prefetch: a fused round (no drafts yet) stages
    the next one; a spec round then moves the lanes by its accepted
    tokens, so that stage misses by its fingerprint, counted as in the
    JAX engine, and no fused round is ever chained right after a verify.
    Streams, staged hits / misses and spec counts equal the JAX
    engine's."""
    prompts = [[10, 20, 30, 40, 50, 60, 70, 80, 90, 100]]
    kws = [_greedy(40)]
    over = {"num_scheduler_steps": 4}
    port, jeng = _port(np_params, **over), _jax(np_params, **over)
    calls = []
    verify, multi = port.runner.verify_batch, port.runner.decode_multi

    def spy_verify(*a, **kw):
        calls.append("verify")
        return verify(*a, **kw)

    def spy_multi(*a, **kw):
        calls.append("chained" if kw.get("staged") is not None else "multi")
        return multi(*a, **kw)

    port.runner.verify_batch = spy_verify
    port.runner.decode_multi = spy_multi
    got = _run(port, prompts, kws, SamplingParams)
    assert got == _run(jeng, prompts, kws, JSampling)
    assert "verify" in calls and "multi" in calls
    assert all(b != "chained" for a, b in zip(calls, calls[1:])
               if a == "verify")
    assert port._staged_misses_total > 0
    assert ((port._staged_hits_total, port._staged_misses_total)
            == (jeng._staged_hits_total, jeng._staged_misses_total))
    assert _counts(port) == (jeng._spec_drafts_total,
                             jeng._spec_accepted_total)


def test_spec_metrics_equal_jax_families(np_params):
    """A spec engine's vllm:spec_decode_* counters, rendered by the port,
    equal the JAX EngineMetrics' fed the JAX spec engine's snapshot."""
    port, jeng = _port(np_params), _jax(np_params)
    _run(port, [PROMPT], [_greedy(24)], SamplingParams)
    _run(jeng, [PROMPT], [_greedy(24)], JSampling)
    reg = CollectorRegistry()
    ref = JMetrics("m", registry=reg)
    ref.update_from_snapshot(jeng.stats())

    def fams(text):
        return {f.name: (f.type, [(s.name, s.value) for s in f.samples
                                  if not s.name.endswith("_created")])
                for f in text_string_to_metric_families(text)
                if f.name.startswith("vllm:spec_decode")
                and not f.name.endswith("_created")}

    got = fams(EngineMetrics("m").render(port.stats()))
    assert len(got) == 2 and got == fams(generate_latest(reg).decode())
    assert got["vllm:spec_decode_num_draft_tokens"][1][0][1] > 0


# -- verify_batch on one cache state ---------------------------------------------
def _adapter(seed):
    rng = np.random.RandomState(seed)
    L, h = MC.num_layers, MC.hidden_size
    dims = {"wq": (h, MC.q_size), "wk": (h, MC.kv_size),
            "wv": (h, MC.kv_size), "wo": (MC.q_size, h)}
    w = {"scaling": np.float32(0.5)}
    for t, (din, dout) in dims.items():
        w[f"{t}_A"] = rng.randn(L, din, 2).astype(np.float32) * 0.2
        w[f"{t}_B"] = rng.randn(L, 2, dout).astype(np.float32) * 0.2
    return w


@pytest.mark.parametrize("ragged,lora", [
    (True, None), (False, None), (True, "uniform"), (True, "per_lane"),
    (False, "per_lane"),
])
def test_verify_batch_matches_jax(np_params, tmp_path, ragged, lora):
    """Three lanes' chunks [last, d_1..d_k] (k = 4, 2, 0) after their
    prefills: greedy rows' tokens equal JAX verify_batch's, every row;
    the KV written within 1e-5 relative. Composed: one prefill launch a
    lane a layer; LoRA through the uniform and per-row slot paths."""
    cfg = dict(BASE, max_num_seqs=4, num_kv_blocks=64)
    if lora is not None:
        cfg.update(enable_lora=True, max_loras=2, max_lora_rank=2)
    jr = JRunner(JConfig(**cfg, attention_impl="xla"),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    tr = ModelRunner(EngineConfig(**cfg, ragged_kernel=ragged,
                                  ragged_dispatch=False, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    slots = None
    if lora is not None:
        for i, name in enumerate(("a", "b")):
            path = str(tmp_path / f"{name}.npz")
            save_adapter_npz(path, _adapter(7 + i))
            jr.lora_manager.load(name, path)
            tr.lora_manager.load(name, path)
        slots = [1, 1, 1] if lora == "uniform" else [1, 0, 2]
    prompts = [list(range(1, 12)), [50, 60, 70, 80, 90],
               [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19]]
    tables = [[1, 2, 3], [4, 5], [6, 7, 8]]
    for p, tb, sl in zip(prompts, tables, slots or [0] * 3):
        tr.prefill(p, 0, tb, len(p), lora_slot=sl)
    jr.k_cache = jnp.asarray(tr.k_cache.numpy())
    jr.v_cache = jnp.asarray(tr.v_cache.numpy())
    chunks = [[3, 4, 5, 6, 7], [9, 10, 11], [12]]
    starts = [len(p) for p in prompts]
    n = len(chunks)
    sampling = (np.zeros(n, np.float32), np.ones(n, np.float32),
                np.full(n, -1, np.int32), np.zeros(n, np.float32),
                np.arange(n, dtype=np.uint32), np.zeros(n, np.int64))
    args = (chunks, starts, tables,
            [s + len(c) for s, c in zip(starts, chunks)], sampling)
    want = np.asarray(jr.verify_batch(*args, lora_slots=slots))
    got = tr.verify_batch(*args, lora_slots=slots)
    assert got.shape == want.shape == (3, 8)
    for lane, c in enumerate(chunks):
        np.testing.assert_array_equal(got[lane, :len(c)],
                                      want[lane, :len(c)])
    # block 0 is the null block every padding row writes (which padding
    # row lands there last is unspecified in both packages)
    bs = BASE["block_size"]
    for mine, ref in ((tr.k_cache, jr.k_cache), (tr.v_cache, jr.v_cache)):
        ref = np.asarray(ref)[:, :, bs:]
        assert (np.abs(mine.numpy()[:, :, bs:] - ref).max()
                <= REL * np.abs(ref).max())
    assert tr.dispatch_counts["verify_batch"] == 1
