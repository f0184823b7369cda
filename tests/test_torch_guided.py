"""Guided decoding and prompt logprobs in the port against the JAX
package, on the CPU in float32, on the same numpy weights.

- TokenDFA tables: the port's copy of engine/structured.py builds the
  token_class / class_mask / class_trans arrays of the JAX package's for
  the constraints of tests/test_guided_device.py, and the engines
  assemble the same round tables (_device_guided_tables).
- Greedy guided streams equal a JAX engine's at K=1 (host mask), at K=8
  on the default unified rounds (device DFA lanes in the fused and the
  ragged rounds) and at K=8 on split rounds; with free lanes beside
  guided ones (staggered, so mixed rounds carry guided decode lanes),
  with a lane that stops early beside a guided one (the loop carry), near
  the token budget (host steering) and when the tables cannot be built.
  Staged hits / misses and every step's round kind equal the JAX
  engine's too.
- Sampled guided streams cannot be compared across packages (the RNGs
  differ): the port's K=1 and K=8 engines draw the same noise a step
  (keys (seed, step)), so they are held equal to each other and every
  output to its constraint.
- Prompt logprobs (one chunk, several chunks, a prompt the prefix cache
  holds) within 1e-5 relative of the JAX engine's, top-k ids equal.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import production_stack_tpu.engine.structured as jstructured
import production_stack_tpu_torch.engine.structured as tstructured
from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.engine.tokenizer import ByteTokenizer as JByte
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

BASE = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=8, num_kv_blocks=64,
            max_num_seqs=2, max_prefill_chunk=32, seed=0)
SCHEMA = {
    "type": "object",
    "properties": {
        "age": {"type": "integer"},
        "mood": {"enum": ["happy", "sad"]},
    },
    "required": ["age", "mood"],
}
CHOICES = ["alpha", "beta", "betamax"]
CONSTRAINTS = {
    "json": {"guided_json": SCHEMA},
    "yes_no": {"guided_regex": r"(yes|no), [0-9]{2}"},
    "ab8": {"guided_regex": r"[ab]{8}"},
    "on_off": {"guided_regex": r"(on|off)"},
    "choice": {"guided_choice": CHOICES},
}
# the other choice lists of tests/test_guided_device.py, for the tables
TABLE_CASES = {**CONSTRAINTS,
               "left_right": {"guided_choice": ["left", "right"]},
               "go_gone": {"guided_choice": ["go", "gone"]}}
CONFIGS = {
    "k1": dict(num_scheduler_steps=1),
    "k8": dict(num_scheduler_steps=8),
    "k8_split": dict(num_scheduler_steps=8, ragged_dispatch=False),
}
COUNTERS = ("_pf_staged_hits_total", "_pf_staged_misses_total",
            "_pf_chained_chunks_total", "_staged_hits_total",
            "_staged_misses_total", "_ragged_staged_hits_total",
            "_ragged_staged_misses_total")
REL = 1e-5


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_engine(np_params):
    """One JAX engine (XLA path) per configuration."""
    engines = {}

    def get(**cfg):
        key = tuple(sorted(cfg.items()))
        if key not in engines:
            engines[key] = JEngine(
                JConfig(**{**BASE, **cfg}, attention_impl="xla"),
                params=jax.tree_util.tree_map(jnp.asarray, np_params))
        return engines[key]
    return get


def _port(np_params, **cfg):
    return LLMEngine(EngineConfig(**{**BASE, **cfg}, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _valid(name: str, text: str) -> bool:
    """`text` satisfies constraint `name` in full."""
    if name == "json":
        v = json.loads(text)
        return isinstance(v["age"], int) and v["mood"] in ("happy", "sad")
    if name == "choice":
        return text in CHOICES
    return re.fullmatch(CONSTRAINTS[name]["guided_regex"], text) is not None


def _drive(eng, arrivals, sp_cls):
    """Requests (step, rid, prompt, sampling kwargs) arrive at their step.
    Returns ({rid: final output}, [round kind per step], {counter:
    delta})."""
    before = {c: getattr(eng, c) for c in COUNTERS}
    outs, kinds, steps = {}, [], 0
    pending = sorted(arrivals, key=lambda a: a[0])
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= steps:
            _, rid, prompt, kw = pending.pop(0)
            eng.add_request(rid, prompt_token_ids=prompt,
                            sampling_params=sp_cls(**kw))
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o
        kinds.append(eng.last_step_kind)
        steps += 1
        assert steps < 2000, "engine wedged"
    return outs, kinds, {c: getattr(eng, c) - before[c] for c in COUNTERS}


def _scenario(np_params, jax_engine, cfg, arrivals):
    """The same arrivals on a JAX engine and a port engine: greedy streams,
    staged hits / misses, chained chunks and round kinds equal."""
    want = _drive(jax_engine(**cfg), arrivals, JSampling)
    port = _port(np_params, **cfg)
    got = _drive(port, arrivals, SamplingParams)
    assert ({r: o.token_ids for r, o in got[0].items()}
            == {r: o.token_ids for r, o in want[0].items()})
    assert got[2] == want[2]
    assert got[1] == want[1]
    return port, got


# -- tables --------------------------------------------------------------------
def _dfa(pkg, name):
    """TokenDFA of constraint `name` built by `pkg`'s structured module."""
    mod, tok = ((jstructured, JByte()) if pkg == "jax"
                else (tstructured, ByteTokenizer()))
    spec = TABLE_CASES[name]
    if "guided_choice" in spec:
        ids = [tuple(tok.encode(c, add_bos=False))
               for c in spec["guided_choice"]]
        return mod.TokenDFA.from_choices(ids, tok.vocab_size,
                                         tok.eos_token_id)
    kind, arg = (("json", spec["guided_json"]) if "guided_json" in spec
                 else ("regex", spec["guided_regex"]))
    return mod.TokenDFA.build(mod.get_machine(kind, arg),
                              mod.TokenMaskCache(tok), tok.vocab_size,
                              tok.eos_token_id)


@pytest.mark.parametrize("name", sorted(TABLE_CASES))
def test_dfa_tables_equal_jax(name):
    got, want = _dfa("port", name), _dfa("jax", name)
    assert got is not None and want is not None
    assert (got.num_states, got.num_classes) == (want.num_states,
                                                 want.num_classes)
    for field in ("token_class", "class_mask", "class_trans"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.state_index == want.state_index


def test_round_tables_equal_jax(np_params, jax_engine):
    """A batch of two guided lanes and a free one: the engines hand their
    runners the same initial states, machine rows and padded tables."""
    jeng = jax_engine(**CONFIGS["k8"], max_num_seqs=3)
    port = _port(np_params, **CONFIGS["k8"], max_num_seqs=3)
    tables = []
    for eng, cls in ((jeng, JSampling), (port, SamplingParams)):
        for rid, kw in (("j", CONSTRAINTS["json"]), ("f", {}),
                        ("c", CONSTRAINTS["choice"])):
            eng.add_request(f"t-{rid}", prompt_token_ids=[5, 6, 7],
                            sampling_params=cls(max_tokens=8, **kw))
        seqs = [eng._seqs[f"t-{r}"] for r in "jfc"]
        tables.append(eng._device_guided_tables(seqs)[1:])
        for r in "jfc":
            eng.abort_request(f"t-{r}")
    for a, b in zip(*tables):
        assert a.shape == b.shape and np.array_equal(a, b)


# -- greedy streams ------------------------------------------------------------
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_greedy_guided_stream_equals_jax(np_params, jax_engine, config,
                                         name):
    cfg = CONFIGS[config]
    kw = dict(max_tokens=64, temperature=0.0, seed=7, **CONSTRAINTS[name])
    want = jax_engine(**cfg).generate(["tell me"], JSampling(**kw))[0]
    port = _port(np_params, **cfg)
    got = port.generate(["tell me"], SamplingParams(**kw))[0]
    assert got.token_ids == want.token_ids
    assert _valid(name, got.text), got.text
    if cfg["num_scheduler_steps"] > 1:
        # the constraint rode the fused rounds on the device tables
        assert port.runner.guided_rounds > 0
        assert port._guided_host_rounds_total == 0


def test_guided_and_free_lanes_staggered_equal_jax(np_params, jax_engine):
    """Free and guided lanes arriving while others prefill (chunk 8), at
    the defaults with K=8: mixed ragged rounds carry guided decode lanes,
    a round with a guided lane is never staged or chained, and the free
    lanes' rounds are staged after the guided lanes finish. Streams,
    staged hits / misses and every step's round kind equal the JAX
    engine's."""
    rng = np.random.RandomState(11)
    p = [rng.randint(1, 250, size=n).tolist() for n in (6, 29, 21, 5)]
    free = dict(max_tokens=24, temperature=0.0, ignore_eos=True)
    arrivals = [
        (0, "free0", p[0], free),
        (1, "json", p[1], dict(max_tokens=48, temperature=0.0,
                               **CONSTRAINTS["json"])),
        (4, "choice", p[2], dict(max_tokens=48, temperature=0.0,
                                 **CONSTRAINTS["choice"])),
        (9, "free1", p[3], free),
    ]
    port, (outs, kinds, counts) = _scenario(
        np_params, jax_engine,
        dict(num_scheduler_steps=8, max_num_seqs=4, max_prefill_chunk=8),
        arrivals)
    assert "ragged" in kinds
    assert port.runner.guided_rounds > 0
    assert _valid("json", outs["json"].text)
    assert _valid("choice", outs["choice"].text)
    assert counts["_staged_hits_total"] + counts[
        "_ragged_staged_hits_total"] > 0


def test_guided_lane_beside_early_stop_equals_jax(np_params, jax_engine):
    """K=8: a lane that freezes after 3 tokens (its budget) and a lane
    that stops on a stop id, beside a guided lane that runs on. A carry
    field read at the wrong index (the done mask, the valid counts, the
    DFA state) changes a stream."""
    arrivals = [
        (0, "g", [9, 8, 7], dict(max_tokens=40, temperature=0.0,
                                 **CONSTRAINTS["json"])),
        (0, "short", [1, 2, 3], dict(max_tokens=3, temperature=0.0,
                                     ignore_eos=True)),
        (0, "stopid", [4, 5, 6], dict(max_tokens=30, temperature=0.0,
                                      ignore_eos=True,
                                      stop_token_ids=[101, 202, 33, 44])),
    ]
    port, (outs, _, _) = _scenario(
        np_params, jax_engine,
        dict(num_scheduler_steps=8, max_num_seqs=3), arrivals)
    assert len(outs["short"].token_ids) == 3
    assert _valid("json", outs["g"].text)
    assert port.runner.guided_rounds > 0


def test_near_budget_rounds_take_the_host_mask_like_jax(np_params,
                                                        jax_engine):
    """A guided lane within K + GUIDED_STEER_BOUND tokens of max_tokens
    leaves the fused round for the host's steered mask; the steps before
    ran on the device tables."""
    kw = dict(max_tokens=20, temperature=0.0, guided_regex=r"[ab]{16}")
    cfg = CONFIGS["k8"]
    want = jax_engine(**cfg).generate(["x"], JSampling(**kw))[0]
    port = _port(np_params, **cfg)
    got = port.generate(["x"], SamplingParams(**kw))[0]
    assert got.token_ids == want.token_ids
    assert re.fullmatch(r"[ab]{16}", got.text)
    assert port.runner.guided_rounds > 0
    assert port._guided_host_rounds_total > 0


def test_unbuildable_tables_take_the_host_mask_like_jax(np_params,
                                                        jax_engine,
                                                        monkeypatch):
    """A constraint whose TokenDFA cannot be built (over budget) keeps
    the host-masked single-step path in both packages."""
    for mod in (jstructured, tstructured):
        monkeypatch.setattr(mod.TokenDFA, "build",
                            staticmethod(lambda *a, **k: None))
        mod._TOKEN_DFA_CACHE.clear()
    try:
        kw = dict(max_tokens=32, temperature=0.0, guided_regex=r"(on|off)")
        cfg = CONFIGS["k8"]
        want = jax_engine(**cfg).generate(["x"], JSampling(**kw))[0]
        port = _port(np_params, **cfg)
        got = port.generate(["x"], SamplingParams(**kw))[0]
        assert got.token_ids == want.token_ids and got.text in ("on", "off")
        assert port.runner.guided_rounds == 0
        assert port._guided_host_rounds_total > 0
    finally:
        for mod in (jstructured, tstructured):
            mod._TOKEN_DFA_CACHE.clear()


def test_device_tables_upload_once_per_constraint_set(np_params):
    """The tables stay on the device across rounds: two requests of one
    constraint upload them once, a new constraint once more."""
    port = _port(np_params, **CONFIGS["k8_split"])
    kw = dict(max_tokens=48, temperature=0.0, **CONSTRAINTS["json"])
    port.generate(["a", "b"], SamplingParams(**kw))
    assert port.runner.guided_rounds > 1
    assert port.runner.guided_table_uploads == 1
    port.generate(["a"], SamplingParams(max_tokens=32, temperature=0.0,
                                        **CONSTRAINTS["on_off"]))
    assert port.runner.guided_table_uploads == 2


@pytest.mark.parametrize("name", ["ab8", "yes_no", "choice"])
def test_sampled_guided_k1_equals_k8(np_params, name):
    """temperature 0.9: a fused round draws step i's noise from key
    (seed, step + i), a single step from (seed, step), so the port's K=8
    device lanes give its K=1 host-masked stream."""
    kw = dict(max_tokens=24, temperature=0.9, seed=7, **CONSTRAINTS[name])
    outs = [_port(np_params, **CONFIGS[c]).generate(
        ["tell me", "more"], SamplingParams(**kw)) for c in ("k1", "k8")]
    assert [o.token_ids for o in outs[0]] == [o.token_ids for o in outs[1]]
    assert all(_valid(name, o.text) for o in outs[0])


# -- prompt logprobs -----------------------------------------------------------
PROMPT = list(range(7, 40))  # 33 tokens


def _plp(eng, cls, prompt, n=5):
    sp = cls(max_tokens=3, temperature=0.0, prompt_logprobs=n,
             ignore_eos=True)
    return eng.generate([prompt], sp)[0]


def _assert_plp_close(got, want, n_prompt):
    assert got.token_ids == want.token_ids
    assert got.prompt_logprobs[0] is None and want.prompt_logprobs[0] is None
    assert len(got.prompt_logprobs) == len(want.prompt_logprobs) == n_prompt
    for g, w in zip(got.prompt_logprobs[1:], want.prompt_logprobs[1:]):
        assert g["token_id"] == w["token_id"]
        assert g["logprob"] == pytest.approx(w["logprob"], rel=REL)
        assert ([t["token_id"] for t in g["top_logprobs"]]
                == [t["token_id"] for t in w["top_logprobs"]])
        np.testing.assert_allclose(
            [t["logprob"] for t in g["top_logprobs"]],
            [t["logprob"] for t in w["top_logprobs"]], rtol=REL)


@pytest.mark.parametrize("chunk,pipeline", [(64, True), (8, True),
                                            (8, False)])
def test_prompt_logprobs_equal_jax(np_params, jax_engine, chunk, pipeline):
    """One chunk, and a prompt in five chunks (the cross-chunk target
    alignment), with and without the prefill pipeline."""
    cfg = dict(num_kv_blocks=128, max_prefill_chunk=chunk,
               prefill_pipeline=pipeline)
    want = _plp(jax_engine(**cfg), JSampling, PROMPT)
    got = _plp(_port(np_params, **cfg), SamplingParams, PROMPT)
    _assert_plp_close(got, want, len(PROMPT))


def test_prompt_logprobs_skip_the_prefix_cache_like_jax(np_params,
                                                        jax_engine):
    """A prompt the prefix cache already holds is computed in full for
    prompt logprobs (nothing is reused), beside a plain request."""
    cfg = dict(num_kv_blocks=128, max_prefill_chunk=16, max_num_seqs=2)
    res = []
    for eng, cls in ((jax_engine(**cfg), JSampling),
                     (_port(np_params, **cfg), SamplingParams)):
        eng.generate([PROMPT], cls(max_tokens=2, temperature=0.0,
                                   ignore_eos=True))
        plain, plp = eng.generate(
            [PROMPT[:20], PROMPT],
            [cls(max_tokens=4, temperature=0.0, ignore_eos=True),
             cls(max_tokens=3, temperature=0.0, prompt_logprobs=3,
                 ignore_eos=True)])
        assert plp.num_cached_tokens == 0 and plain.num_cached_tokens > 0
        res.append((plain, plp))
    (jplain, jplp), (plain, plp) = res
    assert plain.token_ids == jplain.token_ids
    _assert_plp_close(plp, jplp, len(PROMPT))
