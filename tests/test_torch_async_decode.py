"""The port's double-buffered decode (``async_decode``) against its own
synchronous path and the JAX package's, on the CPU in float32.

The 13 scenarios of tests/test_async_decode.py run on port engines and
JAX engines at that file's config (pst-tiny-debug, f32, block 8, K=4, on
the same seeded weights):

- async streams equal sync streams in each package, greedy and sampled;
- the port's async greedy streams equal the JAX engine's async streams
  (sampled noise comes from each package's own generator, so sampled
  streams are held within the port, as in tests/test_torch_multistep.py);
- the chain engages as often as in the JAX engine, EOS and stop ids fire
  mid-chain, the overshoot stays within one round a finished stream,
  penalties fall back to the synchronous path, a request arriving
  mid-pipeline flushes it, an abort mid-pipeline emits no output and
  does not count as finished, aborting every request still drains the
  pending round, and max_model_len bounds the chain.

One engine of each kind (port / JAX, async / sync) serves every case;
the max_model_len case builds its own four.
"""

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
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

CFG = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=8, num_kv_blocks=128,
           max_num_seqs=4, max_prefill_chunk=16, num_scheduler_steps=4,
           seed=0)
PKGS = ("port", "jax")


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _make(np_params, pkg, async_decode, **over):
    cfg = {**CFG, "async_decode": async_decode, **over}
    if pkg == "port":
        return LLMEngine(EngineConfig(**cfg, device="cpu"),
                         params=params_from_numpy(np_params, "cpu"))
    return JEngine(JConfig(**cfg, attention_impl="xla"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))


@pytest.fixture(scope="module")
def engines(np_params):
    """(package, async) -> engine, shared by the cases."""
    return {(pkg, a): _make(np_params, pkg, a)
            for pkg in PKGS for a in (True, False)}


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 384, size=n).tolist() for n in (5, 19, 11)]


def _sp(pkg, **kw):
    return (SamplingParams if pkg == "port" else JSampling)(**kw)


def run(eng, pkg, prompts, **kw):
    return [o.token_ids for o in eng.generate(prompts, _sp(pkg, **kw))]


def _count_chains(monkeypatch, eng):
    """Rounds dispatched through the chain (_can_chain true)."""
    box = {"n": 0}
    orig = eng._can_chain

    def counting():
        r = orig()
        box["n"] += bool(r)
        return r

    monkeypatch.setattr(eng, "_can_chain", counting)
    return box


def _count_dispatches(monkeypatch, eng):
    """Fused decode rounds dispatched (decode_multi calls)."""
    box = {"n": 0}
    orig = eng.runner.decode_multi

    def counting(*a, **kw):
        box["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(eng.runner, "decode_multi", counting)
    return box


def _async_vs_sync(engines, prompts, **kw):
    """{package: (async streams, sync streams)} for one request set."""
    return {pkg: (run(engines[pkg, True], pkg, prompts, **kw),
                  run(engines[pkg, False], pkg, prompts, **kw))
            for pkg in PKGS}


def test_async_matches_sync_greedy(engines):
    got = _async_vs_sync(engines, _prompts(), max_tokens=25,
                         temperature=0.0, ignore_eos=True)
    for a, s in got.values():
        assert a == s
        assert all(len(t) == 25 for t in a)
    assert got["port"][0] == got["jax"][0]


def test_async_matches_sync_sampled(engines):
    """Chained rounds derive the sync path's (seed, generated_len + i)
    keys (keys[:, 1] += k)."""
    got = _async_vs_sync(engines, _prompts(), max_tokens=21,
                         temperature=0.9, top_p=0.9, seed=7,
                         ignore_eos=True)
    for a, s in got.values():
        assert a == s


def test_async_pipeline_actually_chains(engines, monkeypatch):
    chained = {pkg: _count_chains(monkeypatch, engines[pkg, True])
               for pkg in PKGS}
    outs = {pkg: run(engines[pkg, True], pkg, _prompts(), max_tokens=40,
                     temperature=0.0, ignore_eos=True) for pkg in PKGS}
    assert outs["port"] == outs["jax"]
    assert chained["port"]["n"] >= 3
    assert chained["port"]["n"] == chained["jax"]["n"]


def test_async_with_eos_stops_matches_sync(engines):
    got = _async_vs_sync(engines, _prompts(), max_tokens=16,
                         temperature=0.0)
    for a, s in got.values():
        assert a == s
    assert got["port"][0] == got["jax"][0]


def test_async_chains_with_eos_enabled(engines, monkeypatch):
    """EOS active: the chain is speculative, overshoot discarded."""
    chained = {pkg: _count_chains(monkeypatch, engines[pkg, True])
               for pkg in PKGS}
    got = _async_vs_sync(engines, _prompts(), max_tokens=40,
                         temperature=0.0)
    for pkg, (a, s) in got.items():
        assert a == s
        assert chained[pkg]["n"] >= 3
    assert got["port"][0] == got["jax"][0]


def test_async_chains_with_stop_token_ids(engines, monkeypatch):
    """A stop id the greedy streams never emit does not stop chaining."""
    base = run(engines["port", False], "port", _prompts(), max_tokens=32,
               temperature=0.0, ignore_eos=True)
    never = next(t for t in range(384)
                 if all(t not in ids for ids in base))
    chained = {pkg: _count_chains(monkeypatch, engines[pkg, True])
               for pkg in PKGS}
    got = _async_vs_sync(engines, _prompts(), max_tokens=32,
                         temperature=0.0, ignore_eos=True,
                         stop_token_ids=[never])
    for pkg, (a, s) in got.items():
        assert a == s
        assert all(len(t) == 32 for t in a)
        assert chained[pkg]["n"] >= 3
    assert got["port"][0] == got["jax"][0]


def _firing_stop(engines):
    """A stop id ~2/3 into the longest greedy stream."""
    probe = run(engines["port", False], "port", _prompts(), max_tokens=32,
                temperature=0.0, ignore_eos=True)
    return probe[0][20]


def test_async_stop_token_fires_mid_chain(engines, monkeypatch):
    stop_tok = _firing_stop(engines)
    chained = {pkg: _count_chains(monkeypatch, engines[pkg, True])
               for pkg in PKGS}
    got = _async_vs_sync(engines, _prompts(), max_tokens=32,
                         temperature=0.0, ignore_eos=True,
                         stop_token_ids=[stop_tok])
    for pkg, (a, s) in got.items():
        assert a == s
        assert a[0][-1] == stop_tok and len(a[0]) <= 21
        assert chained[pkg]["n"] >= 1
    assert got["port"][0] == got["jax"][0]


def test_async_overshoot_waste_bounded(engines, monkeypatch):
    """At most one extra device round a finished stream."""
    stop_tok = _firing_stop(engines)
    kw = dict(max_tokens=32, temperature=0.0, ignore_eos=True,
              stop_token_ids=[stop_tok])
    for pkg in PKGS:
        sync_n = _count_dispatches(monkeypatch, engines[pkg, False])
        out_s = run(engines[pkg, False], pkg, _prompts(), **kw)
        async_n = _count_dispatches(monkeypatch, engines[pkg, True])
        out_a = run(engines[pkg, True], pkg, _prompts(), **kw)
        assert out_a == out_s
        assert async_n["n"] <= sync_n["n"] + len(out_s)


def test_async_with_penalties_falls_back(engines):
    got = _async_vs_sync(engines, _prompts(), max_tokens=12,
                         temperature=0.0, ignore_eos=True,
                         repetition_penalty=1.3)
    for a, s in got.values():
        assert a == s
    assert got["port"][0] == got["jax"][0]


def test_async_mixed_arrival_mid_generation(engines):
    """A request arriving while the pipeline chains flushes it."""
    prompts = _prompts()

    def staged(eng, pkg):
        sp = _sp(pkg, max_tokens=18, temperature=0.0, ignore_eos=True)
        outs = {}
        eng.add_request("r0", prompt_token_ids=prompts[0],
                        sampling_params=sp)
        for _ in range(4):  # let the pipeline spin up
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.token_ids
        eng.add_request("r1", prompt_token_ids=prompts[1],
                        sampling_params=sp)
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.token_ids
        return [outs["r0"], outs["r1"]]

    got = {(pkg, a): staged(engines[pkg, a], pkg)
           for pkg in PKGS for a in (True, False)}
    for pkg in PKGS:
        assert got[pkg, True] == got[pkg, False]
    assert got["port", True] == got["jax", True]


def _until_pending(eng):
    for _ in range(20):
        eng.step()
        if eng._pending_decode is not None:
            return
    raise AssertionError("no round went in flight")


def test_abort_mid_pipeline_no_spurious_output(engines):
    """Aborting a request whose round is in flight emits no finished
    output for it and does not count it as finished."""
    prompts = _prompts()
    kept = {}
    for pkg in PKGS:
        eng = engines[pkg, True]
        sp = _sp(pkg, max_tokens=40, temperature=0.0, ignore_eos=True)
        done0 = eng.stats().requests_finished_total
        eng.add_request("keep", prompt_token_ids=prompts[0],
                        sampling_params=sp)
        eng.add_request("gone", prompt_token_ids=prompts[1],
                        sampling_params=sp)
        _until_pending(eng)
        assert eng.abort_request("gone")
        outs = []
        while eng.has_unfinished():
            outs.extend(eng.step())
        finished = [o for o in outs if o.finished]
        assert [o.request_id for o in finished] == ["keep"]
        assert eng.stats().requests_finished_total == done0 + 1
        kept[pkg] = finished[0].token_ids
    assert kept["port"] == kept["jax"]


def test_abort_all_mid_pipeline_drains(engines):
    """With every request aborted mid-flight, has_unfinished() holds
    until the pending round is flushed."""
    for pkg in PKGS:
        eng = engines[pkg, True]
        eng.add_request("only", prompt_token_ids=_prompts()[0],
                        sampling_params=_sp(pkg, max_tokens=40,
                                            temperature=0.0,
                                            ignore_eos=True))
        _until_pending(eng)
        eng.abort_request("only")
        assert eng.has_unfinished()
        outs = eng.step()
        assert eng._pending_decode is None
        assert not eng.has_unfinished()
        assert [o.request_id for o in outs if o.finished] == []


def test_async_respects_max_model_len(np_params):
    """Lanes near the context limit do not chain past it."""
    prompts = [_prompts()[0]]
    outs = {}
    for pkg in PKGS:
        for a in (True, False):
            eng = _make(np_params, pkg, a, max_model_len=48)
            outs[pkg, a] = run(eng, pkg, prompts, max_tokens=200,
                               temperature=0.0, ignore_eos=True)
    for pkg in PKGS:
        assert outs[pkg, True] == outs[pkg, False]
        assert len(outs[pkg, True][0]) == 48 - len(prompts[0])
    assert outs["port", True] == outs["jax", True]
