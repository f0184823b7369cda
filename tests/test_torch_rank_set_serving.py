"""Async decode, the serving warm-up sweep and the long-prefill ring on a
port rank set, against the JAX meshed engine.

The JAX meshed engine serves each of them under tensor parallelism on
one host (here on the conftest's 8-device CPU mesh); the port's rank set
is processes, rank 0 in this process and the others spawned over gloo
(parallel/launch.py). The model is tests/test_torch_rank_set_features.py's
tiny one (16 q heads over 8 kv heads, head_dim 8, 2 layers), float32,
with the same JAX-initialised weights on both sides; the ring runs it at
a longer max_model_len.

- Async decode at tp=2, pp=2 and pp=2 x tp=2, K=4: greedy streams equal
  the JAX meshed engine's of the same layout and the port's synchronous
  rank set's; every follower ran chained rounds on its own device tokens
  and checked each against rank 0's; a follower whose tokens part from
  rank 0's takes the set down with RankSetError.
- precompile_serving at tp=2: the grid and the count equal the JAX tp=2
  engine's sweep (its dispatches recorded by stand-ins, so nothing
  compiles), dispatch for dispatch; every rank ran the same sweeps, a
  rank set builds no program variant (compile events 0), and streams
  after the sweep are unchanged. The grid shows the fault of the
  rank-set runner's packed-prefill flag: on when it was, the port's grid
  deduplicated packed-prefill groups the JAX meshed engine sweeps.
- The ring at tp=2 x sp=2: an 1100-token prompt in 128-token chunks
  (tests/test_long_context_serving.py's [2-2] case) gives the JAX
  engine's tokens, 9 chunks, 0 fallbacks and 35 blocks landed; every
  follower dropped its ring state after the collect. Under pp=2 and
  under multihost the lane is off and the prompt serves chunked.

Tokens and counts equal; no tolerance.
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
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.multihost_engine import (
    BroadcastingRunner,
    RankSetError,
)
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models import config as tmcfg
from production_stack_tpu_torch.models.convert import params_from_numpy
import test_torch_precompile as tpc
from test_torch_rank_set_features import TINY
from test_torch_rank_set_features import np_params  # noqa: F401
from test_torch_rank_set_features import register_cfgs  # noqa: F401

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

# K=4; the sweep's grid: the smallest max_model_len with two ctx buckets
# (32 and 64 tokens: one 32-token block, two) and two chunk buckets (8,
# 16), and a pool the sweep's guards let every group through. The
# streams stay in one ctx bucket, so the JAX engines compile little.
ENGINE = dict(model=TINY.name, tokenizer="byte", dtype="float32",
              cache_dtype="float32", block_size=32, num_kv_blocks=128,
              max_model_len=64, max_num_seqs=4, max_prefill_chunk=16,
              num_scheduler_steps=4, seed=0)
LAYOUTS = {"tp2": (2, 1), "pp2": (1, 2), "pp2tp2": (2, 2)}
PROMPTS = [[7, 8, 9, 10, 11, 12, 13, 14, 15], [40, 41, 42, 43, 44],
           [90, 91, 92, 93, 94, 95, 96]]
# the ring: the tiny model at a longer context, the long-context serving
# test's engine (32-token blocks, 128-token chunks past 256 tokens)
RING_MODEL = dataclasses.replace(TINY, name="pst-tiny-rank-set-ctx",
                                 max_model_len=2048)
RING = dict(model=RING_MODEL.name, tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=32, num_kv_blocks=96,
            max_num_seqs=4, max_prefill_chunk=256, seed=0)
LANE = dict(long_prefill_threshold=256, context_parallel_size=2,
            long_prefill_chunk=128)
RING_PROMPT = np.random.RandomState(0).randint(0, 384, 1100).tolist()


def _greedy(pkg, n=12):
    cls = JSampling if pkg == "jax" else SamplingParams
    return cls(max_tokens=n, temperature=0.0, ignore_eos=True)


@pytest.fixture(autouse=True, scope="module")
def register_ring_model():
    jmcfg._PRESETS[RING_MODEL.name] = RING_MODEL
    tmcfg._PRESETS[RING_MODEL.name] = tmcfg.ModelConfig(
        **{f.name: getattr(RING_MODEL, f.name)
           for f in dataclasses.fields(tmcfg.ModelConfig)})
    yield
    jmcfg._PRESETS.pop(RING_MODEL.name, None)
    tmcfg._PRESETS.pop(RING_MODEL.name, None)


def _port(np_params, base=ENGINE, tp=1, pp=1, **over):
    cfg = EngineConfig(**{**base, **over}, device="cpu",
                       tensor_parallel_size=tp, pipeline_parallel_size=pp)
    return LLMEngine(cfg, params=params_from_numpy(np_params, "cpu"))


def _jax(np_params, base=ENGINE, tp=1, pp=1, **over):
    cfg = JConfig(**{**base, "attention_impl": "xla", **over},
                  tensor_parallel_size=tp, pipeline_parallel_size=pp)
    return JEngine(cfg, params=jax.tree_util.tree_map(jnp.asarray,
                                                      np_params))


def _streams(eng, pkg):
    return [o.token_ids for o in eng.generate(PROMPTS, _greedy(pkg))]


def _stop(eng):
    followers = list(eng.tp_group.followers)
    eng.shutdown()
    assert [p.exitcode for p in followers] == [0] * len(followers)


def _swept(eng):
    """Run the engine's precompile_serving with rank 0's dispatches
    recorded: eng.sweep = (its count, the dispatches)."""
    rnr = eng.runner._runner
    saved = {name: getattr(rnr, name) for name in tpc.DISPATCHES}
    log = tpc._spy(rnr)
    eng.sweep = (eng.precompile_serving(), list(log))
    for name, fn in saved.items():
        setattr(rnr, name, fn)
    return eng


@pytest.fixture(scope="module")
def rank_sets(np_params):
    """The port's rank sets by (layout, async_decode), each built at its
    first use and shut down at the module's end. The synchronous tp=2
    set runs precompile_serving first, as a server does at boot."""
    sets = {}

    def get(layout, async_decode):
        key = (layout, async_decode)
        if key not in sets:
            tp, pp = LAYOUTS[layout]
            sets[key] = _port(np_params, tp=tp, pp=pp,
                              async_decode=async_decode,
                              precompile_serving=key == ("tp2", False))
            if sets[key].config.precompile_serving:
                _swept(sets[key])
        return sets[key]

    yield get
    for eng in sets.values():
        eng.shutdown()


# -- async decode ------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_streams(np_params):
    """The JAX meshed engine's greedy streams with async decode, by
    layout."""
    out = {}
    for name, (tp, pp) in LAYOUTS.items():
        eng = _jax(np_params, tp=tp, pp=pp, async_decode=True)
        try:
            assert eng._async_decode
            out[name] = _streams(eng, "jax")
        finally:
            eng.shutdown()
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_async_streams_equal_jax_meshed_and_sync(rank_sets, jax_streams,
                                                 layout):
    want = _streams(rank_sets(layout, False), "port")
    eng = rank_sets(layout, True)
    assert eng._async_decode and not eng._ragged_dispatch
    eng.runner.reset_counts()
    got = _streams(eng, "port")
    reps = eng.runner.reports()
    assert got == want == jax_streams[layout]
    assert len({tuple(s) for s in got}) == len(PROMPTS)
    chained = [r["chained_rounds"] for r in reps]
    # every rank chained the same rounds; each follower checked each one
    # against rank 0's host tokens (rank 0 sent as many checks)
    assert chained[0] > 0 and chained == [chained[0]] * len(reps)
    assert [r["chain_checks"] for r in reps] == [chained[0]] * len(reps)
    assert all(r["host_collectives"] == 0 for r in reps)


def test_parted_chained_tokens_take_the_set_down(rank_sets):
    """A follower whose own tokens of a chained-on round differ from
    rank 0's raises RankSetError through its exit key, and rank 0's
    next dispatch raises it. (Here rank 0's check carries tokens one
    off, which is what the follower sees when its tokens parted.) The
    set stays broken."""
    eng = rank_sets("tp2", True)
    followers = list(eng.tp_group.followers)
    runner = eng.runner
    assert isinstance(runner, BroadcastingRunner)
    runner._host_tokens = lambda t: [int(x) + 1 for x in t.cpu().tolist()]
    with pytest.raises(RankSetError, match="parted from rank 0's"):
        for _ in range(4):
            eng.generate(PROMPTS, _greedy("port"))
    assert not eng.tp_alive() and runner.broken
    with pytest.raises(RankSetError):
        eng.step()  # the failed generate's requests are still live
    for p in followers:
        p.join(10)
    assert [p.exitcode for p in followers] == [1]


def test_async_under_multihost_is_accepted_and_off(np_params, jax_streams):
    """The JAX rule (async_decode and K > 1 and not multihost): a
    multi-host engine takes the flag and decodes synchronously."""
    eng = _port(np_params, multihost=True, async_decode=True)
    jeng = _jax(np_params, multihost=True, async_decode=True)
    try:
        assert not eng._async_decode and not jeng._async_decode
        assert _streams(eng, "port") == jax_streams["tp2"]
    finally:
        eng.shutdown()
        jeng.shutdown()


# -- the serving warm-up sweep -----------------------------------------------
@pytest.fixture(scope="module")
def jax_sweep(np_params):
    """The JAX tp=2 meshed engine's precompile_serving with its runner's
    dispatches replaced by recorders: (count, recorded dispatches, the
    prefill sweep's singles and groups, the decode sweeps' (K, chained,
    stop))."""
    eng = _jax(np_params, tp=2, attention_impl="pallas")
    try:
        rnr = eng.runner
        assert rnr.mesh is not None and not rnr.prefill_pipeline
        log = tpc._stand_ins(rnr, ENGINE["max_num_seqs"])
        sweeps = {"prefill": [], "decode": []}
        pre, dec = rnr.precompile_prefill, rnr.precompile_decode
        rnr.precompile_prefill = lambda s, g: (
            sweeps["prefill"].append((list(s), list(g))) or pre(s, g))
        rnr.precompile_decode = lambda c, k, chained, stop: (
            sweeps["decode"].append((k, chained, stop))
            or dec(c, k, chained=chained, stop=stop))
        n = eng.precompile_serving()
        return n, list(log), sweeps
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def tp2_swept(rank_sets):
    """The port's synchronous tp=2 rank set, swept at its start."""
    return rank_sets("tp2", False)


def test_rank_set_runner_sweeps_the_jax_meshed_grid(tp2_swept, jax_sweep):
    """The rank-set runner's prefill_pipeline is off, as the JAX meshed
    runner's: its packed-prefill groups are the full grid. With the flag
    on, the ragged kernel's row-bucket dedup dropped groups the JAX
    meshed engine sweeps."""
    eng = tp2_swept
    rnr = eng.runner
    (singles, groups), = jax_sweep[2]["prefill"]
    grid = eng.precompile_grid
    assert len(grid["ctx_buckets"]) == 2 and len(grid["chunk_buckets"]) == 2
    assert (grid["singles"], grid["groups"]) == (len(singles), len(groups))
    assert grid["decode_variants"] == jax_sweep[2]["decode"]
    assert rnr.ragged_kernel and not rnr.prefill_pipeline
    # the dedup the flag selected would have dropped a group (the grid
    # differed)
    rows = {(rnr._rows_bucket(s * t), c) for s, t, c in groups}
    assert len(rows) < len(groups)


def test_precompile_count_and_dispatches_equal_jax_tp2(tp2_swept, jax_sweep):
    n, log = tp2_swept.sweep
    assert n == jax_sweep[0] > 0
    assert log == jax_sweep[1]


def test_every_rank_ran_the_sweep_and_built_nothing(tp2_swept):
    """Every rank ran the same sweeps (the published precompile steps);
    a rank set is eager, so the port's compile-event rule reports none
    (tpu:compile_events_total 0 at tp=2)."""
    reps = tp2_swept.runner.reports()
    assert reps[0]["dispatch_counts"] == reps[1]["dispatch_counts"]
    assert reps[0]["dispatch_counts"]["prefill_batch"] > 0
    assert reps[0]["dispatch_counts"]["decode_multi"] > 0
    st = tp2_swept.stats()
    assert st.compile_events_total == 0 and st.compile_events == {}


def test_streams_after_the_sweep_are_unchanged(tp2_swept, jax_streams):
    """Greedy streams are those of the JAX tp=2 engine (its async run;
    greedy tokens do not depend on the chain)."""
    assert _streams(tp2_swept, "port") == jax_streams["tp2"]


# -- the long-prefill ring -----------------------------------------------------
@pytest.fixture(scope="module")
def jax_ring(np_params):
    eng = _jax(np_params, base=RING, tp=2, **LANE)
    try:
        out = eng.generate([RING_PROMPT], _greedy("jax", 8))[0].token_ids
        assert eng.stats().long_prefill_requests_total == 1
        return out
    finally:
        eng.shutdown()


def _lane_event(eng):
    tl = {t["request_id"]: t for t in eng.timeline.snapshot(limit=8)}
    (ev,) = [e for e in tl["gen-0"]["events"] if e["name"] == "long_prefill"]
    return ev["attributes"]


def test_ring_at_tp2_sp2_equals_jax_meshed(np_params, jax_ring):
    eng = _port(np_params, base=RING, tp=2, **LANE)
    try:
        mgr = eng.long_prefill
        assert mgr is not None and mgr.prefiller.tp_group is not None
        assert mgr.prefiller.cfg.num_kv_heads == TINY.num_kv_heads // 2
        out = eng.generate([RING_PROMPT], _greedy("port", 8))[0].token_ids
        st = eng.stats()
        a = _lane_event(eng)
        reps = eng.runner.reports()
    finally:
        _stop(eng)
    assert out == jax_ring
    assert st.long_prefill_requests_total == 1
    assert st.long_prefill_chunks_total == 9
    assert st.long_prefill_fallbacks_total == 0
    assert a["chunks"] == 9 and a["blocks_landed"] == 35
    assert mgr.collect_s_total > 0
    # the follower replayed every chunk and let the ring cache go
    assert [r["lane_jobs"] for r in reps] == [0, 0]
    assert reps[0]["broadcasts"] == reps[1]["broadcasts"] > 0


@pytest.mark.parametrize("over", [{"pipeline_parallel_size": 2},
                                  {"multihost": True}],
                         ids=["pp2", "multihost"])
def test_ring_is_off_under_pp_and_multihost(np_params, jax_ring, over):
    """JAX's condition (not multihost and pp == 1): the lane is not
    built, and the prompt serves chunked with the ring's tokens."""
    pp = over.get("pipeline_parallel_size", 1)
    eng = _port(np_params, base=RING, pp=pp,
                **{k: v for k, v in over.items()
                   if k != "pipeline_parallel_size"}, **LANE)
    try:
        assert eng.long_prefill is None
        out = eng.generate([RING_PROMPT], _greedy("port", 8))[0].token_ids
        assert eng.stats().long_prefill_requests_total == 0
    finally:
        eng.shutdown()
    assert out == jax_ring
