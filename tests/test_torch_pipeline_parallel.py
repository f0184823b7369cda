"""Pipeline parallelism in the PyTorch port against the JAX package's.

The JAX package serves pp as one SPMD program over a ("pp", "tp") mesh
of the conftest's 8 virtual CPU devices (parallel/pp_serving.py) and
prefills with a GPipe pipeline over a "pp" axis (parallel/pipeline.py).
The port serves pp over a rank set (rank 0 here, the other ranks
spawned, gloo on a loopback TCPStore): stage r // tp holds its L/pp
layers and hands its output rows on with a broadcast
(parallel/pp_serving.py); its PipelinedPrefiller drives the stages from
one process, stage devices the CPU repeated.

Models: tests/test_pp_serving.py's engine config (pst-tiny-debug, 2
layers, tied embeddings) and tests/test_pipeline_parallel.py's CFG (4
layers, for pp up to 4), float32, the same JAX-initialised weights on
both sides. Tolerances: 1e-5 for embeddings (summation order differs),
2e-4 for the prefiller's logits and KV (the JAX test's own); equality
for token streams, round kinds, dispatch counts and messages. One
port engine of each layout serves every scenario (module-scoped).
"""

import dataclasses
import time

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
from production_stack_tpu.parallel import pipeline as jpipeline
from production_stack_tpu.parallel import pp_serving as jpp
from production_stack_tpu.parallel import sharding as jsharding
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models import config as tmcfg
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import weights as tweights
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.models.debug_checkpoint import (
    hf_config_of,
    write_hf_checkpoint,
)
from production_stack_tpu_torch.parallel import pipeline as tpipeline
from production_stack_tpu_torch.parallel import pp_serving as tpp
from production_stack_tpu_torch.parallel import sharding as tsharding
import test_torch_rank_set_features as rsf
from test_torch_rank_set_features import np_params as rs_np_params  # noqa: F401
from test_torch_rank_set_features import register_cfgs  # noqa: F401

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

# tests/test_pp_serving.py's engine and prompts
ENGINE = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
              cache_dtype="float32", block_size=8, num_kv_blocks=64,
              max_num_seqs=2, max_prefill_chunk=32, seed=0)
PROMPTS = ["pipeline parallel serving", "second stream here"]
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
LAYOUTS = {"pp2": (2, 1), "pp2tp2": (2, 2)}
# tests/test_pipeline_parallel.py's model
PCFG = jmcfg.ModelConfig(
    name="pst-pp-test", vocab_size=128, hidden_size=32,
    intermediate_size=64, num_layers=4, num_heads=4, num_kv_heads=2,
    head_dim=8, max_model_len=256, rope_theta=10000.0,
    tie_word_embeddings=True,
)


def _tcfg(jcfg):
    return tmcfg.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tmcfg.ModelConfig)})


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def np_params():
    cfg = jmcfg.get_model_config("pst-tiny-debug")
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(cfg, jax.random.key(0), jnp.float32))


def _stepped(eng, prompts, sp):
    """Streams and every step's round kind, stepping the engine."""
    for i, p in enumerate(prompts):
        eng.add_request(f"r{time.monotonic_ns()}-{i}", prompt=p,
                        sampling_params=sp)
    kinds, done = [], {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                done[out.request_id] = out.token_ids
        kinds.append(eng.last_step_kind)
    return [done[k] for k in sorted(done, key=lambda s: s.split("-")[1])], kinds


@pytest.fixture(scope="module")
def jax_pp(np_params):
    """The JAX pp=2 engine's greedy streams, round kinds and embedding."""
    eng = JEngine(JConfig(pipeline_parallel_size=2, **ENGINE),
                  params=jax.tree_util.tree_map(jnp.asarray, np_params))
    assert eng.runner.mesh.shape["pp"] == 2
    streams, kinds = _stepped(eng, PROMPTS, JSampling(**GREEDY))
    vec, _ = eng.embed_one("embedding text")
    return {"streams": streams, "kinds": kinds, "embed": vec}


def _port(np_params, pp=1, tp=1, **over):
    cfg = EngineConfig(device="cpu", pipeline_parallel_size=pp,
                       tensor_parallel_size=tp, **{**ENGINE, **over})
    return LLMEngine(cfg, params=params_from_numpy(np_params, "cpu"))


@pytest.fixture(scope="module", params=list(LAYOUTS))
def pp_eng(request, np_params):
    """One rank set a layout, shared by its scenarios."""
    pp, tp = LAYOUTS[request.param]
    eng = _port(np_params, pp=pp, tp=tp)
    eng.layout = request.param
    yield eng
    followers = list(eng.runner._group.followers)
    eng.shutdown()
    assert [p.exitcode for p in followers] == [0] * (pp * tp - 1)


_PP1: dict = {}


def _pp1(np_params, **over):
    key = tuple(sorted(over.items()))
    if key not in _PP1:
        _PP1[key] = _port(np_params, **over)
    return _PP1[key]


# -- the serving path ----------------------------------------------------------
def test_greedy_streams_and_round_kinds_equal_jax_pp(pp_eng, jax_pp,
                                                     np_params):
    """pp=2 and pp=2 x tp=2 greedy streams equal the JAX pp=2 engine's
    (and the port's pp=1 engine's), every step's round kind the JAX
    meshed engine's: split rounds, no unified ragged round, no staging."""
    got, kinds = _stepped(pp_eng, PROMPTS, SamplingParams(**GREEDY))
    assert got == jax_pp["streams"]
    assert kinds == jax_pp["kinds"] and "ragged" not in kinds
    assert got == [o.token_ids for o in _pp1(np_params).generate(
        PROMPTS, SamplingParams(**GREEDY))]
    assert not pp_eng._ragged_dispatch
    assert pp_eng._staged_hits_total == pp_eng._pf_staged_hits_total == 0


def test_every_rank_holds_its_stage_and_runs_the_same_dispatches(pp_eng):
    """Each rank holds its stage's layers (1 of 2) on the gather path (no
    kernel launch), every rank ran the same dispatches, each forward
    handed its rows on once a stage (a broadcast a phase), and the tp
    sums ran within a stage only."""
    pp, tp = LAYOUTS[pp_eng.layout]
    pp_eng.generate(PROMPTS, SamplingParams(**GREEDY))
    reps = pp_eng.runner.reports()
    assert [(r["rank"], r["stage"], r["tp_rank"]) for r in reps] == [
        (r, r // tp, r % tp) for r in range(pp * tp)]
    assert pp_eng.runner.attention_impl == "xla"
    fwd = sum(reps[0]["dispatch_counts"][k] for k in (
        "prefill", "prefill_batch", "decode", "decode_iterations",
        "verify_batch"))
    for r in reps:
        assert r["layers"] == 1 and r["tensor_devices"] == ["cpu"]
        assert r["launches"] == {"decode": 0, "prefill": 0, "ragged": 0}
        assert r["dispatch_counts"] == reps[0]["dispatch_counts"]
        assert r["broadcasts"] == pp * fwd
        # two sums a layer a forward, on the stage's own layer only
        assert r["all_reduces"] == (2 * fwd if tp > 1 else 0)
        assert r["store_steps"] == reps[0]["store_steps"]


def test_sampled_and_fused_multistep_streams_equal_pp1(pp_eng, np_params):
    """A seeded sampled lane beside a greedy one equals the port's pp=1
    engine (the JAX RNG is not reimplemented); the fused K=4 loop at
    pp=2 equals pp=1 at K=4."""
    sps = [SamplingParams(max_tokens=8, temperature=0.9, seed=3,
                          ignore_eos=True), SamplingParams(**GREEDY)]
    got = [o.token_ids for o in pp_eng.generate(PROMPTS, sps)]
    assert got == [o.token_ids for o in _pp1(np_params).generate(
        PROMPTS, sps)]
    if pp_eng.layout != "pp2":
        return
    pp, tp = LAYOUTS["pp2"]
    k4 = _port(np_params, pp=pp, tp=tp, num_scheduler_steps=4)
    try:
        got = [o.token_ids for o in k4.generate(
            PROMPTS, SamplingParams(**GREEDY))]
        want = [o.token_ids for o in _pp1(
            np_params, num_scheduler_steps=4).generate(
                PROMPTS, SamplingParams(**GREEDY))]
        assert got == want
        assert k4.runner.reports()[1]["dispatch_counts"]["decode_multi"] > 0
    finally:
        k4.shutdown()


def test_embeddings_ride_the_staged_forward_equal_jax(pp_eng, jax_pp):
    vec, n = pp_eng.embed_one("embedding text")
    assert n > 0
    np.testing.assert_allclose(vec, jax_pp["embed"], rtol=1e-5, atol=1e-5)


# -- validation, message for message -------------------------------------------
def _msg(fn, *args):
    try:
        fn(*args)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["ok", "layers", "moe", "lora"])
def test_validate_pp_serving_messages_equal_jax(case):
    cfg = jmcfg.get_model_config("pst-tiny-debug")
    pp = 3 if case == "layers" else 2
    if case == "moe":
        cfg = jmcfg.get_model_config("pst-tiny-moe-debug")
    over = {"enable_lora": case == "lora"}
    want = _msg(jpp.validate_pp_serving, cfg, pp, JConfig(**over))
    got = _msg(tpp.validate_pp_serving, _tcfg(cfg), pp,
               EngineConfig(device="cpu", **over))
    assert got == want and (want is None) == (case == "ok")


@pytest.mark.parametrize("over", [
    {"pipeline_parallel_size": 3},
    {"pipeline_parallel_size": 2, "enable_lora": True},
    {"pipeline_parallel_size": 2, "attention_impl": "pallas"},
], ids=["layers", "lora", "pallas"])
def test_engine_refusals_equal_jax(over):
    """The JAX engine's boot refusals under pp (divisible layers, LoRA,
    the kernels), raised by the port before any rank starts."""
    with pytest.raises(ValueError) as want:
        JEngine(JConfig(**{**ENGINE, **over}))
    with pytest.raises(ValueError) as got:
        LLMEngine(EngineConfig(device="cpu", **{**ENGINE, **over}))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("over,name", [
    ({"context_parallel_size": 2}, "context_parallel_size>1"),
    ({"async_decode": True, "num_scheduler_steps": 4}, "async_decode"),
    ({"precompile_serving": True}, "precompile_serving"),
])
def test_rank_set_refusals_under_pp_name_the_feature(over, name, np_params):
    """Each of the three was refused under pp by this name. Now, as in
    the JAX engine: async decode chains its rounds and the warm-up sweep
    runs on every rank (streams after either equal pp=1's), and the
    long-prefill lane is accepted and off (those prompts serve
    chunked)."""
    over = dict(over, max_model_len=64, num_kv_blocks=128)
    if name == "context_parallel_size>1":
        over["long_prefill_threshold"] = 32
    jeng = JEngine(JConfig(pipeline_parallel_size=2, **{**ENGINE, **over}))
    eng = _port(np_params, pp=2, **over)
    try:
        # room for two K=4 rounds after the first: a chain
        sp = SamplingParams(**{**GREEDY, "max_tokens": 12})
        k = over.get("num_scheduler_steps", 1)
        if name == "precompile_serving":
            assert eng.precompile_serving() > 0
            assert eng.stats().compile_events_total == 0
        got = [o.token_ids for o in eng.generate(PROMPTS, sp)]
        reps = eng.runner.reports()
        assert got == [o.token_ids for o in _pp1(
            np_params, num_scheduler_steps=k).generate(PROMPTS, sp)]
        assert reps[0]["dispatch_counts"] == reps[1]["dispatch_counts"]
        if name == "async_decode":
            assert eng._async_decode and jeng._async_decode
            assert reps[1]["chained_rounds"] > 0
            assert reps[1]["chain_checks"] > 0
        elif name == "context_parallel_size>1":
            assert eng.long_prefill is None and jeng.long_prefill is None
            assert eng.stats().long_prefill_requests_total == 0
    finally:
        eng.shutdown()
        jeng.shutdown()


# -- the KV tiers over the stages ----------------------------------------------
@pytest.fixture(scope="module", params=["pp2", "pp2xtp2"])
def pp_kv(request, rs_np_params):
    """A pp=2 (or pp=2 x tp=2) rank set with the CPU tier, beside the JAX
    meshed engine of the same layout, each through the rank-set
    features' KV scenario (tests/test_torch_rank_set_features.py)."""
    pp, tp = LAYOUTS[request.param.replace("xtp", "tp")]
    jeng = rsf._jax(rs_np_params, tp=tp, pp=pp)
    try:
        want = rsf._kv_scenario(jeng, "jax")
    finally:
        jeng.shutdown()
    eng = rsf._port(rs_np_params, tp=tp, pp=pp)
    eng.runs = {"kv": rsf._kv_scenario(eng, "port")}
    yield eng, want
    eng.shutdown()


def test_kv_export_and_restore_under_pp_equal_jax_meshed(pp_kv):
    """The KV tiers are served under pp (the JAX package refuses them
    under multihost only): a prompt evicted by churn restores with the
    JAX meshed engine's stream and blocks, 0 fallbacks; the wire each
    stage's ranks assemble on rank 0 equals the JAX meshed export, and
    each rank's slice is its cut of it."""
    eng, want = pp_kv
    rsf._check_kv(eng, want)
    reps = eng.runner.reports()
    assert [r["layers"] for r in reps] == [1] * len(reps)


# -- sharding: the layer axis ----------------------------------------------------
@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2), (4, 1)])
def test_shard_params_equal_jax_pp_tp_mesh_shards(pp, tp):
    """Rank r's (stage r // tp, tp index r % tp) params equal the JAX
    serving mesh's shard on device r, byte for byte; its cache shape
    the JAX cache shard's."""
    params = jllama.init_params(PCFG, jax.random.key(1), jnp.float32)
    mesh = jsharding.make_serving_mesh(tp, pp)
    jtree = jsharding.shard_params(params, mesh, PCFG)
    full = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             "cpu")
    cfg = _tcfg(PCFG)
    devs = mesh.devices.reshape(-1)
    for r in range(pp * tp):
        stage, ti = tsharding.rank_layout(r, tp)
        mine = tsharding.shard_params(
            full, cfg, ti, tp,
            layers=tsharding.stage_layers(cfg.num_layers, stage, pp))
        for path, leaf in _leaves(jtree):
            (want,) = [s.data for s in leaf.addressable_shards
                       if s.device == devs[r]]
            got = _get(mine, path).numpy()
            want = np.asarray(want)
            assert got.shape == want.shape, (path, r)
            assert got.tobytes() == want.tobytes(), (path, r)
    shape = (PCFG.num_layers, PCFG.num_kv_heads, 64, PCFG.head_dim)
    want = jsharding.cache_sharding(mesh).shard_shape(shape)
    assert tsharding.local_cache_shape(cfg, 64, tp, pp) == want
    assert cfg.tp_local(tp).pp_local(pp).num_layers == want[0]


def test_seeded_init_and_checkpoint_load_of_a_stage_are_the_full_cut(
        tmp_path):
    """A stage's random init (drawn whole, cut) and its checkpoint load
    (only its layers read) equal the pp=1 tree cut to its layers."""
    cfg = _tcfg(dataclasses.replace(PCFG, tie_word_embeddings=False))

    def init(**kw):
        gen = torch.Generator().manual_seed(7)
        return tllama.init_params(cfg, gen, torch.float32, "cpu", **kw)

    full = init()
    write_hf_checkpoint(str(tmp_path), hf_config_of(cfg), full)
    for stage in range(2):
        span = tsharding.stage_layers(cfg.num_layers, stage, 2)
        for shard in (None, (1, 2)):
            want = tsharding.shard_params(full, cfg, *(shard or (0, 1)),
                                          layers=span)
            for got in (init(shard=shard, layers=span),
                        tweights.load_hf_weights(cfg, str(tmp_path),
                                                 torch.float32, shard=shard,
                                                 layers=span)):
                for path, leaf in _leaves(want):
                    assert torch.equal(_get(got, path), leaf), (path, stage)


# -- the pipelined prefiller -----------------------------------------------------
@pytest.mark.parametrize("pp,mb", [(2, 2), (4, 4), (4, 8), (1, 3)])
def test_pipelined_prefiller_equals_jax(pp, mb):
    """Logits and each stage's K/V equal the JAX prefiller's on rows
    [0, T) within its own test's 2e-4; the stages hold their layers."""
    params = jllama.init_params(PCFG, jax.random.key(0), jnp.float32)
    ids = np.random.RandomState(5).randint(0, PCFG.vocab_size, 23).tolist()
    jpre = jpipeline.PipelinedPrefiller(
        PCFG, params, jpipeline.make_pp_mesh(pp), microbatch_tokens=4,
        num_microbatches=mb)
    jlogits, jkc, jvc, T = jpre.prefill(ids)
    full = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             "cpu")
    pre = tpipeline.PipelinedPrefiller(
        _tcfg(PCFG), full, tpipeline.make_pp_stages(pp, ["cpu"] * pp),
        microbatch_tokens=4, num_microbatches=mb)
    logits, kcs, vcs, t = pre.prefill(ids)
    assert t == T == len(ids) and len(kcs) == pp
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    for mine, theirs in ((kcs, jkc), (vcs, jvc)):
        got = torch.cat(mine).numpy()
        assert got.shape == np.asarray(theirs).shape
        np.testing.assert_allclose(got[:, :, :T],
                                   np.asarray(theirs)[:, :, :T],
                                   rtol=2e-4, atol=2e-4)
    n = PCFG.num_layers // pp
    for s, sp in enumerate(pre.params):
        assert torch.equal(sp["layers"]["wq"],
                           full["layers"]["wq"][s * n:(s + 1) * n])
        (want,) = [x.data for x in jpre.params["layers"]["wq"]
                   .addressable_shards
                   if x.device == jpre.mesh.devices[s]]
        assert sp["layers"]["wq"].numpy().tobytes() == np.asarray(
            want).tobytes()


@pytest.mark.parametrize("case", ["layers", "moe", "window", "ok"])
def test_validate_pp_messages_equal_jax(case):
    cfg = {"layers": PCFG, "ok": PCFG,
           "moe": dataclasses.replace(PCFG, num_experts=4,
                                      num_experts_per_tok=2),
           "window": dataclasses.replace(PCFG, sliding_window=16)}[case]
    pp = 3 if case == "layers" else 2
    want = _msg(jpipeline.validate_pp, cfg, pp)
    assert _msg(tpipeline.validate_pp, _tcfg(cfg), pp) == want
    assert (want is None) == (case == "ok")


def test_more_stages_than_devices_refused_with_the_jax_message():
    n = len(jax.devices())
    with pytest.raises(ValueError) as want:
        jpipeline.make_pp_mesh(n + 1)
    with pytest.raises(ValueError) as got:
        tpipeline.make_pp_stages(n + 1, ["cpu"] * n)
    assert str(got.value) == str(want.value)


def test_a_pp_set_on_cuda_without_enough_cards_raises(monkeypatch):
    """A pp set asked for on the card (the default device) with fewer
    cards than ranks stops with the JAX serving mesh's message; no
    fallback to the CPU."""
    with pytest.raises(ValueError) as want:
        jsharding.make_serving_mesh(1, 2, devices=[])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError) as got:
        LLMEngine(EngineConfig(pipeline_parallel_size=2, **ENGINE))
    assert str(got.value) == str(want.value)
