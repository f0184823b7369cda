"""Tensor parallelism in the PyTorch port against the JAX package's.

The JAX package runs TP on the conftest's 8-device CPU mesh (one
process, GSPMD psums); the port runs a rank set: rank 0 in this process,
ranks 1.. spawned, joined by gloo on a loopback TCPStore
(parallel/launch.py).
The models are tests/test_tensor_parallel.py's TP_TEST_CFG (16 q heads
over 8 kv heads, head_dim 8, 2 layers, tied embeddings) and an untied
variant with Qwen2's qkv bias (its lm_head vocab-sharded, its logits
gathered), all in float32, with the same JAX-initialised weights on both
sides. Tolerances: 1e-5 relative for logits, KV, embeddings and
logprobs (summation order differs: XLA's psum against gloo's sum of the
ranks' f32 partials); bytes for param shards; equality for token
streams, round kinds and counts. One rank set serves each engine
configuration's scenarios (a module-scoped parametrised fixture).
"""

import dataclasses
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker
from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import config as jmcfg
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops import attention as jattn
from production_stack_tpu.parallel import sharding as jsharding
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.multihost_engine import (
    UNBROADCAST,
    BroadcastingRunner,
    RankSetError,
)
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models import config as tmcfg
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import weights as tweights
from production_stack_tpu_torch.models.convert import (
    params_from_numpy,
    tp_params_from_numpy,
)
from production_stack_tpu_torch.models.debug_checkpoint import (
    hf_config_of,
    write_hf_checkpoint,
)
from production_stack_tpu_torch.ops import paged_attention as tpa
from production_stack_tpu_torch.parallel import sharding as tsharding
from production_stack_tpu_torch.parallel.launch import start_tp_ranks
from reference_model import dense_greedy_generate

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
TIED = jmcfg.ModelConfig(
    name="pst-tiny-tp-port",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=16,
    num_kv_heads=8,
    head_dim=8,
    max_model_len=128,
    rope_theta=10000.0,
    tie_word_embeddings=True,
)
UNTIED = dataclasses.replace(TIED, name="pst-tiny-tp-port-untied",
                             tie_word_embeddings=False, qkv_bias=True)
JCFGS = {"tied": TIED, "untied": UNTIED}
# the JAX TP test's prompts: lengths 9 and 21, 6 greedy tokens
PROMPTS = [np.random.RandomState(0).randint(0, 512, size=n).tolist()
           for n in (9, 21)]
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True)


def _tcfg(jcfg):
    return tmcfg.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tmcfg.ModelConfig)})


TCFGS = {k: _tcfg(v) for k, v in JCFGS.items()}


@pytest.fixture(autouse=True, scope="module")
def register_cfgs():
    for jc, tc in zip(JCFGS.values(), TCFGS.values()):
        jmcfg._PRESETS[jc.name] = jc
        tmcfg._PRESETS[tc.name] = tc
    yield
    for jc in JCFGS.values():
        jmcfg._PRESETS.pop(jc.name, None)
        tmcfg._PRESETS.pop(jc.name, None)


def _np_params(kind):
    cfg = JCFGS[kind]
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(cfg, jax.random.key(0), jnp.float32))
    if cfg.qkv_bias:  # JAX draws zero biases: give the split something
        rng = np.random.RandomState(5)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = (rng.randn(*tree["layers"][b].shape)
                                 * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def np_params():
    return {k: _np_params(k) for k in JCFGS}


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


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


# -- sharding rules ------------------------------------------------------------
@pytest.mark.parametrize("case,tp", [
    ("tied", 2), ("tied", 3), ("tied", 16), ("untied", 4),
    ("odd_intermediate", 4), ("odd_vocab", 4), ("moe", 4), ("moe", 2),
])
def test_validate_tp_messages_equal_jax(case, tp):
    cfg = {"tied": TIED, "untied": UNTIED,
           "odd_intermediate": dataclasses.replace(TIED,
                                                   intermediate_size=130),
           "odd_vocab": dataclasses.replace(UNTIED, vocab_size=510),
           "moe": dataclasses.replace(TIED, num_experts=6)}[case]
    errs = []
    for fn, c in ((jsharding.validate_tp, cfg), (tsharding.validate_tp,
                                                 _tcfg(cfg))):
        try:
            fn(c, tp)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (case in ("tied", "untied") and tp in (2, 4)
                                 or case == "moe" and tp == 2)


@pytest.mark.parametrize("kind,tp", [("tied", 2), ("tied", 4),
                                     ("untied", 2), ("untied", 4)])
def test_shard_params_byte_equal_jax_addressable_shards(np_params, kind, tp):
    mesh = jsharding.make_mesh(tp)
    jtree = jsharding.shard_params(
        jax.tree_util.tree_map(jnp.asarray, np_params[kind]), mesh,
        JCFGS[kind])
    for r in range(tp):
        mine = tp_params_from_numpy(np_params[kind], TCFGS[kind], r, tp,
                                    "cpu")
        for path, leaf in _leaves(jtree):
            (want,) = [s.data for s in leaf.addressable_shards
                       if s.device == mesh.devices[r]]
            got = _get(mine, path)
            assert got.is_contiguous(), path
            got, want = got.numpy(), np.asarray(want)
            assert got.shape == want.shape and got.dtype == want.dtype, path
            assert got.tobytes() == want.tobytes(), (path, r)


@pytest.mark.parametrize("tp", [2, 4])
def test_seeded_init_shard_is_the_full_init_cut(tp):
    """A rank's random init equals the tp=1 init of the same seed, cut."""
    cfg = TCFGS["untied"]

    def init(shard):
        gen = torch.Generator().manual_seed(7)
        return tllama.init_params(cfg, gen, torch.float32, "cpu",
                                  shard=shard)

    full = init(None)
    for r in range(tp):
        want = tsharding.shard_params(full, cfg, r, tp)
        for path, got in _leaves(init((r, tp))):
            assert torch.equal(got, _get(want, path)), (path, r)


def test_more_ranks_than_cards_refused_with_the_jax_message(monkeypatch):
    """The card's default layout (rank r on cuda:r over NCCL) refuses more
    ranks than cards as JAX make_mesh refuses more than its devices."""
    from production_stack_tpu_torch.parallel import group as tgroup

    n = len(jax.devices())
    with pytest.raises(ValueError) as jerr:
        jsharding.make_mesh(n + 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    with pytest.raises(ValueError) as terr:
        tgroup.resolve_devices(n + 1, "cuda")
    assert str(terr.value) == str(jerr.value)
    assert tgroup.resolve_devices(2, "cuda") == ["cuda:0", "cuda:1"]
    assert tgroup.default_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert tgroup.default_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert tgroup.default_backend(["cpu", "cpu"]) == "gloo"


@pytest.mark.parametrize("tp", [2, 4])
def test_local_cache_shape_equals_jax_cache_shard(tp):
    mesh = jsharding.make_mesh(tp)
    global_shape = (TIED.num_layers, TIED.num_kv_heads, 64, TIED.head_dim)
    want = jsharding.cache_sharding(mesh).shard_shape(global_shape)
    assert tsharding.local_cache_shape(TCFGS["tied"], 64, tp) == want
    assert TCFGS["tied"].tp_local(tp).num_kv_heads == want[1]


def test_sharded_checkpoint_load_equals_cut_of_full_load(np_params,
                                                         tmp_path):
    """load_hf_weights(shard=(r, tp)) slices each tensor on the host as it
    is read: the same shard as cutting the full load."""
    cfg = TCFGS["untied"]
    write_hf_checkpoint(str(tmp_path), hf_config_of(cfg),
                        params_from_numpy(np_params["untied"], "cpu"))
    full = tweights.load_hf_weights(cfg, str(tmp_path), torch.float32)
    for r in range(2):
        got = tweights.load_hf_weights(cfg, str(tmp_path), torch.float32,
                                       shard=(r, 2))
        want = tsharding.shard_params(full, cfg, r, 2)
        for path, leaf in _leaves(want):
            assert torch.equal(_get(got, path), leaf), (path, r)


def test_tp2_engine_on_a_checkpoint_equals_tp1(np_params, tmp_path):
    """Each rank of a tp=2 engine booted on an HF checkpoint directory
    loads its own shard (qkv bias split, the untied lm_head on the
    vocab): greedy streams equal the tp=1 engine's on the directory."""
    cfg = TCFGS["untied"]
    write_hf_checkpoint(str(tmp_path), hf_config_of(cfg),
                        params_from_numpy(np_params["untied"], "cpu"))
    over = dict(ENGINE, model=str(tmp_path), device="cpu")
    want = LLMEngine(EngineConfig(**over)).generate(
        PROMPTS, SamplingParams(**GREEDY))
    eng = LLMEngine(EngineConfig(**over, tensor_parallel_size=2))
    try:
        got = eng.generate(PROMPTS, SamplingParams(**GREEDY))
    finally:
        eng.shutdown()
    assert [o.token_ids for o in got] == [o.token_ids for o in want]


# -- the *_tp wrappers on one rank's shard -------------------------------------
def _attn_inputs(rng, nq, nkv, d, bs=4, pages=4):
    slots = 32 * bs
    q = torch.from_numpy(rng.randn(8, nq, d).astype(np.float32))
    kc = torch.from_numpy(rng.randn(2, nkv, slots, d).astype(np.float32))
    vc = torch.from_numpy(rng.randn(2, nkv, slots, d).astype(np.float32))
    tables = torch.from_numpy(
        rng.permutation(32)[:2 * pages].reshape(2, pages).astype(np.int32))
    return q, kc, vc, tables


def _call(kind, q, kc, vc, tables, tp_kw=None):
    kw = dict(block_size=4, scale=0.35)
    if kind == "ragged":
        blk_seg = torch.tensor([0, 1], dtype=torch.int32)
        seg_meta = torch.tensor([[0, 0, 8, 5]], dtype=torch.int32)
        args = (tables, blk_seg, seg_meta)
    elif kind == "prefill":
        args = (tables[0], 5)
    else:
        args = (tables, torch.tensor([13, 9], dtype=torch.int32))
        q = q[:2]
    fn = getattr(tpa, {"ragged": "ragged_paged_attention",
                       "prefill": "paged_prefill_attention",
                       "decode": "paged_decode_attention"}[kind])
    if tp_kw is not None:
        fn = getattr(tpa, fn.__name__ + "_tp")
        kw.update(tp_kw)
    return fn(q, kc, vc, 1, *args, **kw)


@pytest.mark.parametrize("kind", ["ragged", "prefill", "decode"])
def test_tp_wrappers_equal_the_full_call_on_each_shard(kind):
    """Rank r's call on its q heads and cache kv heads is rows r of the
    full call's heads (GQA groups whole on each rank), no collective."""
    rng = np.random.RandomState(2)
    nq, nkv, tp = 8, 4, 2
    q, kc, vc, tables = _attn_inputs(rng, nq, nkv, 16)
    full = _call(kind, q, kc, vc, tables)
    tp_kw = dict(num_heads=nq, num_kv_heads=nkv, tp_size=tp)
    for r in range(tp):
        hq, hk = slice(r * nq // tp, (r + 1) * nq // tp), slice(
            r * nkv // tp, (r + 1) * nkv // tp)
        part = _call(kind, q[:, hq].contiguous(), kc[:, hk].contiguous(),
                     vc[:, hk].contiguous(), tables, tp_kw)
        assert torch.equal(part, full[:, hq])


@pytest.mark.parametrize("kind", ["ragged", "prefill", "decode"])
def test_tp_wrappers_refuse_incongruent_shards(kind):
    rng = np.random.RandomState(3)
    q, kc, vc, tables = _attn_inputs(rng, 8, 4, 16)
    with pytest.raises(ValueError, match="shard at tp=2"):
        _call(kind, q, kc[:, :2].contiguous(), vc[:, :2].contiguous(),
              tables, dict(num_heads=8, num_kv_heads=4, tp_size=2))


# -- the forward over a rank set -----------------------------------------------
STEPS = [(list(range(5, 17)), list(range(12))),
         ([40, 41, 42, 43], list(range(12, 16)))]
NUM_SLOTS = 16


@pytest.fixture(scope="module")
def forward_ranks(np_params):
    """Both models' forwards at tp=2 on one rank set: [rank][model]."""
    cases = [(TCFGS[k], np_params[k], STEPS, NUM_SLOTS) for k in JCFGS]
    return torch_tp_worker.run_ranks(torch_tp_worker.tp_forward, 2, cases)


def _jax_tp_forward(kind, np_params):
    cfg = JCFGS[kind]
    mesh = jsharding.make_mesh(2)
    params = jsharding.shard_params(
        jax.tree_util.tree_map(jnp.asarray, np_params[kind]), mesh, cfg)
    shape = (cfg.num_layers, cfg.num_kv_heads, NUM_SLOTS, cfg.head_dim)
    kc = jax.device_put(jnp.zeros(shape, jnp.float32),
                        jsharding.cache_sharding(mesh))
    vc = jax.device_put(jnp.zeros(shape, jnp.float32),
                        jsharding.cache_sharding(mesh))
    logits = []
    for tokens, positions in STEPS:
        pos = jnp.asarray(positions, jnp.int32)
        total = positions[-1] + 1

        def attn(q, layer, k, v):
            return jattn.context_attention_prefill(
                q, k[layer].transpose(1, 0, 2), v[layer].transpose(1, 0, 2),
                pos, total, cfg.head_dim**-0.5)

        lg, kc, vc = jax.jit(
            lambda p, t, kc, vc: jllama.forward(
                cfg, p, t, pos, kc, vc, pos, attn,
                jnp.arange(len(tokens))))(
            params, jnp.asarray(tokens, jnp.int32), kc, vc)
        logits.append(np.asarray(lg))
    return logits, kc, vc, mesh


@pytest.mark.parametrize("kind", list(JCFGS))
def test_tp2_forward_logits_and_local_kv_equal_jax(np_params, forward_ranks,
                                                   kind):
    i = list(JCFGS).index(kind)
    want_logits, kc, vc, mesh = _jax_tp_forward(kind, np_params)
    for r, ranks in enumerate(forward_ranks):
        logits, k, v = ranks[i]
        for got, want in zip(logits, want_logits):
            _close(got, want)  # every rank holds the whole vocab
        for got, arr in ((k, kc), (v, vc)):
            (want,) = [s.data for s in arr.addressable_shards
                       if s.device == mesh.devices[r]]
            assert got.shape == want.shape
            _close(got, want)


# -- engines -------------------------------------------------------------------
ENGINE = dict(tokenizer="byte", dtype="float32", cache_dtype="float32",
              block_size=4, num_kv_blocks=64, max_num_seqs=2,
              max_prefill_chunk=16, seed=0)
# tp=2 engine configurations: (attention impl, fused K)
CONFIGS = {"pallas-k4": ("pallas", 4), "pallas-k1": ("pallas", 1),
           "xla-k4": ("xla", 4)}


def _port(np_params, kind="tied", tp=1, impl="pallas", k=1, **over):
    cfg = EngineConfig(model=JCFGS[kind].name, device="cpu",
                       attention_impl=impl, num_scheduler_steps=k,
                       tensor_parallel_size=tp, **{**ENGINE, **over})
    return LLMEngine(cfg, params=params_from_numpy(np_params[kind], "cpu"))


_JAX_RUNS: dict = {}


def _jax_run(np_params, k):
    """(streams, round kinds) of PROMPTS on a fresh JAX meshed engine at
    tp=2 (its XLA path) with fused K = k, once a k."""
    if k not in _JAX_RUNS:
        eng = JEngine(
            JConfig(model=TIED.name, attention_impl="xla",
                    num_scheduler_steps=k, tensor_parallel_size=2, **ENGINE),
            params=jax.tree_util.tree_map(jnp.asarray, np_params["tied"]))
        _JAX_RUNS[k] = _stepped(eng, PROMPTS, JSampling(**GREEDY))
    return _JAX_RUNS[k]


@pytest.fixture(scope="module", params=list(CONFIGS))
def tp2(request, np_params):
    """One tp=2 rank set a configuration, shared by its scenarios."""
    impl, k = CONFIGS[request.param]
    eng = _port(np_params, tp=2, impl=impl, k=k)
    eng.case = request.param
    yield eng
    eng.shutdown()
    assert all(p.exitcode == 0 for p in eng.runner._group.followers)


_TP1: dict = {}


def _tp1(np_params, eng, **over):
    """The port's tp=1 engine of `eng`'s configuration."""
    impl, k = CONFIGS[eng.case]
    key = (eng.case, tuple(sorted(over.items())))
    if key not in _TP1:
        _TP1[key] = _port(np_params, impl=impl, k=k, **over)
    return _TP1[key]


def _stepped(eng, prompts, sp):
    """Streams and every step's round kind, stepping the engine."""
    for i, p in enumerate(prompts):
        eng.add_request(f"r{time.monotonic_ns()}-{i}", prompt_token_ids=p,
                        sampling_params=sp)
    kinds, done = [], {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                done[out.request_id] = out.token_ids
        kinds.append(eng.last_step_kind)
    return [done[k] for k in sorted(done, key=lambda s: s.split("-")[1])], kinds


def test_greedy_streams_and_round_kinds_equal_jax_meshed(tp2, np_params):
    """Greedy streams equal the JAX tp=2 engine's, the dense reference's
    and the port's tp=1 engine's; every step's round kind equals the JAX
    meshed engine's (no unified ragged round, no staging)."""
    k = CONFIGS[tp2.case][1]
    got, kinds = _stepped(tp2, PROMPTS, SamplingParams(**GREEDY))
    want, jkinds = _jax_run(np_params, k)
    assert got == want
    assert kinds == jkinds and "ragged" not in kinds
    host = jax.tree_util.tree_map(jnp.asarray, np_params["tied"])
    assert got == [dense_greedy_generate(TIED, host, p, 6) for p in PROMPTS]
    assert got == [o.token_ids for o in _tp1(np_params, tp2).generate(
        PROMPTS, SamplingParams(**GREEDY))]
    assert not tp2._ragged_dispatch and not tp2.scheduler.config.ragged_dispatch


def test_every_rank_runs_the_same_dispatches(tp2, np_params):
    """Both ranks ran the same forwards (packed prefill, and the fused
    K-step decode at K=4), on the CPU with the plain versions (no kernel
    launch), with no staged buffer."""
    tp2.generate(PROMPTS, SamplingParams(**GREEDY))
    r0, r1 = tp2.runner.reports()
    assert r0["dispatch_counts"] == r1["dispatch_counts"]
    counts = r0["dispatch_counts"]
    assert counts["prefill_batch"] >= 1 and counts["ragged"] == 0
    if CONFIGS[tp2.case][1] > 1:
        assert counts["decode_multi"] >= 1
    else:
        assert counts["decode"] >= 1 and counts["decode_multi"] == 0
    for r in (r0, r1):
        assert r["launches"] == {"decode": 0, "prefill": 0, "ragged": 0}
        assert r["tensor_devices"] == ["cpu"] and r["all_reduces"] > 0
    assert r0["all_reduces"] == r1["all_reduces"]
    assert tp2._staged_hits_total == tp2._pf_staged_hits_total == 0


def test_seeded_sampled_lane_equals_tp1(tp2, np_params):
    sp = dict(max_tokens=8, temperature=0.8, top_p=0.9, seed=1234,
              ignore_eos=True)
    prompts = [PROMPTS[1], [3, 1, 4, 1, 5, 9, 2, 6]]
    sps = [SamplingParams(**sp), SamplingParams(**GREEDY)]
    got = [o.token_ids for o in tp2.generate(prompts, sps)]
    want = [o.token_ids for o in _tp1(np_params, tp2).generate(prompts, sps)]
    assert got == want


def test_embeddings_equal_tp1(tp2, np_params):
    texts = ["tensor parallel", "x" * 40]
    got = tp2.embed(texts)
    want = _tp1(np_params, tp2).embed(texts)
    for g, w in zip(got, want):
        _close(g, w)


def test_guided_regex_equals_tp1(tp2, np_params):
    """A guided lane beside a free one: valid, and equal to tp=1 (at K=4
    the DFA tables ride the decode_multi broadcast once)."""
    sps = [SamplingParams(max_tokens=12, temperature=0.0,
                          guided_regex=r"(yes|no), [0-9]{2}"),
           SamplingParams(**GREEDY)]
    prompts = ["answer:", [7, 8, 9, 10, 11]]
    got = tp2.generate(prompts, sps)
    want = _tp1(np_params, tp2).generate(prompts, sps)
    assert re.fullmatch(r"(yes|no), [0-9]{2}", got[0].text)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]


def test_prompt_logprobs_equal_tp1(tp2, np_params):
    sp = SamplingParams(max_tokens=3, temperature=0.0, prompt_logprobs=4,
                        ignore_eos=True)
    prompt = list(range(20, 50))
    [got] = tp2.generate([prompt], sp)
    [want] = _tp1(np_params, tp2).generate([prompt], sp)
    assert got.token_ids == want.token_ids
    for g, w in zip(got.prompt_logprobs[1:], want.prompt_logprobs[1:]):
        assert g["token_id"] == w["token_id"]
        assert g["logprob"] == pytest.approx(w["logprob"], rel=REL, abs=REL)
        assert ([t["token_id"] for t in g["top_logprobs"]]
                == [t["token_id"] for t in w["top_logprobs"]])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_spec_decode_streams_and_counts_equal_tp1(np_params, impl):
    """verify_batch broadcast: the untied model (vocab-sharded lm_head
    under the verify rows' own projection) with n-gram drafts."""
    prompt = [70, 71, 72, 73, 70, 71, 72, 73, 70, 71, 72]
    sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    over = dict(num_speculative_tokens=3)
    engs = [_port(np_params, "untied", tp=tp, impl=impl, **over)
            for tp in (2, 1)]
    try:
        outs = [e.generate([prompt, PROMPTS[0]], sp) for e in engs]
        assert ([o.token_ids for o in outs[0]]
                == [o.token_ids for o in outs[1]])
        counts = [(e._spec_drafts_total, e._spec_accepted_total)
                  for e in engs]
        assert counts[0] == counts[1] and counts[0][1] > 0
        r0, r1 = engs[0].runner.reports()
        assert r0["dispatch_counts"]["verify_batch"] > 0
        assert r0["dispatch_counts"] == r1["dispatch_counts"]
    finally:
        engs[0].shutdown()


# -- what tensor parallelism refuses, serves, and failures ---------------------
@pytest.mark.parametrize("over,name", [
    ({"async_decode": True, "num_scheduler_steps": 4}, "async_decode"),
    ({"precompile_serving": True}, "precompile_serving"),
    ({"context_parallel_size": 2}, "context_parallel_size>1"),
])
def test_tp_refuses_what_it_does_not_carry(over, name):
    """The three features EngineConfig refused at tp=2 (by these names)
    until their steps were published: it takes each at tp=2 as at tp=1,
    and so does the JAX package's config
    (tests/test_torch_rank_set_serving.py serves each against the JAX
    meshed engine)."""
    for tp in (2, 1):
        cfg = {**ENGINE, "model": TIED.name, "tensor_parallel_size": tp,
               **over}
        got = EngineConfig(**cfg, device="cpu")
        want = JConfig(**cfg)
        for field in over:
            assert getattr(got, field) == getattr(want, field) == over[field]
    assert not hasattr(EngineConfig, "rank_set_unported"), name


# the features a one-host rank set serves since their exports, imports
# and adapter loads became broadcast steps (each was a refusal case of
# the test above; tests/test_torch_rank_set_features.py serves them
# against the JAX meshed engine, tests/test_torch_moe.py the experts)
SERVED = [
    ({"enable_lora": True}, "enable_lora"),
    ({"cpu_offload_bytes": 2**20}, "cpu_offload_bytes"),
    ({"disk_offload_dir": "/nonexistent"}, "disk_offload_dir"),
    ({"remote_cache_url": "http://127.0.0.1:1"}, "remote_cache_url"),
    ({"kv_role": "prefill"}, "kv_role"),
    ({"kv_transfer_config": {"peer": "127.0.0.1:1"}}, "kv_transfer_config"),
    ({"model": "pst-tiny-moe-debug"}, "MoE"),
]


@pytest.mark.parametrize("over,name", SERVED)
def test_tp_config_takes_what_it_used_to_refuse(over, name):
    """EngineConfig at tp=2 on one host accepts each; a multi-host job
    keeps the JAX multi-host engine's refusals
    (tests/test_torch_multihost.py holds their messages)."""
    from production_stack_tpu_torch.engine.multihost_engine import (
        validate_multihost_config,
    )

    from production_stack_tpu.engine.multihost_engine import (
        validate_multihost_config as jvalidate,
    )

    over = {**ENGINE, "model": TIED.name, "tensor_parallel_size": 2, **over}
    cfg = EngineConfig(**over, device="cpu")
    errs = []
    for fn, c in ((jvalidate, JConfig(**over)), (validate_multihost_config,
                                                 cfg)):
        try:
            fn(c)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    # a peer alone declares no role; MoE is a forward, broadcast as one
    assert (errs[0] is None) == (name in ("kv_transfer_config", "MoE"))


# the warm-up sweeps that were in UNBROADCAST: each is a published step
# now (the kind is the method's name)
PRECOMPILE_STEPS = ("precompile_prefill", "precompile_decode",
                    "precompile_verify", "precompile_kv_import")


@pytest.mark.parametrize("name", sorted(UNBROADCAST | set(PRECOMPILE_STEPS)))
def test_broadcasting_runner_refuses_unbroadcast_methods(name):
    """A method in UNBROADCAST raises before anything is published; a
    sweep that was in it publishes its step (host arguments only), then
    runs on rank 0."""
    published = []
    ran = []
    runner = types.SimpleNamespace(
        **{name: lambda *a, **k: ran.append((a, k)) or 3}, num_blocks=64)
    group = types.SimpleNamespace(store=None, world_size=2, followers=[])
    br = BroadcastingRunner(runner, group)
    br._bc = types.SimpleNamespace(publish=published.append)
    if name in UNBROADCAST:
        with pytest.raises(RuntimeError, match=name):
            getattr(br, name)
        assert br.num_blocks == 64 and not published
        return
    assert name in PRECOMPILE_STEPS
    assert getattr(br, name)([8, 16], steps=4) == 3
    assert published == [{"kind": name, "args": ([8, 16],),
                          "kwargs": {"steps": 4}}]
    assert ran == [(([8, 16],), {"steps": 4})]


# the KV methods that were in UNBROADCAST: what each publishes now (the
# kind, or nothing for rank 0's own halves: its h2d and its d2h)
KV_METHODS = {
    "stage_export_blocks": ["kv_export"], "export_blocks": ["kv_export"],
    "materialize_export": [], "stage_import_blocks": [],
    "import_staged_blocks": ["kv_import"], "import_blocks": ["kv_import"],
}


@pytest.mark.parametrize("name", sorted(KV_METHODS))
def test_broadcasting_runner_serves_kv_methods(name):
    """Each former UNBROADCAST KV method is served: the halves that move
    bytes between the ranks publish their step kind first (with host
    arguments only), rank 0's own h2d and d2h publish nothing."""
    assert name not in UNBROADCAST
    wire = torch.arange(2 * 2 * 3, dtype=torch.float32).view(2, 2, 3)
    calls = []
    runner = types.SimpleNamespace(
        stage_export_blocks=lambda b: calls.append("gather") or (
            len(b), wire, None),
        materialize_export=lambda h: calls.append("d2h") or h[1],
        stage_import_blocks=lambda d: calls.append("h2d") or d,
        staged_wire=lambda h, cols, m: h,
        import_wire=lambda b, w: calls.append(("scatter", b)))
    group = types.SimpleNamespace(store=None, world_size=2, followers=[])
    br = BroadcastingRunner(runner, group)
    published = []
    br._bc = types.SimpleNamespace(publish=published.append)
    args = {"stage_export_blocks": ([3, 4],), "export_blocks": ([3, 4],),
            "materialize_export": ((2, wire, None),),
            "stage_import_blocks": (wire,),
            "import_staged_blocks": ([5, 6], wire, [0, 1]),
            "import_blocks": ([5, 6], wire)}[name]
    getattr(br, name)(*args)
    assert [m["kind"] for m in published] == KV_METHODS[name]
    for m in published:
        assert not any(isinstance(a, torch.Tensor) for a in m["args"])
    if KV_METHODS[name] == ["kv_import"]:
        assert published[0]["kwargs"] == {"shape": (2, 2, 3),
                                          "dtype": "float32"}
        assert calls[-1] == ("scatter", [5, 6])


def test_broadcast_refuses_device_tensors_and_stages():
    """A device tensor rides no step: a chained round's tokens must be
    the last row of the previous round's (published as the marker
    'chained'), any other tensor argument and any staged buffer are
    refused before anything is published."""
    toks = torch.arange(8, dtype=torch.int32).view(4, 2)
    runner = types.SimpleNamespace(decode_multi=lambda *a, **k: toks)
    group = types.SimpleNamespace(store=None, world_size=2, followers=[])
    br = BroadcastingRunner(runner, group)
    published = []
    br._bc = types.SimpleNamespace(publish=published.append)
    with pytest.raises(RuntimeError, match="no decode round before"):
        br.decode_multi(torch.zeros(2, dtype=torch.int32), [0])
    with pytest.raises(RuntimeError, match="device tensor"):
        br.decode_multi([1], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="staged"):
        br.decode_multi([1], [0], staged=object())
    assert not published
    br.decode_multi([1, 2], [0])
    with pytest.raises(RuntimeError, match="last row"):
        br.decode_multi(toks[-1].clone(), [0])
    br.decode_multi(toks[-1], [0])
    assert [m["args"][0] for m in published] == [[1, 2], "chained"]
    # the chained-on round (round 0) is checked at the next step
    br.reset_counts()
    assert published[-1]["chain_check"] == (0, [6, 7])


def _failing_engine(np_params, timeout_s, **over):
    cfg = EngineConfig(model=TIED.name, device="cpu",
                       tensor_parallel_size=2, **{**ENGINE, **over})
    group = start_tp_ranks(cfg, params=params_from_numpy(np_params["tied"],
                                                         "cpu"),
                           timeout_s=timeout_s)
    return LLMEngine(cfg, params=params_from_numpy(np_params["tied"], "cpu"),
                     tp_group=group)


def _adapter_file(path):
    rng = np.random.RandomState(1)
    L, h, q = TIED.num_layers, TIED.hidden_size, TIED.q_size
    np.savez(path, wq_A=rng.randn(L, h, 2).astype(np.float32),
             wq_B=rng.randn(L, 2, q).astype(np.float32))
    return str(path)


@pytest.mark.parametrize("how", ["raises", "killed", "export", "import",
                                 "lora"])
def test_follower_failure_raises_on_rank0_within_the_timeout(np_params, how,
                                                             tmp_path):
    """A follower that raises (an unknown step kind; a KV export, a KV
    import or an adapter load that fails on it) or dies makes rank 0's
    next dispatch raise, naming the follower's error, well inside the
    group timeout; the rank set then reports dead. A failed import is
    an error, not a counted fallback; a failed adapter load leaves no
    rank serving it."""
    timeout_s = 20.0
    over = ({"enable_lora": True, "max_loras": 1, "max_lora_rank": 4}
            if how == "lora" else {})
    eng = _failing_engine(np_params, timeout_s, **over)
    proc = eng.runner._group.followers[0]
    wire = torch.zeros(2, TIED.num_layers, 1, TIED.num_kv_heads, 4,
                       TIED.head_dim)
    poison = {
        "raises": {"kind": "no-such-step"},
        # a block id past the follower's cache
        "export": {"kind": "kv_export", "args": ([10**6],), "kwargs": {}},
        # a wire dtype torch does not have
        "import": {"kind": "kv_import", "args": ([1],),
                   "kwargs": {"shape": tuple(wire.shape),
                              "dtype": "no_such_dtype"}},
        "lora": {"kind": "lora_load",
                 "args": ("x", str(tmp_path / "none.npz"), 1),
                 "kwargs": {}},
    }
    act = {
        "export": lambda: eng.runner.export_blocks([1]),
        "import": lambda: eng.runner.import_blocks([1], wire),
        "lora": lambda: eng.load_lora("a", _adapter_file(tmp_path / "a.npz")),
    }.get(how, lambda: eng.generate([PROMPTS[0]], SamplingParams(**GREEDY)))
    try:
        assert eng.tp_alive()
        if how == "killed":
            proc.kill()
            proc.join(10)
        else:
            eng.runner._bc.publish(poison[how])
        t0 = time.monotonic()
        with pytest.raises(RankSetError) as info:
            act()
        assert time.monotonic() - t0 < timeout_s
        assert "rank 1" in str(info.value)
        if how == "raises":
            assert "unknown tensor-parallel step kind" in str(info.value)
        elif how != "killed":
            assert f"failed at {'lora_load' if how == 'lora' else 'kv_' + how}"\
                in str(info.value)
        assert not eng.tp_alive()
        with pytest.raises(RuntimeError, match="rank set failed"):
            eng.runner.embed([1, 2, 3])
        if how == "import":
            # the engine's restore landing raises; no counted fallback
            with pytest.raises(RankSetError):
                eng._import_restored([2], [], None, [0])
            assert eng._kv_restore_fallbacks_total == 0
        if how == "lora":
            assert eng.list_loras() == []
    finally:
        eng.shutdown()
    assert proc.exitcode not in (0, None)
