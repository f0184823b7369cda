"""The long-context path of the PyTorch port against the JAX package's.

- parallel/ring_attention.py: the port's ring (sp ranks driven from one
  process, here all on the CPU) against the JAX ring (shard_map over the
  conftest's 8 virtual CPU devices) and the unsharded oracle, on the same
  numpy inputs: sp 1/2/4, causal and not, GQA, q_offset and window.
- parallel/long_context.py: LongContextPrefiller.prefill and a sequence
  of prefill_chunk calls against JAX's on the same (converted) params:
  logits and the gathered K/V; the padding helpers over a grid; each
  shard holds S_pad / sp rows.
- engine/long_prefill.py and the engine's lane: port engines with the
  lane (sp 2 and 4) against a JAX engine with the lane and the port's
  chunked control on the same params: greedy tokens (and their top-2
  logprobs), the long-prefill counters, the timeline event's keys; the
  windowed model; short prompts, prompt_logprobs and adapter requests
  stay chunked; abort cancels; decode rounds keep running while a ring
  is in flight; a landed chain spills to disk and a resume restores it;
  the config refusals and the degraded boot.

All float32: the ring's online softmax sums in another order than the
chunked path's attention, so the tokens are compared exactly and the
values within 1e-5 relative. One JAX engine serves every dense scenario
(module-scoped), so its programs compile once.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import config as jmcfg
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel import long_context as jlc
from production_stack_tpu.parallel import ring_attention as jring
from production_stack_tpu.parallel.compat import shard_map
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.long_prefill import (
    LAND_BATCH_BLOCKS,
    LongPrefillManager,
)
from production_stack_tpu_torch.engine.lora import write_peft_adapter
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.sequence import Sequence
from production_stack_tpu_torch.models import config as tmcfg
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.parallel import long_context as tlc
from production_stack_tpu_torch.parallel import ring_attention as tring

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5

# the engine scenarios' model: the tiny debug widths, a long context
DENSE = jmcfg.ModelConfig(
    name="pst-lc-port", vocab_size=384, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, max_model_len=4096, rope_theta=10000.0,
    tie_word_embeddings=True,
)
WINDOWED = dataclasses.replace(DENSE, name="pst-lc-port-win",
                               sliding_window=96)
JCFGS = {"dense": DENSE, "windowed": WINDOWED}
# the JAX long-context test's prefiller model
SMALL = jmcfg.ModelConfig(
    name="lc-test", vocab_size=128, hidden_size=32, intermediate_size=64,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
    max_model_len=256, rope_theta=10000.0, tie_word_embeddings=True,
)

THRESHOLD, CHUNK, BLOCKS = 256, 128, 96
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True, logprobs=2)


def _tcfg(jcfg):
    return tmcfg.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tmcfg.ModelConfig)})


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _prompt(n: int, seed: int = 0) -> list[int]:
    return np.random.RandomState(seed).randint(0, 384, n).tolist()


@pytest.fixture(autouse=True, scope="module")
def register_cfgs():
    for jc in JCFGS.values():
        jmcfg._PRESETS[jc.name] = jc
        tmcfg._PRESETS[jc.name] = _tcfg(jc)
    yield
    for jc in JCFGS.values():
        jmcfg._PRESETS.pop(jc.name, None)
        tmcfg._PRESETS.pop(jc.name, None)


@pytest.fixture(scope="module")
def np_params():
    return {k: jax.tree_util.tree_map(
        np.asarray, jllama.init_params(c, jax.random.key(0), jnp.float32))
        for k, c in JCFGS.items()}


# -- the ring --------------------------------------------------------------
def _qkv(b, s, h, hk, d, seed=0, sq=None):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq or s, h, d).astype(np.float32),
            rng.randn(b, s, hk, d).astype(np.float32),
            rng.randn(b, s, hk, d).astype(np.float32))


def _mesh(sp):
    return Mesh(np.array(jax.devices()[:sp]), ("sp",))


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_equals_jax_ring_and_oracle(sp, causal):
    q, k, v = _qkv(2, 32, 4, 4, 16)
    want = np.asarray(jring.ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _mesh(sp),
        causal=causal))
    got = tring.ring_attention(*map(torch.from_numpy, (q, k, v)),
                               ["cpu"] * sp, causal=causal)
    _close(got, want)
    _close(tring.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal),
           jring.attention_reference(*map(jnp.asarray, (q, k, v)),
                                     causal=causal))


@pytest.mark.parametrize("h,hk", [(8, 2), (4, 1), (6, 3)])
def test_ring_gqa_equals_jax(h, hk):
    q, k, v = _qkv(1, 32, h, hk, 8, seed=3)
    want = jring.ring_attention(*map(jnp.asarray, (q, k, v)), _mesh(4))
    got = tring.ring_attention(*map(torch.from_numpy, (q, k, v)),
                               ["cpu"] * 4)
    _close(got, want)
    _close(got, jring.attention_reference(*map(jnp.asarray, (q, k, v))))


@pytest.mark.parametrize("sp,start,window", [
    (2, 0, None), (2, 32, None), (4, 64, None), (2, 32, 24), (4, 48, 40),
    (1, 16, 8),
])
def test_ring_local_q_offset_and_window_equal_jax(sp, start, window):
    """A C-row chunk at global offset `start` against a 128-row cache:
    the port's ring_attention_local on each rank (through
    ring_attention_blocks) equals JAX's ring_attention_local in
    shard_map with q_offset, and the oracle's rows of the full prompt."""
    S, C = 128, 32
    q, k, v = _qkv(1, S, 4, 2, 8, seed=7)
    qc = q[:, start:start + C]
    scale = 0.3
    spec = P(None, "sp", None, None)
    fn = shard_map(
        functools.partial(jring.ring_attention_local, axis_name="sp",
                          scale=scale, window=window),
        mesh=_mesh(sp), in_specs=(spec, spec, spec, P()), out_specs=spec)
    want = np.asarray(jax.jit(fn)(jnp.asarray(qc), jnp.asarray(k),
                                  jnp.asarray(v), jnp.int32(start)))
    lk = S // sp
    kb = [torch.from_numpy(k[:, j * lk:(j + 1) * lk]) for j in range(sp)]
    vb = [torch.from_numpy(v[:, j * lk:(j + 1) * lk]) for j in range(sp)]
    got = tring.ring_attention_blocks(torch.from_numpy(qc), kb, vb, start,
                                      scale=scale, window=window)
    _close(got, want)
    full = jring.attention_reference(*map(jnp.asarray, (q, k, v)),
                                     scale=scale, window=window)
    _close(got, np.asarray(full)[:, start:start + C])
    # one rank's body alone: its query block, every rank's KV block
    lq = C // sp
    one = tring.ring_attention_local(
        torch.from_numpy(qc[:, (sp - 1) * lq:]), kb, vb, sp - 1, start,
        scale=scale, window=window)
    _close(one, want[:, (sp - 1) * lq:])


def test_ring_bfloat16_is_close_to_f32():
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=9)
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    got = tring.ring_attention(*t, ["cpu"] * 4)
    assert got.dtype == torch.bfloat16
    want = tring.attention_reference(*[x.float() for x in t])
    _close(got.float(), want, rel=2**-7)


def test_ring_refuses_an_unpadded_sequence():
    q, k, v = map(torch.from_numpy, _qkv(1, 30, 2, 2, 8))
    with pytest.raises(ValueError, match="divisible"):
        tring.ring_attention(q, k, v, ["cpu"] * 4)


# -- the prefiller -----------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    params = jllama.init_params(SMALL, jax.random.key(0), jnp.float32)
    ids = np.random.RandomState(1).randint(0, SMALL.vocab_size, 50).tolist()
    return params, ids


@pytest.mark.parametrize("sp", [2, 4])
def test_prefill_equals_jax_prefiller(small, sp):
    params, ids = small
    want = jlc.LongContextPrefiller(
        SMALL, params, jlc.make_sp_mesh(1, sp)).prefill(ids)
    pre = tlc.LongContextPrefiller(
        _tcfg(SMALL), params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), "cpu"),
        tlc.make_sp_ring(sp, ["cpu"] * sp))
    logits, k, v, n = pre.prefill(ids)
    assert n == want[3] == len(ids)
    _close(logits, want[0])
    assert tuple(k.gather().shape) == tuple(want[1].shape)
    _close(k.gather()[:, :, :n], np.asarray(want[1])[:, :, :n])
    _close(v.gather()[:, :, :n], np.asarray(want[2])[:, :, :n])


def test_prefill_chunks_equal_jax_chunks_and_one_shot(small):
    """The serving API: five 16-row chunks of a 70-token prompt over a
    128-row cache (chunk x pow2), each chunk's last-row logits and the
    final caches against JAX's prefill_chunk sequence, and the last
    chunk's logits against the one-shot prefill."""
    params, _ = small
    ids = np.random.RandomState(2).randint(0, SMALL.vocab_size, 70).tolist()
    sp, C = 2, 16
    jpre = jlc.LongContextPrefiller(SMALL, params, jlc.make_sp_mesh(1, sp))
    tpre = tlc.LongContextPrefiller(
        _tcfg(SMALL), params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), "cpu"),
        ["cpu"] * sp)
    S = tpre.seq_pad(len(ids), C)
    assert S == jpre.seq_pad(len(ids), C) == 128
    jk, jv = jpre.begin_cache(S)
    tk, tv = tpre.begin_cache(S)
    for start in range(0, len(ids), C):
        last = min(len(ids) - 1 - start, C - 1)
        jl, jk, jv = jpre.prefill_chunk(
            jk, jv, jpre.stage_tokens(ids[start:start + C], C), start, last)
        tl, tk, tv = tpre.prefill_chunk(
            tk, tv, tpre.stage_tokens(ids[start:start + C], C), start, last)
        _close(tl, jl)
    n = len(ids)
    _close(tk.gather()[:, :, :n], np.asarray(jk)[:, :, :n])
    _close(tv.gather()[:, :, :n], np.asarray(jv)[:, :, :n])
    _close(tl, tpre.prefill(ids)[0])


def test_windowed_prefill_equals_jax(small):
    params, _ = small
    cfg = dataclasses.replace(SMALL, sliding_window=12)
    ids = np.random.RandomState(4).randint(0, SMALL.vocab_size, 40).tolist()
    want = jlc.LongContextPrefiller(cfg, params,
                                    jlc.make_sp_mesh(1, 4)).prefill(ids)
    got = tlc.LongContextPrefiller(
        _tcfg(cfg), params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), "cpu"),
        ["cpu"] * 4).prefill(ids)
    _close(got[0], want[0])
    _close(got[1].gather()[:, :, :40], np.asarray(want[1])[:, :, :40])


def test_padding_helpers_equal_jax(small):
    params, _ = small
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    for sp in (2, 4, 8):
        j = jlc.LongContextPrefiller(SMALL, params, jlc.make_sp_mesh(1, sp))
        t = tlc.LongContextPrefiller(_tcfg(SMALL), tparams, ["cpu"] * sp)
        for n in list(range(1, 70)) + [255, 256, 257, 1100, 4000, 16000]:
            assert t.pad_to(n) == j.pad_to(n), (sp, n)
            for chunk in (16, 128, 2048):
                assert t.seq_pad(n, chunk) == j.seq_pad(n, chunk)
        for chunk in (1, 7, 16, 100, 128, 2048):
            for align in (1, 3, 4, 16, 32):
                assert t.chunk_to(chunk, align) == j.chunk_to(chunk, align)


@pytest.mark.parametrize("sp", [2, 4])
def test_each_shard_holds_s_pad_over_sp_rows(small, sp):
    params, ids = small
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    pre = tlc.LongContextPrefiller(_tcfg(SMALL), tparams, ["cpu"] * sp)
    # on the params' own device the ring uses the caller's tensors
    assert pre.params is tparams
    _, k, v, _ = pre.prefill(ids)
    S = pre.pad_to(len(ids))
    for c in (k, v):
        assert len(c.shards) == sp
        assert {tuple(s.shape) for s in c.shards} == {
            (SMALL.num_layers, SMALL.num_kv_heads, S // sp,
             SMALL.head_dim)}
    with pytest.raises(ValueError, match="sp=3 > available"):
        tlc.make_sp_ring(3, ["cpu", "cpu"])


# -- the lane in an engine ---------------------------------------------------
def _tconfig(model, long=True, sp=2, **kw):
    base = dict(model=model, tokenizer="byte", dtype="float32",
                cache_dtype="float32", block_size=32, num_kv_blocks=BLOCKS,
                max_num_seqs=4, max_prefill_chunk=256, seed=0, device="cpu")
    if long:
        base.update(long_prefill_threshold=THRESHOLD,
                    context_parallel_size=sp, long_prefill_chunk=CHUNK)
    base.update(kw)
    return EngineConfig(**base)


def _jengine(model, params):
    return JEngine(JConfig(
        model=model, tokenizer="byte", dtype="float32",
        cache_dtype="float32", block_size=32, num_kv_blocks=BLOCKS,
        max_num_seqs=4, max_prefill_chunk=256, seed=0, attention_impl="xla",
        long_prefill_threshold=THRESHOLD, context_parallel_size=2,
        long_prefill_chunk=CHUNK,
    ), params=jax.tree_util.tree_map(jnp.asarray, params))


def _drive(eng, reqs, sp_cls, arrivals=None, on_step=None):
    """Add `reqs` ({id: (prompt, sampling kwargs)}) — each at its step in
    `arrivals` (default 0) — and step to the end; {id: final output}."""
    arrivals = arrivals or {}
    finals, step = {}, 0
    pending = dict(reqs)
    while pending or eng.has_unfinished():
        for rid in [r for r in pending if arrivals.get(r, 0) <= step]:
            prompt, kw = pending.pop(rid)
            eng.add_request(rid, prompt_token_ids=prompt,
                            sampling_params=sp_cls(**kw))
        if on_step is not None:
            on_step(eng)
        for o in eng.step():
            if o.finished:
                finals[o.request_id] = o
        step += 1
        assert step < 2000
    return finals


def _lp_rows(out):
    return [[e["logprob"] for e in row["top_logprobs"]]
            for row in out.logprobs]


def _same_streams(got: dict, want: dict):
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid].token_ids == want[rid].token_ids, rid
        if want[rid].logprobs is not None:
            _close(_lp_rows(got[rid]), _lp_rows(want[rid]))


LONG_COUNTERS = ("long_prefill_requests_total", "long_prefill_chunks_total",
                 "long_prefill_fallbacks_total")


def _counters(eng):
    st = eng.stats()
    return {k: getattr(st, k) for k in LONG_COUNTERS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _long_event(eng, rid):
    for t in eng.timeline.snapshot(limit=64):
        if t["request_id"] == rid:
            (ev,) = [e for e in t["events"] if e["name"] == "long_prefill"]
            return ev["attributes"]
    raise AssertionError(f"no timeline for {rid}")


@pytest.fixture(scope="module")
def engines(np_params):
    """One JAX lane engine (sp 2) and port engines on the same params:
    the lane at sp 2 and sp 4, and the chunked control."""
    tp = params_from_numpy(np_params["dense"], "cpu")
    out = {
        "jax": _jengine(DENSE.name, np_params["dense"]),
        "sp2": LLMEngine(_tconfig(DENSE.name, sp=2), params=tp),
        "sp4": LLMEngine(_tconfig(DENSE.name, sp=4), params=tp),
        "ctrl": LLMEngine(_tconfig(DENSE.name, long=False), params=tp),
    }
    yield out
    for e in out.values():
        e.shutdown()


def _run_all(engines, reqs, **kw) -> tuple[dict, dict]:
    """The same requests through every engine -> ({name: finals},
    {name: long-prefill counter deltas})."""
    outs, deltas = {}, {}
    for name, eng in engines.items():
        c0 = _counters(eng)
        outs[name] = _drive(eng, reqs,
                            JSampling if name == "jax" else SamplingParams,
                            **kw)
        deltas[name] = _delta(_counters(eng), c0)
    return outs, deltas


def test_lane_streams_counters_and_event_equal_jax(engines):
    """A 600-token prompt (five 128-token ring chunks over a 1024-row
    cache) beside a short one: tokens and top-2 logprobs equal across
    the JAX lane, the port's lane at sp 2 and 4 and the port's chunked
    control; the lane's counters equal JAX's; the long_prefill event has
    JAX's attribute keys and values (times aside)."""
    reqs = {"long": (_prompt(600, 1), GREEDY),
            "short": (_prompt(40, 2), GREEDY)}
    outs, deltas = _run_all(engines, reqs)
    for name in ("sp2", "sp4", "ctrl"):
        _same_streams(outs[name], outs["jax"])
    want = {"long_prefill_requests_total": 1, "long_prefill_chunks_total": 5,
            "long_prefill_fallbacks_total": 0}
    assert deltas["jax"] == want
    assert deltas["sp2"] == deltas["sp4"] == want
    assert deltas["ctrl"] == dict.fromkeys(LONG_COUNTERS, 0)
    jev = _long_event(engines["jax"], "long")
    for name in ("sp2", "sp4"):
        ev = _long_event(engines[name], "long")
        assert ev.keys() == jev.keys()
        for key in ("prompt_tokens", "chunk_tokens", "chunks",
                    "blocks_landed", "cached_prompt_tokens"):
            assert ev[key] == jev[key], key
        assert ev["ring_s"] > 0 and ev["d2h_s"] >= 0
    st = engines["sp2"].stats()
    assert st.long_prefill_ring_seconds_total > 0
    assert st.long_prefill_land_seconds_total > 0
    assert not engines["sp2"].long_prefill.active


def test_decode_rounds_keep_running_during_long_prefill(engines):
    """A decoding user's rounds keep dispatching while a long prompt
    rings (JAX's test of the same name), and both streams equal the JAX
    lane's and the chunked control's."""
    reqs = {"dec": (_prompt(40, 7), dict(GREEDY, max_tokens=40)),
            "ring": (_prompt(700, 8), GREEDY)}
    during = {}

    def watch(eng):
        lp = getattr(eng, "long_prefill", None)
        if lp is not None and lp.active:
            during.setdefault(id(eng), []).append(eng._decode_rounds_total)

    outs, deltas = _run_all(engines, reqs, arrivals={"ring": 6},
                            on_step=watch)
    for name in ("sp2", "sp4", "ctrl"):
        _same_streams(outs[name], outs["jax"])
    for name in ("sp2", "sp4"):
        assert deltas[name]["long_prefill_requests_total"] == 1
        rounds = during[id(engines[name])]
        assert rounds[-1] - rounds[0] >= 3, rounds


def test_short_and_prompt_logprob_prompts_stay_chunked(engines):
    """At or below the threshold, and prompt_logprobs above it, a lane
    engine serves chunked: counters still, streams and prompt logprobs
    equal JAX's."""
    plp = dict(GREEDY, max_tokens=2, prompt_logprobs=1)
    reqs = {"short": (_prompt(200, 3), GREEDY),
            "plp": (_prompt(500, 5), plp)}
    outs, deltas = _run_all(engines, reqs)
    for name in ("sp2", "sp4", "ctrl"):
        _same_streams(outs[name], outs["jax"])
        assert deltas[name] == dict.fromkeys(LONG_COUNTERS, 0)
        got = [r["logprob"] for r in outs[name]["plp"].prompt_logprobs[1:]]
        want = [r["logprob"] for r in outs["jax"]["plp"].prompt_logprobs[1:]]
        _close(got, want)
    assert deltas["jax"] == dict.fromkeys(LONG_COUNTERS, 0)


def test_abort_cancels_the_ring_job(engines):
    eng = engines["sp2"]
    eng.add_request("doomed", prompt_token_ids=_prompt(1100, 9),
                    sampling_params=SamplingParams(**GREEDY))
    for _ in range(3):
        eng.step()
    assert eng.long_prefill.active
    assert eng.abort_request("doomed")
    assert not eng.long_prefill.active
    reqs = {"after": (_prompt(50, 10), GREEDY)}
    got = _drive(eng, reqs, SamplingParams)
    _same_streams(got, _drive(engines["ctrl"], reqs, SamplingParams))


def test_adapter_requests_stay_chunked(engines, np_params, tmp_path):
    """The ring runs base weights only: an adapter request past the
    threshold is declined by the admission hook and serves chunked,
    equal to a no-lane engine with the same adapter."""
    rng = np.random.RandomState(3)
    L, h, r = DENSE.num_layers, DENSE.hidden_size, 4
    w = {"wq_A": rng.randn(L, h, r) * 0.1,
         "wq_B": rng.randn(L, r, DENSE.num_heads * DENSE.head_dim) * 0.1}
    path = write_peft_adapter(str(tmp_path / "a1"),
                              {k: v.astype(np.float32) for k, v in w.items()},
                              lora_alpha=8.0)
    tp = params_from_numpy(np_params["dense"], "cpu")
    outs = {}
    for long in (True, False):
        eng = LLMEngine(_tconfig(DENSE.name, long=long, enable_lora=True,
                                 max_loras=2, max_lora_rank=8), params=tp)
        eng.load_lora("a1", path)
        eng.add_request("lora", prompt_token_ids=_prompt(400, 11),
                        sampling_params=SamplingParams(**GREEDY),
                        lora_name="a1")
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    outs[long] = o
        assert eng.stats().long_prefill_requests_total == 0
        eng.shutdown()
    assert outs[True].token_ids == outs[False].token_ids
    seq = Sequence("x", _prompt(400), SamplingParams(**GREEDY), None,
                   lora_name="a1")
    assert engines["sp2"]._begin_long_prefill(seq) is False


def test_spill_to_disk_and_resume_restores(engines, np_params, tmp_path):
    """A ring-landed chain registers in the prefix cache, spills to the
    disk tier when later traffic evicts it, and a resume restores it:
    tokens equal to the JAX lane's and the chunked control's."""
    prompt = _prompt(1280, 11)
    eng = LLMEngine(_tconfig(DENSE.name, num_kv_blocks=64,
                             disk_offload_dir=str(tmp_path / "kv")),
                    params=params_from_numpy(np_params["dense"], "cpu"))
    try:
        first = _drive(eng, {"a": (prompt, GREEDY)}, SamplingParams)["a"]
        assert eng.stats().long_prefill_requests_total == 1
        _drive(eng, {"b": (_prompt(1280, 12), GREEDY)}, SamplingParams)
        deadline = time.time() + 10
        while time.time() < deadline and not eng.offload.tiers[0].hashes():
            eng.step()
            time.sleep(0.01)
        assert eng.offload.tiers[0].hashes(), "chain never spilled"
        resume = prompt + list(first.token_ids) + _prompt(40, 13)
        got = _drive(eng, {"r": (resume, GREEDY)}, SamplingParams)
        assert eng.stats().kv_restore_blocks_total > 0
    finally:
        eng.shutdown()
    reqs = {"a": (prompt, GREEDY)}
    want = _drive(engines["jax"], reqs, JSampling)
    assert first.token_ids == want["a"].token_ids
    reqs = {"r": (resume, GREEDY)}
    want = _drive(engines["jax"], reqs, JSampling)
    _same_streams(got, want)
    _same_streams(_drive(engines["ctrl"], reqs, SamplingParams), want)


def test_windowed_model_rides_the_ring_window(np_params):
    """Sliding-window attention in the ring: the lane's tokens equal the
    JAX lane's and the port's chunked control's on a 700-token prompt
    past a 96-token window."""
    reqs = {"w": (_prompt(700, 3), GREEDY)}
    tp = params_from_numpy(np_params["windowed"], "cpu")
    engs = {"jax": _jengine(WINDOWED.name, np_params["windowed"]),
            "sp2": LLMEngine(_tconfig(WINDOWED.name), params=tp),
            "ctrl": LLMEngine(_tconfig(WINDOWED.name, long=False),
                              params=tp)}
    try:
        outs, deltas = _run_all(engs, reqs)
    finally:
        for e in engs.values():
            e.shutdown()
    _same_streams(outs["sp2"], outs["jax"])
    _same_streams(outs["ctrl"], outs["jax"])
    assert deltas["sp2"] == deltas["jax"]
    assert deltas["sp2"]["long_prefill_requests_total"] == 1


def test_land_batches_are_the_wire_layout(engines):
    """The worker's batches are (2, L, n, nkv, bs, d) blocks of at most
    LAND_BATCH_BLOCKS covering the prompt, and the paged blocks they
    land in hold the chunked control's K/V of the same prompt."""
    prompt = _prompt(1100, 14)
    mgr: LongPrefillManager = engines["sp2"].long_prefill
    seen = []
    land = mgr._land_one_batch

    def spy(rec):
        if rec["batches"]:
            seen.append(tuple(rec["batches"][0][1].shape))
        return land(rec)

    def kv_after_prefill(eng):
        """The prompt's K/V rows from the paged cache once it is
        prefilled (before its blocks can be reused)."""
        eng.add_request("wire", prompt_token_ids=prompt,
                        sampling_params=SamplingParams(**GREEDY))
        seq = eng._seqs["wire"]
        while not seq.prefill_done or seq.long_prefill_active:
            eng.step()
        slots = torch.as_tensor(
            [b * 32 + i for b in seq.block_table for i in range(32)]
        )[:len(prompt)]
        kv = [c[:, :, slots].clone() for c in (eng.runner.k_cache,
                                              eng.runner.v_cache)]
        while eng.has_unfinished():
            eng.step()
        return kv

    mgr._land_one_batch = spy
    try:
        got = kv_after_prefill(engines["sp2"])
    finally:
        del mgr._land_one_batch
    cfg = DENSE
    assert seen[0] == (2, cfg.num_layers, LAND_BATCH_BLOCKS,
                       cfg.num_kv_heads, 32, cfg.head_dim)
    assert sum(s[2] for s in seen) == -(-len(prompt) // 32)
    want = kv_after_prefill(engines["ctrl"])
    for g, w in zip(got, want):
        _close(g, w)


# -- config ------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(long_prefill_threshold=1024),
    dict(long_prefill_threshold=1024, context_parallel_size=1),
    dict(long_prefill_threshold=0, context_parallel_size=2),
    dict(long_prefill_threshold=-5, context_parallel_size=2),
])
def test_config_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        JConfig(model="pst-tiny-debug", **kw)
    with pytest.raises(ValueError) as got:
        EngineConfig(model="pst-tiny-debug", device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_ring_under_tensor_parallelism_is_refused_by_name(np_params,
                                                         engines):
    """The ring under tensor parallelism, once refused by the name
    context_parallel_size>1, is served: each tp rank rings its own kv
    heads (tests/test_torch_rank_set_serving.py holds it to the JAX
    meshed engine). A >threshold prompt at tp=2 x sp=2 lands as the
    chunked control decodes it."""
    eng = LLMEngine(_tconfig(DENSE.name, tensor_parallel_size=2),
                    params=params_from_numpy(np_params["dense"], "cpu"))
    try:
        pre = eng.long_prefill.prefiller
        assert pre.tp_group is not None and pre.sp == 2
        assert pre.cfg.num_kv_heads == DENSE.num_kv_heads // 2
        reqs = {"x": (_prompt(300, 4), GREEDY)}
        got = _drive(eng, reqs, SamplingParams)["x"]
        assert eng.stats().long_prefill_requests_total == 1
        assert eng.stats().long_prefill_fallbacks_total == 0
    finally:
        eng.shutdown()
    want = _drive(engines["ctrl"], reqs, SamplingParams)["x"]
    assert got.token_ids == want.token_ids


def test_a_ring_that_cannot_be_built_degrades_loudly(np_params, monkeypatch):
    from production_stack_tpu_torch.engine import llm_engine, model_runner

    def broken(self):
        raise ValueError("no ring here")

    monkeypatch.setattr(model_runner.ModelRunner, "build_long_prefiller",
                        broken)
    warned = []
    monkeypatch.setattr(llm_engine.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    eng = LLMEngine(_tconfig(DENSE.name),
                    params=params_from_numpy(np_params["dense"], "cpu"))
    assert eng.long_prefill is None
    assert any("long-prefill lane DISABLED (no ring here)" in w
               for w in warned)
    out = _drive(eng, {"x": (_prompt(300, 4), GREEDY)}, SamplingParams)
    assert len(out["x"].token_ids) == 8
    assert eng.stats().long_prefill_requests_total == 0
