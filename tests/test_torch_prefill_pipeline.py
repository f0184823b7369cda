"""The port's default configuration — pipelined prefill, decode prefetch
and staged ragged rounds — against the JAX package's, both on the CPU in
float32.

- Config: the port's EngineConfig() equals the JAX package's on every
  field the port has, and its CLI defaults to both flags on.
- Runner: one packed buffer a prefill dispatch gives the per-array
  path's tokens and logits (tests/test_prefill_pipeline.py:68), and the
  JAX runner's within 1e-5 relative; a dispatch that consumes a staged
  buffer equals one that builds its own (:96); a staged buffer whose
  bucket key or length does not match the dispatch is ignored (:112,
  tests/test_ragged_dispatch.py:320). Staged buffers equal, element for
  element, what the dispatch builds from the same arguments.
- Engine scenarios of tests/test_prefill_pipeline.py, test_multistep.py
  (:136, :171, :209) and test_ragged_dispatch.py (:298, :320), each run
  on the port and on the JAX engine at their defaults (both flags on):
  greedy streams, staged hits and misses (prefill, decode, ragged),
  chained chunks and every step's round kind are equal, and the KV of
  every cached block agrees within 1e-5 relative. The JAX engines are
  shared per configuration (counters are compared as deltas; prompts
  differ between scenarios, so no prefix hit crosses them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from production_stack_tpu.engine import block_manager as jbm
from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.model_runner import ModelRunner as JRunner
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine import block_manager as tbm
from production_stack_tpu_torch.engine.__main__ import (
    build_parser,
    config_from_args,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

COMMON = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
              cache_dtype="float32", seed=0)
# tests/test_prefill_pipeline.py, test_multistep.py and
# test_ragged_dispatch.py configurations
CFG_PF = dict(block_size=4, num_kv_blocks=128, max_num_seqs=4,
              max_prefill_chunk=16)
CFG_MS = dict(block_size=8, num_kv_blocks=128, max_num_seqs=4,
              max_prefill_chunk=32, num_scheduler_steps=4)
CFG_RG = dict(block_size=8, num_kv_blocks=256, max_num_seqs=2,
              max_prefill_chunk=8, num_scheduler_steps=4)
REL = 1e-5
COUNTERS = ("_pf_staged_hits_total", "_pf_staged_misses_total",
            "_pf_chained_chunks_total", "_staged_hits_total",
            "_staged_misses_total", "_ragged_staged_hits_total",
            "_ragged_staged_misses_total")


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_engine(np_params):
    """One JAX engine per configuration, at its defaults (XLA path)."""
    engines = {}

    def get(cfg):
        key = tuple(sorted(cfg.items()))
        if key not in engines:
            engines[key] = JEngine(
                JConfig(**COMMON, **cfg, attention_impl="xla"),
                params=jax.tree_util.tree_map(jnp.asarray, np_params))
        return engines[key]
    return get


def _port(np_params, cfg, **over):
    return LLMEngine(EngineConfig(**COMMON, **cfg, **over, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _greedy(n):
    return dict(max_tokens=n, temperature=0.0, ignore_eos=True)


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 384, size=n).tolist() for n in sizes]


def _drive(eng, arrivals, kw, sp_cls, between=None):
    """Requests arrive at the given step indices; `between(eng)` runs
    before every step. Returns ({rid: token_ids}, [round kind per step],
    {counter: delta})."""
    before = {c: getattr(eng, c) for c in COUNTERS}
    outs, kinds, steps = {}, [], 0
    pending = sorted(arrivals, key=lambda a: a[0])
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= steps:
            _, rid, prompt = pending.pop(0)
            eng.add_request(rid, prompt_token_ids=prompt,
                            sampling_params=sp_cls(**kw))
        if between is not None:
            between(eng)
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.token_ids
        kinds.append(eng.last_step_kind)
        steps += 1
        assert steps < 3000, "engine wedged"
    return outs, kinds, {c: getattr(eng, c) - before[c] for c in COUNTERS}


def _block_kv(eng, hash_fn, ids):
    """{block index: (k, v)} of every full block of `ids` the engine's
    prefix cache holds (both packages chain-hash blocks from seed 0,
    each with its own hash function)."""
    bm = eng.block_manager
    bs = bm.block_size
    k, v = (np.asarray(eng.runner.k_cache), np.asarray(eng.runner.v_cache))
    out, h = {}, 0
    for i in range(len(ids) // bs):
        h = hash_fn(h, tuple(ids[i * bs:(i + 1) * bs]))
        bid = bm.cached_blocks.get(h)
        if bid is not None:
            out[i] = (k[:, :, bid * bs:(bid + 1) * bs],
                      v[:, :, bid * bs:(bid + 1) * bs])
    return out


def _assert_kv_close(port, jeng, seqs):
    """The KV of every cached block of each token sequence, port vs JAX,
    within REL of the block's largest value."""
    n = 0
    for ids in seqs:
        got = _block_kv(port, tbm.hash_block, ids)
        want = _block_kv(jeng, jbm.hash_block, ids)
        assert set(got) == set(want)
        for i in got:
            for a, b in zip(got[i], want[i]):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=REL * np.abs(b).max())
                n += 1
    assert n > 0


def _scenario(np_params, jax_engine, cfg, arrivals, kw, between=None,
              check_kv=False):
    jeng = jax_engine(cfg)
    want = _drive(jeng, arrivals, kw, JSampling, between)
    port = _port(np_params, cfg)
    got = _drive(port, arrivals, kw, SamplingParams, between)
    assert got[0] == want[0]  # greedy streams
    assert got[2] == want[2]  # staged hits / misses, chained chunks
    assert got[1] == want[1]  # round kind of every step
    if check_kv:
        _assert_kv_close(port, jeng, [p + got[0][r] for _, r, p in arrivals])
    return port, got


# -- config ----------------------------------------------------------------
def test_config_defaults_equal_jax():
    """Every field the port's EngineConfig has (device aside) has the JAX
    default; the CLI defaults to both flags on and has their --no-."""
    ref = {f.name: f for f in dataclasses.fields(JConfig)}
    diff = []
    for f in dataclasses.fields(EngineConfig):
        if f.name == "device":
            continue
        assert f.name in ref, f.name

        def default(x):
            return (x.default if x.default is not dataclasses.MISSING
                    else x.default_factory())
        if default(f) != default(ref[f.name]):
            diff.append(f.name)
    assert diff == []
    cfg = config_from_args(build_parser().parse_args([]))
    assert cfg.prefill_pipeline and cfg.prefetch_decode
    cfg = config_from_args(build_parser().parse_args(
        ["--no-prefill-pipeline", "--no-prefetch-decode"]))
    assert not cfg.prefill_pipeline and not cfg.prefetch_decode


def test_no_pipeline_flag_selects_serial_path(np_params):
    """--no-prefill-pipeline reaches the engine and the runner
    (tests/test_prefill_pipeline.py:252)."""
    e = _port(np_params, CFG_PF, prefill_pipeline=False)
    assert e.runner.prefill_pipeline is False
    assert e._prefill_pipeline is False
    e2 = _port(np_params, CFG_PF)
    assert e2.runner.prefill_pipeline is True and e2._prefill_pipeline


# -- runner ------------------------------------------------------------------
def _runner(np_params, **over):
    return ModelRunner(EngineConfig(**COMMON, **CFG_PF, **over, device="cpu"),
                       params=params_from_numpy(np_params, "cpu"))


@pytest.mark.parametrize("ragged_kernel", [True, False])
def test_runner_packed_buffer_matches_serial(np_params, ragged_kernel):
    """One packed-buffer dispatch equals the per-array dispatch (the
    ragged-rows layout within 1e-5 of the (s_pad, t_pad) one), and the
    JAX runner's prefill within 1e-5 relative; tokens equal."""
    over = dict(ragged_kernel=ragged_kernel,
                ragged_dispatch=ragged_kernel)
    r_new = _runner(np_params, **over)
    r_old = _runner(np_params, prefill_pipeline=False, **over)
    jr = JRunner(JConfig(**COMMON, **CFG_PF, attention_impl="xla"),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 384, size=13).tolist()
    args = (ids, 0, [2, 3, 4, 5], len(ids))
    (tok_n, lg_n), (tok_o, lg_o) = r_new.prefill(*args), r_old.prefill(*args)
    tok_j, lg_j = jr.prefill(*args)
    assert int(tok_n) == int(tok_o) == int(np.asarray(tok_j))
    np.testing.assert_array_equal(lg_n.numpy(), lg_o.numpy())
    np.testing.assert_allclose(lg_n.numpy(), np.asarray(lg_j), rtol=REL,
                               atol=REL)

    chunks = [rng.randint(0, 384, size=n).tolist() for n in (7, 16, 3)]
    args = (chunks, [0, 0, 0], [[6, 7], [8, 9, 10, 11], [12]],
            [len(c) for c in chunks])
    (tn, ln), (to, lo) = r_new.prefill_batch(*args), r_old.prefill_batch(*args)
    tj, lj = jr.prefill_batch(*args)
    assert r_new.dispatch_counts["prefill_batch"] == 1
    np.testing.assert_array_equal(tn[:3].numpy(), to[:3].numpy())
    np.testing.assert_array_equal(tn[:3].numpy(), np.asarray(tj)[:3])
    for lg in (lo[:3].numpy(), np.asarray(lj)[:3]):
        np.testing.assert_allclose(ln[:3].numpy(), lg, rtol=REL, atol=REL)
    bs = CFG_PF["block_size"]  # past the trash block both layouts write
    for a, b, c in ((r_new.k_cache, r_old.k_cache, jr.k_cache),
                    (r_new.v_cache, r_old.v_cache, jr.v_cache)):
        a = a[:, :, bs:].numpy()
        for ref in (b[:, :, bs:].numpy(), np.asarray(c)[:, :, bs:]):
            np.testing.assert_allclose(a, ref, rtol=0,
                                       atol=REL * np.abs(ref).max())


def _decode_args():
    """Two decode lanes whose tables cover three more rounds of K=4;
    lanes 2 and 3 of max_num_seqs are padding."""
    return ([list(range(1, 9)), list(range(9, 17))], [5, 9], [6, 10],
            np.zeros(2, np.float32), np.ones(2, np.float32),
            np.full(2, -1, np.int32), np.zeros((2, 2), np.uint32))


def _real_lanes(ys):
    """A fused round's outputs on the two real lanes (padding lanes run
    on whatever token they were handed)."""
    ys = ys if isinstance(ys, tuple) else (ys,)
    return [y[..., :2].numpy() if y.dim() > 1 else y[:2].numpy()
            for y in ys]


def test_runner_staged_dispatch_matches_unstaged(np_params):
    """Each stage_* buffer equals what its dispatch builds from the same
    arguments, and a dispatch consuming it equals one that builds its
    own: prefill, packed prefill, a chained fused decode round and a
    chained ragged round (tests/test_prefill_pipeline.py:96)."""
    r_a = _runner(np_params, num_scheduler_steps=4)
    r_b = _runner(np_params, num_scheduler_steps=4)
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 384, size=9).tolist()
    args = (ids, 0, [2, 3, 4], len(ids))
    h = r_a.stage_prefill(*args)
    np.testing.assert_array_equal(h.dev.numpy(), r_a._fill_prefill_pack(
        *args)[-1])
    (ta, la), (tb, lb) = r_a.prefill(*args, staged=h), r_b.prefill(*args)
    assert int(ta) == int(tb)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())

    chunks = [rng.randint(0, 384, size=n).tolist() for n in (5, 12)]
    args = (chunks, [0, 0], [[20, 21], [22, 23, 24]], [5, 12])
    h = r_a.stage_prefill_batch(*args)
    np.testing.assert_array_equal(h.dev.numpy(),
                                  r_a._fill_rows_prefill_pack(*args)[-1])
    (ta, la), (tb, lb) = (r_a.prefill_batch(*args, staged=h),
                          r_b.prefill_batch(*args))
    np.testing.assert_array_equal(ta.numpy(), tb.numpy())
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    np.testing.assert_array_equal(r_a.k_cache.numpy(), r_b.k_cache.numpy())

    tables, pos, ctx, temps, top_ps, top_ks, keys = _decode_args()
    toks = r_a.decode_multi([7, 8], pos, tables, ctx, 4, temps, top_ps,
                            top_ks, keys)
    r_b.decode_multi([7, 8], pos, tables, ctx, 4, temps, top_ps, top_ks,
                     keys)
    nxt = ([p + 4 for p in pos], tables, [c + 4 for c in ctx], 4, temps,
           top_ps, top_ks, keys + np.array([0, 4], np.uint32))
    h = r_a.stage_decode_multi(*nxt)
    c_pad = r_a._ctx_bucket(max(nxt[2]) + 3)
    np.testing.assert_array_equal(h.dev.numpy(), r_a._fill_decode_pack(
        c_pad, 4, None, *nxt[:3], *nxt[4:], chained=True))
    got = r_a.decode_multi(toks[-1], *nxt[:3], 4, *nxt[4:], staged=h)
    want = r_b.decode_multi(toks[-1].tolist()[:2], *nxt[:3], 4, *nxt[4:])
    for a, b in zip(_real_lanes(got), _real_lanes(want)):
        np.testing.assert_array_equal(a, b)

    pf = ([list(range(40, 46))], [0], [[30, 31]], [6])
    nxt = ([p + 4 for p in nxt[0]], tables, [c + 4 for c in nxt[2]], 4,
           temps, top_ps, top_ks, nxt[7] + np.array([0, 4], np.uint32))
    h = r_a.stage_ragged(*pf, None, *nxt)
    c_pad = r_a._ctx_bucket(max(nxt[2]) + 3)
    np.testing.assert_array_equal(h.dev.numpy(), r_a._fill_ragged_rows_pack(
        *pf, None, c_pad, None, *nxt, chained=True)[-1])
    got = r_a.ragged_dispatch(*pf, got[-1], *nxt, staged=h)
    want = r_b.ragged_dispatch(*pf, want[-1].tolist()[:2], *nxt)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(_real_lanes(got[2]), _real_lanes(want[2])):
        np.testing.assert_array_equal(a, b)


def test_runner_stale_stage_is_ignored(np_params):
    """A staged buffer whose bucket key (prefill) or total length
    (decode, ragged: a stop-id cap that changed since the stage) does
    not match the dispatch is rebuilt from the arguments, never
    trusted, never an error."""
    r, ref = _runner(np_params, num_scheduler_steps=4), _runner(
        np_params, num_scheduler_steps=4)
    rng = np.random.RandomState(6)
    ids9 = rng.randint(0, 384, size=9).tolist()
    ids3 = rng.randint(0, 384, size=3).tolist()
    # staged for a 9-token chunk (t_pad 16), dispatched with 3 (t_pad 8)
    h = r.stage_prefill(ids9, 0, [2, 3, 4], len(ids9))
    tok, _ = r.prefill(ids3, 0, [2], len(ids3), staged=h)
    assert int(tok) == int(ref.prefill(ids3, 0, [2], len(ids3))[0])

    tables, pos, ctx, temps, top_ps, top_ks, keys = _decode_args()
    stop = (np.full(2, -1, np.int32), np.zeros(2, np.int32),
            np.full(2, 4, np.int32), np.array([[7] * 4, [9] * 4],
                                              np.int32))
    chain = r.decode_multi([7, 8], pos, tables, ctx, 4, temps, top_ps,
                           top_ks, keys)[-1]
    ref.decode_multi([7, 8], pos, tables, ctx, 4, temps, top_ps, top_ks,
                     keys)
    # staged without the stop fields, dispatched with them
    h = r.stage_decode_multi(pos, tables, ctx, 4, temps, top_ps, top_ks,
                             keys)
    got = r.decode_multi(chain, pos, tables, ctx, 4, temps, top_ps, top_ks,
                         keys, stop=stop, staged=h)
    want = ref.decode_multi(chain.tolist()[:2], pos, tables, ctx, 4, temps,
                            top_ps, top_ks, keys, stop=stop)
    for a, b in zip(_real_lanes(got), _real_lanes(want)):
        np.testing.assert_array_equal(a, b)

    pf = ([[1, 2, 3, 4]], [12], [[40, 41, 42, 43]], [16])
    h = r.stage_ragged(*pf, None, pos, tables, ctx, 4, temps, top_ps,
                       top_ks, keys)
    got = r.ragged_dispatch(*pf, chain, pos, tables, ctx, 4, temps, top_ps,
                            top_ks, keys, stop=stop, staged=h)
    want = ref.ragged_dispatch(*pf, chain.tolist()[:2], pos, tables, ctx, 4,
                               temps, top_ps, top_ks, keys, stop=stop)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    for a, b in zip(_real_lanes(got[2]), _real_lanes(want[2])):
        np.testing.assert_array_equal(a, b)


# -- engine scenarios ------------------------------------------------------------
@pytest.mark.parametrize("ragged", [True, False])
def test_mixed_batch_matches_jax(np_params, jax_engine, ragged):
    """Packed groups, multi-chunk prompts and decode (tests/
    test_prefill_pipeline.py): at the defaults the finals' lanes make the
    next rounds mixed, so nothing is staged for prefill; on the split
    path (--no-ragged-dispatch on both sides) the next chunk group is
    staged beside the interleaved decode rounds and admitted at zero
    cost."""
    arrivals = [(0, f"r{i}", p) for i, p in enumerate(
        _prompts(7, (5, 23, 45, 12)))]
    port, (_, kinds, counts) = _scenario(
        np_params, jax_engine, {**CFG_PF, "ragged_dispatch": ragged},
        arrivals, _greedy(6), check_kv=True)
    assert port.runner.dispatch_counts["prefill_batch"] > 0
    if ragged:
        assert "ragged" in kinds
    else:
        assert counts["_pf_staged_hits_total"] > 0


def test_cold_multichunk_prompt_chains_matches_jax(np_params, jax_engine):
    """A lone cold prompt's chunks chain in one engine step and only the
    final chunk's token is fetched: four chunks, one prefill step, as on
    the per-array path's tokens."""
    arrivals = [(0, "cold", _prompts(9, (61,))[0])]
    port, (outs, kinds, counts) = _scenario(
        np_params, jax_engine, CFG_PF, arrivals, _greedy(5), check_kv=True)
    assert counts["_pf_chained_chunks_total"] == 3
    assert kinds.count("prefill") == 1
    assert port.runner.dispatch_counts["prefill"] == 4
    serial = _port(np_params, CFG_PF, prefill_pipeline=False)
    assert serial.generate([arrivals[0][2]], SamplingParams(
        **_greedy(5)))[0].token_ids == outs["cold"]
    assert serial._pf_chained_chunks_total == 0


def test_chain_cap_stages_the_next_chunk_matches_jax(np_params,
                                                     jax_engine):
    """A chain stops after max_staged_prefill_run chained chunks (one
    step holds the server's step lock); the next chunk is staged and the
    following step's dispatch consumes it."""
    arrivals = [(0, "long", _prompts(29, (200,))[0])]  # 13 chunks
    _, (_, kinds, counts) = _scenario(np_params, jax_engine, CFG_PF,
                                      arrivals, _greedy(3))
    assert counts["_pf_chained_chunks_total"] == 11
    assert counts["_pf_staged_hits_total"] == 1
    assert kinds[:2] == ["prefill", "prefill"]


def test_prefetch_decode_hits_match_jax(np_params, jax_engine):
    """Steady fused decode rounds consume their staged buffers
    (tests/test_multistep.py:136)."""
    arrivals = [(0, f"p{i}", p) for i, p in enumerate(
        _prompts(5, (9, 17, 30)))]
    _, (_, _, counts) = _scenario(np_params, jax_engine, CFG_MS, arrivals,
                                  _greedy(24), check_kv=True)
    assert counts["_staged_hits_total"] > 0


def test_prefetch_survives_mid_stream_admission_matches_jax(
        np_params, jax_engine):
    """An arrival between rounds changes the lane set: the stage is a
    counted miss or is dropped, as in the reference
    (tests/test_multistep.py:171)."""
    a, b = _prompts(11, (11, 15))
    _scenario(np_params, jax_engine, CFG_MS, [(0, "a", a), (3, "b", b)],
              _greedy(20))


def test_free_epoch_invalidates_stage_matches_jax(np_params, jax_engine):
    """A block free between stage and dispatch (simulated by bumping the
    free epoch whenever a stage exists) turns every stage into a
    counted miss (tests/test_multistep.py:209)."""
    def bump(eng):
        if eng._staged_decode is not None:
            eng.block_manager.free_epoch += 1

    _, (_, _, counts) = _scenario(
        np_params, jax_engine, CFG_MS, [(0, "e", _prompts(13, (11,))[0])],
        _greedy(24), between=bump)
    assert counts["_staged_misses_total"] > 0
    assert counts["_staged_hits_total"] == 0


def test_sampled_streams_equal_without_pipeline(np_params):
    """Seeded sampling is key-driven: the pipeline and the prefetch shift
    no sampling key (the port draws its own noise, so this is held to
    the port with both flags off)."""
    arrivals = [(0, f"s{i}", p) for i, p in enumerate(
        _prompts(17, (9, 17, 30)))]
    kw = dict(max_tokens=12, temperature=0.8, top_p=0.9, seed=3,
              ignore_eos=True)
    on = _drive(_port(np_params, CFG_MS), arrivals, kw, SamplingParams)
    off = _drive(_port(np_params, CFG_MS, prefill_pipeline=False,
                       prefetch_decode=False), arrivals, kw, SamplingParams)
    assert on[0] == off[0]
    assert on[2]["_staged_hits_total"] > 0


def test_staged_ragged_hits_match_jax(np_params, jax_engine):
    """The predicted next lane-typed round is staged and consumed in a
    steady mixed run (tests/test_ragged_dispatch.py:298)."""
    short, long_ = _prompts(19, (5, 59))
    _, (_, kinds, counts) = _scenario(
        np_params, jax_engine, CFG_RG, [(0, "a", short), (3, "b", long_)],
        _greedy(24), check_kv=True)
    assert "ragged" in kinds
    assert counts["_ragged_staged_hits_total"] > 0


def test_stale_ragged_stage_is_counted_miss_matches_jax(np_params,
                                                        jax_engine):
    """A staged ragged round whose state drifted (a free between stage
    and dispatch) is a counted miss, never an error
    (tests/test_ragged_dispatch.py:320)."""
    def bump(eng):
        if eng._staged_ragged is not None:
            eng.block_manager.free_epoch += 1

    short, long_ = _prompts(23, (5, 59))
    _, (_, _, counts) = _scenario(
        np_params, jax_engine, CFG_RG, [(0, "a", short), (3, "b", long_)],
        _greedy(24), between=bump)
    assert counts["_ragged_staged_misses_total"] > 0
    assert counts["_ragged_staged_hits_total"] == 0
