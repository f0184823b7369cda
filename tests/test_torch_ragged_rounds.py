"""The port's unified ragged rounds (ModelRunner.ragged_dispatch, the
engine's _step_ragged) against the JAX package's, both on the CPU in
float32.

- Metadata: the step-0 forward of a mixed round hands the ragged kernel
  (tables, blk_seg, seg_meta); the port's must equal the JAX package's
  (_build_ragged_rows, kernel mode: attention_impl="pallas", Pallas in
  interpret mode) element for element over a set of lane mixes, and so
  must the decode loop's (iterations 1..K-1: no prefill lanes). Both
  runners' attention seams are wrapped to record what they are handed.
- Engine scenarios of tests/test_ragged_dispatch.py, driven by the
  staggered arrivals that make mixed rounds happen: greedy streams equal
  the JAX engine's. The JAX streams come from one shared engine in its
  split single-step configuration (a sequence's greedy stream does not
  depend on the rounds around it; the JAX package's own tests hold its
  ragged rounds to its split path), which keeps the XLA compiles to one
  set.
- Sampled streams: the port draws its noise with numpy from the same
  (seed, step) keys, so mixed rounds at K=4 are held to the port's own
  K=1 streams.
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
from production_stack_tpu_torch.models.convert import params_from_numpy

BASE = dict(
    model="pst-tiny-debug", tokenizer="byte", dtype="float32",
    cache_dtype="float32", block_size=8, num_kv_blocks=192, max_num_seqs=3,
    max_prefill_chunk=8, seed=0,
)
SHORT = [1, 2, 3, 4, 5]
MED = [50, 60, 70, 80, 90, 91, 92]
LONG = list(range(1, 30))  # 4 chunks at max_prefill_chunk=8


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_outputs(np_params):
    """{request_id: final output} of the JAX engine (split, single step,
    no prefix caching) for staggered arrivals and per-request
    SamplingParams kwargs."""
    eng = JEngine(JConfig(
        **BASE, attention_impl="xla", ragged_dispatch=False,
        prefill_pipeline=False, num_scheduler_steps=1,
        enable_prefix_caching=False,
    ), params=jax.tree_util.tree_map(jnp.asarray, np_params))

    def run(arrivals, kws):
        outs = eng.generate([p for _, _, p in arrivals],
                            [JSampling(**kws[rid]) for _, rid, _ in arrivals])
        return {rid: o for (_, rid, _), o in zip(arrivals, outs)}
    return run


def _engine(np_params, **over):
    cfg = {**BASE, "num_scheduler_steps": 4, **over}
    return LLMEngine(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _run_staggered(engine, arrivals, kws):
    """Requests arrive at the given step indices: the shape that makes
    MIXED rounds (a cold prompt's chunks beside decoding lanes). Returns
    {request_id: final output}."""
    outs: dict = {}
    pending = sorted(arrivals, key=lambda a: a[0])
    steps = 0
    while pending or engine.has_unfinished():
        while pending and pending[0][0] <= steps:
            _, rid, prompt = pending.pop(0)
            engine.add_request(rid, prompt_token_ids=prompt,
                               sampling_params=SamplingParams(**kws[rid]))
        for o in engine.step():
            if o.finished:
                outs[o.request_id] = o
        steps += 1
        assert steps < 3000, "engine wedged"
    return outs


# -- metadata of the mixed round ----------------------------------------------
@pytest.fixture(scope="module")
def kernel_mode_runners(np_params):
    """A JAX runner in kernel mode and a port runner, each recording the
    (tables, blk_seg, seg_meta) its ragged attention calls are handed.
    The JAX runner's attention returns zeros: only its metadata is read."""
    cfg = {**BASE, "num_kv_blocks": 64, "max_prefill_chunk": 16}
    jr = JRunner(JConfig(**cfg, attention_impl="pallas"),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    assert jr.ragged_kernel
    tr = ModelRunner(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    seen = {"jax": [], "port": []}

    def jax_spy(kind, q, layer, kc, vc, *meta):
        assert kind == "ragged"
        jax.debug.callback(
            lambda *a: seen["jax"].append(tuple(np.asarray(x) for x in a)),
            *meta)
        return jnp.zeros_like(q)

    port_attn = tr._attn

    def port_spy(kind, q, layer, kc, vc, *meta):
        assert kind == "ragged"
        seen["port"].append(tuple(m.numpy().copy() for m in meta))
        return port_attn(kind, q, layer, kc, vc, *meta)

    jr._attn, tr._attn = jax_spy, port_spy
    return jr, tr, seen


def _by_content(metas):
    return sorted(metas, key=lambda m: b"".join(a.tobytes() for a in m))


@pytest.mark.parametrize("n_pf,chunk,n_dec", [
    (1, 5, 3),   # one prefill lane, b = max_num_seqs
    (3, 11, 2),  # three lanes, chunks not multiples of RAGGED_TQ
    (2, 16, 1),  # full chunks, one decode lane
    (1, 8, 3),
    (3, 3, 3),
])
def test_mixed_round_metadata_matches_jax(kernel_mode_runners, n_pf, chunk,
                                          n_dec):
    """ragged_dispatch on both runners with one lane mix: the step-0
    forward's (tables, blk_seg, seg_meta) and the decode loop's equal
    the JAX package's element for element (blocks past the prefill
    lanes carry zero-row segments; decode lanes share the tail blocks)."""
    jr, tr, seen = kernel_mode_runners
    b, k = 3, 3
    pf_tabs = [[10 + 4 * i + j for j in range(4)] for i in range(n_pf)]
    starts = [3 * i for i in range(n_pf)]
    dec_tabs = [[40 + 3 * i + j for j in range(3)] for i in range(n_dec)]
    ctx = [5 + 7 * i for i in range(n_dec)]
    args = ([[7] * chunk] * n_pf, starts, pf_tabs,
            [s + chunk for s in starts], [1] * n_dec,
            [c - 1 for c in ctx], dec_tabs, ctx, k,
            np.zeros(n_dec, np.float32), np.ones(n_dec, np.float32),
            np.full(n_dec, -1, np.int32), np.zeros((n_dec, 2), np.uint32))
    seen["jax"].clear()
    seen["port"].clear()
    jax.block_until_ready(jr.ragged_dispatch(*args))
    tr.ragged_dispatch(*args)
    layers = tr.model_config.num_layers
    for who in ("jax", "port"):
        assert len(seen[who]) == layers * k, who
    mixed = {w: [m for m in seen[w] if m[0].shape[0] > b] for w in seen}
    loop = {w: [m for m in seen[w] if m[0].shape[0] == b] for w in seen}
    assert len(mixed["port"]) == layers and len(loop["port"]) == layers * (
        k - 1)
    for want, got in ((mixed["jax"], mixed["port"]),
                      (_by_content(loop["jax"]), _by_content(loop["port"]))):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            for a, c in zip(w, g):
                assert a.shape == c.shape and a.dtype == c.dtype
                np.testing.assert_array_equal(c, a)


def test_mixed_round_runs_one_ragged_launch_per_layer(np_params):
    """A served mixed round: one ragged attention call a layer for the
    step-0 forward and one a layer per further decode iteration, and no
    prefill or decode kernel, whatever the lane mix."""
    for n_pf in (1, 3):
        tr = ModelRunner(EngineConfig(**BASE, device="cpu"),
                         params=params_from_numpy(np_params, "cpu"))
        calls = []
        attn = tr._attn

        def spy(kind, *a, _attn=attn):
            calls.append(kind)
            return _attn(kind, *a)

        tr._attn = spy
        tr.ragged_dispatch(
            [[5] * 6] * n_pf, [0] * n_pf,
            [[20 + 2 * i, 21 + 2 * i] for i in range(n_pf)], [6] * n_pf,
            [1, 2], [4, 9], [[1, 2], [3, 4]], [5, 10], 4,
            np.zeros(2, np.float32), np.ones(2, np.float32),
            np.full(2, -1, np.int32), np.zeros((2, 2), np.uint32))
        assert calls == ["ragged"] * (tr.model_config.num_layers * 4)
        assert tr.dispatch_counts["ragged"] == 1


# -- engine scenarios ------------------------------------------------------------
def _greedy(n, **kw):
    return dict(max_tokens=n, temperature=0.0, **kw)


SCENARIOS = {
    # test_ragged_dispatch: a 4-chunk cold prompt beside a decoding lane
    "cold_multichunk_prefill_beside_decode": (
        [(0, "a", SHORT), (2, "b", LONG)],
        {"a": _greedy(16, ignore_eos=True), "b": _greedy(16,
                                                         ignore_eos=True)}),
    # two cold prompts pack into the prefill side of one round
    "burst_admission": (
        [(0, "a", SHORT), (2, "b", LONG), (2, "c", MED)],
        {r: _greedy(12, ignore_eos=True) for r in "abc"}),
    # EOS freezes decode lanes inside mixed rounds
    "eos_mid_round": (
        [(0, "a", SHORT), (1, "b", LONG), (1, "c", MED)],
        {r: _greedy(12) for r in "abc"}),
    # per-request stop ids and min_tokens gates (stop id set below)
    "stop_ids_min_tokens": (
        [(0, "a", SHORT), (2, "b", LONG), (2, "c", MED)],
        {"a": _greedy(12, ignore_eos=True), "b": _greedy(12, min_tokens=6),
         "c": _greedy(9, ignore_eos=True)}),
    # budgets that are not multiples of K expire on different iterations
    "max_tokens_not_multiple_of_k": (
        [(0, "a", SHORT), (1, "b", LONG), (2, "c", MED)],
        {"a": _greedy(5, ignore_eos=True), "b": _greedy(11, ignore_eos=True),
         "c": _greedy(7, ignore_eos=True)}),
    # penalty counts ride the mixed round's loop on the device
    "penalties": (
        [(0, "a", SHORT), (2, "b", LONG), (2, "c", MED)],
        {"a": _greedy(9, repetition_penalty=1.3, ignore_eos=True),
         "b": _greedy(9, presence_penalty=0.5, frequency_penalty=0.2,
                      ignore_eos=True),
         "c": _greedy(7, ignore_eos=True)}),
    # logprob arrays share the mixed round's fetch
    "logprobs": (
        [(0, "a", SHORT), (2, "b", LONG)],
        {r: _greedy(7, logprobs=3) for r in "ab"}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mixed_round_streams_match_jax(np_params, jax_outputs, name):
    arrivals, kws = SCENARIOS[name]
    kws = {r: dict(kw) for r, kw in kws.items()}
    if name == "stop_ids_min_tokens":
        free = jax_outputs([(0, "a", SHORT)], {"a": kws["a"]})["a"]
        kws["a"]["stop_token_ids"] = [free.token_ids[5]]
    want = jax_outputs(arrivals, kws)
    eng = _engine(np_params)
    got = _run_staggered(eng, arrivals, kws)
    assert {r: o.token_ids for r, o in got.items()} == {
        r: o.token_ids for r, o in want.items()}
    st = eng.stats()
    assert st.ragged_rounds_total > 0 and st.ragged_split_rounds_total == 0
    assert eng.runner.dispatch_counts["ragged"] == st.ragged_rounds_total
    assert max(st.decode_k_hist) > 1  # K > 1 rounds ran
    assert st.decode_overshoot_tokens_total == 0
    if name == "burst_admission":
        # a round carried both cold prompts' chunks
        assert st.ragged_prefill_lanes_total > st.ragged_rounds_total
    if name == "stop_ids_min_tokens":
        a = got["a"].token_ids
        assert a[-1] == kws["a"]["stop_token_ids"][0] and len(a) < 12
        assert len(got["b"].token_ids) >= 6
    if name == "max_tokens_not_multiple_of_k":
        assert [len(got[r].token_ids) for r in "abc"] == [5, 11, 7]
    if name == "logprobs":
        for r in got:
            lp_got, lp_want = got[r].logprobs, want[r].logprobs
            assert len(lp_got) == len(lp_want) == 7
            for x, y in zip(lp_got, lp_want):
                assert x["token_id"] == y["token_id"]
                assert abs(x["logprob"] - y["logprob"]) < 1e-4


def test_host_sampled_final_runs_the_plan_split(np_params, jax_outputs):
    """A final prefill chunk whose first token needs host sampling (logit
    bias) cannot ride the fused round: the same plan runs split, counted,
    and the streams still equal the JAX engine's."""
    arrivals = [(0, "a", SHORT), (2, "b", MED)]
    kws = {"a": _greedy(10, ignore_eos=True),
           "b": _greedy(6, ignore_eos=True, logit_bias={9: 3.0})}
    want = jax_outputs(arrivals, kws)
    eng = _engine(np_params)
    got = _run_staggered(eng, arrivals, kws)
    assert {r: o.token_ids for r, o in got.items()} == {
        r: o.token_ids for r, o in want.items()}
    assert eng.stats().ragged_split_rounds_total > 0


def test_preemption_in_mixed_rounds_matches_jax(np_params, jax_outputs):
    """A pool too small for three lanes preempts during mixed rounds; the
    recomputed lane with a penalty takes its first token on the host, so
    that round runs split. Streams still equal the JAX engine's. The
    engine runs without the prefill pipeline and the decode prefetch, as
    the reference engine does: with them, the JAX engine and the port
    both compose this mix without a split round
    (test_torch_prefill_pipeline.py holds their round kinds equal)."""
    rng = np.random.RandomState(3)
    arrivals = [(t, rid, rng.randint(0, 384, size=n).tolist())
                for t, rid, n in ((0, "a", 24), (2, "b", 30), (3, "c", 20))]
    kws = {"a": _greedy(24, ignore_eos=True),
           "b": _greedy(24, ignore_eos=True, repetition_penalty=1.2),
           "c": _greedy(20, ignore_eos=True)}
    want = jax_outputs(arrivals, kws)
    eng = _engine(np_params, num_kv_blocks=11, enable_prefix_caching=False,
                  prefill_pipeline=False, prefetch_decode=False)
    got = _run_staggered(eng, arrivals, kws)
    assert {r: o.token_ids for r, o in got.items()} == {
        r: o.token_ids for r, o in want.items()}
    st = eng.stats()
    assert st.num_preemptions_total > 0 and st.ragged_rounds_total > 0
    assert st.ragged_split_rounds_total > 0


def test_sampled_mixed_rounds_equal_single_step(np_params):
    """Seeded sampled streams through mixed rounds at K=4 equal the
    port's K=1 streams (iteration i samples with key (seed, step + i))."""
    arrivals = [(0, "a", SHORT), (2, "b", LONG), (3, "c", MED)]
    kws = {"a": dict(max_tokens=9, temperature=0.8, top_p=0.9, seed=7,
                     ignore_eos=True),
           "b": dict(max_tokens=9, temperature=0.7, seed=3,
                     repetition_penalty=1.3, ignore_eos=True),
           "c": dict(max_tokens=9, temperature=0.9, top_k=30, min_p=0.05,
                     seed=11, ignore_eos=True)}
    e4 = _engine(np_params)
    got = _run_staggered(e4, arrivals, kws)
    want = _run_staggered(_engine(np_params, num_scheduler_steps=1),
                          arrivals, kws)
    assert {r: o.token_ids for r, o in got.items()} == {
        r: o.token_ids for r, o in want.items()}
    assert e4.stats().ragged_rounds_total > 0


def test_mixed_round_exits_early(np_params):
    """A mixed round whose decode lanes all finish before K stops its
    loop: fewer forwards than K, counted as an early exit."""
    eng = _engine(np_params, num_scheduler_steps=8)
    arrivals = [(0, "a", SHORT), (2, "b", LONG)]
    # a: one token from its prefill, 8 from a full round, then 3 left
    # when b's chunks arrive: a K=4 mixed round that runs 3 iterations
    kws = {"a": _greedy(12, ignore_eos=True),
           "b": _greedy(3, ignore_eos=True)}
    _run_staggered(eng, arrivals, kws)
    st = eng.stats()
    runs = eng.runner.dispatch_counts
    assert st.ragged_rounds_total > 0
    assert st.decode_early_exit_rounds_total > 0
    assert runs["decode_iterations"] < 8 * (runs["ragged"]
                                            + runs["decode_multi"])


def test_rows_prefill_step_matches_packed_prefill(np_params):
    """The ragged-rows prefill step (the prefill half of the mixed round:
    RAGGED_TQ-aligned lanes on one row axis) gives the packed prefill's
    logits and first tokens for the same chunks."""
    chunks = [[3, 1, 4, 1, 5], list(range(40, 52)), [9, 2, 6]]
    starts, tables = [0, 0, 0], [[1, 2], [3, 4], [5, 6]]
    totals = [len(c) for c in chunks]
    runners = [ModelRunner(EngineConfig(**{**BASE, "max_prefill_chunk": 16},
                                        device="cpu"),
                           params=params_from_numpy(np_params, "cpu"))
               for _ in range(2)]
    want_tok, want_logits = runners[0].prefill_batch(
        chunks, starts, tables, totals)
    r = runners[1]
    r_pad, pc_pad, packed = r._fill_rows_prefill_pack(
        chunks, starts, tables, totals)
    assert r_pad == 32  # 8 + 16 + 8 aligned rows
    got_tok, got_logits = r._make_prefill_rows_step(r_pad, pc_pad)(
        r._upload(packed))
    np.testing.assert_array_equal(got_tok[:3].numpy(), want_tok[:3].numpy())
    np.testing.assert_allclose(got_logits[:3].numpy(),
                               want_logits[:3].numpy(), rtol=1e-5,
                               atol=1e-5)
    # past the trash block 0, which padded rows of either layout write
    bs = BASE["block_size"]
    for a, b in ((runners[0].k_cache, r.k_cache),
                 (runners[0].v_cache, r.v_cache)):
        np.testing.assert_allclose(b[:, :, bs:].numpy(), a[:, :, bs:].numpy(),
                                   rtol=1e-5, atol=1e-6)
