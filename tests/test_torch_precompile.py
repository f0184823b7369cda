"""The port's compiled-program layer and warm-up sweeps against the JAX
package's, on the CPU in float32.

- precompile_prefill / _decode / _verify / _ragged / _kv_import and
  LLMEngine.precompile_serving run the JAX runner's trash dispatches: on
  the same configs (the cases of tests/test_prefill_packing.py and
  tests/test_ragged_dispatch.py, pool guards included) both packages
  return the same count and make the same dispatches with the same
  arguments in the same order. The JAX runner's dispatch methods are
  stand-ins that record their calls (its sweep logic runs unchanged and
  nothing compiles); the port's run for real, recorded on the way.
- A sweep leaves later generation equal to the JAX engine's.
- Compile events: one a program key (the single-step decode per
  (b, c_pad), the fused loop's iteration per its flags), in stats() and
  in the /metrics text; a workload inside the warmed buckets after
  precompile_serving builds nothing.
- Greedy streams through the program variants equal the JAX engine's at
  the defaults at K=1 and K=4, and the eager control's.

On the CPU a variant has no CUDA graph: it runs the same code on its
static buffers (tests/test_torch_cuda_kernels.py holds the graphs on the
card).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from production_stack_tpu_torch.engine.metrics import EngineMetrics
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

CFG = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=4, num_kv_blocks=128,
           max_num_seqs=4, max_prefill_chunk=16, seed=0)
DISPATCHES = ("prefill", "prefill_batch", "decode", "decode_multi",
              "verify_batch", "ragged_dispatch", "stage_import_blocks",
              "import_staged_blocks")
SIGS = {name: inspect.signature(getattr(ModelRunner, name))
        for name in DISPATCHES}
GREEDY = dict(temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _norm(v):
    """A dispatch argument as comparable data: arrays by shape (a chained
    round's device tokens too), sequences element by element."""
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return ("array", tuple(np.shape(v)))


def _record(name, args, kwargs) -> tuple:
    bound = SIGS[name].bind(None, *args, **kwargs).arguments
    return (name, tuple((k, _norm(v)) for k, v in bound.items()
                        if k not in ("self", "handle")))


def _spy(runner) -> list:
    """Record the port runner's dispatches, then run them."""
    log = []
    for name in DISPATCHES:
        orig = getattr(runner, name)

        def spy(*a, _name=name, _orig=orig, **kw):
            log.append(_record(_name, a, kw))
            return _orig(*a, **kw)

        setattr(runner, name, spy)
    return log


def _stand_ins(runner, b: int) -> list:
    """Replace the JAX runner's dispatches with recorders returning
    outputs of the shapes its sweeps read."""
    log = []

    def ys(bound):
        toks = np.zeros((bound["steps"], b), np.int32)
        return (toks, np.zeros((b,), np.int32)) if bound.get(
            "stop") is not None else toks

    def make(name):
        def stand_in(*a, **kw):
            log.append(_record(name, a, kw))
            bound = SIGS[name].bind(None, *a, **kw).arguments
            if name == "decode_multi":
                return ys(bound)
            if name == "ragged_dispatch":
                return np.zeros((1,)), np.zeros((1,)), ys(bound)
            if name == "stage_import_blocks":
                return bound["data"].shape[2], bound["data"]
            return np.zeros((1,))
        return stand_in

    for name in DISPATCHES:
        setattr(runner, name, make(name))
    return log


def _pair_runners(np_params, **over):
    cfg = {**CFG, **over}
    jr = JRunner(JConfig(**cfg),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    tr = ModelRunner(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    return jr, _stand_ins(jr, cfg["max_num_seqs"]), tr, _spy(tr)


@pytest.mark.parametrize("over,singles,groups,want", [
    # test_precompile_prefill_covers_serving_buckets
    (dict(max_prefill_seqs=8), [(16, 16), (16, 32), (4, 32)],
     [(2, 16, 32), (4, 16, 32)], 5),
    # test_precompile_prefill_pool_guard_skips_oversized
    (dict(num_kv_blocks=40, max_prefill_seqs=8), [(16, 32)],
     [(2, 16, 16)], 0),
    # the guard per entry: the single fits, the group of 4 does not
    (dict(num_kv_blocks=80, max_prefill_seqs=8), [(8, 32)],
     [(4, 16, 32)], 1),
])
def test_precompile_prefill_matches_jax(np_params, over, singles, groups,
                                        want):
    jr, jlog, tr, tlog = _pair_runners(np_params, **over)
    assert jr.precompile_prefill(singles, groups) == want
    assert tr.precompile_prefill(singles, groups) == want
    assert tlog == jlog


@pytest.mark.parametrize("over,ctxs,steps,chained,stop", [
    ({}, [1, 5, 9, 30, 40], 1, False, False),
    ({}, [1, 5, 9, 30, 40], 4, True, True),
    ({}, [2, 17], 2, False, False),
    # 2 * 16 pages + 64 > 90: the 64-token bucket is skipped
    (dict(num_kv_blocks=90, max_model_len=64), [3, 20, 60], 4, True,
     False),
])
def test_precompile_decode_matches_jax(np_params, over, ctxs, steps,
                                       chained, stop):
    jr, jlog, tr, tlog = _pair_runners(np_params, **over)
    n = jr.precompile_decode(ctxs, steps, chained=chained, stop=stop)
    assert tr.precompile_decode(ctxs, steps, chained=chained,
                                stop=stop) == n > 0
    assert tlog == jlog
    kind = "decode" if steps == 1 else "decode_multi"
    assert tr.compile_events == {kind: tr.compile_events_total}
    assert tr.compile_events_total > 0


@pytest.mark.parametrize("over,ctxs", [
    ({}, [8, 16]),
    (dict(num_kv_blocks=90), [8, 32]),  # s=2, 4 at ctx 32 skipped
])
def test_precompile_verify_matches_jax(np_params, over, ctxs):
    jr, jlog, tr, tlog = _pair_runners(np_params, **over)
    n = jr.precompile_verify(ctxs, 3, 4)
    assert tr.precompile_verify(ctxs, 3, 4) == n > 0
    assert tlog == jlog


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("over,chained,stop", [
    (dict(block_size=8, num_kv_blocks=256, max_prefill_chunk=16,
          max_prefill_seqs=4), False, False),
    (dict(block_size=8, num_kv_blocks=256, max_prefill_chunk=16,
          max_prefill_seqs=4), True, True),
    (dict(block_size=8, num_kv_blocks=100, max_prefill_chunk=16,
          max_prefill_seqs=4), True, False),
])
def test_precompile_ragged_matches_jax(np_params, impl, over, chained,
                                       stop):
    """test_single_kernel_variant_space_shrinks' sweep: under the
    ragged kernel group sizes packing to one row bucket run once."""
    jr, jlog, tr, tlog = _pair_runners(np_params, attention_impl=impl,
                                       **over)
    assert jr.ragged_kernel == tr.ragged_kernel == (impl == "pallas")
    args = ([9, 16], [1, 2, 4], 4, 16)
    n = jr.precompile_ragged(*args, stop=stop, chained=chained)
    assert tr.precompile_ragged(*args, stop=stop, chained=chained) == n
    assert n > 0
    assert tlog == jlog


def test_precompile_kv_import_matches_jax(np_params):
    jr, jlog, tr, tlog = _pair_runners(np_params)
    assert jr.precompile_kv_import(5) == tr.precompile_kv_import(5) == 4
    assert tlog == jlog


@pytest.mark.parametrize("over", [
    dict(max_model_len=64, max_prefill_seqs=4),
    dict(max_model_len=64, max_prefill_seqs=4, num_scheduler_steps=4,
         num_speculative_tokens=2),
    dict(max_model_len=48, max_prefill_seqs=2, num_scheduler_steps=4,
         attention_impl="xla", ragged_kernel=False),
    dict(max_model_len=48, max_prefill_seqs=2, num_scheduler_steps=4,
         async_decode=True),
    dict(max_model_len=32, max_prefill_seqs=2, num_scheduler_steps=2,
         cpu_offload_bytes=1 << 20),
], ids=["k1", "k4-spec", "k4-composed", "k4-async", "k2-offload"])
def test_precompile_serving_matches_jax(np_params, over):
    """The engine's grid (ctx and chunk buckets, pow2 groups with the
    rows dedupe, decode_precompile_variants, the ragged lane mixes,
    verify, KV import) makes the JAX engine's dispatches, then the
    covering pass (ModelRunner.precompile_cover) the prefill, packed
    prefill and ragged dispatches of the variants those leave unbuilt.
    Both take the kernels unless the case says xla (the JAX engine's
    auto is xla off its accelerator, the port's is pallas)."""
    cfg = {**CFG, "attention_impl": "pallas", **over}
    jeng = JEngine(JConfig(**cfg),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))
    jlog = _stand_ins(jeng.runner, cfg["max_num_seqs"])
    teng = LLMEngine(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    tlog = _spy(teng.runner)
    n = jeng.precompile_serving()
    got = teng.precompile_serving()
    assert tlog[:len(jlog)] == jlog
    cover = tlog[len(jlog):]
    assert got == n + len(cover) and n > 0
    assert {rec[0] for rec in cover} <= {"prefill", "prefill_batch",
                                         "ragged_dispatch"}
    grid = teng.precompile_grid
    assert grid["singles"] > 0 and grid["ctx_buckets"][0] == 4


@pytest.fixture(scope="module")
def jax_engines(np_params):
    """JAX engines at the defaults (K=1 and K=4), reused by the cases."""
    return {k: JEngine(JConfig(**CFG, num_scheduler_steps=k,
                               attention_impl="xla"),
                       params=jax.tree_util.tree_map(jnp.asarray,
                                                     np_params))
            for k in (1, 4)}


def _port(np_params, k, eager=False, **over):
    return LLMEngine(EngineConfig(**{**CFG, "num_scheduler_steps": k,
                                     **over}, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"),
                     eager=eager)


def _staggered(eng, sp_cls, prompts, max_tokens):
    """Two requests, a third arriving mid-decode (a mixed round)."""
    sp = sp_cls(max_tokens=max_tokens, **GREEDY)
    outs, step = {}, 0
    for i, p in enumerate(prompts[:2]):
        eng.add_request(f"s{i}", prompt_token_ids=p, sampling_params=sp)
    while eng.has_unfinished() or step < 3:
        if step == 2:
            eng.add_request("s2", prompt_token_ids=prompts[2],
                            sampling_params=sp)
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.token_ids
        step += 1
    return [outs[f"s{i}"] for i in range(3)]


PROMPTS = [list(range(1, 12)), [50, 60, 70, 80, 90],
           [7 + (3 * j) % 200 for j in range(27)]]


def test_sweep_leaves_generation_equal_to_jax(np_params, jax_engines):
    """test_precompile_prefill_leaves_cache_semantics_intact, against the
    JAX engine: a full sweep's trash blocks stay out of live tables."""
    teng = _port(np_params, 4)
    assert teng.precompile_serving() > 0
    want = _staggered(jax_engines[4], JSampling, PROMPTS, 12)
    assert _staggered(teng, SamplingParams, PROMPTS, 12) == want


def test_compile_events_counted_once_per_key(np_params):
    """A variant is built (and counted) on its key's first dispatch, in
    stats() and /metrics; the same workload again builds nothing."""
    teng = _port(np_params, 4)
    assert teng.runner.compile_events_total == 0
    _staggered(teng, SamplingParams, PROMPTS, 10)
    ev = dict(teng.runner.compile_events)
    assert ev and set(ev) <= {"decode", "decode_multi", "prefill",
                              "prefill_rows", "ragged_rows"}
    # the mixed round's step 0 and the packed prefill are variants too
    assert {"ragged_rows", "prefill_rows", "decode_multi"} <= set(ev)
    assert len(teng.runner._variants) == teng.runner.compile_events_total
    s = teng.stats()
    assert s.compile_events == ev
    assert s.compile_events_total == sum(ev.values())
    text = EngineMetrics("m").render(s)
    for kind, n in ev.items():
        assert (f'tpu:compile_events_total{{model_name="m",kind="{kind}"}} '
                f"{float(n)!r}") in text
    assert "tpu:compile_events_total_total" not in text
    _staggered(teng, SamplingParams, [p[::-1] for p in PROMPTS], 10)
    assert teng.runner.compile_events == ev


@pytest.mark.parametrize("k", [1, 4])
def test_served_workload_after_precompile_builds_nothing(np_params, k):
    """Inside the warmed buckets (contexts up to max_model_len, greedy
    and seeded sampling, EOS and max_tokens stops) a served workload
    after precompile_serving adds no compile event."""
    teng = _port(np_params, k, max_model_len=64)
    assert teng.precompile_serving() > 0
    before = dict(teng.runner.compile_events)
    assert before
    sp = [SamplingParams(max_tokens=20, **GREEDY),
          SamplingParams(max_tokens=30, temperature=0.8, seed=3),
          SamplingParams(max_tokens=9, temperature=0.0)]
    teng.generate(PROMPTS, sp)
    _staggered(teng, SamplingParams, PROMPTS, 16)
    assert teng.runner.compile_events == before


@pytest.mark.parametrize("k", [1, 4])
def test_variant_streams_match_jax_at_defaults(np_params, jax_engines, k):
    """Greedy streams through the program variants (the fused loop's
    iteration, the single-step decode) equal the JAX engine's and the
    eager control's, on a staggered mix with a mixed round."""
    want = _staggered(jax_engines[k], JSampling, PROMPTS, 14)
    teng = _port(np_params, k)
    got = _staggered(teng, SamplingParams, PROMPTS, 14)
    assert got == want
    kinds = set(teng.runner.compile_events)
    # K=1 decodes single steps; adaptive K sizes some rounds down to 1
    assert ("decode" in kinds and "decode_multi" not in kinds if k == 1
            else "decode_multi" in kinds)
    assert "ragged_rows" in kinds
    assert _staggered(_port(np_params, k, eager=True), SamplingParams,
                      PROMPTS, 14) == want


def test_no_path_moves_what_graphs_capture(np_params, tmp_path):
    """A CUDA graph bakes in the KV caches' and LoRA buffers' addresses:
    serving, an adapter load, reload and unload, a KV export and import
    and a precompile sweep update them in place (the card raises on a
    replay after any move, tests/test_torch_cuda_kernels.py)."""
    from production_stack_tpu_torch.engine.lora import (
        TARGETS,
        _target_dims,
        save_adapter_npz,
    )

    teng = _port(np_params, 4, enable_lora=True, max_loras=2,
                 max_lora_rank=4)
    r = teng.runner
    addresses = r._static_addresses()
    assert len(addresses) == 2 + len(r.lora_manager.buffers)
    mc = r.model_config
    rng = np.random.RandomState(5)
    weights = {"scaling": 0.5}
    for t, (din, dout) in _target_dims(mc).items():
        if t in TARGETS:
            weights[f"{t}_A"] = rng.randn(mc.num_layers, din, 4) * 0.1
            weights[f"{t}_B"] = rng.randn(mc.num_layers, 4, dout) * 0.1
    path = str(tmp_path / "a.npz")
    save_adapter_npz(path, weights)
    teng.load_lora("a", path)
    sp = SamplingParams(max_tokens=9, **GREEDY)
    teng.add_request("x", prompt_token_ids=PROMPTS[0], sampling_params=sp,
                     lora_name="a")
    teng.add_request("y", prompt_token_ids=PROMPTS[1], sampling_params=sp)
    while teng.has_unfinished():
        teng.step()
    teng.load_lora("a", str(tmp_path / "a.npz"))
    teng.unload_lora("a")
    blocks = r.export_blocks([1, 2])
    r.import_blocks([3, 4], blocks)
    teng.precompile_serving()
    assert r._static_addresses() == addresses
