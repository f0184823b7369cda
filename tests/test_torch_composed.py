"""The composed ragged round and the gather attention path of the port
against the JAX package's, both on the CPU in float32.

- attention_impl: "auto" resolves from the head_dim alone, and on the
  card only (a monkeypatched one here): head_dims the kernels are not
  built for take the gather path ("xla") with a warning naming the
  head_dim, 64, 128 and 256 the kernels ("pallas"); "pallas" with such a
  head_dim refuses at boot, and so does a block size the kernels refuse
  under auto; "xla" skips every kernel shape check.
- The gather path: each dispatch (prefill, packed prefill, decode,
  decode_multi, verify_batch, the ragged round) of a port runner with
  attention_impl="xla" on one cache state against the JAX runner's xla
  dispatch: greedy tokens equal, logits and the written KV within 1e-5
  relative.
- The composed ragged round (--no-ragged-kernel on the default ragged
  dispatch): one prefill call a padded prefill lane a layer, then one
  decode call a layer an iteration, and no ragged call.
- Engine scenarios that make mixed rounds happen (staggered arrivals;
  penalties, EOS, a guided lane, adapter and base lanes, logprobs and
  prompt logprobs), run in one sequence on a JAX engine with
  attention_impl="xla" (its composed round) and on two port engines,
  composed (plain kernel versions) and xla: greedy streams equal,
  prompt logprobs and the KV cache after each scenario within 1e-5
  relative, and the port's rounds staged, chained, lane-typed and
  guided on the device tables.
- embed is the same under both impls.
"""

import dataclasses
import logging

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
from production_stack_tpu_torch.engine import model_runner
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops import paged_attention

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
BASE = dict(
    model="pst-tiny-debug", tokenizer="byte", dtype="float32",
    cache_dtype="float32", block_size=8, num_kv_blocks=192, max_num_seqs=3,
    max_prefill_chunk=8, seed=0, num_scheduler_steps=4,
)
# the engine scenarios serve one LoRA adapter too
LORA = dict(enable_lora=True, max_loras=2, max_lora_rank=2)
SHORT = [1, 2, 3, 4, 5]
MED = [50, 60, 70, 80, 90, 91, 92]
LONG = list(range(1, 30))  # 4 chunks at max_prefill_chunk=8
PORTS = {"composed": dict(ragged_kernel=False),
         "xla": dict(attention_impl="xla")}


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _close(mine, ref, what=""):
    ref = np.asarray(ref, np.float32)
    mine = np.asarray(mine, np.float32)
    assert mine.shape == ref.shape, what
    assert np.abs(mine - ref).max() <= REL * max(np.abs(ref).max(), 1e-30), \
        what


def _kv_close(tr_kc, tr_vc, j_kc, j_vc, bs):
    # block 0 is the null block every padding row writes (which padding
    # row lands there last is unspecified in both packages)
    for mine, ref in ((tr_kc, j_kc), (tr_vc, j_vc)):
        _close(mine.numpy()[:, :, bs:], np.asarray(ref)[:, :, bs:], "kv")


# -- attention_impl resolution ---------------------------------------------------
class _Booted(Exception):
    """Raised in place of the weights' random init: the boot checks
    passed."""

    @staticmethod
    def stop(*args, **kwargs):
        raise _Booted


@pytest.fixture
def card_log(monkeypatch):
    """A monkeypatched card (boot stops at the weights' init) and the
    runner's log records."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "Generator", _Booted.stop)
    records: list[logging.LogRecord] = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger(model_runner.__name__)
    log.addHandler(handler)
    yield records
    log.removeHandler(handler)


def _boot(monkeypatch, head_dim, **over):
    wide = dataclasses.replace(get_model_config("llama-3.2-3b"),
                               head_dim=head_dim)
    monkeypatch.setattr(EngineConfig, "model_config", lambda self: wide)
    cfg = {**BASE, "block_size": 32, "device": "cuda", **over}
    ModelRunner(EngineConfig(**cfg))


@pytest.mark.parametrize("head_dim,want", [
    (16, "xla"), (64, "pallas"), (96, "xla"), (128, "pallas"),
    (256, "pallas"),
])
def test_auto_resolves_from_head_dim_on_the_card(head_dim, want,
                                                 card_log):
    assert model_runner.resolve_attention_impl(
        "auto", head_dim, "cuda") == want
    warned = [r.getMessage() for r in card_log
              if r.levelno == logging.WARNING]
    if want == "xla":
        assert warned == [f"attention impl: xla (head_dim {head_dim} "
                          "not in (64, 128, 256))"]
    else:
        assert warned == []
    # the CPU runs the plain versions whatever the head_dim; an explicit
    # impl is kept as asked
    assert model_runner.resolve_attention_impl(
        "auto", head_dim, "cpu") == "pallas"
    for impl in ("xla", "pallas"):
        assert model_runner.resolve_attention_impl(
            impl, head_dim, "cuda") == impl


@pytest.mark.parametrize("head_dim", [96, 256])
def test_card_boot_under_auto_and_pallas(monkeypatch, card_log, head_dim):
    """auto boots a head_dim the kernels lack (96) on the gather path
    (with the warning), and pallas refuses it at boot with the kernels'
    message; a head_dim they take (256, Gemma's) boots on the kernels
    under both, with no warning; xla skips the kernel shape checks (a
    block size they refuse too)."""
    built = head_dim in paged_attention.KERNEL_HEAD_DIMS
    with pytest.raises(_Booted):
        _boot(monkeypatch, head_dim)
    warned = any(f"head_dim {head_dim} not in" in r.getMessage()
                 for r in card_log)
    assert warned != built
    if built:
        with pytest.raises(_Booted):
            _boot(monkeypatch, head_dim, attention_impl="pallas")
    else:
        with pytest.raises(ValueError, match=("cannot run on the card.*"
                                              f"head_dim.*{head_dim}")):
            _boot(monkeypatch, head_dim, attention_impl="pallas")
    with pytest.raises(_Booted):
        _boot(monkeypatch, head_dim, attention_impl="xla", block_size=4)


def test_card_boot_keeps_kernel_checks_of_the_kernel_impl(monkeypatch,
                                                          card_log):
    """Only the head_dim picks xla: a block size the kernels refuse still
    refuses under auto; the composed round (the default ragged dispatch
    without the ragged kernel) runs the decode kernel, so its head limit
    is checked at boot."""
    with pytest.raises(ValueError, match="cannot run on the card.*block"):
        _boot(monkeypatch, 128, block_size=4)
    wide = dataclasses.replace(get_model_config("llama-3.2-3b"),
                               num_heads=24 * 3, num_kv_heads=2)
    monkeypatch.setattr(EngineConfig, "model_config", lambda self: wide)
    cfg = {**BASE, "block_size": 32, "device": "cuda"}
    with pytest.raises(ValueError, match="query heads per kv head, got 36"):
        ModelRunner(EngineConfig(**cfg, ragged_kernel=False))
    with pytest.raises(_Booted):
        ModelRunner(EngineConfig(**cfg))
    with pytest.raises(ValueError, match="attention_impl"):
        EngineConfig(**{**BASE, "attention_impl": "triton"}, device="cpu")


# -- the gather path, dispatch by dispatch ------------------------------------------
PROMPTS = [list(range(1, 12)), [50, 60, 70, 80, 90],
           [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19]]
TABLES = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]


def _greedy_args(n):
    return (np.zeros(n, np.float32), np.ones(n, np.float32),
            np.full(n, -1, np.int32), np.zeros((n, 2), np.uint32))


def _dispatch(kind, runner):
    """One dispatch of `kind` on `runner` (either package) after the
    shared prefills; its outputs as numpy arrays."""
    starts = [len(p) for p in PROMPTS]
    ctx = [s + 1 for s in starts]
    if kind == "prefill":
        tok, logits = runner.prefill([5, 6, 7, 8, 9, 10, 11, 12, 13], 16,
                                     [20, 21, 22, 23], 25)
        return [tok, logits]
    if kind == "prefill_batch":
        return list(runner.prefill_batch(
            [[5, 6, 7], list(range(30, 42))], [0, 8], [[20], [21, 22, 23]],
            [3, 20]))
    if kind == "decode":
        return [runner.decode([3, 9, 27], starts, TABLES, ctx)]
    if kind == "decode_multi":
        return list(runner.decode_multi(
            [3, 9, 27], starts, TABLES, ctx, 4, *_greedy_args(3),
            want_logprobs=True))
    if kind == "verify_batch":
        chunks = [[3, 4, 5, 6, 7], [9, 10, 11], [12]]
        sampling = (np.zeros(3, np.float32), np.ones(3, np.float32),
                    np.full(3, -1, np.int32), np.zeros(3, np.float32),
                    np.arange(3, dtype=np.uint32), np.zeros(3, np.int64))
        rows = np.asarray(runner.verify_batch(
            chunks, starts, TABLES,
            [s + len(c) for s, c in zip(starts, chunks)], sampling))
        # rows past a lane's chunk are padding (sampled, never read)
        return [np.concatenate([r[:len(c)] for r, c in zip(rows, chunks)])]
    assert kind == "ragged"
    pf_sampled, pf_logits, ys = runner.ragged_dispatch(
        [list(range(40, 51)), [7, 7, 7]], [0, 0], [[20, 21], [22]], [11, 3],
        [3, 9], starts[:2], TABLES[:2], ctx[:2], 4, *_greedy_args(2),
        want_logprobs=True)
    # lane 2 of the decode side is padding
    return [pf_sampled[:2], pf_logits[:2], *(y[:, :2] for y in ys)]


@pytest.fixture(scope="module")
def xla_runners(np_params):
    cfg = {**BASE, "num_kv_blocks": 64, "max_prefill_chunk": 16}
    jr = JRunner(JConfig(**cfg, attention_impl="xla"),
                 params=jax.tree_util.tree_map(jnp.asarray, np_params))
    tr = ModelRunner(EngineConfig(**cfg, attention_impl="xla", device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    assert tr.attention_impl == "xla" and not tr.ragged_kernel
    for p, tb in zip(PROMPTS, TABLES):
        tr.prefill(p, 0, tb, len(p))
    return jr, tr, (tr.k_cache.clone(), tr.v_cache.clone())


@pytest.mark.parametrize("kind", ["prefill", "prefill_batch", "decode",
                                  "decode_multi", "verify_batch", "ragged"])
def test_xla_dispatch_matches_jax(xla_runners, kind):
    jr, tr, (kc0, vc0) = xla_runners
    tr.k_cache.copy_(kc0)
    tr.v_cache.copy_(vc0)
    jr.k_cache = jnp.asarray(kc0.numpy())
    jr.v_cache = jnp.asarray(vc0.numpy())
    calls = []
    attn = tr._attn

    def spy(k, *a):
        calls.append(k)
        return attn(k, *a)

    tr._attn = spy
    try:
        got = [np.asarray(x) for x in _dispatch(kind, tr)]
    finally:
        del tr._attn
    want = [np.asarray(x) for x in _dispatch(kind, jr)]
    assert len(got) == len(want) and "ragged" not in calls
    for g, w in zip(got, want):
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w.astype(g.dtype))
        else:
            _close(g, w, kind)
    _kv_close(tr.k_cache, tr.v_cache, jr.k_cache, jr.v_cache,
              BASE["block_size"])


def test_composed_round_calls_prefill_per_lane_and_decode_per_iteration(
        np_params):
    """--no-ragged-kernel on the default ragged dispatch: the prefill
    lanes' packed step calls the prefill kernel once a padded lane a
    layer, the decode loop the decode kernel once a layer an iteration;
    the ragged kernel never runs. Idle prefill lanes sample the idle
    sentinel."""
    tr = ModelRunner(EngineConfig(**BASE, ragged_kernel=False, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    assert tr.attention_impl == "pallas" and not tr.ragged_kernel
    calls = []
    attn = tr._attn

    def spy(kind, *a):
        calls.append(kind)
        return attn(kind, *a)

    tr._attn = spy
    layers = tr.model_config.num_layers
    pf_sampled, _, toks = tr.ragged_dispatch(
        [[5] * 6, [6] * 3, [7] * 8], [0] * 3, [[20], [21], [22]],
        [6, 3, 8], [1, 2], [4, 9], [[1, 2], [3, 4]], [5, 10], 4,
        *_greedy_args(2))
    s_pad = 4
    assert calls.count("prefill") == layers * s_pad
    assert calls.count("decode") == layers * 4
    assert "ragged" not in calls
    assert pf_sampled.shape == (s_pad,) and toks.shape == (4, 3)
    assert int(pf_sampled[3]) == model_runner.RAGGED_IDLE_TOKEN
    assert (pf_sampled[:3] >= 0).all()
    assert tr.dispatch_counts["ragged"] == 1
    assert tr.dispatch_counts["decode_iterations"] == 4


# -- engine scenarios ----------------------------------------------------------------
def _greedy(n, **kw):
    return dict(max_tokens=n, temperature=0.0, **kw)


SCENARIOS = {
    # a 4-chunk cold prompt beside a decoding lane: staged, chained rounds
    "cold_multichunk_prefill_beside_decode": (
        [(0, "a", SHORT), (2, "b", LONG)],
        {"a": _greedy(16, ignore_eos=True),
         "b": _greedy(16, ignore_eos=True)}),
    # two cold prompts pack into the prefill side of one round
    "burst_admission": (
        [(0, "a", MED), (2, "b", LONG), (2, "c", SHORT[::-1])],
        {r: _greedy(12, ignore_eos=True) for r in "abc"}),
    # EOS freezes decode lanes inside mixed rounds
    "eos_mid_round": (
        [(0, "a", SHORT[1:]), (1, "b", LONG[3:]), (1, "c", MED[1:])],
        {r: _greedy(12) for r in "abc"}),
    # penalty counts ride the round's decode loop
    "penalties": (
        [(0, "a", [9, 8, 7]), (2, "b", LONG[::2]), (2, "c", MED[::-1])],
        {"a": _greedy(9, repetition_penalty=1.3, ignore_eos=True),
         "b": _greedy(9, presence_penalty=0.5, frequency_penalty=0.2,
                      ignore_eos=True),
         "c": _greedy(7, ignore_eos=True)}),
    # a guided lane's DFA tables ride the composed round's decode loop
    "guided": (
        [(0, "a", [21, 22, 23]), (2, "b", LONG[5:]),
         (2, "c", [70, 71, 72, 73, 74])],
        {"a": _greedy(28, guided_regex="[ab]{24}x"),
         "b": _greedy(20, ignore_eos=True), "c": _greedy(20, ignore_eos=True)}),
    # adapter and base lanes share the round (per-row slots on the
    # prefill side, per-lane on the decode side)
    "lora": (
        [(0, "a", [31, 32, 33, 34]), (2, "b", LONG[2:]),
         (2, "c", MED[2:])],
        {"a": _greedy(8, ignore_eos=True, lora="x"),
         "b": _greedy(8, ignore_eos=True, lora="x"),
         "c": _greedy(8, ignore_eos=True)}),
    # logprob arrays and prompt logprobs (the single-sequence prefill)
    "logprobs": (
        [(0, "a", [11, 12, 13, 14]), (2, "b", LONG[1::2]),
         (2, "c", [3, 1, 4, 1, 5, 9, 2, 6, 5, 3])],
        {"a": _greedy(7, logprobs=3), "b": _greedy(7, logprobs=3),
         "c": _greedy(5, prompt_logprobs=2, ignore_eos=True)}),
}


def _adapter():
    mc = get_model_config("pst-tiny-debug")
    rng = np.random.RandomState(5)
    dims = {"wq": (mc.hidden_size, mc.q_size),
            "wk": (mc.hidden_size, mc.kv_size),
            "wv": (mc.hidden_size, mc.kv_size),
            "wo": (mc.q_size, mc.hidden_size)}
    w = {"scaling": np.float32(1.0)}
    for t, (din, dout) in dims.items():
        w[f"{t}_A"] = rng.randn(mc.num_layers, din, 2).astype(np.float32) * .2
        w[f"{t}_B"] = rng.randn(mc.num_layers, 2, dout).astype(np.float32) * .2
    return w


@pytest.fixture(scope="module")
def adapter_path(tmp_path_factory):
    from production_stack_tpu_torch.engine.lora import save_adapter_npz

    path = str(tmp_path_factory.mktemp("composed-lora") / "x.npz")
    save_adapter_npz(path, _adapter())
    return path


def _run_all(engine, sampling_cls, adapter):
    """Every scenario in order on one engine (adapter "x" loaded),
    requests arriving at their step indices; returns {scenario: ({rid:
    output}, (k_cache, v_cache) numpy after it)}."""
    engine.load_lora("x", adapter)
    out = {}
    for name, (arrivals, kws) in SCENARIOS.items():
        outs: dict = {}
        pending = sorted(arrivals, key=lambda a: a[0])
        steps = 0
        while pending or engine.has_unfinished():
            while pending and pending[0][0] <= steps:
                _, rid, prompt = pending.pop(0)
                kw = dict(kws[rid])
                lora = kw.pop("lora", None)
                engine.add_request(f"{name}-{rid}", prompt_token_ids=prompt,
                                   lora_name=lora,
                                   sampling_params=sampling_cls(**kw))
            for o in engine.step():
                if o.finished:
                    outs[o.request_id.split("-", 1)[1]] = o
            steps += 1
            assert steps < 3000, "engine wedged"
        kc, vc = engine.runner.k_cache, engine.runner.v_cache
        out[name] = (outs, (np.array(kc), np.array(vc)))
    return out


@pytest.fixture(scope="module")
def jax_run(np_params, adapter_path):
    eng = JEngine(JConfig(**BASE, **LORA, attention_impl="xla"),
                  params=jax.tree_util.tree_map(jnp.asarray, np_params))
    assert not eng.runner.ragged_kernel
    return _run_all(eng, JSampling, adapter_path)


@pytest.fixture(scope="module")
def port_runs(np_params, adapter_path):
    runs = {}
    for kind, over in PORTS.items():
        eng = LLMEngine(EngineConfig(**BASE, **LORA, **over, device="cpu"),
                        params=params_from_numpy(np_params, "cpu"))
        runs[kind] = (eng, _run_all(eng, SamplingParams, adapter_path))
    return runs


@pytest.mark.parametrize("kind", sorted(PORTS))
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax_composed_round(jax_run, port_runs, kind,
                                             name):
    want, (jkc, jvc) = jax_run[name]
    eng, runs = port_runs[kind]
    got, (kc, vc) = runs[name]
    assert {r: o.token_ids for r, o in got.items()} == {
        r: o.token_ids for r, o in want.items()}
    for r, o in got.items():
        if o.logprobs:
            for x, y in zip(o.logprobs, want[r].logprobs, strict=True):
                assert x["token_id"] == y["token_id"]
                assert abs(x["logprob"] - y["logprob"]) < 1e-4
        if o.prompt_logprobs:
            plp = want[r].prompt_logprobs
            assert o.prompt_logprobs[0] is None and plp[0] is None
            for x, y in zip(o.prompt_logprobs[1:], plp[1:], strict=True):
                assert x["token_id"] == y["token_id"]
                assert x["logprob"] == pytest.approx(y["logprob"], rel=REL)
                assert ([t["token_id"] for t in x["top_logprobs"]]
                        == [t["token_id"] for t in y["top_logprobs"]])
                np.testing.assert_allclose(
                    [t["logprob"] for t in x["top_logprobs"]],
                    [t["logprob"] for t in y["top_logprobs"]], rtol=REL)
    _kv_close(torch.from_numpy(kc), torch.from_numpy(vc), jkc, jvc,
              BASE["block_size"])


@pytest.mark.parametrize("kind", sorted(PORTS))
def test_port_rounds_are_lane_typed_staged_and_composed(port_runs, kind):
    """The scenarios ran as lane-typed rounds (one ragged dispatch each),
    some consumed a staged buffer with the decode half chained, and the
    runner composed them: the ragged kernel's seam was never taken."""
    eng, _ = port_runs[kind]
    st = eng.stats()
    assert not eng.runner.ragged_kernel
    assert eng.runner.attention_impl == ("xla" if kind == "xla" else "pallas")
    assert st.ragged_rounds_total > 0
    assert eng.runner.dispatch_counts["ragged"] == st.ragged_rounds_total
    assert eng._ragged_staged_hits_total > 0
    assert max(st.decode_k_hist) > 1
    assert eng.runner.guided_rounds > 0


def test_embed_is_the_same_under_both_impls(np_params):
    """embed attends through the gather path under either impl: the
    vectors are equal to the bit."""
    ids = list(range(3, 40))
    vecs = [ModelRunner(EngineConfig(**BASE, attention_impl=impl,
                                     device="cpu"),
                        params=params_from_numpy(np_params, "cpu")).embed(ids)
            for impl in ("xla", "pallas")]
    np.testing.assert_array_equal(vecs[0], vecs[1])
