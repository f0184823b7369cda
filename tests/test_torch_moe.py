"""Mixture-of-experts in the port against the JAX package, on the CPU in
float32: the scenarios of tests/test_moe.py run on both packages.

- ops/moe.py: top-k gating (Mixtral: softmax over the top-k logits
  only), the dense path, the capacity path with and without dropped
  tokens and its valid mask, each within 1e-5 of JAX ops/moe.py on the
  same numpy inputs, and within 1e-4 of a per-token oracle;
- the forward of pst-tiny-moe-debug on the JAX package's params carried
  across with params_from_numpy: logits within 1e-5 relative;
- an engine serving it (unified ragged rounds, K = 4, staggered
  arrivals): greedy streams equal a JAX engine's, with and without a
  LoRA adapter on the attention projections (served as in JAX: the
  experts take none);
- a tiny Mixtral checkpoint (block_sparse_moe.* keys) written by the
  port's writer loads bit for bit like params_from_numpy(JAX
  load_hf_weights), f32 and bf16, and a partial one is refused;
- a capacity factor above 0 refuses to serve at boot, as in JAX;
- expert parallelism at tp=2 (each rank E/tp whole experts): the
  shards byte-equal to the JAX package's addressable_shards, the rank
  set's forward logits and local KV within 1e-5 relative of the JAX
  tp=2 meshed forward, its greedy stream equal to the JAX tp=2 meshed
  engine's (tests/test_moe.py's expert-parallel setup), and a rank's
  Mixtral checkpoint read holding its experts only.
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
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu.models.weights import (
    load_hf_weights as j_load_hf_weights,
)
from production_stack_tpu.ops import attention as jattn
from production_stack_tpu.ops import moe as jmoe
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.lora import save_adapter_npz
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models import config as tcfg
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.models.debug_checkpoint import (
    hf_config_of,
    write_hf_checkpoint,
)
from production_stack_tpu_torch.models.weights import load_hf_weights
from production_stack_tpu_torch.ops import attention as tattn
from production_stack_tpu_torch.ops import moe as tmoe

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
N, D, F, E, K = 12, 16, 32, 4, 2
MC = get_model_config("pst-tiny-moe-debug")
BASE = dict(model="pst-tiny-moe-debug", tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=8, num_kv_blocks=96,
            max_num_seqs=3, max_prefill_chunk=8, seed=0,
            num_scheduler_steps=4, enable_lora=True, max_loras=2,
            max_lora_rank=2)


def _close(mine, ref, rel=REL):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape
    assert np.abs(mine - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def tensors():
    rng = np.random.RandomState(0)
    return (rng.randn(N, D).astype(np.float32) * 0.3,    # x
            rng.randn(D, E).astype(np.float32),          # gate_w
            rng.randn(E, D, F).astype(np.float32) * 0.2,  # w_gate
            rng.randn(E, D, F).astype(np.float32) * 0.2,  # w_up
            rng.randn(E, F, D).astype(np.float32) * 0.2)  # w_down


def _both(tensors):
    return ([torch.from_numpy(a) for a in tensors],
            [jnp.asarray(a) for a in tensors])


def _oracle(x, gate_w, w_gate, w_up, w_down, k):
    """Per-token loop over the top-k experts (Mixtral semantics)."""
    x = np.asarray(x, np.float64)
    logits = x @ np.asarray(gate_w, np.float64)
    out = np.zeros_like(x)
    for t in range(x.shape[0]):
        top = np.argsort(logits[t])[::-1][:k]
        w = np.exp(logits[t][top] - logits[t][top].max())
        w /= w.sum()
        for expert, weight in zip(top, w):
            g = x[t] @ np.asarray(w_gate[expert], np.float64)
            u = x[t] @ np.asarray(w_up[expert], np.float64)
            out[t] += weight * ((g / (1 + np.exp(-g)) * u)
                                @ np.asarray(w_down[expert], np.float64))
    return out


def test_gating_matches_jax(tensors):
    (x, gate_w, *_), (jx, jgate_w, *_) = _both(tensors)
    got = tmoe.top_k_gating(x, gate_w, K).numpy()
    want = np.asarray(jmoe.top_k_gating(jx, jgate_w, K))
    assert ((got > 0).sum(axis=1) == K).all()
    np.testing.assert_array_equal(got > 0, want > 0)
    _close(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_dense_matches_jax_and_oracle(tensors):
    t, j = _both(tensors)
    got = tmoe.moe_block(*t, K).numpy()
    _close(got, jmoe.moe_block(*j, K))
    np.testing.assert_allclose(got, _oracle(*tensors, K), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("drop", [False, True])
def test_capacity_matches_jax(tensors, drop):
    """No drop (the capacity every expert needs): the dense result.
    Capacity 1: each expert keeps its first token only, so later tokens
    lose weight; token 0 ranks first at both its experts and is exact."""
    (x, gate_w, *w), (jx, jgate_w, *jw) = _both(tensors)
    gates = tmoe.top_k_gating(x, gate_w, K)
    jgates = jmoe.top_k_gating(jx, jgate_w, K)
    cap = int(tmoe.capacity_needed(gates))
    assert cap == int(jmoe.capacity_needed(jgates))
    cap = 1 if drop else cap
    got = tmoe.moe_capacity(x, gates, *w, cap).numpy()
    _close(got, jmoe.moe_capacity(jx, jgates, *jw, cap))
    dense = tmoe.moe_dense(x, gates, *w).numpy()
    if drop:
        assert not np.allclose(got, dense)
        np.testing.assert_allclose(got[0], dense[0], rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)
    # moe_block's capacity factor picks the same path
    factor = 1.0 if drop else 0.0
    _close(tmoe.moe_block(x, gate_w, *w, K, factor).numpy(),
           jmoe.moe_block(jx, jgate_w, *jw, K, factor))


def test_capacity_valid_mask_matches_jax(tensors):
    """Padding rows take no expert capacity from real tokens."""
    (x, gate_w, *w), (jx, jgate_w, *jw) = _both(tensors)
    valid = np.array([False] * 4 + [True] * (N - 4))
    gates = tmoe.top_k_gating(x, gate_w, K)
    cap = int(tmoe.capacity_needed(gates * torch.from_numpy(valid)[:, None]))
    got = tmoe.moe_capacity(x, gates, *w, cap,
                            valid=torch.from_numpy(valid)).numpy()
    want = jmoe.moe_capacity(jx, jmoe.top_k_gating(jx, jgate_w, K), *jw, cap,
                             valid=jnp.asarray(valid))
    _close(got, want)
    np.testing.assert_allclose(got[4:], tmoe.moe_dense(x, gates, *w)[4:],
                               rtol=1e-4, atol=1e-4)
    assert np.allclose(got[:4], 0.0)


@pytest.fixture(scope="module")
def np_params():
    params = jllama.init_params(MC, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def test_forward_matches_jax(np_params):
    """pst-tiny-moe-debug's forward over 6 tokens, both packages on the
    JAX params (the MoE leaves carried across leaf by leaf)."""
    tp = params_from_numpy(np_params, "cpu")
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == {
        k: v.shape for k, v in np_params["layers"].items()}
    for k, v in np_params["layers"].items():
        np.testing.assert_array_equal(tp["layers"][k].numpy(), v)
    n = 6
    scale = MC.head_dim**-0.5
    shape = (MC.num_layers, MC.num_kv_heads, n, MC.head_dim)

    def t_attn(q, layer, kc, vc):
        return tattn.context_attention_prefill(
            q, kc[layer].transpose(0, 1), vc[layer].transpose(0, 1),
            torch.arange(n), n, scale)

    def j_attn(q, layer, kc, vc):
        return jattn.context_attention_prefill(
            q, kc[layer].swapaxes(0, 1), vc[layer].swapaxes(0, 1),
            jnp.arange(n), n, scale)

    got, _, _ = tllama.forward(
        MC, tp, torch.arange(1, n + 1), torch.arange(n), torch.zeros(shape),
        torch.zeros(shape), torch.arange(n), t_attn,
        logits_rows=torch.arange(n))
    want, _, _ = jllama.forward(
        MC, jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.arange(1, n + 1), jnp.arange(n), jnp.zeros(shape),
        jnp.zeros(shape), jnp.arange(n), j_attn,
        logits_rows=jnp.arange(n))
    _close(got.numpy(), want)


# -- engines ---------------------------------------------------------------------
def _adapter():
    rng = np.random.RandomState(5)
    L, h = MC.num_layers, MC.hidden_size
    dims = {"wq": (h, MC.q_size), "wk": (h, MC.kv_size),
            "wv": (h, MC.kv_size), "wo": (MC.q_size, h)}
    w = {"scaling": np.float32(1.0)}
    for t, (din, dout) in dims.items():
        w[f"{t}_A"] = rng.randn(L, din, 2).astype(np.float32) * 0.2
        w[f"{t}_B"] = rng.randn(L, 2, dout).astype(np.float32) * 0.2
    return w


ARRIVALS = [(0, "a", [1, 2, 3, 4, 5], None),
            (2, "b", list(range(1, 30)), None),
            (2, "c", [50, 60, 70, 80, 90, 91, 92], "x"),
            (3, "d", [9, 8, 7, 6], "x")]


def _drive(eng, sp_cls):
    """Staggered greedy requests (mixed rounds, one adapter lane set);
    returns {rid: token_ids}."""
    outs, step = {}, 0
    pending = list(ARRIVALS)
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= step:
            _, rid, ids, lora = pending.pop(0)
            eng.add_request(rid, prompt_token_ids=ids, lora_name=lora,
                            sampling_params=sp_cls(
                                max_tokens=10, temperature=0.0,
                                ignore_eos=True))
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.token_ids
        step += 1
        assert step < 2000, "engine wedged"
    return outs


@pytest.fixture(scope="module")
def adapter_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe-lora") / "x.npz")
    save_adapter_npz(path, _adapter())
    return path


@pytest.fixture(scope="module")
def jax_streams(np_params, adapter_path):
    eng = JEngine(JConfig(**BASE, attention_impl="xla"),
                  params=jax.tree_util.tree_map(jnp.asarray, np_params))
    eng.load_lora("x", adapter_path)
    return _drive(eng, JSampling)


@pytest.mark.parametrize("over", [{}, {"ragged_kernel": False}],
                         ids=["ragged_kernel", "composed"])
def test_engine_serves_moe_like_jax(np_params, adapter_path, jax_streams,
                                    over):
    """Greedy streams of every request (base and adapter lanes) equal the
    JAX engine's; the rounds were lane-typed."""
    eng = LLMEngine(EngineConfig(**BASE, **over, device="cpu"),
                    params=params_from_numpy(np_params, "cpu"))
    eng.load_lora("x", adapter_path)
    got = _drive(eng, SamplingParams)
    assert got == jax_streams
    assert all(len(t) == 10 for t in got.values())
    assert eng.stats().ragged_rounds_total > 0


# -- Mixtral checkpoints -----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_checkpoint_loads_bit_for_bit(np_params, tmp_path, dtype):
    """The port's writer puts the router and each expert's w1 / w3 / w2
    under block_sparse_moe.*; the port's loader reads them back equal to
    the written params and to params_from_numpy of the JAX loader."""
    cfg = dataclasses.replace(MC, name="tiny-mixtral", num_layers=1)
    params = params_from_numpy(
        {**np_params, "layers": {k: v[:1] for k, v in
                                 np_params["layers"].items()}}, "cpu")
    paths = write_hf_checkpoint(str(tmp_path), hf_config_of(cfg), params,
                                shard_bytes=2**14)
    assert len(paths) > 1  # sharded, with its index
    from production_stack_tpu_torch.models import safetensors_io

    keys = {k for k, _ in safetensors_io.iter_dir(str(tmp_path))}
    assert "model.layers.0.block_sparse_moe.gate.weight" in keys
    assert "model.layers.0.block_sparse_moe.experts.3.w2.weight" in keys
    assert not any(".mlp." in k for k in keys)
    loaded_cfg = tcfg.get_model_config(str(tmp_path))
    assert (loaded_cfg.num_experts, loaded_cfg.num_experts_per_tok) == (
        MC.num_experts, MC.num_experts_per_tok)
    tdt = getattr(torch, dtype)
    got = load_hf_weights(loaded_cfg, str(tmp_path), tdt, "cpu")
    want = params_from_numpy(jax.tree_util.tree_map(
        np.asarray,
        j_load_hf_weights(loaded_cfg, str(tmp_path), getattr(jnp, dtype))),
        "cpu")
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k in want["layers"]:
        g, w = got["layers"][k], want["layers"][k]
        assert g.dtype == w.dtype == tdt and torch.equal(g, w), k
        assert torch.equal(g, params["layers"][k].to(tdt)), k
    for k in ("embed", "final_norm"):
        assert torch.equal(got[k], want[k]), k


def test_partial_mixtral_checkpoint_refused(tmp_path):
    from production_stack_tpu_torch.models import safetensors_io

    rng = np.random.RandomState(0)
    h, v = MC.hidden_size, MC.vocab_size
    safetensors_io.save_file(
        {"model.embed_tokens.weight": torch.from_numpy(
            rng.randn(v, h).astype(np.float32)),
         "model.norm.weight": torch.ones(h)},
        str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="incomplete"):
        load_hf_weights(MC, str(tmp_path), torch.float32)
    with pytest.raises(ValueError, match="incomplete"):
        j_load_hf_weights(MC, str(tmp_path), jnp.float32)


def test_capacity_factor_refused_at_boot(monkeypatch):
    bad = dataclasses.replace(MC, name="pst-tiny-moe-cap",
                              moe_capacity_factor=1.25)
    monkeypatch.setitem(tcfg._PRESETS, bad.name, bad)
    with pytest.raises(ValueError, match="not servable"):
        ModelRunner(EngineConfig(**{**BASE, "model": bad.name},
                                 device="cpu"))


# -- expert parallelism over the tp axis -----------------------------------------
EP_PROMPT = [1, 2, 3, 4, 5, 6, 7]  # tests/test_moe.py's EP prompt
EP_ENGINE = dict(model="pst-tiny-moe-debug", tokenizer="byte",
                 dtype="float32", cache_dtype="float32", block_size=4,
                 num_kv_blocks=64, max_num_seqs=2, max_prefill_chunk=16,
                 seed=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_expert_shards_byte_equal_jax_addressable_shards(np_params, tp):
    """Each rank holds E/tp whole experts (w_gate / w_up / w_down cut on
    E), the router whole: the slices of the JAX package's
    addressable_shards on a tp mesh, byte for byte."""
    from production_stack_tpu.parallel import sharding as jsharding
    from production_stack_tpu_torch.models.convert import tp_params_from_numpy

    mesh = jsharding.make_mesh(tp)
    jtree = jsharding.shard_params(
        jax.tree_util.tree_map(jnp.asarray, np_params), mesh, MC)
    for r in range(tp):
        mine = tp_params_from_numpy(np_params, MC, r, tp, "cpu")
        assert mine["layers"]["w_gate"].shape[1] == MC.num_experts // tp
        for k, leaf in jtree["layers"].items():
            (want,) = [s.data for s in leaf.addressable_shards
                       if s.device == mesh.devices[r]]
            got = mine["layers"][k]
            assert got.is_contiguous(), k
            assert got.numpy().tobytes() == np.asarray(want).tobytes(), (
                k, r)


def test_ep_forward_logits_equal_jax_meshed(np_params):
    """Two ranks, each gating over all experts and running its own, the
    block's output all-reduced: logits within 1e-5 relative of the JAX
    tp=2 meshed forward, and the local KV of each rank its cache shard."""
    import torch_tp_worker
    from production_stack_tpu.parallel import sharding as jsharding

    steps = [(list(range(5, 17)), list(range(12))),
             ([40, 41, 42, 43], list(range(12, 16)))]
    tmc = tcfg.get_model_config(MC.name)
    ranks = torch_tp_worker.run_ranks(torch_tp_worker.tp_forward, 2,
                                      [(tmc, np_params, steps, 16)])
    mesh = jsharding.make_mesh(2)
    params = jsharding.shard_params(
        jax.tree_util.tree_map(jnp.asarray, np_params), mesh, MC)
    shape = (MC.num_layers, MC.num_kv_heads, 16, MC.head_dim)
    kc = jax.device_put(jnp.zeros(shape), jsharding.cache_sharding(mesh))
    vc = jax.device_put(jnp.zeros(shape), jsharding.cache_sharding(mesh))
    want = []
    for tokens, positions in steps:
        pos = jnp.asarray(positions, jnp.int32)
        total = positions[-1] + 1

        def attn(q, layer, k, v):
            return jattn.context_attention_prefill(
                q, k[layer].swapaxes(0, 1), v[layer].swapaxes(0, 1), pos,
                total, MC.head_dim**-0.5)

        lg, kc, vc = jax.jit(lambda p, t, kc, vc: jllama.forward(
            MC, p, t, pos, kc, vc, pos, attn, jnp.arange(len(tokens))))(
            params, jnp.asarray(tokens, jnp.int32), kc, vc)
        want.append(np.asarray(lg))
    for r, [(logits, k, v)] in enumerate(ranks):
        for got, w in zip(logits, want):
            _close(got, w)
        for got, arr in ((k, kc), (v, vc)):
            (w,) = [s.data for s in arr.addressable_shards
                    if s.device == mesh.devices[r]]
            _close(got, np.asarray(w))


def test_ep_engine_streams_equal_jax_meshed_and_tp1(np_params):
    """tests/test_moe.py's expert-parallel setup at tp=2: the port's
    rank set (each rank holding 2 of the 4 experts a layer) decodes the
    JAX tp=2 meshed engine's greedy stream, which is the tp=1 stream."""
    sp = dict(max_tokens=5, temperature=0.0, ignore_eos=True)
    want = []
    for tp in (1, 2):
        jeng = JEngine(JConfig(**EP_ENGINE, attention_impl="xla",
                               tensor_parallel_size=tp),
                       params=jax.tree_util.tree_map(jnp.asarray,
                                                     np_params))
        want.append(jeng.generate([EP_PROMPT], JSampling(**sp))[0]
                    .token_ids)
    assert want[0] == want[1]
    eng = LLMEngine(EngineConfig(**EP_ENGINE, device="cpu",
                                 tensor_parallel_size=2),
                    params=params_from_numpy(np_params, "cpu"))
    try:
        got = eng.generate([EP_PROMPT], SamplingParams(**sp))[0].token_ids
        assert got == want[1]
        reps = eng.runner.reports()
        assert [r["experts"] for r in reps] == [[0, 2], [2, 4]]
        assert reps[0]["dispatch_counts"] == reps[1]["dispatch_counts"]
        held = eng.runner._runner.params["layers"]
        assert held["w_gate"].shape[1] == held["w_down"].shape[1] == 2
        assert held["moe_gate"].shape[-1] == MC.num_experts
    finally:
        eng.shutdown()


def test_mixtral_checkpoint_rank_reads_its_experts(np_params, tmp_path):
    """load_hf_weights(shard=(r, 2)) of a Mixtral checkpoint holds the
    rank's experts only, equal to the cut of the full load."""
    from production_stack_tpu_torch.parallel import sharding as tsharding

    tmc = tcfg.get_model_config(MC.name)
    write_hf_checkpoint(str(tmp_path), hf_config_of(tmc),
                        params_from_numpy(np_params, "cpu"))
    full = load_hf_weights(tmc, str(tmp_path), torch.float32, "cpu")
    for r in range(2):
        got = load_hf_weights(tmc, str(tmp_path), torch.float32, "cpu",
                              shard=(r, 2))
        want = tsharding.shard_params(full, tmc, r, 2)
        for k, leaf in want["layers"].items():
            assert torch.equal(got["layers"][k], leaf), (k, r)
        assert got["layers"]["w_up"].shape[1] == MC.num_experts // 2
