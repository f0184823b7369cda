"""Multi-LoRA in the port against the JAX package (tests/test_lora.py's
scenarios), on the CPU in float32, with the same adapter files.

- LoraManager: slots, idempotent and replacing reloads, rank and shape
  refusals; PEFT safetensors (written by engine/lora.py's
  write_peft_adapter) read equal to the JAX reader's.
- forward with adapters (one slot for all rows, a slot per row, the
  base slot) within 1e-5 relative of the JAX forward's.
- Engines on the same weights and adapters: greedy streams equal the
  JAX engine's at the defaults (unified ragged rounds, K > 1, staging)
  and under --no-ragged-dispatch, with adapter and base requests
  sharing rounds; an adapter reloaded into another slot and one
  unloaded mid-request (that request degrades to the base model) give
  the JAX engine's streams too; serving-time adapters equal merged
  weights; base lanes equal an engine without LoRA; a reloaded
  adapter misses the KV of its earlier load, with prefix hits and
  queries equal to the JAX engine's.
- A staged buffer built for one slot assignment is rebuilt, not used,
  when the dispatch's slots differ (runner), and counted a miss by the
  engine (fingerprint).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.lora import LoraManager as JLoraManager
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu.ops.attention import (
    context_attention_prefill as j_prefill_attn,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.lora import (
    LoraManager,
    save_adapter_npz,
    write_peft_adapter,
)
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.config import (
    get_model_config as t_get_config,
)
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops.attention import (
    context_attention_prefill as t_prefill_attn,
)

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
MC = get_model_config("pst-tiny-debug")
# tests/test_lora.py's engine, float32
BASE = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=4, num_kv_blocks=128,
            max_num_seqs=4, max_prefill_chunk=16, seed=0, enable_lora=True,
            max_loras=3, max_lora_rank=4)
PROMPT = "the quick brown fox jumps over the lazy dog"


def make_adapter(rank=2, seed=0, scaling=0.5,
                 targets=("wq", "wk", "wv", "wo")):
    """tests/test_lora.py's adapter: (L, in, r) / (L, r, out) arrays."""
    rng = np.random.RandomState(seed)
    L, h = MC.num_layers, MC.hidden_size
    dims = {"wq": (h, MC.q_size), "wk": (h, MC.kv_size),
            "wv": (h, MC.kv_size), "wo": (MC.q_size, h)}
    w = {"scaling": np.float32(scaling)}
    for t in targets:
        din, dout = dims[t]
        w[f"{t}_A"] = rng.randn(L, din, rank).astype(np.float32) * 0.2
        w[f"{t}_B"] = rng.randn(L, rank, dout).astype(np.float32) * 0.2
    return w


@pytest.fixture(scope="module")
def np_params():
    params = jllama.init_params(MC, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """a1 (.npz, rank 2), a2 (.npz, rank 4, wq/wo only), v2 (another
    .npz for a1's name) and peft (PEFT safetensors, rank 3)."""
    d = tmp_path_factory.mktemp("adapters")
    paths = {}
    for name, kw in (("a1", dict(rank=2, seed=11, scaling=1.0)),
                     ("a2", dict(rank=4, seed=22, scaling=0.5,
                                 targets=("wq", "wo"))),
                     ("v2", dict(rank=2, seed=33, scaling=1.0))):
        paths[name] = str(d / f"{name}.npz")
        save_adapter_npz(paths[name], make_adapter(**kw))
    paths["peft"] = write_peft_adapter(
        str(d / "peft"), make_adapter(rank=3, seed=44), lora_alpha=6.0)
    return paths


def _port(np_params, **over):
    return LLMEngine(EngineConfig(**{**BASE, **over}, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _jax(np_params, **over):
    return JEngine(JConfig(**{**BASE, **over}, attention_impl="xla"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))


def _drive(eng, arrivals, sp_cls, between=None, n=10):
    """Greedy requests (rid, prompt ids, adapter) arriving at step
    indices; `between(eng, step)` runs before each step. Returns
    {rid: token_ids}."""
    outs, step = {}, 0
    pending = sorted(arrivals, key=lambda a: a[0])
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= step:
            _, rid, ids, lora = pending.pop(0)
            eng.add_request(rid, prompt_token_ids=ids, lora_name=lora,
                            sampling_params=sp_cls(
                                max_tokens=n, temperature=0.0,
                                ignore_eos=True))
        if between is not None:
            between(eng, step)
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.token_ids
        step += 1
    return outs


def _ids(seed, n):
    return np.random.RandomState(seed).randint(1, 384, size=n).tolist()


# -- manager and adapter files ------------------------------------------------
def test_manager_slots_and_refusals(adapters, tmp_path):
    m = LoraManager(MC, max_loras=2, max_rank=2, dtype=torch.float32)
    assert m.load("a1", adapters["a1"]) == 1 and m.slot_of("a1") == 1
    assert m.slot_of(None) == 0
    assert m.load("a1", adapters["a1"]) == 1  # idempotent
    gen = m.hash_seed_of("a1")
    assert m.load("a1", adapters["v2"]) == 1  # new path: replaced
    assert m.hash_seed_of("a1") != gen and m.hash_seed_of(None) == 0
    want = make_adapter(rank=2, seed=33)["wq_A"]
    np.testing.assert_array_equal(m.buffers["wq_A"][:, 1, :, :2].numpy(),
                                  want)
    with pytest.raises(ValueError, match="rank"):
        m.load("big", adapters["a2"])  # rank 4 > max_rank 2
    assert m._free == [2]  # nothing written on failure
    bad = str(tmp_path / "bad.npz")
    save_adapter_npz(bad, {"wq_A": np.zeros((1, 64, 2), np.float32),
                           "wq_B": np.zeros((1, 2, 64), np.float32)})
    with pytest.raises(ValueError, match="do not match"):
        m.load("bad", bad)
    assert m.load("v2", adapters["v2"]) == 2
    with pytest.raises(RuntimeError, match="max_loras"):
        m.load("a3", adapters["a1"])
    assert m.unload("a1") and not m.unload("a1")
    assert float(m.buffers["wq_A"][:, 1].abs().sum()) == 0.0
    assert float(m.buffers["scaling"][1]) == 0.0
    with pytest.raises(KeyError):
        m.slot_of("a1")


def test_peft_safetensors_read_equals_jax_reader(adapters):
    t = LoraManager(MC, max_loras=1, max_rank=4)._read_adapter(
        adapters["peft"])
    j = JLoraManager(MC, max_loras=1, max_rank=4,
                     dtype=jnp.float32)._read_adapter(adapters["peft"])
    assert sorted(t) == sorted(j)
    src = make_adapter(rank=3, seed=44)
    for k in j:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
        if k != "scaling":
            np.testing.assert_array_equal(np.asarray(t[k]), src[k])
    assert float(t["scaling"]) == 2.0  # lora_alpha / r


# -- forward ------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["uniform", "per-token", "base"])
def test_lora_forward_matches_jax(mode, np_params):
    rng = np.random.RandomState(5)
    S, r, L, T = 4, 4, MC.num_layers, 11
    h = MC.hidden_size
    dims = {"wq": (h, MC.q_size), "wk": (h, MC.kv_size),
            "wv": (h, MC.kv_size), "wo": (MC.q_size, h)}
    lz = {"scaling": np.asarray([0.0, 0.5, 1.0, 2.0], np.float32)}
    for t, (din, dout) in dims.items():
        lz[f"{t}_A"] = rng.randn(L, S, din, r).astype(np.float32) * 0.2
        lz[f"{t}_B"] = rng.randn(L, S, r, dout).astype(np.float32) * 0.2
        lz[f"{t}_A"][:, 0] = lz[f"{t}_B"][:, 0] = 0.0
    ids = rng.randint(0, MC.vocab_size, T)
    slots = {"uniform": np.int32(2), "base": np.int32(0),
             "per-token": rng.randint(0, S, T).astype(np.int32)}[mode]
    scale = MC.head_dim**-0.5
    kc = jnp.zeros((L, MC.num_kv_heads, T, MC.head_dim))
    pos = jnp.arange(T)

    def j_attn(q, l, kc, vc):
        return j_prefill_attn(q, kc[l].swapaxes(0, 1), vc[l].swapaxes(0, 1),
                              pos, jnp.int32(T), scale)

    want, _, _ = jllama.forward(
        MC, jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(ids),
        pos, kc, jnp.zeros_like(kc), pos, j_attn, logits_rows=pos,
        lora={k: jnp.asarray(v) for k, v in lz.items()},
        lora_slots=jnp.asarray(slots))
    tc = torch.zeros(tuple(kc.shape))
    tpos = torch.arange(T)

    def t_attn(q, l, kc, vc):
        return t_prefill_attn(q, kc[l].transpose(0, 1),
                              vc[l].transpose(0, 1), tpos, T, scale)

    t_slots = (torch.from_numpy(slots.copy()) if mode == "per-token"
               else int(slots))
    got, _, _ = tllama.forward(
        t_get_config("pst-tiny-debug"), params_from_numpy(np_params, "cpu"),
        torch.from_numpy(ids), tpos, tc, torch.zeros_like(tc), tpos, t_attn,
        logits_rows=tpos, lora={k: torch.from_numpy(v) for k, v in lz.items()},
        lora_slots=t_slots)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=REL,
                               atol=REL * np.abs(want).max())


# -- engines ------------------------------------------------------------------------
ARRIVALS = [  # (step, rid, prompt, adapter): base and adapter lanes share
    (0, "r0", _ids(1, 9), "a1"),  # rounds; r3's chunks arrive while the
    (0, "r1", _ids(2, 5), None),  # others decode (mixed ragged rounds
    (1, "r2", _ids(3, 7), "a2"),  # with per-token slots)
    (3, "r3", _ids(4, 37), "a1"),
]


@pytest.mark.parametrize("over", [
    dict(num_scheduler_steps=4),                          # the defaults
    dict(num_scheduler_steps=1, ragged_dispatch=False),   # split rounds
], ids=["ragged-k4-staged", "split-k1"])
def test_streams_equal_jax_engine(over, np_params, adapters):
    outs = {}
    for name, make, sp in (("port", _port, SamplingParams),
                           ("jax", _jax, JSampling)):
        eng = make(np_params, **over)
        eng.load_lora("a1", adapters["a1"])
        eng.load_lora("a2", adapters["a2"])
        outs[name] = _drive(eng, ARRIVALS, sp)
        if name == "port" and over.get("ragged_dispatch", True):
            assert eng._ragged_rounds_total > 0
            assert eng._staged_hits_total + eng._ragged_staged_hits_total > 0
    assert outs["port"] == outs["jax"]


def test_reload_and_unload_mid_request_equal_jax(np_params, adapters):
    """At the first step from 3 on where the port holds a staged decode
    round: a2 unloaded (r2 goes on as the base model), a1 unloaded, v2
    loaded into a1's old slot and a1 reloaded into another from v2's
    file. The engines' streams stay equal, and the port's stage, built
    for a1's old slot, is a counted miss."""
    arrivals = [a for a in ARRIVALS if a[1] != "r3"]
    at, misses = [], []

    def swap(eng):
        eng.unload_lora("a2")
        eng.unload_lora("a1")
        eng.load_lora("v2", adapters["v2"])
        eng.load_lora("a1", adapters["v2"])

    def port_swap(eng, step):
        if not at and step >= 3 and eng._staged_decode is not None:
            at.append(step)
            misses.append(eng._staged_misses_total)
            swap(eng)

    def jax_swap(eng, step):
        if step == at[0]:
            swap(eng)

    outs = {}
    for name, make, sp, between in (
            ("port", _port, SamplingParams, port_swap),
            ("jax", _jax, JSampling, jax_swap)):
        eng = make(np_params, num_scheduler_steps=4)
        eng.load_lora("a1", adapters["a1"])
        eng.load_lora("a2", adapters["a2"])
        outs[name] = _drive(eng, arrivals, sp, between, n=16)
        if name == "port":
            assert at and eng._staged_misses_total > misses[0]
            assert eng.runner.lora_manager.name_to_slot == {"v2": 1,
                                                             "a1": 2}
    assert outs["port"] == outs["jax"]


def test_lora_matches_merged_weights_and_base_lanes(np_params, adapters):
    """Serving-time adapter == offline merge W + s * A @ B, token for
    token, with a base lane in the same batch equal to an engine without
    LoRA (slot 0 adds an exact zero)."""
    sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    eng = _port(np_params, num_scheduler_steps=4)
    eng.load_lora("a1", adapters["a1"])
    eng.add_request("lora", prompt=PROMPT, sampling_params=sp,
                    lora_name="a1")
    eng.add_request("base", prompt=PROMPT, sampling_params=sp)
    outs = {}
    while eng.has_unfinished():
        outs.update({o.request_id: o.token_ids for o in eng.step()
                     if o.finished})
    ad = make_adapter(rank=2, seed=11, scaling=1.0)
    merged = jax.tree_util.tree_map(np.copy, np_params)
    for t in ("wq", "wk", "wv", "wo"):
        merged["layers"][t] = merged["layers"][t] + ad[f"{t}_A"] @ ad[
            f"{t}_B"] * ad["scaling"]
    m_eng = _port(merged, enable_lora=False, num_scheduler_steps=4)
    assert outs["lora"] == m_eng.generate([PROMPT], sp)[0].token_ids
    b_eng = _port(np_params, enable_lora=False, num_scheduler_steps=4)
    assert outs["base"] == b_eng.generate([PROMPT], sp)[0].token_ids
    assert outs["lora"] != outs["base"]


def test_multi_lora_batch_isolation(np_params, adapters):
    """Two adapters decoding in one batch each match their solo run, and
    a base request after them misses their prefix-cache blocks."""
    def run(reqs):
        eng = _port(np_params, num_scheduler_steps=4)
        eng.load_lora("a1", adapters["a1"])
        eng.load_lora("a2", adapters["a2"])
        return _drive(eng, [(0, rid, _ids(8, 12), lo) for rid, lo in reqs],
                      SamplingParams), eng

    solo1, _ = run([("r1", "a1")])
    solo2, _ = run([("r2", "a2")])
    both, eng = run([("r1", "a1"), ("r2", "a2")])
    assert both == {**solo1, **solo2}
    h0 = eng.block_manager.prefix_hits
    _drive(eng, [(0, "base", _ids(8, 12), None)], SamplingParams)
    assert eng.block_manager.prefix_hits == h0


def test_admission_refusals(np_params):
    eng = _port(np_params)
    with pytest.raises(KeyError):
        eng.add_request("r", prompt="hi", lora_name="ghost")
    off = _port(np_params, enable_lora=False)
    with pytest.raises(ValueError, match="enable-lora"):
        off.add_request("r", prompt="hi", lora_name="x")
    with pytest.raises(RuntimeError, match="enable-lora"):
        off.load_lora("x", "/nonexistent.npz")
    assert off.list_loras() == [] and not off.has_unfinished()


def test_reload_misses_stale_kv_like_jax(np_params, adapters):
    """A name reloaded from another file must not reuse KV cached under
    its earlier load: prefix hits, queries and streams equal the JAX
    engine's through the whole sequence."""
    got = {}
    for name, make, sp in (("port", _port, SamplingParams),
                           ("jax", _jax, JSampling)):
        eng = make(np_params)
        eng.load_lora("ad", adapters["a1"])
        r1 = _drive(eng, [(0, "r1", _ids(9, 14), "ad")], sp, n=4)
        hits0 = eng.block_manager.prefix_hits
        eng.load_lora("ad", adapters["v2"])
        r2 = _drive(eng, [(0, "r2", _ids(9, 14), "ad")], sp, n=4)
        hits1 = eng.block_manager.prefix_hits
        r3 = _drive(eng, [(0, "r3", _ids(9, 14), "ad")], sp, n=4)
        got[name] = (r1, r2, r3, hits1 - hits0,
                     eng.block_manager.prefix_hits - hits1,
                     eng.block_manager.prefix_queries)
    assert got["port"] == got["jax"]
    assert got["port"][3] == 0 and got["port"][4] > 0


def test_stage_for_other_slots_is_rebuilt(np_params, adapters):
    """Runner: a stage_decode_multi / stage_prefill / stage_ragged handle
    built for one slot assignment is not consumed by a dispatch under
    another (its key holds the slots); the dispatch builds its own and
    gives the unstaged result."""
    eng = _port(np_params, num_scheduler_steps=4)
    eng.load_lora("a1", adapters["a1"])
    eng.load_lora("a2", adapters["a2"])
    r = eng.runner
    taken = []
    take = r._take
    r._take = lambda st: (taken.append(st), take(st))[1]
    tables = [[1, 2, 3], [4, 5, 6]]
    args = ([5, 7], tables, [6, 8], 4,
            np.zeros(2, np.float32), np.ones(2, np.float32),
            np.full(2, -1, np.int32), np.zeros((2, 2), np.uint32))
    chain = torch.tensor([3, 4, 0, 0], dtype=torch.int32)

    def dispatch(slots, staged):
        # the chosen tokens' logprobs: they move with the adapter
        return r.decode_multi(chain, *args, staged=staged, lora_slots=slots,
                              want_logprobs=True)[1]

    st = r.stage_decode_multi(*args, lora_slots=[1, 0])
    ref = dispatch([2, 0], None)
    got = dispatch([2, 0], st)
    assert taken == [] and torch.equal(got, ref)
    assert not torch.equal(got, dispatch([1, 0], None))
    st = r.stage_decode_multi(*args, lora_slots=[2, 0])
    assert torch.equal(dispatch([2, 0], st), ref) and taken == [st]
    # single-sequence prefill: the slot is part of the key too
    taken.clear()
    st = r.stage_prefill([1, 2, 3], 0, [7], 3, lora_slot=1)
    tok, lg = r.prefill([1, 2, 3], 0, [7], 3, staged=st, lora_slot=2)
    assert taken == []
    tok2, lg2 = r.prefill([1, 2, 3], 0, [7], 3, lora_slot=2)
    assert torch.equal(lg, lg2)
    # ragged round
    pf = ([[9, 8, 7]], [0], [[10]], [3], None)
    st = r.stage_ragged(*pf, *args, pf_lora_slots=[1], lora_slots=[2, 0])
    r.ragged_dispatch(*pf[:4], chain, *args, staged=st, pf_lora_slots=[2],
                      lora_slots=[2, 0])
    assert taken == []


def test_server_adapter_endpoints(np_params, adapters):
    """POST /v1/load_lora_adapter and /v1/unload_lora_adapter on the
    port's server: /v1/models lists the loaded adapters, a request whose
    model names one is served with it (token ids read back through
    return_tokens_as_token_ids equal an in-process engine's with the
    adapter), a bad path is a 500 that loads nothing, and after unload
    the name is a 404."""
    import asyncio
    import json
    import threading
    import urllib.error
    import urllib.request

    from production_stack_tpu_torch.engine.server import EngineServer

    server = EngineServer(EngineConfig(**BASE, device="cpu"),
                          params=params_from_numpy(np_params, "cpu"))
    loop = asyncio.new_event_loop()
    box, ready = [], threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        box.append(loop.run_until_complete(server.start("127.0.0.1", 0)))
        ready.set()
        loop.run_forever()

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{box[0]}{path}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(60)
    try:
        for name in ("a1", "peft"):
            st, _ = call("/v1/load_lora_adapter",
                         {"lora_name": name, "lora_path": adapters[name]})
            assert st == 200
        st, body = call("/v1/load_lora_adapter",
                        {"lora_name": "bad", "lora_path": "/no/such.npz"})
        assert st == 500 and "failed to load" in body["error"]["message"]
        st, body = call("/v1/models")
        assert [c["id"] for c in body["data"]] == [
            "pst-tiny-debug", "a1", "peft"]
        prompt = _ids(12, 10)
        served = {}
        for model in ("a1", "peft", None):
            req = {"prompt": prompt, "max_tokens": 6, "temperature": 0,
                   "ignore_eos": True, "logprobs": 1,
                   "return_tokens_as_token_ids": True}
            if model:
                req["model"] = model
            st, body = call("/v1/completions", req)
            assert st == 200 and body["model"] == (model or
                                                   "pst-tiny-debug")
            toks = body["choices"][0]["logprobs"]["tokens"]
            served[model] = [int(t.split(":")[1]) for t in toks]
        eng = _port(np_params)
        eng.load_lora("a1", adapters["a1"])
        eng.load_lora("peft", adapters["peft"])
        assert served == _drive(eng, [(0, m, prompt, m)
                                      for m in ("a1", "peft")],
                                SamplingParams, n=6) | {
            None: _drive(eng, [(0, "b", prompt, None)], SamplingParams,
                         n=6)["b"]}
        assert served["a1"] != served[None]
        st, _ = call("/v1/unload_lora_adapter", {"lora_name": "a1"})
        assert st == 200
        st, _ = call("/v1/completions", {"prompt": "x", "model": "a1"})
        assert st == 404
        st, _ = call("/v1/unload_lora_adapter", {"lora_name": "a1"})
        assert st == 404
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
    assert not th.is_alive()
