"""LoRA, the KV tiers, the remote cache and PD roles on a port rank set,
against the JAX meshed engine.

The JAX package serves these under tensor parallelism on one host (its
meshed engine is one process; here on the conftest's 8-device CPU mesh).
The port's rank set is processes: rank 0 in this process, the others
spawned over gloo on a loopback TCPStore (parallel/launch.py). Its KV
exports and imports, and its adapter loads, are broadcast steps
(engine/multihost_engine.py). The model is the tensor-parallel tests'
tiny one (16 q heads over 8 kv heads, head_dim 8, 2 layers), float32,
with the same JAX-initialised weights on both sides.

- KV at tp=2 (a 12-block HBM pool and a CPU tier): a prompt evicted by
  churn restores with greedy streams and restored blocks equal to the
  JAX tp=2 engine's, 0 fallbacks; its exported wire equals the JAX
  meshed engine's export within 1e-5 relative, each rank's own slice
  equals the cut of rank 0's wire byte for byte, and the wire crosses
  from the rank set to a tp=1 engine and back unchanged
  (tests/test_torch_pipeline_parallel.py runs the same scenario at
  pp=2 and pp=2 x tp=2).
- LoRA at tp=2: greedy streams of the base and two adapters equal the
  JAX tp=2 engine's; each rank's adapter buffers are byte-equal to the
  cut of a tp=1 manager's.
- The remote cache: the tp=2 engine writes through to the port's
  in-process cache server, and a cold tp=2 engine restores from it.
- PD: a tp=2 prefill engine serves a tp=1 decode engine, and a tp=1
  prefill engine a tp=2 decode engine; streams equal the JAX engine's.
- Ordering: no collective of the rank set runs on the offload worker's
  thread. The store: after 3 x 1024 steps the set's store holds at most
  the step window and a few keys, and no file in its directory grew.

Tolerances: 1e-5 relative for the wire; tokens and counts equal.
"""

import asyncio
import dataclasses
import os
import threading
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
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.lora import (
    LoraManager,
    save_adapter_npz,
)
from production_stack_tpu_torch.engine.multihost_engine import tensor_digest
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.kv import cache_server as tcs
from production_stack_tpu_torch.kv import transfer as ttransfer
from production_stack_tpu_torch.models import config as tmcfg
from production_stack_tpu_torch.models.convert import (
    params_from_numpy,
    tp_params_from_numpy,
)
from production_stack_tpu_torch.parallel import sharding

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
TINY = jmcfg.ModelConfig(
    name="pst-tiny-rank-set", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=16, num_kv_heads=8,
    head_dim=8, max_model_len=128, rope_theta=10000.0,
    tie_word_embeddings=True,
)
TCFG = tmcfg.ModelConfig(**{f.name: getattr(TINY, f.name)
                            for f in dataclasses.fields(tmcfg.ModelConfig)})
# a 12-block HBM pool evicts (tests/test_kv.py's tiny engine) into a CPU
# tier; adapters up to rank 8
ENGINE = dict(model=TINY.name, tokenizer="byte", dtype="float32",
              cache_dtype="float32", block_size=4, num_kv_blocks=12,
              max_num_seqs=2, max_prefill_chunk=32, seed=0,
              cpu_offload_bytes=64 * 2**20)
LORA = dict(enable_lora=True, max_loras=2, max_lora_rank=8)
PROMPT_A = "a" * 24  # BOS + 24 bytes: 6 full blocks
PD_PROMPT = "pd handoff prompt!!"  # BOS + 19 bytes: 5 full blocks


def _greedy(pkg, n=4):
    cls = JSampling if pkg == "jax" else SamplingParams
    return cls(max_tokens=n, temperature=0.0, ignore_eos=True)


def _wait_until(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


@pytest.fixture(autouse=True, scope="module")
def register_cfgs():
    jmcfg._PRESETS[TINY.name] = TINY
    tmcfg._PRESETS[TCFG.name] = TCFG
    yield
    jmcfg._PRESETS.pop(TINY.name, None)
    tmcfg._PRESETS.pop(TCFG.name, None)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(TINY, jax.random.key(0), jnp.float32))


def _adapter(rank, seed, scaling, targets=("wq", "wk", "wv", "wo")):
    rng = np.random.RandomState(seed)
    L, h = TINY.num_layers, TINY.hidden_size
    dims = {"wq": (h, TINY.q_size), "wk": (h, TINY.kv_size),
            "wv": (h, TINY.kv_size), "wo": (TINY.q_size, h)}
    w = {"scaling": np.float32(scaling)}
    for t in targets:
        din, dout = dims[t]
        w[f"{t}_A"] = rng.randn(L, din, rank).astype(np.float32) * 0.2
        w[f"{t}_B"] = rng.randn(L, rank, dout).astype(np.float32) * 0.2
    return w


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """a1 (rank 8, every target) and a2 (rank 4, wq and wo)."""
    d = tmp_path_factory.mktemp("rank-set-adapters")
    paths = {}
    for name, w in (("a1", _adapter(8, 11, 1.0)),
                    ("a2", _adapter(4, 22, 0.5, ("wq", "wo")))):
        paths[name] = str(d / f"{name}.npz")
        save_adapter_npz(paths[name], w)
    return paths


@pytest.fixture(scope="module")
def cache_server():
    srv = tcs.InProcessCacheServer(capacity_bytes=1 << 26)
    yield srv
    srv.stop()


def _port(np_params, tp=1, pp=1, **over):
    cfg = EngineConfig(**{**ENGINE, **over}, device="cpu",
                       tensor_parallel_size=tp, pipeline_parallel_size=pp)
    return LLMEngine(cfg, params=params_from_numpy(np_params, "cpu"))


def _jax(np_params, tp=1, pp=1, **over):
    cfg = JConfig(**{**ENGINE, **over}, attention_impl="xla",
                  tensor_parallel_size=tp, pipeline_parallel_size=pp)
    return JEngine(cfg, params=jax.tree_util.tree_map(jnp.asarray,
                                                      np_params))


def _prompt_bids(eng, prompt):
    bm = eng.block_manager
    return [bm.cached_blocks[h] for h in
            bm.block_hashes_for(eng.tokenizer.encode(prompt), 0)]


def _kv_scenario(eng, pkg):
    """PROMPT_A, four prompts of churn that evict it from the 12-block
    pool, PROMPT_A again (restored from the CPU tier); then its blocks
    exported. -> (first stream, second stream, blocks restored,
    fallbacks, block ids, wire)."""
    sp = _greedy(pkg)
    out1 = eng.generate([PROMPT_A], sp)[0].token_ids
    assert _wait_until(lambda: eng.offload.tiers[0].hashes(), 5)
    for i in range(4):
        eng.generate([chr(ord("b") + i) * 24], sp)
    r0 = eng._kv_restore_blocks_total
    out2 = eng.generate([PROMPT_A], sp)[0].token_ids
    bids = _prompt_bids(eng, PROMPT_A)
    wire = np.asarray(eng.runner.export_blocks(bids))
    return (out1, out2, eng._kv_restore_blocks_total - r0,
            eng._kv_restore_fallbacks_total, bids, wire)


def _lora_scenario(eng, pkg, adapters):
    """Greedy streams of the base model and each adapter, at once."""
    for name, path in adapters.items():
        eng.load_lora(name, path)
    prompts = [[7, 8, 9, 10, 11, 12, 13, 14, 15],
               [40, 41, 42, 43, 44], [90, 91, 92, 93, 94, 95, 96]]
    for i, (ids, lora) in enumerate(zip(prompts, [None, "a1", "a2"])):
        eng.add_request(f"lora{i}", prompt_token_ids=ids, lora_name=lora,
                        sampling_params=_greedy(pkg, 6))
    done = {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                done[o.request_id] = o.token_ids
    return [done[f"lora{i}"] for i in range(3)]


class _TransferServer:
    """The port's KVTransferServer for an engine that is not served: a
    stand-in for AsyncLLMEngine (the engine and its lock) on a loop in a
    thread."""

    class _Async:
        def __init__(self, engine):
            self.engine = engine
            self._lock = threading.Lock()

    def __init__(self, engine):
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=asyncio.run, args=(self._serve(self._Async(engine)),),
            daemon=True)
        self._thread.start()
        assert self._ready.wait(10)
        self.addr = f"127.0.0.1:{self.port}"

    async def _serve(self, fake):
        srv = ttransfer.KVTransferServer(fake)
        await srv.start("127.0.0.1", 0)
        self.port = srv.port
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        self._ready.set()
        await self._stop.wait()
        await srv.stop()

    def close(self):
        self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout=10)


@pytest.fixture(scope="module")
def jax_tp2(np_params, adapters):
    """The JAX meshed engine at tp=2 (LoRA on, the CPU tier): the KV and
    LoRA scenarios and the PD prompt's greedy stream, in the order the
    port's tp=2 engine runs them."""
    eng = _jax(np_params, tp=2, **LORA)
    try:
        return {"kv": _kv_scenario(eng, "jax"),
                "lora": _lora_scenario(eng, "jax", adapters),
                "pd": eng.generate([PD_PROMPT], _greedy("jax", 6))[0]
                .token_ids}
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def tp2(np_params, adapters, cache_server):
    """The port's tp=2 rank set: LoRA on, the CPU tier, and the cache
    server written through. Rank 0's collectives are recorded with the
    thread that issued them."""
    eng = _port(np_params, tp=2, **LORA,
                remote_cache_url=f"127.0.0.1:{cache_server.port}")
    group = eng.runner._group
    threads = []
    for name in ("broadcast", "all_reduce"):
        def spy(*a, _fn=getattr(group, name), **k):
            threads.append(threading.current_thread().name)
            return _fn(*a, **k)
        setattr(group, name, spy)
    eng.collective_threads = threads
    eng.runs = {"kv": _kv_scenario(eng, "port")}
    yield eng
    eng.shutdown()
    assert all(p.exitcode == 0 for p in group.followers)


def _check_kv(eng, want):
    out1, out2, restored, fallbacks, bids, wire = eng.runs["kv"]
    assert out1 == out2 == want[0] == want[1]
    assert fallbacks == want[3] == 0
    assert restored == want[2] and restored > 0
    assert wire.shape == want[5].shape == (
        2, TINY.num_layers, 6, TINY.num_kv_heads, 4, TINY.head_dim)
    np.testing.assert_allclose(wire, want[5], rtol=REL,
                               atol=REL * np.abs(want[5]).max())
    # every rank's own slice is the cut of rank 0's assembled wire
    tp, pp = eng.config.tensor_parallel_size, eng.config.pipeline_parallel_size
    full = torch.from_numpy(wire)
    for r, rep in enumerate(eng.runner.reports(kv_blocks=bids)):
        stage, t = sharding.rank_layout(r, tp)
        lo, hi = sharding.stage_layers(TINY.num_layers, stage, pp)
        nkv = TINY.num_kv_heads // tp
        cut = full[:, lo:hi, :, t * nkv:(t + 1) * nkv]
        assert rep["kv_digest"] == tensor_digest(cut), r


def test_tp2_kv_export_and_restore_equal_jax_meshed(tp2, jax_tp2):
    _check_kv(tp2, jax_tp2["kv"])
    assert tp2._kv_export_blocks_total > 0


def test_wire_crosses_rank_set_and_tp1_both_ways(tp2, np_params):
    """A tp=2 export imports into a tp=1 engine and exports back
    unchanged; a tp=1 export imports into the rank set and back."""
    *_, bids, wire = tp2.runs["kv"]
    one = _port(np_params, num_kv_blocks=32, cpu_offload_bytes=0)
    free = list(range(20, 26))
    one.runner.import_blocks(free, torch.from_numpy(wire))
    back = one.runner.export_blocks(free)
    assert back.numpy().tobytes() == wire.tobytes()
    g = torch.Generator().manual_seed(3)
    one.runner.k_cache.copy_(torch.randn(one.runner.k_cache.shape,
                                         generator=g))
    one.runner.v_cache.copy_(torch.randn(one.runner.v_cache.shape,
                                         generator=g))
    data = one.runner.export_blocks([3, 9, 4])
    spare = [b for b in range(1, 12) if b not in bids][-3:]
    tp2.runner.import_blocks(spare, data)
    assert torch.equal(tp2.runner.export_blocks(spare), data)
    # a staged import with a column permutation (the staged restore's)
    handle = tp2.runner.stage_import_blocks(data)
    tp2.runner.import_staged_blocks(spare[:2], handle, [2, 0])
    got = tp2.runner.export_blocks(spare[:2])
    assert torch.equal(got[:, :, 0], data[:, :, 2])
    assert torch.equal(got[:, :, 1], data[:, :, 0])


def test_tp2_lora_streams_equal_jax_and_rank_buffers_are_cuts(
        tp2, jax_tp2, adapters):
    got = _lora_scenario(tp2, "port", adapters)
    assert got == jax_tp2["lora"]
    assert len({tuple(s) for s in got}) == 3  # each adapter tells
    full = LoraManager(TCFG, 2, 8, torch.float32)
    for name, path in adapters.items():
        full.load(name, path)
    want = [tp_params_from_numpy(
        {k: v.numpy() for k, v in full.buffers.items()}, TCFG, r, 2,
        "cpu", adapter=True) for r in range(2)]
    reps = tp2.runner.reports(adapter_digests=True)
    for r, rep in enumerate(reps):
        assert rep["adapters"] == full.name_to_slot
        assert rep["adapter_digests"] == {
            k: tensor_digest(v) for k, v in want[r].items()}, r
    # wq's B and wo's A are cut; wq's A is whole
    assert want[0]["wq_B"].shape[-1] == TINY.q_size // 2
    assert want[0]["wo_A"].shape[-2] == TINY.q_size // 2
    assert want[0]["wq_A"].shape == full.buffers["wq_A"].shape
    # an unload is a broadcast step too
    tp2.unload_lora("a2")
    assert [r["adapters"] for r in tp2.runner.reports()] == [{"a1": 1}] * 2


def test_refused_adapter_load_is_never_published(tp2, tmp_path):
    count = tp2.runner._bc.count
    with pytest.raises(Exception):
        tp2.load_lora("ghost", str(tmp_path / "none.npz"))
    assert tp2.runner._bc.count == count and tp2.tp_alive()


def test_remote_cache_written_by_tp2_restores_in_a_cold_tp2(
        tp2, np_params, cache_server):
    """The tp=2 engine's exports reached the cache server (written
    through); a cold tp=2 engine pulls PROMPT_A's chain from it and
    continues with the writer's stream."""
    want = tp2.runs["kv"][0]
    hashes = tp2.block_manager.block_hashes_for(
        tp2.tokenizer.encode(PROMPT_A), 0)
    assert _wait_until(lambda: cache_server.server.lookup(hashes) == 6, 5)
    cold = _port(np_params, tp=2, cpu_offload_bytes=0,
                 remote_cache_url=f"127.0.0.1:{cache_server.port}")
    try:
        got = cold.generate([PROMPT_A], _greedy("port"))[0].token_ids
        assert got == want
        assert cold.offload.remote.hits == 6
        assert cold._kv_restore_blocks_total == 6
        assert cold._kv_restore_fallbacks_total == 0
    finally:
        cold.shutdown()


def test_pd_tp2_prefill_serves_tp1_decode(tp2, np_params, jax_tp2):
    tp2.generate([PD_PROMPT], _greedy("port", 1))
    srv = _TransferServer(tp2)
    try:
        dec = _port(np_params, num_kv_blocks=32, cpu_offload_bytes=0,
                    kv_role="decode", kv_transfer_config={"peer": srv.addr})
        try:
            got = dec.generate([PD_PROMPT], _greedy("port", 6))[0]
            assert got.token_ids == jax_tp2["pd"]
            assert dec._kv_restore_blocks_total == 5
            assert dec._kv_restore_fallbacks_total == 0
        finally:
            dec.shutdown()
    finally:
        srv.close()


def test_pd_tp1_prefill_serves_tp2_decode(np_params, jax_tp2):
    pre = _port(np_params, num_kv_blocks=32, cpu_offload_bytes=0,
                kv_role="prefill")
    pre.generate([PD_PROMPT], _greedy("port", 1))
    srv = _TransferServer(pre)
    try:
        dec = _port(np_params, tp=2, cpu_offload_bytes=0, kv_role="decode",
                    kv_transfer_config={"peer": srv.addr})
        try:
            got = dec.generate([PD_PROMPT], _greedy("port", 6))[0]
            assert got.token_ids == jax_tp2["pd"]
            assert dec._kv_restore_blocks_total == 5
            assert dec._kv_restore_fallbacks_total == 0
            r0, r1 = dec.runner.reports()
            assert r0["broadcasts"] == r1["broadcasts"] > 0
        finally:
            dec.shutdown()
    finally:
        srv.close()


def test_no_collective_on_the_offload_worker(tp2):
    """Every collective rank 0 issued came from the step thread (here
    the test's own) or, under the engine lock, from a PD pull's executor
    thread; the offload worker's thread issued none, though it
    materialized every deferred export."""
    assert tp2._kv_export_blocks_total > 0
    threads = set(tp2.collective_threads)
    assert threading.current_thread().name in threads
    assert all(t == threading.current_thread().name
               or t.startswith("asyncio_") for t in threads), threads
    assert "kv-offload-writer" not in threads


def test_store_stays_bounded_over_3x1024_steps(tp2):
    """Each published step deletes the one a window back, and a deleted
    key of the TCPStore is gone. (The steps here run no collective, so a
    report every 512 keeps the follower inside the window, as a
    forward's collectives do when serving.)"""
    group = tp2.runner._group
    files = {f: os.path.getsize(os.path.join(group.store_dir, f))
             for f in os.listdir(group.store_dir)}
    for i in range(3 * 1024):
        tp2.runner.reset_counts()
        if i % 512 == 511:
            tp2.runner.reports()
    reps = tp2.runner.reports()
    window = tp2.runner._bc._window
    assert all(r["store_keys"] is not None for r in reps)
    assert max(r["store_keys"] for r in reps) < window + 64
    assert {f: os.path.getsize(os.path.join(group.store_dir, f))
            for f in os.listdir(group.store_dir)} == files
