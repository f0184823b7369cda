"""The port's KV export, import and tiers against the JAX package's, on
the CPU in float32.

- Content addresses: the port's pure-Python xxh64 equals the xxhash
  package on drawn bytes and seeds; hash_block, iter_chain_hashes, the
  LoRA chain seed of a Sequence and LoraManager.hash_seed_of equal the
  JAX package's.
- Wire and disk: serialize_block writes the JAX package's bytes for f32
  and bf16, each package's deserialize_block reads the other's, and a
  DiskTier directory written by one package restores in the other.
- The tier unit scenarios of tests/test_kv.py, on both packages' tiers
  (one parametrised test each): LRU, disk restart, cascade, refcounted
  pending reads, a rejected block not reported as evicted.
- Runner: the wire blocks a port runner exports after a prefill are
  within 1e-5 relative of a JAX runner's on the same params and prompt;
  the port's import round trip is exact (f32 and bf16).
- Engine scenarios of tests/test_kv.py, each on a port engine and a JAX
  engine at their defaults: offload restore after HBM churn, the
  capped-HBM cascade through cpu and disk, a mid-chain failure that
  falls back, controller reporting. Greedy streams, restored blocks and
  restored prefix hits are equal.
- Across packages: a disk directory written by one package's engine
  restores in the other's; the JAX KVController matches a prompt against
  a port engine's reports (and the port controller a JAX engine's); a
  RemoteTier of either package talks to the other's KVCacheServer, and a
  cache server written by one package's engine restores in the other's.
"""

import asyncio
import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from production_stack_tpu.engine import block_manager as jbm
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine import sequence as jseq
from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.kv import cache_server as jcs
from production_stack_tpu.kv import controller as jctl
from production_stack_tpu.kv import offload as joff
from production_stack_tpu.kv import remote as jremote
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine import block_manager as tbm
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine import sequence as tseq
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.kv import cache_server as tcs
from production_stack_tpu_torch.kv import controller as tctl
from production_stack_tpu_torch.kv import offload as toff
from production_stack_tpu_torch.kv import remote as tremote
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.utils.xxh64 import xxh64

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

PKGS = ("jax", "port")
OFF = {"jax": joff, "port": toff}
COMMON = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
              cache_dtype="float32", seed=0)
# tests/test_kv.py's tiny_engine_cfg: a 12-block HBM pool evicts
TINY = dict(block_size=4, num_kv_blocks=12, max_num_seqs=2,
            max_prefill_chunk=32, cpu_offload_bytes=64 * 2**20)
REL = 1e-5


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _engine(pkg, np_params, **cfg):
    """A JAX (XLA path) or port (CPU) engine on the same weights."""
    cfg = {**COMMON, **cfg}
    if pkg == "jax":
        return JEngine(JConfig(**cfg, attention_impl="xla"),
                       params=jax.tree_util.tree_map(jnp.asarray, np_params))
    return LLMEngine(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


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


def blk(pkg, v, nbytes=1024):
    """A host block of `nbytes` f32 values `v`, in the package's type."""
    a = np.full(nbytes // 4, v, dtype=np.float32)
    return a if pkg == "jax" else torch.from_numpy(a)


def _np(arr):
    """A host block of either package as a numpy array (bf16 as its
    uint16 bits)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return arr.view(torch.int16).numpy().view(np.uint16)
        return arr.numpy()
    if arr.dtype == ml_dtypes.bfloat16:
        return arr.view(np.uint16)
    return np.asarray(arr)


def _wire(pkg, shape=(2, 3, 2, 4, 8), seed=0, bf16=False):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    if pkg == "jax":
        return x.astype(ml_dtypes.bfloat16) if bf16 else x
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if bf16 else t


# -- content addresses -------------------------------------------------------
@settings(max_examples=200, deadline=None)
@given(data=st.binary(max_size=300),
       seed=st.integers(min_value=0, max_value=2**64 - 1))
def test_xxh64_equals_xxhash(data, seed):
    assert xxh64(data, seed) == xxhash.xxh64(data, seed).intdigest()


def test_chain_hashes_and_seeds_equal_jax():
    rng = np.random.RandomState(3)
    for n, extra in ((32, ()), (4, ("lora", 7)), (0, ()), (16, (1.5,))):
        toks = tuple(int(t) for t in rng.randint(0, 2**31, size=n))
        prev = int(rng.randint(0, 2**62))
        assert tbm.hash_block(prev, toks, extra) == jbm.hash_block(
            prev, toks, extra)
    toks = rng.randint(0, 128256, size=1500).tolist()
    for bs, seed in ((32, 0), (16, 12345), (4, 2**64 - 1)):
        assert list(tbm.iter_chain_hashes(toks, bs, seed)) == list(
            jbm.iter_chain_hashes(toks, bs, seed))
    tb = tbm.BlockManager(8, 4)
    jb = jbm.BlockManager(8, 4)
    assert tb.block_hashes_for(toks[:40], 99) == jb.block_hashes_for(
        toks[:40], 99)
    for name in ("adapter-a", "ü-name"):
        ts = tseq.Sequence("r", [1, 2], SamplingParams(), 0, lora_name=name)
        js = jseq.Sequence("r", [1, 2], JSampling(), 0, lora_name=name)
        assert ts.hash_seed == js.hash_seed != 0
    mc = get_model_config("pst-tiny-debug")
    tm = tlora.LoraManager(mc, 2, 4, torch.float32)
    jm = jlora.LoraManager(mc, 2, 4, jnp.float32)
    assert tm.hash_seed_of(None) == jm.hash_seed_of(None) == 0
    for gen in (0, 3):
        tm._generation["a"] = jm._generation["a"] = gen
        assert tm.hash_seed_of("a") == jm.hash_seed_of("a")


# -- wire and disk -----------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_serialize_block_bytes_equal_jax(bf16):
    j, t = _wire("jax", bf16=bf16), _wire("port", bf16=bf16)
    data = toff.serialize_block(t)
    assert data == joff.serialize_block(j)
    assert data.startswith(b"KVBF16") == bf16
    back = toff.deserialize_block(joff.serialize_block(j))
    assert back.dtype == t.dtype and torch.equal(back, t)
    np.testing.assert_array_equal(_np(joff.deserialize_block(data)), _np(t))
    # a block of a stacked batch serializes as the block alone does
    assert toff.serialize_block(toff.own_block(t, 1)) == \
        joff.serialize_block(np.ascontiguousarray(j[:, :, 1]))


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_disk_tier_directory_restores_in_the_other(tmp_path, writer,
                                                   reader):
    d = str(tmp_path / "kv")
    w = OFF[writer].DiskTier(d)
    blocks = {h: _wire(writer, seed=h, bf16=h % 2 == 0) for h in (2, 3)}
    for h, a in blocks.items():
        w.put(h, a)
    assert sorted(os.listdir(d)) == ["2.kvblk", "3.kvblk"]
    r = OFF[reader].DiskTier(d)  # restart adopts the files
    assert sorted(r.hashes()) == [2, 3]
    for h, a in blocks.items():
        np.testing.assert_array_equal(_np(r.get(h)), _np(a))


# -- the tier unit scenarios of tests/test_kv.py ----------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_cpu_tier_lru_eviction(pkg):
    t = OFF[pkg].CpuTier(capacity_bytes=3 * 1024)
    for h in (1, 2, 3):
        assert t.put(h, blk(pkg, h)) == []
    t.get(1)  # touch 1 -> 2 is now LRU
    assert [h for h, _ in t.put(4, blk(pkg, 4))] == [2]
    assert t.contains(1) and t.contains(3) and t.contains(4)
    assert not t.contains(2)


@pytest.mark.parametrize("pkg", PKGS)
def test_disk_tier_roundtrip_and_restart(tmp_path, pkg):
    d = str(tmp_path / "kv")
    t = OFF[pkg].DiskTier(d, capacity_bytes=10 * 2**20)
    a = blk(pkg, 7)
    t.put(42, a)
    np.testing.assert_array_equal(_np(t.get(42)), _np(a))
    t2 = OFF[pkg].DiskTier(d)
    assert t2.contains(42)
    np.testing.assert_array_equal(_np(t2.get(42)), _np(a))


@pytest.mark.parametrize("pkg", PKGS)
def test_offload_manager_cascade(tmp_path, pkg):
    cpu = OFF[pkg].CpuTier(capacity_bytes=2 * 1024)
    disk = OFF[pkg].DiskTier(str(tmp_path / "kv"))
    m = OFF[pkg].KVOffloadManager([cpu, disk])
    try:
        m.put_batch([(i, blk(pkg, i)) for i in range(1, 5)])
        assert _wait_until(
            lambda: len(cpu.hashes()) + len(disk.hashes()) == 4, 5)
        for i in range(1, 5):
            np.testing.assert_array_equal(_np(m.get(i)), _np(blk(pkg, i)))
        assert len(cpu.hashes()) == 2
        assert sorted(disk.hashes()) == [1, 2]
    finally:
        m.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_pending_reads_are_refcounted_across_requesters(pkg):
    cpu = OFF[pkg].CpuTier(capacity_bytes=1 << 20)
    m = OFF[pkg].KVOffloadManager([cpu])
    try:
        cpu.put(11, blk(pkg, 1))
        m.request_reads([11])  # requester A
        m.request_reads([11])  # requester B (same hash, no second job)
        assert _wait_until(lambda: m.poll_reads([11]), 5)
        got_a = m.take_reads([11])
        assert got_a[11][0] is not None
        got_b = m.take_reads([11])  # B still sees it (refcount)
        assert got_b[11][0] is not None
        assert m.poll_reads([11]) == {}  # last reference popped it
        m.request_reads([12])
        m.discard_reads([12])
        cpu.put(12, blk(pkg, 2))
        time.sleep(0.3)
        assert m.poll_reads([12]) == {}
    finally:
        m.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_rejected_block_not_reported_as_tier_evict(pkg):
    off = OFF[pkg]

    class Reporter:
        def __init__(self):
            self.events = []

        def admit(self, tier, hashes):
            self.events.append(("admit", tier, sorted(hashes)))

        def evict(self, tier, hashes):
            self.events.append(("evict", tier, sorted(hashes)))

    class RejectTier(off.KVTier):
        name = "reject"

        def put(self, h, arr):
            return [(h, arr)]

        def get(self, h):
            return None

        def contains(self, h):
            return False

        def hashes(self):
            return []

        def stats(self):
            return {"tier": self.name, "blocks": 0}

    cpu = off.CpuTier(capacity_bytes=int(blk(pkg, 1).nbytes))
    rep = Reporter()
    m = off.KVOffloadManager([cpu, RejectTier()], reporter=rep)
    try:
        m.put_batch([(1, blk(pkg, 1))])
        m.put_batch([(2, blk(pkg, 2))])  # displaces 1 -> reject drops it
        assert _wait_until(lambda: cpu.contains(2), 5)
        time.sleep(0.05)
    finally:
        m.close()
    assert ("admit", "cpu", [1]) in rep.events
    assert ("evict", "cpu", [1]) in rep.events
    assert not [e for e in rep.events if e[1] == "reject"], rep.events


# -- runner ------------------------------------------------------------------
def _prompt_bids(eng, toks):
    bm = eng.block_manager
    return [bm.cached_blocks[h] for h in bm.block_hashes_for(toks, 0)]


def test_exported_blocks_equal_jax_and_import_round_trips(np_params):
    cfg = dict(block_size=4, num_kv_blocks=64, max_num_seqs=2,
               max_prefill_chunk=16)
    toks = np.random.RandomState(5).randint(1, 250, size=27).tolist()
    got = {}
    for pkg in PKGS:
        eng = _engine(pkg, np_params, **cfg)
        eng.generate([toks], _greedy(pkg, 1))
        bids = _prompt_bids(eng, toks)
        assert len(bids) == 6
        got[pkg] = (eng, bids, eng.runner.export_blocks(bids))
    want = np.asarray(got["jax"][2])
    data = got["port"][2]
    mc = get_model_config("pst-tiny-debug")
    assert tuple(data.shape) == (2, mc.num_layers, 6, mc.num_kv_heads, 4,
                                 mc.head_dim) == want.shape
    np.testing.assert_allclose(data.numpy(), want, rtol=REL,
                               atol=REL * np.abs(want).max())
    # import into six free blocks, export back: exact
    eng, bids, _ = got["port"]
    free = [b for b in range(1, 64) if b not in bids][-6:]
    eng.runner.import_blocks(free, data)
    assert torch.equal(eng.runner.export_blocks(free), data)
    # a staged import with a column permutation and a partial adoption
    handle = eng.runner.stage_import_blocks(data)
    eng.runner.import_staged_blocks(free[:2], handle, [5, 0])
    back = eng.runner.export_blocks(free[:2])
    assert torch.equal(back[:, :, 0], data[:, :, 5])
    assert torch.equal(back[:, :, 1], data[:, :, 0])


def test_bf16_import_round_trip_and_serialization(np_params):
    eng = _engine("port", np_params, block_size=4, num_kv_blocks=16,
                  cache_dtype="bfloat16")
    r = eng.runner
    g = torch.Generator().manual_seed(0)
    r.k_cache.copy_(torch.randn(r.k_cache.shape, generator=g))
    r.v_cache.copy_(torch.randn(r.v_cache.shape, generator=g))
    data = r.export_blocks([3, 1, 7])
    assert data.dtype == torch.bfloat16
    wire = toff.deserialize_block(toff.serialize_block(data))
    r.import_blocks([9, 10, 11], wire)
    assert torch.equal(r.export_blocks([9, 10, 11]), data)
    # the JAX package reads the same bytes as the same bf16 values
    np.testing.assert_array_equal(
        _np(joff.deserialize_block(toff.serialize_block(data))), _np(data))


def test_offloaded_blocks_own_their_memory(np_params):
    eng = _engine("port", np_params, **{**TINY, "cpu_offload_bytes": 1 << 20})
    try:
        outs = eng.generate([list(range(24)), list(range(30, 50))],
                            _greedy("port"))
        assert all(len(o.token_ids) == 4 for o in outs)
        cpu = eng.offload.tiers[0]
        assert _wait_until(lambda: cpu.hashes(), 5)
        for h in cpu.hashes():
            arr = cpu.get(h)
            assert arr.storage_offset() == 0 and arr.is_contiguous()
            assert arr.untyped_storage().nbytes() == arr.nbytes, (
                "offloaded block is a view into a shared export array")
    finally:
        eng.shutdown()


# -- engine scenarios, on a port engine and a JAX engine ---------------------
def _restore_after_churn(pkg, np_params):
    eng = _engine(pkg, np_params, **TINY)
    try:
        sp = _greedy(pkg)
        prompt_a = "aaaaaaaaaaaaaaaaaaaaaaaa"  # 24 tokens = 6 blocks
        out1 = eng.generate([prompt_a], sp)[0].token_ids
        assert _wait_until(lambda: eng.offload.tiers[0].hashes(), 5)
        for i in range(4):
            eng.generate([chr(ord("b") + i) * 24], sp)
        h0 = eng.block_manager.prefix_hits
        r0 = eng._kv_restore_blocks_total
        out2 = eng.generate([prompt_a], sp)[0].token_ids
        assert out2 == out1
        assert eng._kv_restore_fallbacks_total == 0
        return (out1, eng.block_manager.prefix_hits - h0,
                eng._kv_restore_blocks_total - r0)
    finally:
        eng.shutdown()


def test_offload_restore_after_churn_equals_jax(np_params):
    port = _restore_after_churn("port", np_params)
    assert port[1] >= 16 and port[2] > 0
    assert port == _restore_after_churn("jax", np_params)


def _capped_cfg(path, **over):
    nbytes = 2 * 2 * 2 * 4 * 16 * 4  # (2, L, nkv, bs, d) f32 tiny block
    return {**TINY, "num_kv_blocks": 16, "cpu_offload_bytes": 3 * nbytes,
            "disk_offload_dir": str(path), **over}


def _sessions(pkg, np_params, path):
    """tests/test_kv.py's capped-HBM cascade: three users' multi-round
    sessions, round-major, so every resume restores through the tiers."""
    eng = _engine(pkg, np_params, **_capped_cfg(path))
    prompts = [[10 + u] * 24 for u in range(3)]
    outs = []
    try:
        for _ in range(3):
            for u in range(3):
                out = eng.generate([prompts[u]], _greedy(pkg))[0].token_ids
                outs.append(out)
                prompts[u] = prompts[u] + list(out) + [40 + u] * 8
        assert _wait_until(lambda: eng.offload.tiers[1].hashes(), 5)
        counters = eng.offload.counters()
        assert counters["disk"]["write_bytes"] > 0
        return (outs, eng._kv_restore_blocks_total,
                eng._kv_restore_fallbacks_total,
                eng.block_manager.prefix_hits)
    finally:
        eng.shutdown()


def test_capped_hbm_cascade_equals_jax(np_params, tmp_path):
    port = _sessions("port", np_params, tmp_path / "port")
    assert port[1] > 0 and port[2] == 0
    assert port == _sessions("jax", np_params, tmp_path / "jax")


def _midchain_failure(pkg, np_params, path):
    eng = _engine(pkg, np_params, **_capped_cfg(
        path, cpu_offload_bytes=64 * 2**20))
    sp = _greedy(pkg)
    prompt_a = [7] * 24
    try:
        out1 = eng.generate([prompt_a], sp)[0].token_ids
        cpu, disk = eng.offload.tiers
        assert _wait_until(lambda: len(cpu.hashes()) >= 4, 5)
        for i in range(5):
            eng.generate([[100 + i] * 24], sp)
        hashes = eng.block_manager.block_hashes_for(prompt_a, 0)
        assert not eng.block_manager.contains_hash(hashes[0])
        victim = hashes[2]  # drop block 2 from every tier
        with cpu._lock:
            if victim in cpu._d:
                cpu.used -= int(cpu._d.pop(victim).nbytes)
        with disk._lock:
            if victim in disk._sizes:
                disk.used -= disk._sizes.pop(victim)
                os.remove(disk._path(victim))
        f0 = eng._kv_restore_fallbacks_total
        r0 = eng._kv_restore_blocks_total
        h0 = eng.block_manager.prefix_hits
        out2 = eng.generate([prompt_a], sp)[0].token_ids
        assert out2 == out1
        restored = eng._kv_restore_blocks_total - r0
        assert restored <= 2
        assert restored > 0 or eng._kv_restore_fallbacks_total > f0
        return (out1, restored, eng._kv_restore_fallbacks_total - f0,
                eng.block_manager.prefix_hits - h0)
    finally:
        eng.shutdown()


def test_midchain_failure_falls_back_like_jax(np_params, tmp_path):
    assert _midchain_failure("port", np_params, tmp_path / "p") == \
        _midchain_failure("jax", np_params, tmp_path / "j")


class _Controllers:
    """A JAX and a port KVController, each on its own event loop thread."""

    def __init__(self):
        self.loops, self.ctl, self.ports = {}, {}, {}
        self._stop, self._threads = {}, []
        for pkg, mod in (("jax", jctl), ("port", tctl)):
            ready = threading.Event()
            th = threading.Thread(target=self._serve,
                                  args=(pkg, mod, ready), daemon=True)
            th.start()
            assert ready.wait(5)
            self._threads.append(th)

    def _serve(self, pkg, mod, ready):
        async def run():
            c = mod.KVController()
            await c.start("127.0.0.1", 0)
            self.ctl[pkg] = c
            self.ports[pkg] = c._server.sockets[0].getsockname()[1]
            self.loops[pkg] = asyncio.get_running_loop()
            self._stop[pkg] = asyncio.Event()
            ready.set()
            await self._stop[pkg].wait()
            await c.stop()

        asyncio.run(run())

    def close(self):
        for pkg, loop in self.loops.items():
            loop.call_soon_threadsafe(self._stop[pkg].set)
        for th in self._threads:
            th.join(5)


def test_controller_reporting_across_packages(np_params):
    """A port engine reports to the JAX controller and a JAX engine to
    the port controller: each controller matches the prompt's tokens
    (BOS + bytes) against the other package's reported hashes, and both
    see the same per-tier matches."""
    ctls = _Controllers()
    engines = []
    try:
        prompt = "cccccccccccccccc"  # 16 tokens = 4 full blocks
        toks = [256] + list(prompt.encode("utf-8"))
        for pkg, ctl in (("port", "jax"), ("jax", "port")):
            eng = _engine(pkg, np_params, **TINY,
                          kv_controller_url=f"127.0.0.1:{ctls.ports[ctl]}",
                          kv_instance_id=f"127.0.0.1:70{len(engines)}")
            engines.append(eng)
            eng.generate([prompt], _greedy(pkg, 2))
        want = {"jax": "127.0.0.1:700", "port": "127.0.0.1:701"}
        for ctl, iid in want.items():
            c = ctls.ctl[ctl]
            assert _wait_until(
                lambda: c.lookup(toks).get(iid, 0) >= 16, 5), (
                ctl, c.lookup(toks))
        full = {ctl: ctls.ctl[ctl].full_lookup(toks)[iid]
                for ctl, iid in want.items()}
        assert full["jax"]["hbm"] == full["port"]["hbm"] >= 16
    finally:
        for eng in engines:
            eng.shutdown()
        ctls.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_engine_disk_directory_restores_in_the_other(np_params, tmp_path,
                                                     writer, reader):
    """An engine of one package offloads a prompt to disk and stops; a
    cold engine of the other package on the same directory restores the
    prompt from it, with the writer's greedy stream."""
    cfg = dict(TINY, cpu_offload_bytes=0, disk_offload_dir=str(tmp_path))
    prompt = list(range(40, 65))
    w = _engine(writer, np_params, **cfg)
    try:
        want = w.generate([prompt], _greedy(writer))[0].token_ids
        assert _wait_until(lambda: len(w.offload.tiers[0].hashes()) >= 6)
    finally:
        w.shutdown()
    r = _engine(reader, np_params, **cfg)
    try:
        assert len(r.offload.tiers[0].hashes()) >= 6
        h0 = r.block_manager.prefix_hits
        assert r.generate([prompt], _greedy(reader))[0].token_ids == want
        assert r._kv_restore_blocks_total == 6
        assert r.block_manager.prefix_hits - h0 == 24
        assert r._kv_restore_fallbacks_total == 0
    finally:
        r.shutdown()


# -- the shared cache server --------------------------------------------------
CS = {"jax": jcs, "port": tcs}
REMOTE = {"jax": jremote, "port": tremote}


@pytest.mark.parametrize("client,server", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_remote_tier_against_cache_server(client, server):
    srv = CS[server].InProcessCacheServer(capacity_bytes=1 << 24)
    tier = REMOTE[client].RemoteTier(f"127.0.0.1:{srv.port}",
                                     flush_age_s=0.05)
    try:
        blocks = {h: _wire(client, seed=h, bf16=True) for h in (11, 22, 33)}
        for h, a in blocks.items():
            assert tier.put(h, a) == []
        assert _wait_until(lambda: tier.flushes >= 1, 5)
        assert srv.stats().get("blocks") == 3 and tier.fallbacks == 0
        assert sorted(tier.hashes()) == [11, 22, 33]
        got, addr = tier.get_chain([11, 22, 33, 44])
        assert addr == f"127.0.0.1:{srv.port}" and len(got) == 3
        for g, h in zip(got, (11, 22, 33)):
            np.testing.assert_array_equal(_np(g), _np(blocks[h]))
        cl = REMOTE[client].CacheClient("127.0.0.1", srv.port)
        assert cl.lookup([11, 22, 99]) == 2
        np.testing.assert_array_equal(_np(cl.get(22)), _np(blocks[22]))
        assert cl.health()["status"] == "ok"
        cl.close()
    finally:
        tier.close()
        srv.stop()


@pytest.mark.parametrize("server,writer,reader", [
    ("port", "port", "port"), ("jax", "jax", "port"),
    ("port", "port", "jax")])
def test_cache_server_restores_across_engines(np_params, server, writer,
                                              reader):
    """An engine writes a prompt's blocks through to the shared cache
    server; a cold engine (no local tier) pulls the chain from it and
    continues with the writer's greedy stream."""
    srv = CS[server].InProcessCacheServer(capacity_bytes=1 << 26)
    cfg = dict(TINY, cpu_offload_bytes=0, num_kv_blocks=64,
               remote_cache_url=f"127.0.0.1:{srv.port}")
    prompt = list(range(70, 95))  # 25 tokens: 6 full blocks
    try:
        w = _engine(writer, np_params, **cfg)
        try:
            want = w.generate([prompt], _greedy(writer))[0].token_ids
            hashes = w.block_manager.block_hashes_for(prompt, 0)
            assert _wait_until(lambda: srv.server.lookup(hashes) == 6, 5)
        finally:
            w.shutdown()
        r = _engine(reader, np_params, **cfg)
        try:
            h0 = r.block_manager.prefix_hits
            assert r.generate([prompt], _greedy(reader))[0].token_ids == want
            assert r.offload.remote.hits == 6
            assert r._kv_restore_blocks_total == 6
            assert r.block_manager.prefix_hits - h0 == 24
        finally:
            r.shutdown()
    finally:
        srv.stop()
