"""Disaggregated prefill/decode on the port, on the CPU in float32.

The scenarios of tests/test_pd_transfer.py on port engines: the decode
engine's PeerTier pull rides the staged restore (request_chain_reads ->
pending-READ map -> stage/import) and decodes exactly the tokens of a
single engine; a dead peer, a mid-chain eviction on the prefill side and
a dead first peer degrade without a stall; --sync-kv-offload pulls
blocking; a peer-only engine has no export hooks; roles validate and
resolve as the JAX config's (and the CLI's vLLM aliases map). Across
packages: a port decode engine pulls from a JAX prefill engine's
KVTransferServer and the other way round, each continuing as a single
engine does. End to end: the JAX router's `pd` policy in front of two
port EngineServers (prefill serving KV, decode pulling it) gives the
text of a single port engine.
"""

import asyncio
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
from production_stack_tpu.kv import transfer as jtransfer
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu_torch.engine.__main__ import (
    build_parser,
    config_from_args,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.kv import transfer as ttransfer
from production_stack_tpu_torch.kv.peer import PeerTier
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

BASE = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
            cache_dtype="float32", seed=0, block_size=4, num_kv_blocks=64,
            max_num_seqs=2, max_prefill_chunk=32)
PROMPT = "here is a long shared prompt that fills multiple kv blocks!!"
N_FULL = (len(PROMPT) + 1) // 4  # BOS + bytes, full blocks of 4


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _engine(pkg, np_params, **kw):
    if pkg == "jax":
        return JEngine(JConfig(**BASE, **kw, attention_impl="xla"),
                       params=jax.tree_util.tree_map(jnp.asarray, np_params))
    return LLMEngine(EngineConfig(**BASE, **kw, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))


def _sp(pkg, n):
    cls = JSampling if pkg == "jax" else SamplingParams
    return cls(max_tokens=n, temperature=0.0)


class _ServerHarness:
    """A KVTransferServer of either package for an engine that is not
    served (a stand-in for AsyncLLMEngine: the engine and its lock)."""

    class _FakeAsync:
        def __init__(self, engine):
            self.engine = engine
            self._lock = threading.Lock()

    def __init__(self, engine, module=ttransfer):
        self.holder = {"ready": threading.Event()}
        self.fake = self._FakeAsync(engine)
        self.module = module
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()
        assert self.holder["ready"].wait(5)
        self.port = self.holder["port"]
        self.addr = f"127.0.0.1:{self.port}"

    def _serve(self):
        async def run():
            srv = self.module.KVTransferServer(self.fake)
            await srv.start("127.0.0.1", 0)
            self.holder["port"] = srv.port
            self.holder["loop"] = asyncio.get_running_loop()
            self.holder["stop"] = asyncio.Event()
            self.holder["ready"].set()
            await self.holder["stop"].wait()
            await srv.stop()

        asyncio.run(run())

    def close(self):
        self.holder["loop"].call_soon_threadsafe(self.holder["stop"].set)
        self.thread.join(timeout=5)


@pytest.fixture(scope="module")
def prefill(np_params):
    """A port prefill engine that ran the PD phase 1 (max_tokens 1) of
    PROMPT, serving its chains."""
    eng = _engine("port", np_params, kv_role="prefill")
    eng.generate([PROMPT], _sp("port", 1))
    harness = _ServerHarness(eng)
    yield eng, harness
    harness.close()
    eng.shutdown()


@pytest.fixture(scope="module")
def reference(np_params):
    """A single port engine's greedy continuation of PROMPT."""
    eng = _engine("port", np_params)
    out = eng.generate([PROMPT], _sp("port", 6))[0].token_ids
    eng.shutdown()
    return out


def test_decode_pulls_kv_from_prefiller_staged(np_params, prefill,
                                               reference):
    _, harness = prefill
    decode = _engine("port", np_params, kv_role="decode",
                     kv_transfer_config={"peer": harness.addr})
    try:
        assert decode._kv_async
        assert decode.offload is not None
        assert decode.offload.peer is decode.kv_peer
        out = decode.generate([PROMPT], _sp("port", 6))[0].token_ids
        assert decode.kv_peer.hits == N_FULL
        assert decode.kv_peer.fallbacks == 0
        assert decode.block_manager.prefix_hits >= N_FULL * 4
        assert decode._kv_restore_blocks_total == N_FULL
        assert decode._kv_restore_fallbacks_total == 0
        assert out == reference
    finally:
        decode.shutdown()


def test_decode_degrades_gracefully_without_peer(np_params, reference):
    decode = _engine("port", np_params, kv_role="decode",
                     kv_transfer_config={"peer": "127.0.0.1:1"})
    try:
        t0 = time.time()
        out = decode.generate([PROMPT], _sp("port", 6))[0].token_ids
        assert time.time() - t0 < 30  # connect fails fast, no stall
        assert out == reference
        assert decode.kv_peer.hits == 0
        assert decode.kv_peer.fallbacks >= 1
    finally:
        decode.shutdown()


def test_midchain_peer_eviction_falls_back(np_params, reference):
    pf = _engine("port", np_params, kv_role="prefill")
    pf.generate([PROMPT], _sp("port", 1))
    hashes = pf.block_manager.block_hashes_for(pf.tokenizer.encode(PROMPT))
    cut = len(hashes) // 2
    pf.block_manager.drop_cached_block(hashes[cut])
    harness = _ServerHarness(pf)
    try:
        decode = _engine("port", np_params, kv_role="decode",
                         kv_transfer_config={"peer": harness.addr})
        try:
            out = decode.generate([PROMPT], _sp("port", 6))[0].token_ids
            assert out == reference
            assert decode.kv_peer.hits == cut
            assert decode.kv_peer.misses >= 1
            assert decode._kv_restore_blocks_total == cut
        finally:
            decode.shutdown()
    finally:
        harness.close()
        pf.shutdown()


def test_transfer_server_chain_semantics_and_failover(prefill):
    eng, harness = prefill
    hashes = eng.block_manager.block_hashes_for(
        eng.tokenizer.encode(PROMPT))
    peer = PeerTier(harness.addr)
    blocks, addr = peer.get_chain(hashes)
    assert len(blocks) == len(hashes) == N_FULL and addr == harness.addr
    assert peer.get_chain([123456789]) == ([], None)
    blocks, _ = peer.get_chain(hashes + [987654321])
    assert len(blocks) == len(hashes)
    peer.close()
    # a dead first peer degrades to the next address in the list
    peer = PeerTier(f"127.0.0.1:1,{harness.addr}")
    blocks, addr = peer.get_chain(hashes)
    assert len(blocks) == len(hashes) and addr == harness.addr
    assert peer.fallbacks == 1
    peer.close()


def test_sync_mode_still_pulls_blocking(np_params, prefill, reference):
    _, harness = prefill
    decode = _engine("port", np_params, kv_role="decode",
                     kv_transfer_config={"peer": harness.addr},
                     sync_kv_offload=True)
    try:
        assert not decode._kv_async
        out = decode.generate([PROMPT], _sp("port", 6))[0].token_ids
        assert out == reference
        assert decode.kv_peer.hits == N_FULL
    finally:
        decode.shutdown()


@pytest.mark.parametrize("prefill_pkg,decode_pkg", [("jax", "port"),
                                                    ("port", "jax")])
def test_decode_pulls_across_packages(np_params, reference, prefill_pkg,
                                      decode_pkg):
    """A decode engine of one package pulls the chain a prefill engine of
    the other package serves, and continues as a single engine does."""
    pf = _engine(prefill_pkg, np_params, kv_role="prefill")
    pf.generate([PROMPT], _sp(prefill_pkg, 1))
    harness = _ServerHarness(
        pf, jtransfer if prefill_pkg == "jax" else ttransfer)
    try:
        decode = _engine(decode_pkg, np_params, kv_role="decode",
                         kv_transfer_config={"peer": harness.addr})
        try:
            out = decode.generate([PROMPT], _sp(decode_pkg, 6))[0]
            assert out.token_ids == reference
            assert decode.kv_peer.hits == N_FULL
            assert decode.kv_peer.fallbacks == 0
            assert decode._kv_restore_blocks_total == N_FULL
        finally:
            decode.shutdown()
    finally:
        harness.close()
        pf.shutdown()


def test_peer_only_engine_has_no_export_hooks(np_params):
    decode = _engine("port", np_params, kv_role="decode",
                     kv_transfer_config={"peer": "127.0.0.1:1"})
    try:
        assert decode.offload is not None
        assert decode.offload.tiers == []
        assert decode.block_manager.on_freed_cached is None
        assert decode.scheduler.kv_flush is None
    finally:
        decode.shutdown()


def test_pd_config_role_validation():
    def cfg(**kw):
        return EngineConfig(**BASE, **kw, device="cpu")

    with pytest.raises(ValueError, match="kv_role"):
        cfg(kv_role="producer")
    assert cfg(kv_role="both").pd_role() == "both"
    assert cfg(kv_transfer_config={"listen": ":8200"}).pd_role() == "prefill"
    assert cfg(kv_transfer_config={"peer": "h:8200"}).pd_role() == "decode"
    assert cfg(kv_transfer_config={"listen": ":8200", "peer": "h:8200"}
               ).pd_role() == "both"
    assert cfg().pd_role() is None
    for listen, peer in ((":8200", None), (None, "h:8200"),
                         (":8200", "h:8200"), (None, None)):
        tc = {"listen": listen, "peer": peer}
        assert cfg(kv_transfer_config=tc).pd_role() == JConfig(
            **BASE, kv_transfer_config=tc).pd_role()
    args = build_parser().parse_args([
        "--kv-role", "kv_consumer", "--kv-peer", "a:1,b:2",
        "--cpu-offload-gb", "0.5", "--disk-offload-dir", "/kv",
        "--remote-cache-url", "c:8100", "--kv-controller-url", "c:9000",
        "--kv-instance-id", "e:1", "--sync-kv-offload",
        "--kv-restore-wait-s", "0.5"])
    c = config_from_args(args)
    assert (c.kv_role, c.kv_transfer_config["peer"], c.cpu_offload_bytes,
            c.disk_offload_dir, c.remote_cache_url, c.kv_controller_url,
            c.kv_instance_id, c.sync_kv_offload, c.kv_restore_wait_s) == (
        "decode", "a:1,b:2", 2**29, "/kv", "c:8100", "c:9000", "e:1",
        True, 0.5)
    c = config_from_args(build_parser().parse_args(
        ["--kv-role", "kv_producer", "--kv-transfer-listen", ":0"]))
    assert c.pd_role() == "prefill"


def test_pd_router_e2e_equals_single_engine(np_params):
    """Two port EngineServers (prefill serving KV, decode pulling it)
    behind the JAX router's `pd` policy: the cold prompt splits (phase 1
    on the prefill engine, decode on the decode engine, which pulls the
    chain) and the text equals a single port engine's."""
    from aiohttp.test_utils import TestClient, TestServer

    from production_stack_tpu.router import parsers
    from production_stack_tpu.router.app import build_app
    from production_stack_tpu.router.routing_logic import (
        _reset_routing_logic,
    )
    from production_stack_tpu.router.service_discovery import (
        _probe_endpoint,
        _reset_service_discovery,
        get_service_discovery,
    )
    from production_stack_tpu.router.stats.health import (
        _reset_engine_health_board,
    )
    from production_stack_tpu_torch.engine.server import EngineServer

    prompt = (PROMPT + " and even more shared context to transfer!!") * 2
    body = {"prompt": prompt, "max_tokens": 6, "temperature": 0.0}

    def server(**kw):
        return EngineServer(EngineConfig(**BASE, **kw, device="cpu"),
                            params=params_from_numpy(np_params, "cpu"))

    async def completion(url, session_post):
        r = await session_post(f"{url}/v1/completions", json=body)
        assert r.status == 200
        return (await r.json())["choices"][0]["text"]

    async def run():
        import aiohttp

        _reset_routing_logic()
        _reset_service_discovery()
        _reset_engine_health_board()
        servers = []
        try:
            control = server()
            servers.append(control)
            cport = await control.start("127.0.0.1", 0)
            async with aiohttp.ClientSession() as s:
                want = await completion(f"http://127.0.0.1:{cport}", s.post)

            pf_srv = server(kv_role="prefill",
                            kv_transfer_config={"listen": "127.0.0.1:0"})
            servers.append(pf_srv)
            pf_url = f"http://127.0.0.1:{await pf_srv.start('127.0.0.1', 0)}"
            kv_port = pf_srv._kv_transfer_server.port
            assert kv_port
            dc_srv = server(kv_role="decode", kv_transfer_config={
                "peer": f"127.0.0.1:{kv_port}"})
            servers.append(dc_srv)
            dc_url = f"http://127.0.0.1:{await dc_srv.start('127.0.0.1', 0)}"
            probed = await _probe_endpoint(pf_url)
            assert probed is not None and probed[3] == "prefill"
            probed = await _probe_endpoint(dc_url)
            assert probed is not None and probed[3] == "decode"

            args = parsers.parse_args([
                "--service-discovery", "static",
                "--static-backends", f"{pf_url},{dc_url}",
                "--static-models", "pst-tiny-debug,pst-tiny-debug",
                "--static-model-labels", "prefill,decode",
                "--routing-logic", "pd",
                "--engine-stats-interval", "30",
                "--kv-controller-url", "",
            ])
            rclient = TestClient(TestServer(build_app(args).app))
            await rclient.start_server()
            try:
                roles = {e.url: e.role for e in
                         get_service_discovery().get_endpoint_info()}
                assert roles == {pf_url: "prefill", dc_url: "decode"}
                r = await rclient.post("/v1/completions", json=body)
                assert r.status == 200
                got = await r.json()
                assert got["choices"][0]["text"] == want
                pf_eng = pf_srv.engine.engine
                dc_eng = dc_srv.engine.engine
                assert pf_eng._finished_total == 1
                n_full = len(dc_eng.tokenizer.encode(prompt)) // 4
                assert dc_eng.kv_peer.hits == n_full
                assert dc_eng.kv_peer.fallbacks == 0
                assert dc_eng._kv_restore_blocks_total == n_full
            finally:
                await rclient.close()
        finally:
            # decode first: its PeerTier holds a connection to the
            # prefill engine's transfer server, whose stop waits for it
            for srv in reversed(servers):
                await srv.stop()
            _reset_routing_logic()
            _reset_service_discovery()
            _reset_engine_health_board()

    asyncio.run(run())
