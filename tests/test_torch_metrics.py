"""The port's /metrics against the router's scrape contract and the JAX
package's metrics module, on the CPU.

- A CPU port engine serves over loopback; the router's own parser
  (router/stats/engine_stats.py, EngineStats.from_prometheus_text) reads
  its /metrics. After one prompt sent twice, the prefix-cache hits,
  queries and hit rate equal the JAX engine's block manager numbers on
  the same prompts, and the scheduling-delay count equals the finished
  requests.
- Every request finish is observed, streamed or not, on both endpoints.
- engine/metrics.py renders every family it exports with the name, type,
  label names, histogram buckets and values prometheus_client writes for
  the JAX module (production_stack_tpu/engine/metrics.py) fed the same
  snapshot and the same finished requests.
"""

import asyncio
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.metrics import EngineMetrics as JMetrics
from production_stack_tpu.engine.outputs import (
    EngineStatsSnapshot as JSnapshot,
)
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import get_model_config
from production_stack_tpu.router.stats.engine_stats import EngineStats
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.metrics import EngineMetrics
from production_stack_tpu_torch.engine.outputs import EngineStatsSnapshot
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

CFG = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=4, num_kv_blocks=256,
           max_num_seqs=4, max_prefill_chunk=32, seed=0)
PROMPT = np.random.RandomState(31).randint(1, 250, size=22).tolist()
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def port(np_params):
    server = EngineServer(EngineConfig(**CFG, device="cpu"),
                          params=params_from_numpy(np_params, "cpu"))
    loop = asyncio.new_event_loop()
    box = []
    ready = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        box.append(loop.run_until_complete(server.start("127.0.0.1", 0)))
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(60)
    yield box[0]
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    th.join(30)


def call(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def scrape(port):
    text = call(port, "/metrics")[1]
    samples = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            samples[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return EngineStats.from_prometheus_text(text), samples


def test_router_reads_prefix_hits_and_scheduling_delay(port, np_params):
    """One prompt sent twice: the router reads the port's prefix-cache
    hits, queries and hit rate — equal to the JAX engine's on the same
    prompts — and one scheduling delay per finished request."""
    for _ in range(2):
        st, body = call(port, "/v1/completions",
                        {"prompt": PROMPT, **GREEDY})
        assert st == 200
        assert json.loads(body)["usage"]["completion_tokens"] == 6
    stats, _ = scrape(port)
    jeng = JEngine(JConfig(**CFG, attention_impl="xla"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))
    for _ in range(2):
        jeng.generate([PROMPT], JSampling(**GREEDY))
    bm = jeng.block_manager
    assert bm.prefix_hits > 0
    assert stats.gpu_prefix_cache_hits_total == bm.prefix_hits
    assert stats.gpu_prefix_cache_queries_total == bm.prefix_queries
    assert stats.gpu_prefix_cache_hit_rate == pytest.approx(
        bm.prefix_hits / bm.prefix_queries)
    assert stats.scheduling_delay_count == 2
    assert stats.scheduling_delay_sum >= 0.0
    assert stats.num_running_requests == stats.num_queuing_requests == 0


@pytest.mark.parametrize("path,stream", [
    ("/v1/completions", False), ("/v1/completions", True),
    ("/v1/chat/completions", False), ("/v1/chat/completions", True),
])
def test_every_finish_is_observed(port, path, stream):
    """Streamed or not, completions or chat: the finish lands in
    vllm:request_success, the TTFT / e2e / queue / scheduling-delay
    histograms, and (more than one token) the TPOT histogram."""
    _, before = scrape(port)
    body = dict(GREEDY, stream=stream)
    if path.endswith("chat/completions"):
        body["messages"] = [{"role": "user", "content": "hello"}]
    else:
        body["prompt"] = "hello there"
    assert call(port, path, body)[0] == 200
    _, after = scrape(port)
    lab = (("model_name", "pst-tiny-debug"),)
    ok = ("vllm:request_success_total",
          (("finished_reason", "length"),) + lab)
    assert after[ok] == before.get(ok, 0.0) + 1
    for name in ("vllm:time_to_first_token_seconds",
                 "vllm:e2e_request_latency_seconds",
                 "vllm:time_per_output_token_seconds",
                 "tpu:request_queue_seconds", "tpu:scheduling_delay_seconds"):
        key = (f"{name}_count", lab)
        assert after[key] == before[key] + 1, name


def _families(text):
    """{family: (type, {(sample name, label names, le): value})}, without
    prometheus_client's _created samples."""
    out = {}
    for fam in text_string_to_metric_families(text):
        samples = {}
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            key = (s.name, tuple(sorted(k for k in s.labels if k != "le")),
                   s.labels.get("le"))
            samples[key] = s.value
        out[fam.name] = (fam.type, samples)
    return out



def test_families_match_the_jax_module():
    """The same snapshot and finished requests through both modules:
    every family the port exports exists in the JAX module's output with
    the same type, sample names, label names, buckets and values, and
    every family of the JAX module is exported by the port (except
    prometheus_client's _created gauges), the long-prefill lane's
    tpu:long_prefill_* and tpu:prefill_{ring,ring_d2h,kv_land,
    overflow_export}_seconds families included."""
    fields = dict(
        num_running=3, num_waiting=2, kv_usage=0.25,
        prefix_cache_queries=40, prefix_cache_hits=12,
        prompt_tokens_total=300, generation_tokens_total=77,
        num_preemptions_total=1, requests_finished_total=5,
        spec_draft_tokens_total=64, spec_accepted_tokens_total=23,
        prefill_prep_seconds_total=0.5, prefill_h2d_seconds_total=0.125,
        prefill_dispatch_seconds_total=2.0,
        prefill_fetch_seconds_total=0.75, prefill_staged_hits_total=4,
        prefill_staged_misses_total=1, prefill_chained_chunks_total=6,
        long_prefill_requests_total=2, long_prefill_chunks_total=16,
        long_prefill_fallbacks_total=1,
        long_prefill_ring_seconds_total=3.25,
        long_prefill_d2h_seconds_total=0.5,
        long_prefill_land_seconds_total=0.125,
        long_prefill_overflow_seconds_total=0.0625,
        decode_rounds_total=9, decode_overshoot_tokens_total=0,
        decode_early_exit_rounds_total=2, ragged_rounds_total=3,
        ragged_split_rounds_total=1,
        kv_export_blocks_total=46, kv_restore_blocks_total=40,
        kv_restore_fallbacks_total=1, kv_export_sync_fallbacks_total=2,
        kv_peer_hits_total=34, kv_peer_misses_total=3,
        kv_peer_read_bytes_total=34 << 20, kv_peer_fallbacks_total=1,
        kv_remote_hits_total=12, kv_remote_misses_total=5,
        kv_remote_read_bytes_total=12 << 20,
        kv_remote_write_bytes_total=50 << 20, kv_remote_flushes_total=4,
        kv_remote_fallbacks_total=1,
        compile_events_total=9,
        compile_events={"decode": 3, "decode_multi": 6},
        kv_tier_counters={
            "cpu": {"hits": 7, "misses": 2, "read_bytes": 7 << 20,
                    "write_bytes": 20 << 20},
            "disk": {"hits": 1, "misses": 1, "read_bytes": 1 << 20,
                     "write_bytes": 9 << 20},
            "peer": {"hits": 34, "read_bytes": 34 << 20},
        },
    )
    kv_obs = ([0.004, 0.03, 1.7], [0.02, 0.0009])
    ks = [8, 8, 4, 2, 8, 1, 8, 4, 8]
    finishes = [
        ("length", 0.03, 0.9, 12, 0.001, 0.002, None),
        ("stop", 0.5, 3.2, 40, 0.2, 0.01, 1.5),
        ("length", None, 0.04, 1, None, None, None),
    ]
    lane_mix = [1, 3, 1, 8, 2]
    mine = EngineMetrics("m")
    mine.observe_kv(*kv_obs)
    mine.observe_ragged(lane_mix)
    for f in finishes:
        mine.observe_request(*f[:4], queue_s=f[4], sched_delay_s=f[5],
                             preempt_stall_s=f[6])
    hist = {}
    for k in ks:
        hist[k] = hist.get(k, 0) + 1
    got = _families(mine.render(EngineStatsSnapshot(**fields,
                                                    decode_k_hist=hist)))
    reg = CollectorRegistry()
    ref = JMetrics("m", registry=reg)
    ref.update_from_snapshot(JSnapshot(**fields))
    ref.observe_decode_k(ks)
    ref.observe_kv(*kv_obs)
    ref.observe_ragged(lane_mix)
    for f in finishes:
        ref.observe_request(*f[:4], queue_s=f[4], sched_delay_s=f[5],
                            preempt_stall_s=f[6])
    want = _families(generate_latest(reg).decode())
    assert len(got) == 61
    missing = sorted(name for name in want
                     if name not in got and not name.endswith("_created"))
    assert missing == []
    for name, (kind, samples) in got.items():
        assert name in want, name
        assert kind == want[name][0], name
        assert samples.keys() == want[name][1].keys(), name
        for key, value in samples.items():
            assert value == pytest.approx(want[name][1][key]), (name, key)
    for name in ("vllm:gpu_prefix_cache_hit_rate",
                 "vllm:gpu_prefix_cache_hits_total",
                 "vllm:gpu_prefix_cache_queries_total",
                 "tpu:scheduling_delay_seconds", "tpu:kv_tier_hits",
                 "tpu:kv_restore_seconds", "tpu:kv_restore_fallbacks",
                 "tpu:kv_export_sync_fallbacks", "tpu:ragged_lane_mix",
                 "vllm:spec_decode_num_draft_tokens",
                 "vllm:spec_decode_num_accepted_tokens",
                 "tpu:compile_events", "tpu:hbm_kv_cache_usage_perc",
                 "tpu:long_prefill_requests", "tpu:long_prefill_chunks",
                 "tpu:long_prefill_fallbacks", "tpu:prefill_ring_seconds",
                 "tpu:prefill_ring_d2h_seconds",
                 "tpu:prefill_kv_land_seconds",
                 "tpu:prefill_overflow_export_seconds"):
        assert name in got


def test_ragged_lane_mix_matches_jax_engine(np_params):
    """tpu:ragged_lane_mix: a port engine and a JAX engine at their
    defaults (unified ragged rounds, K=4) on the same staggered arrivals
    drain the same prefill-lane count a fused round, and the port's
    histogram renders as the JAX module's does from the JAX engine's."""
    cfg = {**CFG, "num_scheduler_steps": 4, "max_prefill_chunk": 8}
    jeng = JEngine(JConfig(**cfg, attention_impl="xla"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    peng = LLMEngine(EngineConfig(**cfg, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 250, size=n).tolist() for n in (5, 29, 13)]

    def drive(eng, sp_cls):
        for step in range(400):
            if step < len(prompts):
                eng.add_request(f"r{step}", prompt_token_ids=prompts[step],
                                sampling_params=sp_cls(**GREEDY))
            elif not eng.has_unfinished():
                break
            eng.step()
        return eng.drain_ragged_observations()

    want = drive(jeng, JSampling)
    got = drive(peng, SamplingParams)
    assert got == want and len(got) > 0
    assert peng.drain_ragged_observations() == []  # drained
    mine = EngineMetrics("m")
    mine.observe_ragged(got)
    reg = CollectorRegistry()
    JMetrics("m", registry=reg).observe_ragged(want)
    fam = _families(mine.render(EngineStatsSnapshot()))["tpu:ragged_lane_mix"]
    assert fam == _families(generate_latest(reg).decode())[
        "tpu:ragged_lane_mix"]
