"""The port's captured programs against the JAX runner's jitted ones, on
the CPU in float32.

The JAX runner jit-caches a program per bucket key for prefill, packed
prefill, the ragged round, verify, embed and KV import; the port builds
each as a program variant (engine/programs.py) of the same kind. On the
CPU a variant runs its function eagerly on its static buffers, so two
dispatches of one key go through the same closures and buffers a CUDA
graph captures on the card: a value a closure took at the first
dispatch would show at the second. Each kind is held to the JAX runner
across two dispatches of one key that differ in start positions, chunk
lengths within the bucket and block tables: greedy tokens equal, logits
and the KV written within 1e-5 relative.

Then the serving engine: after precompile_serving the mixed scenario
builds nothing; the fused loop, which no longer reads its `done` flag
back, gives the JAX engine's streams at K=8 with lanes stopping at
different iterations and every lane stopping before K; and a SIGTERM
mid-stream ends the stream with [DONE] and a clean exit, with the
engine's shutdown run, on the JAX CLI and the port's.

One JAX engine and one port engine serve the whole file (the runner
cases use their runners, on blocks at the top of the pool the engines'
requests never reach), plus one port runner without the ragged kernel
for the per-lane and composed layouts.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

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
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
CFG = dict(model="pst-tiny-debug", tokenizer="byte", dtype="float32",
           cache_dtype="float32", block_size=8, num_kv_blocks=256,
           max_num_seqs=4, max_prefill_chunk=16, max_prefill_seqs=4,
           max_model_len=64, num_scheduler_steps=8, seed=0)
GREEDY = dict(temperature=0.0, ignore_eos=True)
BS = CFG["block_size"]
# each runner case writes its own blocks from BASE: above what the
# engines' requests allocate (the sweeps' trash tables at the top of the
# pool come after the runner cases)
BASE = {"single": 96, "packed": 112, "ragged": 136, "verify": 176,
        "kv_import": 192}


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def engines(np_params):
    """(JAX engine on the gather path, port engine at its defaults: the
    ragged kernel's plain version, variants on static buffers)."""
    jeng = JEngine(JConfig(**CFG, attention_impl="xla"),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))
    teng = LLMEngine(EngineConfig(**CFG, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    return jeng, teng


@pytest.fixture(scope="module")
def composed(np_params):
    """A port runner without the ragged kernel: packed prefill on the
    per-lane layout, ragged rounds composed."""
    return ModelRunner(EngineConfig(**CFG, ragged_kernel=False,
                                    device="cpu"),
                       params=params_from_numpy(np_params, "cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * max(np.abs(want).max(), 1.0))


def _kv_close(tr, jr, blocks):
    """The KV both runners hold in `blocks`, within 1e-5 relative."""
    slots = np.concatenate([np.arange(b * BS, (b + 1) * BS)
                            for b in blocks])
    for t, j in ((tr.k_cache, jr.k_cache), (tr.v_cache, jr.v_cache)):
        want = np.asarray(j)[:, :, slots]
        np.testing.assert_allclose(
            t.numpy()[:, :, slots], want, rtol=0,
            atol=REL * max(np.abs(want).max(), 1.0))


def _ids(rng, n):
    return rng.randint(1, 200, size=n).tolist()


def _same_key_twice(tr, kind, first, second):
    """Run `first()` then `second()` on the port runner: the first builds
    one variant of `kind`, the second replays it."""
    before = tr.compile_events.get(kind, 0)
    out1 = first()
    assert tr.compile_events.get(kind, 0) == before + 1, kind
    out2 = second()
    assert tr.compile_events.get(kind, 0) == before + 1, kind
    return out1, out2


def _prefix(tr, jr, ids, table):
    """Write a prompt's first len(ids) positions on both runners."""
    tr.prefill(ids, 0, table, len(ids))
    jr.prefill(ids, 0, table, len(ids))


@pytest.mark.parametrize("plp", [False, True])
def test_single_prefill_variant_matches_jax(engines, plp):
    jeng, teng = engines
    jr, tr = jeng.runner, teng.runner
    rng = np.random.RandomState(1 + plp)
    base = BASE["single"] + 8 * plp
    t1, t2 = [base, base + 1], [base + 2, base + 3, base + 4]
    a, pre, b = _ids(rng, 11), _ids(rng, 5), _ids(rng, 9)
    _prefix(tr, jr, pre, t2)
    # (11 at 0, ctx 11) and (9 at 5, ctx 14): t_pad 16, c_pad 16 both
    calls = [(a, 0, t1, 11), (b, 5, t2, 14)]

    def kw(ids):
        return ({"prompt_lp_targets": ids[1:] + [7]} if plp else {})

    outs = _same_key_twice(
        tr, "prefill", *(lambda c=c: tr.prefill(*c, **kw(c[0]))
                         for c in calls))
    for c, got in zip(calls, outs):
        want = jr.prefill(*c, **kw(c[0]))
        assert int(got[0]) == int(np.asarray(want[0]))
        _close(got[1], want[1])
        if plp:
            n = len(c[0])
            _close(got[2][:n], np.asarray(want[2])[:n])
            _close(got[3][:n], np.asarray(want[3])[:n])
            np.testing.assert_array_equal(_np(got[4])[:n],
                                          np.asarray(want[4])[:n])
    _kv_close(tr, jr, t1 + t2)


@pytest.mark.parametrize("layout", ["rows", "per_lane"])
def test_packed_prefill_variant_matches_jax(engines, composed, layout):
    jeng, teng = engines
    jr = jeng.runner
    tr = teng.runner if layout == "rows" else composed
    kind = "prefill_rows" if layout == "rows" else "prefill_batch"
    rng = np.random.RandomState(3)
    base = BASE["packed"] + 12 * (layout == "per_lane")
    tabs1 = [[base], [base + 1, base + 2]]
    tabs2 = [[base + 3, base + 4], [base + 5, base + 6]]
    pre = _ids(rng, 4)
    _prefix(tr, jr, pre, tabs2[1])
    # rows: 2 lanes of <= 16 rows each -> 32 rows, pc 16; per lane: s 2,
    # t 16, c 16 — both dispatches
    calls = [([_ids(rng, 7), _ids(rng, 13)], [0, 0], tabs1, [7, 13]),
             ([_ids(rng, 12), _ids(rng, 9)], [0, 4], tabs2, [12, 13])]
    outs = _same_key_twice(tr, kind,
                           *(lambda c=c: tr.prefill_batch(*c)
                             for c in calls))
    for c, (tok, lg) in zip(calls, outs):
        jt, jl = jr.prefill_batch(*c)
        np.testing.assert_array_equal(_np(tok)[:2], np.asarray(jt)[:2])
        _close(lg[:2], np.asarray(jl)[:2])
    _kv_close(tr, jr, [b for t in tabs1 + tabs2 for b in t])


def _decode_kw(n):
    return (np.zeros(n, np.float32), np.ones(n, np.float32),
            np.full(n, -1, np.int32), np.zeros((n, 2), np.uint32))


@pytest.mark.parametrize("layout", ["rows", "composed"])
def test_ragged_step0_variant_matches_jax(engines, composed, layout):
    """Two mixed rounds of one step-0 key. On the ragged kernel the key
    is (rows, page count of the wider context bucket): the first round's
    prefill context is the wider, the second's decode one."""
    jeng, teng = engines
    jr = jeng.runner
    tr = teng.runner if layout == "rows" else composed
    kind = "ragged_rows" if layout == "rows" else "ragged"
    rng = np.random.RandomState(5)
    base = BASE["ragged"] + 20 * (layout == "composed")
    k = 4
    dec_tabs = [[base, base + 1], [base + 2, base + 3, base + 4, base + 5]]
    for n, tab in zip((5, 8), dec_tabs):
        _prefix(tr, jr, _ids(rng, n), tab)
    pf_tabs = [[base + 6, base + 7, base + 8, base + 9],
               [base + 10, base + 11]]
    _prefix(tr, jr, _ids(rng, 8), pf_tabs[0])
    _prefix(tr, jr, _ids(rng, 3), pf_tabs[1])

    def stop():
        return (np.full(2, -1, np.int32), np.zeros(2, np.int32),
                np.array([2, 4], np.int32), None)

    if layout == "rows":
        # 16 + 8 rows at pc 32 beside decode ctx 16, then 16 + 16 rows
        # at pc 16 beside decode ctx 32: 32 rows and 4 pages both
        calls = [
            ([_ids(rng, 14), _ids(rng, 6)], [8, 3], pf_tabs, [22, 9],
             [5, 7], [5, 8], dec_tabs, [6, 9]),
            ([_ids(rng, 9), _ids(rng, 10)], [0, 3], pf_tabs, [9, 13],
             [9, 4], [9, 17], dec_tabs, [10, 18]),
        ]
    else:
        # two lanes of <= 16 rows at pc 16: s 2, t 16, pc 16 both
        calls = [
            ([_ids(rng, 14), _ids(rng, 6)], [0, 3], pf_tabs, [14, 9],
             [5, 7], [5, 8], dec_tabs, [6, 9]),
            ([_ids(rng, 9), _ids(rng, 10)], [0, 3], pf_tabs, [9, 13],
             [9, 4], [9, 12], dec_tabs, [10, 13]),
        ]

    def go(runner, c):
        return runner.ragged_dispatch(*c, k, *_decode_kw(2), stop=stop())

    outs = _same_key_twice(tr, kind, *(lambda c=c: go(tr, c)
                                       for c in calls))
    for c, (pf_tok, pf_lg, ys) in zip(calls, outs):
        jt, jl, jys = go(jr, c)
        np.testing.assert_array_equal(_np(pf_tok)[:2], np.asarray(jt)[:2])
        _close(pf_lg[:2], np.asarray(jl)[:2])
        np.testing.assert_array_equal(_np(ys[0])[:, :2],
                                      np.asarray(jys[0])[:, :2])
        np.testing.assert_array_equal(_np(ys[-1])[:2],
                                      np.asarray(jys[-1])[:2])
    _kv_close(tr, jr, [b for t in pf_tabs for b in t])


@pytest.mark.parametrize("layout", ["rows", "composed"])
def test_verify_variant_matches_jax(engines, composed, layout):
    jeng, teng = engines
    jr = jeng.runner
    tr = teng.runner if layout == "rows" else composed
    rng = np.random.RandomState(7)
    base = BASE["verify"] + 8 * (layout == "composed")
    tabs1 = [[base, base + 1], [base + 2, base + 3]]
    tabs2 = [[base + 4, base + 5], [base + 6, base + 7]]
    for tab, n in zip(tabs1 + tabs2, (5, 9, 3, 11)):
        _prefix(tr, jr, _ids(rng, n), tab)

    def sampling(n):
        return (np.zeros(n, np.float32), np.ones(n, np.float32),
                np.full(n, -1, np.int32), np.zeros(n, np.float32),
                np.zeros(n, np.uint32), np.zeros(n, np.int64))

    # 2 lanes, chunks <= 8 rows, ctx <= 16: one key
    calls = [([_ids(rng, 4), _ids(rng, 3)], [5, 9], tabs1, [9, 12],
              sampling(2)),
             ([_ids(rng, 2), _ids(rng, 4)], [3, 11], tabs2, [5, 15],
              sampling(2))]
    outs = _same_key_twice(tr, "verify",
                           *(lambda c=c: tr.verify_batch(*c)
                             for c in calls))
    for c, got in zip(calls, outs):
        want = jr.verify_batch(*c)
        for s, ids in enumerate(c[0]):
            np.testing.assert_array_equal(got[s, :len(ids)],
                                          np.asarray(want)[s, :len(ids)])
    _kv_close(tr, jr, [b for t in tabs1 + tabs2 for b in t])


def test_kv_import_variant_matches_jax(engines):
    """Two imports of one (n_pad, n_pad) key: 3 of 4 staged columns, out
    of order, then all 4."""
    jeng, teng = engines
    jr, tr = jeng.runner, teng.runner
    mc = tr.model_config
    rng = np.random.RandomState(9)
    shape = (2, mc.num_layers, 4, mc.num_kv_heads, BS, mc.head_dim)
    base = BASE["kv_import"]
    calls = [([base, base + 1, base + 2], [2, 0, 3]),
             ([base + 3, base + 4, base + 5, base + 6], [0, 1, 2, 3])]
    datas = [rng.randn(*shape).astype(np.float32) for _ in calls]

    def imp(runner, data, bids, cols):
        if runner is tr:
            handle = runner.stage_import_blocks(torch.from_numpy(data))
        else:
            handle = runner.stage_import_blocks(data)
        runner.import_staged_blocks(bids, handle, cols)

    _same_key_twice(tr, "kv_import",
                    *(lambda d=d, c=c: imp(tr, d, *c)
                      for d, c in zip(datas, calls)))
    for d, c in zip(datas, calls):
        imp(jr, d, *c)
    _kv_close(tr, jr, calls[0][0] + calls[1][0])


def test_embed_variant_matches_jax(engines):
    """Two inputs of one (t_pad, c_pad) chunk key, then one of two
    chunks: the scratch is zeroed between calls."""
    jeng, teng = engines
    jr, tr = jeng.runner, teng.runner
    rng = np.random.RandomState(11)
    a, b, c = _ids(rng, 10), _ids(rng, 13), _ids(rng, 30)
    outs = _same_key_twice(tr, "embed", lambda: tr.embed(a),
                           lambda: tr.embed(b))
    for ids, got in zip((a, b), outs):
        _close(got, jr.embed(ids))
    _close(tr.embed(c), jr.embed(c))
    _close(tr.embed(a), outs[0])


# -- the engines ------------------------------------------------------------
def _staggered(eng, sp_cls, prompts, kws, arrive):
    """Requests arriving at the given steps (mixed rounds); returns the
    streams in order."""
    outs, step = {}, 0
    pending = sorted(zip(arrive, range(len(prompts))))
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= step:
            _, i = pending.pop(0)
            eng.add_request(f"r{i}", prompt_token_ids=prompts[i],
                            sampling_params=sp_cls(**kws[i]))
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.token_ids
        step += 1
        assert step < 2000, "engine wedged"
    return [outs[f"r{i}"] for i in range(len(prompts))]


PROMPTS = [[5 + (7 * j) % 190 for j in range(n)] for n in (19, 6, 33, 11)]


def test_mixed_scenario_after_precompile_builds_nothing(engines):
    """precompile_serving, then staggered prompts beside decoding lanes
    (mixed rounds at several row and context buckets, K up to 8): no
    compile event, and the JAX engine's streams."""
    jeng, teng = engines
    assert teng.precompile_serving() > 0
    before = dict(teng.runner.compile_events)
    assert {"prefill", "prefill_rows", "ragged_rows",
            "decode_multi"} <= set(before)
    kws = [dict(max_tokens=n, **GREEDY) for n in (20, 9, 14, 25)]
    arrive = [0, 0, 3, 7]
    want = _staggered(jeng, JSampling, PROMPTS, kws, arrive)
    got = _staggered(teng, SamplingParams, PROMPTS, kws, arrive)
    assert got == want
    assert teng.runner.compile_events == before


def _fused_rounds(eng, monkeypatch):
    """Record each fused round the engine applies: (K, its lanes' ids,
    their valid counts)."""
    rounds, apply = [], eng._apply_multi_tokens

    def spy(seqs, toks, k, lps=None, valid=None, round_attrs=None):
        rounds.append((k, [s.request_id for s in seqs],
                       None if valid is None
                       else [int(v) for v in valid[:len(seqs)]]))
        return apply(seqs, toks, k, lps=lps, valid=valid,
                     round_attrs=round_attrs)

    monkeypatch.setattr(eng, "_apply_multi_tokens", spy)
    return rounds


def test_loop_without_done_read_matches_jax(engines, monkeypatch):
    """K=8 rounds whose lanes stop at different iterations (max_tokens
    and a stop token id), and rounds where every lane stops before K:
    the JAX engine's streams, its fused rounds (K, lanes, valid counts)
    and its count of rounds that exited early (every lane frozen before
    K), no round past its largest lane budget, and every iteration it
    runs an eager forward here. Both engines serve the probe first, so
    both hold the prompts in their prefix caches and their scheduled
    rounds start from the same state."""
    jeng, teng = engines
    prompts = [p[::-1] for p in PROMPTS]
    kws = [dict(max_tokens=n, **GREEDY) for n in (3, 6, 13, 2)]
    probe = _staggered(jeng, JSampling, prompts, kws, [0, 0, 0, 0])
    assert _staggered(teng, SamplingParams, prompts, kws,
                      [0, 0, 0, 0]) == probe
    # a stop id the third lane samples at its fifth token
    kws[2] = dict(max_tokens=13, temperature=0.0,
                  stop_token_ids=[probe[2][4]])
    jrounds = _fused_rounds(jeng, monkeypatch)
    jexits = jeng.stats().decode_early_exit_rounds_total
    want = _staggered(jeng, JSampling, prompts, kws, [0, 0, 0, 0])
    jexits = jeng.stats().decode_early_exit_rounds_total - jexits
    assert len(want[2]) == 5
    runs = teng.runner.dispatch_counts
    before = dict(runs)
    fwd0 = int(teng.runner.loop_forwards)
    trounds = _fused_rounds(teng, monkeypatch)
    exits = teng.stats().decode_early_exit_rounds_total
    got = _staggered(teng, SamplingParams, prompts, kws, [0, 0, 0, 0])
    assert got == want
    assert trounds == jrounds
    assert jexits > 0
    assert teng.stats().decode_early_exit_rounds_total - exits == jexits
    rounds = (runs["decode_multi"] - before["decode_multi"]
              + runs["ragged"] - before["ragged"])
    iters = runs["decode_iterations"] - before["decode_iterations"]
    # the budgets (2, 5, 12, 1 after the prefill's token) cap the loop
    assert 0 < iters <= 8 * rounds
    # iteration 0 of a ragged round is its step-0 program's
    assert int(teng.runner.loop_forwards) - fwd0 == iters - (
        runs["ragged"] - before["ragged"])


# -- SIGTERM on the CLIs ----------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the CLI under a wrapper that says when LLMEngine.shutdown runs
CLI = """import sys
import {pkg}.engine.llm_engine as m
orig = m.LLMEngine.shutdown
def shutdown(self):
    print("SHUTDOWN_RAN", flush=True)
    orig(self)
m.LLMEngine.shutdown = shutdown
from {pkg}.engine.__main__ import main
main(sys.argv[1:])
"""


def _start_cli(pkg: str):
    port = _free_port()
    args = ["--model", "pst-tiny-debug", "--tokenizer", "byte",
            "--dtype", "float32", "--kv-cache-dtype", "float32",
            "--block-size", "4", "--num-kv-blocks", "256",
            "--host", "127.0.0.1", "--port", str(port)]
    if pkg.endswith("_torch"):
        args += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI.format(pkg=pkg)] + args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    lines: list[str] = []
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    return proc, port, lines


def _stream_and_sigterm(proc, port, out: dict) -> None:
    """Wait for the server, stream a completion and SIGTERM the process
    after its third event; record the events, the last one's
    finish_reason and whether [DONE] came."""
    deadline = time.monotonic() + 60
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                   timeout=1).read()
            break
        except OSError:
            assert time.monotonic() < deadline, "server did not start"
            time.sleep(0.1)
    body = json.dumps({"prompt": "hello", "max_tokens": 40,
                       "temperature": 0, "ignore_eos": True,
                       "stream": True}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=body,
        headers={"Content-Type": "application/json"})
    events, done, finish = 0, False, None
    with urllib.request.urlopen(req, timeout=60) as r:
        for raw in r:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
                break
            if line.startswith("data:"):
                events += 1
                finish = json.loads(line[5:])["choices"][0]["finish_reason"]
                if events == 3:
                    proc.send_signal(signal.SIGTERM)
    out.update(events=events, done=done, finish=finish)


def test_sigterm_finishes_streams_on_both_clis():
    """A stream SIGTERMed mid-way: the JAX CLI (aiohttp's run_app) and
    the port's (EngineServer.run) both stop listening, finish it with
    [DONE], run LLMEngine.shutdown and exit 0."""
    procs = {pkg: _start_cli(pkg)
             for pkg in ("production_stack_tpu", "production_stack_tpu_torch")}
    results = {pkg: {} for pkg in procs}
    try:
        threads = [threading.Thread(target=_stream_and_sigterm,
                                    args=(p, port, results[pkg]))
                   for pkg, (p, port, _) in procs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        for pkg, (p, _, lines) in procs.items():
            assert p.wait(30) == 0, (pkg, "".join(lines)[-2000:])
            # the whole stream: all 40 tokens, then [DONE]
            res = results[pkg]
            assert res["done"] and res["finish"] == "length", (pkg, res)
            assert res["events"] > 3, (pkg, res)
            assert any("SHUTDOWN_RAN" in ln for ln in lines), pkg
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
