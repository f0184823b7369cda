"""The port's multi-host job against the JAX package's.

Two OS processes (tests/torch_multihost_worker.py) join one job on a
loopback TCPStore and hold a tp=4 rank set between them, two CPU ranks a
process over gloo: process 0 runs the engine with the broadcasting
runner, process 1 runs its ranks as followers. The model, engine config
and prompts are tests/multihost_worker.py's; the weights the JAX ones.
Greedy tokens (with n-gram spec decode on the port's side, as the JAX
worker runs) equal the JAX single-process tp=4 engine's without it, and
the embedding equals that engine's within 1e-5 (summation order
differs). Also: validate_multihost_config's messages, initialize's
refusal of a job that cannot join, the follower's exit when process 0
is killed, and make_multihost_mesh's cases.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.multihost_engine import (
    validate_multihost_config as j_validate,
)
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import config as jmcfg
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel import multihost as jmultihost
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.multihost_engine import (
    validate_multihost_config,
)
from production_stack_tpu_torch.parallel import multihost

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_multihost_worker.py")
CFG = jmcfg.ModelConfig(
    name="pst-mh-test-port", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=8, num_kv_heads=4,
    head_dim=8, max_model_len=128, rope_theta=10000.0,
    tie_word_embeddings=True,
)
PROMPTS = [[1, 2, 3, 1, 2, 3, 1], [9, 8, 7, 9, 8, 7, 9]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The JAX params (key 0) as a flat npz the workers read."""
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(CFG, jax.random.key(0), jnp.float32))
    flat = {}

    def walk(tree, pre):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                flat[pre + k] = v

    walk(params, "")
    path = tmp_path_factory.mktemp("mh") / "params.npz"
    np.savez(path, **flat)
    return str(path), params


def _start(npz_path: str, port: int, *extra) -> list[subprocess.Popen]:
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, WORKER, str(pid), str(port), npz_path, *extra],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for pid in (0, 1)]


def _jax_tp4(params) -> tuple[list, np.ndarray]:
    """tests/test_multihost_engine.py's single-process tp=4 reference:
    greedy tokens of PROMPTS, and the embedding of "hello"."""
    jmcfg._PRESETS[CFG.name] = CFG
    try:
        eng = JEngine(JConfig(
            model=CFG.name, tokenizer="byte", dtype="float32",
            cache_dtype="float32", block_size=4, num_kv_blocks=64,
            max_num_seqs=2, max_prefill_chunk=16, tensor_parallel_size=4,
            seed=0), params=jax.tree_util.tree_map(jnp.asarray, params))
        outs = eng.generate(PROMPTS, JSampling(
            max_tokens=4, temperature=0.0, ignore_eos=True))
        vec, _ = eng.embed_one("hello")
    finally:
        jmcfg._PRESETS.pop(CFG.name, None)
    return [o.token_ids for o in outs], vec


def test_two_process_engine_matches_jax_single_process_tp4(npz):
    procs = _start(npz[0], _free_port())
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n---\n".join(outs)
    (line,) = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")]
    result = json.loads(line[len("RESULT "):])
    tokens, vec = _jax_tp4(npz[1])
    # spec decode and an embedding rode the broadcast to every rank of
    # both processes (the follower process exited 0 after the shutdown)
    assert result["tokens"] == tokens
    assert result["spec_drafts"] > 0
    np.testing.assert_allclose(result["embed"], vec, rtol=1e-5, atol=1e-5)
    ranks = result["ranks"]
    assert [r for r, _ in ranks] == [0, 1, 2, 3]
    assert all(c == ranks[0][1] for _, c in ranks)
    assert ranks[0][1]["verify_batch"] > 0


def test_follower_exits_nonzero_when_process0_is_killed(npz):
    """Process 0 killed while serving: process 1 (its rank and its
    spawned one) exits non-zero within a few POLL_S, never hangs."""
    procs = _start(npz[0], _free_port(), "hold")
    try:
        lines = []
        for ln in procs[0].stdout:
            lines.append(ln)
            if ln.startswith("SERVING"):
                break
        else:
            pytest.fail("".join(lines))
        procs[0].send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        out = procs[1].communicate(timeout=60)[0]
        waited = time.monotonic() - t0
        assert procs[1].returncode not in (0, None), out
        assert waited < 5 * multihost.POLL_S + 5, waited
        assert "rank 0 is gone" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.mark.parametrize("over", [
    {}, {"enable_lora": True}, {"cpu_offload_bytes": 2**20},
    {"disk_offload_dir": "/nonexistent"},
    {"remote_cache_url": "127.0.0.1:1"}, {"kv_role": "decode"},
    {"enable_lora": True, "kv_role": "prefill", "cpu_offload_bytes": 1},
    {"num_speculative_tokens": 4},
], ids=lambda o: "-".join(o) or "plain")
def test_validate_multihost_config_messages_equal_jax(over):
    errs = []
    for validate, cfg in (
            (j_validate, JConfig(multihost=True, **over)),
            (validate_multihost_config,
             EngineConfig(device="cpu", multihost=True, **over))):
        try:
            validate(cfg)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (over in ({}, {"num_speculative_tokens": 4}))


@pytest.mark.parametrize("kw,why", [
    (dict(num_processes=2, process_id=1, timeout_s=2), "connect"),
    (dict(num_processes=2, process_id=0, timeout_s=2), "timeout"),
    (dict(num_processes=2, process_id=None), "process_id"),
    (dict(num_processes=None, process_id=0), "num_processes"),
], ids=["no-host", "peer-missing", "no-id", "no-count"])
def test_initialize_raises_on_an_explicit_job_that_cannot_join(
        monkeypatch, kw, why):
    """An explicit job (a coordinator address) that cannot join raises,
    naming why, and leaves the process single-host; it never falls back
    silently."""
    monkeypatch.setattr(multihost, "_JOB", None)
    with pytest.raises(RuntimeError, match="explicitly configured") as e:
        multihost.initialize(f"127.0.0.1:{_free_port()}", **kw)
    assert why.lower() in str(e.value).lower()
    assert multihost.job() is None and not multihost.is_multihost()


def test_initialize_without_a_job_is_single_host(monkeypatch):
    monkeypatch.setattr(multihost, "_JOB", None)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    multihost.initialize()
    assert (multihost.process_index(), multihost.process_count(),
            multihost.is_multihost()) == (0, 1, False)


def test_coordinator_address_from_the_environment(monkeypatch):
    """COORDINATOR_ADDRESS makes a job explicit, as in JAX: without the
    process count it raises."""
    monkeypatch.setattr(multihost, "_JOB", None)
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    with pytest.raises(RuntimeError, match="num_processes"):
        multihost.initialize(process_id=0)


def test_make_multihost_mesh_cases_equal_jax():
    """JAX's (dp, tp) cases on its 8 devices: tp groups contiguous in
    rank order, the dp axis across them; the same refusal."""
    jmultihost.initialize()  # single-host no-op
    devs = jax.devices()
    mesh = jmultihost.make_multihost_mesh(tp=4, dp=2)
    got = multihost.make_multihost_mesh(4, 2, ranks=len(devs))
    assert np.asarray(got).shape == mesh.devices.shape
    ids = {d: i for i, d in enumerate(devs)}
    assert got == [[ids[d] for d in row] for row in mesh.devices]
    for tp, dp in ((3, 2), (8, 2)):
        with pytest.raises(ValueError) as want:
            jmultihost.make_multihost_mesh(tp=tp, dp=dp)
        with pytest.raises(ValueError) as mine:
            multihost.make_multihost_mesh(tp, dp, ranks=len(devs))
        assert str(mine.value) == str(want.value)
