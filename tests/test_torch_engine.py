"""The PyTorch port's LLMEngine against the JAX package's, both on the CPU
in the split configuration (--no-ragged-dispatch): split prefill/decode
rounds, single-step decode, no prefill pipeline. The same
JAX-initialised float32 weights go to both (carried across with
params_from_numpy); greedy token streams must be equal, token for token.
The unified ragged rounds and fused K-step decode are held to the JAX
engine in test_torch_ragged_rounds.py and test_torch_multistep.py.

The JAX engine runs its XLA gather path here (its Pallas kernels are held
against the port's plain versions in test_torch_paged_attention.py); the
port runs its plain versions, through the ragged kernel's seam and
through the composed prefill/decode kernels' (--no-ragged-kernel).
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
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops import paged_attention as tpa

BASE = dict(
    model="pst-tiny-debug", tokenizer="byte", dtype="float32",
    cache_dtype="float32", block_size=4, num_kv_blocks=128, max_num_seqs=4,
    max_prefill_chunk=16, seed=0, ragged_dispatch=False,
)


@pytest.fixture(scope="module")
def np_params():
    cfg = get_model_config("pst-tiny-debug")
    params = jllama.init_params(cfg, jax.random.key(0), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _prompts(case):
    rng = np.random.RandomState(3)
    if case == "single":
        return [[1, 5, 9, 200, 33, 7, 77, 120, 3, 250, 14]], {}
    if case == "chunked":  # 45 tokens: 3 chunks of <= 16
        return [rng.randint(0, 384, size=45).tolist()], {}
    if case == "packed":  # 4 concurrent prompts pack into one prefill
        return [rng.randint(0, 384, size=n).tolist()
                for n in (5, 17, 30, 9)], {}
    if case == "preempt":  # a tiny pool forces preemption mid-decode
        return [rng.randint(0, 384, size=24).tolist() for _ in range(2)], {
            "num_kv_blocks": 18, "enable_prefix_caching": False,
            "max_num_seqs": 2,
        }
    raise ValueError(case)


@pytest.mark.parametrize("case,ragged", [
    ("single", True), ("chunked", True), ("packed", True),
    ("packed", False), ("preempt", True), ("preempt", False),
])
def test_greedy_tokens_match_jax_engine(np_params, case, ragged):
    prompts, over = _prompts(case)
    n_tokens = 10
    jeng = JEngine(JConfig(
        **{**BASE, **over}, attention_impl="xla", prefill_pipeline=False,
        num_scheduler_steps=1,
    ), params=jax.tree_util.tree_map(jnp.asarray, np_params))
    want = [o.token_ids for o in jeng.generate(
        prompts, JSampling(max_tokens=n_tokens, temperature=0.0,
                           ignore_eos=True))]
    teng = LLMEngine(EngineConfig(**{**BASE, **over}, device="cpu",
                                  ragged_kernel=ragged),
                     params=params_from_numpy(np_params, "cpu"))
    got = teng.generate(prompts, SamplingParams(
        max_tokens=n_tokens, temperature=0.0, ignore_eos=True))
    assert [o.token_ids for o in got] == want
    assert all(o.finish_reason == "length" for o in got)
    if case == "packed":
        assert teng.runner.dispatch_counts["prefill_batch"] >= 1
    if case == "preempt":
        assert teng.stats().num_preemptions_total > 0
    # CPU tensors ran the plain versions: no kernel launched
    assert tpa.launch_counts() == {"decode": 0, "prefill": 0, "ragged": 0}


def test_stop_and_stats_match_jax_engine(np_params):
    """Stop tokens and the /metrics counters follow the JAX engine."""
    prompt = [[10, 20, 30, 40, 50, 60]]
    jeng = JEngine(JConfig(**BASE, attention_impl="xla",
                           prefill_pipeline=False),
                   params=jax.tree_util.tree_map(jnp.asarray, np_params))
    [free] = jeng.generate(prompt, JSampling(max_tokens=6, temperature=0.0,
                                             ignore_eos=True))
    stop_at = free.token_ids[2]
    kw = dict(max_tokens=6, temperature=0.0, stop_token_ids=[stop_at])
    [j] = jeng.generate(prompt, JSampling(**kw))
    teng = LLMEngine(EngineConfig(**BASE, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    [t] = teng.generate(prompt, SamplingParams(**kw))
    assert t.token_ids == j.token_ids and t.finish_reason == j.finish_reason
    st = teng.stats()
    assert st.prompt_tokens_total == len(prompt[0])
    assert st.generation_tokens_total == len(t.token_ids)
    assert st.requests_finished_total == 1
    assert st.num_running == st.num_waiting == 0


def test_seeded_sampling_is_reproducible(np_params):
    teng = LLMEngine(EngineConfig(**BASE, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    sp = SamplingParams(max_tokens=8, temperature=0.9, top_p=0.9, top_k=50,
                        seed=1234, ignore_eos=True)
    a = teng.generate([[1, 2, 3, 4, 5]], sp)[0].token_ids
    b = teng.generate([[1, 2, 3, 4, 5]], sp)[0].token_ids
    assert a == b and len(a) == 8


@pytest.mark.parametrize("field,value", [
    ("precompile_serving", True), ("long_prefill_threshold", 1024),
    ("ragged_kernel", False),  # the composed-kernel ragged round
    ("disk_offload_dir", "kv-offload"), ("async_decode", True),
    ("tensor_parallel_size", 2),
    ("pipeline_parallel_size", 2), ("multihost", True),
    ("num_speculative_tokens", 2), ("cpu_offload_bytes", 1 << 20),
    ("remote_cache_url", "127.0.0.1:1"), ("model", "pst-tiny-moe-debug"),
])
def test_unported_flags_refuse_to_start(field, value):
    """On the default (unified ragged round) configuration."""
    with pytest.raises(NotImplementedError,
                       match="--no-ragged-dispatch" if field == "ragged_kernel"
                       else field):
        EngineConfig(**{**BASE, "ragged_dispatch": True, field: value},
                     device="cpu")


def test_unported_request_fields_refuse(np_params):
    teng = LLMEngine(EngineConfig(**BASE, device="cpu"),
                     params=params_from_numpy(np_params, "cpu"))
    for sp in (SamplingParams(prompt_logprobs=1),
               SamplingParams(guided_choice=["a", "b"])):
        with pytest.raises(NotImplementedError):
            teng.add_request("r", prompt_token_ids=[1, 2], sampling_params=sp)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(EngineConfig(**BASE, device="cuda"))


@pytest.mark.parametrize("over,match", [
    ({}, "head_dim"),  # pst-tiny-debug: head_dim 16
    ({"model": "llama-3.2-3b", "block_size": 4}, "block_size"),
    ({"model": "llama-3.2-3b", "block_size": 256}, "block_size"),
])
def test_card_refuses_unbuilt_kernel_shapes_at_boot(monkeypatch, over,
                                                    match):
    """On the card, a model or block size the prefill and decode kernels
    are not built for refuses when the engine starts, before any weight
    or cache is allocated, not at the first request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "Generator", _Booted.stop)
    with pytest.raises(ValueError, match=f"cannot run on the card.*{match}"):
        LLMEngine(EngineConfig(**{**BASE, **over}, device="cuda"))


def test_card_boot_checks_decode_heads_only_without_ragged_kernel(
        monkeypatch):
    """The decode kernel (one 16-row MMA tile of query heads per kv head)
    serves only --no-ragged-kernel, so only then does the head count
    refuse."""
    from production_stack_tpu_torch.engine import model_runner
    from production_stack_tpu_torch.models.config import get_model_config

    wide = dataclasses.replace(get_model_config("llama-3.2-3b"),
                               num_heads=24 * 3, num_kv_heads=2)
    monkeypatch.setattr(EngineConfig, "model_config", lambda self: wide)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "Generator", _Booted.stop)
    cfg = {**BASE, "block_size": 32, "device": "cuda"}
    with pytest.raises(ValueError, match="query heads per kv head, got 36"):
        model_runner.ModelRunner(EngineConfig(**cfg, ragged_kernel=False))
    with pytest.raises(_Booted):
        model_runner.ModelRunner(EngineConfig(**cfg))


class _Booted(Exception):
    """Raised in place of the weights' random init: the boot checks
    passed."""

    @staticmethod
    def stop(*args, **kwargs):
        raise _Booted
