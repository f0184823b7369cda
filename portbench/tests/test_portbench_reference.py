"""The plain reference against the port's own CPU forward, at tiny
widths, for both families (Qwen2's qkv bias included): the port's
engine serves greedy tokens with their log-probabilities, prefill then
decode through its paged cache, and the reference reads the same
sequences in one pass."""

import pytest
import torch

from portbench.harness import model_dir
from portbench.manifest import Layout
from portbench.reference import model as ref_model
from portbench.reference.control import fp8_weight
from portbench.tests import fixtures
from portbench.weights import make_params


@pytest.mark.parametrize("family", ["mistral", "qwen2"])
def test_reference_matches_port_forward(tmp_path, checkout, family):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.llm_engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling_params import (
        SamplingParams,
    )

    torch.set_num_threads(2)
    cell = fixtures.make(tmp_path, checkout, family)
    lay = Layout(tmp_path)
    config = lay.config(lay.workload(cell)["config"])
    hf = config["hf_config"]
    params = make_params(hf, 99, "cpu", torch.float32)
    if family == "qwen2":
        assert params["layers"]["bq"].abs().max() > 0
    else:
        assert "bq" not in params["layers"]
    eng = LLMEngine(EngineConfig(
        model=str(model_dir(lay, config)), device="cpu", dtype="float32",
        cache_dtype="float32", tokenizer="byte", num_kv_blocks=64,
        max_model_len=512, num_scheduler_steps=8, max_num_seqs=4),
        params=params)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, hf["vocab_size"], (n,), generator=g).tolist()
               for n in (5, 40, 75)]
    outs = eng.generate(prompts, SamplingParams(
        max_tokens=20, temperature=0.0, ignore_eos=True, logprobs=1))
    for p, out in zip(prompts, outs):
        toks = out.token_ids
        seq = torch.tensor(p + toks[:-1])
        rows = torch.arange(len(p) - 1, len(p) - 1 + len(toks))
        ref = ref_model.logits(hf, params, seq, rows).log_softmax(-1)
        served = torch.tensor(toks)
        assert torch.equal(ref.argmax(-1), served)
        got = torch.tensor([e["logprob"] for e in out.logprobs])
        want = ref.gather(1, served[:, None])[:, 0]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_control_is_a_coarser_rounding():
    w = torch.randn(256, 64)
    q = fp8_weight(w)
    rel = ((q - w).norm() / w.norm()).item()
    bf = ((w.bfloat16().float() - w).norm() / w.norm()).item()
    # e4m3 keeps 3 mantissa bits, bf16 7
    assert 4 * bf < rel < 0.1
    # one scale per output column: a column scaled up rounds alike
    w2 = w.clone()
    w2[:, 3] *= 1000
    torch.testing.assert_close(fp8_weight(w2)[:, 3] / 1000, q[:, 3])
