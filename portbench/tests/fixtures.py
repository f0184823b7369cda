"""A fixture benchmark in a temporary directory: a tiny configuration of
either family, a small session mix, one cell and one metric of its own,
laid out as the real benchmark is, beside the real metric readers."""

import json
import shutil
from pathlib import Path

# the widths of the port's pst-tiny-debug preset
TINY_HF = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 384,
    "max_position_embeddings": 256, "rope_theta": 10000.0,
    "tie_word_embeddings": False,
}
FAMILIES = {
    # pst-tiny-debug itself: Llama, tied embeddings
    "pst-tiny-debug": {"architectures": ["LlamaForCausalLM"],
                       "rms_norm_eps": 1e-5, "tie_word_embeddings": True},
    "mistral": {"architectures": ["MistralForCausalLM"],
                "rms_norm_eps": 1e-5, "sliding_window": None},
    "qwen2": {"architectures": ["Qwen2ForCausalLM"], "rms_norm_eps": 1e-6,
              "use_sliding_window": False},
}
MIX = {"loop": "open", "session_rate_per_s": 6.0,
       "shared_prefix_tokens": 48, "history_tokens": 32,
       "turns": {"dist": "uniform_int", "lo": 2, "hi": 3},
       "user_tokens": {"dist": "uniform_int", "lo": 8, "hi": 32},
       "answer_tokens": {"dist": "uniform_int", "lo": 8, "hi": 24},
       "think_s": {"dist": "exponential", "mean": 0.1}, "block": 8}
METRIC = '''"""A fixture metric: requests whose first token came in the window."""


def read(run):
    return float(sum(1 for r in run.requests
                     if r.first_token_s is not None
                     and run.t_open <= r.first_token_s < run.t_close))
'''


# a short warm-up for the tiny engine (harness.WARMUP is sized for the card)
WARMUP = {"min_s": 1.0, "stable_s": 0.5, "max_s": 4.0, "answer_tokens": 8}


def tiny_hf(family: str) -> dict:
    return {**TINY_HF, **FAMILIES[family]}


def make(tmp: Path, checkout: Path, family: str = "qwen2",
         dtype: str = "float32", limit: float = 1e-3) -> str:
    """Writes the fixture benchmark under `tmp`; returns its cell name."""
    pb = tmp / "portbench"
    shutil.copytree(checkout / "portbench" / "metrics", pb / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "metrics" / "fixture_first_tokens.py").write_text(METRIC)
    for d in ("configs", "workloads", "traffic"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    cfg = f"tiny-{family}"
    cell = f"{cfg}.fixture-chat"
    (pb / "configs" / f"{cfg}.json").write_text(json.dumps({
        "name": cfg, "source": "fixture", "hf_config": tiny_hf(family),
        "dtype": dtype, "reduced": [], "assumed": {},
        "engine": {"dtype": dtype, "cache_dtype": dtype,
                   "max_model_len": 256, "num_scheduler_steps": 8,
                   "num_kv_blocks": 192, "tokenizer": "byte"}}))
    (pb / "traffic" / "fixture-chat.json").write_text(json.dumps(MIX))
    (pb / "workloads" / f"{cell}.json").write_text(json.dumps({
        "engine": {"max_num_seqs": 8},
        "ramp": {"s": 1.0, "quiet_s": 0.5, "max_s": 3.0},
        "trace_span_s": 0.5,
        "limits": {"max_logit_gap": limit}}))
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": cfg, "source": "fixture",
                         "file": f"portbench/configs/{cfg}.json",
                         "reduced": [], "why": "fixture"}]
    bench["workloads"] = [{"name": cell, "config": cfg,
                           "traffic": "fixture-chat", "chips": 1,
                           "why": "fixture"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"].append({
        "name": "fixture_first_tokens", "unit": "requests",
        "better": "higher", "source": "host_clock", "layer": "fixture",
        "moves": "ttft_p95_ms", "workloads": [cell]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell
