"""Model architecture configs for the Llama-class decoder family.

One config dataclass covers Llama 2/3, Mistral, Qwen2 (qkv bias), Mixtral
(MoE), Phi-3 (fused qkv/gate_up), Gemma (GeGLU + zero-centered norms +
scaled embeddings), and TinyLlama variants — the family the reference stack's tutorials deploy (Llama-3.1-8B in
reference: tutorials/08-benchmark-multi-round-qa-multi-gpu.md, opt-125m-sized
configs for CI-scale tests).

Presets are resolvable by name so the engine can run weight-free (random init)
for benchmarks and tests; `from_hf_config` maps a HuggingFace config.json so
real checkpoints load when present on disk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_model_len: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    qkv_bias: bool = False  # Qwen2-style attention bias
    # family knobs beyond the Llama defaults:
    hidden_act: str = "silu"  # "gelu_tanh" for the Gemma family
    norm_weight_offset: float = 0.0  # Gemma stores RMSNorm w zero-centered
    embed_scale: float = 1.0  # Gemma scales embeddings by sqrt(hidden)
    # sliding-window attention (Phi-3-mini, Mistral-v0.1): each token
    # attends to at most this many predecessors; None = full context.
    # Served on the XLA attention path (the paged kernels are
    # full-context); parity-tested against transformers beyond the window
    sliding_window: int | None = None
    # MoE (Mixtral family): 0 experts = dense MLP. capacity_factor 0
    # selects the exact all-experts einsum path; > 0 the GShard
    # static-capacity dispatch (ops/moe.py)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 0.0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_params(self) -> int:
        """Approximate parameter count (for memory budgeting)."""
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        mlp = 3 * h * i * max(1, self.num_experts)
        if self.is_moe:
            mlp += h * self.num_experts  # router
        per_layer = (
            h * self.q_size
            + 2 * h * self.kv_size
            + self.q_size * h
            + mlp
            + 2 * h
        )
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return self.num_layers * per_layer + embed + h


# -- Presets ---------------------------------------------------------------
# Architecture hyper-parameters are public knowledge (HF config.json files).

_PRESETS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    _PRESETS[cfg.name] = cfg
    return cfg


TINY_DEBUG = _register(
    ModelConfig(
        name="pst-tiny-debug",
        vocab_size=384,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_model_len=256,
        rope_theta=10000.0,
        tie_word_embeddings=True,
    )
)

# same tiny dims with headroom past 512-token prompts: the shared-KV-
# cache e2e serves a 512-token cross-engine prefix (tests/
# test_cache_server.py) which TINY_DEBUG's 256 ceiling cannot hold
TINY_CTX1K_DEBUG = _register(
    dataclasses.replace(
        TINY_DEBUG,
        name="pst-tiny-ctx1k-debug",
        max_model_len=1024,
    )
)

# tiny widths with a LONG logical context: CPU tests drive the
# long-prefill ring lane (tests/test_long_context_serving.py), deep
# logical chains, and the tier-overflow path without big-model compute
TINY_CTX64K_DEBUG = _register(
    dataclasses.replace(
        TINY_DEBUG,
        name="pst-tiny-ctx64k-debug",
        max_model_len=65536,
    )
)

TINY_MOE_DEBUG = _register(
    dataclasses.replace(
        TINY_DEBUG,
        name="pst-tiny-moe-debug",
        num_kv_heads=4,  # ep tests shard experts one-per-chip at tp=4
        num_experts=4,
        num_experts_per_tok=2,
    )
)

# CI-scale stand-in for facebook/opt-125m in the reference's test configs:
# same order of magnitude, Llama-class architecture.
SMALL_125M = _register(
    ModelConfig(
        name="pst-small-125m",
        vocab_size=32000,
        hidden_size=768,
        intermediate_size=2048,
        num_layers=12,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        max_model_len=2048,
        rope_theta=10000.0,
    )
)

LLAMA_3_2_1B = _register(
    ModelConfig(
        name="llama-3.2-1b",
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        max_model_len=131072,
        rope_theta=500000.0,
        tie_word_embeddings=True,
    )
)

LLAMA_3_2_3B = _register(
    ModelConfig(
        name="llama-3.2-3b",
        vocab_size=128256,
        hidden_size=3072,
        intermediate_size=8192,
        num_layers=28,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=131072,
        rope_theta=500000.0,
        tie_word_embeddings=True,
    )
)

LLAMA_3_8B = _register(
    ModelConfig(
        name="llama-3-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=8192,
        rope_theta=500000.0,
    )
)

LLAMA_3_1_8B = _register(
    dataclasses.replace(LLAMA_3_8B, name="llama-3.1-8b", max_model_len=131072)
)

MISTRAL_7B = _register(
    ModelConfig(
        name="mistral-7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=32768,
        rope_theta=1000000.0,
    )
)

QWEN2_7B = _register(
    ModelConfig(
        name="qwen2-7b",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        max_model_len=32768,
        rope_theta=1000000.0,
        qkv_bias=True,
    )
)

MIXTRAL_8X7B = _register(
    ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=32768,
        rope_theta=1000000.0,
        num_experts=8,
        num_experts_per_tok=2,
    )
)


def from_hf_config(path: str, name: str | None = None) -> ModelConfig:
    """Build a ModelConfig from a HuggingFace `config.json` on local disk."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["?"])[0]
    if arch not in (
        "LlamaForCausalLM",
        "MistralForCausalLM",
        "Qwen2ForCausalLM",
        "MixtralForCausalLM",
        "Phi3ForCausalLM",
        "GemmaForCausalLM",
    ):
        raise ValueError(f"unsupported architecture {arch!r} at {path}")
    num_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads
    gemma = arch == "GemmaForCausalLM"
    max_len = hf.get("max_position_embeddings", 8192)
    window = hf.get("sliding_window")
    # Qwen2-family configs ship a sliding_window value alongside
    # use_sliding_window=false; a window >= max_position_embeddings is
    # also a no-op mask that would only cost us the paged-attention path.
    if not hf.get("use_sliding_window", True):
        window = None
    # HF Qwen2 slides only layers >= max_window_layers; the shipped
    # default (== num_hidden_layers) means NO layer slides. Mixed
    # per-layer windows aren't representable here: all-full when no
    # layer slides, else keep the window for every layer (the majority
    # behavior) and say so.
    mwl = hf.get("max_window_layers")
    if window and mwl is not None:
        if mwl >= hf["num_hidden_layers"]:
            window = None
        elif mwl > 0:
            logger.warning(
                "max_window_layers=%d < num_hidden_layers=%d: applying "
                "sliding_window=%d to ALL layers (per-layer windows "
                "unsupported); first %d layers will differ from HF",
                mwl, hf["num_hidden_layers"], window, mwl,
            )
    if window and window >= max_len:
        window = None
    act = hf.get("hidden_act") or hf.get("hidden_activation") or "silu"
    if act in ("gelu_pytorch_tanh", "gelu_new", "gelu"):
        act = "gelu_tanh"
    return ModelConfig(
        name=name or os.path.basename(os.path.normpath(path)),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        max_model_len=max_len,
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=(
            True if gemma else hf.get("tie_word_embeddings", False)
        ),
        qkv_bias=(arch == "Qwen2ForCausalLM"),
        hidden_act=act if gemma else "silu",
        norm_weight_offset=1.0 if gemma else 0.0,
        embed_scale=float(hf["hidden_size"]) ** 0.5 if gemma else 1.0,
        sliding_window=int(window) if window else None,
        num_experts=hf.get("num_local_experts", 0),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
    )


def get_model_config(model: str) -> ModelConfig:
    """Resolve a model: preset name, local HF checkpoint directory, or an
    HF id already present in the local HF cache (zero-egress)."""
    if model in _PRESETS:
        return _PRESETS[model]
    if os.path.isdir(model) and os.path.exists(
        os.path.join(model, "config.json")
    ):
        return from_hf_config(model)
    from production_stack_tpu_torch.models.weights import resolve_model_dir

    d = resolve_model_dir(model)
    if d is not None:
        return from_hf_config(d, name=model)
    raise ValueError(
        f"unknown model {model!r} (not a preset, local checkpoint dir, or "
        f"cached HF id); known presets: {sorted(_PRESETS)}"
    )


def list_presets() -> list[str]:
    return sorted(_PRESETS)
