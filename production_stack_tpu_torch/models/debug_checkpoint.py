"""Write HF checkpoints on disk: a tiny-but-real debug one, and any port
param tree at full width.

``write_debug_checkpoint`` is ``production_stack_tpu/models/
debug_checkpoint.py``'s: ``config.json``, ``model.safetensors`` in HF's
torch (out, in) layout and a real fast tokenizer (``tokenizer.json`` +
``tokenizer_config.json`` with eos/bos and a chat template), so the whole
serve path runs as it would for a downloaded model:
``resolve_model_dir`` -> ``load_hf_weights`` -> ``HFTokenizer`` ->
``engine/server.py``. The weights go through models/safetensors_io.py;
the tokenizer needs the ``tokenizers`` package, imported only when one
is written.

``write_hf_checkpoint`` is the inverse of models/weights.py: a port
param tree (on the CPU or the card) becomes ``config.json`` in HF field
names and sharded safetensors with their index, one tensor on the host
at a time.

CLI: ``python -m production_stack_tpu_torch.models.debug_checkpoint
OUTDIR``
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import ModelConfig

DEFAULT_CONFIG = {
    "architectures": ["LlamaForCausalLM"],
    "vocab_size": 384,
    "hidden_size": 32,
    "intermediate_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "max_position_embeddings": 256,
    "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False,
}

# enough text for a stable char/BPE vocab covering ascii prompts
_TOKENIZER_CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "The Quick Brown Fox Jumps Over The Lazy Dog 0123456789",
    "hello world! how are you today? i am a tiny debug model.",
    "serving engines route requests, cache kv blocks, stream tokens.",
    "!\"#$%&'()*+,-./:;<=>?@[]^_`{|}~",
]

CHAT_TEMPLATE = (
    "{% for message in messages %}<|{{ message.role }}|>\n"
    "{{ message.content }}\n{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


def write_debug_tokenizer(dirpath: str, vocab_size: int = 384) -> None:
    """Train + save a real byte-level BPE fast tokenizer into dirpath."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=["<s>", "</s>", "<unk>"],
        show_progress=False,
    )
    tok.train_from_iterator(_TOKENIZER_CORPUS, trainer)
    tok.save(os.path.join(dirpath, "tokenizer.json"))
    with open(os.path.join(dirpath, "tokenizer_config.json"), "w") as f:
        json.dump({
            "tokenizer_class": "PreTrainedTokenizerFast",
            "bos_token": "<s>",
            "eos_token": "</s>",
            "unk_token": "<unk>",
            "model_max_length": 256,
            "chat_template": CHAT_TEMPLATE,
        }, f, indent=1)


def write_debug_checkpoint(
    dirpath: str,
    seed: int = 0,
    config: dict | None = None,
    with_tokenizer: bool = True,
) -> dict[str, np.ndarray]:
    """Write config + weights (+ tokenizer); returns the HF tensor dict."""
    c = dict(DEFAULT_CONFIG)
    c.update(config or {})
    rng = np.random.RandomState(seed)
    h, i, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = h // c["num_attention_heads"]
    q_size = c["num_attention_heads"] * hd
    kv_size = c["num_key_value_heads"] * hd
    tensors = {
        "model.embed_tokens.weight":
            rng.randn(v, h).astype(np.float32) * 0.1,
        "model.norm.weight": np.ones(h, np.float32),
        "lm_head.weight": rng.randn(v, h).astype(np.float32) * 0.1,
    }
    for layer in range(c["num_hidden_layers"]):
        p = f"model.layers.{layer}."
        tensors[p + "input_layernorm.weight"] = np.ones(h, np.float32)
        tensors[p + "post_attention_layernorm.weight"] = np.ones(
            h, np.float32)
        tensors[p + "self_attn.q_proj.weight"] = (
            rng.randn(q_size, h).astype(np.float32) * 0.1)
        tensors[p + "self_attn.k_proj.weight"] = (
            rng.randn(kv_size, h).astype(np.float32) * 0.1)
        tensors[p + "self_attn.v_proj.weight"] = (
            rng.randn(kv_size, h).astype(np.float32) * 0.1)
        tensors[p + "self_attn.o_proj.weight"] = (
            rng.randn(h, q_size).astype(np.float32) * 0.1)
        tensors[p + "mlp.gate_proj.weight"] = (
            rng.randn(i, h).astype(np.float32) * 0.1)
        tensors[p + "mlp.up_proj.weight"] = (
            rng.randn(i, h).astype(np.float32) * 0.1)
        tensors[p + "mlp.down_proj.weight"] = (
            rng.randn(h, i).astype(np.float32) * 0.1)
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(c, f, indent=1)
    safetensors_io.save_file(
        {k: torch.from_numpy(a) for k, a in tensors.items()},
        os.path.join(dirpath, "model.safetensors"))
    if with_tokenizer:
        write_debug_tokenizer(dirpath, vocab_size=c["vocab_size"])
    return tensors


def hf_config_of(cfg: ModelConfig) -> dict:
    """HF ``config.json`` fields that models/config.py:from_hf_config
    reads back as `cfg` (Llama, Mistral with a window, Qwen2 with qkv
    bias, Mixtral; Gemma's knobs have no such inverse here)."""
    if cfg.norm_weight_offset or cfg.embed_scale != 1.0:
        raise ValueError(f"{cfg.name}: only Llama, Mistral, Qwen2 and "
                         "Mixtral layouts are written")
    arch = ("MixtralForCausalLM" if cfg.is_moe
            else "Qwen2ForCausalLM" if cfg.qkv_bias
            else "MistralForCausalLM" if cfg.sliding_window
            else "LlamaForCausalLM")
    hf = {
        "architectures": [arch],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_model_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "hidden_act": "silu",
        "sliding_window": cfg.sliding_window,
    }
    if cfg.qkv_bias:
        hf["use_sliding_window"] = cfg.sliding_window is not None
    if cfg.is_moe:
        hf["num_local_experts"] = cfg.num_experts
        hf["num_experts_per_tok"] = cfg.num_experts_per_tok
    return hf


# port layer key -> (HF suffix, stored transposed in the port?)
_HF_LAYER = {
    "attn_norm": ("input_layernorm.weight", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}
# a MoE layer's router and experts (HF MixtralSparseMoeBlock): port key ->
# HF suffix, every one stored transposed in the port; expert e of
# w_gate / w_up / w_down is experts.{e}.w1 / w3 / w2
_HF_MOE = {
    "moe_gate": "block_sparse_moe.gate.weight",
    "w_gate": "block_sparse_moe.experts.{e}.w1.weight",
    "w_up": "block_sparse_moe.experts.{e}.w3.weight",
    "w_down": "block_sparse_moe.experts.{e}.w2.weight",
}


def hf_tensors(params: dict):
    """(HF name, tensor in HF layout) of a port param tree, lazily: each
    projection is a transposed view, made contiguous when written."""
    yield "model.embed_tokens.weight", params["embed"]
    layers = params["layers"]
    n_layers = layers["wq"].shape[0]
    moe = "moe_gate" in layers
    for layer in range(n_layers):
        p = f"model.layers.{layer}."
        for ours, (suffix, transpose) in _HF_LAYER.items():
            if ours in layers and not (moe and ours in _HF_MOE):
                w = layers[ours][layer]
                yield p + suffix, w.t() if transpose else w
        if moe:
            yield p + _HF_MOE["moe_gate"], layers["moe_gate"][layer].t()
            for e in range(layers["w_gate"].shape[1]):
                for ours in ("w_gate", "w_up", "w_down"):
                    yield (p + _HF_MOE[ours].format(e=e),
                           layers[ours][layer, e].t())
    yield "model.norm.weight", params["final_norm"]
    if "lm_head" in params:
        yield "lm_head.weight", params["lm_head"].t()


def write_hf_checkpoint(dirpath: str, hf_config: dict, params: dict,
                        shard_bytes: int = 2**30) -> list[str]:
    """Write `params` (the port's tree, on the CPU or the card) as an HF
    checkpoint: config.json (`hf_config`), safetensors shards of at most
    `shard_bytes` each (one tensor may exceed it alone), named and
    indexed as HF shards them. Returns the shard paths."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=1)
    plan: list[list[tuple[str, torch.Tensor]]] = [[]]
    size = 0
    for name, t in hf_tensors(params):
        nbytes = t.numel() * t.element_size()
        if plan[-1] and size + nbytes > shard_bytes:
            plan.append([])
            size = 0
        plan[-1].append((name, t))
        size += nbytes
    paths, weight_map, total = [], {}, 0
    for i, group in enumerate(plan):
        fn = f"model-{i + 1:05d}-of-{len(plan):05d}.safetensors"
        # save_file brings one tensor at a time to the host
        safetensors_io.save_file(dict(group), os.path.join(dirpath, fn),
                                 metadata={"format": "pt"})
        paths.append(os.path.join(dirpath, fn))
        for name, t in group:
            weight_map[name] = fn
            total += t.numel() * t.element_size()
    with open(os.path.join(dirpath, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    return paths


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="write a tiny real HF checkpoint (weights + tokenizer)"
    )
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_debug_checkpoint(args.outdir, seed=args.seed)
    print(f"wrote debug checkpoint to {args.outdir}")


if __name__ == "__main__":
    main()
