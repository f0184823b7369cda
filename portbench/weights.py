"""Random weights from the run's seed, in the port's parameter layout.

One normal draw fills a single buffer in the served dtype on the device;
each leaf is a view of it, scaled in place. The layout is the one
``production_stack_tpu_torch.models.llama`` takes: layer weights stacked
on a leading layer axis, projections as (in, out). The plain reference
reads the same tensors.
"""

from __future__ import annotations

import math

import torch

NORM_STD = 0.1
BIAS_STD = 0.1


def leaf_specs(hf: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, scale) of every leaf: kind "matrix" is
    N(0, 1) * scale, "norm" is 1 + scale * N(0, 1), "bias" scale * N."""
    L, h, i, v = (hf["num_hidden_layers"], hf["hidden_size"],
                  hf["intermediate_size"], hf["vocab_size"])
    nq = hf["num_attention_heads"]
    d = hf.get("head_dim") or h // nq
    q, kv = nq * d, hf.get("num_key_value_heads", nq) * d
    specs = [
        (("embed",), (v, h), "matrix", h**-0.5),
        (("layers", "attn_norm"), (L, h), "norm", NORM_STD),
        (("layers", "mlp_norm"), (L, h), "norm", NORM_STD),
        (("layers", "wq"), (L, h, q), "matrix", h**-0.5),
        (("layers", "wk"), (L, h, kv), "matrix", h**-0.5),
        (("layers", "wv"), (L, h, kv), "matrix", h**-0.5),
        (("layers", "wo"), (L, q, h), "matrix", q**-0.5),
        (("layers", "w_gate"), (L, h, i), "matrix", h**-0.5),
        (("layers", "w_up"), (L, h, i), "matrix", h**-0.5),
        (("layers", "w_down"), (L, i, h), "matrix", i**-0.5),
        (("final_norm",), (h,), "norm", NORM_STD),
    ]
    if has_qkv_bias(hf):
        specs += [(("layers", "bq"), (L, q), "bias", BIAS_STD),
                  (("layers", "bk"), (L, kv), "bias", BIAS_STD),
                  (("layers", "bv"), (L, kv), "bias", BIAS_STD)]
    if not hf.get("tie_word_embeddings", False):
        specs.append((("lm_head",), (h, v), "matrix", h**-0.5))
    return specs


def has_qkv_bias(hf: dict) -> bool:
    return (hf.get("architectures") or ["?"])[0] == "Qwen2ForCausalLM"


def make_params(hf: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The model's weights, drawn on `device` from `seed` in `dtype`."""
    specs = leaf_specs(hf)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    params: dict = {"layers": {}}
    at = 0
    for path, shape, kind, scale in specs:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        leaf.mul_(scale)
        if kind == "norm":
            leaf.add_(1.0)
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return params
