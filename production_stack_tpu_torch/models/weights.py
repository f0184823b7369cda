"""HF checkpoint loading: safetensors / torch shards -> the port's params.

Counterpart of ``production_stack_tpu/models/weights.py``. HF
Llama-family per-layer ``{q,k,v,o}_proj.weight`` are (out, in) torch
matrices; the port's params (models/llama.py) store them transposed,
(in, out), stacked over layers on axis 0 — the tree ``models/convert.py``
makes of the JAX package's params.

Each stacked weight is allocated once, on the target device in the
target dtype, and every checkpoint tensor is copied into its layer's
slice as it is read: the transpose and the cast happen in that copy
(on the card after a plain upload of the tensor, when the target is the
card). Nothing is widened to float32 on the host, and the shards are
mapped (models/safetensors_io.py), so host memory holds the checkpoint
once, in the page cache.

Zero-egress: only local paths (a model directory, or an HF id already
present in the local HF cache) are accepted.
"""

from __future__ import annotations

import os
import time

import torch

from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)


def resolve_model_dir(model: str) -> str | None:
    """Local directory containing config.json + weights for `model`."""
    if os.path.isdir(model) and os.path.exists(
        os.path.join(model, "config.json")
    ):
        return model
    # HF cache layout: <cache>/models--org--name/snapshots/<rev>/
    cache = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface")
    )
    hub = os.path.join(cache, "hub", f"models--{model.replace('/', '--')}")
    snaps = os.path.join(hub, "snapshots")
    if os.path.isdir(snaps):
        # prefer the revision refs/main points at (the cache's notion of
        # "current"); fall back to any snapshot with a config.json
        ref_main = os.path.join(hub, "refs", "main")
        if os.path.exists(ref_main):
            with open(ref_main) as f:
                rev = f.read().strip()
            d = os.path.join(snaps, rev)
            if os.path.exists(os.path.join(d, "config.json")):
                return d
        for rev in sorted(os.listdir(snaps)):
            d = os.path.join(snaps, rev)
            if os.path.exists(os.path.join(d, "config.json")):
                return d
    return None


def _iter_tensors(model_dir: str):
    """Yield (name, CPU tensor) across all weight shards in the dir."""
    if safetensors_io.shard_files(model_dir):
        yield from safetensors_io.iter_dir(model_dir)
        return
    bin_files = sorted(
        f for f in os.listdir(model_dir)
        if f.startswith("pytorch_model") and f.endswith(".bin")
    )
    if not bin_files:
        raise FileNotFoundError(
            f"no safetensors or pytorch_model*.bin in {model_dir}"
        )
    for fn in bin_files:
        sd = torch.load(
            os.path.join(model_dir, fn), map_location="cpu",
            weights_only=True,
        )
        yield from sd.items()


def _put(dst: torch.Tensor, src: torch.Tensor, name: str,
         transpose: bool = False) -> None:
    """Copy checkpoint tensor `src` (its own dtype, on the CPU) into
    `dst` (a slice of a stacked weight), transposed and cast on the way.
    Shapes must match exactly: a broadcasting copy would hide a wrong
    tensor."""
    want = tuple(dst.shape[::-1]) if transpose else tuple(dst.shape)
    if tuple(src.shape) != want:
        raise ValueError(
            f"checkpoint tensor {name} has shape {tuple(src.shape)}, "
            f"expected {want}")
    if src.device != dst.device:
        src = src.to(dst.device)  # the upload keeps the file's dtype
    dst.copy_(src.t() if transpose else src)


def load_hf_weights(
    cfg: ModelConfig, model_dir: str, dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> dict:
    """Read an HF Llama/Mistral/Qwen2/Phi-3/Gemma checkpoint into the
    port's param tree on `device`, in `dtype`."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"checkpoint at {model_dir} is a MoE model ({cfg.name}): MoE "
            "layers are not ported to the PyTorch engine yet")
    t0 = time.perf_counter()
    L, h = cfg.num_layers, cfg.hidden_size

    def alloc(shape):
        # zeros, as the JAX loader: a slot no tensor filled reads 0
        return torch.zeros(shape, dtype=dtype, device=device)

    i_sz = cfg.intermediate_size
    layers = {
        "attn_norm": alloc((L, h)),
        "mlp_norm": alloc((L, h)),
        "wq": alloc((L, h, cfg.q_size)),
        "wk": alloc((L, h, cfg.kv_size)),
        "wv": alloc((L, h, cfg.kv_size)),
        "wo": alloc((L, cfg.q_size, h)),
        "w_gate": alloc((L, h, i_sz)),
        "w_up": alloc((L, h, i_sz)),
        "w_down": alloc((L, i_sz, h)),
    }
    if cfg.qkv_bias:
        layers["bq"] = alloc((L, cfg.q_size))
        layers["bk"] = alloc((L, cfg.kv_size))
        layers["bv"] = alloc((L, cfg.kv_size))
    top: dict[str, torch.Tensor] = {}

    # HF key suffix -> (our key, transpose?)
    per_layer = {
        "input_layernorm.weight": ("attn_norm", False),
        "post_attention_layernorm.weight": ("mlp_norm", False),
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "self_attn.q_proj.bias": ("bq", False),
        "self_attn.k_proj.bias": ("bk", False),
        "self_attn.v_proj.bias": ("bv", False),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
    }
    n_loaded = 0
    for name, tensor in _iter_tensors(model_dir):
        key = name.removeprefix("model.")
        if key == "embed_tokens.weight":
            top["embed"] = alloc((cfg.vocab_size, h))
            _put(top["embed"], tensor, name)
            n_loaded += 1
            continue
        if key == "norm.weight":
            top["final_norm"] = alloc((h,))
            _put(top["final_norm"], tensor, name)
            n_loaded += 1
            continue
        if name == "lm_head.weight":
            top["lm_head"] = alloc((h, cfg.vocab_size))
            _put(top["lm_head"], tensor, name, transpose=True)
            n_loaded += 1
            continue
        if not key.startswith("layers."):
            continue
        _, idx, *rest = key.split(".", 2)
        i, suffix = int(idx), rest[0]
        # Phi-3 fuses attention and MLP inputs into single matrices;
        # split the rows back out to the Llama-layout params
        if suffix == "self_attn.qkv_proj.weight":
            q, k, v = torch.split(
                tensor, [cfg.q_size, cfg.kv_size, cfg.kv_size], dim=0)
            _put(layers["wq"][i], q, name, transpose=True)
            _put(layers["wk"][i], k, name, transpose=True)
            _put(layers["wv"][i], v, name, transpose=True)
            n_loaded += 3
            continue
        if suffix == "mlp.gate_up_proj.weight":
            gate, up = torch.split(tensor, [i_sz, i_sz], dim=0)
            _put(layers["w_gate"][i], gate, name, transpose=True)
            _put(layers["w_up"][i], up, name, transpose=True)
            n_loaded += 2
            continue
        mapping = per_layer.get(suffix)
        if mapping is None:
            continue
        ours, transpose = mapping
        if ours not in layers:
            continue  # bias tensors on a model without qkv_bias
        _put(layers[ours][i], tensor, name, transpose=transpose)
        n_loaded += 1

    if "embed" not in top:
        raise ValueError(f"checkpoint at {model_dir} has no embed_tokens")
    # completeness: a partial shard set must never load as zero-filled
    # layers (n per-layer tensors + embed + final_norm [+ lm_head])
    per_layer_count = len([
        k for k, (ours, _) in per_layer.items() if ours in layers
    ])
    expected = (
        L * per_layer_count + 2 + (0 if cfg.tie_word_embeddings else 1)
    )
    if n_loaded < expected:
        raise ValueError(
            f"checkpoint at {model_dir} is incomplete: loaded {n_loaded} "
            f"of {expected} expected tensors (missing shards?)"
        )
    params = {
        "embed": top["embed"],
        "layers": layers,
        "final_norm": top["final_norm"],
    }
    if not cfg.tie_word_embeddings:
        if "lm_head" in top:
            params["lm_head"] = top["lm_head"]
        else:
            logger.warning("no lm_head in checkpoint; tying to embeddings")
            params["lm_head"] = params["embed"].t()
    logger.info(
        "loaded %d tensors from %s (%s, %s on %s) in %.2fs", n_loaded,
        model_dir, cfg.name, dtype, device, time.perf_counter() - t0,
    )
    return params


def maybe_load(model: str, cfg: ModelConfig,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> dict | None:
    """Load weights if `model` resolves to a local checkpoint, else None
    (the runner draws random weights for preset names).

    A checkpoint that RESOLVES but fails to load raises: silently serving
    random weights under a real model's name would be far worse than
    failing startup."""
    d = resolve_model_dir(model)
    if d is None:
        return None
    return load_hf_weights(cfg, d, dtype, device)
