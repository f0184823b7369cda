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

Tensor parallelism (``shard=(rank, tp)``): each rank allocates its own
shard's shapes (parallel/sharding.py) and slices every split tensor as
the mmap reader hands it over, in the checkpoint's own layout, before it
reaches the card: no rank holds the full weights there. A Mixtral rank
reads only its E/tp experts (each HF expert is a tensor of its own). Pipeline
parallelism (``layers=(lo, hi)``): a stage allocates its L/pp layers
and reads only their tensors.

Zero-egress: only local paths (a model directory, or an HF id already
present in the local HF cache) are accepted.
"""

from __future__ import annotations

import os
import time

import torch

from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel import sharding
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
         transpose: bool = False, part: tuple | None = None) -> None:
    """Copy checkpoint tensor `src` (its own dtype, on the CPU) into
    `dst` (a slice of a stacked weight), transposed and cast on the way.
    `part` = (axis, rank, tp): first take the rank's slice of `src` on
    `axis` of `dst`'s layout (on the host, before any upload). Shapes
    must match exactly: a broadcasting copy would hide a wrong tensor."""
    if part is not None:
        axis, rank, tp = part
        if transpose:  # dst is src's transpose: the other axis
            axis = 1 - axis % 2
        src = sharding.shard(src, axis, rank, tp)
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
    device: str | torch.device = "cpu", shard: tuple[int, int] | None = None,
    layers: tuple[int, int] | None = None,
) -> dict:
    """Read an HF Llama/Mistral/Qwen2/Phi-3/Gemma/Mixtral checkpoint into
    the port's param tree on `device`, in `dtype`; with `shard` = (rank,
    tp), the rank's tensor-parallel shard of it; with `layers` = (lo, hi),
    a pipeline stage's layers only (another stage's tensors are skipped
    by name: a safetensors view that is never touched reads nothing)."""
    t0 = time.perf_counter()
    rank, tp = shard if shard is not None else (0, 1)
    if tp > 1:
        sharding.validate_tp(cfg, tp)
    full_cfg = cfg
    if tp > 1:
        cfg = cfg.tp_local(tp)
    lo, hi = layers if layers is not None else (0, cfg.num_layers)
    L, h = hi - lo, cfg.hidden_size

    def part(path: tuple, per_layer: bool = True):
        """The (axis, rank, tp) of leaf `path` in a per-layer (or, with
        per_layer False, whole) tensor's layout, or None."""
        axis = sharding.split_axis(path, full_cfg)
        if axis is None or tp == 1:
            return None
        return (axis - 1 if per_layer and axis > 0 else axis, rank, tp)

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
    }
    if cfg.is_moe:
        E = cfg.num_experts
        # expert parallelism: the rank's experts only, each HF expert its
        # own tensor (another rank's are skipped by name, unread)
        e_lo, e_hi = sharding.expert_range(cfg, rank, tp)
        layers["moe_gate"] = alloc((L, h, E))
        layers["w_gate"] = alloc((L, e_hi - e_lo, h, i_sz))
        layers["w_up"] = alloc((L, e_hi - e_lo, h, i_sz))
        layers["w_down"] = alloc((L, e_hi - e_lo, i_sz, h))
    else:
        layers["w_gate"] = alloc((L, h, i_sz))
        layers["w_up"] = alloc((L, h, i_sz))
        layers["w_down"] = alloc((L, i_sz, h))
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
            lm_axis = part(("lm_head",), per_layer=False)
            top["lm_head"] = alloc(
                (h, cfg.vocab_size // (tp if lm_axis else 1)))
            _put(top["lm_head"], tensor, name, transpose=True,
                 part=lm_axis)
            n_loaded += 1
            continue
        if not key.startswith("layers."):
            continue
        _, idx, *rest = key.split(".", 2)
        i, suffix = int(idx) - lo, rest[0]
        if not 0 <= i < L:
            continue  # another pipeline stage's layer
        # Mixtral MoE block (HF MixtralSparseMoeBlock):
        #   block_sparse_moe.gate.weight            [E, h] -> moe_gate
        #   block_sparse_moe.experts.{e}.w1.weight  [f, h] -> w_gate
        #   block_sparse_moe.experts.{e}.w3.weight  [f, h] -> w_up
        #   block_sparse_moe.experts.{e}.w2.weight  [h, f] -> w_down
        if cfg.is_moe and suffix.startswith("block_sparse_moe."):
            if suffix == "block_sparse_moe.gate.weight":
                _put(layers["moe_gate"][i], tensor, name, transpose=True)
                n_loaded += 1
                continue
            parts = suffix.split(".")  # [.., 'experts', e, 'w1', 'weight']
            if len(parts) == 5 and parts[1] == "experts":
                ours = {"w1": "w_gate", "w3": "w_up",
                        "w2": "w_down"}.get(parts[3])
                e = int(parts[2])
                if ours is not None and e_lo <= e < e_hi:
                    _put(layers[ours][i, e - e_lo], tensor, name,
                         transpose=True)
                    n_loaded += 1
            continue
        # Phi-3 fuses attention and MLP inputs into single matrices;
        # split the rows back out to the Llama-layout params
        if suffix == "self_attn.qkv_proj.weight":
            q, k, v = torch.split(
                tensor,
                [full_cfg.q_size, full_cfg.kv_size, full_cfg.kv_size], dim=0)
            for ours, t in (("wq", q), ("wk", k), ("wv", v)):
                _put(layers[ours][i], t, name, transpose=True,
                     part=part(("layers", ours)))
            n_loaded += 3
            continue
        if suffix == "mlp.gate_up_proj.weight":
            full_i = full_cfg.intermediate_size
            gate, up = torch.split(tensor, [full_i, full_i], dim=0)
            _put(layers["w_gate"][i], gate, name, transpose=True,
                 part=part(("layers", "w_gate")))
            _put(layers["w_up"][i], up, name, transpose=True,
                 part=part(("layers", "w_up")))
            n_loaded += 2
            continue
        mapping = per_layer.get(suffix)
        if mapping is None:
            continue
        ours, transpose = mapping
        if ours not in layers:
            continue  # bias tensors on a model without qkv_bias
        _put(layers[ours][i], tensor, name, transpose=transpose,
             part=part(("layers", ours)))
        n_loaded += 1

    if "embed" not in top:
        raise ValueError(f"checkpoint at {model_dir} has no embed_tokens")
    # completeness: a partial shard set must never load as zero-filled
    # layers (n per-layer tensors + embed + final_norm [+ lm_head])
    dense_mlp = {"w_gate", "w_up", "w_down"}
    per_layer_count = len([
        k for k, (ours, _) in per_layer.items()
        if ours in layers and not (cfg.is_moe and ours in dense_mlp)
    ])
    if cfg.is_moe:
        # the router + the rank's experts
        per_layer_count += 1 + 3 * (e_hi - e_lo)
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
            params["lm_head"] = sharding.shard(
                params["embed"].t(), sharding.LM_HEAD_SPLIT_AXIS, rank, tp)
    logger.info(
        "loaded %d tensors from %s (%s, %s on %s) in %.2fs", n_loaded,
        model_dir, cfg.name, dtype, device, time.perf_counter() - t0,
    )
    return params


def maybe_load(model: str, cfg: ModelConfig,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu",
               shard: tuple[int, int] | None = None,
               layers: tuple[int, int] | None = None) -> dict | None:
    """Load weights if `model` resolves to a local checkpoint, else None
    (the runner draws random weights for preset names); `shard` and
    `layers` as load_hf_weights takes them.

    A checkpoint that RESOLVES but fails to load raises: silently serving
    random weights under a real model's name would be far worse than
    failing startup."""
    d = resolve_model_dir(model)
    if d is None:
        return None
    return load_hf_weights(cfg, d, dtype, device, shard=shard,
                           layers=layers)
