"""Tensor- and pipeline-parallel sharding rules for the Llama family, one
process a rank.

Counterpart of ``production_stack_tpu/parallel/sharding.py``. The JAX
package places params and cache with ``NamedSharding``s over a mesh and
lets GSPMD insert the psums; here each rank holds its own contiguous
slice of every split leaf, and the forward reduces explicitly
(models/llama.py, through parallel/group.TPGroup). The layout is the
JAX package's (Megatron-style, hidden activations replicated):

- attention: wq/wk/wv (and Qwen2's bq/bk/bv) column-parallel, heads
  split across tp; wo row-parallel -> one all-reduce a layer after the
  attention output projection;
- MLP: w_gate/w_up column-parallel, w_down row-parallel -> one
  all-reduce;
- KV cache: split on the kv-head axis, (L, nkv/tp, slots, d) a rank, so
  paged attention is local to each rank (q heads and kv heads split
  congruently: every GQA group lies whole on one rank);
- MoE (expert parallelism over the same axis): each rank holds E/tp
  whole experts, w_gate / w_up / w_down (L, E, ...) cut on E, the
  router moe_gate replicated; every rank gates over all E experts,
  runs its own and the block's output is all-reduced;
- lm_head split on the vocab for untied models, its logits gathered;
  the embedding, the norms and a tied vocab projection replicated.

Pipeline parallelism adds the layer axis: a rank set of tp * pp ranks is
the JAX ``("pp", "tp")`` serving mesh reshaped row-major, so rank r is
stage ``r // tp`` and tp index ``r % tp`` (``rank_layout``), the tp
ranks of a stage are contiguous, and stage s holds layers
``[s * L / pp, (s + 1) * L / pp)`` of every stacked leaf
(``stage_layers``) and of the KV cache. The embedding, the final norm and
the lm_head (cut on the vocab over tp) sit on every stage, as the JAX
package replicates them over "pp".

The mesh builders (``make_mesh``, ``make_serving_mesh``) have no
counterpart: a rank set is processes (parallel/launch.py).
"""

from __future__ import annotations

import torch

from production_stack_tpu_torch.models.config import ModelConfig

# split axis of each stacked per-layer leaf (layer axis 0): column
# splits on the last axis, row splits on axis 1 (JAX param_shardings)
LAYER_SPLIT_AXIS = {
    "wq": -1, "wk": -1, "wv": -1, "w_gate": -1, "w_up": -1,
    "bq": -1, "bk": -1, "bv": -1,
    "wo": 1, "w_down": 1,
}
# a MoE model's experts (L, E, ...) split whole on E (expert
# parallelism over the tp axis, as the JAX package shards them); its
# router moe_gate (L, h, E) is replicated
MOE_SPLIT_AXIS = {"w_gate": 1, "w_up": 1, "w_down": 1, "moe_gate": None}
# an untied lm_head (hidden, vocab) splits on the vocab
LM_HEAD_SPLIT_AXIS = -1
# a LoRA adapter's split arrays, in its (L, in, r) / (L, r, out) layout
# or the stacked slots' (L, S, in, r) / (L, S, r, out): the B of a
# column target on its head columns, the A of the row target wo on its
# input rows (its partial deltas sum in the o-projection's all-reduce);
# every other array (the A of wq / wk / wv, wo's B, scaling) replicated
LORA_SPLIT_AXIS = {"wq_B": -1, "wk_B": -1, "wv_B": -1, "wo_A": -2}


def validate_tp(cfg: ModelConfig, tp_size: int) -> None:
    """The JAX package's validate_tp, message for message."""
    if cfg.num_heads % tp_size or cfg.num_kv_heads % tp_size:
        raise ValueError(
            f"model {cfg.name}: heads ({cfg.num_heads}/{cfg.num_kv_heads}) "
            f"not divisible by tp={tp_size}"
        )
    if cfg.is_moe:
        if cfg.num_experts % tp_size:
            raise ValueError(
                f"model {cfg.name}: num_experts {cfg.num_experts} not "
                f"divisible by tp={tp_size} (experts shard whole)"
            )
    elif cfg.intermediate_size % tp_size:
        raise ValueError(
            f"model {cfg.name}: intermediate_size "
            f"{cfg.intermediate_size} not divisible by tp={tp_size}"
        )
    if not cfg.tie_word_embeddings and cfg.vocab_size % tp_size:
        raise ValueError(
            f"model {cfg.name}: vocab_size {cfg.vocab_size} not divisible "
            f"by tp={tp_size} (lm_head is vocab-sharded)"
        )


def split_axis(path: tuple[str, ...], cfg: ModelConfig) -> int | None:
    """The axis leaf `path` (("layers", "wq"), ("lm_head",), ...) splits
    on, or None where it is replicated."""
    if path[0] == "layers":
        if cfg.is_moe and path[1] in MOE_SPLIT_AXIS:
            return MOE_SPLIT_AXIS[path[1]]
        return LAYER_SPLIT_AXIS.get(path[1])
    if path == ("lm_head",) and not cfg.tie_word_embeddings:
        return LM_HEAD_SPLIT_AXIS
    return None


def shard(x: torch.Tensor, axis: int | None, rank: int,
          tp: int) -> torch.Tensor:
    """Rank `rank`'s contiguous slice of `x` on `axis` (a view; None:
    x itself)."""
    if axis is None or tp == 1:
        return x
    n = x.shape[axis] // tp
    return x.narrow(axis, rank * n, n)


def cut_adapter(key: str, x: torch.Tensor, rank: int,
                tp: int) -> torch.Tensor:
    """Adapter array `key` ("wq_A", "wo_B", ...) as tp index `rank`
    holds it: contiguous where cut, else `x` itself."""
    axis = LORA_SPLIT_AXIS.get(key)
    if axis is None or tp == 1:
        return x
    return shard(x, axis, rank, tp).contiguous()


def rank_layout(rank: int, tp: int) -> tuple[int, int]:
    """(stage, tp index) of `rank` in a set of tp ranks a stage."""
    return divmod(rank, tp)


def stage_layers(num_layers: int, stage: int, pp: int) -> tuple[int, int]:
    """The layer range [lo, hi) stage `stage` of `pp` holds."""
    n = num_layers // pp
    return stage * n, (stage + 1) * n


def shard_params(full: dict, cfg: ModelConfig, rank: int, tp: int,
                 layers: tuple[int, int] | None = None) -> dict:
    """One rank's params from the full tree (models/llama.init_params'
    layout): with `layers` = (lo, hi), every stacked layer leaf cut to
    the stage's layers; every split leaf narrowed to the rank's
    contiguous slice; a cut leaf copied out (contiguous, so the full
    tensor can go), the rest as they are. The same slices as the JAX
    package's ``addressable_shards[rank]`` on a tp (or ("pp", "tp"))
    mesh."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            out[k] = cut(path + (k,), v, cfg, rank, tp, layers)
        return out

    return walk(full, ())


def cut(path: tuple[str, ...], x: torch.Tensor, cfg: ModelConfig,
        rank: int, tp: int,
        layers: tuple[int, int] | None = None) -> torch.Tensor:
    """Leaf `path` of the full tree as rank `rank` holds it: a stacked
    layer leaf cut to `layers`, then a split leaf narrowed to the rank's
    tp slice; contiguous wherever it was cut (else `x` itself)."""
    out = x
    if layers is not None and path[0] == "layers":
        out = out[layers[0]:layers[1]]
    axis = split_axis(path, cfg)
    if axis is not None and tp > 1:
        out = shard(out, axis, rank, tp)
    return out if out is x else out.contiguous()


def expert_range(cfg: ModelConfig, rank: int, tp: int) -> tuple[int, int]:
    """The experts [lo, hi) tp index `rank` holds of a MoE model."""
    n = cfg.num_experts // tp
    return rank * n, (rank + 1) * n


def local_cache_shape(cfg: ModelConfig, num_slots: int, tp: int,
                      pp: int = 1) -> tuple[int, int, int, int]:
    """One rank's head-major KV cache (L/pp, nkv/tp, slots, d): the JAX
    package's cache_sharding, as the shape each rank allocates."""
    return (cfg.num_layers // pp, cfg.num_kv_heads // tp, num_slots,
            cfg.head_dim)
