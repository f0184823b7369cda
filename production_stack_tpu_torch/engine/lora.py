"""Multi-LoRA serving: stacked adapter slots applied inside the forward.

Counterpart of ``production_stack_tpu/engine/lora.py`` (engine pods
expose /v1/load_lora_adapter and the operator's LoraAdapter controller
places adapters on pods — reference: loraadapter_controller.go:582/:598,
vllmruntime spec enableLora):

- All adapters live in ONE pair of stacked device buffers per target
  projection: A (L, S+1, in, r_max), B (L, S+1, r_max, out), slot 0 all
  zeros = "no adapter". Loading or unloading an adapter writes its slot
  in place; shapes stay fixed (max_loras and max_lora_rank are set at
  engine start, like vLLM).
- Per-token adapter slots ride into each forward; every layer adds
  scaling * (x @ A) @ B to the wq/wk/wv/wo projections
  (models/llama.py), so a batch can mix any combination of adapters.
- Ranks smaller than r_max are zero-padded.
- Under tensor parallelism each rank's manager holds the slice of every
  adapter its base weights use (``shard``): wq/wk/wv's B on the head
  columns, wo's A on its input rows; a rank set's loads and unloads are
  broadcast steps (engine/multihost_engine.py).

Adapter files: native .npz with arrays `{target}_A` (L, in, r) and
`{target}_B` (L, r, out) for targets wq/wk/wv/wo plus optional scalar
`scaling`; HF PEFT safetensors checkpoints (``adapter_model.safetensors``
+ ``adapter_config.json``), read through models/safetensors_io.py.

The prefix-cache seed of an adapter's requests is the JAX package's xxh64
of its name and load generation (utils/xxh64.py), so an adapter's blocks
carry the same content addresses in both packages.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.utils import init_logger
from production_stack_tpu_torch.utils.xxh64 import xxh64

logger = init_logger(__name__)

TARGETS = ("wq", "wk", "wv", "wo")
# HF PEFT module name of each target
PEFT_MODULES = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj",
                "wo": "o_proj"}


def _target_dims(mc: ModelConfig) -> dict[str, tuple[int, int]]:
    h = mc.hidden_size
    return {
        "wq": (h, mc.q_size),
        "wk": (h, mc.kv_size),
        "wv": (h, mc.kv_size),
        "wo": (mc.q_size, h),
    }


def _local_dims(mc: ModelConfig, tp: int) -> dict[str, tuple[int, int]]:
    """A tp rank's (in, out) of each target: the column targets' out and
    wo's in divided by tp (parallel/sharding.LORA_SPLIT_AXIS)."""
    return {t: (din // tp, dout) if t == "wo" else (din, dout // tp)
            for t, (din, dout) in _target_dims(mc).items()}


class LoraManager:
    """Owns the stacked adapter buffers + name->slot registry."""

    def __init__(self, mc: ModelConfig, max_loras: int, max_rank: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cpu",
                 shard: tuple[int, int] | None = None):
        """`shard` = (tp index, tp): a tensor-parallel rank's manager,
        whose buffers hold the slice its base weights use (the column
        targets' B on their head columns, wo's A on its input rows;
        parallel/sharding.cut_adapter). An adapter is read and checked
        whole, then cut."""
        self.mc = mc
        self.max_loras = max_loras
        self.max_rank = max_rank
        self.dtype = dtype
        self.shard = shard if shard is not None else (0, 1)
        L = mc.num_layers
        S = max_loras + 1  # slot 0 = no adapter
        # layer-leading layout (L, S, ...): the forward's layer loop
        # slices a layer's adapter rows beside its base weights
        self.buffers: dict[str, torch.Tensor] = {}
        for t, (din, dout) in _local_dims(mc, self.shard[1]).items():
            self.buffers[f"{t}_A"] = torch.zeros(
                (L, S, din, max_rank), dtype=dtype, device=device)
            self.buffers[f"{t}_B"] = torch.zeros(
                (L, S, max_rank, dout), dtype=dtype, device=device)
        self.buffers["scaling"] = torch.zeros((S,), dtype=torch.float32,
                                              device=device)
        self.name_to_slot: dict[str, int] = {}
        self._paths: dict[str, str] = {}
        self._generation: dict[str, int] = {}
        self._free = list(range(1, S))

    def slot_of(self, name: str | None) -> int:
        if name is None:
            return 0
        slot = self.name_to_slot.get(name)
        if slot is None:
            raise KeyError(f"LoRA adapter {name!r} is not loaded")
        return slot

    def path_of(self, name: str) -> str | None:
        """The path `name` was loaded from (None: not loaded)."""
        return self._paths.get(name)

    def list_adapters(self) -> list[str]:
        return sorted(self.name_to_slot)

    # -- load/unload -------------------------------------------------------
    def load(self, name: str, path: str, slot: int | None = None) -> int:
        """Load the adapter at `path` as `name`; returns its slot. Same
        name and path: nothing changes. Same name, another path: the new
        weights replace the old. Every check (a free slot, the file, the
        rank and the shapes) runs before anything changes, so a refused
        load leaves the manager as it was. `slot`: the slot rank 0
        assigned (a follower of a rank set mirrors it)."""
        if name in self.name_to_slot and self._paths.get(name) == path:
            return self.name_to_slot[name]  # idempotent reload
        replacing = name in self.name_to_slot
        if not replacing and not self._free:
            raise RuntimeError(
                f"max_loras={self.max_loras} adapters already loaded"
            )
        staged, scaling = self._stage(self._read_adapter(path))
        if replacing:
            # same name, new path: replace the served weights (the caller
            # expects the new adapter, not a silent no-op)
            self.unload(name)
        if slot is None:
            slot = self._free.pop(0)
        else:
            self._free.remove(slot)
        for key, arr in staged.items():
            self.buffers[key][:, slot] = arr.to(self.buffers[key].device)
        self.buffers["scaling"][slot] = scaling
        self.name_to_slot[name] = slot
        self._paths[name] = path
        # per-load generation: the prefix-cache hash seed folds this in so
        # KV computed under an earlier load of the same name is never
        # reused after a reload with different weights
        self._generation[name] = self._generation.get(name, 0) + 1
        logger.info("loaded LoRA %r into slot %d (path %s, gen %d)",
                    name, slot, path, self._generation[name])
        return slot

    def _stage(self, weights: dict) -> tuple[dict, float]:
        """Validate and pad EVERY target before any buffer write, so a
        bad adapter can never leave partial rows in a freed slot; then
        cut each padded array to this rank's slice."""
        L = self.mc.num_layers
        dims = _target_dims(self.mc)
        rank, tp = self.shard
        staged: dict[str, torch.Tensor] = {}
        for t in TARGETS:
            A = weights.get(f"{t}_A")
            B = weights.get(f"{t}_B")
            if A is None or B is None:
                continue  # adapter may target a subset of projections
            din, dout = dims[t]
            r = A.shape[-1]
            if r > self.max_rank:
                raise ValueError(
                    f"adapter rank {r} exceeds max_lora_rank={self.max_rank}"
                )
            if tuple(A.shape) != (L, din, r) or tuple(B.shape) != (
                    L, r, dout):
                raise ValueError(
                    f"adapter {t} shapes {tuple(A.shape)}/{tuple(B.shape)} "
                    f"do not match model ({L}, {din}, r)/({L}, r, {dout})"
                )
            A_pad = torch.zeros((L, din, self.max_rank), dtype=self.dtype)
            B_pad = torch.zeros((L, self.max_rank, dout), dtype=self.dtype)
            A_pad[:, :, :r] = torch.as_tensor(A)
            B_pad[:, :r, :] = torch.as_tensor(B)
            for key, arr in ((f"{t}_A", A_pad), (f"{t}_B", B_pad)):
                staged[key] = sharding.cut_adapter(key, arr, rank, tp)
        return staged, float(weights.get("scaling", 1.0))

    def hash_seed_of(self, name: str | None) -> int:
        """Prefix-cache chain seed for requests using this adapter: folds
        the per-load generation in so reloaded weights never hit KV cached
        under a previous load of the same name."""
        if name is None:
            return 0
        gen = self._generation.get(name, 0)
        return xxh64(f"lora:{name}:{gen}".encode())

    def unload(self, name: str) -> bool:
        slot = self.name_to_slot.pop(name, None)
        self._paths.pop(name, None)
        if slot is None:
            return False
        for t in TARGETS:
            self.buffers[f"{t}_A"][:, slot] = 0.0
            self.buffers[f"{t}_B"][:, slot] = 0.0
        self.buffers["scaling"][slot] = 0.0
        self._free.insert(0, slot)
        logger.info("unloaded LoRA %r (slot %d)", name, slot)
        return True

    # -- adapter file formats ---------------------------------------------
    def _read_adapter(self, path: str) -> dict:
        if os.path.isdir(path):
            for candidate in ("adapter.npz", "adapter_model.safetensors"):
                p = os.path.join(path, candidate)
                if os.path.exists(p):
                    path = p
                    break
        if path.endswith(".npz"):
            with np.load(path) as z:
                return {k: np.asarray(z[k]) for k in z.files}
        if path.endswith(".safetensors"):
            return self._read_peft_safetensors(path)
        raise ValueError(f"unsupported adapter format: {path!r}")

    def _read_peft_safetensors(self, path: str) -> dict:
        """Convert HF PEFT layout (per-layer q_proj/k_proj/... lora_A/B
        with (r, in)/(out, r) torch conventions) to our stacked layout.
        Scaling = lora_alpha / r from the sibling adapter_config.json."""
        peft_to_target = {p: t for t, p in PEFT_MODULES.items()}
        L = self.mc.num_layers
        per_target: dict[str, dict[int, dict[str, torch.Tensor]]] = {}
        for key, tensor in safetensors_io.iter_file(path):
            parts = key.split(".")
            try:
                layer = int(parts[parts.index("layers") + 1])
            except (ValueError, IndexError):
                continue
            proj = next(
                (t for p, t in peft_to_target.items() if p in key), None
            )
            if proj is None:
                continue
            ab = "A" if "lora_A" in key else "B"
            per_target.setdefault(proj, {}).setdefault(layer, {})[ab] = (
                tensor
            )
        out: dict = {}
        for t, layers in per_target.items():
            if len(layers) != L:
                raise ValueError(
                    f"adapter covers {len(layers)} layers for {t}, "
                    f"model has {L}"
                )
            # torch lora_A: (r, in) -> ours (in, r); lora_B: (out, r) ->
            # ours (r, out)
            out[f"{t}_A"] = torch.stack([layers[i]["A"].t()
                                         for i in range(L)])
            out[f"{t}_B"] = torch.stack([layers[i]["B"].t()
                                         for i in range(L)])
        # PEFT scaling convention: lora_alpha / r from adapter_config.json
        cfg_path = os.path.join(os.path.dirname(path),
                                "adapter_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            alpha = cfg.get("lora_alpha")
            r = cfg.get("r")
            if alpha and r:
                out["scaling"] = np.float32(alpha / r)
        return out


def save_adapter_npz(path: str, weights: dict) -> None:
    """Write an adapter in the native .npz format (tests, tooling)."""
    np.savez(path, **weights)


def write_peft_adapter(dirpath: str, weights: dict, lora_alpha: float,
                       ) -> str:
    """Write an adapter in the HF PEFT layout (tests, tooling):
    ``adapter_model.safetensors`` with per-layer ``lora_A`` (r, in) and
    ``lora_B`` (out, r) of each target in `weights` (our (L, in, r) /
    (L, r, out) arrays or tensors) and ``adapter_config.json`` with r and
    `lora_alpha` (scaling = lora_alpha / r). Returns the directory."""
    os.makedirs(dirpath, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    rank = None
    for t in TARGETS:
        if f"{t}_A" not in weights:
            continue
        A = torch.as_tensor(weights[f"{t}_A"])
        B = torch.as_tensor(weights[f"{t}_B"])
        rank = A.shape[-1]
        mod = PEFT_MODULES[t]
        for layer in range(A.shape[0]):
            base = (f"base_model.model.model.layers.{layer}.self_attn."
                    f"{mod}")
            tensors[f"{base}.lora_A.weight"] = A[layer].t().contiguous()
            tensors[f"{base}.lora_B.weight"] = B[layer].t().contiguous()
    safetensors_io.save_file(tensors, os.path.join(
        dirpath, "adapter_model.safetensors"))
    with open(os.path.join(dirpath, "adapter_config.json"), "w") as f:
        json.dump({
            "peft_type": "LORA", "r": int(rank), "lora_alpha": lora_alpha,
            "target_modules": [PEFT_MODULES[t] for t in TARGETS
                               if f"{t}_A" in weights],
        }, f, indent=1)
    return dirpath
