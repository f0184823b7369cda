"""Mixture-of-experts ops: top-k gating and two compute paths.

Counterpart of ``production_stack_tpu/ops/moe.py``, same names,
signatures and semantics, in plain PyTorch: the JAX package computes
these in XLA, with no Pallas kernel. Each expert's products are
``matmul_f32`` GEMMs (f32 results of the operands' dtype, as
preferred_element_type=f32), one expert at a time.

- ``moe_dense``: every token runs every expert, weighted by the sparse
  gate matrix. Exact (no token dropping); the serving path.
- ``moe_capacity``: GShard-style static dispatch, each expert a fixed
  capacity of tokens gathered by one-hot einsums; tokens past an
  expert's capacity are dropped. Offline callers only (the model runner
  refuses a capacity factor above 0).

Gating follows Mixtral (HF MixtralSparseMoeBlock): softmax over each
token's top-k logits only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from production_stack_tpu_torch.ops.layers import matmul_f32


def top_k_gating(x: torch.Tensor, gate_w: torch.Tensor,
                 k: int) -> torch.Tensor:
    """x [n,d] @ gate_w [d,E] -> sparse gates [n,E] f32, each row summing
    to 1 over its token's top-k experts, zero elsewhere."""
    logits = matmul_f32(x, gate_w)
    top_v, top_i = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(top_v, dim=-1)
    return torch.zeros_like(logits).scatter(1, top_i, probs)


def _expert_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """One expert's SwiGLU over rows x [n,d]: (silu(x W_gate) * (x W_up))
    W_down, f32 products of the operands (matmul_f32), the activation
    cast to x's dtype before W_down. Returns [n,d] f32."""
    a = F.silu(matmul_f32(x, w_gate)) * matmul_f32(x, w_up)
    return matmul_f32(a.to(x.dtype), w_down)


def moe_dense(x: torch.Tensor, gates: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Exact all-experts path. x [n,d]; w_gate/w_up [E,d,f]; w_down
    [E,f,d]; gates [n,E]. Every expert runs on every row (a row's
    weight is 0 at the experts it was not routed to). Returns [n,d]
    f32."""
    out = torch.zeros((x.shape[0], w_down.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for e in range(w_gate.shape[0]):
        y = _expert_mlp(x, w_gate[e], w_up[e], w_down[e])
        out += y * gates[:, e, None]
    return out


def capacity_needed(gates: torch.Tensor) -> torch.Tensor:
    """Max tokens routed to any one expert (the no-drop capacity)."""
    return (gates > 0).sum(dim=0).max()


def moe_capacity(x: torch.Tensor, gates: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, capacity: int,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """GShard static-capacity path: tokens beyond `capacity` per expert
    are dropped (combine weight zero: they keep their residual stream).
    Shapes as in moe_dense. `valid` ([n] bool) masks padding rows out, so
    they take no expert capacity from real tokens."""
    if valid is not None:
        gates = gates * valid[:, None].to(gates.dtype)
    mask = gates > 0
    # rank of each token within its expert's arrival order
    pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1  # [n,E]
    keep = mask & (pos < capacity)
    disp = keep[..., None] & (
        pos[..., None] == torch.arange(capacity, device=x.device))
    disp_f = disp.to(torch.float32)  # [n,E,C]
    # one token at most a (expert, slot): the gather is exact in x's dtype
    xe = torch.einsum("nec,nd->ecd", disp_f, x.float()).to(x.dtype)
    ye = torch.stack([
        _expert_mlp(xe[e], w_gate[e], w_up[e], w_down[e])
        for e in range(xe.shape[0])
    ])  # [E,C,d] f32
    comb = disp_f * gates[..., None]
    return torch.einsum("nec,ecd->nd", comb, ye)


def moe_block(x: torch.Tensor, gate_w: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor,
              num_experts_per_tok: int, capacity_factor: float = 0.0,
              valid: torch.Tensor | None = None,
              first_expert: int = 0) -> torch.Tensor:
    """The MoE MLP block: gate, then compute. capacity_factor 0 selects
    the exact dense path (serving); > 0 GShard dispatch with C =
    ceil(k * n * factor / E), for callers that pass `valid` when rows
    include padding.

    Expert parallelism: `w_gate` / `w_up` / `w_down` may hold a rank's
    experts only, [first_expert, first_expert + w_gate.shape[0]) of the
    router's E columns. The gating still runs over all E (the same top-k
    on every rank), and the dense path runs the rank's experts with
    their gate columns: the rank's share of the output, which the
    caller sums over the ranks (the JAX package's dispatch and combine,
    summed in another order)."""
    gates = top_k_gating(x, gate_w, num_experts_per_tok)
    held = w_gate.shape[0]
    if held != gates.shape[1]:
        if capacity_factor > 0:
            raise ValueError("the capacity path runs every expert; under "
                             "expert parallelism serve capacity_factor 0")
        gates = gates[:, first_expert:first_expert + held]
    if capacity_factor <= 0:
        return moe_dense(x, gates, w_gate, w_up, w_down)
    n, e = gates.shape
    # stackcheck: disable=device-sync-transitive — n and e are
    # gates.shape, capacity_factor a config float: host arithmetic
    cap = max(1, int(-(-num_experts_per_tok * n * capacity_factor // e)))
    return moe_capacity(x, gates, w_gate, w_up, w_down, cap, valid)
