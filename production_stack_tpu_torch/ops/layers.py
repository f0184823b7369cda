"""Elementwise / normalization / rotary ops on PyTorch tensors.

Counterpart of ``production_stack_tpu/ops/layers.py``: the same math,
accumulated in float32 and cast back to the input dtype at the same
places, so the two packages round alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with float32 accumulation, cast back to input dtype.

    `offset` supports zero-centered norm weights (Gemma stores w - 1 and
    the model multiplies by 1 + w)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (weight.float() + offset)).to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions. Returns (N, head_dim) each.

    HF-Llama convention: frequencies over the first half of the head dim,
    duplicated across halves (rotate-half formulation)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) * (2.0 / head_dim)
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[:, None] * inv_freq[None, :]
    cos = torch.cos(freqs)
    sin = torch.sin(freqs)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply rotary embeddings.

    q: (N, num_heads, head_dim), k: (N, num_kv_heads, head_dim),
    cos/sin: (N, head_dim)."""
    cos = cos[:, None, :].float()
    sin = sin[:, None, :].float()

    def rot(x):
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    return rot(q), rot(k)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with a float32 result (JAX's preferred_element_type=f32).

    Float32 operands multiply in float32. Lower-precision operands keep
    the float32 accumulator unrounded: on the card the GEMM writes it out
    as float32 (``out_dtype``); on the CPU the operands are widened to
    float32 first, which gives the same products exactly."""
    if x.dtype == torch.float32:
        return x @ w.float()
    w = w.to(x.dtype)
    if not x.is_cuda:
        return x.float() @ w.float()
    out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: (act(x @ w_gate) * (x @ w_up)) @ w_down.

    act: "silu" (Llama/Mistral/Qwen SwiGLU) or "gelu_tanh" (Gemma
    GeGLU)."""
    pre = matmul_f32(x, w_gate)
    if act == "gelu_tanh":
        gate = F.gelu(pre, approximate="tanh")
    else:
        gate = F.silu(pre)
    up = matmul_f32(x, w_up)
    return matmul_f32((gate * up).to(x.dtype), w_down).to(x.dtype)
