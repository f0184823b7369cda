"""The control: the reference computed in the nearest precision below
the configuration's bfloat16, float8 (e4m3) weights with one scale per
output channel, dequantized to float32 for the products. It stands where
a later change to fp8 weights would, and the comparison has to call it
wrong."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """(in, out) matrix rounded to float8 e4m3, per output column."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale
