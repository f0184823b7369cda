"""Batched token sampler on PyTorch tensors.

Counterpart of ``production_stack_tpu/engine/sampler.py``: temperature /
top-k / top-p / min-p are per-row vectors, the candidates are the
TOP_CAP largest logits, greedy rows (temperature 0) take the exact
full-vocab argmax, and a sampled row takes argmax(masked + gumbel noise).

Randomness: JAX derives each row's gumbel noise from a per-row key
(seed, step). Here the noise is an input: `gumbel_noise` makes it from
the same (seed, step) key data with numpy's counter-based Philox, so a
row's draw depends only on its own key, never on the batch around it.
The numbers differ from JAX's threefry; tests hand both samplers the
same noise.
"""

from __future__ import annotations

import numpy as np
import torch

TOP_CAP = 64
LOGPROB_CAP = 20  # top-N logprob bucket; hosts slice to the requested N


def gumbel_noise(key_data: np.ndarray, top_cap: int = TOP_CAP) -> np.ndarray:
    """(b, 2) uint32 key data -> (b, top_cap) float32 gumbel noise."""
    key_data = np.asarray(key_data, np.uint64).reshape(-1, 2)
    out = np.empty((key_data.shape[0], top_cap), np.float32)
    for i, (seed, step) in enumerate(key_data):
        gen = np.random.Generator(
            np.random.Philox(key=int(seed) << 32 | int(step))
        )
        out[i] = gen.gumbel(size=top_cap)
    return out


def sample_tokens(
    logits: torch.Tensor,       # (b, vocab) float32
    temperature: torch.Tensor,  # (b,) float32; 0 => greedy
    top_p: torch.Tensor,        # (b,) float32 in (0, 1]
    top_k: torch.Tensor,        # (b,) int32; <= 0 => disabled
    gumbel: torch.Tensor,       # (b, top_cap) float32 noise
    min_p: torch.Tensor | None = None,  # (b,) float32; 0 => off
) -> torch.Tensor:
    """Sample one token per row. Returns (b,) int32."""
    top_cap = gumbel.shape[1]
    greedy_ids = torch.argmax(logits, dim=-1)

    vals, idxs = torch.topk(logits, top_cap, dim=-1)  # descending
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = vals / temp

    ranks = torch.arange(top_cap, device=logits.device)[None, :]
    k = torch.where(top_k[:, None] <= 0, top_cap, top_k[:, None])
    keep_k = ranks < torch.clamp(k, max=top_cap)

    # nucleus: keep entries whose preceding cumulative mass is < top_p
    neg_inf = torch.full_like(scaled, float("-inf"))
    probs = torch.softmax(torch.where(keep_k, scaled, neg_inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[:, None]

    keep = keep_k & keep_p
    if min_p is not None:
        keep = keep & (probs >= min_p[:, None] * probs[:, 0:1])
    keep[:, 0] = True  # never mask the argmax candidate
    masked = torch.where(keep, scaled, neg_inf)

    choice = torch.argmax(masked + gumbel, dim=-1)
    sampled = torch.gather(idxs, 1, choice[:, None]).squeeze(1)
    return torch.where(temperature <= 0.0, greedy_ids, sampled).to(
        torch.int32
    )


def apply_penalties(
    logits: torch.Tensor,         # (b, vocab) float32
    output_mask: torch.Tensor,    # (b, vocab) bool: token appeared in output
    output_counts: torch.Tensor,  # (b, vocab) float32: occurrences in output
    presence: torch.Tensor,       # (b,)
    frequency: torch.Tensor,      # (b,)
    repetition: torch.Tensor,     # (b,)
) -> torch.Tensor:
    """OpenAI-style presence/frequency + HF-style repetition penalties."""
    logits = logits - presence[:, None] * output_mask
    logits = logits - frequency[:, None] * output_counts
    rep = repetition[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(output_mask, penalized, logits)
