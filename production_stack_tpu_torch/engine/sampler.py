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
same noise. A fused K-step round draws its whole (K, b, TOP_CAP) block
at once (`round_noise`, keys (seed, step + i)), so K fused steps sample
exactly what K single steps would.
"""

from __future__ import annotations

import numpy as np
import torch

TOP_CAP = 64
LOGPROB_CAP = 20  # top-N logprob bucket; hosts slice to the requested N

# device-side stop masks (fused decode): the token a frozen lane's
# sampled slot is pinned to. The host reads only each lane's valid
# count of tokens, never the pinned slots.
STOP_PAD_TOKEN = 0

# unified ragged rounds: the sentinel a NON-prefill lane's sampled
# first-token slot is pinned to (negative, so it never collides with a
# real token id); hosts consume only rows >= 0.
RAGGED_IDLE_TOKEN = -1


# stackcheck: not-hot — numpy Philox draws from host key arrays
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


# stackcheck: not-hot — numpy noise of a fused round from host key
# arrays, built while the buffer is filled
def round_noise(key_data: np.ndarray, temps: np.ndarray, k_steps: int,
                top_cap: int = TOP_CAP) -> np.ndarray:
    """(b, 2) base keys -> (k_steps, b, top_cap) noise for a fused round:
    row (i, lane) is gumbel_noise of key (seed, step + i). Greedy lanes
    (temperature <= 0) get zeros: the sampler never reads their noise."""
    key_data = np.asarray(key_data, np.uint64).reshape(-1, 2)
    out = np.zeros((k_steps, key_data.shape[0], top_cap), np.float32)
    steps = np.arange(k_steps, dtype=np.uint64)
    for lane in np.flatnonzero(np.asarray(temps, np.float32) > 0.0):
        seed, step = key_data[lane]
        keys = np.stack([np.full_like(steps, seed), step + steps], axis=1)
        out[:, lane] = gumbel_noise(keys, top_cap)
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


def stop_hit(
    tokens: torch.Tensor,            # (b,) int32 just-sampled tokens
    eos_ids: torch.Tensor,           # (b,) int32 per-lane EOS (-1 = none)
    stop_ids: torch.Tensor | None,   # (b, cap) int32 padded with -1
) -> torch.Tensor:
    """Per-lane bool: the sampled token is that lane's EOS or one of its
    stop_token_ids. The min_tokens / max_tokens gates are the caller's
    (they depend on the loop's per-lane counts). -1 never matches."""
    hit = tokens == eos_ids
    if stop_ids is not None:
        hit = hit | (tokens[:, None] == stop_ids).any(dim=1)
    return hit


def token_logprobs(
    logits: torch.Tensor,  # (b, vocab) float32, post-penalty
    tokens: torch.Tensor,  # (b,) int32 chosen tokens
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row chosen-token logprob and the top-LOGPROB_CAP alternatives
    from log_softmax of the (pre-temperature) logits. Returns (chosen
    (b,), top_vals (b, CAP), top_ids (b, CAP) int32)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(lp, 1, tokens.long()[:, None])[:, 0]
    top_vals, top_ids = torch.topk(lp, LOGPROB_CAP, dim=-1)
    return chosen, top_vals, top_ids.to(torch.int32)
