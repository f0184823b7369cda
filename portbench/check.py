"""What decides ``correct``: the served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the requests the window served is run through the float32 reference,
each request once over its prompt and served tokens: REQUESTS distinct
requests (the longest, then others drawn from the seed), so that the
sample spans the slots of the batch, and at most TOKENS_EACH served
positions of each (its last, then others drawn from the seed), so that no
one request fills the sample. At each position the reference's best
logit lies some gap above the logit of the token the program served; a
greedy token computed right lies within the rounding of bf16 of the
best. The number compared is the widest gap over the sample.

The control reads the same gap for the token that the float8 reference
(``reference.control``) puts first at each of those positions.
"""

from __future__ import annotations

import random

import torch

from portbench.reference import model as ref_model
from portbench.reference.control import fp8_weight

SAMPLE_SALT = 0x5EED
REQUESTS = 12      # distinct requests compared in a run
TOKENS_EACH = 32   # served positions compared in each


def draw_sample(requests, seed: int) -> list[tuple[object, list[int]]]:
    """(request, served positions) pairs: the longest finished request,
    then others in an order drawn from the seed, REQUESTS in all (fewer
    only when fewer finished); of each, its last served position and
    others drawn from the seed, TOKENS_EACH in all."""
    done = [r for r in requests if r.finished and r.output_ids]
    if not done:
        return []
    done.sort(key=lambda r: r.index)
    longest = max(done, key=lambda r: (r.prompt_len + len(r.output_ids),
                                       -r.index))
    rng = random.Random(int(seed) * 1000003 + SAMPLE_SALT)
    rest = [r for r in done if r is not longest]
    rng.shuffle(rest)
    sample = []
    for r in [longest] + rest[:REQUESTS - 1]:
        n = len(r.output_ids)
        picks = rng.sample(range(n - 1), min(n - 1, TOKENS_EACH - 1))
        sample.append((r, sorted(picks) + [n - 1]))
    return sample


def gaps_of(hf: dict, params: dict, req, positions: list[int], device,
            control: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """At each of `req`'s served `positions`: the reference's best logit
    minus the logit of the served token; with `control`, also minus the
    logit of the float8 reference's first choice there."""
    last = positions[-1]
    seq = req.prompt_ids + req.output_ids[:last]
    tokens = torch.tensor(seq, dtype=torch.long, device=device)
    p = req.prompt_len
    rows = torch.tensor([p - 1 + i for i in positions], device=device)
    served = torch.tensor([req.output_ids[i] for i in positions],
                          dtype=torch.long, device=device)
    ref = ref_model.logits(hf, params, tokens, rows)
    best = ref.max(-1).values
    gap = best - ref.gather(1, served[:, None])[:, 0]
    ctl_gap = None
    if control:
        low = ref_model.logits(hf, params, tokens, rows, weight=fp8_weight)
        pick = low.argmax(-1)
        ctl_gap = best - ref.gather(1, pick[:, None])[:, 0]
    return gap, ctl_gap


def judge(hf: dict, params: dict, sample, device,
          control: bool = False) -> dict:
    """The widest gap over the sample (and the control's), with counts."""
    worst = worst_ctl = 0.0
    positions = 0
    with torch.no_grad():
        for req, at in sample:
            gap, ctl = gaps_of(hf, params, req, at, device, control)
            worst = max(worst, float(gap.max()))
            if ctl is not None:
                worst_ctl = max(worst_ctl, float(ctl.max()))
            positions += gap.numel()
    out = {"max_logit_gap": worst, "positions": positions,
           "requests": len(sample)}
    if control:
        out["control_max_logit_gap"] = worst_ctl
    return out
