"""Per-request sampling parameters (OpenAI-compatible surface)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1  # -1 = disabled
    # vLLM min_p role: drop candidates whose post-temperature probability
    # is below min_p * max_prob (0 = disabled)
    min_p: float = 0.0
    # OpenAI logit_bias role: token id -> additive bias in [-100, 100],
    # applied to the logits before sampling (after penalties, before any
    # guided-constraint mask)
    logit_bias: dict[int, float] | None = None
    n: int = 1
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    # vLLM include_stop_str_in_output role: keep the matched stop string
    # in the returned text instead of truncating before it
    include_stop_str_in_output: bool = False
    # vLLM truncate_prompt_tokens role: keep only the LAST N prompt
    # tokens; -1 = truncate to the model's max length (None = off)
    truncate_prompt_tokens: int | None = None
    ignore_eos: bool = False
    seed: int | None = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logprobs: int | None = None
    # vLLM prompt_logprobs role: per-prompt-token logprob of the token
    # given its preceding context, plus top-N alternatives (position 0
    # has no context -> None). Disables prefix-cache reuse for the
    # request (cached positions would otherwise skip computation).
    prompt_logprobs: int | None = None
    min_tokens: int = 0
    # structured output (vLLM guided_choice role): the generation must
    # be exactly one of these strings — logits are masked to the tokens
    # that extend a still-matching choice
    guided_choice: list[str] | None = None
    # structured output (vLLM guided_json / guided_regex roles): the
    # generation must parse against this JSON schema (dict or JSON
    # string; {} / True = any JSON value) / fully match this regex.
    # Compiled to a character-level machine whose per-state token masks
    # constrain sampling (engine/structured.py).
    guided_json: dict | str | None = None
    guided_regex: str | None = None
    # structured output (vLLM guided_grammar role): the generation must
    # derive from the `root` rule of this EBNF grammar (GBNF-style
    # syntax; engine/structured.GrammarMachine)
    guided_grammar: str | None = None

    def __post_init__(self) -> None:
        n_guided = sum(
            x is not None
            for x in (self.guided_choice, self.guided_json,
                      self.guided_regex, self.guided_grammar)
        )
        if n_guided > 1:
            raise ValueError(
                "at most one of guided_choice / guided_json / "
                "guided_regex / guided_grammar may be set"
            )
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k == 0 or self.top_k < -1:
            raise ValueError("top_k must be -1 (disabled) or >= 1")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")
        if self.prompt_logprobs is not None and not (
            0 <= self.prompt_logprobs <= 20
        ):
            raise ValueError("prompt_logprobs must be in [0, 20]")
        if self.truncate_prompt_tokens is not None and (
            self.truncate_prompt_tokens < 1
            and self.truncate_prompt_tokens != -1
        ):
            raise ValueError(
                "truncate_prompt_tokens must be >= 1, or -1 for the "
                "model's max length"
            )
        if self.logit_bias is not None:
            try:
                self.logit_bias = {
                    int(t): float(v) for t, v in self.logit_bias.items()
                }
            except (TypeError, ValueError, AttributeError):
                raise ValueError(
                    "logit_bias must map token ids to numbers"
                ) from None
            for t, v in self.logit_bias.items():
                if t < 0:
                    raise ValueError("logit_bias token ids must be >= 0")
                if not -100.0 <= v <= 100.0:
                    raise ValueError(
                        "logit_bias values must be in [-100, 100]"
                    )
            if not self.logit_bias:
                self.logit_bias = None
        if isinstance(self.stop, str):
            self.stop = [self.stop]

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def truncate_prompt(
    ids: list[int], sp: "SamplingParams", max_model_len: int
) -> list[int]:
    """vLLM truncate_prompt_tokens: keep the LAST N prompt tokens
    (-1 = the model's max length, leaving room for one generated
    token). The ONE implementation shared by the server gate and
    engine admission so the two can never drift."""
    n = sp.truncate_prompt_tokens
    if n is None:
        return ids
    if n == -1:
        n = max_model_len - 1
    return ids[-n:]
