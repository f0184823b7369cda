"""Tokenizer abstraction: HF tokenizers for real checkpoints, a byte-level
tokenizer for hermetic tests/benchmarks (no network, matching the reference's
practice of testing with tiny stand-in models — reference:
.github/workflows/router-e2e-test.yml uses facebook/opt-125m).
"""

from __future__ import annotations

import os
from typing import Protocol

_DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>\n{{ message['content'] }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


class Tokenizer(Protocol):
    eos_token_id: int | None
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, token_ids: list[int]) -> str: ...
    def apply_chat_template(self, messages: list[dict]) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer with BOS/EOS specials. Hermetic, vocab 384."""

    BOS = 256
    EOS = 257

    def __init__(self):
        self.eos_token_id = self.EOS
        self.bos_token_id = self.BOS
        self.vocab_size = 384

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, token_ids: list[int]) -> str:
        data = bytes(t for t in token_ids if 0 <= t < 256)
        return data.decode("utf-8", errors="replace")

    def token_strings(self) -> list[str]:
        """Per-token strings for constrained decoding (structured.py):
        byte ids render alone; specials/unused ids are never forced."""
        return [
            bytes([i]).decode("utf-8", errors="replace") if i < 256 else ""
            for i in range(self.vocab_size)
        ]

    def apply_chat_template(self, messages: list[dict]) -> str:
        override = getattr(self, "chat_template_override", None)
        if override is not None:
            return _render_template(override, messages)
        parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
        parts.append("<|assistant|>\n")
        return "".join(parts)


class HFTokenizer:
    """Wrapper over a local HuggingFace tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            path, local_files_only=True
        )
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = getattr(self._tok, "bos_token_id", None)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, token_ids: list[int]) -> str:
        return self._tok.decode(token_ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict]) -> str:
        override = getattr(self, "chat_template_override", None)
        if override is not None:
            return _render_template(override, messages)
        if self._tok.chat_template is not None:
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        return _render_template(_DEFAULT_CHAT_TEMPLATE, messages)


def _render_template(template: str, messages: list[dict]) -> str:
    import jinja2

    return jinja2.Template(template).render(
        messages=messages, add_generation_prompt=True
    )


def get_tokenizer(
    spec: str | None, model: str, chat_template: str | None = None
) -> Tokenizer:
    """Resolve the tokenizer.

    - explicit "byte" -> hermetic ByteTokenizer
    - explicit path (``spec``) -> must load, else raise (a silent fallback
      would serve garbage tokens against real weights)
    - no spec: the model dir if it is one, else (weight-free preset) the
      ByteTokenizer with a log line.

    ``chat_template``: optional Jinja override (a template string, or a
    path to a file containing one) applied over whatever the tokenizer
    ships — the ``--chat-template`` serving knob (reference capability:
    helm/values.yaml ``chatTemplate`` per modelSpec).
    """
    from production_stack_tpu_torch.utils import init_logger

    logger = init_logger(__name__)
    explicit = spec is not None
    spec = spec or model
    if spec == "byte":
        tok: Tokenizer = ByteTokenizer()
    elif os.path.isdir(spec):
        tok = HFTokenizer(spec)  # raises on a broken checkpoint dir
    elif explicit:
        raise ValueError(
            f"tokenizer path {spec!r} does not exist; pass 'byte' for the "
            "hermetic byte tokenizer"
        )
    else:
        logger.info(
            "model %r is a weight-free preset; using the hermetic byte "
            "tokenizer", model,
        )
        tok = ByteTokenizer()
    if chat_template:
        if os.path.isfile(chat_template):
            with open(chat_template) as f:
                chat_template = f.read()
        elif "{" not in chat_template:
            # path-looking string (no Jinja syntax) whose file is
            # missing: rendering it verbatim would silently corrupt
            # every chat prompt — fail at startup instead
            raise ValueError(
                f"chat template file {chat_template!r} does not exist "
                "(an inline template must contain Jinja '{{ ... }}' "
                "syntax)"
            )
        tok.chat_template_override = chat_template  # type: ignore[union-attr]
    return tok
