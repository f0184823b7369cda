"""Incremental detokenization: O(1) amortised host time per token.

The naive streaming loop re-decodes the FULL generated id list after
every token — O(n^2) host time per stream on the step loop's critical
path (the reference's engines get vLLM's incremental detokenizer; this
is ours). Two wrinkles make "decode the new id and append" wrong:

- UTF-8: a multi-byte character can span tokens; its partial prefix
  decodes to U+FFFD until complete.
- Subword tokenizers: an id's text can depend on its neighbours
  (byte-level BPE byte joins, metaspace leading-space stripping), so
  `decode(a) + decode(b) != decode(a + b)` in general.

Strategy (the shape of vLLM's detokenize_incrementally): decode only a
bounded tail — a few already-committed CONTEXT ids plus the uncommitted
window — and splice the window's text after the committed text by
stripping the context's own rendering. The commit point only advances
when re-decoding with context reproduces the committed prefix exactly;
when a tokenizer ever violates that (context affects text at a distance
greater than CONTEXT), the step falls back to a full decode, so the
output is ALWAYS bit-identical to `tokenizer.decode(all_ids)` — parity
asserted per-step by tests over random streams."""

from __future__ import annotations

CONTEXT = 4   # committed ids re-decoded for boundary context
WINDOW = 16   # max uncommitted ids before the commit point advances
KEEP = 4      # uncommitted ids kept behind after an advance


class IncrementalDetokenizer:
    """Per-sequence streaming decoder.

    append(token_id) -> current full text (== decode(all ids so far)).
    """

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._c = 0  # ids[:c] are committed
        self._committed = ""  # == decode(ids[:c])

    def append(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._render()
        if len(self._ids) - self._c > WINDOW:
            self._advance()
        return text

    def current(self) -> str:
        return self._render()

    # -- internals ---------------------------------------------------------
    def _ctx_start(self) -> int:
        return max(0, self._c - CONTEXT)

    def _render(self) -> str:
        """committed + context-spliced tail; full decode on any doubt."""
        s = self._ctx_start()
        ctx_text = self._tok.decode(self._ids[s:self._c])
        tail = self._tok.decode(self._ids[s:])
        if tail.startswith(ctx_text):
            return self._committed + tail[len(ctx_text):]
        # context interacted with committed text at a distance — rare
        # (never for our byte/BPE tokenizers); correctness wins
        return self._tok.decode(self._ids)

    def _advance(self) -> None:
        """Move the commit point, keeping `_committed == decode(ids[:c])`.

        A candidate boundary is safe when the chunk's rendering is a
        prefix of the joint decode of everything pending — that holds
        for permanently-invalid bytes (their U+FFFD never changes) but
        not for a split mid-character (the joint decode renders the
        completed char differently). A UTF-8 char spans at most 4 bytes,
        so stepping the boundary back up to 4 ids always finds a safe
        cut; without this, a long invalid-byte run would grow the window
        unboundedly and regress to O(n^2) re-decoding."""
        s = self._ctx_start()
        ctx_text = self._tok.decode(self._ids[s:self._c])
        joint = self._tok.decode(self._ids[s:])
        target = len(self._ids) - KEEP
        for t in range(target, max(self._c, target - 4), -1):
            chunk = self._tok.decode(self._ids[s:t])
            if chunk.startswith(ctx_text) and joint.startswith(chunk):
                self._committed += chunk[len(ctx_text):]
                self._c = t
                return
        # No candidate cut within 4 ids was safe — a tokenizer violating
        # the CONTEXT-locality assumption could hit this on every append
        # and grow the uncommitted window without bound (back to the
        # O(n^2) behavior this module exists to avoid). Bound the window
        # with a forced full-decode commit; `_render` stays correct
        # because `_committed` equals decode(ids[:c]) by construction.
        if len(self._ids) - self._c > 4 * WINDOW:
            self._committed = self._tok.decode(self._ids[:target])
            self._c = target
