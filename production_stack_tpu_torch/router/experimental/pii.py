"""PII detection middleware: scan request content, block or log.

Capability parity with the reference's PII subsystem (reference:
src/vllm_router/experimental/pii/ — middleware.py:43 check_pii_content,
analyzers/base.py:30 PIIAnalyzer ABC, regex analyzer + optional Presidio
analyzer, Prometheus counters). Presidio is optional here too; the regex
analyzer is the hermetic default.
"""

from __future__ import annotations

import abc
import re
from dataclasses import dataclass

from production_stack_tpu_torch.utils import web

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)


@dataclass
class PIIMatch:
    entity_type: str
    start: int
    end: int
    text: str


class PIIAnalyzer(abc.ABC):
    @abc.abstractmethod
    def analyze(self, text: str) -> list[PIIMatch]:
        ...


class RegexAnalyzer(PIIAnalyzer):
    """Pattern-based PII detection (reference: analyzers regex impl)."""

    PATTERNS: dict[str, re.Pattern] = {
        "EMAIL": re.compile(
            r"\b[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}\b"
        ),
        "SSN": re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),
        "CREDIT_CARD": re.compile(
            r"\b(?:\d[ -]?){13,16}\b"
        ),
        "PHONE": re.compile(
            r"\b(?:\+?\d{1,3}[ .-]?)?(?:\(\d{2,4}\)[ .-]?)?"
            r"\d{3}[ .-]\d{3,4}[ .-]?\d{0,4}\b"
        ),
        "IP_ADDRESS": re.compile(
            r"\b(?:(?:25[0-5]|2[0-4]\d|1?\d?\d)\.){3}"
            r"(?:25[0-5]|2[0-4]\d|1?\d?\d)\b"
        ),
        "API_KEY": re.compile(
            r"\b(?:sk|pk|api|key|token)[-_][A-Za-z0-9_-]{16,}\b",
            re.IGNORECASE,
        ),
        "IBAN": re.compile(r"\b[A-Z]{2}\d{2}[A-Z0-9]{11,30}\b"),
    }

    def __init__(self, entities: list[str] | None = None):
        names = entities or list(self.PATTERNS)
        self.patterns = {n: self.PATTERNS[n] for n in names
                         if n in self.PATTERNS}

    @staticmethod
    def _luhn_ok(digits: str) -> bool:
        """Luhn checksum — keeps benign long numeric ids (order numbers,
        timestamps) from being flagged (and blocked) as credit cards."""
        total, parity = 0, len(digits) % 2
        for i, ch in enumerate(digits):
            d = ord(ch) - 48
            if i % 2 == parity:
                d *= 2
                if d > 9:
                    d -= 9
            total += d
        return total % 10 == 0

    def analyze(self, text: str) -> list[PIIMatch]:
        out: list[PIIMatch] = []
        for name, pat in self.patterns.items():
            for m in pat.finditer(text):
                if name == "CREDIT_CARD":
                    digits = re.sub(r"\D", "", m.group())
                    if not (13 <= len(digits) <= 16
                            and self._luhn_ok(digits)):
                        continue
                out.append(PIIMatch(name, m.start(), m.end(), m.group()))
        return out


class PresidioAnalyzer(PIIAnalyzer):  # pragma: no cover — optional dep
    def __init__(self):
        from presidio_analyzer import AnalyzerEngine

        self._engine = AnalyzerEngine()

    def analyze(self, text: str) -> list[PIIMatch]:
        results = self._engine.analyze(text=text, language="en")
        return [
            PIIMatch(r.entity_type, r.start, r.end, text[r.start: r.end])
            for r in results
        ]


def _request_texts(body: dict) -> list[str]:
    out = []
    p = body.get("prompt")
    if isinstance(p, str):
        out.append(p)
    elif isinstance(p, list):
        out.extend(x for x in p if isinstance(x, str))
    for m in body.get("messages") or []:
        if isinstance(m, dict) and isinstance(m.get("content"), str):
            out.append(m["content"])
    inp = body.get("input")
    if isinstance(inp, str):
        out.append(inp)
    elif isinstance(inp, list):
        out.extend(x for x in inp if isinstance(x, str))
    return out


class PIIMiddleware:
    """check() a request before routing (reference: pii/middleware.py:43).

    action="block"  -> 400 response naming the entity types found
    action="log"    -> allow through, log a warning
    """

    def __init__(self, analyzer: str | PIIAnalyzer = "regex",
                 action: str = "block",
                 entities: list[str] | None = None):
        if isinstance(analyzer, PIIAnalyzer):
            self.analyzer = analyzer
        elif analyzer == "presidio":
            try:
                self.analyzer = PresidioAnalyzer()
            except Exception:  # noqa: BLE001 — not installed on this image
                logger.warning("presidio unavailable; using regex analyzer")
                self.analyzer = RegexAnalyzer(entities)
        else:
            self.analyzer = RegexAnalyzer(entities)
        self.action = action
        self.requests_scanned = 0
        self.requests_flagged = 0

    async def check(self, request: web.Request) -> web.Response | None:
        try:
            body = await request.json()
        # stackcheck: disable=silent-except — non-JSON bodies carry no
        # scannable fields; skipping them is the designed fast path
        except Exception:  # noqa: BLE001
            return None
        self.requests_scanned += 1
        matches: list[PIIMatch] = []
        for text in _request_texts(body):
            matches.extend(self.analyzer.analyze(text))
        if not matches:
            return None
        self.requests_flagged += 1
        types = sorted({m.entity_type for m in matches})
        logger.warning("PII detected (%s): %s",
                       self.action, ",".join(types))
        if self.action == "block":
            return web.json_response(
                {"error": {
                    "message":
                        f"request blocked: PII detected ({', '.join(types)})",
                    "type": "invalid_request_error",
                    "code": "pii_detected",
                }},
                status=400,
            )
        return None  # action == "log": allow

    def stats(self) -> dict:
        return {"scanned": self.requests_scanned,
                "flagged": self.requests_flagged}
