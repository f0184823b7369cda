"""stackcheck core: rule framework, suppression handling, runner, output.

stackcheck is the repo-native static analyzer for the hazard classes this
serving stack actually ships: dead falsy-truthiness gates (an ``if err :=
check(...)`` gate is dead when the checked response is an empty, falsy
mapping), event-loop stalls from sync calls in ``async def`` bodies,
hidden host<->device syncs in engine hot loops, fire-and-forget asyncio
tasks that die silently, lock-guarded attributes touched without the lock,
and silent ``except Exception`` swallows on request paths.

Design:

- ``Rule`` subclasses register themselves via ``@register``; each yields
  ``Finding`` objects from ``check(ctx)`` where ``ctx`` is a parsed
  ``ModuleContext`` (AST + source lines + comment directives).
- Suppression is per-line: ``# stackcheck: disable=<rule>[,<rule>...] --
  justification`` on the flagged line, or on a pure-comment line directly
  above it, downgrades matching findings to "suppressed" (reported with
  ``--show-suppressed``, never fail the run). ``disable=all`` matches every
  rule. A justification is strongly encouraged; the runner records it.
- ``# stackcheck: hot-path`` on (or directly above) a ``def``, or above
  its first decorator, marks the function as a device-dispatch hot path
  for the device-sync rules, as does a ``@hot_path`` decorator. A nested
  ``def`` may carry the mark too: under PyTorch a closure runs eagerly on
  the host each time it is called, so one called every round is an entry
  point of its own.
- No third-party imports anywhere in this package: it must run on a bare
  CPython so CI / pre-push hooks need zero installs.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Iterator

DISABLE_RE = re.compile(
    r"#\s*stackcheck:\s*disable="
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
    r"(?:\s*(?:[-–—]+)\s*(?P<why>.*))?"
)
HOT_RE = re.compile(r"#\s*stackcheck:\s*hot-path\b")
# context markers (interprocedural; see analysis/README.md):
# not-hot declares a function a sanctioned hot-path BOUNDARY — transitive
# hot propagation stops there (the def's comment should say why);
# monotonic-only bans wall-clock reachability from a module or class;
# slo-finish marks a request-finish function for exactly-once-note.
NOT_HOT_RE = re.compile(r"#\s*stackcheck:\s*not-hot\b")
MONOTONIC_RE = re.compile(r"#\s*stackcheck:\s*monotonic-only\b")
SLO_FINISH_RE = re.compile(r"#\s*stackcheck:\s*slo-finish\b")
GUARDED_RE = re.compile(r"#\s*guarded by:\s*(?P<lock>[A-Za-z0-9_.()\[\]]+)")


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    justification: str | None = None

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: " \
               f"[{self.rule}]{tag} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    rules: frozenset[str]  # rule names, or {"all"}
    justification: str | None

    def covers(self, rule: str) -> bool:
        return "all" in self.rules or rule in self.rules


class ModuleContext:
    """Parsed view of one source file shared by every rule.

    Holds the AST, raw lines, comment directives (suppressions, hot-path
    marks, guarded-by annotations) and the module's import alias map so
    rules can resolve ``np.asarray`` -> ``numpy.asarray`` etc.
    """

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> Suppression
        self.suppressions: dict[int, Suppression] = {}
        # lines bearing a hot-path mark
        self.hot_lines: set[int] = set()
        # lines bearing the context markers
        self.not_hot_lines: set[int] = set()
        self.monotonic_lines: set[int] = set()
        self.slo_finish_lines: set[int] = set()
        # line -> lock expression string from "# guarded by: <lock>"
        self.guarded_lines: dict[int, str] = {}
        # pure-comment lines (a directive there applies to the next line)
        self._comment_only: set[int] = set()
        for i, raw in enumerate(self.lines, 1):
            stripped = raw.lstrip()
            if stripped.startswith("#"):
                self._comment_only.add(i)
            m = DISABLE_RE.search(raw)
            if m:
                rules = frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                why = (m.group("why") or "").strip() or None
                self.suppressions[i] = Suppression(rules, why)
            if HOT_RE.search(raw):
                self.hot_lines.add(i)
            if NOT_HOT_RE.search(raw):
                self.not_hot_lines.add(i)
            if MONOTONIC_RE.search(raw):
                self.monotonic_lines.add(i)
            if SLO_FINISH_RE.search(raw):
                self.slo_finish_lines.add(i)
            g = GUARDED_RE.search(raw)
            if g:
                self.guarded_lines[i] = g.group("lock").strip()
        self._extend_justifications()
        self.import_aliases = _collect_import_aliases(self.tree)

    def _extend_justifications(self) -> None:
        """A directive on a comment-only line may wrap its justification
        onto following comment-only lines; fold those in so reports show
        the full text."""
        for line, sup in self.suppressions.items():
            if line not in self._comment_only or sup.justification is None:
                continue
            parts = [sup.justification]
            nxt = line + 1
            while nxt in self._comment_only and \
                    nxt not in self.suppressions:
                parts.append(self.lines[nxt - 1].lstrip().lstrip("#")
                             .strip())
                nxt += 1
            sup.justification = " ".join(p for p in parts if p)

    # -- directives --------------------------------------------------------
    def suppression_for(self, line: int, rule: str) -> Suppression | None:
        """Suppression covering ``rule`` at ``line``: same line wins, else
        a directive anywhere in the contiguous block of pure-comment lines
        directly above (so justifications can wrap)."""
        s = self.suppressions.get(line)
        if s is not None and s.covers(rule):
            return s
        prev = line - 1
        while prev in self._comment_only:
            s = self.suppressions.get(prev)
            if s is not None and s.covers(rule):
                return s
            prev -= 1
        return None

    def marker_attaches(
        self, node: ast.FunctionDef | ast.AsyncFunctionDef | ast.ClassDef,
        lines: set[int],
    ) -> bool:
        """True when a marker line set covers ``node``: the marker sits
        on the def/class line itself or anywhere in the contiguous block
        of comment-only lines directly above it (the marker's rationale
        usually wraps)."""
        if node.lineno in lines:
            return True
        return self._in_block_above(node.lineno, lines)

    def _in_block_above(self, line: int, lines: set[int]) -> bool:
        prev = line - 1
        while prev in self._comment_only:
            if prev in lines:
                return True
            prev -= 1
        return False

    def marker_binds(
        self, func: ast.FunctionDef | ast.AsyncFunctionDef,
        lines: set[int],
    ) -> bool:
        """``marker_attaches``, or the marker sits in the comment block
        directly above the function's first decorator: a mark written
        above ``@torch.inference_mode()`` marks the function it
        decorates."""
        if self.marker_attaches(func, lines):
            return True
        if not func.decorator_list:
            return False
        first = min(d.lineno for d in func.decorator_list)
        return first in lines or self._in_block_above(first, lines)

    def is_hot(self, func: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
        """True if marked ``# stackcheck: hot-path`` on the def line or
        anywhere in the contiguous comment block directly above it or
        above its first decorator (the mark's rationale usually wraps),
        or decorated ``@hot_path``."""
        if self.marker_binds(func, self.hot_lines):
            return True
        for dec in func.decorator_list:
            if attr_tail(dec) == "hot_path":
                return True
            if isinstance(dec, ast.Call) and attr_tail(dec.func) == \
                    "hot_path":
                return True
        return False

    def is_not_hot(
        self, func: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> bool:
        """True if marked ``# stackcheck: not-hot`` — the function is a
        declared hot-path boundary (worker submission point / sanctioned
        fetch seam) and transitive hot propagation stops at it. Binds
        above a decorator list as ``is_hot`` does."""
        return self.marker_binds(func, self.not_hot_lines)

    def is_slo_finish(
        self, func: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> bool:
        """True if marked ``# stackcheck: slo-finish`` — every finish
        path of the function must note SLO exactly once
        (exactly-once-note)."""
        return self.marker_attaches(func, self.slo_finish_lines)


# -- shared AST helpers -----------------------------------------------------
def _collect_import_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local names to dotted origins: ``import numpy as np`` ->
    {"np": "numpy"}; ``from time import sleep`` -> {"sleep": "time.sleep"}."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def resolve_dotted(node: ast.expr, aliases: dict[str, str]) -> str | None:
    """Unparse an attribute chain to a dotted name, resolving the base
    through the module's import aliases. Returns None when the base is not
    a plain Name (e.g. a call result)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(aliases.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def attr_tail(node: ast.expr) -> str | None:
    """Last segment of a call target: ``a.b.c(...)`` -> "c"; ``f(...)`` ->
    "f"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def walk_function_body(
    func: ast.FunctionDef | ast.AsyncFunctionDef,
) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested def/class bodies
    (a nested def has its own execution context — a closure shipped to an
    executor or thread, or one the function calls each round — so its
    hazards are judged separately, against its own marks)."""
    stack: list[ast.AST] = list(func.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def iter_functions(
    tree: ast.Module,
) -> Iterator[ast.FunctionDef | ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# -- rule framework ---------------------------------------------------------
class Rule:
    """Base class: subclasses set ``name``/``summary`` and yield Findings
    from ``check``. Register with ``@register``."""

    name: str = ""
    summary: str = ""

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(
            rule=self.name,
            path=ctx.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


class ProjectRule(Rule):
    """Interprocedural rule: sees the whole scanned set as one
    ``ProjectContext`` (analysis/callgraph.py) instead of one module at
    a time, so it can follow calls across helpers, classes, and modules.
    Subclasses implement ``check_project(project)``; ``check`` is never
    called for these."""

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        return ()

    def check_project(self, project) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    assert cls.name, "rule classes must set a name"
    assert cls.name not in _REGISTRY, f"duplicate rule {cls.name!r}"
    _REGISTRY[cls.name] = cls()
    return cls


def all_rules() -> dict[str, Rule]:
    # import for side effect: rule modules self-register
    from production_stack_tpu_torch.analysis import rules  # noqa: F401

    return dict(_REGISTRY)


# -- runner -----------------------------------------------------------------
@dataclasses.dataclass
class Report:
    findings: list[Finding]
    files_scanned: int

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    def to_dict(self) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "findings": [f.to_dict() for f in self.unsuppressed],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "summary": self.summary(),
        }

    def summary(self) -> dict:
        by_rule: dict[str, int] = {}
        for f in self.unsuppressed:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "unsuppressed": len(self.unsuppressed),
            "suppressed": len(self.suppressed),
            "by_rule": by_rule,
        }


def _select_rules(
    select: Iterable[str] | None,
) -> dict[str, Rule]:
    rules = all_rules()
    if select is not None:
        wanted = set(select)
        unknown = wanted - rules.keys()
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        rules = {k: v for k, v in rules.items() if k in wanted}
    return rules


def _run_rules(
    contexts: list[ModuleContext],
    rules: dict[str, Rule],
) -> list[Finding]:
    """Module rules per context, then interprocedural rules over the
    whole set as one project; suppression applied per finding against
    its own module's directives. Findings are deduped on
    (rule, path, line, col) — two hot entry points reaching the same
    hazard site must not double-report it."""
    findings: list[Finding] = []
    module_rules = [
        r for r in rules.values() if not isinstance(r, ProjectRule)
    ]
    project_rules = [
        r for r in rules.values() if isinstance(r, ProjectRule)
    ]
    for ctx in contexts:
        for rule in module_rules:
            findings.extend(rule.check(ctx))
    if project_rules and contexts:
        from production_stack_tpu_torch.analysis.callgraph import (
            ProjectContext,
        )

        project = ProjectContext(contexts)
        for rule in project_rules:
            findings.extend(rule.check_project(project))
    by_path = {ctx.path: ctx for ctx in contexts}
    seen: set[tuple[str, str, int, int]] = set()
    out: list[Finding] = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.col)
        if key in seen:
            continue
        seen.add(key)
        ctx = by_path.get(f.path)
        if ctx is not None:
            sup = ctx.suppression_for(f.line, f.rule)
            if sup is not None:
                f.suppressed = True
                f.justification = sup.justification
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def analyze_source(
    source: str,
    path: str = "<string>",
    select: Iterable[str] | None = None,
) -> list[Finding]:
    """Run rules over one source string; returns all findings with
    suppression already applied (suppressed ones carry suppressed=True).
    Interprocedural rules see the single module as a one-file project,
    so same-module indirection (hot entry -> helper) is still caught."""
    rules = _select_rules(select)
    try:
        ctx = ModuleContext(path, source)
    except SyntaxError as e:
        return [Finding(
            rule="syntax-error", path=path, line=e.lineno or 0,
            col=e.offset or 0, message=f"cannot parse: {e.msg}",
        )]
    return _run_rules([ctx], rules)


def iter_python_files(paths: Iterable[str]) -> Iterator[Path]:
    """Expand paths to .py files; a path that is neither an existing
    directory nor an existing .py file raises instead of silently
    shrinking the scan scope (a typo'd CI argument must not exit 0)."""
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(
                f for f in path.rglob("*.py")
                if "__pycache__" not in f.parts
            )
        elif path.suffix == ".py" and path.is_file():
            yield path
        else:
            raise ValueError(
                f"not a python file or directory: {p!r}"
            )


def analyze_paths(
    paths: Iterable[str],
    select: Iterable[str] | None = None,
    report_only: Iterable[str] | None = None,
) -> Report:
    """Scan every .py under ``paths`` as ONE project: module rules per
    file plus interprocedural rules over the whole call graph.

    ``report_only`` (the --changed-only mode) restricts which files may
    REPORT findings while the call graph is still built over the full
    scan scope — an interprocedural finding in a changed file must not
    disappear just because the helper it calls through didn't change."""
    contexts: list[ModuleContext] = []
    parse_failures: list[Finding] = []
    n = 0
    for f in iter_python_files(paths):
        n += 1
        source = f.read_text(encoding="utf-8")
        try:
            contexts.append(ModuleContext(str(f), source))
        except SyntaxError as e:
            parse_failures.append(Finding(
                rule="syntax-error", path=str(f), line=e.lineno or 0,
                col=e.offset or 0, message=f"cannot parse: {e.msg}",
            ))
    rules = _select_rules(select)
    findings = parse_failures + _run_rules(contexts, rules)
    if report_only is not None:
        wanted = {str(Path(p).resolve()) for p in report_only}
        findings = [
            f for f in findings
            if str(Path(f.path).resolve()) in wanted
        ]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return Report(findings=findings, files_scanned=n)


def render_human(report: Report, show_suppressed: bool = False) -> str:
    out = []
    for f in report.unsuppressed:
        out.append(f.format())
    if show_suppressed:
        for f in report.suppressed:
            line = f.format()
            if f.justification:
                line += f" [why: {f.justification}]"
            out.append(line)
    s = report.summary()
    out.append(
        f"stackcheck: {report.files_scanned} file(s), "
        f"{s['unsuppressed']} finding(s), "
        f"{s['suppressed']} suppressed"
    )
    return "\n".join(out)


def render_json(report: Report) -> str:
    return json.dumps(report.to_dict(), indent=2)


def render_sarif(report: Report) -> str:
    """SARIF 2.1.0 for github/codeql-action/upload-sarif: unsuppressed
    findings annotate PR diffs as errors; suppressed ones ride along as
    notes with their in-source justification, so the suppression
    inventory is visible in the code-scanning UI too. ``--json`` stays
    byte-compatible — this is a separate renderer, not a reshape."""
    rule_meta = all_rules()
    driver_rules = [
        {
            "id": name,
            "shortDescription": {"text": rule.summary or name},
        }
        for name, rule in sorted(rule_meta.items())
    ]
    driver_rules.append({
        "id": "syntax-error",
        "shortDescription": {"text": "file could not be parsed"},
    })
    results = []
    for f in report.findings:
        result = {
            "ruleId": f.rule,
            "level": "note" if f.suppressed else "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace("\\", "/"),
                    },
                    "region": {
                        "startLine": max(1, f.line),
                        "startColumn": f.col + 1,
                    },
                },
            }],
        }
        if f.suppressed:
            sup: dict = {"kind": "inSource"}
            if f.justification:
                sup["justification"] = f.justification
            result["suppressions"] = [sup]
        results.append(result)
    doc = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "stackcheck",
                    "informationUri": (
                        "production_stack_tpu_torch/analysis/README.md"
                    ),
                    "rules": driver_rules,
                },
            },
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2)
