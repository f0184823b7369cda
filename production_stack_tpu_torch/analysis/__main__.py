"""stackcheck CLI.

Usage:
    python -m production_stack_tpu_torch.analysis [paths...] [--json|--sarif]
        [--select rule1,rule2] [--show-suppressed] [--list-rules]
        [--changed-only [REF]]

Exit codes: 0 = clean (no unsuppressed findings), 1 = findings,
2 = usage / unreadable input / git failure. --changed-only keeps the
same contract: the call graph is still built over the FULL paths scope
(so interprocedural findings in changed files keep their chains), only
REPORTING is restricted to files changed since REF (default HEAD); zero
changed python files is a clean run (exit 0).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from production_stack_tpu_torch.analysis.core import (
    all_rules,
    analyze_paths,
    render_human,
    render_json,
    render_sarif,
)


def _changed_files(ref: str) -> list[str]:
    """Python files changed vs ``ref`` per git (working tree included);
    raises RuntimeError when git itself fails (exit 2 territory — a
    broken ref must not silently become a clean scan)."""
    try:
        proc = subprocess.run(
            ["git", "diff", "--name-only", ref],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"git diff failed: {e}")
    if proc.returncode != 0:
        raise RuntimeError(
            f"git diff --name-only {ref!r} failed: "
            f"{proc.stderr.strip() or proc.returncode}"
        )
    return [
        line.strip() for line in proc.stdout.splitlines()
        if line.strip().endswith(".py")
    ]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m production_stack_tpu_torch.analysis",
        description=(
            "stackcheck: repo-native AST analysis for async/dispatch/"
            "lock hazards"
        ),
    )
    parser.add_argument(
        "paths", nargs="*", default=["production_stack_tpu_torch"],
        help=("files or directories to scan (default: "
              "production_stack_tpu_torch)"),
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    parser.add_argument(
        "--sarif", action="store_true",
        help="SARIF 2.1.0 output (for github code-scanning upload)",
    )
    parser.add_argument(
        "--select", metavar="RULES",
        help="comma-separated subset of rules to run",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also print suppressed findings with their justifications",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule registry and exit",
    )
    parser.add_argument(
        "--changed-only", nargs="?", const="HEAD", metavar="REF",
        help=(
            "report findings only in files changed vs REF (default "
            "HEAD); the call graph still covers the full scan scope"
        ),
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name}: {rule.summary}")
        return 0
    if args.json and args.sarif:
        print(
            "stackcheck: error: --json and --sarif are exclusive",
            file=sys.stderr,
        )
        return 2

    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]

    report_only = None
    if args.changed_only is not None:
        try:
            changed = _changed_files(args.changed_only)
        except RuntimeError as e:
            print(f"stackcheck: error: {e}", file=sys.stderr)
            return 2
        # only files that still exist can be scanned (a deleted file
        # shows in the diff but has no findings to report)
        report_only = [c for c in changed if Path(c).is_file()]
        if not report_only:
            print(
                "stackcheck: 0 changed python file(s), 0 finding(s), "
                "0 suppressed"
            )
            return 0

    try:
        report = analyze_paths(
            args.paths, select=select, report_only=report_only
        )
    except (OSError, ValueError) as e:
        print(f"stackcheck: error: {e}", file=sys.stderr)
        return 2
    if report.files_scanned == 0:
        print("stackcheck: error: no python files found", file=sys.stderr)
        return 2

    if args.json:
        print(render_json(report))
    elif args.sarif:
        print(render_sarif(report))
    else:
        print(render_human(report, show_suppressed=args.show_suppressed))
    return 1 if report.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
