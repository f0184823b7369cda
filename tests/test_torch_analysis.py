"""The port's analyzer, production_stack_tpu_torch/analysis/, against the
JAX package's stackcheck.

Both analyzers are stdlib-only and run here side by side:

- on every fixture of tests/test_stackcheck.py they report the same
  findings (rule, line, column, suppression);
- over both packages' trees they agree finding for finding on every rule
  the port's three differences leave alone (each tree scanned once per
  analyzer, module-scoped);
- the three differences, each pinned by fixtures: the sync set in
  PyTorch terms (and its noise heuristics), closures that run eagerly
  and carry their own hot mark, and a mark above a decorator list;
- the port's self-scan exits 0 through the API and the CLI, its hot
  entries include every JAX hot entry with a same-named counterpart and
  the fused round's per-round closures, and the router's monotonic-only
  contract pins hold over the port's router files.
"""

from __future__ import annotations

import ast
import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import test_stackcheck as jax_cases
from production_stack_tpu.analysis import analyze_paths as jax_paths
from production_stack_tpu.analysis import analyze_source as jax_source
from production_stack_tpu_torch.analysis import (
    all_rules,
    analyze_paths,
    analyze_source,
)
from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    iter_functions,
)

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "production_stack_tpu"
PORT = REPO / "production_stack_tpu_torch"

# the rules whose verdicts the three differences change: the sync set
# (device-sync-*) and the hot entries (closures, marks above decorators)
# that device-sync-transitive and blocking-hot walk from
TOUCHED = {"device-sync-hot", "device-sync-transitive", "blocking-hot"}


def _key(f) -> tuple:
    return (f.rule, f.line, f.col, f.suppressed)


def _tree_key(f, root: Path) -> tuple:
    return (f.rule, str(Path(f.path).resolve().relative_to(root)), f.line,
            f.col, f.suppressed, f.justification)


def port_findings(src: str, rule: str | None = None,
                  live: bool = True) -> list:
    found = analyze_source(textwrap.dedent(src), path="fixture.py")
    if live:
        found = [f for f in found if not f.suppressed]
    return [f for f in found if rule is None or f.rule == rule]


# -- (a) parity on test_stackcheck.py's fixtures ---------------------------
FIXTURE_SOURCES = [
    (f"{rule}-{kind}", src)
    for rule, triple in sorted(jax_cases.FIXTURES.items())
    for kind, src in sorted(triple.items())
] + [("indirection", jax_cases.INDIRECTION_FIXTURE)]


@pytest.mark.parametrize("name,src", FIXTURE_SOURCES,
                         ids=[n for n, _ in FIXTURE_SOURCES])
def test_fixture_parity(name, src):
    src = textwrap.dedent(src)
    want = [_key(f) for f in jax_source(src, path="fixture.py")]
    got = [_key(f) for f in analyze_source(src, path="fixture.py")]
    assert got == want


def test_same_rule_registry():
    from production_stack_tpu.analysis import all_rules as jax_rules

    assert sorted(all_rules()) == sorted(jax_rules())


# -- (b) parity on both packages' trees ------------------------------------
@pytest.fixture(scope="module")
def scans():
    """Each tree scanned once by each analyzer."""
    return {
        (analyzer, tree): scan([str(root)])
        for analyzer, scan in (("jax", jax_paths), ("port", analyze_paths))
        for tree, root in (("jax", JAX_PKG), ("port", PORT))
    }


@pytest.mark.parametrize("tree", ["jax", "port"])
def test_tree_parity_on_untouched_rules(scans, tree):
    root = REPO
    want = sorted(_tree_key(f, root) for f in scans["jax", tree].findings
                  if f.rule not in TOUCHED)
    got = sorted(_tree_key(f, root) for f in scans["port", tree].findings
                 if f.rule not in TOUCHED)
    assert got == want
    assert scans["jax", tree].files_scanned == \
        scans["port", tree].files_scanned


def test_untouched_rules_listed():
    assert TOUCHED < set(all_rules())


# -- (d) the port's self-scan ----------------------------------------------
def test_port_self_scan_is_clean_api(scans):
    report = scans["port", "port"]
    assert report.files_scanned > 100
    assert report.unsuppressed == [], "\n".join(
        f.format() for f in report.unsuppressed)


def test_port_self_scan_is_clean_cli():
    """`python -m production_stack_tpu_torch.analysis
    production_stack_tpu_torch/` exits 0, and with no path the CLI scans
    the port's package."""
    proc = subprocess.run(
        [sys.executable, "-m", "production_stack_tpu_torch.analysis",
         "production_stack_tpu_torch/"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_defaults_to_the_port(tmp_path):
    from production_stack_tpu_torch.analysis.__main__ import main

    parser_default = None
    src = (PORT / "analysis" / "__main__.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and any(
                k.arg == "default" and isinstance(k.value, ast.List)
                for k in node.keywords):
            parser_default = next(k.value for k in node.keywords
                                  if k.arg == "default")
    assert [c.value for c in parser_default.elts] == [
        "production_stack_tpu_torch"]
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\nasync def f():\n    time.sleep(1)\n")
    assert main([str(bad), "--select", "blocking-async"]) == 1
    assert main([str(bad), "--select", "silent-except"]) == 0


def test_port_analyzer_is_stdlib_only():
    """No torch, jax or production_stack_tpu import anywhere in the
    port's analysis/ package (tests/test_torch_imports.py checks the
    package-wide ban; this one holds the analyzer to the stdlib)."""
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    for path in sorted((PORT / "analysis").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in stdlib or name.startswith(
                    "production_stack_tpu_torch.analysis"), (path, name)


def test_every_jax_analysis_file_has_a_counterpart():
    jax_files = {p.relative_to(JAX_PKG / "analysis")
                 for p in (JAX_PKG / "analysis").rglob("*")
                 if p.is_file() and "__pycache__" not in p.parts}
    port_files = {p.relative_to(PORT / "analysis")
                  for p in (PORT / "analysis").rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts}
    assert jax_files == port_files


def test_chain_labels_name_the_port():
    from production_stack_tpu_torch.analysis.callgraph import (
        ProjectContext,
    )

    path = PORT / "engine" / "scheduler.py"
    project = ProjectContext([ModuleContext(str(path), path.read_text())])
    fn = next(f for f in project.functions if f.name == "pick_decode_k")
    assert fn.qualname.startswith("production_stack_tpu_torch.engine.")
    assert fn.short == "engine.scheduler.Scheduler.pick_decode_k"


# -- (c1) the sync set in PyTorch terms ------------------------------------
SYNC_EXPRS = {
    ".item()": "t.item()",
    ".tolist()": "t.tolist()",
    ".cpu()": "t.cpu()",
    ".numpy()": "t.numpy()",
    ".nonzero()": "t.nonzero()",
    "Event.synchronize": "ev.synchronize()",
    "Stream.synchronize": "torch.cuda.current_stream().synchronize()",
    '.to("cpu")': 't.to("cpu")',
    '.to(device="cpu")': 't.to(device="cpu", non_blocking=True)',
    ".to(torch.device(cpu))": 't.to(torch.device("cpu"))',
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    "torch.nonzero": "torch.nonzero(t)",
    "torch.unique": "torch.unique(t)",
    "torch.masked_select": "torch.masked_select(t, t > 0)",
    "numpy.asarray": "np.asarray(t)",
    "numpy.array": "np.array(t)",
    "numpy.asanyarray": "np.asanyarray(t)",
    "float()": "float(t[0])",
    "bool()": "bool(t.all())",
    "int()": "int(q_start)",
}


def _hot_src(stmt: str) -> str:
    return f"""
        import numpy as np
        import torch

        # stackcheck: hot-path
        def dispatch(t, ev, q_start):
            x = {stmt}
            return x
    """


def _transitive_src(stmt: str) -> str:
    return f"""
        import numpy as np
        import torch

        def helper(t, ev, q_start):
            return {stmt}

        # stackcheck: hot-path
        def dispatch(t, ev, q_start):
            return helper(t, ev, q_start)
    """


@pytest.mark.parametrize("name", sorted(SYNC_EXPRS))
def test_sync_name_flagged_in_a_hot_path(name):
    found = port_findings(_hot_src(SYNC_EXPRS[name]), "device-sync-hot")
    assert len(found) == 1, found
    assert found[0].line == 7


@pytest.mark.parametrize("name", sorted(SYNC_EXPRS))
def test_sync_name_flagged_through_a_helper(name):
    found = port_findings(_transitive_src(SYNC_EXPRS[name]),
                          "device-sync-transitive")
    assert len(found) == 1, found
    assert found[0].line == 6
    assert "fixture.dispatch -> fixture.helper" in found[0].message


@pytest.mark.parametrize("test", ["if t.any():", "while not t.all():",
                                  "if ok and t.any():"])
def test_any_all_as_a_test_is_a_sync(test):
    src = f"""
        # stackcheck: hot-path
        def dispatch(t, ok):
            {test}
                return 1
            return 0
    """
    found = port_findings(src, "device-sync-hot")
    assert [f.line for f in found] == [4]
    assert "as a test" in found[0].message


# each heuristic's negative: host values the sync set must not flag
HOST_EXPRS = {
    "constant": 'float("inf")',
    "int constant": "int(3)",
    "len": "int(len(xs))",
    "shape": "int(t.shape[0])",
    "shape arithmetic": "int(t.size(0) * 2 + t.dim())",
    "numel": "float(t.numel())",
    "nbytes": "int(t.nbytes)",
    "element_size": "int(t.element_size())",
    "ndim": "bool(t.ndim)",
    "host list literal": "np.asarray([1, 2, 3])",
    "host comprehension": "np.asarray([x for x in xs], np.int32)",
    "host list()": "np.array(list(xs))",
    "host range()": "np.asarray(range(4))",
    "to the card": 't.to("cuda", non_blocking=True)',
    "to a device variable": "t.to(dev)",
    "builtin any in a test": "1 if any(xs) else 0",
    "reduction with an argument": "t.any(1)",
    "jax.device_get": "jax.device_get(t)",
    "block_until_ready": "t.block_until_ready()",
}


@pytest.mark.parametrize("name", sorted(HOST_EXPRS))
def test_host_expression_not_flagged(name):
    src = f"""
        import jax
        import numpy as np

        # stackcheck: hot-path
        def dispatch(t, xs, dev):
            x = {HOST_EXPRS[name]}
            if all(xs):
                return x
            return None
    """
    assert port_findings(src, "device-sync-hot") == []


def test_jax_analyzer_does_not_know_the_torch_names():
    """The JAX analyzer's set misses these torch syncs (why the port has
    its own): each is flagged by the port and by neither JAX rule."""
    for stmt in (".tolist()", ".cpu()", "torch.cuda.synchronize",
                 "int()", "Event.synchronize"):
        src = textwrap.dedent(_hot_src(SYNC_EXPRS[stmt]))
        assert not [f for f in jax_source(src, path="f.py")
                    if f.rule.startswith("device-sync")], stmt
        assert port_findings(src, "device-sync-hot"), stmt


def test_sync_suppression_and_not_hot_boundary():
    src = """
        # stackcheck: hot-path
        def dispatch(t):
            # stackcheck: disable=device-sync-hot — the round's one fetch
            toks = t.cpu()
            return fetch(toks)

        # stackcheck: not-hot — host-side bookkeeping
        def fetch(toks):
            return toks.tolist()
    """
    assert port_findings(src) == []
    sup = [f for f in port_findings(src, live=False) if f.suppressed]
    assert [(f.rule, f.line, f.justification) for f in sup] == [
        ("device-sync-hot", 5, "the round's one fetch")]


# -- (c2) closures run eagerly: a hot closure is an entry point -------------
CLOSURE_SRC = """
    class Runner:
        def build(self):
            # stackcheck: hot-path — runs every round
            def run(carry):
                while True:
                    if bool(carry.done.all()):
                        break
                    carry = step(carry)
                return carry

            def step(carry):
                return post(carry)

            def post(carry):
                n = int(carry.valid.sum())
                return self._note(carry, n)

            def cold(x):
                return x.item()

            return run

        def _note(self, carry, n):
            return carry.tokens.tolist()
"""


def test_hot_closure_is_checked_and_walked():
    found = port_findings(CLOSURE_SRC)
    got = sorted((f.rule, f.line) for f in found)
    assert got == [("device-sync-hot", 7),
                   ("device-sync-transitive", 16),
                   ("device-sync-transitive", 25)], found
    chain = next(f for f in found if f.line == 25).message
    assert "Runner.build.<locals>.run -> " in chain
    assert "<locals>.post -> " in chain and "Runner._note" in chain


def test_unmarked_closure_is_not_an_entry():
    assert all(f.line != 20 for f in port_findings(CLOSURE_SRC))


def test_jax_analyzer_skips_the_closure_tree():
    """JAX's jitted closures are traced, so its analyzer stops at the
    closure's own body: the calls it makes are not followed."""
    src = textwrap.dedent(CLOSURE_SRC)
    found = [f for f in jax_source(src, path="f.py") if not f.suppressed]
    assert [(f.rule, f.line) for f in found] == [("device-sync-hot", 7)]


def test_closures_stay_out_of_the_async_and_clock_rules():
    """Closure nodes are kept apart from project.functions: a closure
    calling a blocking helper does not take it out of async-only
    context (blocking-async-transitive), as in the JAX analyzer."""
    src = """
        import time

        def helper():
            time.sleep(1)

        async def handler():
            helper()

        def outer():
            def inner():
                helper()
            return inner
    """
    port = [_key(f) for f in port_findings(src)]
    jax = [_key(f) for f in jax_source(textwrap.dedent(src), path="f.py")]
    assert port == jax
    assert [k[0] for k in port] == ["blocking-async-transitive"]


# -- (c3) a mark above a decorator list binds ------------------------------
DECORATED_SRC = """
    import torch

    class Runner:
        # stackcheck: hot-path — one dispatch a round
        @torch.inference_mode()
        def decode(self, t):
            return t.item()

        # stackcheck: not-hot — host-side, behind a decorator
        @staticmethod
        @functools.cache
        def host(t):
            return float(t.sum())

        # stackcheck: hot-path
        def round(self, t):
            return self.host(t)
"""


def test_mark_above_decorators_binds():
    found = port_findings(DECORATED_SRC)
    assert [(f.rule, f.line) for f in found] == [("device-sync-hot", 8)]
    ctx = ModuleContext("f.py", textwrap.dedent(DECORATED_SRC))
    marks = {f.name: (ctx.is_hot(f), ctx.is_not_hot(f))
             for f in iter_functions(ctx.tree)}
    assert marks == {"decode": (True, False), "host": (False, True),
                     "round": (True, False)}


def test_jax_analyzer_misses_the_decorated_mark():
    src = textwrap.dedent(DECORATED_SRC)
    found = [f for f in jax_source(src, path="f.py") if not f.suppressed]
    assert [(f.rule, f.line) for f in found] == [
        ("device-sync-transitive", 14)]


def test_mark_far_above_a_decorator_does_not_bind():
    src = """
        import torch

        # stackcheck: hot-path

        @torch.inference_mode()
        def decode(t):
            return t.item()
    """
    assert port_findings(src) == []


# -- (e) the hot marks are present -----------------------------------------
@functools.cache
def _names(path: Path) -> tuple[set[str], set[str]]:
    """(every function name, the hot ones) of a source file."""
    ctx = ModuleContext(str(path), path.read_text())
    fns = list(iter_functions(ctx.tree))
    return {f.name for f in fns}, {f.name for f in fns if ctx.is_hot(f)}


def _hot_names(path: Path) -> set[str]:
    return _names(path)[1]


def _defined(path: Path) -> set[str]:
    return _names(path)[0]


def test_every_jax_hot_entry_with_a_counterpart_is_hot():
    """Each (file, function) the JAX package marks hot is hot in the
    port where the port's file defines a function of that name: 46 of
    the 47, the runner's _ragged_rows_dispatch having none (its work is
    inside ragged_dispatch)."""
    pairs, missing, absent = set(), [], []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG)
        for name in _hot_names(path):
            pairs.add((rel, name))
    for rel, name in sorted(pairs):
        port = PORT / rel
        if not port.is_file() or name not in _defined(port):
            absent.append((str(rel), name))
        elif name not in _hot_names(port):
            missing.append((str(rel), name))
    assert len(pairs) == 47
    assert missing == []
    assert absent == [("engine/model_runner.py", "_ragged_rows_dispatch")]


# the marks the JAX package's own pins hold, with the six entries its
# marks did not bind in the port
HOT_MARKS = {
    "engine/llm_engine.py": {"_flush_kv_exports", "_advance_kv_restore",
                             "step", "_step_impl", "_stop_arrays"},
    "engine/model_runner.py": {
        "stage_export_blocks", "stage_import_blocks",
        "import_staged_blocks", "decode_multi", "stage_decode_multi",
        "ragged_dispatch", "stage_ragged", "_fill_ragged_pack",
        "_fill_ragged_rows_pack", "_fill_rows_prefill_pack", "_attn",
        "decode", "stage_prefill", "stage_prefill_batch"},
    "engine/scheduler.py": {"plan_ragged_round", "pick_decode_k"},
    "engine/long_prefill.py": {"advance", "_dispatch_next_chunk",
                               "_land_one_batch"},
    "kv/transfer.py": {"_snapshot_chain"},
    "kv/offload.py": {"request_chain_reads", "contains_local"},
    "kv/remote.py": {"contains"},
    "parallel/long_context.py": {"stage_tokens", "prefill_chunk"},
    "router/admission/controller.py": {"admit", "release",
                                       "resolve_tenant", "load_score"},
    "router/admission/tenants.py": {"try_acquire", "_refill"},
    "router/admission/load.py": {"compute_load"},
    "router/services/request_service.py": {
        "route_general_request", "process_request", "_note_slo",
        "_ttft_from_clock"},
    "router/stats/slo.py": {"observe_request", "observe_shed",
                            "shed_burn", "_match", "bucket"},
}


@pytest.mark.parametrize("rel", sorted(HOT_MARKS))
def test_hot_marks_present(rel):
    missing = HOT_MARKS[rel] - _hot_names(PORT / rel)
    assert not missing, f"{rel}: unmarked hot paths {missing}"


def test_long_prefill_worker_stays_unmarked():
    assert "_materialize" not in _hot_names(PORT / "engine/long_prefill.py")


# the closures the fused decode round, the ragged rounds, the prefill
# dispatches and the iteration programs run every round, by enclosing def
HOT_CLOSURES = {
    ("_decode_round_core", "run"), ("_decode_round_core", "step"),
    ("_decode_round_core", "post"), ("_decode_round_core", "unpack"),
    ("_build_ragged", "step"), ("_build_ragged_rows", "step"),
    ("_make_prefill_rows_step", "step"),
    ("_make_prefill_rows_step", "sample"),
    ("_single_prefill_step", "step"), ("_packed_prefill_step", "step"),
    ("_decode_step", "step"), ("make", "fn"),
    ("_build_ragged_rows", "step0"), ("_build_ragged", "pf_fn"),
    ("_verify_step", "fn"), ("_embed_step", "fn"), ("_import_step", "fn"),
}


def test_per_round_closures_are_hot():
    path = PORT / "engine" / "model_runner.py"
    ctx = ModuleContext(str(path), path.read_text())
    hot = set()

    def visit(node, outer):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if outer is not None and ctx.is_hot(child):
                    hot.add((outer, child.name))
                visit(child, child.name)
            else:
                visit(child, outer)

    visit(ctx.tree, None)
    assert HOT_CLOSURES <= hot, HOT_CLOSURES - hot
    # the iteration program's body is the closure inside
    # _iteration_program's make()
    src = ast.get_source_segment(path.read_text(), next(
        f for f in iter_functions(ctx.tree)
        if f.name == "_iteration_program"))
    assert "def make():" in src and "def fn(inp):" in src


CLOSURE_FIXTURE = """
import torch


class Runner:
    def _round(self, k_steps):
        # stackcheck: hot-path — the loop of every round
        def run(carry):
            i = 0
            while i < k_steps:
                # stackcheck: disable=device-sync-hot — a blocking read
                # — queued: the early exit on the device
                if i > 0 and bool(carry.done.all()):
                    break
                i += 1
            return i

        return run
"""


def test_closure_entries_reach_the_call_graph(scans):
    """The hot closures are entry points of the transitive rules: a
    blocking read in a hot closure (the fused loop's old `done` read, in
    a fixture) is a finding, suppressed here as a queued hazard, inside
    the closure `run`. The port's own loop reads no flag back: its
    _decode_round_core run has no sync finding, suppressed or not."""
    found = [f for f in analyze_source(CLOSURE_FIXTURE, path="fixture.py")
             if f.rule == "device-sync-hot"]
    assert len(found) == 1 and found[0].suppressed
    assert "'run'" in found[0].message
    assert "queued: the early exit on the device" in found[0].justification
    report = scans["port", "port"]
    assert not [f for f in report.findings + report.suppressed
                if f.path.endswith("engine/model_runner.py")
                and "'run'" in f.message
                and f.rule == "device-sync-hot"]


# -- (f) the router's contract pins over the port's files ------------------
def test_no_wall_clock_in_port_slo_source():
    """test_slo.py's pin over the port's router/stats/slo.py."""
    path = PORT / "router" / "stats" / "slo.py"
    assert "stackcheck: monotonic-only" in path.read_text()
    report = analyze_paths([str(path)], select=["wall-clock-banned"])
    assert report.findings == [], "\n".join(
        f.format() for f in report.findings)


def test_no_wall_clock_in_port_admission_sources():
    """test_admission.py's pin over the port's router/admission/."""
    pkg = PORT / "router" / "admission"
    for src in sorted(pkg.glob("*.py")):
        if src.name == "__init__.py":
            continue
        assert "stackcheck: monotonic-only" in src.read_text(), (
            f"{src.name} dropped its monotonic-only marker")
    report = analyze_paths([str(pkg)], select=["wall-clock-banned"])
    assert report.findings == [], "\n".join(
        f.format() for f in report.findings)


def test_port_request_stats_monotonic_only():
    """test_request_stats.py's pin over the port's
    router/stats/request_stats.py."""
    path = PORT / "router" / "stats" / "request_stats.py"
    src = path.read_text()
    assert "prefises" not in src
    assert "stackcheck: monotonic-only" in src
    report = analyze_paths([str(path)], select=["wall-clock-banned"])
    assert report.findings == [], "\n".join(
        f.format() for f in report.findings)
