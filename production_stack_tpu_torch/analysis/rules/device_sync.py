"""device-sync-hot: host<->device sync forcers inside marked hot paths.

The engine's perf model (PERF.md) is that dispatch-side code does not
wait on the card: a CUDA launch returns before the kernel finishes, and
the intended fetches of a round are explicit. A stray ``.item()`` /
``.tolist()`` / ``.cpu()`` / ``int(t)`` / ``torch.cuda.synchronize()``
inside a dispatch or staging function silently serializes host and
device and shows up only as tail latency and device idle time.

The sync set, in PyTorch terms:

- attribute calls ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.nonzero()`` (its output size is data-dependent), ``.synchronize()``
  (an event, a stream, or ``torch.cuda``), and ``.to("cpu")`` /
  ``.to(device="cpu")`` / ``.to(torch.device("cpu"))``;
- dotted calls ``torch.cuda.synchronize``, ``torch.nonzero``,
  ``torch.unique``, ``torch.masked_select`` and ``numpy.asarray`` /
  ``asanyarray`` / ``array``;
- the builtins ``float()``, ``bool()`` and ``int()`` of one argument;
- ``.any()`` / ``.all()`` as the test of an ``if`` or ``while`` (the
  implicit ``bool`` of a tensor).

A function is "hot" when marked ``# stackcheck: hot-path`` on (or
directly above) its ``def`` line or its first decorator, or decorated
``@hot_path``. Mark the engine step/decode/prefill dispatch+staging
loops; the intended fetch points get a per-line suppression with a
justification.

Heuristics keep noise down, each with a negative fixture: a builtin of
a literal constant is host-only; ``int()`` / ``float()`` / ``bool()`` of
a shape int (``len(x)``, ``t.shape[i]``, ``t.ndim``, ``t.nbytes``,
``t.itemsize``, ``t.size(i)``, ``t.numel()``, ``t.dim()``,
``t.element_size()``, or arithmetic over those and constants) never
touch the card; ``numpy.asarray`` / ``array`` over a host list (a
literal, a comprehension, ``list()`` / ``tuple()`` / ``sorted()`` /
``range()``) is host prep, not a device fetch.

A nested def is NOT traced here as it is under ``jax.jit``: it runs
eagerly on the host every time it is called. It is judged on its own
(its body is never part of the enclosing function's), and a closure
that runs every round carries its own hot-path mark.
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    Rule,
    attr_tail,
    iter_functions,
    register,
    resolve_dotted,
    walk_function_body,
)

#: attribute calls that force the host to wait on device values
SYNC_ATTR_CALLS = {
    "item", "tolist", "cpu", "numpy", "nonzero", "synchronize",
}

#: dotted calls that force a device fetch / barrier
SYNC_DOTTED_CALLS = {
    "torch.cuda.synchronize",
    "torch.nonzero",
    "torch.unique",
    "torch.masked_select",
    "numpy.asarray",
    "numpy.asanyarray",
    "numpy.array",
}

#: builtins that synchronize when handed a device tensor
SYNC_BUILTINS = {"float", "bool", "int"}

#: reductions whose implicit bool() syncs when they are an if/while test
SYNC_TEST_ATTRS = {"any", "all"}

_LITERALS = (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set)
_HOST_LIST_NODES = _LITERALS + (
    ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
)
_HOST_LIST_BUILTINS = {"list", "tuple", "sorted", "range"}
_SHAPE_ATTRS = {"ndim", "nbytes", "itemsize"}
_SHAPE_CALLS = {"size", "numel", "dim", "element_size"}


def _is_host_list(node: ast.expr, ctx: ModuleContext) -> bool:
    if isinstance(node, _HOST_LIST_NODES):
        return True
    return (
        isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id in _HOST_LIST_BUILTINS
        and node.func.id not in ctx.import_aliases
    )


def _is_shape_int(node: ast.expr, ctx: ModuleContext) -> bool:
    """True for an expression built only from constants and shape reads
    (``len(x)``, ``t.shape[i]``, ``t.ndim``, ``t.nbytes``, ``t.size(i)``,
    ``t.numel()``, ``t.dim()``, ...): host ints, whatever device ``t``
    lives on."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.BinOp):
        return _is_shape_int(node.left, ctx) and \
            _is_shape_int(node.right, ctx)
    if isinstance(node, ast.UnaryOp):
        return _is_shape_int(node.operand, ctx)
    if isinstance(node, ast.Subscript):
        return isinstance(node.value, ast.Attribute) and \
            node.value.attr == "shape"
    if isinstance(node, ast.Attribute):
        return node.attr in _SHAPE_ATTRS
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name):
            return node.func.id == "len" and \
                "len" not in ctx.import_aliases
        return isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SHAPE_CALLS
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``t.to("cpu")``, ``t.to(device="cpu")``,
    ``t.to(torch.device("cpu"))``."""
    targets = list(call.args[:1]) + [
        k.value for k in call.keywords if k.arg == "device"
    ]
    for t in targets:
        if isinstance(t, ast.Call) and attr_tail(t.func) == "device" \
                and t.args:
            t = t.args[0]
        if isinstance(t, ast.Constant) and isinstance(t.value, str) \
                and t.value.split(":")[0] == "cpu":
            return True
    return False


def classify_call(call: ast.Call, ctx: ModuleContext) -> str | None:
    """Label of the sync ``call`` forces, or None."""
    func = call.func
    tail = attr_tail(func)
    if isinstance(func, ast.Attribute):
        if tail in SYNC_ATTR_CALLS:
            dotted = resolve_dotted(func, ctx.import_aliases)
            return dotted if dotted in SYNC_DOTTED_CALLS else f".{tail}()"
        if tail == "to" and _to_cpu(call):
            return '.to("cpu")'
    dotted = resolve_dotted(func, ctx.import_aliases)
    if dotted in SYNC_DOTTED_CALLS:
        # asarray over a host list is host prep, not a device fetch
        if dotted.startswith("numpy.") and call.args and \
                _is_host_list(call.args[0], ctx):
            return None
        return dotted
    if isinstance(func, ast.Name) and func.id in SYNC_BUILTINS and \
            func.id not in ctx.import_aliases:
        if len(call.args) == 1 and not _is_shape_int(call.args[0], ctx):
            return f"{func.id}()"
    return None


def _test_calls(test: ast.expr) -> list[ast.Call]:
    """``x.any()`` / ``x.all()`` calls an if/while test converts to
    bool: the test itself, or an operand of ``not`` / ``and`` / ``or``."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _test_calls(test.operand)
    if isinstance(test, ast.BoolOp):
        return [c for v in test.values for c in _test_calls(v)]
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute) \
            and test.func.attr in SYNC_TEST_ATTRS and not test.args:
        return [test]
    return []


def sync_forcers(
    func: ast.FunctionDef | ast.AsyncFunctionDef, ctx: ModuleContext,
) -> list[tuple[ast.Call, str]]:
    """Every sync forcer lexically in ``func``'s own body (nested defs
    excluded: they are judged on their own)."""
    hits: list[tuple[ast.Call, str]] = []
    for node in walk_function_body(func):
        if isinstance(node, ast.Call):
            hit = classify_call(node, ctx)
            if hit is not None:
                hits.append((node, hit))
        elif isinstance(node, (ast.If, ast.While)):
            for call in _test_calls(node.test):
                hits.append((call, f".{attr_tail(call.func)}() as a test"))
    return hits


@register
class DeviceSyncInHotPath(Rule):
    name = "device-sync-hot"
    summary = (
        "host-device sync forcer (.item()/.tolist()/.cpu()/int()/"
        "torch.cuda.synchronize/...) inside a marked hot path"
    )

    def check(self, ctx: ModuleContext):
        for func in iter_functions(ctx.tree):
            if not ctx.is_hot(func):
                continue
            for node, hit in sync_forcers(func, ctx):
                yield self.finding(
                    ctx, node,
                    f"'{hit}' forces a host-device sync inside hot "
                    f"path '{func.name}'; move it off the dispatch "
                    f"path or suppress with the justification for "
                    f"this being an intended fetch point",
                )
