"""stackcheck rules: importing this package registers every rule.

One module per hazard class; each module's rule class self-registers with
``@register`` so ``core.all_rules()`` sees it. Adding a rule = adding a
module here that defines a ``Rule`` (per-module) or ``ProjectRule``
(interprocedural, sees the whole call graph) subclass and importing it
below (see analysis/README.md for the recipe and a worked example).
"""

from production_stack_tpu_torch.analysis.rules import (  # noqa: F401
    async_transitive,
    blocking_async,
    device_sync,
    falsy_gate,
    fire_forget,
    hot_transitive,
    lock_guard,
    mutable_state,
    note_once,
    paired_release,
    silent_except,
    wall_clock,
)
