"""stackcheck for the PyTorch port: repo-native AST analysis for
async/dispatch/lock hazards, with PyTorch's host syncs, closures that run
eagerly, and hot marks above decorator lists.

Run ``python -m production_stack_tpu_torch.analysis
production_stack_tpu_torch/``; exits 0 only when the tree has zero
unsuppressed findings (enforced by tier-1 in tests/test_torch_analysis.py,
and on the card by chip_smoke.py's sync phase). See analysis/README.md
for the rules, the suppression syntax, what differs from the JAX
package's analyzer, and how to add a rule. Stdlib-only by design.
"""

from production_stack_tpu_torch.analysis.core import (
    Finding,
    Report,
    all_rules,
    analyze_paths,
    analyze_source,
    render_human,
    render_json,
    render_sarif,
)

__all__ = [
    "Finding",
    "Report",
    "all_rules",
    "analyze_paths",
    "analyze_source",
    "render_human",
    "render_json",
    "render_sarif",
]
