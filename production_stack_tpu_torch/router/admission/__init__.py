"""SLO-aware admission control & overload protection for the router.

Every proxied request passes through :class:`AdmissionController`
before routing: per-tenant token-bucket rate limiting + concurrency
caps with a priority shed ladder (interactive sheds last), and load
shedding driven by REAL backend signals (health-board in-flight depth,
scraped queue depth, recent scheduling delay) aggregated into a
cluster load score that tightens admission before upstreams fall over.
Sheds return 429 with a computed, finite Retry-After and are recorded
as a tiled ``shed`` phase on the PhaseClock so phase closure holds for
shed requests too.

Limits are live-reloadable via the ``admission:`` section of the
dynamic config file (``router/dynamic_config.py``); the
``AdmissionControl`` feature gate is the boot-time kill switch, the
``enabled`` config key the live one. ``GET /debug/admission`` exposes
the load signals + per-tenant budgets.
"""

from production_stack_tpu_torch.router.admission.controller import (
    OTHER_TENANT_LABEL,
    PRIORITY_SHED_FRACTION,
    RETRY_AFTER_MAX_S,
    AdmissionController,
    ShedDecision,
    _reset_admission_controller,
    get_admission_controller,
    initialize_admission_controller,
)
from production_stack_tpu_torch.router.admission.load import (
    LoadSignals,
    compute_load,
)
from production_stack_tpu_torch.router.admission.tenants import (
    PRIORITIES,
    TenantLimits,
    TenantState,
    TokenBucket,
    priority_rank,
)

__all__ = [
    "AdmissionController",
    "ShedDecision",
    "LoadSignals",
    "TenantLimits",
    "TenantState",
    "TokenBucket",
    "PRIORITIES",
    "PRIORITY_SHED_FRACTION",
    "RETRY_AFTER_MAX_S",
    "OTHER_TENANT_LABEL",
    "compute_load",
    "priority_rank",
    "get_admission_controller",
    "initialize_admission_controller",
    "_reset_admission_controller",
]
