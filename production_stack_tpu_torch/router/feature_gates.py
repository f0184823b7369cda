"""K8s-style feature gates.

Parity: reference src/vllm_router/experimental/feature_gates.py —
`--feature-gates=SemanticCache=true,PIIDetection=true` parsing with
Alpha/Beta/GA stages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class Stage(str, enum.Enum):
    ALPHA = "Alpha"
    BETA = "Beta"
    GA = "GA"


@dataclass(frozen=True)
class Feature:
    name: str
    stage: Stage
    default: bool


KNOWN_FEATURES: dict[str, Feature] = {
    f.name: f
    for f in [
        Feature("SemanticCache", Stage.ALPHA, False),
        Feature("PIIDetection", Stage.ALPHA, False),
        Feature("KVOffload", Stage.BETA, False),
        # boot-time kill switch for router/admission/ (the dynamic
        # config's `admission.enabled` key is the LIVE one): default on
        # because an unconfigured controller admits everything
        Feature("AdmissionControl", Stage.BETA, True),
    ]
}


class FeatureGates:
    def __init__(self, spec: str | None = None):
        self._enabled: dict[str, bool] = {
            name: f.default for name, f in KNOWN_FEATURES.items()
        }
        for pair in (spec or "").split(","):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                raise ValueError(
                    f"invalid feature gate {pair!r}; want Name=true|false"
                )
            name, value = pair.split("=", 1)
            name = name.strip()
            if name not in KNOWN_FEATURES:
                raise ValueError(
                    f"unknown feature {name!r}; known: "
                    f"{sorted(KNOWN_FEATURES)}"
                )
            self._enabled[name] = value.strip().lower() == "true"
            logger.info(
                "feature gate %s (%s) = %s",
                name, KNOWN_FEATURES[name].stage.value, self._enabled[name],
            )

    def enabled(self, name: str) -> bool:
        return self._enabled.get(name, False)


_gates: FeatureGates | None = None


def initialize_feature_gates(spec: str | None = None) -> FeatureGates:
    global _gates
    _gates = FeatureGates(spec)
    return _gates


def get_feature_gates() -> FeatureGates:
    global _gates
    if _gates is None:
        _gates = FeatureGates()
    return _gates


def _reset_feature_gates() -> None:
    global _gates
    _gates = None
