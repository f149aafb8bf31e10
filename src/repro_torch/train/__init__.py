"""Control-plane plans for a fleet of ranks: shard placement on failure,
mesh fallback and straggler duplication (``elastic``)."""

from repro_torch.train.elastic import (
    MeshFallback,
    ShardPlacement,
    StragglerMonitor,
    escalation_plan,
    replan_on_failure,
)

__all__ = [
    "MeshFallback",
    "ShardPlacement",
    "StragglerMonitor",
    "escalation_plan",
    "replan_on_failure",
]
