"""The planner (planner.py), name resolution (resolver.py) and the
physical plan nodes (physical.py)."""

from tidb_tpu_torch.plan.planner import Planner, PlanError
from tidb_tpu_torch.plan import physical

__all__ = ["Planner", "PlanError", "physical"]
