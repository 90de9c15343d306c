"""Epoch-plan subsystem: the declarative IR (``plan/ir.py``, stdlib only)
and its execution engine (``plan/scheduler.py``)."""

from ray_shuffling_data_loader_tpu_torch.plan.ir import (EpochPlan,
                                                         EpochSpec,
                                                         LineageKey,
                                                         PlanError,
                                                         PlanNode,
                                                         build_epoch_plan,
                                                         epoch_range,
                                                         from_json, node_id,
                                                         queue_epoch,
                                                         queue_index,
                                                         queue_rank,
                                                         route_slices,
                                                         static_epoch_specs)
from ray_shuffling_data_loader_tpu_torch.plan.scheduler import (
    PlanScheduler, SchedulerPolicy, speculation_totals)

__all__ = [
    "EpochPlan", "EpochSpec", "LineageKey", "PlanError", "PlanNode",
    "PlanScheduler", "SchedulerPolicy", "build_epoch_plan", "epoch_range",
    "from_json", "node_id", "queue_epoch", "queue_index", "queue_rank",
    "route_slices", "speculation_totals", "static_epoch_specs",
]
