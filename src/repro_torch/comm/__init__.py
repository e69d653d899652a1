"""All-to-All schedules on the local mesh (``all_to_all``) and the
plan-driven exchange (``plan_exec``)."""

from .all_to_all import (
    ALL_TO_ALL_IMPLS,
    all_to_all_by_name,
    available_all_to_all_impls,
    direct_all_to_all,
    fast_only_all_to_all,
    flash_all_to_all,
    hierarchical_all_to_all,
    intra_all_to_all,
    register_all_to_all_impl,
    resolve_all_to_all,
    rotation_all_to_all,
)
from .plan_exec import DeviceSchedule, is_lowered, lower_plan, plan_all_to_all

__all__ = [
    "ALL_TO_ALL_IMPLS", "all_to_all_by_name", "available_all_to_all_impls",
    "direct_all_to_all", "fast_only_all_to_all", "flash_all_to_all",
    "hierarchical_all_to_all", "intra_all_to_all", "register_all_to_all_impl",
    "resolve_all_to_all", "rotation_all_to_all", "DeviceSchedule",
    "is_lowered", "lower_plan", "plan_all_to_all",
]
