"""FLASH: two-tier All-to-All scheduling (the paper's core contribution).

One Scheduler -> Plan -> Executor pipeline: every algorithm (FLASH and the
paper's baselines) is a registered ``Scheduler`` synthesizing a typed,
scheduler-agnostic ``Plan`` (plan.py); a single generic alpha-beta executor
(simulator.py) times any Plan.  ``PlanCache`` skips re-synthesis when a
dynamic-MoE traffic fingerprint repeats across iterations.  The Theorem 1-3
analytic bounds live in bounds.py.
"""

from .birkhoff import (
    DecompositionState,
    Stage,
    StageBlock,
    birkhoff_decompose,
    effective_pair_caps,
    max_line_sum,
    stage_duration,
)
from .bounds import gap_bound, t_flash_worst_case, t_optimal
from .plan import (
    BarrierStage,
    BoundStage,
    FanOutBurst,
    IntraOverlapPhase,
    LoadBalancePhase,
    PermutationBlock,
    PermutationStage,
    Plan,
    PlanCache,
    PlanValidationError,
    RailStage,
    RedistributePhase,
    cluster_family_key,
    plan_family_key,
    traffic_fingerprint,
)
from .schedulers import (
    FlashPlan,
    RepairConfig,
    Scheduler,
    available_schedulers,
    flash_schedule,
    get_scheduler,
    optimal_completion_time,
    register_scheduler,
    synthesis_time,
)
from .simulator import (
    ALGORITHMS,
    ExecutableSchedule,
    SimResult,
    compile_plan,
    execute_plan,
    simulate,
    simulate_many,
)
from .topology import ServerFabric, Topology, uniform_nic_shares
from .traffic import (
    ClusterSpec,
    Workload,
    balanced_workload,
    capacity_matched_workload,
    moe_workload,
    random_workload,
    server_reduce,
    skewed_workload,
)

__all__ = [
    "Stage",
    "StageBlock",
    "DecompositionState",
    "birkhoff_decompose",
    "effective_pair_caps",
    "max_line_sum",
    "stage_duration",
    "gap_bound",
    "t_flash_worst_case",
    "t_optimal",
    "Plan",
    "PlanCache",
    "cluster_family_key",
    "plan_family_key",
    "PlanValidationError",
    "traffic_fingerprint",
    "LoadBalancePhase",
    "PermutationStage",
    "PermutationBlock",
    "BarrierStage",
    "FanOutBurst",
    "RailStage",
    "BoundStage",
    "RedistributePhase",
    "IntraOverlapPhase",
    "Scheduler",
    "RepairConfig",
    "register_scheduler",
    "get_scheduler",
    "available_schedulers",
    "optimal_completion_time",
    "FlashPlan",
    "flash_schedule",
    "synthesis_time",
    "ALGORITHMS",
    "SimResult",
    "ExecutableSchedule",
    "compile_plan",
    "simulate",
    "simulate_many",
    "execute_plan",
    "ServerFabric",
    "Topology",
    "uniform_nic_shares",
    "ClusterSpec",
    "Workload",
    "balanced_workload",
    "capacity_matched_workload",
    "moe_workload",
    "random_workload",
    "server_reduce",
    "skewed_workload",
]
