"""Closed-form bounds from the paper's section 4.4 (Theorems 1-3).

These are the analytical oracles the property tests check the simulator and
the Birkhoff scheduler against.
"""

from __future__ import annotations

import numpy as np

from .birkhoff import max_line_sum
from .traffic import ClusterSpec, Workload, server_reduce

__all__ = [
    "t_optimal",
    "t_flash_worst_case",
    "gap_bound",
]


def t_optimal(w: Workload) -> float:
    """Theorem 1: infinite intra-bandwidth lower bound.

    t_opt = max(max_i sum_j T_ij, max_j sum_i T_ij) / (m * B2)
    """
    t, _ = server_reduce(w.matrix, w.cluster.m_gpus)
    return max_line_sum(t) / (w.cluster.m_gpus * w.cluster.b_inter)


def t_flash_worst_case(w: Workload) -> float:
    """Theorem 2: sum of worst-case phase times.

    t_FLASH <= t_opt                                   (inter, Birkhoff)
             + max_i sum_j T_ij / (m * B1)             (load balance head)
             + max_ij T_ij / B1                        (intra traffic S_i)
             + max_ij T_ij / (m * B1)                  (redistribute tail)

    Uses the paper's assumptions: full-mesh intra fabric of per-link
    bandwidth B1, one NIC of bandwidth B2 per GPU, S_i <= max_j T_ij.
    """
    c = w.cluster
    t, _ = server_reduce(w.matrix, c.m_gpus)
    m, b1, b2 = c.m_gpus, c.b_intra, c.b_inter
    t0 = t.sum(axis=1).max(initial=0.0) / (m * b1)
    t1 = t.max(initial=0.0) / b1
    t2 = max_line_sum(t) / (m * b2)
    t3 = t.max(initial=0.0) / (m * b1)
    return t0 + t1 + t2 + t3


def gap_bound(cluster: ClusterSpec) -> float:
    """Theorem 3: t_FLASH / t_opt <= 1 + (m + 2) * B2 / B1."""
    return 1.0 + (cluster.m_gpus + 2) * cluster.b_inter / cluster.b_intra


def check_workload_assumption(w: Workload) -> bool:
    """Paper's S_i <= max_j T_ij assumption (section 4.4)."""
    t, s = server_reduce(w.matrix, w.cluster.m_gpus)
    if t.size == 0:
        return True
    return bool(np.all(s <= t.max(axis=1) + 1e-9 * max(t.max(), 1.0)))
