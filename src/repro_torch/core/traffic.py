"""Traffic-matrix abstractions and workload generators.

A GPU-level All-to-All workload on a cluster of n servers x m GPUs is an
(n*m, n*m) nonnegative matrix ``W`` where ``W[g, h]`` is the number of bytes
GPU g must deliver to GPU h.  FLASH's load-balance step collapses it to a
server-level (n, n) matrix T plus per-server intra traffic S_i (paper
section 4.3): after balancing, every one of the m GPUs of server a carries
exactly T[a, b] / m bytes for server b.

Generators mirror the paper's evaluation workloads (section 6): balanced,
random (uniform), skewed (Zipf), plus an MoE-gating generator reproducing the
Megatron-LM measurement methodology of Fig 4 (top-k routing with a skewed
expert-popularity prior, traffic matrix changing every iteration).

Every generator accepts either a ``ClusterSpec`` (homogeneous two-scalar
model) or a ``Topology`` (first-class heterogeneous fabric, topology.py);
the resulting ``Workload`` carries the topology so schedulers synthesize
against the real fabric and PlanCache keys include it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from .topology import Topology, fabric_a2a_bandwidth, fabric_path_bandwidth

__all__ = [
    "ClusterSpec",
    "Workload",
    "balanced_workload",
    "random_workload",
    "skewed_workload",
    "moe_workload",
    "capacity_matched_workload",
    "server_reduce",
]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Two-tier cluster model (paper Fig 6), homogeneous scalar form.

    Bandwidths are bytes/second *per link*: ``b_intra`` for one intra-server
    link (NVLink / xGMI / ICI) and ``b_inter`` for one GPU's NIC (uplink =
    downlink = b_inter, assumption (1) in section 3).  ``alpha`` is the static
    per-stage wakeup latency of the alpha-beta model (section 6.3).

    For heterogeneous fabrics (mixed NIC speeds, degraded links, per-server
    fabric types) use ``Topology`` (topology.py); ``to_topology()`` is the
    adapter.
    """

    n_servers: int
    m_gpus: int
    b_intra: float = 64e9  # 64 GB/s per Infinity Fabric link (MI300X testbed)
    b_inter: float = 12.5e9  # 100 Gbps NIC
    alpha: float = 10e-6
    intra_topology: str = "full_mesh"  # full_mesh | switch | ring | hybrid_cube

    @property
    def n_gpus(self) -> int:
        return self.n_servers * self.m_gpus

    @property
    def bw_ratio(self) -> float:
        return self.b_intra / self.b_inter

    def intra_path_bandwidth(self) -> float:
        """Effective single-path intra-server bandwidth under the topology."""
        return fabric_path_bandwidth(self.intra_topology, self.b_intra,
                                     self.m_gpus)

    def intra_a2a_bandwidth(self) -> float:
        """Aggregate per-GPU bandwidth during an intra-server All-to-All."""
        return fabric_a2a_bandwidth(self.intra_topology, self.b_intra,
                                    self.m_gpus)

    def to_topology(self) -> Topology:
        """Adapter to the first-class fabric model (homogeneous instance)."""
        return Topology.from_cluster(self)


ClusterLike = Union[ClusterSpec, Topology]


def _resolve_cluster(cluster: ClusterLike):
    """Normalize a ClusterSpec-or-Topology argument to (spec, topology)."""
    if isinstance(cluster, Topology):
        return cluster.cluster_view(), cluster
    return cluster, None


@dataclasses.dataclass(frozen=True)
class Workload:
    """GPU-level traffic matrix plus the fabric it runs on.

    ``topology`` is optional: when None, a homogeneous Topology is derived
    from ``cluster`` on demand (``topo``), so the two-scalar call sites
    keep working unchanged.
    """

    cluster: ClusterSpec
    matrix: np.ndarray  # (n_gpus, n_gpus), zero diagonal
    topology: Optional[Topology] = None

    def __post_init__(self):
        n = self.cluster.n_gpus
        if self.matrix.shape != (n, n):
            raise ValueError(
                f"matrix shape {self.matrix.shape} != ({n}, {n})")
        if np.any(self.matrix < 0):
            bad = np.argwhere(self.matrix < 0)[0]
            raise ValueError(
                f"traffic matrix has negative entries (e.g. "
                f"W[{bad[0]}, {bad[1]}] = {self.matrix[bad[0], bad[1]]}); "
                "byte counts must be >= 0")
        diag = np.diagonal(self.matrix)
        if np.any(diag != 0):
            g = int(np.argmax(diag != 0))
            raise ValueError(
                f"traffic matrix has self-traffic on the diagonal "
                f"(W[{g}, {g}] = {diag[g]}); a GPU does not send to itself "
                "-- zero the diagonal")
        if self.topology is not None and (
                self.topology.n_servers != self.cluster.n_servers
                or self.topology.m_gpus != self.cluster.m_gpus):
            raise ValueError(
                f"topology shape ({self.topology.n_servers}, "
                f"{self.topology.m_gpus}) != cluster shape "
                f"({self.cluster.n_servers}, {self.cluster.m_gpus})")

    @property
    def topo(self) -> Topology:
        """The fabric to schedule against (derived when not explicit).

        The derived homogeneous Topology is memoized so repeated accesses
        (fingerprinting, synthesis, execution) share one instance -- and
        with it, its memoized ``fingerprint()``."""
        if self.topology is not None:
            return self.topology
        derived = self.__dict__.get("_derived_topo")
        if derived is None:
            derived = Topology.from_cluster(self.cluster)
            object.__setattr__(self, "_derived_topo", derived)
        return derived

    @property
    def total_bytes(self) -> float:
        return float(self.matrix.sum())

    def server_matrix(self) -> np.ndarray:
        """(n, n) inter-server byte matrix T with zero diagonal."""
        return self.reductions()[0]

    def intra_bytes(self) -> np.ndarray:
        """S_i: bytes that stay inside each server."""
        return self.reductions()[1]

    def reductions(self):
        """Memoized ``(t_server, s_intra, per_gpu_dest)`` for this matrix.

        ``per_gpu_dest`` is the (n, m, n) per-(server, gpu, dest-server)
        byte sums; the server matrix and intra vector derive from it, so
        the whole family costs one pass over the GPU matrix.  Memoized
        because every consumer of a workload re-reduces the same frozen
        matrix -- fingerprinting, synthesis, warm repair, execution -- and
        the O(n_gpus^2) pass dwarfs incremental repair itself."""
        out = self.__dict__.get("_reductions")
        if out is None:
            n, m = self.cluster.n_servers, self.cluster.m_gpus
            per_gpu_dest = self.matrix.reshape(n, m, n, m).sum(axis=3)
            blocks = per_gpu_dest.sum(axis=1)  # (n, n) incl. diagonal
            s = np.diag(blocks).copy()
            t = blocks.copy()
            np.fill_diagonal(t, 0.0)
            out = (t, s, per_gpu_dest)
            object.__setattr__(self, "_reductions", out)
        return out


def server_reduce(w: np.ndarray, m: int):
    """Collapse a GPU-level matrix to (server-level T, intra byte vector S)."""
    n_gpus = w.shape[0]
    n = n_gpus // m
    blocks = w.reshape(n, m, n, m).sum(axis=(1, 3))  # (n, n) incl. diagonal
    s = np.diag(blocks).copy()
    t = blocks.copy()
    np.fill_diagonal(t, 0.0)
    return t, s


def _zero_diag(w: np.ndarray) -> np.ndarray:
    np.fill_diagonal(w, 0.0)
    return w


def balanced_workload(cluster: ClusterLike, size_per_pair: float) -> Workload:
    """Every GPU sends `size_per_pair` bytes to every other GPU."""
    cluster, topo = _resolve_cluster(cluster)
    n = cluster.n_gpus
    w = np.full((n, n), float(size_per_pair))
    return Workload(cluster, _zero_diag(w), topo)


def random_workload(
    cluster: ClusterLike, mean_size: float, seed: int = 0
) -> Workload:
    """Pairwise sizes ~ Uniform[0, 2 * mean] (paper 'Random')."""
    cluster, topo = _resolve_cluster(cluster)
    rng = np.random.default_rng(seed)
    n = cluster.n_gpus
    w = rng.uniform(0.0, 2.0 * mean_size, size=(n, n))
    return Workload(cluster, _zero_diag(w), topo)


def skewed_workload(
    cluster: ClusterLike,
    mean_size: float,
    zipf_s: float = 1.2,
    seed: int = 0,
) -> Workload:
    """Pairwise sizes follow a Zipf-ranked distribution (paper 'Skewed').

    Ranks are randomly assigned to (src, dst) pairs; sizes are rescaled so the
    total equals the balanced workload's total, making AlgoBW comparable
    across skew factors (as in Fig 13).
    """
    cluster, topo = _resolve_cluster(cluster)
    rng = np.random.default_rng(seed)
    n = cluster.n_gpus
    n_pairs = n * (n - 1)
    ranks = np.arange(1, n_pairs + 1, dtype=np.float64)
    sizes = ranks ** (-zipf_s)
    sizes *= (mean_size * n_pairs) / sizes.sum()
    rng.shuffle(sizes)
    # Scatter the shuffled sizes over the off-diagonal entries in row-major
    # order (boolean assignment fills in C order, matching the (i, j) i != j
    # enumeration).
    w = np.zeros((n, n))
    w[~np.eye(n, dtype=bool)] = sizes
    return Workload(cluster, w, topo)


def capacity_matched_workload(
    topology: Topology, mean_size: float, seed: int = 0
) -> Workload:
    """Random traffic scaled to follow pair capacity: a serving load
    balancer keeps slow servers lightly loaded, so pairwise sizes are
    ``random_workload`` entries scaled by the normalized server-pair
    capacity (``Topology.pair_capacity``).  The regime where
    capacity-aware synthesis pays: capacity-blind equal-byte slots park
    fast pairs behind lightly-loaded slow stragglers (DESIGN.md 1d).
    """
    w = random_workload(topology, mean_size, seed=seed)
    caps = topology.pair_capacity()
    scale = caps / max(float(caps.max()), 1.0)
    np.fill_diagonal(scale, 1.0)
    m = topology.m_gpus
    mat = w.matrix * np.kron(scale, np.ones((m, m)))
    return Workload(w.cluster, mat, w.topology)


def moe_workload(
    cluster: ClusterLike,
    tokens_per_gpu: int,
    bytes_per_token: int,
    top_k: int = 2,
    expert_skew: float = 0.6,
    seed: int = 0,
    n_experts: Optional[int] = None,
) -> Workload:
    """All-to-All dispatch matrix induced by top-k MoE gating.

    Each GPU hosts one expert (DeepSeek-style, paper section 6.2) unless
    ``n_experts`` says otherwise.  Expert popularity follows a Dirichlet prior
    with concentration ``expert_skew`` (smaller = more skew), reproducing the
    measured 12.5x p90/median skew of Fig 4a at the defaults.
    """
    cluster, topo = _resolve_cluster(cluster)
    rng = np.random.default_rng(seed)
    n = cluster.n_gpus
    e = n_experts or n
    popularity = rng.dirichlet(np.full(e, expert_skew))
    # One batched draw: (n, top_k, e) multinomials consume the generator
    # stream in the same src-major, draw-minor order as the per-GPU loop.
    counts = rng.multinomial(
        tokens_per_gpu, popularity, size=(n, top_k)).sum(axis=1)  # (n, e)
    # Fold experts onto their host GPUs (expert % n) and drop self-traffic.
    w = np.zeros((n, n))
    np.add.at(w.T, np.arange(e) % n, counts.astype(np.float64).T)
    return Workload(cluster, _zero_diag(w) * float(bytes_per_token), topo)
