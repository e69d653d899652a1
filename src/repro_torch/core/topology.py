"""First-class two-tier fabric model: named link-level resources.

The paper's claim is efficient scheduling on *heterogeneous* two-tier
fabrics (H200 NVLink vs MI300X xGMI, mixed NIC generations, degraded
links), but a ``ClusterSpec`` models the cluster as two scalars -- every
server, NIC and link identical.  ``Topology`` replaces those scalars with
explicit resources:

  * one ``ServerFabric`` per server -- intra topology type, per-link
    bandwidth and GPU count (mixed-generation servers);
  * a per-NIC capacity matrix ``nic_bw[server, nic]`` in bytes/s
    (heterogeneous NIC speeds; a degraded link is a scaled entry, a failed
    link is a zero);
  * an optional scale-out ``oversubscription`` factor capping the
    aggregate cross-fabric ("spine") bandwidth at
    ``sum(nic_bw) / oversubscription`` per direction.

``Topology.from_cluster`` is the adapter that keeps every existing
``ClusterSpec`` call site working: a homogeneous Topology derived from a
spec reproduces the scalar cost model exactly (the link-level executor in
simulator.py is golden-tested to <= 1e-9 relative error against the
scalar formulas).  ``fingerprint()`` is the content hash that keys
``PlanCache`` entries and stamps synthesized Plans, so a traffic matrix
replayed on a different fabric can never be served a stale plan.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ServerFabric",
    "Topology",
    "fabric_path_bandwidth",
    "fabric_a2a_bandwidth",
    "bw_div",
    "bw_sdiv",
    "uniform_nic_shares",
]


@functools.lru_cache(maxsize=64)
def uniform_nic_shares(n_servers: int, m_gpus: int) -> np.ndarray:
    """Memoized uniform ``(n, n, m)`` rail-share fallback (``1/m`` per rail).

    The executor, the Plan validator and the homogeneous synthesis path all
    need this array whenever a plan carries no explicit ``nic_shares``;
    memoizing per shape means a serving loop stops paying an O(n^2 m)
    allocation on every executed plan.  The array is frozen read-only
    because every caller shares the same instance.
    """
    shares = np.full((n_servers, n_servers, m_gpus), 1.0 / m_gpus)
    shares.flags.writeable = False
    return shares


def bw_div(x, bw) -> np.ndarray:
    """Elementwise x / bw with failed links handled: 0 bandwidth carries
    nothing in finite time (inf when bytes > 0, 0 when idle)."""
    x, bw = np.broadcast_arrays(np.asarray(x, dtype=np.float64),
                                np.asarray(bw, dtype=np.float64))
    out = np.zeros(x.shape)
    np.divide(x, bw, out=out, where=bw > 0)
    out[(bw <= 0) & (x > 0)] = np.inf
    return out


def bw_sdiv(x: float, bw: float) -> float:
    """Scalar form of bw_div: same zero-bandwidth contract."""
    if x <= 0:
        return 0.0
    return x / bw if bw > 0 else float("inf")


def fabric_path_bandwidth(intra_topology: str, b_intra: float,
                          m_gpus: int) -> float:
    """Effective single-path intra-server bandwidth under the topology.

    full_mesh / switch: a pairwise transfer rides one dedicated link.
    ring: average path crosses m/4 hops sharing the ring -> ~4/m of a link.
    hybrid_cube (DGX-1 style): ~half of full-mesh efficiency.
    These coarse factors reproduce the ordering of paper Fig 16a.
    """
    if intra_topology in ("full_mesh", "switch"):
        return b_intra
    if intra_topology == "ring":
        return b_intra * 4.0 / max(m_gpus, 4)
    if intra_topology == "hybrid_cube":
        return b_intra * 0.5
    raise ValueError(f"unknown intra topology {intra_topology!r}")


def fabric_a2a_bandwidth(intra_topology: str, b_intra: float,
                         m_gpus: int) -> float:
    """Aggregate per-GPU bandwidth during an intra-server All-to-All.

    Coarse per-topology efficiency factors, calibrated to reproduce the
    paper's Fig 16a ordering (switch/full-mesh near-optimal; ring and
    hybrid-cube at 0.86-0.92x due to multi-hop shuffles).
    """
    if intra_topology in ("full_mesh",):
        return b_intra * max(m_gpus - 1, 1)
    if intra_topology == "switch":
        return b_intra  # switch port caps a GPU at one link rate
    if intra_topology == "ring":
        # two directions, average path m/4 hops sharing ring capacity
        return b_intra * 2 * 4.0 / max(m_gpus, 4)
    if intra_topology == "hybrid_cube":
        # 4 links/GPU, ~half usable bisection for an A2A shuffle
        return b_intra * 2
    raise ValueError(f"unknown intra topology {intra_topology!r}")


@dataclasses.dataclass(frozen=True)
class ServerFabric:
    """One server's intra fabric: type, per-link bandwidth, GPU count."""

    intra_topology: str = "full_mesh"
    b_intra: float = 64e9
    m_gpus: int = 8

    def path_bandwidth(self) -> float:
        return fabric_path_bandwidth(self.intra_topology, self.b_intra,
                                     self.m_gpus)

    def a2a_bandwidth(self) -> float:
        return fabric_a2a_bandwidth(self.intra_topology, self.b_intra,
                                    self.m_gpus)

    def to_dict(self) -> Dict[str, Any]:
        return {"intra_topology": self.intra_topology,
                "b_intra": float(self.b_intra),
                "m_gpus": int(self.m_gpus)}


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Two-tier fabric as explicit per-server / per-NIC resources.

    Attributes:
      fabrics: one ``ServerFabric`` per server.
      nic_bw: (n_servers, m_gpus) per-NIC *transmit* bandwidth, bytes/s.
        Zero = failed link.  With ``nic_bw_rx`` unset this is also the
        receive rate (full duplex, paper assumption (1)).
      alpha: per-stage wakeup latency (alpha-beta model, paper 6.3).
      oversubscription: scale-out fabric factor >= 1; the spine carries at
        most ``sum(nic_bw) / oversubscription`` bytes/s per direction.
        1.0 = full bisection (no effect).
      nic_bw_rx: optional (n_servers, m_gpus) per-NIC *receive* bandwidth
        for asymmetric up/down rates (a congested downlink, a degraded
        receive pipeline).  None = symmetric (receive mirrors ``nic_bw``);
        an array equal to ``nic_bw`` is normalized back to None so the
        fingerprint of a symmetric fabric is representation-independent.
      nominal_nic_bw / nominal_nic_rx: pre-degradation rates captured by
        the first degrade/fail constructor so ``recover_nic`` can restore
        them.  Bookkeeping only: excluded from ``fingerprint()``/``__eq__``
        (two fabrics with identical live rates schedule identically) and
        dropped automatically once every link is back at nominal, so
        ``t.fail_nic(s, g).recover_nic(s, g)`` *is* ``t``.
    """

    fabrics: Tuple[ServerFabric, ...]
    nic_bw: np.ndarray
    alpha: float = 10e-6
    oversubscription: float = 1.0
    nic_bw_rx: Optional[np.ndarray] = None
    nominal_nic_bw: Optional[np.ndarray] = None
    nominal_nic_rx: Optional[np.ndarray] = None

    def __post_init__(self):
        # Defensive copy + freeze: fingerprint()/__hash__ key PlanCache
        # entries, so the array must never change under us.
        nic = np.array(self.nic_bw, dtype=np.float64, order="C", copy=True)
        nic.flags.writeable = False
        object.__setattr__(self, "nic_bw", nic)
        object.__setattr__(self, "fabrics", tuple(self.fabrics))
        n = len(self.fabrics)
        if n == 0:
            raise ValueError("topology needs at least one server")
        counts = {f.m_gpus for f in self.fabrics}
        if len(counts) != 1:
            raise ValueError(
                "heterogeneous per-server GPU counts are not supported "
                f"yet (got {sorted(counts)}); see ROADMAP open items")
        m = self.fabrics[0].m_gpus
        if nic.shape != (n, m):
            raise ValueError(
                f"nic_bw shape {nic.shape} != (n_servers, m_gpus) = "
                f"({n}, {m})")
        if np.any(nic < 0):
            raise ValueError("NIC bandwidths must be >= 0")
        if self.oversubscription < 1.0:
            raise ValueError(
                f"oversubscription must be >= 1, got {self.oversubscription}")
        rx = self._freeze_optional("nic_bw_rx", nic.shape)
        if rx is not None and np.array_equal(rx, nic):
            # Symmetric-by-value fabrics normalize to the symmetric
            # representation so fingerprints cannot fork on how the same
            # rates were spelled.
            object.__setattr__(self, "nic_bw_rx", None)
            rx = None
        if rx is not None and np.any(rx < 0):
            raise ValueError("NIC bandwidths must be >= 0")
        nom_tx = self._freeze_optional("nominal_nic_bw", nic.shape)
        nom_rx = self._freeze_optional("nominal_nic_rx", nic.shape)
        if nom_tx is not None:
            eff_rx = rx if rx is not None else nic
            eff_nom_rx = nom_rx if nom_rx is not None else nom_tx
            if np.array_equal(nom_tx, nic) and np.array_equal(
                    eff_nom_rx, eff_rx):
                # Fully recovered: the nominal bookkeeping is spent.
                object.__setattr__(self, "nominal_nic_bw", None)
                object.__setattr__(self, "nominal_nic_rx", None)
        elif nom_rx is not None:
            raise ValueError("nominal_nic_rx requires nominal_nic_bw")
        # Derived per-resource capacities, computed once (the executor reads
        # them several times per plan); frozen like nic_bw.
        recv = self.nic_bw_rx if self.nic_bw_rx is not None else nic
        for attr, arr in (
                ("_send_caps", nic.sum(axis=1)),
                ("_recv_caps", recv.sum(axis=1)),
                ("_intra_path_bw",
                 np.array([f.path_bandwidth() for f in self.fabrics])),
                ("_intra_a2a_bw",
                 np.array([f.a2a_bandwidth() for f in self.fabrics]))):
            arr.flags.writeable = False
            object.__setattr__(self, attr, arr)

    def _freeze_optional(self, attr: str,
                         shape: Tuple[int, int]) -> Optional[np.ndarray]:
        arr = getattr(self, attr)
        if arr is None:
            return None
        arr = np.array(arr, dtype=np.float64, order="C", copy=True)
        if arr.shape != shape:
            raise ValueError(f"{attr} shape {arr.shape} != nic_bw "
                             f"shape {shape}")
        arr.flags.writeable = False
        object.__setattr__(self, attr, arr)
        return arr

    # -- shape ----------------------------------------------------------

    @property
    def n_servers(self) -> int:
        return len(self.fabrics)

    @property
    def m_gpus(self) -> int:
        return self.fabrics[0].m_gpus

    @property
    def n_gpus(self) -> int:
        return self.n_servers * self.m_gpus

    # -- derived link-level capacities ----------------------------------

    @property
    def nic_tx(self) -> np.ndarray:
        """(n, m) per-NIC transmit bandwidth (alias of ``nic_bw``)."""
        return self.nic_bw

    @property
    def nic_rx(self) -> np.ndarray:
        """(n, m) per-NIC receive bandwidth; ``nic_bw`` when symmetric.

        Returns the *same array object* as ``nic_bw`` on symmetric
        fabrics, so executor hot paths that hoist both planes pay nothing
        extra there."""
        return self.nic_bw_rx if self.nic_bw_rx is not None else self.nic_bw

    @property
    def is_symmetric(self) -> bool:
        """True when receive rates mirror transmit rates everywhere."""
        return self.nic_bw_rx is None

    @property
    def send_caps(self) -> np.ndarray:
        """(n_servers,) aggregate NIC transmit capacity per server."""
        return self._send_caps

    @property
    def recv_caps(self) -> np.ndarray:
        """(n_servers,) aggregate NIC receive capacity per server."""
        return self._recv_caps

    @property
    def spine_bandwidth(self) -> float:
        """Aggregate cross-fabric bandwidth per direction (scale-out tier).

        Under asymmetric rates the spine can move no more than the slower
        of what the servers can collectively inject or drain."""
        cap = float(self.nic_bw.sum())
        if self.nic_bw_rx is not None:
            cap = min(cap, float(self.nic_bw_rx.sum()))
        return cap / self.oversubscription

    @property
    def intra_path_bw(self) -> np.ndarray:
        """(n_servers,) single-path intra bandwidth per server fabric."""
        return self._intra_path_bw

    @property
    def intra_a2a_bw(self) -> np.ndarray:
        """(n_servers,) per-GPU intra All-to-All bandwidth per fabric."""
        return self._intra_a2a_bw

    def theorem1_time(self, line_sums, inter_total: float) -> float:
        """Theorem 1 lower bound on this fabric: each server's max(row, col)
        line sum over its aggregate NIC capacity, and the whole exchange
        over the spine.  Single source of truth for the BoundStage executor
        branch and ``optimal_completion_time``.

        Under asymmetric rates the combined line sum is charged against
        ``max(send_caps, recv_caps)`` per server -- still a valid lower
        bound, since ``max(row, col) / max(tx, rx)`` never exceeds
        ``max(row / tx, col / rx)`` -- and degrades to the exact symmetric
        form when the planes coincide."""
        caps = self.send_caps
        if self.nic_bw_rx is not None:
            caps = np.maximum(caps, self.recv_caps)
        per_server = bw_div(np.asarray(line_sums, dtype=np.float64), caps)
        return max(float(per_server.max(initial=0.0)),
                   bw_sdiv(float(inter_total), self.spine_bandwidth))

    @property
    def is_homogeneous(self) -> bool:
        """Identical fabrics, identical NICs, full-bisection spine.

        Memoized: the fabric is frozen, and the serving/repair hot paths
        consult this on every synthesized plan."""
        homog = self.__dict__.get("_is_homogeneous")
        if homog is None:
            homog = bool(len(set(self.fabrics)) == 1
                         and self.nic_bw_rx is None
                         and np.all(self.nic_bw == self.nic_bw.flat[0])
                         and self.oversubscription == 1.0)
            object.__setattr__(self, "_is_homogeneous", homog)
        return homog

    def pair_capacity(self) -> np.ndarray:
        """(n, n) aggregate bandwidth each server pair can sustain.

        Rail-aligned fabric: rail g of the (src, dst) pair is capped by the
        slower of the two endpoint NICs, so the pair carries at most
        ``sum_g min(nic_bw[src, g], nic_bw[dst, g])`` bytes/s in each
        direction.  Zero on the diagonal (a server is not a pair with
        itself) and for fully disconnected pairs (every rail failed).  This
        is the per-edge weight of the capacity-aware Birkhoff synthesis
        (``birkhoff_decompose(..., capacity_aware=True)``) and the
        denominator of its time-domain traffic matrix.

        Rail g of the pair moves data from the source NIC's *transmit*
        plane into the destination NIC's *receive* plane, so under
        asymmetric rates the matrix is ``sum_g min(tx[src, g],
        rx[dst, g])`` and need not be symmetric.
        """
        caps = np.minimum(self.nic_tx[:, None, :],
                          self.nic_rx[None, :, :]).sum(axis=-1)
        np.fill_diagonal(caps, 0.0)
        return caps

    def nic_shares(self) -> np.ndarray:
        """(n, n, m) fraction of the (src, dst) server-pair bytes each rail
        should carry so all rails of the pair drain simultaneously.

        Rail g of a pair is capped by the slower of the two endpoint NICs
        (rail-aligned fabric: NIC g talks to NIC g), so shares are
        proportional to ``min(nic_bw[src, g], nic_bw[dst, g])`` -- uniform
        1/m on a homogeneous fabric, zero on a failed rail (the pair's
        traffic routes around it), uniform fallback for a fully
        disconnected pair."""
        n, m = self.nic_bw.shape
        caps = np.minimum(self.nic_tx[:, None, :], self.nic_rx[None, :, :])
        tot = caps.sum(axis=-1, keepdims=True)
        shares = np.full((n, n, m), 1.0 / m)
        np.divide(caps, tot, out=shares, where=tot > 0)
        return shares

    # -- adapters --------------------------------------------------------

    @classmethod
    def from_cluster(cls, cluster) -> "Topology":
        """ClusterSpec -> homogeneous Topology adapter (exact cost parity)."""
        fabric = ServerFabric(intra_topology=cluster.intra_topology,
                              b_intra=cluster.b_intra,
                              m_gpus=cluster.m_gpus)
        nic = np.full((cluster.n_servers, cluster.m_gpus), cluster.b_inter)
        topo = cls(fabrics=(fabric,) * cluster.n_servers, nic_bw=nic,
                   alpha=cluster.alpha)
        # Homogeneous by construction: seed the memo so per-iteration
        # consumers (every synthesized plan checks) never recompute it.
        object.__setattr__(topo, "_is_homogeneous", True)
        return topo

    def cluster_view(self):
        """Nearest ClusterSpec (shape + back-compat scalar fields).

        Exact round-trip for ``from_cluster`` topologies; for heterogeneous
        ones the scalars are the fastest resource of each tier and only the
        *shape* fields should be trusted -- timing goes through the
        topology itself.
        """
        from .traffic import ClusterSpec

        return ClusterSpec(
            n_servers=self.n_servers,
            m_gpus=self.m_gpus,
            b_intra=float(max(f.b_intra for f in self.fabrics)),
            b_inter=float(self.nic_bw.max()),
            alpha=self.alpha,
            intra_topology=self.fabrics[0].intra_topology,
        )

    # -- scenario constructors ------------------------------------------

    @classmethod
    def homogeneous(cls, n_servers: int, m_gpus: int, *,
                    b_intra: float = 64e9, b_inter: float = 12.5e9,
                    alpha: float = 10e-6,
                    intra_topology: str = "full_mesh") -> "Topology":
        fabric = ServerFabric(intra_topology=intra_topology,
                              b_intra=b_intra, m_gpus=m_gpus)
        return cls(fabrics=(fabric,) * n_servers,
                   nic_bw=np.full((n_servers, m_gpus), b_inter),
                   alpha=alpha)

    _KEEP = object()  # sentinel: "leave this plane as it is"

    def with_nic_bw(self, nic_bw, *, nic_bw_rx=_KEEP,
                    keep_nominal: bool = False) -> "Topology":
        """New transmit (and optionally receive) rates.

        A plain call defines a *new fabric*: any recovery bookkeeping is
        dropped.  The degrade/fail/recover constructors pass
        ``keep_nominal=True`` so the pre-degradation rates survive the
        edit (captured from the current rates on the first degradation).
        """
        if nic_bw_rx is Topology._KEEP:
            nic_bw_rx = self.nic_bw_rx
        if keep_nominal:
            nom_tx = (self.nominal_nic_bw if self.nominal_nic_bw is not None
                      else self.nic_bw)
            nom_rx = (self.nominal_nic_rx if self.nominal_nic_bw is not None
                      else self.nic_bw_rx)
        else:
            nom_tx = nom_rx = None
        return dataclasses.replace(
            self, nic_bw=np.asarray(nic_bw), nic_bw_rx=nic_bw_rx,
            nominal_nic_bw=nom_tx, nominal_nic_rx=nom_rx)

    def with_nic_rx(self, nic_bw_rx) -> "Topology":
        """Asymmetric up/down rates: override the receive plane only."""
        return self.with_nic_bw(self.nic_bw, nic_bw_rx=np.asarray(nic_bw_rx))

    @staticmethod
    def _check_direction(direction: str) -> None:
        if direction not in ("both", "up", "down"):
            raise ValueError(
                f"direction must be 'both', 'up' or 'down', got {direction!r}")

    def _scale(self, sel, factor: float, direction: str) -> "Topology":
        """Scale one NIC (or a whole server row) in the named plane(s),
        preserving the nominal rates for a later ``recover_nic``."""
        tx = self.nic_bw
        rx = self.nic_bw_rx
        if direction != "both" and rx is None:
            # A single-plane edit on a symmetric fabric forks the planes:
            # the untouched plane must keep its current rate, so the
            # receive mirror becomes explicit first.  'both' keeps
            # symmetric fabrics symmetric (rx stays an implicit mirror).
            rx = np.array(tx)
        if direction in ("up", "both"):
            tx = tx.copy()
            tx[sel] *= factor
        if direction in ("down", "both") and rx is not None:
            rx = np.array(rx)
            rx[sel] *= factor
        return self.with_nic_bw(tx, nic_bw_rx=rx, keep_nominal=True)

    def degrade_nic(self, server: int, nic: int, factor: float,
                    direction: str = "both") -> "Topology":
        """One NIC running at ``factor`` of its nominal speed (0 = failed).

        ``direction`` selects the plane: ``"both"`` (default), ``"up"``
        (transmit only) or ``"down"`` (receive only) for asymmetric
        up/down degradation scenarios."""
        if not 0.0 <= factor <= 1.0:
            raise ValueError(f"degrade factor must be in [0, 1], got {factor}")
        self._check_direction(direction)
        return self._scale((server, nic), factor, direction)

    def fail_nic(self, server: int, nic: int,
                 direction: str = "both") -> "Topology":
        return self.degrade_nic(server, nic, 0.0, direction)

    def degrade_server(self, server: int, factor: float,
                       direction: str = "both") -> "Topology":
        """Every NIC of one server at ``factor`` of nominal (thermal
        throttling, PCIe fault): the whole server becomes a slow rail set."""
        if not 0.0 <= factor <= 1.0:
            raise ValueError(f"degrade factor must be in [0, 1], got {factor}")
        self._check_direction(direction)
        return self._scale(server, factor, direction)

    def fail_server(self, server: int,
                    direction: str = "both") -> "Topology":
        """Whole server off the fabric (power loss, kernel panic)."""
        return self.degrade_server(server, 0.0, direction)

    def recover_nic(self, server: int, nic: int) -> "Topology":
        """Inverse of degrade/fail: one NIC back at its pre-degradation
        rate (both planes).  A no-op when nothing was degraded through the
        scenario constructors; once every link is nominal again the
        recovered topology compares and fingerprints equal to the
        original."""
        return self._restore((server, nic))

    def recover_server(self, server: int) -> "Topology":
        """Every NIC of one server back at its pre-degradation rate."""
        return self._restore(server)

    def _restore(self, sel) -> "Topology":
        nom_tx = self.nominal_nic_bw
        if nom_tx is None:
            return self  # nothing recorded as degraded
        tx = self.nic_bw.copy()
        tx[sel] = nom_tx[sel]
        rx = self.nic_bw_rx
        if rx is not None:
            nom_rx = (self.nominal_nic_rx if self.nominal_nic_rx is not None
                      else nom_tx)
            rx = rx.copy()
            rx[sel] = nom_rx[sel]
        return self.with_nic_bw(tx, nic_bw_rx=rx, keep_nominal=True)

    def with_oversubscription(self, factor: float) -> "Topology":
        return dataclasses.replace(self, oversubscription=float(factor))

    def with_server_nic_speeds(self, speeds: Sequence[float]) -> "Topology":
        """Mixed NIC generations: per-server uniform NIC speed override."""
        if len(speeds) != self.n_servers:
            raise ValueError(
                f"need {self.n_servers} per-server speeds, got {len(speeds)}")
        nic_bw = np.tile(np.asarray(speeds, dtype=np.float64)[:, None],
                         (1, self.m_gpus))
        return self.with_nic_bw(nic_bw, nic_bw_rx=None)

    # -- identity --------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable content hash: keys PlanCache entries and stamps Plans.

        Computed once and memoized -- the instance is immutable (frozen
        dataclass, read-only nic_bw) and the hash sits on the per-miss
        cache path, where traffic/family/plan keys would otherwise each
        re-hash the full NIC matrix."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.blake2b(digest_size=16)
            for f in self.fabrics:
                h.update(repr((f.intra_topology, f.b_intra,
                               f.m_gpus)).encode())
            h.update(self.nic_bw.tobytes())
            if self.nic_bw_rx is not None:
                h.update(b"rx")
                h.update(self.nic_bw_rx.tobytes())
            h.update(repr((self.alpha, self.oversubscription)).encode())
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    def __eq__(self, other) -> bool:
        # Nominal (recovery) rates are deliberately excluded: fabrics with
        # identical live rates schedule identically, and normalization in
        # __post_init__ guarantees a fully-recovered topology compares
        # equal to the pristine original.
        if not isinstance(other, Topology):
            return NotImplemented
        if (self.nic_bw_rx is None) != (other.nic_bw_rx is None):
            return False
        if self.nic_bw_rx is not None and not np.array_equal(
                self.nic_bw_rx, other.nic_bw_rx):
            return False
        return (self.fabrics == other.fabrics
                and self.nic_bw.shape == other.nic_bw.shape
                and np.array_equal(self.nic_bw, other.nic_bw)
                and self.alpha == other.alpha
                and self.oversubscription == other.oversubscription)

    def __hash__(self) -> int:
        return hash(self.fingerprint())

    # -- serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "fabrics": [f.to_dict() for f in self.fabrics],
            "nic_bw": self.nic_bw.tolist(),
            "alpha": float(self.alpha),
            "oversubscription": float(self.oversubscription),
        }
        # Optional planes serialize only when present, so symmetric /
        # pristine fabrics keep the pre-existing JSON shape.
        for key in ("nic_bw_rx", "nominal_nic_bw", "nominal_nic_rx"):
            arr = getattr(self, key)
            if arr is not None:
                d[key] = arr.tolist()
        return d

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["Topology"]:
        if d is None:
            return None

        def opt(key):
            arr = d.get(key)
            return None if arr is None else np.asarray(arr, dtype=np.float64)

        return cls(
            fabrics=tuple(ServerFabric(**f) for f in d["fabrics"]),
            nic_bw=np.asarray(d["nic_bw"], dtype=np.float64),
            alpha=float(d["alpha"]),
            oversubscription=float(d.get("oversubscription", 1.0)),
            nic_bw_rx=opt("nic_bw_rx"),
            nominal_nic_bw=opt("nominal_nic_bw"),
            nominal_nic_rx=opt("nominal_nic_rx"),
        )
