"""Birkhoff-von Neumann decomposition of a server-level traffic matrix.

The heart of FLASH's inter-server stage synthesis (paper section 4.2): an
arbitrary nonnegative n x n traffic matrix T is padded to a matrix with equal
row and column sums ("doubly stochastic" up to scale) and decomposed into a
sum of scaled permutation matrices

    T + P = sum_k  w_k * Perm(pi_k)

Each (pi_k, w_k) becomes one inter-server transfer stage in which server i
sends exactly w_k bytes to server pi_k(i) -- one sender per receiver (incast
free) and equal sizes within the stage (straggler free).  The classic bound
guarantees at most n^2 - 2n + 2 stages.

All of this runs on the host: the paper's deployment (Fig 10) runs the
scheduler on a CPU control thread per iteration, and synthesis time is one of
the two evaluation axes.  Three engines share one stage loop whose float math
(stage weight, subtraction, ``sent`` extraction) is fancy-indexed NumPy; they
differ in how the per-stage perfect matching is obtained:

  * ``policy="exact"`` -- *bit-identical* to the reference.  The positive
    support's adjacency lists are maintained incrementally (stage
    subtraction only ever zeroes matched entries, so a handful of removals
    per stage replaces the reference's O(n^2) per-stage rebuild), and the
    matching Hopcroft-Karp's first phase would build from scratch -- a
    first-fit greedy -- is maintained incrementally under those removals.
    When the greedy is imperfect, the exact Hopcroft-Karp augmentation
    phases run from it, which by construction reproduces the from-scratch
    result (see below).
  * ``policy="repair"`` -- the scale engine.  The previous stage's perfect
    matching stays near-perfect after subtraction (only its own entries can
    hit zero), so it is repaired with augmenting-path searches from the few
    unmatched rows instead of re-running Hopcroft-Karp from scratch:
    amortized O(n * E) over the whole decomposition instead of O(E sqrt(V))
    per stage.  Stage lists are equally valid (same makespan = max line
    sum, same stage bound, incast-free) but not bit-identical to the
    reference -- property-tested rather than golden-tested.
  * ``reference=True`` -- the original interpreted loop (per-stage adjacency
    rebuild, from-scratch Hopcroft-Karp, entry-by-entry updates), kept as
    the golden oracle for the exact engine's identity tests.

``policy="auto"`` (the default) selects "exact" up to ``AUTO_EXACT_MAX_N``
servers -- covering every golden-parity workload and the paper's testbed
scale, so default callers keep seed-identical plans -- and "repair" beyond,
where synthesis speed is the binding constraint (ROADMAP north star) and no
stage list is pinned.

Capacity-aware synthesis (``capacity_aware=True`` with a ``topology=``): on
a heterogeneous fabric the equal-byte-slot stage is no longer
straggler-free -- a slow server pair stretches every stage it rides while
fast pairs idle out their slots.  The aware mode therefore decomposes the
*time* matrix ``tau = T / pair_capacity`` (DESIGN.md section 1d): a stage of
time-weight ``w`` gives pair (i, j) a byte slot of ``w *
pair_capacity(i, j)``, so every pair in the stage drains in the same
``w``-second window (equal-*time* slots, the heterogeneous generalization
of straggler freedom), and both matching engines prefer high-capacity
edges (per-row adjacency ordered by descending ``min``-endpoint capacity;
the exact engine's first-fit tie-breaks and the repair engine's
augmenting-path searches follow that order).  Stages sort ascending by
*duration*, which is what the Theorem 2 pipelining argument needs --
low-capacity pairs automatically ride the small byte slots.  The
capacity-blind path is bit-identical to before: ``capacity_aware=False``
never looks at the topology, and a uniform-capacity fabric degenerates to
the blind decomposition exactly.

Why "exact" can be incremental: Hopcroft-Karp's first BFS/DFS phase on an
empty matching is exactly a first-fit greedy (row u takes the smallest free
column of its adjacency; no augmentation happens because every ``dist`` is
0), and that greedy matching is uniquely characterized by the invariant

    pick[i] = min { j in adj(i) : inv[j] == -1 or inv[j] >= i }     (or -1)

so *any* procedure restoring the invariant after edge deletions lands on the
matching the reference would recompute from scratch; the subsequent
augmentation phases are then a deterministic function of (support, greedy
matching) and can be replayed verbatim.  tests/test_birkhoff.py holds the
stage-list-identity property test against the reference engine.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.locks import check_forbidden, make_lock

__all__ = [
    "Stage",
    "StageBlock",
    "DecompositionState",
    "pad_to_doubly_balanced",
    "hopcroft_karp",
    "birkhoff_decompose",
    "effective_pair_caps",
    "max_line_sum",
    "live_slots",
    "live_slots_batch",
    "stage_duration",
    "AUTO_EXACT_MAX_N",
]

# Relative tolerance used to treat float residuals as zero.
_EPS_REL = 1e-9

# policy="auto" runs the bit-identical exact engine up to this many servers
# (the golden suite and the paper's testbed all sit well below it) and the
# repair engine beyond, where synthesis latency dominates.
AUTO_EXACT_MAX_N = 32


@dataclasses.dataclass(frozen=True)
class Stage:
    """One incast-free, straggler-free inter-server transfer stage.

    perm[i] = j means server i sends to server j during this stage; -1 means
    server i idles (its matched entry was pure padding).  ``size`` is the
    stage's chunk size -- the stage lasts size/(m*B2) regardless of how much
    *real* data each slot carries.  ``sent[i]`` is the genuine byte count
    transferred by server i (<= size; the remainder of the slot is padding,
    i.e. link idle time inside the stage).

    ``slots`` is None for capacity-blind stages (every sender's slot is the
    uniform ``size`` bytes).  Capacity-aware stages carry per-sender slot
    sizes instead: slot i is ``w * pair_capacity(i, perm[i])`` bytes for
    the stage's time-weight ``w``, so all pairs drain in the same window;
    ``size`` is then the largest slot (``sent[i] <= slots[i] <= size``).
    """

    perm: tuple
    size: float
    sent: tuple
    slots: Optional[tuple] = None

    def __post_init__(self):
        if len(self.perm) != len(self.sent):
            raise ValueError(
                f"perm has {len(self.perm)} slots but sent has "
                f"{len(self.sent)} entries; one genuine-byte count per slot")
        if self.slots is not None and len(self.slots) != len(self.perm):
            raise ValueError(
                f"perm has {len(self.perm)} slots but slots has "
                f"{len(self.slots)} entries; one slot size per sender")

    @property
    def active(self) -> int:
        return sum(1 for j in self.perm if j >= 0)

    @property
    def real_bytes(self) -> float:
        return float(sum(self.sent))

    def as_matrix(self, n: int) -> np.ndarray:
        m = np.zeros((n, n))
        perm = np.asarray(self.perm, dtype=np.int64)
        live = perm >= 0
        m[np.flatnonzero(live), perm[live]] = np.asarray(
            self.sent, dtype=np.float64)[live]
        return m


def max_line_sum(t: np.ndarray) -> float:
    """max(max row sum, max col sum): the quantity Birkhoff preserves and the
    numerator of the paper's Theorem 1 optimal completion time."""
    return float(max(t.sum(axis=1).max(), t.sum(axis=0).max()))


def pad_to_doubly_balanced(t: np.ndarray) -> np.ndarray:
    """Return padding P >= 0 such that T + P has all row and column sums equal
    to max_line_sum(T).

    Greedy deficit pairing: repeatedly pick a row with remaining deficit and a
    column with remaining deficit and close the smaller of the two.  Each step
    zeroes at least one deficit, so it terminates in <= 2n steps.  Total row
    deficit always equals total column deficit, so both pools empty together.
    """
    t = np.asarray(t, dtype=np.float64)
    n = t.shape[0]
    if t.shape != (n, n):
        raise ValueError(f"traffic matrix must be square, got {t.shape}")
    if (t < 0).any():
        raise ValueError("traffic matrix must be nonnegative")

    target = max_line_sum(t)
    pad = np.zeros_like(t)
    row_def = target - t.sum(axis=1)
    col_def = target - t.sum(axis=0)
    rows = deque(i for i in range(n) if row_def[i] > 0)
    cols = deque(j for j in range(n) if col_def[j] > 0)
    while rows and cols:
        i, j = rows[0], cols[0]
        amt = min(row_def[i], col_def[j])
        pad[i, j] += amt
        row_def[i] -= amt
        col_def[j] -= amt
        if row_def[i] <= target * _EPS_REL:
            rows.popleft()
        if col_def[j] <= target * _EPS_REL:
            cols.popleft()
    return pad


def hopcroft_karp(adj: Sequence[Sequence[int]], n_right: int) -> List[int]:
    """Maximum bipartite matching via Hopcroft-Karp, O(E * sqrt(V)).

    adj[u] lists right-vertices reachable from left-vertex u.  Returns
    match_left where match_left[u] is the matched right vertex (or -1).
    """
    n_left = len(adj)
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    _augment_phases(adj, match_l, match_r)
    return match_l


def _augment_phases(adj: Sequence[Sequence[int]], match_l: List[int],
                    match_r: List[int]) -> None:
    """Hopcroft-Karp's BFS/DFS phases, in place, from any starting matching.

    This is the reference algorithm's main loop verbatim.  Started from an
    empty matching it *is* ``hopcroft_karp``; started from the first-fit
    greedy matching it reproduces the from-scratch result bit-for-bit,
    because the from-scratch run's first phase builds exactly that greedy
    (all ``dist`` are 0, so no augmentation can happen) and every later
    phase is a deterministic function of (support, current matching).
    """
    n_left = len(adj)
    INF = float("inf")
    dist = [0.0] * n_left

    def bfs() -> bool:
        q = deque()
        for u in range(n_left):
            if match_l[u] == -1:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = INF
        found = False
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = match_r[v]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    q.append(w)
        return found

    def dfs(u: int) -> bool:
        for v in adj[u]:
            w = match_r[v]
            if w == -1 or (dist[w] == dist[u] + 1 and dfs(w)):
                match_l[u] = v
                match_r[v] = u
                return True
        dist[u] = INF
        return False

    while bfs():
        for u in range(n_left):
            if match_l[u] == -1:
                dfs(u)


# -- incremental matching machinery ----------------------------------------

class _CanonicalGreedy:
    """First-fit greedy matching maintained incrementally (exact engine).

    ``pick[i]`` is row i's matched column (-1 if unmatched), ``inv`` the
    inverse map.  The state always satisfies the first-fit invariant (module
    docstring), which uniquely pins it to the matching Hopcroft-Karp's first
    phase would build from scratch on the current support.  ``delete_edges``
    restores the invariant after a stage subtraction zeroes matched entries:
    an affected row re-picks the smallest column that is free, kept, or
    owned by a larger row (stealing makes the victim re-pick), a freed
    column is re-offered to the smallest row that prefers it, and taking a
    column pushes any smaller claimant so it can steal back.  Cascades are
    short in practice: each steal strictly shrinks the thief's pick.

    ``rank`` generalizes "smallest column" to an arbitrary per-row
    preference order (capacity-aware synthesis: ``row_adj`` comes sorted by
    descending pair capacity and ``rank[i, j]`` is column j's position in
    row i's order).  ``rank=None`` keeps the original ascending-index
    comparisons bit-for-bit -- the blind path never allocates or consults a
    rank matrix.  Row order (whose first-fit turn comes first) stays the
    ascending row index in both modes, so ``col_adj`` stays row-sorted.
    """

    def __init__(self, row_adj: List[List[int]], col_adj: List[List[int]],
                 rank: Optional[np.ndarray] = None):
        self.row_adj = row_adj  # shared with the stage loop, pruned there
        self.col_adj = col_adj
        self.rank = rank
        n = len(row_adj)
        self.pick = [-1] * n
        self.inv = [-1] * n
        free = [True] * n
        for i in range(n):
            for j in row_adj[i]:
                if free[j]:
                    self.pick[i] = j
                    self.inv[j] = i
                    free[j] = False
                    break
        self.n_unmatched = sum(1 for p in self.pick if p == -1)

    @property
    def perfect(self) -> bool:
        return self.n_unmatched == 0

    def delete_edges(self, pairs) -> None:
        """Re-establish the invariant after ``pairs`` left the support.

        Only deletions of *currently picked* edges matter: an unpicked edge
        (i, j) with j < pick[i] was already owned by a smaller row (that is
        the invariant), so removing it cannot change any first-fit choice.
        """
        heap: List[int] = []
        freed: List[int] = []
        pick, inv = self.pick, self.inv
        for i, j in pairs:
            if pick[i] == j:
                pick[i] = -1
                inv[j] = -1
                self.n_unmatched += 1
                heapq.heappush(heap, i)
                freed.append(j)
        self._drain(heap, freed)

    def _prefers(self, y: int, a: int, b: int) -> bool:
        """Does row y rank column a strictly before column b (b != -1)?"""
        if self.rank is None:
            return a < b
        return self.rank[y, a] < self.rank[y, b]

    def _drain(self, heap: List[int], freed: List[int]) -> None:
        row_adj, col_adj = self.row_adj, self.col_adj
        pick, inv = self.pick, self.inv
        while heap or freed:
            if heap:
                x = heapq.heappop(heap)
                # Canonical re-pick: smallest column free, kept, or owned by
                # a larger row (first-fit reaches it before that row's turn).
                new = -1
                for c in row_adj[x]:
                    o = inv[c]
                    if o == -1 or o >= x:
                        new = c
                        break
                old = pick[x]
                if new == old:
                    continue
                if old != -1:
                    inv[old] = -1
                    freed.append(old)
                else:
                    self.n_unmatched -= 1
                pick[x] = new
                if new == -1:
                    self.n_unmatched += 1
                    continue
                r = inv[new]
                if r != -1:  # steal from the larger row; it re-picks
                    pick[r] = -1
                    self.n_unmatched += 1
                    heapq.heappush(heap, r)
                inv[new] = x
                # Claimant check: a smaller row whose first-fit turn came
                # before x's may canonically own `new`; push it so it can
                # steal back.
                for y in col_adj[new]:
                    if y >= x:
                        break
                    p = pick[y]
                    if p == -1 or self._prefers(y, new, p):
                        heapq.heappush(heap, y)
                        break
                continue
            j = freed.pop()
            if inv[j] != -1:
                continue
            # Smallest row that would have taken j at its first-fit turn.
            for y in self.col_adj[j]:
                p = pick[y]
                if p == -1 or self._prefers(y, j, p):
                    heapq.heappush(heap, y)
                    # Re-offer until someone takes it: y's re-pick may
                    # settle on a smaller column, which removes y from j's
                    # candidate set -- strict progress.
                    freed.append(j)
                    break


def _kuhn_augment(row_adj: List[List[int]], mask: np.ndarray,
                  match_l: List[int], match_r: List[int], root: int,
                  free_cols: List[int]) -> bool:
    """One augmenting-path search from unmatched ``root`` (repair engine).

    The matching was perfect before this stage's subtraction, so the only
    free columns are the just-zeroed ones (``free_cols``, typically one):
    every expanded row first O(1)-tests its mask entry against those targets
    instead of discovering a free column by scanning, which keeps paths a
    couple of hops long.  Iterative DFS (paths can still be ~n long in the
    eroded endgame; no recursion limit risk); on success the path is flipped
    into the matching in place.
    """
    visited = bytearray(len(match_r))
    stack = [root]
    iters = [iter(row_adj[root])]
    down_col = [-1]  # column each stacked row used to descend

    def finish(x: int, c: int) -> None:
        # Augment: x takes c; every ancestor takes its descent column.
        match_l[x] = c
        match_r[c] = x
        for d in range(len(stack) - 1, 0, -1):
            r, cc = stack[d - 1], down_col[d]
            match_l[r] = cc
            match_r[cc] = r

    while stack:
        x = stack[-1]
        for f in free_cols:
            if match_r[f] == -1 and mask[x, f]:
                finish(x, f)
                return True
        descended = False
        for c in iters[-1]:
            if visited[c]:
                continue
            visited[c] = 1
            o = match_r[c]
            if o == -1:  # safety net: a free column outside free_cols
                finish(x, c)
                return True
            stack.append(o)
            iters.append(iter(row_adj[o]))
            down_col.append(c)
            descended = True
            break
        if not descended:
            stack.pop()
            iters.pop()
            down_col.pop()
    return False


# -- decomposition engines -------------------------------------------------

def birkhoff_decompose(
    t: np.ndarray,
    *,
    sort_ascending: bool = True,
    coalesce: bool = True,
    reference: bool = False,
    policy: str = "auto",
    topology=None,
    capacity_aware: bool = False,
) -> List[Stage]:
    """Decompose a nonnegative square traffic matrix into Birkhoff stages.

    Args:
      t: (n, n) nonnegative matrix of inter-server byte counts.  The diagonal
        (intra-server traffic) must be zero -- FLASH handles it separately by
        overlapping it with the first inter-server stage.
      sort_ascending: execute stages in ascending size order so each stage's
        intra-server redistribute (over B1) hides under the *next* stage's
        inter-server transfer (over B2); see the Theorem 2 pipelining argument.
        Capacity-aware stages sort by *duration* instead of byte size --
        the quantity the pipelining argument actually needs.
      coalesce: merge consecutive stages that share an identical permutation
        support (reduces stage count, whose minimization is NP-hard [20] --
        this is the cheap 80 percent).
      reference: run the original interpreted engine (per-stage adjacency
        rebuild + from-scratch Hopcroft-Karp) instead of an incremental one.
        Bit-identical to policy="exact"; the golden oracle for tests, O(n)
        times slower.  Overrides ``policy``.
      policy: "exact" (bit-identical to the reference, incremental greedy +
        replayed augmentation), "repair" (previous stage's perfect matching
        patched by augmenting paths; fastest, equally valid but different
        stage lists), or "auto" (exact up to AUTO_EXACT_MAX_N servers,
        repair beyond -- see module docstring).
      topology: the fabric whose ``pair_capacity()`` weights the
        capacity-aware decomposition.  Required (and only consulted) when
        ``capacity_aware=True``.
      capacity_aware: decompose the time matrix ``t / pair_capacity``
        instead of the byte matrix, emitting per-sender byte ``slots``
        proportional to pair capacity so every pair of a stage drains in
        the same window, with both matching engines preferring
        high-capacity edges (module docstring).  On a uniform-capacity
        fabric this degenerates to the blind decomposition exactly.

    Returns:
      List of Stage.  sum_k stage_k.as_matrix upper-bounds T elementwise and
      matches it exactly on the support of T (padding shows up as idle slots,
      perm[i] == -1, never as real traffic).
    """
    check_forbidden("birkhoff_decompose")
    t = np.asarray(t, dtype=np.float64).copy()
    n = t.shape[0]
    if n == 0:
        return []
    if np.abs(np.diag(t)).max(initial=0.0) > 0:
        raise ValueError("diagonal (intra-server) traffic must be zero")

    if capacity_aware:
        if reference:
            raise ValueError(
                "the reference oracle is capacity-blind; drop reference=True "
                "or capacity_aware=True")
        caps = _pair_caps(topology, n)
        offdiag = caps[~np.eye(n, dtype=bool)]  # empty for n == 1: uniform
        if offdiag.size and not np.all(offdiag == offdiag.flat[0]):
            return _capacity_aware_stages(t, caps, n, sort_ascending,
                                          coalesce, policy)
        # Uniform pair capacity: time and byte domains coincide up to one
        # global scale, so fall through to the blind path (bit-identical
        # stages, no redundant slots carried).

    total = max_line_sum(t)
    if total <= 0:
        return []
    eps = total * _EPS_REL

    work = t + pad_to_doubly_balanced(t)
    real = t  # mutated alongside `work` to track genuine remaining bytes

    if reference:
        stages = _reference_stages(work, real, n, eps)
    else:
        stages = _incremental_stages(work, real, n, eps,
                                     _resolve_policy(policy, n))

    if coalesce:
        stages = _coalesce(stages)
    if sort_ascending:
        stages.sort(key=lambda s: s.size)
    return stages


def _resolve_policy(policy: str, n: int) -> str:
    if policy == "auto":
        policy = "exact" if n <= AUTO_EXACT_MAX_N else "repair"
    if policy not in ("exact", "repair"):
        raise ValueError(
            f"unknown policy {policy!r}; pick from auto/exact/repair")
    return policy


def _pair_caps(topology, n: int) -> np.ndarray:
    if topology is None:
        raise ValueError("capacity_aware=True requires topology=")
    if topology.n_servers != n:
        raise ValueError(
            f"topology has {topology.n_servers} servers but the traffic "
            f"matrix is {n}x{n}")
    return topology.pair_capacity()


def effective_pair_caps(caps: np.ndarray) -> np.ndarray:
    """Pair capacities as the time-domain decomposition consumes them.

    A fully disconnected pair can never drain -- keep it schedulable (the
    executor charges infinity) by converting at the slowest live capacity.
    The diagonal is forced to 1.0; it is never consulted because traffic
    matrices carry a zero diagonal.
    """
    n = caps.shape[0]
    off = ~np.eye(n, dtype=bool)
    pos = caps[off & (caps > 0)]
    fallback = float(pos.min()) if pos.size else 1.0
    caps_eff = np.where(caps > 0, caps, fallback)
    np.fill_diagonal(caps_eff, 1.0)
    return caps_eff


def _capacity_pref_rank(caps_eff: np.ndarray) -> np.ndarray:
    """Per-row preference: descending pair capacity, ascending index on ties
    (stable argsort), so uniform-capacity rows keep first-fit order."""
    n = caps_eff.shape[0]
    order = np.argsort(-caps_eff, axis=1, kind="stable")
    rank = np.empty((n, n), dtype=np.int64)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(n), (n, n)),
                      axis=1)
    return rank


def _capacity_aware_stages(t: np.ndarray, caps: np.ndarray, n: int,
                           sort_ascending: bool, coalesce: bool,
                           policy: str) -> List[Stage]:
    """Time-domain decomposition: stages of tau = t / pair_capacity, matched
    with high-capacity-first preference, converted back to byte slots."""
    caps_eff = effective_pair_caps(caps)

    tau = t / caps_eff
    total = max_line_sum(tau)
    if total <= 0:
        return []
    eps = total * _EPS_REL
    work = tau + pad_to_doubly_balanced(tau)

    rank = _capacity_pref_rank(caps_eff)

    stages = _incremental_stages(work, tau, n, eps,
                                 _resolve_policy(policy, n), pref_rank=rank)
    if coalesce:
        stages = _coalesce(stages)
    if sort_ascending:
        stages.sort(key=lambda s: s.size)  # time units: ascending durations
    out = []
    for s in stages:
        byte_stage = _stage_to_bytes(s, caps_eff, n)
        if byte_stage is not None:  # padding-only stages carry nothing
            out.append(byte_stage)
    return out


def live_slots(perm, slots, size: float):
    """Shared slot-extraction idiom: ``(src, dst, slot)`` for a stage's
    live senders -- their row indices, destinations, and per-sender slot
    bytes (the uniform ``size`` when ``slots`` is None).  Used by the
    executor, the validator and the duration helpers so slot semantics
    live in one place."""
    perm = np.asarray(perm, dtype=np.int64)
    src = np.flatnonzero(perm >= 0)
    dst = perm[src]
    slot = (np.asarray(slots, dtype=np.float64)[src] if slots is not None
            else np.full(src.size, float(size)))
    return src, dst, slot


def live_slots_batch(perms, slots):
    """Batched ``live_slots`` over ``S`` stacked stages.

    Args:
      perms: (S, n) int array of stage permutations (-1 = idle sender).
      slots: (S, n) float array of per-sender slot bytes; the caller fills
        capacity-blind rows with the stage's uniform ``size``.

    Returns ``(mask, dst, slot)``: the (S, n) live-sender mask, the
    destination indices clipped to 0 where idle (safe for fancy indexing),
    and the slot bytes zeroed where idle -- so downstream vectorized math
    can run over the full padded arrays with dead senders contributing
    exactly nothing.  This is the compile-time counterpart of the
    per-stage ``live_slots`` idiom (used by the plan compiler in
    simulator.py to time all permutation stages in one pass).
    """
    perms = np.asarray(perms, dtype=np.int64)
    mask = perms >= 0
    dst = np.where(mask, perms, 0)
    slot = np.where(mask, np.asarray(slots, dtype=np.float64), 0.0)
    return mask, dst, slot


def _stage_to_bytes(s: Stage, caps: np.ndarray, n: int) -> Optional[Stage]:
    """Convert one time-domain stage (weight w seconds) into byte slots:
    pair (i, j) gets a ``w * caps[i, j]``-byte slot, so every pair drains
    in the same w-second window."""
    perm = np.asarray(s.perm, dtype=np.int64)
    rows = np.flatnonzero(perm >= 0)
    if rows.size == 0:
        return None
    c = caps[rows, perm[rows]]
    slots = np.zeros(n)
    slots[rows] = s.size * c
    sent = np.zeros(n)
    sent[rows] = np.asarray(s.sent, dtype=np.float64)[rows] * c
    return Stage(perm=s.perm, size=float(slots.max(initial=0.0)),
                 sent=tuple(sent.tolist()), slots=tuple(slots.tolist()))


def stage_duration(stage: Stage, caps: np.ndarray) -> float:
    """Seconds a stage occupies on the fabric whose pair capacities are
    ``caps``: the slowest live pair's slot over its capacity.  Uniform
    ``size``-byte slots when the stage carries no per-sender slots."""
    src, dst, slot = live_slots(stage.perm, stage.slots, stage.size)
    if src.size == 0:
        return 0.0
    c = caps[src, dst]
    out = np.full(src.size, np.inf)
    np.divide(slot, c, out=out, where=c > 0)
    out[(c <= 0) & (slot <= 0)] = 0.0
    return float(out.max(initial=0.0))


def _incremental_stages(work: np.ndarray, real: np.ndarray, n: int,
                        eps: float, policy: str,
                        pref_rank: Optional[np.ndarray] = None,
                        init_match: Optional[List[int]] = None,
                        seed_out: Optional[List[List[int]]] = None
                        ) -> List[Stage]:
    """Shared vectorized stage loop for the exact and repair engines.

    Per stage, the float math is pure NumPy fancy indexing; the support's
    adjacency lists shrink incrementally (only matched entries can hit
    zero); the two policies differ solely in how the next perfect matching
    is obtained from the previous one.  ``pref_rank`` (capacity-aware
    synthesis) orders each row's adjacency by the given per-row preference
    instead of ascending column index, which steers both engines' matching
    choices toward high-capacity edges; None keeps the original order
    bit-for-bit.

    ``init_match`` warm-seeds the repair engine's first matching: edges of a
    previous decomposition's perfect matching that still lie on the current
    support are adopted, and only the rows they no longer cover pay
    augmenting-path searches -- the "targeted at changed rows/cols" half of
    incremental trajectory synthesis (DecompositionState).  ``seed_out``,
    when given, receives that first perfect matching (one append) so the
    caller can carry it to the next delta.  Both are ignored by the exact
    engine, whose matching is pinned by the first-fit invariant.
    """
    mask = work > eps
    if pref_rank is None:
        row_adj: List[List[int]] = [np.flatnonzero(mask[i]).tolist()
                                    for i in range(n)]
    else:
        row_adj = []
        for i in range(n):
            cols = np.flatnonzero(mask[i])
            row_adj.append(
                cols[np.argsort(pref_rank[i, cols], kind="stable")].tolist())
    col_adj: List[List[int]] = [np.flatnonzero(mask[:, j]).tolist()
                                for j in range(n)]
    nnz = int(mask.sum())

    exact = policy == "exact"
    greedy: Optional[_CanonicalGreedy] = None
    match_l: List[int] = []
    match_r: List[int] = []
    n_free = 0  # unmatched rows of the maintained matching (repair engine)
    if exact:
        greedy = _CanonicalGreedy(row_adj, col_adj, rank=pref_rank)
    else:
        # Repair engine: one full matching up front, patched ever after.
        match_l = [-1] * n
        match_r = [-1] * n
        if init_match is not None:
            # Adopt surviving edges of the carried matching; the augment
            # phases below only have to repair the rows that lost theirs.
            for i, j in enumerate(init_match):
                if 0 <= j < n and mask[i, j] and match_r[j] == -1:
                    match_l[i] = j
                    match_r[j] = i
        _augment_phases(row_adj, match_l, match_r)
        n_free = sum(1 for m in match_l if m == -1)
        if seed_out is not None:
            seed_out.append(list(match_l))

    rows = np.arange(n)
    stages: List[Stage] = []
    # Each iteration removes at least one nonzero entry of `work`, and `work`
    # starts with at most n^2 nonzeros: classic <= n^2 - 2n + 2 stage bound.
    for _ in range(n * n + 2 * n):
        if nnz == 0:  # mask mirrors (work > eps): same stop condition
            break
        imperfect = False
        if exact:
            if greedy.perfect:
                match = greedy.pick
            else:
                match = list(greedy.pick)
                inv = list(greedy.inv)
                _augment_phases(row_adj, match, inv)
                imperfect = any(m < 0 for m in match)
        else:
            match = match_l
            imperfect = n_free > 0
        if imperfect:
            # Can only happen through float erosion of an almost-zero line;
            # route remaining mass greedily and stop.
            _greedy_drain(real, stages, eps)
            break
        match_arr = np.array(match, dtype=np.int64)
        vals = work[rows, match_arr]
        w = float(vals.min())
        newvals = vals - w
        work[rows, match_arr] = newvals
        zero = newvals <= eps

        rvals = real[rows, match_arr]
        has_real = rvals > eps
        amt = np.where(has_real, np.minimum(rvals, w), 0.0)
        real[rows, match_arr] = rvals - amt
        perm = np.where(has_real, match_arr, -1)
        stages.append(Stage(perm=tuple(perm.tolist()), size=w,
                            sent=tuple(amt.tolist())))

        zr, zc = rows[zero], match_arr[zero]
        mask[zr, zc] = False
        pairs = list(zip(zr.tolist(), zc.tolist()))
        for i, j in pairs:
            row_adj[i].remove(j)
            col_adj[j].remove(i)
        nnz -= len(pairs)
        if nnz == 0:
            break
        if exact:
            greedy.delete_edges(pairs)
        else:
            # The zeroed entries are the matching's own edges: unmatch those
            # rows, then re-match each with one augmenting-path search
            # targeted at the just-freed columns.
            for i, j in pairs:
                match_l[i] = -1
                match_r[j] = -1
            free_cols = [j for _, j in pairs]
            for i, _ in pairs:
                if match_l[i] == -1 and \
                        not _kuhn_augment(row_adj, mask, match_l, match_r,
                                          i, free_cols):
                    # Float erosion can strand a row even though mass
                    # remains; one from-scratch rebuild confirms before the
                    # drain fallback triggers at the top of the next pass.
                    _augment_phases(row_adj, match_l, match_r)
                    break
            n_free = sum(1 for m in match_l if m == -1) \
                if any(match_l[i] == -1 for i, _ in pairs) else 0
    else:  # pragma: no cover - loop bound is a mathematical guarantee
        raise RuntimeError("Birkhoff decomposition failed to terminate")
    return stages


def _reference_stages(work: np.ndarray, real: np.ndarray, n: int,
                      eps: float) -> List[Stage]:
    """The original interpreted decomposition loop (golden oracle)."""
    stages: List[Stage] = []
    for _ in range(n * n + 2 * n):
        if work.max() <= eps:
            break
        adj = [[j for j in range(n) if work[i, j] > eps] for i in range(n)]
        match = hopcroft_karp(adj, n)
        if any(m == -1 for m in match):
            # Can only happen through float erosion of an almost-zero line;
            # route remaining mass greedily and stop.
            _greedy_drain(real, stages, eps)
            break
        w = min(work[i, match[i]] for i in range(n))
        perm = []
        sent = []
        for i in range(n):
            j = match[i]
            work[i, j] -= w
            if real[i, j] > eps:
                amt = min(real[i, j], w)
                real[i, j] -= amt
                perm.append(j)
                sent.append(float(amt))
            else:
                perm.append(-1)  # padding-only slot: server i idles
                sent.append(0.0)
        stages.append(Stage(perm=tuple(perm), size=float(w), sent=tuple(sent)))
    else:  # pragma: no cover - loop bound is a mathematical guarantee
        raise RuntimeError("Birkhoff decomposition failed to terminate")
    return stages


def _coalesce(stages: List[Stage]) -> List[Stage]:
    merged: dict = {}
    order: List[tuple] = []
    for s in stages:
        if s.perm in merged:
            size, sent = merged[s.perm]
            merged[s.perm] = (size + s.size,
                              tuple(a + b for a, b in zip(sent, s.sent)))
        else:
            merged[s.perm] = (s.size, s.sent)
            order.append(s.perm)
    return [Stage(perm=p, size=merged[p][0], sent=merged[p][1])
            for p in order]


# -- incremental trajectory synthesis ---------------------------------------

@dataclasses.dataclass(frozen=True)
class StageBlock:
    """A whole stage list as stacked arrays (one emission of the
    incremental engine).

    ``perms`` is (S, n) int64 with -1 for idle senders, ``sizes`` (S,) the
    per-stage chunk sizes, ``sent`` (S, n) the genuine bytes each sender
    carries, and ``slots`` either None (capacity-blind: every live slot is
    the uniform stage size) or (S, n) per-sender slot bytes.  Stages are
    already in execution order (ascending size, or ascending duration when
    capacity-aware).  Keeping the arrays stacked is the point: a drifting
    trajectory re-emits ~n^2 stages per step, and materializing that many
    Stage/PermutationStage objects costs more than the decomposition delta
    itself.
    """

    perms: np.ndarray
    sizes: np.ndarray
    sent: np.ndarray
    slots: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.sizes.shape[0])

    def to_stages(self) -> List[Stage]:
        """Expand into per-stage objects (tests / interop, not hot paths)."""
        out: List[Stage] = []
        for k in range(len(self)):
            out.append(Stage(
                perm=tuple(self.perms[k].tolist()),
                size=float(self.sizes[k]),
                sent=tuple(self.sent[k].tolist()),
                slots=(tuple(self.slots[k].tolist())
                       if self.slots is not None else None)))
        return out


class DecompositionState:
    """Birkhoff decomposition *maintained* across a drifting trajectory.

    Instead of re-decomposing every matrix from scratch (or re-walking a
    cached ancestor's stage list in Python), the state keeps the previous
    decomposition's structure -- stage permutations, per-slot byte
    capacities, and the repair engine's last perfect matching -- and
    ``update(t_new)`` re-derives a valid stage list for the next matrix of
    the trajectory in three vectorized moves:

      1. *Refill*: every existing slot re-fills from the new matrix by a
         water-fill over each pair's slots in stage order (``take =
         clip(t_pair - prior_cap, 0, cap)`` with a segmented cumsum), so
         shrinking traffic shrinks slots in place and growing traffic
         spills into each pair's last slot, which carries ``headroom``
         extra capacity exactly to absorb drift without structural change.
      2. *Residual*: whatever the slots could not absorb is decomposed
         fresh -- but it is a sparse few-percent matrix, and the repair
         engine is warm-seeded with the previous residual's perfect
         matching (augmenting-path work only on changed rows/cols).  New
         stages join the state, so the structure tracks the trajectory.
      3. *Ratchet*: repair quality can only be audited, not guaranteed --
         cumulative drift could in principle stretch the stage list.  The
         update trips (returns no block and invalidates the state) when the
         residual fraction, live stage count, or total window length
         crosses the configured bounds; the caller then resynthesizes cold
         and builds a fresh state.  This bounds trajectory degradation by
         construction.

    One state serves one (cluster, topology, algorithm) plan family.
    ``update`` is serialized by an internal lock; callers hand the state
    from plan to plan (see FlashScheduler.try_repair_plan) so a family's
    misses chain through it.
    """

    def __init__(self, perms: np.ndarray, sent: np.ndarray, *,
                 caps_eff: Optional[np.ndarray] = None,
                 headroom: float = 0.5):
        perms = np.asarray(perms, dtype=np.int64)
        sent = np.asarray(sent, dtype=np.float64)
        if perms.ndim != 2 or perms.shape != sent.shape:
            raise ValueError(
                f"perms {perms.shape} and sent {sent.shape} must be "
                f"matching (S, n) arrays")
        self.n = int(perms.shape[1])
        self.aware = caps_eff is not None
        self.caps_eff = (np.asarray(caps_eff, dtype=np.float64)
                         if caps_eff is not None else None)
        if self.aware and self.caps_eff.shape != (self.n, self.n):
            raise ValueError("caps_eff must be (n, n)")
        self.headroom = float(headroom)
        self.invalid = False
        self.updates = 0
        self._rank = (_capacity_pref_rank(self.caps_eff)
                      if self.aware else None)
        self._res_seed: Optional[List[int]] = None
        self._take_buf: Optional[np.ndarray] = None
        self._lock = make_lock("DecompositionState._lock")
        # Slots with no byte capacity can never carry traffic; drop them at
        # ingest so the flat index stays dense.
        self._perms2d = np.where(sent > 0.0, perms, -1)
        self._capmat = np.where(sent > 0.0, sent, 0.0)
        self._build_index()

    @classmethod
    def from_stages(cls, stages: Sequence[Stage], n: int, *,
                    caps_eff: Optional[np.ndarray] = None,
                    headroom: float = 0.5) -> "DecompositionState":
        """Seed a state from a cold decomposition's stage list."""
        if len(stages) == 0:
            perms = np.full((0, n), -1, dtype=np.int64)
            sent = np.zeros((0, n))
        else:
            perms = np.array([s.perm for s in stages], dtype=np.int64)
            sent = np.array([s.sent for s in stages], dtype=np.float64)
        return cls(perms, sent, caps_eff=caps_eff, headroom=headroom)

    # -- flat slot index -----------------------------------------------------

    def _build_index(self) -> None:
        """Flatten live slots into arrays sorted by (pair, stage order).

        The water-fill needs each pair's slots contiguous and in stage
        order so an exclusive prefix sum of capacities gives every slot's
        fill threshold.  Rebuilt only when the structure changes (residual
        stages appended), never on a pure refill.
        """
        n = self.n
        stage_idx, src = np.nonzero(self._capmat > 0.0)
        dst = self._perms2d[stage_idx, src]
        pair = src * n + dst
        # Single fused-key sort (pair-major, stage-minor): one stable
        # argsort is ~3x cheaper than the equivalent two-pass lexsort.
        n_store = self._perms2d.shape[0]
        order = np.argsort(pair * n_store + stage_idx, kind="stable")
        # Everything the refill touches per update is kept in the
        # STAGE-MAJOR domain (np.nonzero is already row-major): the
        # per-slot fill thresholds need pair-contiguity only here, at
        # build time, so the water-fill cumsums run pair-major and are
        # scattered back once.  update() is then pure elementwise work on
        # these flat arrays plus one reduceat per stage -- no dense (S, n)
        # pass and no per-update permutation.
        self._sm_stage = stage_idx
        self._sm_src = src
        self._sm_flat = src * n + dst  # ravel index into t_new
        self._sm_out_flat = stage_idx * n + src  # ravel index into (S, n)
        if stage_idx.size:
            stg_cuts = np.flatnonzero(np.diff(stage_idx)) + 1
            self._stg_start = np.concatenate(([0], stg_cuts))
            self._stg_ids = stage_idx[self._stg_start]
        else:
            self._stg_start = np.zeros(0, dtype=np.int64)
            self._stg_ids = np.zeros(0, dtype=np.int64)
        # True when every stored stage owns at least one slot (the normal
        # case: stages are born with traffic): the per-stage reduceat then
        # yields sizes directly, no zeros+scatter.
        self._stg_full = self._stg_ids.size == self._perms2d.shape[0]
        self._sm_paircap = self.caps_eff[src, dst] if self.aware else None
        cap = self._capmat[stage_idx, src][order]
        pair_sorted = pair[order]
        cuts = np.flatnonzero(np.diff(pair_sorted)) + 1
        start = np.concatenate(([0], cuts))
        end = np.concatenate((cuts, [pair_sorted.size]))
        if pair_sorted.size == 0:
            start = np.zeros(0, dtype=np.int64)
            end = np.zeros(0, dtype=np.int64)
        # Headroom rides each pair's last (largest-threshold) slot: growth
        # within `headroom x pair_total` refills in place, no new stages.
        cap_fill = cap.copy()
        if start.size:
            pair_tot = np.add.reduceat(cap, start)
            cap_fill[end - 1] += self.headroom * pair_tot
        cum = np.cumsum(cap_fill)
        prior = cum - cap_fill
        if start.size:
            prior = prior - np.repeat(prior[start], end - start)
        # Scatter thresholds back to stage-major slot positions.
        self._cap_sm = np.empty_like(cap_fill)
        self._cap_sm[order] = cap_fill
        self._prior_sm = np.empty_like(prior)
        self._prior_sm[order] = prior
        # Closed-form fill totals: a water-fill delivers min(t_pair,
        # pair capacity), so the residual never needs the per-slot takes.
        self._pair_cap_tot = np.zeros((n, n))
        if start.size:
            src_first = src[order][start]
            dst_first = dst[order][start]
            self._pair_cap_tot[src_first, dst_first] = np.add.reduceat(
                cap_fill, start)

    def _append_live(self, stages: Sequence[Stage],
                     take_sm: np.ndarray) -> np.ndarray:
        """Extend the flat index with freshly decomposed residual stages,
        in place -- no full rebuild.  New stages append at the end of the
        store (small residual slivers, executed last).  The carried
        headroom stays where it is; each touched pair gains extra headroom
        on its last *new* slot, so the invariant ``pair fill capacity =
        slot bytes + headroom x pair bytes`` keeps tracking the traffic.
        Returns ``take_sm`` extended with the new slots' takes (each new
        slot carries exactly its decomposed bytes this step).
        """
        n = self.n
        n_old_stages = self._perms2d.shape[0]
        n_old_slots = take_sm.size
        perms = np.array([s.perm for s in stages], dtype=np.int64)
        sent = np.array([s.sent for s in stages], dtype=np.float64)
        live = sent > 0.0
        perms = np.where(live, perms, -1)
        self._perms2d = np.concatenate([self._perms2d, perms], axis=0)
        self._capmat = np.concatenate(
            [self._capmat, np.where(live, sent, 0.0)], axis=0)
        f_idx, src = np.nonzero(live)
        stage = n_old_stages + f_idx
        dst = perms[f_idx, src]
        flat = src * n + dst
        cap = sent[f_idx, src]
        # Water-fill thresholds: a new slot fills only after everything
        # its pair already had -- stored slots incl. their headroom, plus
        # earlier new slots of the same pair in append order.  The slot
        # count here is tiny (residual support), so a Python walk beats
        # another segmented-cumsum setup.
        prior = np.empty(cap.size)
        cap_fill = cap.copy()
        base = self._pair_cap_tot.ravel()
        added: dict = {}
        last_new: dict = {}
        for k in range(cap.size):
            p = int(flat[k])
            a = added.get(p, 0.0)
            prior[k] = base[p] + a
            added[p] = a + float(cap[k])
            last_new[p] = k
        for p, k in last_new.items():
            cap_fill[k] += self.headroom * added[p]
        for p, a in added.items():
            base[p] += a * (1.0 + self.headroom)
        self._sm_stage = np.concatenate([self._sm_stage, stage])
        self._sm_src = np.concatenate([self._sm_src, src])
        self._sm_flat = np.concatenate([self._sm_flat, flat])
        self._sm_out_flat = np.concatenate(
            [self._sm_out_flat, stage * n + src])
        self._cap_sm = np.concatenate([self._cap_sm, cap_fill])
        self._prior_sm = np.concatenate([self._prior_sm, prior])
        if stage.size:
            starts = np.concatenate(
                ([0], np.flatnonzero(np.diff(stage)) + 1))
            self._stg_start = np.concatenate(
                [self._stg_start, n_old_slots + starts])
            self._stg_ids = np.concatenate([self._stg_ids, stage[starts]])
        self._stg_full = self._stg_ids.size == self._perms2d.shape[0]
        if self.aware:
            self._sm_paircap = np.concatenate(
                [self._sm_paircap, self.caps_eff[src, dst]])
        return np.concatenate([take_sm, cap])

    # -- the delta path ------------------------------------------------------

    def update(self, t_new: np.ndarray, *,
               max_residual_fraction: float = 0.25,
               max_stage_drift: float = 2.0,
               quality_ratchet: float = 1.10
               ) -> Tuple[Optional[StageBlock], dict]:
        """Re-derive a stage list for ``t_new`` from the carried structure.

        Returns ``(block, stats)``.  ``block`` is None when a ratchet
        tripped (stats["tripped"] names which); the state is then invalid
        and the caller must resynthesize cold.  ``stats`` always carries
        ``residual_fraction`` and, on success, ``n_stages`` and
        ``quality`` (total window length over the exact lower bound).
        """
        with self._lock:
            return self._update_locked(
                np.asarray(t_new, dtype=np.float64),
                max_residual_fraction, max_stage_drift, quality_ratchet)

    def _update_locked(self, t_new, max_residual_fraction, max_stage_drift,
                       quality_ratchet):
        if self.invalid:
            raise RuntimeError(
                "DecompositionState tripped its ratchet; build a fresh one "
                "from a cold synthesis")
        n = self.n
        if t_new.shape != (n, n):
            raise ValueError(f"expected ({n}, {n}) matrix, got {t_new.shape}")
        stats: dict = {"mode": "incremental"}
        total = float(t_new.sum())

        # 1. Refill, entirely in the stage-major domain: each slot takes
        # clip(t_pair - prior, 0, cap) against its precomputed water-fill
        # thresholds -- one flat gather plus in-place elementwise ops.
        nslots = self._sm_src.size
        if nslots:
            # The takes never escape (emission scatters them into a fresh
            # block), so reuse one scratch buffer across updates.
            take_sm = self._take_buf
            if take_sm is None or take_sm.size != nslots:
                take_sm = np.empty(nslots)
                self._take_buf = take_sm
            np.take(t_new.reshape(-1), self._sm_flat, out=take_sm)
            take_sm -= self._prior_sm
            np.maximum(take_sm, 0.0, out=take_sm)
            np.minimum(take_sm, self._cap_sm, out=take_sm)
        else:
            take_sm = np.zeros(0)

        # 2. Residual: what the slots could not absorb, in closed form --
        # the water-fill delivers exactly min(t_pair, pair capacity), so
        # no per-slot reduction is needed.  Entries below the cutoff are
        # float fuzz (and far inside the validator's conservation
        # tolerance); dropping them keeps the residual support sparse.
        residual = np.maximum(t_new - self._pair_cap_tot, 0.0)
        byte_line = max_line_sum(t_new)  # shared: cutoff + quality lower
        cutoff = 1e-10 * max(byte_line, 1e-300)
        if float(residual.max(initial=0.0)) <= cutoff:
            # Fully absorbed (the steady case) -- skip the masking pass.
            res_total = 0.0
        else:
            residual[residual <= cutoff] = 0.0
            res_total = float(residual.sum())
        res_frac = res_total / total if total > 0 else 0.0
        stats["residual_fraction"] = res_frac
        if res_frac > max_residual_fraction:
            self.invalid = True
            stats["tripped"] = "residual"
            return None, stats

        if res_total > 0.0:
            fresh = self._decompose_residual(residual)
            stats["residual_stages"] = len(fresh)
            if fresh:
                # Structural change (rare on a drifting trajectory: the
                # slot headroom absorbs in-place drift): extend the flat
                # index in place -- no rebuild, no dense pass.  Appended
                # stages sit at the end of the store and execute last.
                take_sm = self._append_live(fresh, take_sm)
                nslots = take_sm.size

        # 3. Emit + ratchet audit: per-stage maxima via one flat reduceat
        # -- no dense (S, n) pass on the trajectory hot path.
        S = self._perms2d.shape[0]
        if self._stg_full and nslots:
            sizes_all = np.maximum.reduceat(take_sm, self._stg_start)
        else:
            sizes_all = np.zeros(S)
            if nslots:
                sizes_all[self._stg_ids] = np.maximum.reduceat(
                    take_sm, self._stg_start)
        if not self.aware:
            key_all = sizes_all
        elif self._stg_full and nslots:
            key_all = np.maximum.reduceat(
                take_sm / self._sm_paircap, self._stg_start)
        else:
            key_all = np.zeros(S)
            if nslots:
                key_all[self._stg_ids] = np.maximum.reduceat(
                    take_sm / self._sm_paircap, self._stg_start)
        live = sizes_all > 0.0
        n_live = int(live.sum())
        stats["n_stages"] = n_live
        bound = n * n - 2 * n + 2
        if n_live > max_stage_drift * bound:
            self.invalid = True
            stats["tripped"] = "stages"
            return None, stats
        # Quality: an exact decomposition's windows sum to the max line sum
        # (bytes, or seconds in the aware time domain) -- the Theorem 1
        # completion-time numerator.  Chained repairs may drift above it.
        lower = max_line_sum(t_new / self.caps_eff) if self.aware \
            else byte_line
        all_live = n_live == S
        q_sum = float(key_all.sum() if all_live else key_all[live].sum())
        quality = q_sum / lower if lower > 0 else 1.0
        stats["quality"] = quality
        if quality > quality_ratchet:
            self.invalid = True
            stats["tripped"] = "quality"
            return None, stats

        # Emission keeps the stored stage order: it is the cold
        # decomposition's ascending execution order, and per-step drift
        # perturbs sizes only locally, so re-sorting every update would
        # cost an (S, n) gather for a negligible pipeline-overlap gain
        # (the quality ratchet audits the window sum either way).
        # Appended residual slivers execute last.
        if all_live and bool(take_sm.all()):
            # Steady state -- every carried stage and slot refilled.  The
            # store IS the emission: zero-copy perms, and only the sent
            # scatter allocates (through the precomputed flat index: one
            # 1-D fancy store instead of a 2-D advanced-index resolve).
            out_sent = np.zeros(S * n)
            out_sent[self._sm_out_flat] = take_sm
            out_sent.shape = (S, n)
            out_perms = self._perms2d
            out_sizes = sizes_all
        else:
            idx = np.flatnonzero(live)
            row = np.full(S, -1, dtype=np.int64)
            row[idx] = np.arange(idx.size)
            live_slot = take_sm > 0.0
            out_sent = np.zeros((idx.size, n))
            out_sent[row[self._sm_stage[live_slot]],
                     self._sm_src[live_slot]] = take_sm[live_slot]
            out_perms = self._perms2d[idx]
            if not live_slot.all():
                # A carried slot that refilled to zero is idle this step:
                # mask its perm entry so the emitted stage stays tight.
                dead = ~live_slot
                dr = row[self._sm_stage[dead]]
                keep = dr >= 0
                out_perms[dr[keep], self._sm_src[dead][keep]] = -1
            out_sizes = sizes_all[idx]
        block = StageBlock(
            perms=out_perms,
            sizes=out_sizes,
            sent=out_sent,
            slots=out_sent.copy() if self.aware else None)
        self.updates += 1
        return block, stats

    def _decompose_residual(self, residual: np.ndarray) -> List[Stage]:
        """Fresh stages for the unabsorbed delta, warm-seeded matching.

        Capacity-aware states decompose in the time domain (matching the
        cold flash_ca path) and convert weights back to byte ``sent``
        entries; the per-slot capacity recorded in the state is the byte
        count, so refills stay in the byte domain either way.
        """
        n = self.n
        work_base = residual / self.caps_eff if self.aware else residual
        total = max_line_sum(work_base)
        if total <= 0:
            return []
        eps = total * _EPS_REL
        work = work_base + pad_to_doubly_balanced(work_base)
        realm = work_base.copy()
        seed: List[List[int]] = []
        stages = _incremental_stages(work, realm, n, eps, "repair",
                                     pref_rank=self._rank,
                                     init_match=self._res_seed,
                                     seed_out=seed)
        self._res_seed = seed[0] if seed else None
        stages = _coalesce(stages)
        out: List[Stage] = []
        for s in stages:
            if self.aware:
                s = _stage_to_bytes(s, self.caps_eff, n)
                if s is None:
                    continue
            elif not any(v > 0.0 for v in s.sent):
                continue  # padding-only stage: nothing to carry forward
            out.append(s)
        return out


def _greedy_drain(real: np.ndarray, stages: List[Stage], eps: float) -> None:
    """Fallback for pathological float residue: one stage per remaining entry."""
    n = real.shape[0]
    idx = np.argwhere(real > eps)
    for i, j in idx:
        perm = [-1] * n
        sent = [0.0] * n
        perm[int(i)] = int(j)
        sent[int(i)] = float(real[i, j])
        stages.append(Stage(perm=tuple(perm), size=float(real[i, j]),
                            sent=tuple(sent)))
        real[i, j] = 0.0
