"""The numbers that decide ``correct``: each a reading of the program
against the reference, held to its cell's limit."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

from . import ties


def row_errs(program: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's relative L2 distance of the program's logits from the
    reference's: ``program``, ``ref`` ``[N, V]``."""
    return (program.float() - ref).norm(dim=-1) / ref.norm(dim=-1)


def row_gaps(program: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's gap by which the reference's logit of the token the
    program serves (its argmax) lies below the reference's best, in units
    of the standard deviation of the row's reference logits."""
    picked = ref.gather(-1, program.float().argmax(-1)[:, None])[:, 0]
    return (ref.max(-1).values - picked) / ref.std(-1)


def tie_readings(program: torch.Tensor, br: ties.Branches,
                 margin: float) -> Dict[str, List[float]]:
    """Each request's logit error and served-token gap against the nearest
    of the reference's branches (``ties.branches``) that crosses ties of
    at most ``margin``: ``{"errs", "gaps"}``, a value a request (row of
    ``program [N, V]``)."""
    rows = program[br.owner]
    ok = (br.margin <= margin).to(rows.device)
    inf = torch.tensor(float("inf"), device=rows.device)
    out = {}
    for name, per in (("errs", row_errs(rows, br.logits)),
                      ("gaps", row_gaps(rows, br.logits))):
        best = torch.full((program.shape[0],), float("inf"),
                          device=rows.device)
        out[name] = [float(v) for v in best.scatter_reduce(
            0, br.owner.to(rows.device), torch.where(ok, per, inf), "amin")]
    return out


def rank_median(values: Sequence[float], ranks: Sequence[int]) -> float:
    """The widest over ranks of each rank's lower-median request (the
    second best of four)."""
    by: Dict[int, List[float]] = {}
    for v, r in zip(values, ranks):
        by.setdefault(r, []).append(v)
    return max(sorted(vs)[(len(vs) - 1) // 2] for vs in by.values())


def served_numbers(program: torch.Tensor, br: ties.Branches, margin: float,
                   ranks: Sequence[int]) -> Dict[str, float]:
    """A served cell's numbers, those its limits name compared:
    ``rank_logit_err`` and ``rank_served_gap``, each request's logit error
    and served-token gap against its nearest branch, by ``rank_median``
    over the ranks that served the requests (``ranks``, one a request);
    and the widest request of each (``logit_err_max``,
    ``served_gap_max``).  One or two requests of a hundred read tens of
    percent on a sound run, as they do in a plain reference that only
    rounds otherwise (a rounding cascade beyond the last token's ties), so
    the widest cannot be held; a fault in a rank's rows or exchange moves
    every request of the rank, which the rank's median sees."""
    r = tie_readings(program, br, margin)
    return {"rank_logit_err": rank_median(r["errs"], ranks),
            "rank_served_gap": rank_median(r["gaps"], ranks),
            "logit_err_max": max(r["errs"]),
            "served_gap_max": max(r["gaps"])}


def branch_table(program: torch.Tensor, br: ties.Branches) -> dict:
    """Every branch's request, widest tie crossed, logit error and
    served-token gap (calibration reads the numbers at other ties from
    it)."""
    rows = program[br.owner]
    return {"owner": br.owner.tolist(), "margin": br.margin.tolist(),
            "errs": row_errs(rows, br.logits).tolist(),
            "gaps": row_gaps(rows, br.logits).tolist()}


def rel_gap(program: float, ref: float) -> float:
    return abs(program - ref) / abs(ref)


def leaf_gap(program: Dict[str, float], ref: Dict[str, float],
             names: Sequence[str]) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in names)
    return max(abs(program[k] - ref[k]) / max(ref[k], med) for k in names)


def moved_leaves(first_grad: Dict[str, float]) -> List[str]:
    """Leaves whose first gradient, in the reference, is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone."""
    med = statistics.median(first_grad.values())
    return sorted(k for k, v in first_grad.items() if v >= 1e-3 * med)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` for every limit, and whether every
    reading lies under its limit.  A missing reading fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value == value and value <= limit
    return {"checks": checks, "ok": ok}
