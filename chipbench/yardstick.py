"""The benchmark's frozen yardstick: peaks, useful-work counts and the
arithmetic every metric reader shares.

Nothing here reads the program.  Work is counted from the configuration's
widths and the traffic's shapes (rows, tokens, experts per token), never
from the capacity-padded grids the program happens to compute, so a
change that stops computing padded rows raises a share instead of making
the count stale.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

# One NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core peak and HBM3
# bandwidth.  Each share is stated against these with the card's
# power.limit beside it (run.py prints it).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


# -- model FLOPs ---------------------------------------------------------------

def attn_params(m: dict) -> int:
    """wq, wk, wv and wo of one layer."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return d * h * dh + 2 * d * kv * dh + h * dh * d


def expert_params(m: dict) -> int:
    """One SwiGLU expert: gate, up and down."""
    return 3 * m["d_model"] * m["d_ff"]


def layer_active_params(m: dict) -> int:
    """The parameters one token multiplies in one layer: attention, the
    router and its ``top_k`` experts (norms left out)."""
    return (attn_params(m) + m["d_model"] * m["num_experts"]
            + m["top_k"] * expert_params(m))


def visible_pairs(seq_len: int, window) -> int:
    """(query, key) pairs a causal sequence of ``seq_len`` attends to, with
    keys older than ``window`` positions masked."""
    w = seq_len if window is None else min(window, seq_len)
    # query i sees min(i + 1, w) keys
    full = w * (w + 1) // 2
    return full + (seq_len - w) * w


def prefill_flops(m: dict, rows: int, seq_len: int) -> int:
    """Model FLOPs of one prefill of ``rows`` prompts of ``seq_len``: 2 x
    active parameters a token, causal attention (4 x head_dim a visible
    pair and head), and the head at the last position alone (the only
    logits a prefill returns)."""
    tokens = rows * seq_len
    layers = m["n_layers"]
    dense = 2 * tokens * layers * layer_active_params(m)
    attn = 4 * m["head_dim"] * m["n_heads"] * layers * rows \
        * visible_pairs(seq_len, m.get("swa_window"))
    head = 2 * rows * m["d_model"] * m["vocab"]
    return dense + attn + head


def train_flops(m: dict, rows: int, seq_len: int) -> int:
    """Model FLOPs of one training step: 6 x active parameters a token (the
    head at every position), attention's forward and backward (3 x the
    forward's 4 x head_dim a pair and head); no recompute counted."""
    tokens = rows * seq_len
    layers = m["n_layers"]
    dense = 6 * tokens * (layers * layer_active_params(m)
                          + m["d_model"] * m["vocab"])
    attn = 12 * m["head_dim"] * m["n_heads"] * layers * rows \
        * visible_pairs(seq_len, m.get("swa_window"))
    return dense + attn


# -- kernels' useful work ------------------------------------------------------

def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def gmm_work(m: dict, tokens: int, backward: bool) -> Tuple[int, int]:
    """(FLOPs, bytes) of one layer's grouped SwiGLU over ``tokens`` tokens:
    ``tokens * top_k`` routed rows, 2·d·d_ff a row and product; the
    forward's three products, plus dX and dW of each under ``backward``.
    Bytes: each product's inputs read once and its output written once,
    the expert weights once a product (bf16)."""
    d, f, e = m["d_model"], m["d_ff"], m["num_experts"]
    rows = tokens * m["top_k"]
    per_product = 2 * rows * d * f
    # every product, gate [rows, d] x [E, d, f], up alike and down
    # [rows, f] x [E, f, d], touches one [rows, d], one [rows, f] and one
    # weight stack; so do its dX and its dW
    elems = rows * d + rows * f + e * d * f
    if not backward:
        return 3 * per_product, 3 * elems * BF16_BYTES
    return 9 * per_product, 9 * elems * BF16_BYTES


def exchange_bytes(m: dict, tokens: int) -> int:
    """Useful bytes of one exchange's pack and unpack: the routed rows
    (``tokens * top_k`` rows of d bf16), each kernel reading them once and
    writing them once."""
    return 2 * 2 * tokens * m["top_k"] * m["d_model"] * BF16_BYTES


def attn_work(m: dict, rows: int, seq_len: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one layer's prefill attention: 4·head_dim a
    visible pair and query head; q, k, v read once and o written once
    (bf16)."""
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    flops = 4 * dh * h * rows * visible_pairs(seq_len, m.get("swa_window"))
    nbytes = rows * seq_len * dh * (2 * h + 2 * kv) * BF16_BYTES
    return flops, nbytes


# -- time arithmetic -----------------------------------------------------------

def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps between the union's pieces, from the first start to the
    last end, as ``(start, end)``."""
    gaps, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def device_span(intervals: Sequence[Tuple[float, float]]):
    """From the first start to the last end; None without an interval."""
    if not intervals:
        return None
    span = max(b for _, b in intervals) - min(a for a, _ in intervals)
    return span if span > 0 else None


def idle_share(intervals: Sequence[Tuple[float, float]]):
    """One minus the union of the intervals over the span from the first
    start to the last end; None without an interval."""
    span = device_span(intervals)
    return None if span is None else 1.0 - union_s(intervals) / span


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 to 100) of every value, linear between
    the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def config_widths(config: dict) -> Dict[str, int]:
    """The model widths of a configuration file, head_dim resolved."""
    m = dict(config["model"])
    m.setdefault("head_dim", m["d_model"] // m["n_heads"])
    return m
