"""Work and time of the intra-pod all-to-all (``a2a.intra`` spans of the
port's ``comm/all_to_all.py``), for the per-layer metrics of a cell whose
experts lie over the fast axis alone."""

from __future__ import annotations

from chipbench import yardstick

SPAN = "a2a.intra"


def exchange_bytes(m: dict, tokens: int) -> int:
    """Useful bytes of one exchange: the routed rows (``tokens * top_k``
    rows of d bf16) read once and written once."""
    return 2 * tokens * m["top_k"] * m["d_model"] * yardstick.BF16_BYTES


def window_bytes(record: dict):
    """Useful bytes of the traced window's exchanges, two a layer and
    batch; None without a batch."""
    work, m = record["work"], record["model"]
    if not work.get("batches"):
        return None
    return work["batches"] * m["n_layers"] * 2 * exchange_bytes(
        m, work["rows"] * work["seq_len"])


def span_device_s(record: dict) -> float:
    """Device time of the operations launched inside ``a2a.intra``
    spans."""
    spans = record["ranges"].get(SPAN, [])
    return sum(b - a for _, a, b, launch in record["device_ops"]
               if launch is not None
               and any(s <= launch <= e for s, e in spans))
