"""The share of the traced window's device time in operations launched
outside the port's ``train.forward_backward`` range (AdamW, the gradient
norm, the batch's copies), in percent."""

RANGE = "train.forward_backward"


def read(record: dict):
    spans = record["ranges"].get(RANGE)
    ops = record["device_ops"]
    if not spans or not ops:
        return None
    total = inside = 0.0
    for _, a, b, launch in ops:
        total += b - a
        if launch is not None and any(s <= launch <= e for s, e in spans):
            inside += b - a
    return 100.0 * (total - inside) / total if total > 0 else None
