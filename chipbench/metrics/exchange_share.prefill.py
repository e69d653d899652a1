"""The share of the traced window's device time in operations launched
inside the port's ``moe.exchange`` spans (each trip between the MoE
layer's dispatch buffer and its expert grid: the exchange with the
grid's permutes and copies), in percent: a device operation belongs to a
span when the span holds its launch."""

SPANS = ("moe.exchange",)


def read(record: dict):
    spans = [s for name in SPANS for s in record["ranges"].get(name, [])]
    ops = record["device_ops"]
    if not spans or not ops:
        return None
    total = inside = 0.0
    for _, a, b, launch in ops:
        total += b - a
        if launch is not None and any(s <= launch <= e for s, e in spans):
            inside += b - a
    return 100.0 * inside / total if total > 0 else None
