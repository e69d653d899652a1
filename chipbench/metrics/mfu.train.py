"""Model FLOPs the traced window's training steps need (6 x active
parameters a token, attention forward and backward, no recompute) over
the device's span (its first operation to its last, from the trace) at
the bf16 peak, in percent."""

from chipbench import yardstick


def read(record: dict):
    work, m = record["work"], record["model"]
    span = yardstick.device_span([(a, b) for _, a, b, _ in
                                  record["device_ops"]])
    if not work.get("steps") or span is None:
        return None
    flops = work["steps"] * yardstick.train_flops(m, work["rows"],
                                                  work["seq_len"])
    return 100.0 * flops / (span * yardstick.PEAK_BF16_FLOPS)
