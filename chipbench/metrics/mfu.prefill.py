"""Model FLOPs the traced window's prefill tokens need (2 x active
parameters a token, causal attention, the head at the last position) over
the device's span (its first operation to its last, from the trace) at
the bf16 peak, in percent."""

from chipbench import yardstick


def read(record: dict):
    work, m = record["work"], record["model"]
    span = yardstick.device_span([(a, b) for _, a, b, _ in
                                  record["device_ops"]])
    if not work.get("batches") or span is None:
        return None
    flops = work["batches"] * yardstick.prefill_flops(m, work["rows"],
                                                      work["seq_len"])
    return 100.0 * flops / (span * yardstick.PEAK_BF16_FLOPS)
