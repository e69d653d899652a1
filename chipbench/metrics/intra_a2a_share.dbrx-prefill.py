"""The share of the traced window's device time in operations launched
inside the port's ``a2a.intra`` spans (the intra-pod all-to-all of each
of a layer's two exchanges), in percent."""

from chipbench import intra_a2a


def read(record: dict):
    total = sum(b - a for _, a, b, _ in record["device_ops"])
    if not record["ranges"].get(intra_a2a.SPAN) or total <= 0:
        return None
    return 100.0 * intra_a2a.span_device_s(record) / total
