"""The intra-pod exchanges' useful bytes in the traced window's prefills
(the routed rows read once and written once, two exchanges a layer) at
HBM bandwidth, over the device time launched inside the port's
``a2a.intra`` spans, in percent."""

from chipbench import intra_a2a, yardstick


def read(record: dict):
    nbytes = intra_a2a.window_bytes(record)
    measured = intra_a2a.span_device_s(record)
    if nbytes is None or measured <= 0:
        return None
    return 100.0 * yardstick.bound_s(0, nbytes) / measured
