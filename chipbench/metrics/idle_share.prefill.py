"""From the traced window's first device operation to its last, the share
of time in which none ran, in percent."""

from chipbench import yardstick


def read(record: dict):
    share = yardstick.idle_share([(a, b) for _, a, b, _ in
                                  record["device_ops"]])
    return None if share is None else 100.0 * share
