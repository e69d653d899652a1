"""The exchanges' useful bytes in the traced window's prefills (the routed
rows, read once and written once by the pack and by the unpack of each of
a layer's two exchanges) at HBM bandwidth, over the device time of the
port's block-copy kernels, in percent."""

from chipbench import harness, yardstick

KERNELS = ("block_copy_kernel", "bulk_copy_kernel")


def read(record: dict):
    work, m = record["work"], record["model"]
    measured = harness.device_time(record, *KERNELS)
    if not work.get("batches") or measured <= 0:
        return None
    n = work["batches"] * m["n_layers"] * 2
    nbytes = n * yardstick.exchange_bytes(m, work["rows"] * work["seq_len"])
    return 100.0 * yardstick.bound_s(0, nbytes) / measured
