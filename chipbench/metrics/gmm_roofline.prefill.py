"""The grouped FFN's useful work in the traced window's prefills (every
routed row once, three products, weights read once) at its roofline bound,
over the device time of the port's grouped_matmul kernels, in percent."""

from chipbench import harness, yardstick

KERNELS = ("gmm_tma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel")


def read(record: dict):
    work, m = record["work"], record["model"]
    measured = harness.device_time(record, *KERNELS)
    if not work.get("batches") or measured <= 0:
        return None
    flops, nbytes = yardstick.gmm_work(m, work["rows"] * work["seq_len"],
                                       backward=False)
    n = work["batches"] * m["n_layers"]
    return 100.0 * yardstick.bound_s(n * flops, n * nbytes) / measured
