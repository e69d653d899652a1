"""Prefill attention's useful work in the traced window (4 x head_dim a
visible pair and head, or q, k, v read and o written once, whichever
bounds) over the device time of the port's flash_attention kernels, in
percent."""

from chipbench import harness, yardstick

KERNELS = ("flash_bf16_kernel", "flash_f32_kernel")


def read(record: dict):
    work, m = record["work"], record["model"]
    measured = harness.device_time(record, *KERNELS)
    if not work.get("batches") or measured <= 0:
        return None
    flops, nbytes = yardstick.attn_work(m, work["rows"], work["seq_len"])
    n = work["batches"] * m["n_layers"]
    return 100.0 * yardstick.bound_s(n * flops, n * nbytes) / measured
