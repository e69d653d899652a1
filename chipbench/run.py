"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error.  Exits nonzero, printing no result,
without the CUDA devices the cell asks for, and where the process holds
JAX, Flax or the JAX package once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from chipbench import harness

    suite = harness.Suite()
    chips = int(suite.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = harness.power_limit()
    print(f"card: {card}; peaks {harness.yardstick.PEAK_BF16_FLOPS:.4g} "
          f"FLOP/s bf16, {harness.yardstick.PEAK_HBM_BYTES_PER_S:.4g} B/s",
          file=sys.stderr, flush=True)
    result = harness.run_cell(suite, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    result["device"]["card"] = card
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark runs without JAX "
              f"and the JAX package", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
