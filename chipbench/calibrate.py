"""Readings that the cells' limits are set from, on the card at each
cell's own size: for every seed, one process runs the cell (a short
window) and prints the program's numbers, the control's (the reference
computed in float8 e4m3 in the program's place) and, with ``--fault``,
the numbers of a run with that fault planted (``faults.py``).

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--fault half_batch] [--no-control] [--out FILE]

One JSON line a seed, on standard output and appended to ``--out``.
Not run by the benchmark's own runs.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from chipbench import faults, harness

    suite = harness.Suite()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        plant = faults.planted(args.fault) if args.fault \
            else contextlib.nullcontext()
        with plant:
            res = harness.run_cell(
                suite, args.workload, seed, args.seconds, False,
                args.device, t0, control=not args.no_control)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "correct": res["correct"],
                "checks": res["checks"], "metrics": res["metrics"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "readings": res.get("readings", {}),
                "seconds": time.perf_counter() - t0}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
