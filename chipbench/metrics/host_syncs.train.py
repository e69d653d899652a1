"""Host-device synchronizations a step inside the port's ``train.step``
spans over the traced window (its ``host_syncs`` counter, counted under
``torch.cuda``'s sync debug mode), with their first call sites on
standard error; nothing where the program has no such counter."""

import sys


def read(record: dict):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    n = record["work"].get("steps")
    if not n:
        return None
    syncs = trace.snapshot().get("host_syncs", 0)
    print(f"host syncs: {syncs} in {n} steps; sites {trace.sync_sites()}",
          file=sys.stderr, flush=True)
    return syncs / n
