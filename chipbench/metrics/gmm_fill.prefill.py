"""The routed (token, expert) pairs the MoE layers kept over the rows
their grouped FFN ran over (the padded grid), over the traced window, in
percent: the port's ``moe.pairs_kept`` over ``moe.grid_rows`` counters,
with the pairs routed on standard error; nothing where the program has
no such counters."""

import sys


def read(record: dict):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    got = trace.snapshot()
    rows = got.get("moe.grid_rows")
    if not rows:
        return None
    kept = got.get("moe.pairs_kept", 0)
    print(f"moe pairs: {kept} kept of {got.get('moe.pairs_routed')} routed; "
          f"grid rows {rows}", file=sys.stderr, flush=True)
    return 100.0 * kept / rows
