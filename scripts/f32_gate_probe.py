"""Phase 15 (b)'s f32 parameter gate at 4 layers, read at one element.

``chip_smoke.py`` phase 15 (b) trains qwen3-0.6b with ``pure_dp`` and FSDP
on (1, 2, 2) against the stacked oracle, and gates every parameter after
the steps within 1e-5 of its tensor's largest (the elements at the
gradients' f32 noise floor within 0.1 x the rate).  At 4 layers the gate
read just over its limit in ``embed``.  This script runs that gate at 4
layers, unchanged, and reads its worst ``embed`` element three ways:

1. with FSDP (phase 15 (b)'s cell): the element's synced gradient on its
   process each step beside the stacked oracle's, and both updates;
2. without FSDP (phase 14 (c)'s cell, ``pure_dp`` alone): the same element
   on the processes;
3. in one process, step 0's gradient of the element from the whole batch,
   and from the batch's rows cut as the processes cut them and added in
   their member order: the two halves of the FSDP reduce-scatter over
   ``data``, the four quarters of the sync over ``("data", "model")``.

It prints one JSON line a part and exits 0 whether or not the gate passes
(the gate's verdict is among what it prints).  On the card, from the
repository's root:

    python3 scripts/f32_gate_probe.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

LAYERS = 4
LEAF = "embed"


def gate_config(fsdp):
    return cs.spf_config(cs.FSDP_ARCH, LAYERS, pure_dp=True, fsdp=fsdp,
                         compute_dtype="float32")


def run_gate(torch, kernels, fsdp, where):
    """The f32 gate of phase 15 (b) (``fsdp``) or of phase 14 (c) (not),
    at LAYERS layers, watching LEAF at ``where`` (None: each process's
    worst strict element).  Returns (verdict, the watched elements)."""
    label = f"probe[{'pure_dp+fsdp' if fsdp else 'pure_dp'} f32 {LAYERS}]"
    plant, name = ((cs.fsdp_bwd_unsummed, "fsdp_gather's backward "
                    "unsummed") if fsdp else
                   (cs.sync_skipping_model, "_sync_grads skipping 'model'"))
    outs = []
    try:
        cs.train_procs_f32_gate(
            torch, kernels, shape=cs.FSDP_MESH, label=label, plant=plant,
            fault_name=name, batch=cs.FSDP_TRAIN[0], noise_unit="dp",
            cfg=gate_config(fsdp), seq=cs.FSDP_TRAIN[1],
            watch=(LEAF, where), outs=outs)
        verdict = "passed"
    except AssertionError as e:
        verdict = f"failed: {e}"
    ranks = outs[0]["ranks"] if outs else []
    seen = [r["params"][LEAF].get("watch") for r in ranks]
    seen = [w for w in seen if w is not None]
    cs.free(torch)
    return verdict, seen


def split_sums(torch, kernels, where):
    """Step 0's gradient of LEAF at ``where`` in one process: the whole
    batch, and its rows cut as the processes cut them, added in member
    order."""
    from repro_torch.models import build_model

    cfg = gate_config(True)
    model = build_model(cfg, torch.device(cs.DEVICE), train=True)
    params = cs.stack_params(torch, cfg, train=True)
    leaf = dict(params.named_parameters())[LEAF]
    host = cs.train_batches(cfg, cs.FSDP_TRAIN[0], cs.FSDP_TRAIN[1], 1)[0]

    def grad(lo, hi):
        batch = {k: torch.as_tensor(v[lo:hi]).long().to(cs.DEVICE)
                 for k, v in host.items()}
        loss, _ = model.loss(params, batch, None, True)
        return torch.autograd.grad(loss, [leaf])[0]

    b = cs.FSDP_TRAIN[0]
    whole = grad(0, b)
    halves = [grad(i * b // 2, (i + 1) * b // 2) for i in range(2)]
    quarters = [grad(i * b // 4, (i + 1) * b // 4) for i in range(4)]
    two = (halves[0] + halves[1]) / 2
    four = (((quarters[0] + quarters[1]) + quarters[2]) + quarters[3]) / 4
    top = float(whole.abs().max())
    at = tuple(where)
    return {"index": list(where), "whole": float(whole[at]),
            "halves_summed": float(two[at]),
            "quarters_summed": float(four[at]),
            "halves": [float(h[at]) for h in halves],
            "quarters": [float(q[at]) for q in quarters],
            "leaf_largest": top,
            "halves_vs_whole_max_over_largest":
                float((two - whole).abs().max()) / top,
            "quarters_vs_whole_max_over_largest":
                float((four - whole).abs().max()) / top}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("f32_gate_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    kernels = cs.proc_kernels()
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"probe: {smi}; build {time.perf_counter() - t0:.1f} s")
    out = {}
    verdict, seen = run_gate(torch, kernels, True, None)
    out["fsdp"] = {"verdict": verdict, "watched": seen}
    cs.log("probe[fsdp]: " + json.dumps(out["fsdp"]))
    worst = max(seen, key=lambda w: abs(w["update"] - w["oracle_update"]))
    where = worst["index"]
    verdict, seen = run_gate(torch, kernels, False, where)
    out["pure_dp"] = {"verdict": verdict, "watched": seen}
    cs.log("probe[pure_dp]: " + json.dumps(out["pure_dp"]))
    out["one_process"] = split_sums(torch, kernels, where)
    cs.log("probe[one process]: " + json.dumps(out["one_process"]))
    from repro_torch.launch.procs import stop_fork_server

    stop_fork_server()
    cs.log(f"probe: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
