#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; none is caught):

1. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc;
2. kernels: run ``a2a_pack``, ``a2a_unpack`` and ``grouped_matmul`` at the
   serving path's prefill and decode shapes and at ragged ones, hold each
   against its plain PyTorch version (pack and unpack bit for bit;
   grouped_matmul within a relative error of 1e-5 in f32 and 2e-2 in bf16)
   and time each, its plain version and one PyTorch library call with CUDA
   events (median of 20);
   then a small f32 MoE layer on a (2, 2, 1) mesh against its one-rank path;
3. serve: megatron-moe-32e at its published widths (4 of 24 layers, random
   weights from a seed) on a local (pod 2, data 16, model 1) mesh, expert
   dispatch through the FAST plan: prefill of 32 prompts of 128 tokens, then
   15 decode steps (16 generated tokens per request), counting each kernel's
   launches;
4. the same serving run with ``a2a_impl="direct"``: prefill logits
   bit-identical to the plan run, greedy tokens equal;
5. the same prefill with the plain versions (``use_kernel=False``).  In
   bf16 the kernel and the plain product round differently, and from the
   second layer on a near-tie in a router's top-k can flip, moving that
   sequence's logits by O(1); the logit difference and every routing
   decision that differs are printed.  The gates: routing of the first
   layer (identical inputs) is equal; the first MoE layer on identical
   inputs agrees within 2e-2; and the same full-width prefill in f32 routes
   every token alike and agrees within a relative logit difference of 1e-4
   (the f32 serving tests' limit).

The last lines are the card's name and power limit, one JSON line of kernel
results, and ``{"ok": true, "device": {...}}``.  It exits non-zero, printing
no result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, no TF32
ARCH, N_LAYERS = "megatron-moe-32e", 4
MESH = (2, 16, 1)
BATCH, PROMPT, GEN = 32, 128, 16
SEED = 0
TIMED_RUNS = 20
DEVICE = "cuda"


def serve_config():
    """megatron-moe-32e at its published widths, depth cut to N_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(ARCH, n_layers=N_LAYERS)


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, runs=TIMED_RUNS, warmup=3) -> float:
    """Median device time of ``fn`` in ms over ``runs`` CUDA-event pairs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def rel_err(torch, y, ref) -> float:
    y, ref = y.float(), ref.float()
    return ((y - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def max_abs(torch, y, ref) -> float:
    return (y.float() - ref.float()).abs().max().item()


def check_pack(torch, k, x, idx, block_rows) -> float:
    """a2a_pack of ``x`` by ``idx`` against the plain version, bit for bit.
    Returns the measured max abs difference."""
    out = k.a2a_pack(x, idx, block_rows=block_rows)
    ref = k.a2a_pack_ref(x, idx, block_rows=block_rows)
    if not torch.equal(out, ref):
        raise AssertionError(f"a2a_pack != plain: {tuple(x.shape)} "
                             f"r={block_rows}")
    return max_abs(torch, out, ref)


def check_unpack(torch, k, y, idx, block_rows, n_out, trash=None) -> float:
    """a2a_unpack of ``y`` by ``idx`` against the plain version, bit for
    bit on the named blocks (``trash`` marks blocks written more than once,
    not compared).  The kernel also scatters into a buffer longer than its
    output, filled with a sentinel: unnamed blocks and every row after the
    output must still hold it.  Returns the measured max abs difference
    over the named blocks."""
    from repro_torch.kernels.a2a_pack.a2a_pack import _block_copy

    r, d, m = block_rows, y.shape[1], idx.shape[0]
    n_tot = max(m, n_out)
    out = k.a2a_unpack(y, idx, n_out_blocks=n_out, block_rows=r)
    ref = k.a2a_unpack_ref(y, idx, n_out_blocks=n_out, block_rows=r)
    ref = ref.reshape(n_tot, r, d)
    named = torch.unique(idx.long())
    if trash is not None:
        named = named[~trash[named]]
    got = out.reshape(n_tot, r, d)[named]
    if not torch.equal(got, ref[named]):
        raise AssertionError(f"a2a_unpack != plain: {tuple(y.shape)} r={r}")
    err = max_abs(torch, got, ref[named])
    extra = 3
    big = torch.full(((n_tot + extra) * r, d), 7, dtype=y.dtype,
                     device=y.device)
    _block_copy(y, big, idx, n_tot, r * d * y.element_size(), scatter=True)
    blocks = big.reshape(n_tot + extra, r, d)
    unnamed = torch.ones(n_tot + extra, dtype=torch.bool, device=y.device)
    unnamed[idx.long()] = False
    if not bool((blocks[unnamed] == 7).all()):
        raise AssertionError("a2a_unpack wrote outside its named blocks")
    if not torch.equal(blocks[named], ref[named]):
        raise AssertionError("a2a_unpack into a longer buffer != plain")
    return err


def phase_kernels(torch):
    """Kernels against their plain versions, then timings at the serving
    path's shapes.  Returns the kernel result rows."""
    from repro_torch.comm.plan_exec import _global_rows, lower_plan
    from repro_torch.kernels import a2a_pack as k
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul, grouped_matmul_ref)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan
    from repro_torch.models.moe import _capacity

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ragged shapes, every dtype the exchange may carry
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        for d in (5, 64, 130, 2048):
            for r in (1, 3, 8, 24):
                x = (torch.randn((6 * r, d), generator=gen, device=dev)
                     * 50).to(dt)
                idx = torch.randint(0, 6, (10,), generator=gen, device=dev,
                                    dtype=torch.int32)
                check_pack(torch, k, x, idx, r)
                perm = torch.randperm(9, generator=gen, device=dev)[:5]
                check_unpack(torch, k, x[: 5 * r], perm.to(torch.int32), r,
                             9)
    torch.cuda.synchronize()
    log("kernels: a2a_pack / a2a_unpack bit-exact on ragged shapes "
        "(f32, bf16, int8)")

    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for e, c, d, f in ((3, 37, 70, 45), (2, 100, 256, 513),
                           (4, 256, 1024, 512)):
            x = torch.randn((e, c, d), generator=gen, device=dev).to(dt)
            w = torch.randn((e, d, f), generator=gen, device=dev).to(dt)
            cnt = torch.randint(0, c + 1, (e,), generator=gen, device=dev,
                                dtype=torch.int32)
            for counts in (None, cnt):
                err = rel_err(torch, grouped_matmul(x, w, counts),
                              grouped_matmul_ref(x, w, counts))
                if not err < tol:
                    raise AssertionError(
                        f"grouped_matmul {dt} {(e, c, d, f)} counts="
                        f"{counts is not None}: rel err {err} >= {tol}")
    torch.cuda.synchronize()
    log("kernels: grouped_matmul within 1e-5 (f32) / 2e-2 (bf16) on ragged "
        "shapes, with and without counts")

    # the serving path's shapes
    cfg = serve_config()
    p, i = MESH[0], MESH[1]
    n_ranks = p * i
    e_loc = cfg.moe.num_experts // n_ranks
    d = cfg.d_model
    sched = lower_plan(flash_plan(p, i, SEED), n_pods=p)
    s = sched.n_stages
    pods = tuple(q for q in range(p) for _ in range(i))
    bf16 = torch.bfloat16
    rows = []

    island = make_mesh(MESH[:2], ("pod", "data"), dev)
    dst_idx = _global_rows(island, sched, pods, p, "dst_of", None, dev)
    src_idx = _global_rows(island, sched, pods, p + 1, "src_of", p, dev)
    n_out = n_ranks * (p + 1)
    trash = torch.zeros(max(n_out, src_idx.shape[0]), dtype=torch.bool,
                        device=dev)
    trash[torch.arange(n_ranks, device=dev) * (p + 1) + p] = True

    def exchange(cap, what):
        """Fresh send rows and received stages of one exchange at capacity
        ``cap``, each kernel checked against its plain version on them."""
        block = i * e_loc * cap
        x2 = torch.randn((n_ranks * p * block, d), generator=gen,
                         device=dev).to(bf16)
        stack2 = torch.randn((n_ranks * (s + 1) * block, d), generator=gen,
                             device=dev).to(bf16)
        errs = (check_pack(torch, k, x2, dst_idx, block),
                check_unpack(torch, k, stack2, src_idx, block, n_out, trash))
        torch.cuda.synchronize()
        log(f"kernels: pack/unpack bit-exact at the {what} exchange: "
            f"{n_ranks} ranks x {s + 1} slots x {block} rows x {d} bf16")
        return block, x2, stack2, errs

    def copy_times(x, idx, block, unpack):
        """(kernel, plain, library) ms of one pack or unpack."""
        n_blocks = idx.shape[0]
        il = idx.long()
        if unpack:
            out = torch.zeros((n_out * block, d), dtype=x.dtype, device=dev)
            xv, ov = x.view(n_blocks, block, d), out.view(n_out, block, d)
            return (cuda_ms(torch, lambda: k.a2a_unpack(
                        x, idx, n_out_blocks=n_out, block_rows=block)),
                    cuda_ms(torch, lambda: k.a2a_unpack_ref(
                        x, idx, n_out_blocks=n_out, block_rows=block)),
                    cuda_ms(torch, lambda: ov.index_copy_(0, il, xv)))
        xv = x.view(-1, block, d)
        return (cuda_ms(torch, lambda: k.a2a_pack(x, idx, block_rows=block)),
                cuda_ms(torch, lambda: k.a2a_pack_ref(
                    x, idx, block_rows=block)),
                cuda_ms(torch, lambda: torch.index_select(xv, 0, il)))

    cap = _capacity(cfg, BATCH // n_ranks * PROMPT, cfg.moe.num_experts)
    cap_dec = _capacity(cfg, BATCH // n_ranks, cfg.moe.num_experts)
    block, x2, stack2, errs = exchange(cap, "prefill")
    block_dec, x2_dec, stack2_dec, errs_dec = exchange(cap_dec, "decode")
    for j, (name, x, idx, unpack) in enumerate((
            ("a2a_pack", x2, dst_idx, False),
            ("a2a_unpack", stack2, src_idx, True))):
        n_blocks = idx.shape[0]
        ms, plain, lib = copy_times(x, idx, block, unpack)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/a2a_block_copy.cu",
                     "replaces": "src/repro/kernels/a2a_pack/a2a_pack.py:73",
                     "shape": f"{n_blocks} blocks x {block} x {d} bf16",
                     "max_abs_err": max(errs[j], errs_dec[j]),
                     "max_err": max(errs[j], errs_dec[j]), "ms": ms,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": 2 * n_blocks * block * d * x.element_size()
                     / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"})
    for name, x, idx, unpack in (("a2a_pack", x2_dec, dst_idx, False),
                                 ("a2a_unpack", stack2_dec, src_idx, True)):
        ms, plain, lib = copy_times(x, idx, block_dec, unpack)
        nbytes = 2 * idx.shape[0] * block_dec * d * x.element_size()
        log(f"timing: {name} decode shape {idx.shape[0]} blocks x "
            f"{block_dec} x {d} bf16: {ms:.4f} ms (plain {plain:.4f} ms, "
            f"library {lib:.4f} ms, bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    del x2, stack2, x2_dec, stack2_dec

    # grouped matmul at the island's products: prefill and decode, gate/up
    # [E, C, d] @ [E, d, f] and down [E, C, f] @ [E, f, d], counts=None
    f = cfg.d_ff
    w_up = (torch.randn((cfg.moe.num_experts, d, f), generator=gen,
                        device=dev) / d ** 0.5).to(bf16)
    w_dn = (torch.randn((cfg.moe.num_experts, f, d), generator=gen,
                        device=dev) / f ** 0.5).to(bf16)
    e = n_ranks * e_loc
    worst_rel = worst_abs = 0.0
    acts = {}
    for what, c in (("prefill", n_ranks * cap), ("decode", n_ranks * cap_dec)):
        tok = torch.randn((e, c, d), generator=gen, device=dev).to(bf16)
        h = torch.randn((e, c, f), generator=gen, device=dev).to(bf16)
        acts[what] = (tok, h)
        for x, w in ((tok, w_up), (h, w_dn)):
            y, ref = grouped_matmul(x, w), grouped_matmul_ref(x, w)
            err = rel_err(torch, y, ref)
            if not err < 2e-2:
                raise AssertionError(
                    f"grouped_matmul bf16 at the {what} shape "
                    f"{tuple(x.shape)} @ {tuple(w.shape)}: rel err {err}")
            worst_rel = max(worst_rel, err)
            worst_abs = max(worst_abs, max_abs(torch, y, ref))
            del y, ref
    log(f"kernels: grouped_matmul bf16 within 2e-2 at the prefill and decode "
        f"products (gate/up and down): worst rel err {worst_rel:.3e}")

    def gmm_bound(x, w):
        ee, c, dd = x.shape
        ff = w.shape[2]
        t_ops = 2 * ee * c * dd * ff / PEAK_OPS_PER_S["bfloat16"] * 1e3
        t_bytes = (x.numel() + w.numel() + ee * c * ff) * 2 \
            / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), \
            "operations" if t_ops >= t_bytes else "bytes"

    tok, _ = acts["prefill"]
    bound, by = gmm_bound(tok, w_up)
    rows.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul/grouped_matmul.py:76",
        "shape": f"[{e}, {tok.shape[1]}, {d}] @ [{e}, {d}, {f}] bf16",
        "max_abs_err": worst_abs, "max_err": worst_rel,
        "ms": cuda_ms(torch, lambda: grouped_matmul(tok, w_up)),
        "plain_ms": cuda_ms(torch, lambda: grouped_matmul_ref(tok, w_up)),
        "library_ms": cuda_ms(torch, lambda: torch.bmm(tok, w_up)),
        "bound_ms": bound, "bound_by": by})
    for what, (x, w) in (("prefill down", (acts["prefill"][1], w_dn)),
                         ("decode gate/up", (acts["decode"][0], w_up)),
                         ("decode down", (acts["decode"][1], w_dn))):
        bound, by = gmm_bound(x, w)
        log(f"timing: grouped_matmul {what} {tuple(x.shape)} @ "
            f"{tuple(w.shape)}: "
            f"{cuda_ms(torch, lambda: grouped_matmul(x, w)):.4f} ms (plain "
            f"{cuda_ms(torch, lambda: grouped_matmul_ref(x, w)):.4f} ms, bmm "
            f"{cuda_ms(torch, lambda: torch.bmm(x, w)):.4f} ms, bound "
            f"{bound:.4f} ms by {by})")
    for row in rows:
        log("timing:", json.dumps(row))
    return rows


def phase_small_reference(torch):
    """A small f32 MoE layer: the island on a (2, 2, 1) mesh with the plan
    against the one-rank path, with a capacity that drops no token."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.registry import MoESpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan, make_dist_context
    from repro_torch.models.moe import MoE, moe_apply

    cfg = dataclasses.replace(
        smoke_config(ARCH), compute_dtype="float32",
        moe=MoESpec(num_experts=4, top_k=2, capacity_factor=4.0))
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    moe = MoE(cfg, gen, torch.float32, dev)
    x = torch.randn((8, 16, cfg.d_model), generator=gen, device=dev) * 0.3
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), dev)
    dist = make_dist_context(cfg, mesh, "plan", flash_plan(2, 2, SEED))
    with torch.no_grad():
        y_loc, aux_loc = moe_apply(cfg, moe, x, None)
        y_mesh, _ = moe_apply(cfg, moe, x, dist)
    err = rel_err(torch, y_mesh, y_loc)
    if not (torch.isfinite(y_mesh).all() and err < 1e-4):
        raise AssertionError(f"f32 MoE island vs one-rank path: {err}")
    log(f"reference: f32 MoE island (plan, mesh 2x2x1) vs one-rank path "
        f"rel err {err:.3e}")


class RouteRecorder:
    """Records every MoE routing decision (the expert ids of each token's
    top-k) while active."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.eids = moe, moe._route, []

    def __enter__(self):
        def spy(*args):
            out = self.real(*args)
            self.eids.append(out[1].sort(dim=-1).values)
            return out
        self.moe._route = spy
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def route_flips(torch, rec_a, rec_b, n_layers):
    """Routing decisions of the timed prefills (the second ``n_layers``
    recorded) that differ between two recorders: (count, total, per
    layer)."""
    pairs = list(zip(rec_a.eids[n_layers:], rec_b.eids[n_layers:]))
    if len(pairs) != n_layers:
        raise AssertionError(f"recorded {len(pairs)} routings, expected "
                             f"{n_layers}")
    per_layer = [int((a != b).any(-1).sum()) for a, b in pairs]
    return sum(per_layer), sum(a.shape[0] * a.shape[1] for a, _ in pairs), \
        per_layer


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def serve(torch, cfg, params, mesh, impl, plan, prompts, kernels, *,
          use_kernel=True, decode=True):
    """Prefill (warm-up, then timed) and greedy decode through the serving
    step builders.  Returns logits, tokens, timings and launch counts."""
    from repro_torch.launch.serve import make_prefill_step, make_serve_step

    total = PROMPT + GEN
    prefill = make_prefill_step(cfg, mesh, impl, plan, cache_len=total,
                                use_kernel=use_kernel)
    step = make_serve_step(cfg, mesh, impl, plan, use_kernel=use_kernel)
    batch = {"tokens": prompts}
    prefill(params, batch)                                  # warm-up
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    res = {"logits": logits, "prefill_s": t_prefill,
           "prefill_launches": read_launches(kernels)}
    if not decode:
        return res
    toks = logits.argmax(-1)
    out = [toks]
    reset_launches(kernels)
    events = []
    t0 = time.perf_counter()
    for t in range(PROMPT, total - 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lg, cache = step(params, cache, toks, t)
        toks = lg.argmax(-1)
        b.record()
        events.append((a, b))
        out.append(toks)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in events]
    res.update(tokens=torch.stack(out, dim=1), decode_s=t_decode,
               decode_steps=GEN - 1, decode_launches=read_launches(kernels),
               last_logits=lg, step_ms_median=statistics.median(step_ms),
               step_ms_max=max(step_ms))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import _build
    from repro_torch.comm.plan_exec import lower_plan
    from repro_torch.kernels.a2a_pack import a2a_pack, a2a_unpack
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan
    from repro_torch.models import build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")

    # 2. kernels against their plain versions; a small reference
    rows = phase_kernels(torch)
    phase_small_reference(torch)

    # 3. serve megatron-moe-32e through the plan
    kernels = {"a2a_pack": a2a_pack, "a2a_unpack": a2a_unpack,
               "grouped_matmul": grouped_matmul}
    cfg = serve_config()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH, ("pod", "data", "model"), dev)
    plan = flash_plan(MESH[0], MESH[1], SEED)
    sched = lower_plan(plan, n_pods=MESH[0])
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)).to(dev)
    log(f"serve: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} experts="
        f"{cfg.moe.num_experts} top{cfg.moe.top_k} layers={cfg.n_layers}/24 "
        f"mesh={MESH} batch={BATCH} prompt={PROMPT} gen={GEN}; plan "
        f"{sched.algorithm} n_plan_stages={sched.n_plan_stages} "
        f"n_fallback_stages={sched.n_fallback_stages}; params "
        f"{sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9:.2f} GB")

    run = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels)
    n_tok = BATCH * GEN
    tok_s = n_tok / (run["prefill_s"] + run["decode_s"])
    for name, n in run["prefill_launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in the prefill")
    for name, n in run["decode_launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in decode")
    for t in (run["logits"], run["last_logits"]):
        if tuple(t.shape) != (BATCH, cfg.vocab) or \
                not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"bad logits {tuple(t.shape)}")
    log(f"serve[plan]: prefill {run['prefill_s'] * 1e3:.3f} ms; decode "
        f"{run['decode_s'] / run['decode_steps'] * 1e3:.3f} ms/step over "
        f"{run['decode_steps']} steps (median {run['step_ms_median']:.3f} "
        f"ms, max {run['step_ms_max']:.3f} ms on the device clock); "
        f"{tok_s:.1f} tokens/s "
        f"({n_tok} tokens); launches prefill {run['prefill_launches']}, "
        f"decode {run['decode_launches']}")
    log(f"serve[plan]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 4. the same with direct: the exchange is pure data movement
    direct = serve(torch, cfg, params, mesh, "direct", None, prompts,
                   kernels)
    if not torch.equal(direct["logits"], run["logits"]):
        raise AssertionError("direct prefill logits differ from plan's")
    if not torch.equal(direct["tokens"], run["tokens"]):
        raise AssertionError("direct greedy tokens differ from plan's")
    log(f"serve[direct]: prefill logits bit-identical to plan, greedy "
        f"tokens equal; prefill {direct['prefill_s'] * 1e3:.3f} ms; decode "
        f"{direct['decode_s'] / direct['decode_steps'] * 1e3:.3f} ms/step "
        f"(median {direct['step_ms_median']:.3f} ms on the device clock)")
    again = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels)
    log(f"serve[plan, again]: prefill {again['prefill_s'] * 1e3:.3f} ms; "
        f"decode {again['decode_s'] / again['decode_steps'] * 1e3:.3f} "
        f"ms/step (median {again['step_ms_median']:.3f} ms)")

    # 5. the same prefill with the plain versions.  In bf16 the kernel and
    # the plain product round differently, and from the second layer on a
    # near-tie in a router's top-k can flip, sending a token to another
    # expert and moving its sequence's logits by O(1): the logit difference
    # is reported with every routing decision that differs, and the gates
    # are (b) the first MoE layer on identical inputs, where routing cannot
    # differ, and (c) the same prefill in f32, where the kernel's sums
    # match the plain product's closely enough that no route flips.
    with RouteRecorder() as rk:
        kern = serve(torch, cfg, params, mesh, "plan", plan, prompts,
                     kernels, decode=False)
    with RouteRecorder() as rp:
        plain = serve(torch, cfg, params, mesh, "plan", plan, prompts,
                      kernels, use_kernel=False, decode=False)
    if any(plain["prefill_launches"].values()):
        raise AssertionError("use_kernel=False launched a kernel")
    if not torch.equal(kern["logits"], run["logits"]):
        raise AssertionError("kernel prefill is not deterministic")
    n_flip, n_dec, flipped = route_flips(torch, rk, rp, cfg.n_layers)
    log(f"serve[plain]: prefill {plain['prefill_s'] * 1e3:.3f} ms; max rel "
        f"logit diff kernels vs plain {rel_err(torch, run['logits'], plain['logits']):.3e}; "
        f"routing differs in {n_flip} of {n_dec} (token, layer) decisions "
        f"(per layer {flipped}), first layer {flipped[0]}")
    if flipped[0]:
        raise AssertionError("routing differs in the first layer, whose "
                             "inputs are identical")

    from repro_torch.launch.serve import make_dist_context
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import _embed_tokens

    blk = params.blocks[0]
    with torch.no_grad():
        h = norm_apply(cfg, blk.norm2, _embed_tokens(cfg, params, prompts,
                                                     None))
        ys = [moe_apply(cfg, blk.moe, h, make_dist_context(
            cfg, mesh, "plan", plan, use_kernel=uk))[0] for uk in (1, 0)]
    layer_err = rel_err(torch, ys[0], ys[1])
    log(f"serve[plain]: first MoE layer, identical bf16 inputs, kernels vs "
        f"plain: max rel diff {layer_err:.3e}")
    if not layer_err < 2e-2:
        raise AssertionError(f"MoE layer kernels vs plain: {layer_err}")
    del ys, h

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = build_model(cfg32, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    with RouteRecorder() as rk:
        k32 = serve(torch, cfg32, params32, mesh, "plan", plan, prompts,
                    kernels, decode=False)
    with RouteRecorder() as rp:
        p32 = serve(torch, cfg32, params32, mesh, "plan", plan, prompts,
                    kernels, use_kernel=False, decode=False)
    n_flip32, _, _ = route_flips(torch, rk, rp, cfg.n_layers)
    diff32 = rel_err(torch, k32["logits"], p32["logits"])
    log(f"serve[f32]: prefill kernels {k32['prefill_s'] * 1e3:.3f} ms, plain "
        f"{p32['prefill_s'] * 1e3:.3f} ms; max rel logit diff {diff32:.3e}; "
        f"routing differs in {n_flip32} decisions")
    if n_flip32 or not diff32 < 1e-4:
        raise AssertionError(f"f32 kernel vs plain prefill: logits {diff32}, "
                             f"{n_flip32} routing decisions differ")
    del params32, k32, p32

    launches = {name: run["prefill_launches"][name]
                + run["decode_launches"][name] for name in kernels}
    result = []
    for row in rows:
        row = dict(row, launches=launches[row["name"]],
                   launches_prefill=run["prefill_launches"][row["name"]],
                   launches_decode=run["decode_launches"][row["name"]])
        result.append(row)
    log(smi)
    log(json.dumps({"kernels": result}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
