#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; none is caught):

1. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc, all
   at once;
2. kernels: run ``a2a_pack``, ``a2a_unpack``, ``grouped_matmul`` and
   ``flash_attention`` at the serving paths' prefill and decode shapes and at
   ragged ones, hold each against its plain PyTorch version (pack and unpack
   bit for bit, on every instance, bulk, vec and bytes, in f32, bf16 and
   int8, with a sentinel in the blocks unpack must not write;
   grouped_matmul within a relative error of 1e-5 in f32 and 2e-2 in bf16,
   on both of its bf16 instances, TMA + wgmma and WMMA; flash_attention
   within an absolute error of 2e-5 in f32 and 2e-2 in bf16, the
   reference's kernel tolerances, on contiguous tensors and on
   ``[B, S, H, D]`` views) and time each, its plain version and one PyTorch
   library call by device time (``cuda_ms``: CUDA events around runs of
   back-to-back launches, median of 20 runs), pack and unpack also one call
   per event pair (``call_ms``: host and device) and on each 16-byte
   instance; print the kernel to library ratios and each kernel's
   registers, shared memory and spills from ``ptxas -v``; then a small f32
   MoE layer on a (2, 2, 1) mesh against its one-rank path;
3. megatron-moe-32e at its published widths (4 of 24 layers, random weights
   from a seed) on a local (pod 2, data 16, model 1) mesh, expert dispatch
   through the FAST plan: prefill of 32 prompts of 128 tokens, then 15
   decode steps, counting each kernel's launches; the same with ``direct``
   and a prefill with the config's ``flash`` (logits bit-identical to the
   plan's); then the plain versions (``use_kernel=False``): routing
   decisions that differ are counted, and the gates are the first attention
   layer and the first MoE layer on identical bf16 inputs (within 2e-2,
   routing equal) and the prefill in f32 (within a relative logit
   difference of 1e-4, no routing decision that differs);
4. mixtral-8x7b at its published widths (4 of 32 layers) on the same mesh,
   its 8 experts over ``pod`` alone: (a) 32 prompts of 1024 tokens and 15
   decode steps through ``plan``, then through the config's ``flash`` (the
   rotation schedule), bit-identical; (b) int8 dispatch through ``plan``,
   its first MoE layer within (0, 0.05) of exact on identical inputs, the
   prefill's logits and routing differences reported; (c) one prompt of
   8192 tokens through the 4096-token window and 15 decode steps on the
   4096-slot ring cache; the gates of phase 3 at mixtral's shapes; and a
   ``torch.profiler`` window over one (a) prefill and three decode steps:
   device time by kernel name and the device's idle share.

5. backward kernels: ``flash_attention``'s ``lse`` against the plain
   forward's, ``flash_attention_bwd`` against ``flash_attention_bwd_ref``
   (within 1e-5 in f32 and 2e-2 in bf16 of the largest reference gradient
   of the case) on ragged shapes, at the training shape (q [32, 32, 512,
   64], 8 kv heads, causal) and at mixtral's windowed shape (q [1, 32, 8192,
   128], window 4096), timed beside its plain version and SDPA's backward;
   grouped_matmul's backward products (dX and dW of the gate/up and down
   products, an operand read transposed in place) against the plain
   version and timed beside ``bmm`` at the training shapes, and beside the
   same product on contiguous copies of the transposes and those copies;
6. training megatron-moe-32e at its published widths (2 of 24 layers, f32
   masters, bf16 compute, remat) on the same mesh, EP over (pod, data)
   through the island and the config's ``flash`` exchange: 32 x 512 tokens
   a step, 4 AdamW steps with the kernels, each step's launches gated (per
   layer: 2 attention forwards under remat, 1 backward, 6 grouped_matmul
   forwards and 6 backward products, all on TMA; no pack or unpack), then
   the same 4 steps with ``use_kernel=False`` (step losses within 2e-2);
   the first attention and MoE layer's bf16 gradients on identical inputs
   within 2e-2 of plain, routing equal; one layer's forward run twice,
   bit-identical (remat recomputes it); an f32 run (1 layer, 32 x 128
   tokens) whose every gradient is within a relative norm of 1e-4 of the
   plain version's; the ``Trainer`` at smoke size with a checkpoint and a
   resume (within a relative 1e-6 of an unbroken run: the embedding's
   backward sums with atomics); and a ``torch.profiler`` window over one
   step.

Every bf16 serving run must launch grouped_matmul on its TMA + wgmma
instance alone (``grouped_matmul.launches_by_variant``), and pack and unpack
on the instance ``a2a_pack.variant`` picks for the exchange's size: bulk for
mixtral's prefill exchanges, vec for the rest, never bytes.  The profiler
window also gives the median device time of a pack and an unpack launch in
the prefill and in decode.

The last lines are the card's name and power limit, one JSON line of kernel
results, and ``{"ok": true, "device": {...}}``.  Each kernel's ``launches``
there is its count in the newest main path that runs it: the training run
(4 steps) for grouped_matmul, flash_attention and flash_attention_bwd,
mixtral's plan run for pack and unpack; ``launches_by_path`` lists every
path's counts.  It exits non-zero, printing
no result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import gc
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
MIX_ARCH, MIX_LAYERS = "mixtral-8x7b", 4
MESH = (2, 16, 1)
BATCH, PROMPT, GEN = 32, 128, 16
MIX_PROMPT, LONG_PROMPT, F32_PROMPT = 1024, 8192, 128
SEED = 0
TIMED_RUNS = 20
RUN_MS, MAX_REPS = 2.0, 100    # cuda_ms: device time a timed run should fill
SLEEP_CYCLES_PER_MS = 2.0e6    # torch.cuda._sleep cycles a ms at <= 2 GHz
DEVICE = "cuda"
SERVE_KERNELS = ("a2a_pack", "a2a_unpack", "grouped_matmul",
                 "flash_attention")
KERNELS = SERVE_KERNELS + ("flash_attention_bwd",)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 32, 512, 4
F32_TRAIN_SEQ = 128
# the serving shapes' flash_attention device ms before the forward kernel
# could write lse (PERF.md, section 6), for the check that serving, which
# asks for none, kept its time
FLASH_MS_BEFORE_LSE = {"megatron-moe-32e prefill": 0.0491,
                 "mixtral-8x7b prefill": 1.6262,
                 "mixtral-8x7b long prefill": 1.9873}
# block sizes of the bulk-against-vec sweep, 64 blocks each: 8 KiB to 1280
# MiB moved, the serving exchanges' range
SWEEP_BLOCK_BYTES = (128, 64 << 10, 256 << 10, 512 << 10, 2 << 20, 8 << 20,
                     20 << 20)


def serve_config():
    """megatron-moe-32e at its published widths, depth cut to N_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(ARCH, n_layers=N_LAYERS)


def train_config(**over):
    """megatron-moe-32e at its published widths, depth cut to
    TRAIN_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(ARCH, **{"n_layers": TRAIN_LAYERS, **over})


def mixtral_config(**over):
    """mixtral-8x7b at its published widths, depth cut to MIX_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(MIX_ARCH, n_layers=MIX_LAYERS, **over)


def log(*a):
    print(*a, flush=True)


def call_ms(torch, fn, runs=TIMED_RUNS, warmup=3) -> float:
    """Median time in ms of one call of ``fn`` between a CUDA-event pair,
    over ``runs`` pairs.  Where the host's work for a call outlasts the
    kernel, the device idles between the events while the host works, so
    this is host plus device: what one call costs a caller that waits."""
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


def cuda_ms(torch, fn, runs=TIMED_RUNS, warmup=3) -> float:
    """Device time in ms of one call of ``fn``: the median over ``runs``
    CUDA-event pairs, each around a run of back-to-back calls (as many as
    fill about RUN_MS of device time, at most MAX_REPS), divided by the
    run's length.  A sleep kernel ahead of each pair holds the device while
    the host enqueues the run, so the host's time between calls does not
    enter.  The L2 is not flushed: the serving caller writes a kernel's
    input just before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()                                  # the host's enqueue time of a call
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    one = call_ms(torch, fn, runs=1, warmup=0)
    reps = max(1, min(MAX_REPS, int(RUN_MS / max(one, 1e-3))))
    hold = min(2 * reps * host_ms + 0.1, 50.0) if reps > 1 else 0.0
    pairs = []
    for _ in range(runs):
        if hold:
            torch.cuda._sleep(int(hold * SLEEP_CYCLES_PER_MS))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / reps for a, b in pairs)


def rel_err(torch, y, ref) -> float:
    y, ref = y.float(), ref.float()
    return ((y - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def max_abs(torch, y, ref) -> float:
    return (y.float() - ref.float()).abs().max().item()


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def kernel_names(path):
    """The ``__global__`` function names defined in a CUDA source."""
    import re

    return re.findall(
        r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        path.read_text())


def template_args(rest):
    """The template arguments of a mangled kernel name, given what follows
    the kernel's own name: ints, ``f32`` and ``bf16``."""
    import re

    out = []
    a = rest[1:rest.find("EE") + 1] if rest.startswith("I") else ""
    while a:
        num = re.match(r"Li(\d+)E", a)
        if num:
            out.append(num.group(1))
            a = a[num.end():]
        elif a.startswith("13__nv_bfloat16"):
            out.append("bf16")
            a = a[len("13__nv_bfloat16"):]
        elif a.startswith("f"):
            out.append("f32")
            a = a[1:]
        else:
            break
    return out


def ptxas_lines(_build):
    """One line per kernel of every source: registers, shared memory,
    spills, from the ``ptxas -v`` report of its build."""
    import re

    lines = []
    for path in sorted(_build.CSRC.glob("*.cu")):
        src = path.stem
        kernels = kernel_names(path)
        name = None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:  # the source's name of the mangled kernel, its template
                # arguments (dtype, width, layout bits)
                name = max((k for k in kernels if k in m.group(1)), key=len,
                           default=m.group(1))
                targs = template_args(m.group(1).split(name, 1)[-1])
                name += f"<{', '.join(targs)}>" if targs else ""
                spill = ""
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                lines.append(f"ptxas: {src}.cu {name}: "
                             f"{line.split(':', 1)[1].strip()}; {spill}")
                name = None
    return lines


def a2a_instance(moved_bytes):
    """The instance a serving exchange of aligned blocks should take: bulk
    from ``BULK_MIN_BYTES`` moved, vec below (``a2a_pack.variant``)."""
    from repro_torch.kernels.a2a_pack import BULK_MIN_BYTES

    return "bulk" if moved_bytes >= BULK_MIN_BYTES else "vec"


def forced_copy(torch, x, idx, block_rows, n_out, name, scatter):
    """Pack (or, with ``scatter``, unpack into ``n_out`` blocks) through
    instance ``name`` itself, bypassing the wrapper's rule and counts."""
    from repro_torch.kernels.a2a_pack.a2a_pack import _block_copy

    r, d = block_rows, x.shape[1]
    rows = max(idx.shape[0], n_out) if scatter else idx.shape[0]
    out = torch.empty((rows * r, d), dtype=x.dtype, device=x.device)
    _block_copy(x, out, idx, n_out if scatter else x.shape[0] // r,
                r * d * x.element_size(), scatter, name)
    return out


def check_pack(torch, k, x, idx, block_rows, name=None) -> float:
    """a2a_pack of ``x`` by ``idx`` against the plain version, bit for bit:
    through the wrapper (the rule's instance) or, with ``name``, through
    that instance itself.  Returns the measured max abs difference."""
    out = (k.a2a_pack(x, idx, block_rows=block_rows) if name is None else
           forced_copy(torch, x, idx, block_rows, 0, name, False))
    ref = k.a2a_pack_ref(x, idx, block_rows=block_rows)
    if not torch.equal(out, ref):
        raise AssertionError(f"a2a_pack ({name or 'rule'}) != plain: "
                             f"{tuple(x.shape)} r={block_rows}")
    return max_abs(torch, out, ref)


def check_unpack(torch, k, y, idx, block_rows, n_out, trash=None,
                 name=None) -> float:
    """a2a_unpack of ``y`` by ``idx`` against the plain version, bit for
    bit on the named blocks (``trash`` marks blocks written more than once,
    not compared), through the wrapper or, with ``name``, that instance
    itself.  The kernel also scatters into a buffer longer than its output,
    filled with a sentinel: unnamed blocks and every row after the output
    must still hold it.  Returns the measured max abs difference over the
    named blocks."""
    from repro_torch.kernels.a2a_pack.a2a_pack import _block_copy

    r, d, m = block_rows, y.shape[1], idx.shape[0]
    n_tot = max(m, n_out)
    out = (k.a2a_unpack(y, idx, n_out_blocks=n_out, block_rows=r)
           if name is None else
           forced_copy(torch, y, idx, r, n_out, name, True))
    ref = k.a2a_unpack_ref(y, idx, n_out_blocks=n_out, block_rows=r)
    ref = ref.reshape(n_tot, r, d)
    named = torch.unique(idx.long())
    if trash is not None:
        named = named[~trash[named]]
    got = out.reshape(n_tot, r, d)[named]
    if not torch.equal(got, ref[named]):
        raise AssertionError(f"a2a_unpack ({name or 'rule'}) != plain: "
                             f"{tuple(y.shape)} r={r}")
    err = max_abs(torch, got, ref[named])
    del out, got
    extra = 3
    big = torch.full(((n_tot + extra) * r, d), 7, dtype=y.dtype,
                     device=y.device)
    _block_copy(y, big, idx, n_tot, r * d * y.element_size(), True, name)
    blocks = big.reshape(n_tot + extra, r, d)
    unnamed = torch.ones(n_tot + extra, dtype=torch.bool, device=y.device)
    unnamed[idx.long()] = False
    if not bool((blocks[unnamed] == 7).all()):
        raise AssertionError("a2a_unpack wrote outside its named blocks")
    if not torch.equal(blocks[named], ref[named]):
        raise AssertionError("a2a_unpack into a longer buffer != plain")
    return err


def gmm_bound(x, w):
    """(bound ms, what bounds it) of ``x [E, C, D] @ w [E, D, F]`` in bf16."""
    ee, c, dd = x.shape
    ff = w.shape[2]
    t_ops = 2 * ee * c * dd * ff / PEAK_OPS_PER_S["bfloat16"] * 1e3
    t_bytes = (x.numel() + w.numel() + ee * c * ff) * 2 \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def band_pairs(s, causal, window) -> int:
    """Visible (query, key) pairs of one head of S tokens."""
    q = np.arange(s, dtype=np.int64)
    hi = q if causal else np.full(s, s - 1, np.int64)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attn_bound(b, h, kv, s, d, causal, window, dtype_name, elem):
    """(bound ms, what bounds it) of one flash_attention call: 4 * D
    operations per visible pair and head; q, k, v read and o written once."""
    t_ops = 4 * b * h * d * band_pairs(s, causal, window) \
        / PEAK_OPS_PER_S[dtype_name] * 1e3
    t_bytes = (2 * b * h + 2 * b * kv) * s * d * elem / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def exchange_rows(torch, mesh_shape, plan):
    """Global pack / unpack index rows of the plan exchange on
    ``mesh_shape`` (``plan_all_to_all``'s), and the unpack side's trash
    blocks."""
    from repro_torch.comm.plan_exec import _global_rows, lower_plan
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(DEVICE)
    p, i = mesh_shape[0], mesh_shape[1]
    n_ranks = p * i
    sched = lower_plan(plan, n_pods=p)
    pods = tuple(q for q in range(p) for _ in range(i))
    island = make_mesh(mesh_shape[:2], ("pod", "data"), dev)
    dst_idx = _global_rows(island, sched, pods, p, "dst_of", None, dev)
    src_idx = _global_rows(island, sched, pods, p + 1, "src_of", p, dev)
    n_out = n_ranks * (p + 1)
    trash = torch.zeros(max(n_out, src_idx.shape[0]), dtype=torch.bool,
                        device=dev)
    trash[torch.arange(n_ranks, device=dev) * (p + 1) + p] = True
    return sched, dst_idx, src_idx, n_out, trash


def copy_times(torch, k, x, idx, block, d, n_out, unpack):
    """Times of one pack or unpack: the kernel's, its plain version's and
    the library call's device ms (``cuda_ms``), and the kernel's and the
    library call's ms with one call per event pair (``call_ms``); and the
    two 16-byte instances' device ms, each launched itself."""
    dev = x.device
    n_blocks = idx.shape[0]
    il = idx.long()
    if unpack:
        out = torch.zeros((n_out * block, d), dtype=x.dtype, device=dev)
        xv, ov = x.view(n_blocks, block, d), out.view(n_out, block, d)
        fns = (lambda: k.a2a_unpack(x, idx, n_out_blocks=n_out,
                                    block_rows=block),
               lambda: k.a2a_unpack_ref(x, idx, n_out_blocks=n_out,
                                        block_rows=block),
               lambda: ov.index_copy_(0, il, xv))
    else:
        xv = x.view(-1, block, d)
        fns = (lambda: k.a2a_pack(x, idx, block_rows=block),
               lambda: k.a2a_pack_ref(x, idx, block_rows=block),
               lambda: torch.index_select(xv, 0, il))
    kernel, plain, lib = fns
    return {"ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain),
            "library_ms": cuda_ms(torch, lib),
            "call_ms": call_ms(torch, kernel),
            "library_call_ms": call_ms(torch, lib),
            **{f"{name}_ms": cuda_ms(torch, lambda: forced_copy(
                torch, x, idx, block, n_out, name, unpack))
               for name in ("bulk", "vec")}}


def phase_kernels(torch):
    """a2a_pack, a2a_unpack and grouped_matmul against their plain versions
    on ragged shapes, then at megatron's and mixtral's exchange and expert
    products, with timings.  Returns the kernel result rows by name; each
    row's ``shapes`` lists every serving shape timed."""
    from repro_torch.kernels import a2a_pack as k
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul, grouped_matmul_ref)
    from repro_torch.launch.serve import flash_plan
    from repro_torch.models.moe import _capacity

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ragged shapes, every dtype the exchange may carry, each on contiguous
    # tensors and on views one element off 16-byte alignment, through the
    # wrappers (the rule: vec or bytes at these sizes) and, where the block
    # allows it, through bulk itself; every dtype must reach every instance
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        before = {kn: dict(getattr(k, kn).launches_by_variant)
                  for kn in ("a2a_pack", "a2a_unpack")}
        n_bulk = 0
        for d in (1, 5, 64, 130, 2048, 2056):
            for r in (1, 3, 8, 24):
                flat = (torch.randn((6 * r * d + 1,), generator=gen,
                                    device=dev) * 50).to(dt)
                aligned = r * d * flat.element_size() % 16 == 0
                for x, names in ((flat[: 6 * r * d].view(6 * r, d),
                                  (None, "bulk") if aligned else (None,)),
                                 (flat[1:].view(6 * r, d), (None,))):
                    for name in names:
                        idx = torch.randint(0, 6, (10,), generator=gen,
                                            device=dev, dtype=torch.int32)
                        check_pack(torch, k, x, idx, r, name)
                        perm = torch.randperm(9, generator=gen,
                                              device=dev)[:5]
                        check_unpack(torch, k, x[: 5 * r],
                                     perm.to(torch.int32), r, 9, name=name)
                        n_bulk += name == "bulk"
        torch.cuda.synchronize()
        hits = {kn: {v: n - before[kn][v] for v, n in
                     getattr(k, kn).launches_by_variant.items()}
                for kn in before}
        for kn, hit in hits.items():
            if not (hit["vec"] and hit["bytes"] and n_bulk):
                raise AssertionError(f"{kn}'s ragged {dt} checks missed an "
                                     f"instance: {hit}, bulk {n_bulk}")
        log(f"kernels: a2a_pack / a2a_unpack bit-exact on ragged {dt} shapes "
            f"(aligned and not); launches by instance {hits}, and {n_bulk} "
            f"shapes each through bulk")

    by_variant = dict(grouped_matmul.launches_by_variant)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for e, c, d, f in ((3, 37, 70, 45), (2, 100, 256, 513),
                           (4, 256, 1024, 512), (3, 37, 72, 200),
                           (2, 300, 136, 264)):
            x = torch.randn((e, c, d), generator=gen, device=dev).to(dt)
            w = torch.randn((e, d, f), generator=gen, device=dev).to(dt)
            cnt = torch.randint(0, c + 1, (e,), generator=gen, device=dev,
                                dtype=torch.int32)
            # the backward's forms too: x stored as x^T, w stored as w^T
            xt, wt = x.transpose(1, 2).contiguous(), \
                w.transpose(1, 2).contiguous()
            for counts in (None, cnt):
                ref = grouped_matmul_ref(x, w, counts)
                for kind, got in (
                        ("", lambda: grouped_matmul(x, w, counts)),
                        ("x^T ", lambda: grouped_matmul(
                            xt, w, counts, transpose_x=True)),
                        ("w^T ", lambda: grouped_matmul(
                            x, wt, counts, transpose_w=True)),
                        ("x^T w^T ", lambda: grouped_matmul(
                            xt, wt, counts, transpose_x=True,
                            transpose_w=True))):
                    err = rel_err(torch, got(), ref)
                    if not err < tol:
                        raise AssertionError(
                            f"grouped_matmul {kind}{dt} {(e, c, d, f)} "
                            f"counts={counts is not None}: rel err {err} >= "
                            f"{tol}")
    torch.cuda.synchronize()
    ragged = {k: n - by_variant[k]
              for k, n in grouped_matmul.launches_by_variant.items()}
    if not (ragged["wmma"] and ragged["tma"] and ragged["simt"]):
        raise AssertionError(f"grouped_matmul's ragged checks missed an "
                             f"instance: {ragged}")
    log(f"kernels: grouped_matmul within 1e-5 (f32) / 2e-2 (bf16) on ragged "
        f"shapes, with and without counts, x and w stored as given or "
        f"transposed; launches by instance {ragged}")

    bf16 = torch.bfloat16
    p, i = MESH[0], MESH[1]
    n_ranks = p * i
    plan = flash_plan(p, i, SEED)
    rows = {
        "a2a_pack": {"name": "a2a_pack", "route": "cuda",
                     "source": "src/repro_torch/csrc/a2a_block_copy.cu",
                     "replaces": "src/repro/kernels/a2a_pack/a2a_pack.py:73",
                     "max_abs_err": 0.0, "shapes": []},
        "a2a_unpack": {"name": "a2a_unpack", "route": "cuda",
                       "source": "src/repro_torch/csrc/a2a_block_copy.cu",
                       "replaces":
                       "src/repro/kernels/a2a_pack/a2a_pack.py:73",
                       "max_abs_err": 0.0, "shapes": []},
        "grouped_matmul": {
            "name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces":
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:76",
            "max_abs_err": 0.0, "max_err": 0.0, "shapes": []},
    }

    # The exchanges: megatron's EP over (pod, data) (one slot per stage of
    # i * E_loc * C rows), mixtral's over pod alone (E_loc * C rows a slot),
    # each at the prefill and the decode capacity.  Mixtral's int8 dispatch
    # exchanges int8 rows and f32 scale rows of width 1 as well.
    sched, dst_idx, src_idx, n_out, trash = exchange_rows(torch, MESH, plan)
    s = sched.n_stages
    for arch, cfg, fast in ((ARCH, serve_config(), True),
                            (MIX_ARCH, mixtral_config(), False)):
        e = cfg.moe.num_experts
        e_loc = e // (n_ranks if fast else p)
        prompt = PROMPT if arch == ARCH else MIX_PROMPT
        dtypes = ((bf16, cfg.d_model),) if fast else (
            (bf16, cfg.d_model), (torch.int8, cfg.d_model),
            (torch.float32, 1))
        for what, t in (("prefill", BATCH // n_ranks * prompt),
                        ("decode", BATCH // n_ranks)):
            cap = _capacity(cfg, t, e)
            block = (i if fast else 1) * e_loc * cap
            for dt, d in dtypes:
                x2 = (torch.randn((n_ranks * p * block, d), generator=gen,
                                  device=dev) * 50).to(dt)
                stack2 = (torch.randn((n_ranks * (s + 1) * block, d),
                                      generator=gen, device=dev) * 50).to(dt)
                bb = block * d * x2.element_size()
                want = {"a2a_pack": a2a_instance(dst_idx.shape[0] * bb),
                        "a2a_unpack": a2a_instance(src_idx.shape[0] * bb)}
                n_want = {kn: getattr(k, kn).launches_by_variant[v]
                          for kn, v in want.items()}
                errs = (check_pack(torch, k, x2, dst_idx, block),
                        check_unpack(torch, k, stack2, src_idx, block, n_out,
                                     trash))
                if any(getattr(k, kn).launches_by_variant[v] != n_want[kn] + 1
                       for kn, v in want.items()):
                    raise AssertionError(f"pack/unpack at the {arch} {what} "
                                         f"{dt} exchange did not take "
                                         f"{want}")
                for name in ("bulk", "vec"):  # each 16-byte instance itself
                    errs += (check_pack(torch, k, x2, dst_idx, block, name),
                             check_unpack(torch, k, stack2, src_idx, block,
                                          n_out, trash, name))
                for kname, err in zip(("a2a_pack", "a2a_unpack") * 3, errs):
                    rows[kname]["max_abs_err"] = max(
                        rows[kname]["max_abs_err"], err)
                torch.cuda.synchronize()
                name = str(dt).replace("torch.", "")
                log(f"kernels: pack/unpack bit-exact at the {arch} {what} "
                    f"exchange: {n_ranks} ranks x {s + 1} slots x {block} "
                    f"rows x {d} {name}, on {want} by the rule and on bulk "
                    f"and vec themselves")
                if dt is bf16:
                    for kname, x, idx, unpack in (
                            ("a2a_pack", x2, dst_idx, False),
                            ("a2a_unpack", stack2, src_idx, True)):
                        nbytes = idx.shape[0] * block * d * x.element_size()
                        entry = {
                            "path": f"{arch} {what}",
                            "shape": f"{idx.shape[0]} blocks x {block} x "
                                     f"{d} bf16",
                            **copy_times(torch, k, x, idx, block, d, n_out,
                                         unpack),
                            "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
                            "bound_by": "bytes", "instance": want[kname]}
                        entry["ratio_to_library"] = (entry["ms"]
                                                     / entry["library_ms"])
                        entry["ratio_to_bound"] = (entry["ms"]
                                                   / entry["bound_ms"])
                        rows[kname]["shapes"].append(entry)
                        log("timing:", kname, json.dumps(entry))
                del x2, stack2
    free(torch)

    # bulk against vec by bytes moved: a pack of 64 int8 blocks in a random
    # order, each instance launched itself; BULK_MIN_BYTES rests on this
    sweep = []
    for blk in SWEEP_BLOCK_BYTES:
        x = torch.randint(-100, 100, (64, blk), generator=gen, device=dev,
                          dtype=torch.int8)
        idx = torch.randperm(64, generator=gen, device=dev).to(torch.int32)
        t = {name: cuda_ms(torch, lambda: forced_copy(
                 torch, x, idx, 1, 0, name, False))
             for name in ("bulk", "vec")}
        sweep.append({"moved_bytes": 64 * blk, "bulk_ms": t["bulk"],
                      "vec_ms": t["vec"], "rule": a2a_instance(64 * blk)})
        log(f"sweep: pack of 64 blocks x {blk} B ({64 * blk / 2**20:.3f} "
            f"MiB): bulk {t['bulk']:.4f} ms, vec {t['vec']:.4f} ms, "
            f"bulk/vec {t['bulk'] / t['vec']:.3f}; the rule picks "
            f"{sweep[-1]['rule']}")
        del x
    rows["a2a_pack"]["sweep"] = sweep
    free(torch)

    # grouped matmul at the expert products: gate/up [E, C, d] @ [E, d, f]
    # and down [E, C, f] @ [E, f, d], prefill and decode, counts=None (the
    # island's and the split island's groups hold many ranks' chunks)
    for arch, cfg in ((ARCH, serve_config()), (MIX_ARCH, mixtral_config())):
        e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
        prompt = PROMPT if arch == ARCH else MIX_PROMPT
        w_up = (torch.randn((e, d, f), generator=gen, device=dev)
                / d ** 0.5).to(bf16)
        w_dn = (torch.randn((e, f, d), generator=gen, device=dev)
                / f ** 0.5).to(bf16)
        for what, t in (("prefill", BATCH // n_ranks * prompt),
                        ("decode", BATCH // n_ranks)):
            # a group holds one expert's C rows from every rank
            c = n_ranks * _capacity(cfg, t, e)
            for kind, (x, w) in (
                    ("gate/up", (torch.randn((e, c, d), generator=gen,
                                             device=dev).to(bf16), w_up)),
                    ("down", (torch.randn((e, c, f), generator=gen,
                                          device=dev).to(bf16), w_dn))):
                n_tma = grouped_matmul.launches_by_variant["tma"]
                y, ref = grouped_matmul(x, w), grouped_matmul_ref(x, w)
                if grouped_matmul.launches_by_variant["tma"] != n_tma + 1:
                    raise AssertionError(
                        f"grouped_matmul at the {arch} {what} {kind} shape "
                        f"did not take the TMA + wgmma instance")
                err = rel_err(torch, y, ref)
                if not err < 2e-2:
                    raise AssertionError(
                        f"grouped_matmul bf16 at the {arch} {what} {kind} "
                        f"shape {tuple(x.shape)} @ {tuple(w.shape)}: rel err "
                        f"{err}")
                row = rows["grouped_matmul"]
                row["max_err"] = max(row["max_err"], err)
                row["max_abs_err"] = max(row["max_abs_err"],
                                         max_abs(torch, y, ref))
                del y, ref
                bound, by = gmm_bound(x, w)
                entry = {
                    "path": f"{arch} {what} {kind}",
                    "shape": f"{list(x.shape)} @ {list(w.shape)} bf16",
                    "ms": cuda_ms(torch, lambda: grouped_matmul(x, w)),
                    "plain_ms": cuda_ms(
                        torch, lambda: grouped_matmul_ref(x, w),
                        runs=TIMED_RUNS if arch == ARCH else 5, warmup=1),
                    "library_ms": cuda_ms(torch, lambda: torch.bmm(x, w)),
                    "bound_ms": bound, "bound_by": by, "instance": "tma"}
                entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
                entry["ratio_to_bound"] = entry["ms"] / bound
                row["shapes"].append(entry)
                log("timing: grouped_matmul", json.dumps(entry))
                del x
                free(torch)
        log(f"kernels: grouped_matmul bf16 within 2e-2 at the {arch} "
            f"prefill and decode products (gate/up and down)")
        del w_up, w_dn
        free(torch)
    log(f"kernels: grouped_matmul worst rel err "
        f"{rows['grouped_matmul']['max_err']:.3e}")
    return rows


def phase_flash_attention(torch):
    """flash_attention against its plain version on ragged shapes and at
    the serving paths' prefill shapes (f32 within 2e-5, bf16 within 2e-2,
    absolute), each on contiguous ``[B, H, S, D]`` tensors and on
    ``[B, S, H, D]`` memory seen as ``[B, H, S, D]`` (what attention_apply
    passes), then timings in bf16 beside the plain version and
    ``scaled_dot_product_attention``.  Returns the kernel's result row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

    def inputs(b, h, kv, s, d, dt, views=False):
        """q, k, v as [B, H, S, D]; with ``views``, [B, S, H, D] memory
        seen as [B, H, S, D], as attention_apply hands them over."""
        if views:
            return [torch.randn((b, s, n, d), generator=gen,
                                device=dev).to(dt).transpose(1, 2)
                    for n in (h, kv, kv)]
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]

    def check(b, h, kv, s, d, causal, window, dt, views=False) -> float:
        q, k, v = inputs(b, h, kv, s, d, dt, views)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = max_abs(torch, out, ref)
        if not (err <= tols[dt] and bool(torch.isfinite(out.float()).all())):
            raise AssertionError(
                f"flash_attention {dt} b{b} h{h} k{kv} s{s} d{d} causal="
                f"{causal} window={window} views={views}: max abs err {err} "
                f"> {tols[dt]}")
        return err

    worst = {dt: 0.0 for dt in tols}
    n = 0
    for dt in tols:
        for s in (1, 37, 130, 1000):
            for d in (8, 12, 16, 24, 40, 64, 128):
                for group in (1, 4):
                    for causal in (True, False):
                        for window in (None, 5, 100):
                            for views in (False, True):
                                worst[dt] = max(worst[dt], check(
                                    1, 2 * group, 2, s, d, causal, window,
                                    dt, views))
                                n += 1
    torch.cuda.synchronize()
    log(f"kernels: flash_attention within 2e-5 (f32) / 2e-2 (bf16) on {n} "
        f"ragged cases (S 1 to 1000, head dims 8 to 128, groups 1 and 4, "
        f"causal and not, windows none, 5, 100, contiguous and [B, S, H, D] "
        f"views): worst {worst[torch.float32]:.3e} / "
        f"{worst[torch.bfloat16]:.3e}")

    meg, mix = serve_config(), mixtral_config()
    shapes = [(f"{arch} {what}", batch, cfg.n_heads, cfg.n_kv_heads, s,
               cfg.resolved_head_dim, cfg.swa_window)
              for arch, cfg, what, batch, s in (
                  (ARCH, meg, "prefill", BATCH, PROMPT),
                  (MIX_ARCH, mix, "prefill", BATCH, MIX_PROMPT),
                  (MIX_ARCH, mix, "long prefill", 1, LONG_PROMPT))]
    entries = []
    for path, b, h, kv, s, d, w in shapes:
        for dt, views in ((torch.float32, False), (torch.bfloat16, False),
                          (torch.bfloat16, True)):
            err = check(b, h, kv, s, d, True, w, dt, views)
            worst[dt] = max(worst[dt], err)
            log(f"kernels: flash_attention at the {path} shape "
                f"[{b}, {h}, {s}, {d}] kv {kv} window {w} {dt}"
                f"{' on [B, S, H, D] views' if views else ''}: max abs err "
                f"{err:.3e}")
            free(torch)
        q, k, v = inputs(b, h, kv, s, d, torch.bfloat16)
        if w is not None and w < s:
            qi = torch.arange(s, device=dev)
            band = (qi[None, :] <= qi[:, None]) & (qi[None, :] > qi[:, None]
                                                   - w)
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True))
            del band
        else:
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        bound, by = attn_bound(b, h, kv, s, d, True, w, "bfloat16", 2)
        entry = {
            "path": path, "shape": f"q [{b}, {h}, {s}, {d}], kv heads {kv}, "
                                   f"causal, window {w}, bf16",
            "ms": cuda_ms(torch, lambda: flash_attention(
                q, k, v, causal=True, window=w)),
            "plain_ms": cuda_ms(torch, lambda: attention_ref(
                q, k, v, causal=True, window=w), runs=5, warmup=1),
            "library_ms": lib, "bound_ms": bound, "bound_by": by}
        entry["ratio_to_library"] = entry["ms"] / lib
        entry["ratio_to_bound"] = entry["ms"] / bound
        qv, kv_, vv = inputs(b, h, kv, s, d, torch.bfloat16, views=True)
        entry["ms_on_views"] = cuda_ms(torch, lambda: flash_attention(
            qv, kv_, vv, causal=True, window=w))
        del qv, kv_, vv
        entries.append(entry)
        log("timing: flash_attention", json.dumps(entry))
        if s == LONG_PROMPT:
            full = cuda_ms(torch, lambda: flash_attention(q, k, v,
                                                          causal=True))
            log(f"timing: flash_attention {path} without the window "
                f"(causal only): {full:.4f} ms against {entry['ms']:.4f} ms "
                f"with it; visible pairs {band_pairs(s, True, None)} against "
                f"{band_pairs(s, True, w)} (tiles outside the window are "
                f"skipped)")
        del q, k, v
        free(torch)
    main = entries[1]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces":
            "src/repro/kernels/flash_attention/flash_attention.py:122",
            "shape": main["shape"],
            "max_abs_err": max(worst.values()),
            "max_abs_err_f32": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "shapes": entries}


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
    top-k, ``[G, T, k]`` sorted) while active."""

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


def route_flips(torch, routes_a, routes_b, batch):
    """Routing decisions of two prefills that differ: (count, total, per
    layer, per sequence [B] bool).  Tokens are rank-major, which is
    sequence-major, so flat token ``j`` belongs to sequence ``j // S``."""
    if len(routes_a) != len(routes_b):
        raise AssertionError(f"recorded {len(routes_a)} and "
                             f"{len(routes_b)} routings")
    per_layer, per_seq = [], None
    for a, b in zip(routes_a, routes_b):
        tok = (a != b).any(-1).reshape(batch, -1)
        per_layer.append(int(tok.sum()))
        seq = tok.any(-1)
        per_seq = seq if per_seq is None else per_seq | seq
    total = sum(a.shape[0] * a.shape[1] for a in routes_a)
    return sum(per_layer), total, per_layer, per_seq


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def read_variants(kernels):
    """Launches by instance since the last reset, of each kernel that
    counts them (pack, unpack, grouped_matmul)."""
    return {name: dict(fn.launches_by_variant)
            for name, fn in kernels.items()
            if hasattr(fn, "launches_by_variant")}


def run_counts(run):
    """A run's launch counts by kernel and by instance."""
    return {"prefill": run["prefill_launches"],
            "decode": run["decode_launches"],
            "prefill_variants": run["prefill_variants"],
            "decode_variants": run["decode_variants"]}


# The pack and unpack instances of the serving runs, by part of the run:
# mixtral's prefill exchanges move 1280 MiB (bf16) and 640 MiB (int8 rows)
# and take bulk, its f32 scale rows and every decode exchange and all of
# megatron's vec.
MEGATRON_A2A = {"prefill": {"vec"}, "decode": {"vec"}}
MIXTRAL_A2A = {"prefill": {"bulk"}, "decode": {"vec"}}
MIXTRAL_INT8_A2A = {"prefill": {"bulk", "vec"}}


def check_variants(run, label, want="tma", a2a=None):
    """Every grouped_matmul launch of the run's prefill (and decode) went
    through instance ``want``; no pack or unpack launch through ``bytes``,
    and with ``a2a`` ({part: instances}) every one through those instances,
    each of them taken."""
    for part in ("prefill", "decode"):
        if f"{part}_variants" not in run:
            continue
        by_kernel, totals = run[f"{part}_variants"], run[f"{part}_launches"]
        by, total = by_kernel["grouped_matmul"], totals["grouped_matmul"]
        if not (total > 0 and by[want] == total):
            raise AssertionError(f"{label}: grouped_matmul's {part} launches "
                                 f"by instance {by}; expected all {total} "
                                 f"on {want!r}")
        allowed = (a2a or {}).get(part)
        for name in ("a2a_pack", "a2a_unpack"):
            by, total = by_kernel[name], totals[name]
            ok = by["bytes"] == 0 and (allowed is None or (
                total > 0 and sum(by[v] for v in allowed) == total
                and all(by[v] for v in allowed)))
            if not ok:
                raise AssertionError(
                    f"{label}: {name}'s {part} launches by instance {by}; "
                    f"expected {sorted(allowed) if allowed else 'none'} "
                    f"{'' if allowed else 'on bytes'}")


def serve(torch, cfg, params, mesh, impl, plan, prompts, kernels, *,
          use_kernel=True, decode=True, warmup=True, record=False):
    """Prefill (a warm-up, then timed) and greedy decode of GEN tokens
    through the serving step builders.  Returns logits, tokens, timings,
    launch counts (counts set to 0 just before the timed prefill and before
    decode) and, with ``record``, the timed prefill's routing decisions."""
    from repro_torch.launch.serve import make_prefill_step, make_serve_step

    prompt = prompts.shape[1]
    total = prompt + GEN
    prefill = make_prefill_step(cfg, mesh, impl, plan, cache_len=total,
                                use_kernel=use_kernel)
    step = make_serve_step(cfg, mesh, impl, plan, use_kernel=use_kernel)
    batch = {"tokens": prompts}
    if warmup:
        prefill(params, batch)
    torch.cuda.synchronize()
    reset_launches(kernels)
    rec = RouteRecorder()
    t0 = time.perf_counter()
    if record:
        with rec:
            logits, cache = prefill(params, batch)
    else:
        logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    res = {"logits": logits, "prefill_s": t_prefill, "routes": rec.eids,
           "prefill_launches": read_launches(kernels),
           "prefill_variants": read_variants(kernels),
           "cache_slots": cache[0]["k"].shape[1]}
    if not decode:
        return res
    toks = logits.argmax(-1)
    out = [toks]
    reset_launches(kernels)
    events = []
    t0 = time.perf_counter()
    for t in range(prompt, total - 1):
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
               decode_variants=read_variants(kernels),
               last_logits=lg, step_ms_median=statistics.median(step_ms),
               step_ms_max=max(step_ms))
    return res


def check_run(torch, run, cfg, batch, label, required, a2a=None):
    """Shape and finiteness of a run's logits; every kernel of ``required``
    launched in its prefill and decode, grouped_matmul on its TMA + wgmma
    instance alone, pack and unpack as ``check_variants`` asks,
    ``flash_attention`` once per layer per prefill and never in decode."""
    for t in (run["logits"], run["last_logits"]):
        if tuple(t.shape) != (batch, cfg.vocab) or \
                not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"{label}: bad logits {tuple(t.shape)}")
    pre, dec = run["prefill_launches"], run["decode_launches"]
    for name in required:
        if pre[name] <= 0:
            raise AssertionError(f"{label}: {name} never launched in the "
                                 f"prefill")
        if name != "flash_attention" and dec[name] <= 0:
            raise AssertionError(f"{label}: {name} never launched in decode")
    check_variants(run, label, a2a=a2a)
    if pre["flash_attention"] != cfg.n_layers or dec["flash_attention"]:
        raise AssertionError(
            f"{label}: flash_attention launched {pre['flash_attention']} "
            f"times in the prefill and {dec['flash_attention']} in decode; "
            f"expected {cfg.n_layers} and 0")


def log_run(run, label, batch):
    n_tok = batch * GEN
    tok_s = n_tok / (run["prefill_s"] + run["decode_s"])
    log(f"{label}: prefill {run['prefill_s'] * 1e3:.3f} ms; decode "
        f"{run['decode_s'] / run['decode_steps'] * 1e3:.3f} ms/step over "
        f"{run['decode_steps']} steps (median {run['step_ms_median']:.3f} "
        f"ms, max {run['step_ms_max']:.3f} ms on the device clock); "
        f"{tok_s:.1f} tokens/s ({n_tok} tokens); launches prefill "
        f"{run['prefill_launches']}, decode {run['decode_launches']}; "
        f"by instance: prefill {run['prefill_variants']}, decode "
        f"{run['decode_variants']}")


def plain_gates(torch, cfg, params, mesh, plan, prompts, run, kernels,
                label):
    """The plain versions against the kernels.  The full bf16 prefill is
    reported, not gated: the two round differently, so routers' near-ties
    flip from the first layer on (attention feeds it).  Gated: the first
    attention layer and the first MoE layer on identical bf16 inputs
    (within 2e-2, the MoE layer's routing equal)."""
    from repro_torch.launch.serve import make_dist_context
    from repro_torch.models.layers import attention_apply, norm_apply
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import _embed_tokens, _window_args

    plain = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels,
                  use_kernel=False, decode=False, warmup=False, record=True)
    if any(plain["prefill_launches"].values()):
        raise AssertionError(f"{label}: use_kernel=False launched a kernel: "
                             f"{plain['prefill_launches']}")
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, run["routes"], plain["routes"], prompts.shape[0])
    log(f"{label}[plain]: prefill {plain['prefill_s'] * 1e3:.3f} ms (no "
        f"warm-up); max rel logit diff kernels vs plain "
        f"{rel_err(torch, run['logits'], plain['logits']):.3e}; routing "
        f"differs in {n_flip} of {n_dec} (token, layer) decisions (per layer "
        f"{per_layer}), in {int(per_seq.sum())} of {prompts.shape[0]} "
        f"sequences")
    del plain

    blk = params.blocks[0]
    b, s = prompts.shape
    with torch.no_grad():
        x0 = _embed_tokens(cfg, params, prompts, None)
        h = norm_apply(cfg, blk.norm1, x0)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x0.device).expand(b, s)
        window, use_window = _window_args(cfg, False)
        outs = [attention_apply(cfg, blk.attn, h, positions=positions,
                                window=window, use_window=use_window,
                                use_kernel=uk) for uk in (True, False)]
        attn_err = rel_err(torch, outs[0], outs[1])
        del outs, h
        h2 = norm_apply(cfg, blk.norm2, x0)
        dist = make_dist_context(cfg, mesh, "plan", plan)
        with RouteRecorder() as rec:
            ys = [moe_apply(cfg, blk.moe, h2, dist, use_kernel=uk)[0]
                  for uk in (True, False)]
    moe_err = rel_err(torch, ys[0], ys[1])
    same = torch.equal(rec.eids[0], rec.eids[1])
    log(f"{label}[plain]: first layer on identical bf16 inputs, kernels vs "
        f"plain: attention (window {window}) max rel diff {attn_err:.3e}; "
        f"MoE max rel diff {moe_err:.3e}, routing equal {same}")
    if not (attn_err < 2e-2 and moe_err < 2e-2 and same):
        raise AssertionError(f"{label}: first layer kernels vs plain: "
                             f"attention {attn_err}, MoE {moe_err}, routing "
                             f"equal {same}")
    del ys, h2, x0


def f32_gate(torch, cfg, mesh, plan, prompts, kernels, label):
    """The same prefill in f32 with fresh f32 weights from the seed: kernels
    against plain within a relative logit difference of 1e-4 (the f32
    serving tests' limit), no routing decision that differs."""
    from repro_torch.models import build_model

    dev = torch.device(DEVICE)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = build_model(cfg32, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    k32 = serve(torch, cfg32, params32, mesh, "plan", plan, prompts, kernels,
                decode=False, record=True)
    p32 = serve(torch, cfg32, params32, mesh, "plan", plan, prompts, kernels,
                use_kernel=False, decode=False, warmup=False, record=True)
    check_variants(k32, f"{label}[f32]", want="simt")
    n_flip, n_dec, per_layer, _ = route_flips(torch, k32["routes"],
                                              p32["routes"], prompts.shape[0])
    diff32 = rel_err(torch, k32["logits"], p32["logits"])
    log(f"{label}[f32]: prompt {prompts.shape[1]}: prefill kernels "
        f"{k32['prefill_s'] * 1e3:.3f} ms, plain {p32['prefill_s'] * 1e3:.3f} "
        f"ms (no warm-up); max rel logit diff {diff32:.3e}; routing differs in "
        f"{n_flip} of {n_dec} decisions (per layer {per_layer})")
    if n_flip or not diff32 < 1e-4:
        raise AssertionError(f"{label}: f32 kernel vs plain prefill: logits "
                             f"{diff32}, {n_flip} routing decisions differ")
    del params32, k32, p32
    free(torch)


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def copy_durations(label, events, n_prefill):
    """Median device duration of the pack and unpack launches of a traced
    window, prefill and decode apart: ``events`` are the block-copy
    kernel's device events in start order, the first ``n_prefill`` of them
    the prefill's; each exchange launches pack, then unpack."""
    for part, evs in (("prefill", events[:n_prefill]),
                      ("decode", events[n_prefill:])):
        for kname, sub in (("a2a_pack", evs[0::2]), ("a2a_unpack", evs[1::2])):
            us = [e.time_range.elapsed_us() for e in sub]
            med = (f"{statistics.median(us) / 1e3:.4f} ms" if us
                   else "not measured")
            log(f"{label}: {kname} {part}: median device duration {med} "
                f"over {len(sub)} launches")


def device_time(prof, label, host_ms):
    """Log a trace's device time by kernel name (top 10) and the device's
    idle share over the window from the first device event's start to the
    last one's end.  Returns (device events, summary), the summary None and
    "not measured" logged where the trace holds no device event."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"{label}: device time by kernel: not measured (the trace holds "
            f"no device event); idle share: not measured; host window "
            f"{host_ms:.3f} ms")
        return dev, None
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = busy_us(spans)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    total = sum(t for _, t in by_name.values())
    log(f"{label}: host window {host_ms:.3f} ms; device window "
        f"{window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / window:.4f}; {len(dev)} device events, "
        f"{total / 1e3:.3f} ms summed")
    for name, (n, t) in top:
        log(f"{label}: {t / 1e3:10.3f} ms {100 * t / total:6.2f}% {n:5d}x "
            f"{name[:110]}")
    return dev, {"idle_share": 1 - busy / window, "window_ms": window / 1e3,
                 "top": [(name, n, t / 1e3) for name, (n, t) in top]}


def profile_window(torch, cfg, params, mesh, plan, prompts, kernels,
                   steps=3):
    """One plan prefill and ``steps`` decode steps under torch.profiler:
    device time by kernel name (top 10), the device's idle share over the
    window from the first device event's start to the last one's end, and
    the median device duration of pack and unpack launches in the prefill
    and in decode.  Prints "not measured" where the trace holds no device
    event."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _build
    from repro_torch.launch.serve import make_prefill_step, make_serve_step

    prompt = prompts.shape[1]
    prefill = make_prefill_step(cfg, mesh, "plan", plan,
                                cache_len=prompt + GEN)
    step = make_serve_step(cfg, mesh, "plan", plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n0 = kernels["a2a_pack"].launches + kernels["a2a_unpack"].launches
        logits, cache = prefill(params, {"tokens": prompts})
        n_prefill = (kernels["a2a_pack"].launches
                     + kernels["a2a_unpack"].launches - n0)
        toks = logits.argmax(-1)
        for t in range(prompt, prompt + steps):
            lg, cache = step(params, cache, toks, t)
            toks = lg.argmax(-1)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    label = f"profile[mixtral plan, prefill + {steps} decode steps]"
    dev, summary = device_time(prof, label, host_ms)
    if summary is None:
        return None
    names = kernel_names(_build.CSRC / "a2a_block_copy.cu")
    copies = sorted((e for e in dev if any(k in e.name for k in names)),
                    key=lambda e: e.time_range.start)
    copy_durations(label, copies, n_prefill)
    return summary


def phase_megatron(torch, kernels):
    """megatron-moe-32e through the plan, direct and flash, then the gates
    against the plain versions.  Returns the plan run's launch counts."""
    from repro_torch.comm.plan_exec import lower_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan
    from repro_torch.models import build_model

    cfg = serve_config()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH, ("pod", "data", "model"), dev)
    plan = flash_plan(MESH[0], MESH[1], SEED)
    sched = lower_plan(plan, n_pods=MESH[0])
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)).to(dev)
    log(f"serve: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} experts="
        f"{cfg.moe.num_experts} top{cfg.moe.top_k} layers={cfg.n_layers}/24 "
        f"mesh={MESH} batch={BATCH} prompt={PROMPT} gen={GEN}; plan "
        f"{sched.algorithm} n_plan_stages={sched.n_plan_stages} "
        f"n_fallback_stages={sched.n_fallback_stages}; params "
        f"{sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9:.2f} GB")

    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels,
                record=True)
    check_run(torch, run, cfg, BATCH, "serve[plan]", SERVE_KERNELS,
              MEGATRON_A2A)
    log_run(run, "serve[plan]", BATCH)
    log(f"serve[plan]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the exchange is pure data movement: direct and flash are bit-identical
    direct = serve(torch, cfg, params, mesh, "direct", None, prompts,
                   kernels)
    check_variants(direct, "serve[direct]")
    if not torch.equal(direct["logits"], run["logits"]):
        raise AssertionError("direct prefill logits differ from plan's")
    if not torch.equal(direct["tokens"], run["tokens"]):
        raise AssertionError("direct greedy tokens differ from plan's")
    log(f"serve[direct]: prefill logits bit-identical to plan, greedy "
        f"tokens equal; prefill {direct['prefill_s'] * 1e3:.3f} ms; decode "
        f"{direct['decode_s'] / direct['decode_steps'] * 1e3:.3f} ms/step "
        f"(median {direct['step_ms_median']:.3f} ms on the device clock)")
    del direct
    flash = serve(torch, cfg, params, mesh, "flash", None, prompts, kernels,
                  decode=False)
    check_variants(flash, "serve[flash]")
    if not torch.equal(flash["logits"], run["logits"]):
        raise AssertionError("flash prefill logits differ from plan's")
    log(f"serve[flash]: prefill logits bit-identical to plan; prefill "
        f"{flash['prefill_s'] * 1e3:.3f} ms")
    again = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels)
    check_variants(again, "serve[plan, again]", a2a=MEGATRON_A2A)
    log(f"serve[plan, again]: prefill {again['prefill_s'] * 1e3:.3f} ms; "
        f"decode {again['decode_s'] / again['decode_steps'] * 1e3:.3f} "
        f"ms/step (median {again['step_ms_median']:.3f} ms)")
    del flash, again

    plain_gates(torch, cfg, params, mesh, plan, prompts, run, kernels,
                "serve")
    launches = run_counts(run)
    del params, run
    free(torch)
    f32_gate(torch, cfg, mesh, plan, prompts, kernels, "serve")
    return launches


def phase_mixtral(torch, kernels):
    """mixtral-8x7b: (a) plan and flash, (b) int8 dispatch, (c) the long
    prompt, then the gates.  Returns the launch counts of (a)'s plan run
    and of (c)."""
    from repro_torch.comm.all_to_all import rotation_all_to_all
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan, make_dist_context
    from repro_torch.models import build_model
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.moe import _pod_ep_exchange, moe_apply
    from repro_torch.models.transformer import _embed_tokens

    cfg = mixtral_config()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH, ("pod", "data", "model"), dev)
    plan = flash_plan(MESH[0], MESH[1], SEED)
    dist = make_dist_context(cfg, mesh)
    a2a = _pod_ep_exchange(cfg, dist, mesh.sub(dist.dp_axes), "pod", True)
    if dist.ep_axes != ("pod",) or a2a.func is not rotation_all_to_all:
        raise AssertionError(f"mixtral on {MESH}: EP axes {dist.ep_axes}, "
                             f"{cfg.a2a_impl!r} exchange {a2a}")
    t0 = time.perf_counter()
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, MIX_PROMPT)).astype(np.int64)).to(dev)
    log(f"mixtral: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} experts={cfg.moe.num_experts} top"
        f"{cfg.moe.top_k} window={cfg.swa_window} layers={cfg.n_layers}/32 "
        f"mesh={MESH} EP axes {dist.ep_axes} ({cfg.a2a_impl!r} resolves to "
        f"the rotation); params "
        f"{sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9:.2f} GB, "
        f"initialised in {time.perf_counter() - t0:.1f} s")

    # (a) the plan, then the config's flash (the rotation schedule)
    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels,
                record=True)
    check_run(torch, run, cfg, BATCH, "mixtral[plan]", SERVE_KERNELS,
              MIXTRAL_A2A)
    log_run(run, f"mixtral[plan] batch {BATCH} x prompt {MIX_PROMPT}", BATCH)
    log(f"mixtral[plan]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rot = serve(torch, cfg, params, mesh, "flash", None, prompts, kernels)
    check_run(torch, rot, cfg, BATCH, "mixtral[flash]",
              ("grouped_matmul", "flash_attention"))
    if not torch.equal(rot["logits"], run["logits"]):
        raise AssertionError("mixtral: flash (rotation) prefill logits "
                             "differ from plan's")
    if not torch.equal(rot["tokens"], run["tokens"]):
        raise AssertionError("mixtral: flash greedy tokens differ from "
                             "plan's")
    log_run(rot, "mixtral[flash]: prefill logits bit-identical to plan, "
            "greedy tokens equal", BATCH)
    del rot
    free(torch)
    profile_window(torch, cfg, params, mesh, plan, prompts, kernels)
    free(torch)

    # (b) int8 dispatch through the plan.  Gated where the reference's
    # test gates it, on one MoE layer (identical inputs); the prefill's
    # logits are reported: from the second layer on, routers' near-ties
    # flip under the int8 rounding, in every sequence of 1024 tokens.
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    quant = serve(torch, cfg_q, params, mesh, "plan", plan, prompts, kernels,
                  decode=False, record=True)
    check_variants(quant, "mixtral[int8 dispatch]", a2a=MIXTRAL_INT8_A2A)
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, run["routes"], quant["routes"], BATCH)
    q_err = rel_err(torch, quant["logits"], run["logits"])
    blk = params.blocks[0]
    with torch.no_grad():
        h2 = norm_apply(cfg, blk.norm2, _embed_tokens(cfg, params, prompts,
                                                      None))
        ys = [moe_apply(c, blk.moe, h2, make_dist_context(c, mesh, "plan",
                                                          plan))[0]
              for c in (cfg, cfg_q)]
    layer_err = rel_err(torch, ys[1], ys[0])
    del ys, h2
    log(f"mixtral[int8 dispatch]: prefill {quant['prefill_s'] * 1e3:.3f} ms, "
        f"launches {quant['prefill_launches']}, by instance "
        f"{quant['prefill_variants']}; first MoE layer on identical "
        f"inputs: max rel diff to exact {layer_err:.3e}; prefill logits: max "
        f"rel diff {q_err:.3e}; routing differs in {n_flip} of {n_dec} "
        f"decisions (per layer {per_layer}), in {int(per_seq.sum())} of "
        f"{BATCH} sequences")
    if not (0 < layer_err < 0.05 and q_err > 0):
        raise AssertionError(f"int8 dispatch: first MoE layer {layer_err}, "
                             f"prefill logits {q_err}")
    del quant

    plain_gates(torch, cfg, params, mesh, plan, prompts, run, kernels,
                "mixtral")
    launches = {"mixtral-8x7b plan": run_counts(run)}
    del run
    free(torch)

    # (c) one long prompt: B = 1 does not divide the 32 ranks, so the MoE
    # runs the local path; the prefill's window skips tiles and decode runs
    # on the ring cache
    prompt_long = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LONG_PROMPT)).astype(np.int64)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    long = serve(torch, cfg, params, mesh, "plan", plan, prompt_long,
                 kernels)
    check_run(torch, long, cfg, 1, "mixtral[long]",
              ("grouped_matmul", "flash_attention"))
    if long["cache_slots"] != cfg.swa_window:
        raise AssertionError(f"mixtral[long]: decode cache of "
                             f"{long['cache_slots']} slots, expected the "
                             f"{cfg.swa_window}-slot ring")
    log_run(long, f"mixtral[long] 1 x prompt {LONG_PROMPT}, window "
            f"{cfg.swa_window}, ring cache of {long['cache_slots']} slots", 1)
    log(f"mixtral[long]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    launches["mixtral-8x7b long"] = run_counts(long)
    del long, params
    free(torch)

    f32_gate(torch, cfg, mesh, plan, prompts[:, :F32_PROMPT], kernels,
             "mixtral")
    return launches


def attn_bwd_bound(b, h, kv, s, d, causal, window, dtype_name, elem):
    """(bound ms, what bounds it) of one flash_attention_bwd call: 10 * D
    operations per visible pair and head; q, o, dO, k, v and the f32 lse
    read once, dq, dk, dv written once."""
    t_ops = 10 * b * h * d * band_pairs(s, causal, window) \
        / PEAK_OPS_PER_S[dtype_name] * 1e3
    t_bytes = ((4 * b * h + 4 * b * kv) * s * d * elem + 4 * b * h * s) \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_backward_kernels(torch):
    """The backward's kernels: flash_attention's lse and flash_attention_bwd
    against their plain versions on ragged shapes, at the training shape and
    at mixtral's windowed shape, timed beside SDPA's backward; then
    grouped_matmul's backward products at the training shapes, timed beside
    bmm.  Returns the flash_attention_bwd row and grouped_matmul's backward
    shape entries."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, flash_attention, flash_attention_bwd,
        flash_attention_bwd_ref)
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul, grouped_matmul_ref)
    from repro_torch.models.moe import _capacity

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

    def inputs(b, h, kv, s, d, dt, views):
        if views:   # [B, S, H, D] memory seen as [B, H, S, D]
            return [torch.randn((b, s, n, d), generator=gen,
                                device=dev).to(dt).transpose(1, 2)
                    for n in (h, kv, kv, h)]
        return [torch.randn((b, n, s, d), generator=gen, device=dev).to(dt)
                for n in (h, kv, kv, h)]

    def check(b, h, kv, s, d, causal, window, dt, views):
        """(lse max abs err, backward err): the backward's max abs
        difference over the largest reference gradient of the case (a
        gradient that cancels to ~0, dq and dk at S = 1, has no scale of
        its own)."""
        q, k, v, do = inputs(b, h, kv, s, d, dt, views)
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        _, lse_ref = attention_lse_ref(q, k, v, causal=causal, window=window)
        e_lse = max_abs(torch, lse, lse_ref)
        del lse_ref
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      window=window)
        scale = max(r.float().abs().max().item() for r in ref)
        err = max(max_abs(torch, g, r) for g, r in zip(got, ref)) \
            / (scale + 1e-30)
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        if not (err <= tols[dt] and e_lse <= 1e-4 and finite):
            raise AssertionError(
                f"flash_attention_bwd {dt} b{b} h{h} k{kv} s{s} d{d} causal="
                f"{causal} window={window} views={views}: err {err} > "
                f"{tols[dt]}, lse err {e_lse}, finite {finite}")
        return e_lse, err

    worst = {dt: [0.0, 0.0] for dt in tols}
    n = 0
    for dt in tols:
        for s in (1, 37, 130, 300):
            for d in (8, 16, 40, 64, 128):
                for group in (1, 4):
                    for causal in (True, False):
                        for window in (None, 5, 100):
                            errs = check(1, 2 * group, 2, s, d, causal,
                                         window, dt, views=n % 2 == 0)
                            worst[dt] = [max(a, e) for a, e in
                                         zip(worst[dt], errs)]
                            n += 1
    torch.cuda.synchronize()
    log(f"kernels: flash_attention_bwd within 1e-5 (f32) / 2e-2 (bf16) of "
        f"its plain version on {n} ragged cases (S 1 to 300, head dims 8 to "
        f"128, groups 1 and 4, causal and not, windows none, 5, 100, "
        f"contiguous and views): worst {worst[torch.float32][1]:.3e} / "
        f"{worst[torch.bfloat16][1]:.3e}; forward lse max abs err "
        f"{worst[torch.float32][0]:.3e} / {worst[torch.bfloat16][0]:.3e}")

    meg, mix = train_config(), mixtral_config()
    shapes = [("megatron-moe-32e train", TRAIN_BATCH, meg.n_heads,
               meg.n_kv_heads, TRAIN_SEQ, meg.resolved_head_dim, None),
              ("mixtral-8x7b long", 1, mix.n_heads, mix.n_kv_heads,
               LONG_PROMPT, mix.resolved_head_dim, mix.swa_window)]
    entries = []
    for path, b, h, kv, s, d, w in shapes:
        for dt in (torch.float32, torch.bfloat16):
            errs = check(b, h, kv, s, d, True, w, dt, views=True)
            worst[dt] = [max(a, e) for a, e in zip(worst[dt], errs)]
            log(f"kernels: flash_attention_bwd at the {path} shape [{b}, "
                f"{h}, {s}, {d}] kv {kv} window {w} {dt}: err {errs[1]:.3e}, "
                f"lse max abs err {errs[0]:.3e}")
            free(torch)
        q, k, v, do = inputs(b, h, kv, s, d, torch.bfloat16, True)
        o, lse = flash_attention(q, k, v, causal=True, window=w,
                                 return_lse=True)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        if w is not None and w < s:
            qi = torch.arange(s, device=dev)
            mask = dict(attn_mask=(qi[None, :] <= qi[:, None])
                        & (qi[None, :] > qi[:, None] - w))
        else:
            mask = dict(is_causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg,
                                                  enable_gqa=True, **mask)

        def sdpa_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        bound, by = attn_bwd_bound(b, h, kv, s, d, True, w, "bfloat16", 2)
        runs = TIMED_RUNS if s <= TRAIN_SEQ else 5
        entry = {
            "path": path, "shape": f"q [{b}, {h}, {s}, {d}], kv heads {kv}, "
                                   f"causal, window {w}, bf16",
            "ms": cuda_ms(torch, lambda: flash_attention_bwd(
                q, k, v, o, lse, do, causal=True, window=w), runs=runs),
            "plain_ms": cuda_ms(torch, lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=True, window=w), runs=3,
                warmup=1),
            "library_ms": cuda_ms(torch, sdpa_bwd, runs=runs)
            - cuda_ms(torch, sdpa, runs=runs),
            "bound_ms": bound, "bound_by": by}
        entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
        entry["ratio_to_bound"] = entry["ms"] / bound
        entries.append(entry)
        log("timing: flash_attention_bwd", json.dumps(entry))
        del q, k, v, do, o, lse, qg, kg, vg, mask
        free(torch)
    main = entries[0]
    attn_row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:"
                    "122 (forward only: the reference differentiates its "
                    "einsum attention)",
        "shape": main["shape"],
        "max_abs_err": max(v[1] for v in worst.values()),
        "max_err_f32": worst[torch.float32][1],
        "max_err_bf16": worst[torch.bfloat16][1],
        "lse_max_abs_err": max(v[0] for v in worst.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "shapes": entries}

    # grouped_matmul's backward products at the training island's shapes:
    # a group holds one expert's C rows from each of the 32 ranks
    cfg = train_config()
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    c = MESH[0] * MESH[1] * _capacity(
        cfg, TRAIN_BATCH // (MESH[0] * MESH[1]) * TRAIN_SEQ, e)
    bf16 = torch.bfloat16
    gmm_entries = []
    for kind, din, dout in (("gate/up", d, f), ("down", f, d)):
        x = torch.randn((e, c, din), generator=gen, device=dev).to(bf16)
        wt = (torch.randn((e, din, dout), generator=gen, device=dev)
              / din ** 0.5).to(bf16)
        dy = torch.randn((e, c, dout), generator=gen, device=dev).to(bf16)
        # what the autograd Function launches (an operand read transposed
        # in place), and the contiguous operands the copies would make
        products = (
            ("dX", lambda: grouped_matmul(dy, wt, transpose_w=True),
             lambda: (dy, wt.transpose(1, 2).contiguous())),
            ("dW", lambda: grouped_matmul(x, dy, transpose_x=True),
             lambda: (x.transpose(1, 2).contiguous(), dy)))
        for what, product, operands in products:
            a, bmat = operands()
            n_tma = grouped_matmul.launches_by_variant["tma"]
            y, ref = product(), grouped_matmul_ref(a, bmat)
            if grouped_matmul.launches_by_variant["tma"] != n_tma + 1:
                raise AssertionError(f"grouped_matmul's {what} of the {kind} "
                                     f"product did not take TMA + wgmma")
            err = rel_err(torch, y, ref)
            if not err < 2e-2:
                raise AssertionError(f"grouped_matmul {what} of the {kind} "
                                     f"product: rel err {err}")
            del y, ref
            bound, by = gmm_bound(a, bmat)
            entry = {
                "path": f"megatron-moe-32e train {kind} {what}",
                "shape": f"{list(a.shape)} @ {list(bmat.shape)} bf16",
                "ms": cuda_ms(torch, product),
                "contiguous_ms": cuda_ms(torch, lambda: grouped_matmul(
                    a, bmat)),
                "plain_ms": cuda_ms(torch, lambda: grouped_matmul_ref(
                    a, bmat), runs=5, warmup=1),
                "library_ms": cuda_ms(torch, lambda: torch.bmm(a, bmat)),
                "transpose_copy_ms": cuda_ms(torch, operands),
                "bound_ms": bound, "bound_by": by, "instance": "tma",
                "max_err": err}
            entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
            entry["ratio_to_bound"] = entry["ms"] / bound
            gmm_entries.append(entry)
            log("timing: grouped_matmul backward", json.dumps(entry))
            del a, bmat
            free(torch)
        del x, wt, dy
        free(torch)
    log("kernels: grouped_matmul's dX and dW products (an operand read "
        "transposed in place) within 2e-2 at the training shapes, all on "
        "TMA + wgmma")
    return attn_row, gmm_entries


def rel_norm(torch, a, b) -> float:
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / (b.norm() + 1e-30)).item()


def train_launches_per_step(n_layers):
    """Launches a training step must make, worked out from the code: under
    remat each layer's forward runs twice (attention once and the expert
    FFN's three products each time), the backward once (one attention
    backward, two products for each of the three expert products)."""
    return {"flash_attention": 2 * n_layers,
            "flash_attention_bwd": n_layers,
            "grouped_matmul": (2 * 3 + 3 * 2) * n_layers,
            "a2a_pack": 0, "a2a_unpack": 0}


def train_batches(cfg, batch, seq, steps):
    from repro_torch.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=SEED), cfg)
    return [data.batch(i) for i in range(steps)]


def train_run(torch, cfg, mesh, batches, kernels, use_kernel=True,
              profile_extra=False):
    """TRAIN_STEPS AdamW steps (peak rate 3e-4 after one warm-up step) of
    fresh parameters from the seed, through ``make_train_step``; counts set
    to 0 just before each step and read just after.  Returns the metrics,
    step ms, launches and instances of each step, the launches of the whole
    run, and the peak device memory."""
    from repro_torch.launch.train import (TrainOptions, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model

    dev = torch.device(DEVICE)
    params = build_model(cfg, dev, train=True).init(
        torch.Generator(device=dev).manual_seed(SEED))
    state = init_train_state(params)
    step = make_train_step(cfg, mesh, TrainOptions(
        peak_lr=3e-4, warmup_steps=1, total_steps=len(batches)),
        use_kernel=use_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"metrics": [], "step_ms": [], "launches": [], "variants": []}
    total = dict.fromkeys(kernels, 0)
    for batch in batches:
        reset_launches(kernels)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["launches"].append(read_launches(kernels))
        out["variants"].append(read_variants(kernels))
        for k, n in out["launches"][-1].items():
            total[k] += n
    out["total_launches"] = total
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile_extra:
        out["profile"] = profile_train_step(torch, step, state, batches[-1])
    del state, params, step
    free(torch)
    return out


def profile_train_step(torch, step, state, batch):
    """One more training step under torch.profiler: device time by kernel
    name (top 10) and the device's idle share over the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    return device_time(prof, "profile[train step]", host_ms)[1]


def check_train_launches(run, n_layers, label):
    """Every step's launches as ``train_launches_per_step`` says, every
    grouped_matmul launch on TMA + wgmma."""
    want = train_launches_per_step(n_layers)
    for i, (got, by) in enumerate(zip(run["launches"], run["variants"])):
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if bad:
            raise AssertionError(f"{label} step {i}: launches (got, "
                                 f"expected) {bad}")
        if by["grouped_matmul"]["tma"] != want["grouped_matmul"]:
            raise AssertionError(f"{label} step {i}: grouped_matmul by "
                                 f"instance {by['grouped_matmul']}")


def layer_grads(torch, cfg, blk, fn, x, dy):
    """(output, gradients of the input and of every parameter of ``blk``)
    of ``fn(x)`` against the cotangent ``dy``; ``fn`` returns (y, aux) or
    y, and aux enters the loss as the model's does."""
    x = x.detach().requires_grad_()
    out = fn(x)
    y, aux = out if isinstance(out, tuple) else (out, None)
    loss = (y.float() * dy.float()).sum()
    if aux is not None:
        loss = loss + 0.01 * aux
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad(loss, [x] + [p for _, p in
                                             blk.named_parameters()])
    return y.detach(), dict(zip(["input"] + names, grads))


def train_layer_gates(torch, mesh, kernels):
    """On one layer of fresh bf16-compute parameters and the cell's first
    batch: the first attention and MoE layer's outputs and gradients with
    the kernels against plain on identical inputs (relative norm 2e-2,
    routing equal), and the layer's forward run twice bit-identical (what
    remat recomputes)."""
    from repro_torch.launch.train import make_dist_context
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention_apply, norm_apply
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import _block_train, _embed_tokens

    dev = torch.device(DEVICE)
    cfg = train_config(n_layers=1)
    params = build_model(cfg, dev, train=True).init(
        torch.Generator(device=dev).manual_seed(SEED))
    batch = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1)[0]
    tokens = torch.from_numpy(batch["tokens"]).long().to(dev)
    b, s = tokens.shape
    blk = params.blocks[0]
    dist = make_dist_context(cfg, mesh)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        x0 = _embed_tokens(cfg, params, tokens, None)
        h = norm_apply(cfg, blk.norm1, x0)
        h2 = norm_apply(cfg, blk.norm2, x0)
    dy = torch.randn(x0.shape, generator=gen, device=dev).to(x0.dtype)
    worst = {}
    for name, sub, fn_of, x in (
            ("attention", blk.attn, lambda uk: lambda t: attention_apply(
                cfg, blk.attn, t, positions=positions, use_kernel=uk), h),
            ("moe", blk.moe, lambda uk: lambda t: moe_apply(
                cfg, blk.moe, t, dist, use_kernel=uk), h2)):
        with RouteRecorder() as rec:
            runs = [layer_grads(torch, cfg, sub, fn_of(uk), x, dy)
                    for uk in (True, False)]
        (y_k, g_k), (y_p, g_p) = runs
        errs = {"output": rel_norm(torch, y_k, y_p)}
        errs.update({k: rel_norm(torch, g_k[k], g_p[k]) for k in g_k})
        same = name != "moe" or torch.equal(rec.eids[0], rec.eids[-1])
        log(f"train[identical inputs]: first {name} layer, bf16, kernels vs "
            f"plain, relative norms: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + (f"; routing equal {same}" if name == "moe" else ""))
        if not (max(errs.values()) < 2e-2 and same):
            raise AssertionError(f"train: first {name} layer kernels vs "
                                 f"plain: {errs}, routing equal {same}")
        worst[name] = max(errs.values())
        del runs, y_k, g_k, y_p, g_p
        free(torch)

    # remat runs each layer's forward again in the backward: the kernels'
    # forward must give the same bits, routing included
    with RouteRecorder() as rec:
        outs = [_block_train(cfg, blk, x0.detach().requires_grad_(),
                             positions=positions, dist=dist, kind="moe",
                             full_flag=False, use_kernel=True)
                for _ in range(2)]
    same = torch.equal(outs[0][0], outs[1][0]) and \
        torch.equal(outs[0][1], outs[1][1]) and \
        torch.equal(rec.eids[0], rec.eids[1])
    log(f"train[remat]: one layer's forward with the kernels run twice: "
        f"bit-identical {same}")
    if not same:
        raise AssertionError("train: the layer's forward is not "
                             "bit-identical when run again")
    del outs, params, x0, h, h2, dy
    free(torch)
    return worst


def train_f32_gate(torch, mesh, kernels):
    """An f32 step's gradients (1 layer, TRAIN_BATCH x F32_TRAIN_SEQ tokens)
    with the kernels against the plain versions, every parameter within a
    relative norm of 1e-4; returns the worst."""
    from repro_torch.launch.train import _on, make_dist_context
    from repro_torch.models import build_model

    dev = torch.device(DEVICE)
    cfg = train_config(n_layers=1, compute_dtype="float32")
    model = build_model(cfg, dev, train=True)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    batch = _on(dev, train_batches(cfg, TRAIN_BATCH, F32_TRAIN_SEQ, 1)[0])
    named = dict(params.named_parameters())
    grads, losses = [], []
    for uk in (True, False):
        dist = make_dist_context(cfg, mesh, use_kernel=uk)
        reset_launches(kernels)
        loss, _ = model.loss(params, batch, dist, uk)
        grads.append(torch.autograd.grad(loss, list(named.values())))
        losses.append(loss.item())
        if uk and not (kernels["flash_attention_bwd"].launches == 1 and
                       kernels["grouped_matmul"].launches == 12):
            raise AssertionError(f"train[f32]: launches "
                                 f"{read_launches(kernels)}")
    errs = {k: rel_norm(torch, a, b)
            for k, a, b in zip(named, grads[0], grads[1])}
    worst = max(errs, key=errs.get)
    log(f"train[f32]: 1 layer, {TRAIN_BATCH} x {F32_TRAIN_SEQ} tokens: loss "
        f"kernels {losses[0]:.6f}, plain {losses[1]:.6f}; gradients, "
        f"relative norm, worst {errs[worst]:.3e} ({worst}); "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not errs[worst] < 1e-4:
        raise AssertionError(f"train[f32]: gradient {worst} kernels vs "
                             f"plain {errs[worst]}")
    del grads, params, model
    free(torch)
    return errs[worst]


def train_resume_gate(torch):
    """The Trainer at smoke size on the card: 6 steps unbroken, and 3 steps,
    a checkpoint and a resume to 6; parameters within a relative 1e-6
    (each tensor's largest value) of the unbroken run's."""
    import tempfile

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (TrainOptions, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig

    dev = torch.device(DEVICE)
    cfg = smoke_config(ARCH)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), dev)
    step = make_train_step(cfg, mesh, TrainOptions(
        peak_lr=5e-3, warmup_steps=2, total_steps=6))
    model = build_model(cfg, dev, train=True)
    batches = train_batches(cfg, 8, 32, 6)

    def init_state():
        return init_train_state(model.init(
            torch.Generator(device=dev).manual_seed(SEED)))

    with tempfile.TemporaryDirectory() as root:
        a = Trainer(TrainerConfig(total_steps=6, ckpt_dir=f"{root}/a",
                                  ckpt_every=100), step, init_state,
                    batches.__getitem__).run()
        Trainer(TrainerConfig(total_steps=3, ckpt_dir=f"{root}/b",
                              ckpt_every=3), step, init_state,
                batches.__getitem__).run()
        b = Trainer(TrainerConfig(total_steps=6, ckpt_dir=f"{root}/b",
                                  ckpt_every=100), step, init_state,
                    batches.__getitem__).run()
    errs = {k: ((p - q).abs().max() / q.abs().max()).item()
            for (k, p), (_, q) in zip(
                b["state"]["params"].named_parameters(),
                a["state"]["params"].named_parameters())}
    worst = max(errs, key=errs.get)
    n_equal = sum(v == 0 for v in errs.values())
    log(f"train[trainer]: smoke {cfg.name} on (2, 2, 1), 6 steps against 3 "
        f"+ checkpoint + resume 3: stopped at {b['stopped_at']}; parameters "
        f"bit-identical in {n_equal} of {len(errs)} tensors, worst relative "
        f"difference {errs[worst]:.3e} ({worst}); loss {a['metrics']['loss']:.6f}"
        f" and {b['metrics']['loss']:.6f}")
    if b["stopped_at"] != 6 or int(b["state"]["step"]) != 6 \
            or not errs[worst] <= 1e-6:
        raise AssertionError(f"train[trainer]: resume differs: {errs[worst]}")
    return errs[worst]


def phase_training(torch, kernels):
    """megatron-moe-32e trained at full width (the cell), then the gates.
    Returns the kernel run's launches over its TRAIN_STEPS steps and a
    summary."""
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(DEVICE)
    cfg = train_config()
    mesh = make_mesh(MESH, ("pod", "data", "model"), dev)
    batches = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS)
    log(f"train: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} experts="
        f"{cfg.moe.num_experts} top{cfg.moe.top_k} layers={cfg.n_layers}/24 "
        f"mesh={MESH} batch={TRAIN_BATCH} seq={TRAIN_SEQ} steps="
        f"{TRAIN_STEPS}; {cfg.param_dtype} masters, {cfg.compute_dtype} "
        f"compute, remat={cfg.remat}, exchange {cfg.a2a_impl!r}")
    run = train_run(torch, cfg, mesh, batches, kernels, profile_extra=True)
    check_train_launches(run, cfg.n_layers, "train[kernels]")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = statistics.median(run["step_ms"][1:])
    for i, (m, ms) in enumerate(zip(run["metrics"], run["step_ms"])):
        log(f"train[kernels] step {i}: {ms:.3f} ms ({tokens / ms * 1e3:.1f} "
            f"tokens/s); " + ", ".join(f"{k} {v:.6f}" for k, v in m.items())
            + f"; launches {run['launches'][i]}")
    log(f"train[kernels]: steady step {steady:.3f} ms (median of steps 1 to "
        f"{TRAIN_STEPS - 1}), {tokens / steady * 1e3:.1f} tokens/s; peak "
        f"device memory {run['peak_gb']:.2f} GB; launches over the run "
        f"{run['total_launches']}")
    plain = train_run(torch, cfg, mesh, batches, kernels, use_kernel=False)
    if any(any(n.values()) for n in plain["launches"]):
        raise AssertionError(f"train[plain]: use_kernel=False launched a "
                             f"kernel: {plain['launches']}")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(run["metrics"], plain["metrics"])]
    log(f"train[plain]: step ms {[round(x, 3) for x in plain['step_ms']]}; "
        f"peak device memory {plain['peak_gb']:.2f} GB; step losses "
        f"kernels {[round(m['loss'], 6) for m in run['metrics']]}, plain "
        f"{[round(m['loss'], 6) for m in plain['metrics']]}; relative "
        f"differences {[f'{d:.3e}' for d in diffs]}")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"train: step losses kernels vs plain {diffs}")
    summary = {"step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
               "peak_gb": run["peak_gb"], "loss_diffs": diffs,
               "profile": run.get("profile")}
    summary["layers"] = train_layer_gates(torch, mesh, kernels)
    summary["f32_grad_err"] = train_f32_gate(torch, mesh, kernels)
    summary["resume_err"] = train_resume_gate(torch)
    return run["total_launches"], summary


# Ratios of the redesigned kernels to their library calls that the bf16
# serving shapes should stay under (reported, not gated: a card below its
# power limit moves them).  Pack and unpack: device time at most the
# library call's at every serving shape, at most 1.15x the bound at
# mixtral's prefill, and one call per event pair at most 1.2x the library
# call's at decode.
RATIO_LIMITS = {"grouped_matmul prefill": 2.5, "grouped_matmul decode": 3.0,
                "flash_attention mixtral-8x7b prefill": 3.5,
                "flash_attention mixtral-8x7b long prefill": 1.5,
                "flash_attention megatron-moe-32e prefill": 2.7,
                "a2a prefill": 1.0, "a2a decode": 1.0}
BOUND_LIMITS = {"a2a mixtral-8x7b prefill": 1.15}
CALL_LIMITS = {"a2a decode": 1.2}


def verdict(limit, ratio) -> str:
    if limit is None:
        return ""
    return f" (limit {limit}: {'within' if ratio <= limit else 'OVER'})"


def log_ratios(rows):
    """Each redesigned kernel's time over its library call's at every
    serving shape, beside the limit it should stay under; for pack and
    unpack also the ratio to the bound and the one-call-per-pair ratio."""
    for name in KERNELS:
        for e in rows[name]["shapes"]:
            what = e["path"].split()[-1]
            key = {"grouped_matmul": f"{name} {e['path'].split()[-2]}",
                   "flash_attention": f"{name} {e['path']}",
                   "flash_attention_bwd": f"{name} {e['path']}"}.get(
                       name, f"a2a {what}")
            bound = (verdict(BOUND_LIMITS.get(f"a2a {e['path']}"),
                             e["ratio_to_bound"])
                     if name.startswith("a2a") else "")
            log(f"ratio: {name} {e['path']}: {e['ms']:.4f} ms / library "
                f"{e['library_ms']:.4f} ms = {e['ratio_to_library']:.3f}"
                f"{verdict(RATIO_LIMITS.get(key), e['ratio_to_library'])}; "
                f"{e['ratio_to_bound']:.3f}x its bound {e['bound_ms']:.4f} "
                f"ms{bound}")
            if "call_ms" in e:
                ratio = e["call_ms"] / e["library_call_ms"]
                log(f"ratio: {name} {e['path']}, one call per event pair: "
                    f"{e['call_ms']:.4f} ms / library "
                    f"{e['library_call_ms']:.4f} ms = {ratio:.3f}"
                    f"{verdict(CALL_LIMITS.get(key), ratio)}")


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
    from repro_torch.kernels.a2a_pack import a2a_pack, a2a_unpack
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.grouped_matmul import grouped_matmul

    t_start = time.perf_counter()
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
    for line in ptxas_lines(_build):
        log(line)

    # 2. kernels against their plain versions; a small reference
    t0 = time.perf_counter()
    rows = phase_kernels(torch)
    rows["flash_attention"] = phase_flash_attention(torch)
    for e in rows["flash_attention"]["shapes"]:
        was = FLASH_MS_BEFORE_LSE[e["path"]]
        log(f"ratio: flash_attention {e['path']} against its time before "
            f"the lse store: {e['ms']:.4f} / {was:.4f} ms = "
            f"{e['ms'] / was:.3f} (the serving path writes no lse)")
    phase_small_reference(torch)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    # 3. megatron-moe-32e; 4. mixtral-8x7b
    kernels = {"a2a_pack": a2a_pack, "a2a_unpack": a2a_unpack,
               "grouped_matmul": grouped_matmul,
               "flash_attention": flash_attention,
               "flash_attention_bwd": flash_attention_bwd}
    t0 = time.perf_counter()
    launches = {"megatron-moe-32e plan": phase_megatron(torch, kernels)}
    log(f"phase megatron: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_mixtral(torch, kernels))
    log(f"phase mixtral: {time.perf_counter() - t0:.1f} s")

    # 5. the backward's kernels; 6. training
    t0 = time.perf_counter()
    rows["flash_attention_bwd"], gmm_bwd = phase_backward_kernels(torch)
    rows["grouped_matmul"]["shapes"] += gmm_bwd
    log_ratios(rows)
    log(f"phase backward kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches, summary = phase_training(torch, kernels)
    log(f"phase training: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(summary)}")

    # Each kernel's count is that of the newest main path that runs it:
    # training (this slice's) for grouped_matmul and both attention
    # kernels, mixtral's plan run for pack and unpack, which training does
    # not launch.  Every path's counts are listed beside them.
    serving = launches["mixtral-8x7b plan"]
    result = []
    for name in KERNELS:
        row = rows[name]
        if "ms" not in row:  # the first timed shape: megatron's prefill
            first = row["shapes"][0]
            row.update({key: first[key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "instance", "call_ms", "library_call_ms",
                "bulk_ms", "vec_ms", "ratio_to_library", "ratio_to_bound")
                if key in first})
        by_path = {p: {"prefill": c["prefill"][name],
                       "decode": c["decode"][name]}
                   for p, c in launches.items()}
        by_path[f"megatron-moe-32e train ({TRAIN_STEPS} steps)"] = \
            train_launches[name]
        if train_launches[name]:
            row = dict(row, launches=train_launches[name],
                       main_path=f"megatron-moe-32e train ({TRAIN_STEPS} "
                                 f"steps)")
        else:
            if name in serving["prefill_variants"]:
                row["launches_by_variant"] = {
                    part: serving[f"{part}_variants"][name]
                    for part in ("prefill", "decode")}
            row = dict(row, launches=serving["prefill"][name]
                       + serving["decode"][name],
                       main_path="mixtral-8x7b plan (serving)")
        row["launches_by_path"] = by_path
        result.append(row)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": result}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
