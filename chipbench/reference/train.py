"""The reference's first training steps: the loss of each, the first
gradient as AdamW takes it (after clipping) and the parameters' change
after the last, leaf by leaf, from the benchmark's seeded f32 weights and
batches.

AdamW: decoupled weight decay on every leaf, the gradients clipped to a
global norm, bias-corrected moments; the rate is linear warm-up then
cosine decay to a tenth of the peak.
"""

from __future__ import annotations

import math
from typing import List

import torch

from .. import traffic as traffic_mod
from .. import weights
from . import model


def cosine_lr(opts: dict, step: int) -> float:
    peak, warm = opts["peak_lr"], opts["warmup_steps"]
    total, floor = opts["total_steps"], 0.1 * opts["peak_lr"]
    if step < warm:
        return peak * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * frac))


def _parts(t: torch.Tensor) -> List[torch.Tensor]:
    """A leaf's trainable tensors: an expert stack's experts apart (views
    of it, each with a gradient of its own expert's size)."""
    if t.dim() == 3:
        return [x.detach().requires_grad_() for x in t.unbind(0)]
    return [t.requires_grad_()]


def _norm(tensors: List[torch.Tensor]) -> float:
    return math.sqrt(sum(float(torch.linalg.vector_norm(t)) ** 2
                         for t in tensors))


def reference_steps(m: dict, traffic: dict, seed: int, steps: int,
                    group_rows: int, device, mm=model.matmul,
                    block_rows: int = 4, state_dtype=None) -> dict:
    """``{"loss": [each step's], "first_grad": {leaf: norm},
    "change": {leaf: norm}}`` after ``steps`` steps on batches 0, 1, ...
    of the seed, ``block_rows`` rows (whole groups) a backward.  The
    control passes ``mm=model.fp8_matmul`` and ``state_dtype`` bfloat16:
    the parameters and moments kept in it, rounded to it after each
    update."""
    opts = traffic["options"]
    leaves = weights.leaves(m, train=True)
    params = {leaf.name: _parts(weights.make(leaf, seed, device))
              for leaf in leaves}

    def rounded(t):
        if state_dtype is not None:
            t.copy_(t.to(state_dtype))
        return t

    with torch.no_grad():
        for ps in params.values():
            for p in ps:
                rounded(p)

    def leaf(name):
        return params[name] if "moe.w_" in name else params[name][0]

    mom = {k: [torch.zeros_like(p) for p in ps] for k, ps in params.items()}
    vel = {k: [torch.zeros_like(p) for p in ps] for k, ps in params.items()}
    rows, s = int(traffic["rows"]), int(traffic["seq_len"])
    groups = rows // group_rows
    block_rows = max(group_rows, block_rows - block_rows % group_rows)
    out = {"loss": []}
    for step in range(steps):
        b = traffic_mod.batch(traffic, m["vocab"], seed, step, device)
        loss = 0.0
        for r in range(0, rows, block_rows):
            nll, aux = model.loss_terms(
                m, leaf, b["tokens"][r:r + block_rows],
                b["labels"][r:r + block_rows], group_rows, mm)
            part = nll / (rows * s) + 0.01 * aux / groups
            part.backward()
            loss += float(part.detach())
        out["loss"].append(loss)
        with torch.no_grad():
            norms = {k: _norm([p.grad for p in ps])
                     for k, ps in params.items()}
            gnorm = math.sqrt(sum(n * n for n in norms.values()))
            scale = min(1.0, opts["clip_norm"] / max(gnorm, 1e-9))
            if step == 0:
                out["first_grad"] = {k: scale * n for k, n in norms.items()}
            count = step + 1
            bc1 = 1 - opts["b1"] ** count
            bc2 = 1 - opts["b2"] ** count
            lr = cosine_lr(opts, step)
            for k, ps in params.items():
                for p, mo, ve in zip(ps, mom[k], vel[k]):
                    g = p.grad * scale
                    rounded(mo.mul_(opts["b1"]).add_(g, alpha=1 - opts["b1"]))
                    rounded(ve.mul_(opts["b2"]).add_(g * g,
                                                     alpha=1 - opts["b2"]))
                    upd = (mo / bc1) / ((ve / bc2).sqrt() + opts["eps"])
                    rounded(p.sub_(lr * (upd + opts["weight_decay"] * p)))
                    p.grad = None
    with torch.no_grad():
        del mom, vel
        out["change"] = {
            leaf.name: _norm([p - p0 for p, p0 in zip(
                params[leaf.name],
                _parts(weights.make(leaf, seed, device)))])
            for leaf in leaves}
    return out
