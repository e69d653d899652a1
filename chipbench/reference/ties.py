"""The reference's answers at its routing ties, for a served request.

A request's last-position logits hinge on how its last token is routed.
Two computations that round differently (the program in bf16, this
reference in f32) route it differently where the reference's ``k``-th and
``k+1``-th router logits lie closer than rounding moves them, and the
answer then moves by tens of percent.

``branches`` follows each request's last token through the layers on the
reference's own prefix (every other token's keys and values), and where
the ``k``-th and ``k+1``-th router logits lie within ``margin`` takes both
ways.  Each branch is an answer the f32 model gives at a tie; the first
branch of each request is the reference's own.  A program is judged by the
branch nearest to it.  The last token's choices are all kept: the cells
that use this run without dropping (capacity ``E / k`` or more), so no
other token moves a capacity cut onto it.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from . import model


class Branches(NamedTuple):
    logits: torch.Tensor    # [B, V] last-position logits
    owner: torch.Tensor     # [B] the request (row of the prompts) it answers
    margin: torch.Tensor    # [B] widest router-logit margin it crossed (0: none)


def branches(m: dict, leaf: model.Leaves, tokens: torch.Tensor,
             group_rows: int, margin: float, attn_rows: int = 8,
             most: int = 64) -> Branches:
    """The last-position logits of prompts ``tokens [N, S]`` on every
    branch of their last token's ties (at most ``most`` a request, those
    that cross the smallest ties kept), layer by layer as
    ``model.last_logits``."""
    n, s = tokens.shape
    if model.capacity(group_rows * s, m["num_experts"], m["top_k"],
                      m["capacity_factor"]) < group_rows * s:
        raise ValueError("ties.branches takes a dropless configuration: "
                         "capacity at least a group's tokens")
    x = leaf("embed")[tokens]
    state = x[:, -1].clone()
    owner = torch.arange(n, device=tokens.device)
    need = torch.zeros(n, dtype=torch.float64)
    for i in range(m["n_layers"]):
        pre = f"blocks.{i}."
        eps = m["rms_norm_eps"]
        h = model.rms_norm(x, leaf(pre + "norm1.scale"), eps)
        outs, ks, vs = [], [], []
        for r in range(0, n, attn_rows):
            o, k, v = model.attention(m, leaf, pre, h[r:r + attn_rows],
                                      keys=True)
            outs.append(o)
            ks.append(k[:, :-1])
            vs.append(v[:, :-1])
        x = x + torch.cat(outs)
        y, _ = model.moe(m, leaf, pre, model.rms_norm(
            x, leaf(pre + "norm2.scale"), eps), group_rows)
        x = x + y
        state = state + _attend(m, leaf, pre, state, owner, torch.cat(ks),
                                torch.cat(vs))
        state, owner, need = _route(m, leaf, pre, state, owner, need,
                                    margin, most)
    out = model.rms_norm(state, leaf("final_norm.scale"), m["rms_norm_eps"])
    return Branches(model.matmul(out, leaf("lm_head")), owner, need)


def _attend(m, leaf, pre, state, owner, keys, values, chunk: int = 64):
    """The attention block's output at the last position ``[B, d]`` for
    branch states ``state`` over their requests' prefix ``keys``,
    ``values [N, S-1, KV, head_dim]``."""
    heads, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = keys.shape[1]
    h = model.rms_norm(state, leaf(pre + "norm1.scale"), m["rms_norm_eps"])
    q = model.rope(model.matmul(h, leaf(pre + "attn.wq"))
                   .reshape(-1, 1, heads, dh), m["rope_theta"], pos)
    k = model.rope(model.matmul(h, leaf(pre + "attn.wk"))
                   .reshape(-1, 1, kv, dh), m["rope_theta"], pos)
    v = model.matmul(h, leaf(pre + "attn.wv")).reshape(-1, 1, kv, dh)
    visible = torch.ones(pos + 1, dtype=torch.bool, device=state.device)
    if m.get("swa_window") is not None:
        visible &= torch.arange(pos + 1, device=state.device) \
            > pos - m["swa_window"]
    outs = []
    for b in range(0, state.shape[0], chunk):
        sl = slice(b, b + chunk)
        kk = torch.cat([keys[owner[sl]], k[sl]], 1) \
            .repeat_interleave(heads // kv, dim=2)          # [b, S, H, dh]
        vv = torch.cat([values[owner[sl]], v[sl]], 1) \
            .repeat_interleave(heads // kv, dim=2)
        scores = torch.einsum("bhd,bshd->bhs", q[sl, 0], kk) / math.sqrt(dh)
        scores = scores.masked_fill(~visible, float("-inf"))
        outs.append(torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1),
                                 vv).reshape(-1, heads * dh))
    return model.matmul(torch.cat(outs), leaf(pre + "attn.wo"))


def _route(m, leaf, pre, state, owner, need, margin, most):
    """Each branch's MoE block at the last position, split at its ties:
    ``(state, owner, need)`` of the branches that follow."""
    e, k = m["num_experts"], m["top_k"]
    h = model.rms_norm(state, leaf(pre + "norm2.scale"), m["rms_norm_eps"])
    logits = model.matmul(h, leaf(pre + "moe.router"))
    probs = torch.softmax(logits, -1)
    z = logits.double().cpu()
    order = torch.sort(z, dim=-1, descending=True, stable=True).indices
    req = owner.tolist()
    # (branch, experts, the widest tie crossed) of every way on
    ways: List[tuple] = []
    for b in range(state.shape[0]):
        o = order[b].tolist()
        ways.append((b, o[:k], float(need[b])))
        gap = float(z[b, o[k - 1]] - z[b, o[k]]) if k < e else math.inf
        if gap < margin:
            ways.append((b, o[:k - 1] + [o[k]], max(float(need[b]), gap)))
    ways = _fewest(ways, req, most)

    stacks = [model._experts(leaf(pre + f"moe.{w}"))
              for w in ("w_gate", "w_up", "w_down")]
    rows = sorted({(b, ex) for b, experts, _ in ways for ex in experts})
    outs = {}
    for ex in sorted({ex for _, ex in rows}):
        bs = [b for b, x_ in rows if x_ == ex]
        hr = h[bs]
        y = model.matmul(F.silu(model.matmul(hr, stacks[0][ex]))
                         * model.matmul(hr, stacks[1][ex]), stacks[2][ex])
        outs.update({(b, ex): y[j] for j, b in enumerate(bs)})
    new = []
    for b, experts, _ in ways:
        p = probs[b, experts]
        gates = p / p.sum()
        new.append(state[b] + sum(gates[j] * outs[(b, ex)]
                                  for j, ex in enumerate(experts)))
    idx = torch.tensor([w[0] for w in ways], device=state.device)
    return (torch.stack(new), owner[idx],
            torch.tensor([w[2] for w in ways], dtype=torch.float64))


def _fewest(ways, req, most):
    """At most ``most`` ways a request, those whose widest tie is least
    kept; each request's own way (no tie crossed) first."""
    by_req = {}
    for w in ways:
        by_req.setdefault(req[w[0]], []).append(w)
    out = []
    for r in sorted(by_req):
        out += sorted(by_req[r], key=lambda w: w[2])[:most]
    return out
