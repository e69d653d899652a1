"""DBRX (hf ``databricks/dbrx-base``) in plain PyTorch, float32 by default.

What it computes, from the published ``modeling_dbrx``:

- the token embedding, then per layer ``x += attn(LN1(x))`` and
  ``x += moe(LN2(x))``, then the final LN and the head; each LN a
  LayerNorm without bias (``nn.LayerNorm(d, bias=False)``);
- attention: q, k and v projected and each clamped to ``[-clip_qkv,
  clip_qkv]``, then rotate-half RoPE at ``rope_theta`` on q and k; GQA
  (query head ``j`` reads kv head ``j // (H / KV)``), causal, scaled by
  ``1 / sqrt(head_dim)``;
- the MoE block (``model.moe``): softmax router over the experts, the top
  ``k`` divided by their sum (``moe_normalize_expert_weights`` 1: the L1
  norm of positive weights), each expert a SwiGLU (``silu(x w1) * (x v1)
  w2``), under ``model.capacity``'s rule, which drops nothing at the
  cell's factor of ``E / k`` (DBRX's MegaBlocks MoE is dropless).

Departures from the published model, none of which changes what it
computes at the cell's sizes:

- q, k and v are three leaves (``attn.wq``, ``wk``, ``wv``), the columns of
  the published fused ``Wqkv``; clamping them apart clamps the same
  numbers;
- the LayerNorms' eps is the configuration's ``layer_norm_eps`` (the
  program's fixed 1e-6; published 1e-5);
- the router's jitter (training only) is left out.

``branches`` takes the last token's routing ties as ``ties.branches`` does
for the RMS-norm models: where a layer's 4th and 5th router logits lie
within the margin, both ways.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from . import model, ties
from .model import Leaves, exact, fp8_matmul, matmul, rope

__all__ = ["exact", "fp8_matmul", "layer_norm", "attention", "layer",
           "last_logits", "branches"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """LayerNorm over the last dim, scaled, without bias."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


def _qkv(m: dict, leaf: Leaves, pre: str, h: torch.Tensor, mm, start: int):
    """q ``[N, S, H, dh]``, k, v ``[N, S, KV, dh]`` of ``h [N, S, d]`` at
    positions ``start..``: clamped as projected, q and k then rotated."""
    n, s, _ = h.shape
    heads, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    c = m["clip_qkv"]

    def proj(name, width):
        return mm(h, leaf(pre + name)).clamp(-c, c).reshape(n, s, width, dh)

    q = rope(proj("attn.wq", heads), m["rope_theta"], start)
    k = rope(proj("attn.wk", kv), m["rope_theta"], start)
    return q, k, proj("attn.wv", kv)


def attention(m: dict, leaf: Leaves, pre: str, h: torch.Tensor,
              mm=matmul, keys: bool = False):
    """The attention block's output ``[N, S, d]``; with ``keys``, also its
    rotated keys and its values ``[N, S, KV, head_dim]``."""
    n, s, _ = h.shape
    heads, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q, k, v = _qkv(m, leaf, pre, h, mm, 0)
    kv_out = (k, v)
    k = k.repeat_interleave(heads // kv, dim=2)
    v = v.repeat_interleave(heads // kv, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(dh)
    pos = torch.arange(s, device=h.device)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v.transpose(1, 2))
    out = mm(out.transpose(1, 2).reshape(n, s, heads * dh),
             leaf(pre + "attn.wo"))
    return (out, *kv_out) if keys else out


def layer(m: dict, leaf: Leaves, i: int, x: torch.Tensor, group_rows: int,
          mm=matmul, attn_rows: int = 8):
    """One block: ``(x, aux [G])``; attention over ``attn_rows`` rows at a
    time to bound the scores' memory."""
    pre = f"blocks.{i}."
    eps = m["layer_norm_eps"]
    h = layer_norm(x, leaf(pre + "norm1.scale"), eps)
    x = x + torch.cat([attention(m, leaf, pre, h[r:r + attn_rows], mm)
                       for r in range(0, x.shape[0], attn_rows)])
    y, aux = model.moe(m, leaf, pre,
                       layer_norm(x, leaf(pre + "norm2.scale"), eps),
                       group_rows, mm)
    return x + y, aux


def last_logits(m: dict, leaf: Leaves, tokens: torch.Tensor,
                group_rows: int, mm=matmul, attn_rows: int = 8
                ) -> torch.Tensor:
    """The last position's logits ``[N, V]`` of prompts ``tokens [N, S]``,
    whose consecutive ``group_rows`` rows are one expert-parallel group,
    layer by layer."""
    x = leaf("embed")[tokens]
    for i in range(m["n_layers"]):
        x, _ = layer(m, leaf, i, x, group_rows, mm, attn_rows)
    x = layer_norm(x[:, -1], leaf("final_norm.scale"), m["layer_norm_eps"])
    return mm(x, leaf("lm_head"))


# -- the last token's routing ties ---------------------------------------------

def branches(m: dict, leaf: Leaves, tokens: torch.Tensor, group_rows: int,
             margin: float, attn_rows: int = 8, most: int = 64
             ) -> ties.Branches:
    """``ties.branches`` of DBRX: the last-position logits of prompts
    ``tokens [N, S]`` on every branch of their last token's ties (at most
    ``most`` a request, those that cross the smallest ties kept)."""
    n, s = tokens.shape
    if model.capacity(group_rows * s, m["num_experts"], m["top_k"],
                      m["capacity_factor"]) < group_rows * s:
        raise ValueError("branches takes a dropless configuration: "
                         "capacity at least a group's tokens")
    eps = m["layer_norm_eps"]
    x = leaf("embed")[tokens]
    state = x[:, -1].clone()
    owner = torch.arange(n, device=tokens.device)
    need = torch.zeros(n, dtype=torch.float64)
    for i in range(m["n_layers"]):
        pre = f"blocks.{i}."
        h = layer_norm(x, leaf(pre + "norm1.scale"), eps)
        outs, ks, vs = [], [], []
        for r in range(0, n, attn_rows):
            o, k, v = attention(m, leaf, pre, h[r:r + attn_rows], keys=True)
            outs.append(o)
            ks.append(k[:, :-1])
            vs.append(v[:, :-1])
        x = x + torch.cat(outs)
        y, _ = model.moe(m, leaf, pre, layer_norm(
            x, leaf(pre + "norm2.scale"), eps), group_rows)
        x = x + y
        state = state + _attend(m, leaf, pre, state, owner, torch.cat(ks),
                                torch.cat(vs))
        state, owner, need = _route(m, leaf, pre, state, owner, need,
                                    margin, most)
    out = layer_norm(state, leaf("final_norm.scale"), eps)
    return ties.Branches(matmul(out, leaf("lm_head")), owner, need)


def _attend(m, leaf, pre, state, owner, keys, values, chunk: int = 64):
    """The attention block's output at the last position ``[B, d]`` for
    branch states ``state`` over their requests' prefix ``keys``,
    ``values [N, S-1, KV, head_dim]``."""
    heads, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = keys.shape[1]
    h = layer_norm(state, leaf(pre + "norm1.scale"), m["layer_norm_eps"])
    q, k, v = _qkv(m, leaf, pre, h[:, None], matmul, pos)
    outs = []
    for b in range(0, state.shape[0], chunk):
        sl = slice(b, b + chunk)
        kk = torch.cat([keys[owner[sl]], k[sl]], 1) \
            .repeat_interleave(heads // kv, dim=2)          # [b, S, H, dh]
        vv = torch.cat([values[owner[sl]], v[sl]], 1) \
            .repeat_interleave(heads // kv, dim=2)
        scores = torch.einsum("bhd,bshd->bhs", q[sl, 0], kk) / math.sqrt(dh)
        outs.append(torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1),
                                 vv).reshape(-1, heads * dh))
    return matmul(torch.cat(outs), leaf(pre + "attn.wo"))


def _route(m, leaf, pre, state, owner, need, margin, most):
    """Each branch's MoE block at the last position, split at its ties:
    ``(state, owner, need)`` of the branches that follow."""
    e, k = m["num_experts"], m["top_k"]
    h = layer_norm(state, leaf(pre + "norm2.scale"), m["layer_norm_eps"])
    logits = matmul(h, leaf(pre + "moe.router"))
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
    ways = ties._fewest(ways, req, most)

    stacks = [model._experts(leaf(pre + f"moe.{w}"))
              for w in ("w_gate", "w_up", "w_down")]
    rows = sorted({(b, ex) for b, experts, _ in ways for ex in experts})
    outs = {}
    for ex in sorted({ex for _, ex in rows}):
        bs = [b for b, x_ in rows if x_ == ex]
        hr = h[bs]
        y = matmul(F.silu(matmul(hr, stacks[0][ex]))
                   * matmul(hr, stacks[1][ex]), stacks[2][ex])
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
