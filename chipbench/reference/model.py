"""The MoE transformer in plain PyTorch, float32 by default.

What it computes (Mixtral's and Megatron-LM's MoE block):

- the token embedding, then per layer ``x += attn(rms(x))`` and
  ``x += moe(rms(x))``, then the final RMS norm and the head;
- attention: GQA (query head ``j`` reads kv head ``j // (H / KV)``),
  rotate-half RoPE, causal, keys older than ``swa_window`` masked, scaled
  by ``1 / sqrt(head_dim)``;
- the MoE block: softmax router over all experts, the top ``k``
  renormalised to sum to 1, Switch's load-balance term ``E * sum_e(frac_e
  * mean_prob_e)`` over each group's tokens (``frac_e``: the share whose
  first choice is ``e``), and each expert a SwiGLU;
- capacity: the tokens of one expert-parallel group (the rows one rank
  holds) fill each expert's ``capacity`` slots in (token, choice) order;
  a choice past them is dropped and adds nothing.  The capacity is
  ``int(factor * T * k // E) + 1`` for ``T`` tokens a group, rounded up to
  a multiple of 8 (at least 8) below 1024 tokens and of 128 from there.

``mm`` computes every product: ``matmul`` (f32, TF32 off), or
``fp8_matmul``, the control, whose operands (and, under a gradient, the
backward's) are rounded to float8 e4m3 with a per-tensor scale.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Leaves = Callable[[str], torch.Tensor]

FP8_MAX = 448.0


def exact() -> None:
    """f32 products in f32: no TF32 (the card's default may differ)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in f32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: operands in float8 e4m3, f32 accumulation."""
    if b.dim() == 2 and a.dim() > 2:
        out = _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return _Fp8Matmul.apply(a, b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float, start: int = 0) -> torch.Tensor:
    """Rotate-half RoPE of ``x [N, S, H, D]`` at positions start..start+S-1."""
    s, dim = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                       device=x.device) / dim)
    ang = torch.arange(start, start + s, dtype=torch.float64,
                       device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(m: dict, leaf: Leaves, pre: str, h: torch.Tensor,
              mm=matmul, keys: bool = False):
    """The attention block's output ``[N, S, d]``; with ``keys``, also its
    rotated keys and its values ``[N, S, KV, head_dim]``."""
    n, s, _ = h.shape
    heads, kv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope(mm(h, leaf(pre + "attn.wq")).reshape(n, s, heads, dh),
             m["rope_theta"])
    k = rope(mm(h, leaf(pre + "attn.wk")).reshape(n, s, kv, dh),
             m["rope_theta"])
    v = mm(h, leaf(pre + "attn.wv")).reshape(n, s, kv, dh)
    kv_out = (k, v)
    k = k.repeat_interleave(heads // kv, dim=2)
    v = v.repeat_interleave(heads // kv, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(dh)
    qpos = torch.arange(s, device=h.device)[:, None]
    kpos = torch.arange(s, device=h.device)[None, :]
    visible = kpos <= qpos
    if m.get("swa_window") is not None:
        visible &= kpos > qpos - m["swa_window"]
    scores = scores.masked_fill(~visible, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v.transpose(1, 2))
    out = mm(out.transpose(1, 2).reshape(n, s, heads * dh),
             leaf(pre + "attn.wo"))
    return (out, *kv_out) if keys else out


def capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(factor * tokens * top_k // n_experts) + 1
    if tokens < 1024:
        return max(8, -(-c // 8) * 8)
    return -(-c // 128) * 128


def _experts(stack):
    """An expert stack's experts: a ``[E, ...]`` tensor's slices, or the
    list a training reference keeps them in."""
    return stack.unbind(0) if torch.is_tensor(stack) else stack


def moe(m: dict, leaf: Leaves, pre: str, h: torch.Tensor, group_rows: int,
        mm=matmul):
    """``(y [N, S, d], aux [G])`` of ``h [N, S, d]``, whose consecutive
    ``group_rows`` rows are one expert-parallel group."""
    n, s, d = h.shape
    e, k = m["num_experts"], m["top_k"]
    g = n // group_rows
    t = group_rows * s
    x = h.reshape(g, t, d)
    probs = torch.softmax(mm(x, leaf(pre + "moe.router")), dim=-1)
    top, eid = torch.topk(probs, k, dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    first = F.one_hot(eid[..., 0], e).to(probs.dtype)
    aux = e * (first.mean(1) * probs.mean(1)).sum(-1)

    flat = eid.reshape(g, t * k)
    order = F.one_hot(flat, e).cumsum(1) - 1
    pos = order.gather(-1, flat[..., None])[..., 0]
    keep = (pos < capacity(t, e, k, m["capacity_factor"])).reshape(-1)
    flat = flat.reshape(-1)
    token = torch.arange(g * t * k, device=h.device) // k
    gate = gates.reshape(-1)
    xt = x.reshape(g * t, d)
    out = torch.zeros_like(xt)
    # one unbind a stack: indexing it per expert would give each expert's
    # backward a gradient the size of the whole stack
    stacks = zip(*(_experts(leaf(pre + f"moe.{w}"))
                   for w in ("w_gate", "w_up", "w_down")))
    for j, (w_gate, w_up, w_down) in enumerate(stacks):
        sel = torch.nonzero((flat == j) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        rows = xt[token[sel]]
        y = mm(F.silu(mm(rows, w_gate)) * mm(rows, w_up), w_down)
        out.index_add_(0, token[sel], y * gate[sel, None])
    return out.reshape(n, s, d), aux


def layer(m: dict, leaf: Leaves, i: int, x: torch.Tensor, group_rows: int,
          mm=matmul, attn_rows: Optional[int] = None):
    """One block: ``(x, aux [G])``; attention over ``attn_rows`` rows at a
    time (all by default) to bound the scores' memory."""
    pre = f"blocks.{i}."
    eps = m["rms_norm_eps"]
    h = rms_norm(x, leaf(pre + "norm1.scale"), eps)
    step = attn_rows or x.shape[0]
    x = x + torch.cat([attention(m, leaf, pre, h[r:r + step], mm)
                       for r in range(0, x.shape[0], step)])
    y, aux = moe(m, leaf, pre, rms_norm(x, leaf(pre + "norm2.scale"), eps),
                 group_rows, mm)
    return x + y, aux


def last_logits(m: dict, leaf: Leaves, tokens: torch.Tensor,
                group_rows: int, mm=matmul, attn_rows: int = 8
                ) -> torch.Tensor:
    """The last position's logits ``[N, V]`` of prompts ``tokens [N, S]``,
    layer by layer over every row; ``leaf`` may make each layer's leaves
    as it is reached."""
    x = leaf("embed")[tokens]
    for i in range(m["n_layers"]):
        x, _ = layer(m, leaf, i, x, group_rows, mm, attn_rows)
    x = rms_norm(x[:, -1], leaf("final_norm.scale"), m["rms_norm_eps"])
    return mm(x, leaf("lm_head"))


def loss_terms(m: dict, leaf: Leaves,
               tokens: torch.Tensor, labels: torch.Tensor, group_rows: int,
               mm=matmul):
    """``(sum of the rows' next-token NLL, sum over layers and groups of
    the load-balance term)`` of ``tokens [N, S]``: the training loss of a
    batch of ``B`` rows in ``G`` groups is ``nll / (B * S) + 0.01 * aux /
    G``, so a batch may be taken a block of groups at a time."""
    x = leaf("embed")[tokens]
    aux = x.new_zeros(())
    for i in range(m["n_layers"]):
        x, a = layer(m, leaf, i, x, group_rows, mm)
        aux = aux + a.sum()
    x = rms_norm(x, leaf("final_norm.scale"), m["rms_norm_eps"])
    logits = mm(x, leaf("lm_head"))
    nll = torch.logsumexp(logits, -1) \
        - logits.gather(-1, labels[..., None])[..., 0]
    return nll.sum(), aux
