"""Mixture-of-Experts layer with expert-parallel dispatch over the plan.

Counterpart of ``src/repro/models/moe.py``.  Top-k routing, sort-based
dispatch into capacity-padded ``[E * C, d]`` buffers, the grouped SwiGLU
expert FFN and the weighted combine are the reference's math; the FFN's three
products run on the ``grouped_matmul`` kernel.

The expert-parallel island runs every rank of the local mesh at once: the
batch is split over the DP axes slow-axis major (rank ``r`` holds rows
``[r*B/R, (r+1)*B/R)``, as ``P(("pod", "data"))`` shards it), routing and
dispatch run batched over the rank axis, and dispatch and combine go through
``comm.resolve_all_to_all`` (``direct`` or the plan).  EP axes equal DP axes
here, so rank ``r``'s local expert ``e`` is global expert ``r*E_loc + e`` and
one kernel launch per product serves every rank.

``dist=None`` runs the same math with one rank and no exchange; it is the
correctness oracle for the island.  ``_moe_pod_ep`` (EP over one axis or none)
and quantized dispatch are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..comm.all_to_all import resolve_all_to_all
from ..configs.registry import ModelConfig
from ..kernels.grouped_matmul import grouped_matmul, grouped_matmul_ref
from ..launch.mesh import pmean
from .dist import DistContext
from .layers import dense_init, param

__all__ = ["MoE", "init_moe", "moe_apply"]


class MoE(nn.Module):
    """``router [d, E]`` in f32; expert stacks ``w_gate``/``w_up [E, d, f]``
    and ``w_down [E, f, d]``.

    The expert stacks are kept in the compute dtype: they hold exactly what
    the reference's ``w.astype(dt)`` gives at each use (``moe.py:119-121``),
    cast once instead of per call, which halves their memory in bf16.
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        wdt = getattr(torch, cfg.compute_dtype)

        def stack(din, dout):
            w = torch.randn((e, din, dout), generator=gen,
                            dtype=torch.float32, device=device)
            return (w * (1.0 / din ** 0.5)).to(dtype).to(wdt)

        self.router = param(dense_init(gen, d, e, torch.float32, device))
        self.w_gate = param(stack(d, f))
        self.w_up = param(stack(d, f))
        self.w_down = param(stack(f, d))


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device="cuda") -> MoE:
    return MoE(cfg, gen, dtype, device)


def _capacity(cfg: ModelConfig, n_tokens: int, n_experts: int) -> int:
    c = int(cfg.moe.capacity_factor * n_tokens * cfg.moe.top_k
            // n_experts) + 1
    # The reference's rounding (to 8 below 1024 tokens, to 128 above), kept
    # exactly so buffer shapes match it.
    return max(8, -(-c // 8) * 8) if n_tokens < 1024 else -(-c // 128) * 128


def _route(cfg: ModelConfig, router_w: torch.Tensor, x_flat: torch.Tensor):
    """Top-k routing of ``x_flat [G, T, d]`` for each of G ranks.

    Returns (gates [G, T, k], eids [G, T, k], aux [G])."""
    e = cfg.moe.num_experts
    logits = x_flat.float() @ router_w                         # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, cfg.moe.top_k, dim=-1)     # [G, T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss (fraction * mean prob).
    frac = F.one_hot(eids[..., 0], e).float().mean(1)          # [G, E]
    aux = e * (frac * probs.mean(1)).sum(-1)
    return gates.to(x_flat.dtype), eids, aux


def _dispatch(x_flat: torch.Tensor, eids: torch.Tensor, capacity: int,
              n_experts: int):
    """Sort-based dispatch of ``x_flat [G, T, d]`` into ``[G, E * C, d]``.

    Returns (buffer, slot [G, T*k], keep [G, T*k]): ``slot`` is each
    (token, choice)'s position in its rank's buffer (valid where keep).
    """
    g, t, k = eids.shape
    d = x_flat.shape[-1]
    n_slots = n_experts * capacity
    flat_eid = eids.reshape(g, t * k)
    sorted_eid, order = torch.sort(flat_eid, dim=-1, stable=True)
    first = torch.searchsorted(sorted_eid, sorted_eid, side="left")
    pos_in_e = torch.arange(t * k, device=x_flat.device) - first
    keep_sorted = pos_in_e < capacity
    slot_sorted = sorted_eid * capacity + pos_in_e
    tokens_sorted = torch.gather(
        x_flat, 1, (order // k)[..., None].expand(g, t * k, d))
    # Overflow lands in one trash row per rank, sliced off below.
    safe = torch.where(keep_sorted, slot_sorted, n_slots)
    rank_base = torch.arange(g, device=x_flat.device)[:, None] * (n_slots + 1)
    buf = torch.zeros(((n_slots + 1) * g, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    buf.index_copy_(0, (safe + rank_base).reshape(-1),
                    tokens_sorted.reshape(-1, d))
    buf = buf.reshape(g, n_slots + 1, d)[:, :n_slots]
    # map back to unsorted (token, choice) order
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    return buf, slot, keep


def _combine(y_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Gather expert outputs ``y_buf [G, E*C, d]`` back to (token, choice),
    weight and sum: ``[G, T, d]``."""
    g, n_slots, d = y_buf.shape
    # The reference's gather clamps out-of-range slots of dropped choices;
    # keep = 0 then zeroes them.
    idx = slot.clamp(max=n_slots - 1)[..., None].expand(g, t * k, d)
    y = torch.gather(y_buf, 1, idx) * keep[..., None].to(y_buf.dtype)
    y = y.reshape(g, t, k, d)
    return (y * gates[..., None]).sum(dim=2)


def _expert_ffn(cfg: ModelConfig, w_gate, w_up, w_down,
                tokens: torch.Tensor, counts: Optional[torch.Tensor] = None,
                use_kernel: bool = True) -> torch.Tensor:
    """tokens [E, C_tot, d] -> [E, C_tot, d] (grouped SwiGLU).

    ``counts [E]`` marks each expert's filled rows (the rest are zero and
    stay zero); None treats every row as valid."""
    dt = tokens.dtype
    gmm = grouped_matmul if use_kernel else grouped_matmul_ref
    h = F.silu(gmm(tokens, w_gate.to(dt), counts)) \
        * gmm(tokens, w_up.to(dt), counts)
    return gmm(h, w_down.to(dt), counts)


def _moe_island(cfg: ModelConfig, dist: DistContext, x: torch.Tensor,
                p: MoE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (pod, data) rank at once.  x: [R, B_loc, S, d] stacked."""
    r, b, s, d = x.shape
    e = cfg.moe.num_experts
    g = dist.ep_size
    e_loc = e // g
    t = b * s
    x_flat = x.reshape(r, t, d)
    gates, eids, aux = _route(cfg, p.router, x_flat)
    cap = _capacity(cfg, t, e)
    buf, slot, keep = _dispatch(x_flat, eids, cap, e)
    buf = buf.reshape(r, g, e_loc * cap, d)

    a2a = resolve_all_to_all(dist)
    recv = a2a(buf)                                   # [R, G, E_loc*C, d]

    # [R, G, E_loc, C, d] -> [R*E_loc, G*C, d]: group r*E_loc + e is global
    # expert r*E_loc + e, so the [E, d, f] stacks serve every rank at once.
    # Each group is G chunks with their own filled prefix: no counts.
    tokens = recv.reshape(r, g, e_loc, cap, d).transpose(1, 2) \
        .reshape(r * e_loc, g * cap, d).contiguous()
    y = _expert_ffn(cfg, p.w_gate, p.w_up, p.w_down, tokens,
                    use_kernel=dist.use_kernel)
    y = y.reshape(r, e_loc, g, cap, d).transpose(1, 2) \
        .reshape(r, g, e_loc * cap, d)
    y = a2a(y)                                        # return trip
    out = _combine(y.reshape(r, e * cap, d), slot, keep, gates, t,
                   cfg.moe.top_k)
    # Aux loss averaged over all ranks, as the reference's pmean.
    aux = pmean(dist.mesh.sub(dist.dp_axes), aux, dist.dp_axes)[0]
    return out.reshape(r, b, s, d), aux


def _dp_size(dist: DistContext) -> int:
    return dist.mesh.axis_size(dist.dp_axes)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              dist: Optional[DistContext] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,d], aux_loss scalar)."""
    if dist is not None and x.shape[0] % _dp_size(dist) != 0:
        # batch does not divide the DP shards: run the local path
        dist = None
    if dist is not None and (
            dist.ep_axes is None or len(dist.ep_axes) == 1):
        raise NotImplementedError(
            "MoE with expert parallelism over one mesh axis or none "
            "(_moe_pod_ep, quantized dispatch) is not ported to PyTorch "
            "yet: ROADMAP.md Queue 1, item 2")
    use_kernel = True if dist is None else dist.use_kernel
    if dist is None or dist.ep_size == 1:
        b, s, d = x.shape
        e = cfg.moe.num_experts
        x_flat = x.reshape(1, b * s, d)
        gates, eids, aux = _route(cfg, p.router, x_flat)
        cap = _capacity(cfg, b * s, e)
        buf, slot, keep = _dispatch(x_flat, eids, cap, e)
        counts = torch.bincount(eids.reshape(-1), minlength=e) \
            .clamp(max=cap).to(torch.int32)
        y = _expert_ffn(cfg, p.w_gate, p.w_up, p.w_down,
                        buf.reshape(e, cap, d), counts, use_kernel)
        out = _combine(y.reshape(1, e * cap, d), slot, keep, gates, b * s,
                       cfg.moe.top_k)
        return out.reshape(b, s, d), aux[0]

    if tuple(dist.ep_axes) != tuple(dist.dp_axes):
        raise ValueError(f"the island needs EP axes {dist.ep_axes} equal to "
                         f"the DP axes {dist.dp_axes}")
    r = _dp_size(dist)
    b, s, d = x.shape
    out, aux = _moe_island(cfg, dist, x.reshape(r, b // r, s, d), p)
    return out.reshape(b, s, d), aux
