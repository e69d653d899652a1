"""Mixture-of-Experts layer with expert-parallel dispatch over the plan.

Counterpart of ``src/repro/models/moe.py``.  Top-k routing, sort-based
dispatch into capacity-padded ``[E * C, d]`` buffers, the grouped SwiGLU
expert FFN and the weighted combine are the reference's math; the FFN's three
products run on the ``grouped_matmul`` kernel.

The expert-parallel island runs every rank the mesh holds at once: the
batch is split over the DP axes slow-axis major (rank ``r`` holds rows
``[r*B/R, (r+1)*B/R)``, as ``P(("pod", "data"))`` shards it), routing and
dispatch run batched over the rank axis, and dispatch and combine go through
``comm.resolve_all_to_all`` (``direct`` or the plan).  EP axes equal DP axes
here, so rank ``r``'s local expert ``e`` is global expert ``r*E_loc + e`` and
one kernel launch per product serves every held rank.  On a ``LocalMesh``
that is all ``R`` ranks, and ``x [B, S, d]`` and the ``[E, ...]`` expert
stacks are the whole model's; on a ``ProcessMesh`` it is this process's
rank alone, ``x [B_loc, S, d]`` is its batch rows and the stacks hold its
``E_loc`` experts (``launch/shardings.py``), and the aux loss's mean goes
over the process group.

EP over one mesh axis or none (``_moe_pod_ep``: mixtral's 8 experts over
``pod``, dbrx's over ``data``, or experts replicated) runs the reference's
split-island form: routing, dispatch and the exchange per rank, then one
grouped FFN over the held ranks' tokens, then the return exchange and the
combine.  Over the slow axis the exchange may be int8 with a per-row f32
scale (``cfg.quantized_dispatch``).  On a ``LocalMesh`` the grid holds every
rank's tokens against all ``E`` experts; on a ``ProcessMesh`` it is this
process's own ``[E_loc, p * C, d]`` (the reference's island layout) against
the ``E_loc`` experts its shard holds, and equals the ``LocalMesh`` grid's
slice of those experts and of this process's other DP coordinates.

Under tensor parallelism (a ``ProcessMesh`` whose "model" axis is above 1,
``models/tp.py``) the expert stacks hold this process's slice of ``d_ff``,
``[E_loc, d, F/tp]`` and ``[E_loc, F/tp, d]``, as the reference's
``_MOE_TABLE`` shards them.  Routing, dispatch and the exchange run whole on
every model peer, bit for bit the same; the token grid enters the grouped
FFN through ``copy_in`` (never ``x``: the router's path to ``x`` is already
whole on every peer, and a copy there would add its share of ``dx`` ``tp``
times), and the FFN's partial output is summed over "model" on the grid,
before the return trip, as the reference's GSPMD sums it: the int8 return
exchange then quantizes the whole ``y``, and the gates' gradient reads it.
The local path sums too, also where ``moe_apply`` drops ``dist``.

Under ``pure_dp`` on a ``ProcessMesh`` with a "model" axis (weights whole
on every process, the batch cut over every axis) the layer runs as the
reference's ``shard_map`` over the DP axes alone hands it a ``(pod, data)``
shard: the model peers' rows are gathered over "model" in member order
(``tp.gather_rows``), routed, dispatched, exchanged and run through the
experts as that shard, every model peer alike (capacity, slot order and
the grid are those of the peers' rows together, the experts' ``d_ff``
whole), and each process keeps its own rows of the output.  The gather's
backward sums the peers' cotangents in member order; the gradient sync
sums the experts' over "model" (``launch/train._sync_grads``).

``dist=None`` runs the same math with one rank and no exchange; it is the
correctness oracle for the island.  ``use_kernel=False`` runs the plain
versions of the kernels on every path.

Every path is differentiable, as the reference's: the gates and the aux
loss carry gradients into the router, ``_dispatch``'s ``index_copy_`` and
``_combine``'s ``gather`` differentiate as the reference's ``.at[].set`` and
``y_buf[slot]`` (a dropped choice gets no gradient), the exchanges are
index copies, and the expert FFN's products differentiate through the
``grouped_matmul`` kernel.  The plan exchange's pack and unpack have no
gradient (neither has the reference's Pallas pack) and raise in the
backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..comm.all_to_all import resolve_all_to_all
from ..configs.registry import ModelConfig
from ..kernels.grouped_matmul import grouped_matmul_ref
# the kernel's differentiable form: without a gradient to take it is the
# plain wrapper call
from ..kernels.grouped_matmul import grouped_matmul_autograd as \
    grouped_matmul
from ..launch.mesh import ProcessMesh, pmean
from .dist import DistContext
from .layers import dense_init, param
from .tp import copy_in, gather_rows, model_coord, own_seq, row_parallel, \
    tp_mesh, tp_of, whole_seq

__all__ = ["MoE", "init_moe", "moe_apply"]


class MoE(nn.Module):
    """``router [d, E]`` in f32; expert stacks ``w_gate``/``w_up [E, d, f]``
    and ``w_down [E, f, d]``.

    Serving keeps the expert stacks in the compute dtype: they hold exactly
    what the reference's ``w.astype(dt)`` gives at each use
    (``moe.py:119-121``), cast once instead of per call, which halves their
    memory in bf16.  Training (``masters=True``) keeps them in ``dtype``
    (the config's ``param_dtype``), the masters AdamW updates, and
    ``_expert_ffn`` casts them at each use, as the reference does.
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device, masters: bool = False):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        wdt = dtype if masters else getattr(torch, cfg.compute_dtype)

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

    The top k are the first k of a stable descending sort: among equal
    probabilities the lower expert first, as ``lax.top_k`` orders them
    (``torch.topk`` picks another set, on the CPU, and documents no order on
    the card).  Returns (gates [G, T, k], eids [G, T, k], aux [G])."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = x_flat.float() @ router_w                         # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[..., :k], eids[..., :k]                # [G, T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss (fraction * mean prob).
    # one_hot's, compared on every device alike (F.one_hot validates the
    # ids on the host on the CPU, which a meta tensor cannot)
    top1 = eids[..., 0, None] == torch.arange(e, device=eids.device)
    frac = top1.float().mean(1)                                # [G, E]
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
                use_kernel: bool = True, tp=None) -> torch.Tensor:
    """tokens [E, C_tot, d] -> [E, C_tot, d] (grouped SwiGLU).

    ``counts [E]`` marks each expert's filled rows (the rest are zero and
    stay zero); None treats every row as valid.  ``tp`` (``_moe_tp``): the
    stacks hold a slice of ``d_ff``, and the partial output is summed over
    "model"."""
    dt = tokens.dtype
    gmm = grouped_matmul if use_kernel else grouped_matmul_ref
    tokens = copy_in(tp, tokens)
    h = F.silu(gmm(tokens, w_gate.to(dt), counts)) \
        * gmm(tokens, w_up.to(dt), counts)
    return row_parallel(tp, gmm, h, w_down.to(dt), counts)


def _moe_tp(cfg: ModelConfig, dist: Optional[DistContext], p: MoE):
    """The ``ProcessMesh`` to sum the FFN over when ``p``'s stacks hold a
    slice of ``d_ff``, else None."""
    return tp_of(tp_mesh(dist), p.w_down.shape[1], cfg.d_ff)


def _moe_island(cfg: ModelConfig, dist: DistContext, x: torch.Tensor,
                p: MoE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every held (pod, data) rank at once.  x: [R, B_loc, S, d] stacked
    (``R = 1`` on a ``ProcessMesh``); the expert stacks hold ``R * E_loc``
    experts."""
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
                    use_kernel=dist.use_kernel, tp=_moe_tp(cfg, dist, p))
    y = y.reshape(r, e_loc, g, cap, d).transpose(1, 2) \
        .reshape(r, g, e_loc * cap, d)
    y = a2a(y)                                        # return trip
    out = _combine(y.reshape(r, e * cap, d), slot, keep, gates, t,
                   cfg.moe.top_k)
    # Aux loss averaged over all ranks, as the reference's pmean (over the
    # process group on a ProcessMesh).
    aux = pmean(dist.mesh.sub(dist.dp_axes), aux, dist.dp_axes)[0]
    return out.reshape(r, b, s, d), aux


def _quantized(a2a):
    """``a2a`` of a buffer as per-row int8 with an f32 scale, exchanged as
    two tensors (the reference's ``_exchange``): the scale is computed in
    the buffer's dtype, and the result is dequantized in it."""
    def exchange(buf: torch.Tensor) -> torch.Tensor:
        scale = torch.clamp(buf.abs().amax(-1, keepdim=True), min=1e-6) \
            / 127.0
        q = torch.clamp(torch.round(buf / scale), -127, 127).to(torch.int8)
        return a2a(q).to(buf.dtype) * a2a(scale.float()).to(buf.dtype)
    return exchange


def _pod_ep_exchange(cfg: ModelConfig, dist: DistContext, mesh,
                     ep_axis: str, slow: bool):
    """The exchange over the one EP axis: the rotation schedule (or the
    plan's stages) over the slow axis, a flat all-to-all over a fast one;
    int8 over the slow axis under ``cfg.quantized_dispatch``."""
    a2a = resolve_all_to_all(
        mesh=mesh, slow_axis=ep_axis if slow else None, ep_axes=(ep_axis,),
        impl=dist.a2a_impl, plan=dist.plan if slow else None,
        use_kernel=dist.use_kernel)
    return _quantized(a2a) if cfg.quantized_dispatch and slow else a2a


def _moe_pod_ep(cfg: ModelConfig, dist: DistContext, x: torch.Tensor,
                p: MoE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-island MoE with EP over one DP axis (``p_pods`` = its size) or
    none (``p_pods = 1``: experts replicated), every held rank at once.

    Per rank (x split over the DP axes, slow-axis major): route, dispatch
    into ``[p_pods, E_loc * C, d]`` and exchange over the EP axis; the
    capacity ``C`` comes from the rank's own token count (the reference's
    ``t_loc``).  Rank ``r`` then holds, for each of its ``E_loc`` experts,
    the tokens of the ``p_pods`` ranks that share its other coordinates.
    Its EP coordinate ``c`` names its experts ``c * E_loc + e``, so the held
    ranks' tokens are laid out as ``[ep dim, E_loc, other dp dims, p_pods,
    C, d]``: on a ``LocalMesh`` (every rank held) that is ``[E, R * C, d]``
    against all ``E`` experts, on a ``ProcessMesh`` (every dim 1 but its
    own ``E_loc`` and ``p_pods``) ``[E_loc, p_pods * C, d]`` against its
    shard's ``E_loc``.  One grouped-FFN launch per product serves the grid;
    the return trip runs the inverse.  x: ``[B, S, d]``, the held ranks'
    rows (B divisible by their number).
    """
    mesh = dist.mesh.sub(dist.dp_axes)
    ep_axis = dist.ep_axes[0] if dist.ep_axes else None
    p_pods = mesh.axis_size(ep_axis) if ep_axis else 1
    r = mesh.local_size
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    e_loc = e // p_pods
    b, s, d = x.shape
    t = b * s // r
    cap = _capacity(cfg, t, e)
    x_flat = x.reshape(r, t, d)
    gates, eids, aux = _route(cfg, p.router, x_flat)
    buf, slot, keep = _dispatch(x_flat, eids, cap, e)
    exchange = None
    if p_pods > 1:
        exchange = _pod_ep_exchange(cfg, dist, mesh, ep_axis,
                                    ep_axis == dist.slow_axis)
    recv = buf.reshape(r, p_pods, e_loc * cap, d)
    if exchange is not None:
        recv = exchange(recv)

    # [*held dp dims, p_pods, E_loc, C, d] -> [ep dim, E_loc, other held dp
    # dims, p_pods, C, d] -> [held experts, rows, d]
    held = mesh.local_shape
    n = len(held)
    lead = [mesh.axis_names.index(ep_axis)] if ep_axis else []
    perm = lead + [n + 1] + [i for i in range(n) if i not in lead] \
        + [n, n + 2, n + 3]
    grid = recv.reshape(*held, p_pods, e_loc, cap, d).permute(perm)
    e_held = e_loc * (held[lead[0]] if lead else 1)
    tokens = grid.reshape(e_held, -1, d).contiguous()
    if tokens.shape[0] != p.w_gate.shape[0]:
        raise ValueError(
            f"the grid holds {tokens.shape[0]} experts' tokens and the "
            f"expert stacks {p.w_gate.shape[0]}: a ProcessMesh needs its "
            f"shard's E_loc = {e_loc} experts (convert.shard_module)")
    y = _expert_ffn(cfg, p.w_gate, p.w_up, p.w_down, tokens,
                    use_kernel=dist.use_kernel, tp=_moe_tp(cfg, dist, p))
    inv = [perm.index(i) for i in range(len(perm))]
    y = y.reshape(grid.shape).permute(inv).reshape(r, p_pods, e_loc * cap, d)
    if exchange is not None:
        y = exchange(y)                               # return trip
    out = _combine(y.reshape(r, e * cap, d), slot, keep, gates, t, k)
    aux = pmean(mesh, aux, dist.dp_axes)[0]
    return out.reshape(b, s, d), aux


def _held_ranks(dist: DistContext) -> int:
    """DP ranks this process holds: all on a LocalMesh, one on a
    ProcessMesh (where ``x`` is already this rank's batch rows)."""
    return dist.mesh.sub(dist.dp_axes).local_size


def _row_peers(dist: Optional[DistContext]) -> Optional[ProcessMesh]:
    """The ``ProcessMesh`` whose model peers' rows a ``pure_dp`` MoE takes
    together (one ``(pod, data)`` shard), else None (also under ``pure_dp``
    with FSDP, whose batch the model peers share)."""
    if dist is None or not dist.pure_dp or dist.fsdp is not None \
            or not isinstance(dist.mesh, ProcessMesh) \
            or "model" not in dist.mesh.axis_names \
            or dist.mesh.axis_size("model") == 1:
        return None
    return dist.mesh


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              dist: Optional[DistContext] = None, *,
              use_kernel: bool = True, sp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,d], aux_loss scalar).

    The kernels run unless ``use_kernel`` or ``dist.use_kernel`` is
    False.  Under SP (``sp``, a ``tp.SeqShard``) ``x`` is this process's
    sequence chunk: the block gathers the whole sequence (``whole_seq``:
    routing, capacity and dispatch see whole sequences, as the reference's
    ``shard_map`` hands them, every model peer alike) and keeps its chunk of
    the output (``own_seq``)."""
    if sp is not None:
        y, aux = moe_apply(cfg, p, whole_seq(sp, x), dist,
                           use_kernel=use_kernel)
        return own_seq(sp, y), aux
    peers = _row_peers(dist)
    if peers is None:
        return _moe_rows(cfg, p, x, dist, use_kernel)
    b = x.shape[0]
    y, aux = _moe_rows(cfg, p, gather_rows(peers, x), dist, use_kernel)
    return y.narrow(0, model_coord(peers) * b, b), aux


def _moe_rows(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              dist: Optional[DistContext], use_kernel: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` of the rows one ``(pod, data)`` shard holds."""
    tp = _moe_tp(cfg, dist, p)   # the local path below sums over "model" too
    if dist is not None:
        if not use_kernel and dist.use_kernel:
            dist = dataclasses.replace(dist, use_kernel=False)
        use_kernel = dist.use_kernel
        if x.shape[0] % _held_ranks(dist) != 0:
            # batch does not divide the DP shards: run the local path
            dist = None
    if dist is not None and (
            dist.ep_axes is None or len(dist.ep_axes) == 1):
        # single-axis EP (mixtral: pod; dbrx: data) or no EP
        return _moe_pod_ep(cfg, dist, x, p)
    if dist is None or dist.ep_size == 1:
        b, s, d = x.shape
        e = cfg.moe.num_experts
        x_flat = x.reshape(1, b * s, d)
        gates, eids, aux = _route(cfg, p.router, x_flat)
        cap = _capacity(cfg, b * s, e)
        buf, slot, keep = _dispatch(x_flat, eids, cap, e)
        # each expert's routed rows (bincount's, by a scatter: its shape
        # does not depend on the ids, so it runs on meta tensors too)
        ids = eids.reshape(-1)
        counts = torch.zeros(e, dtype=ids.dtype, device=ids.device) \
            .index_add_(0, ids, torch.ones_like(ids)) \
            .clamp(max=cap).to(torch.int32)
        y = _expert_ffn(cfg, p.w_gate, p.w_up, p.w_down,
                        buf.reshape(e, cap, d), counts, use_kernel, tp)
        out = _combine(y.reshape(1, e * cap, d), slot, keep, gates, b * s,
                       cfg.moe.top_k)
        return out.reshape(b, s, d), aux[0]

    if tuple(dist.ep_axes) != tuple(dist.dp_axes):
        raise ValueError(f"the island needs EP axes {dist.ep_axes} equal to "
                         f"the DP axes {dist.dp_axes}")
    r = _held_ranks(dist)
    b, s, d = x.shape
    out, aux = _moe_island(cfg, dist, x.reshape(r, b // r, s, d), p)
    return out.reshape(b, s, d), aux
