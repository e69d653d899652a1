"""Tensor parallelism over the "model" axis of a ``ProcessMesh``.

The reference gets TP from GSPMD through its specs (``launch/shardings.py``:
attention heads, the FFN hidden dim, the experts' ``d_ff`` and the
vocabulary over "model"); here each process holds its slice of those
weights (``convert.shard_module``) and the model code runs on its slice
between two operators, each an ``autograd.Function``:

* ``copy_in``: the identity forward; backward, the sum of the cotangents
  over "model" (every peer's slice read the same input).
* ``sum_out``: the sum over "model" forward (every peer holds a partial
  product); backward, the identity.

Both sums add the peers' parts in member order (``launch/mesh.member_sum``,
in f32), so every model peer holds the same bits: two peers whose residual
streams differ by an ulp could route a token differently.  An all-reduce's
order is the backend's and gives no such promise.  Beyond two peers a sum
is a scatter of ``1 / n`` chunks, each peer's member-order sum of its
chunk, and a gather of the sums (about twice the operand's bytes a process
at any ``n``); a small operand's sum is one gather of every peer's.
``max_over`` (the cross entropy's shift) and ``argmax_over`` (greedy
decoding over vocabulary shards, the lowest global index first among
ties, as ``torch.argmax`` and ``jnp.argmax``) complete the set.  ``gather_cols`` joins the peers' column slices of a projection
(the keys' and values' ``K·dh`` columns where "model" cuts through a kv
head, the queries' where it cuts through a query head, as the reference's
GSPMD gathers them after the projection); its
backward sums the cotangent over "model" in member order, keeping this
process's slice (the scatter alone).  ``q_heads`` names the query heads
that a process's ``wq`` columns touch (one or two whole heads where
"model" cuts through a query head: each process then gathers the peers'
query columns, computes those heads and keeps its own columns of their
output), and ``kv_heads`` the kv heads those query heads read.
``channels`` names the channels a process owns of a per-channel width (the
recurrent blocks' state, ``models/ssm.py``).  ``gather_rows`` joins the
model peers' batch rows (``pure_dp``'s MoE, which routes a ``(pod, data)``
shard's rows together as the reference's ``shard_map`` over the DP axes
hands them); its backward is the same member-order scatter as
``gather_cols``'.  Each operator's collectives run inside a
``procmesh.tp_*`` profiler range (a sum's two beyond two peers inside
``procmesh.tp_*:scatter`` and ``:gather`` within it), a backward's inside
``procmesh.tp_*.bwd``.

Sequence parallelism's operators (``SeqShard``, ``gather_seq``,
``scatter_seq``, ``whole_seq``, ``own_seq``, ``enter``, ``leave``) close
the module; their section says how they keep TP's bits.

``tp`` below is the ``ProcessMesh`` whose "model" group the collectives run
over, or None: on a ``LocalMesh`` (which keeps whole weights), where
"model" has size 1, or for a leaf its spec keeps whole, every operator is
the identity (``tp_of``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..launch.mesh import ProcessMesh, all_gather, all_to_all, member_sum

__all__ = ["tp_mesh", "tp_of", "vocab_slice", "copy_in", "sum_out",
           "row_parallel", "gather_cols", "gather_rows", "channels",
           "q_heads", "kv_heads", "model_coord", "max_over", "argmax_over",
           "SeqShard", "seq_shard", "gather_seq", "scatter_seq",
           "whole_seq", "own_seq", "enter", "leave"]

AXIS = ("model",)


def tp_mesh(dist) -> Optional[ProcessMesh]:
    """The mesh of ``dist`` (a ``DistContext`` or None) when it runs TP
    (``dist.tp_size > 1``), else None."""
    if dist is None or dist.tp_size == 1:
        return None
    return dist.mesh


def tp_of(tp: Optional[ProcessMesh], local: int, whole: int
          ) -> Optional[ProcessMesh]:
    """``tp`` for a leaf whose sharded dim holds ``local`` of ``whole``
    entries here: None when the leaf is whole (its spec replicates it, as
    ``_drop_uneven`` does for a dim "model" does not divide).  A slice with
    no mesh to sum it over raises."""
    if local == whole:
        return None
    if tp is None:
        raise ValueError(f"a weight sharded over 'model' ({local} of "
                         f"{whole}) needs its ProcessMesh in the DistContext")
    return tp


def model_coord(tp: ProcessMesh) -> int:
    """This process's coordinate on "model"."""
    return tp.rank_coords[tp.axis_names.index("model")]


def vocab_slice(tp: ProcessMesh, ids: torch.Tensor, n_loc: int):
    """(the ids as rows of this process's contiguous ``n_loc``-row slice
    of the vocabulary, 0 for the ids outside it; whether each id is
    inside)."""
    local = ids - model_coord(tp) * n_loc
    owned = (local >= 0) & (local < n_loc)
    return torch.where(owned, local, torch.zeros_like(local)), owned


def _gather(tp: ProcessMesh, x: torch.Tensor, span: str,
            axes: Tuple[str, ...] = AXIS) -> torch.Tensor:
    """``[n, *x.shape]``: every peer's ``x`` over ``axes`` (default
    "model"), by combined coordinate."""
    with torch.no_grad():
        return all_gather(tp, x.unsqueeze(0), axes, span=span)[0]


def _scatter_sum(tp: ProcessMesh, chunks: torch.Tensor, span: str,
                 axes: Tuple[str, ...] = AXIS) -> torch.Tensor:
    """This process's chunk of the peers' ``chunks [n, ...]`` over ``axes``
    (default "model"; chunk ``j`` for combined coordinate ``j``): the
    peers' copies of it added in member order in f32, rounded to the
    chunks' dtype (a reduce-scatter whose bits do not depend on the
    backend)."""
    with torch.no_grad():
        got = all_to_all(tp, chunks.unsqueeze(0), axes, span=span)[0]
    return member_sum(p.float() for p in got).to(chunks.dtype)


# a sum whose gather of every peer's operand moves at most this many bytes
# a process takes that one collective instead of a scatter and a gather:
# decode's sums are a few KB, where a collective's latency, not its bytes,
# sets the time
GATHER_SUM_MAX_BYTES = 1 << 22


def _sum(tp: ProcessMesh, x: torch.Tensor, span: str) -> torch.Tensor:
    """The peers' ``x`` added in member order in f32, rounded to ``x``'s
    dtype (the same bits either way).  Two peers, or a gather of every
    peer's ``x`` within ``GATHER_SUM_MAX_BYTES``, gather each other's
    ``x`` in one collective.  More peers on a larger ``x`` each add their
    ``1 / n`` of the elements (``_scatter_sum``), then gather the sums:
    about twice ``x``'s bytes in two collectives, where a gather of every
    peer's ``x`` would move ``n`` times them (at 16 peers more than the
    card holds for the MoE's grid)."""
    n = tp.axis_size("model")
    if n <= 2 or n * x.numel() * x.element_size() <= GATHER_SUM_MAX_BYTES:
        parts = _gather(tp, x.contiguous(), span)
        return member_sum(p.float() for p in parts).to(x.dtype)
    with torch.profiler.record_function(span):
        flat = x.reshape(-1)
        pad = -flat.numel() % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        mine = _scatter_sum(tp, flat.reshape(n, -1), f"{span}:scatter")
        whole = _gather(tp, mine, f"{span}:gather").reshape(-1)
    return whole[:x.numel()].reshape(x.shape)


class _CopyIn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tp, x):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _sum(ctx.tp, g, "procmesh.tp_copy.bwd")


class _SumOut(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tp, x):
        return _sum(tp, x, "procmesh.tp_sum")

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherCols(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tp, x):
        ctx.tp = tp
        parts = _gather(tp, x.contiguous(), "procmesh.tp_gather")
        return parts.movedim(0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        n = ctx.tp.axis_size("model")
        chunks = g.reshape(*g.shape[:-1], n, -1).movedim(-2, 0)
        return None, _scatter_sum(ctx.tp, chunks.contiguous(),
                                  "procmesh.tp_gather.bwd")


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tp, x):
        ctx.tp = tp
        parts = _gather(tp, x.contiguous(), "procmesh.tp_gather_rows")
        return parts.reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        n = ctx.tp.axis_size("model")
        chunks = g.reshape(n, -1, *g.shape[1:])
        return None, _scatter_sum(ctx.tp, chunks.contiguous(),
                                  "procmesh.tp_gather_rows.bwd")


def copy_in(tp: Optional[ProcessMesh], x: torch.Tensor) -> torch.Tensor:
    """Enter the TP region: ``x`` as it is; its gradient summed over
    "model"."""
    return x if tp is None else _CopyIn.apply(tp, x)


def sum_out(tp: Optional[ProcessMesh], x: torch.Tensor) -> torch.Tensor:
    """Leave the TP region: the peers' partial ``x`` summed over "model"
    (member order); the gradient passes unchanged."""
    return x if tp is None else _SumOut.apply(tp, x)


def row_parallel(tp: Optional[ProcessMesh], product, x: torch.Tensor,
                 w: torch.Tensor, *extra, sp: Optional["SeqShard"] = None
                 ) -> torch.Tensor:
    """A row-parallel product: ``product(x, w, *extra)`` on this process's
    slice of the contraction (``x``'s last dim, ``w``'s second to last:
    attention's ``wo``, the MLP's and the experts' ``w_down``), each
    peer's partial output rounded to its dtype, then ``sum_out``; under
    sequence parallelism (``sp``) ``leave``: its chunk of the sum."""
    return leave(tp, sp, product(x, w, *extra))


def gather_cols(tp: Optional[ProcessMesh], x: torch.Tensor) -> torch.Tensor:
    """``[..., n · c]``: every model peer's ``x [..., c]`` (a column slice)
    joined along the last dim by model coordinate, no arithmetic; its
    gradient summed over "model" in member order (f32), this process's
    ``c`` columns kept."""
    return x if tp is None else _GatherCols.apply(tp, x)


def gather_rows(tp: Optional[ProcessMesh], x: torch.Tensor) -> torch.Tensor:
    """``[n · B, ...]``: every model peer's ``x [B, ...]`` joined along the
    first dim by model coordinate; its gradient summed over "model" in
    member order (f32), this process's ``B`` rows kept."""
    return x if tp is None else _GatherRows.apply(tp, x)


def channels(tp: Optional[ProcessMesh], width: int) -> slice:
    """The channels ``[m · c, (m + 1) · c)`` of ``width`` that model
    coordinate ``m`` owns (``c = width / n``, as a spec over "model" cuts a
    per-channel dim); every channel without ``tp``."""
    if tp is None:
        return slice(0, width)
    c = width // tp.axis_size("model")
    return slice(model_coord(tp) * c, (model_coord(tp) + 1) * c)


def q_heads(n_heads: int, dh: int, cols: int, coord: int
            ) -> Tuple[range, int]:
    """(the query heads that model coordinate ``coord``'s ``cols`` columns
    of ``wq`` touch, a range; the offset of those columns in the first of
    them): the columns ``[coord · cols, (coord + 1) · cols)`` of ``n_heads``
    heads of ``dh``, which cut through a head where ``dh`` does not divide
    them (internvl2-1b's 56 of a 64-wide head at 16)."""
    start = coord * cols
    heads = range(start // dh, -(-(start + cols) // dh))
    if heads.stop > n_heads:
        raise ValueError(f"columns [{start}, {start + cols}) lie past "
                         f"{n_heads} heads of {dh}")
    return heads, start - heads.start * dh


def kv_heads(n_heads: int, n_kv_heads: int, n: int = 1, coord: int = 0,
             *, heads: Optional[range] = None) -> Tuple[int, ...]:
    """The kv heads that a range of query heads read, in order: ``heads``,
    or those that model coordinate ``coord`` of ``n`` touches (``q_heads``
    of its ``n_heads / n`` heads' worth of columns: every head for ``n``
    1, ``n_heads / n`` whole ones where ``n`` divides ``n_heads``).
    Global q head ``i`` reads kv head ``i // (n_heads / n_kv_heads)``.
    One entry a kv head when each is read by as many of those q heads (the
    ``j``-th of them then reads entry ``j // (len(heads) / entries)``);
    else, where the range's edge cuts a GQA group, one entry a q head."""
    if heads is None:
        heads = range(coord * n_heads // n, -(-(coord + 1) * n_heads // n))
    h, group = len(heads), n_heads // n_kv_heads
    per_q = tuple(i // group for i in heads)
    sel = tuple(sorted(set(per_q)))
    if h % len(sel) or any(per_q.count(k) != h // len(sel) for k in sel):
        return per_q
    return sel


def max_over(tp: ProcessMesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of the peers' ``x`` (no gradient: the cross
    entropy's shift, which its value does not depend on)."""
    return _gather(tp, x.detach(), "procmesh.tp_max").amax(0)


def argmax_over(tp: Optional[ProcessMesh], logits: torch.Tensor
                ) -> torch.Tensor:
    """``[...]`` int64: the global index of the largest of ``logits
    [..., V_loc]``, this process's contiguous slice of the vocabulary,
    over every model peer's slice; among equal values the lowest global
    index, as ``torch.argmax`` over the whole row."""
    idx = logits.argmax(-1)
    if tp is None:
        return idx
    best = logits.gather(-1, idx[..., None])[..., 0]
    glob = idx + model_coord(tp) * logits.shape[-1]
    both = _gather(tp, torch.stack([best.double(), glob.double()]),
                   "procmesh.tp_argmax")                 # [n, 2, ...]
    # the first peer holding the largest value: ties go to the lowest
    # coordinate, whose slice holds the lower indices
    pick = both[:, 0].argmax(0, keepdim=True)
    return both[:, 1].gather(0, pick)[0].long()


# -- sequence parallelism ------------------------------------------------------
#
# Under ``cfg.seq_shard_activations`` (Megatron's SP, the reference's
# ``act_seq = "model"``) the residual stream between the TP regions lies on
# a sequence chunk: process ``m`` of ``n`` holds rows ``[m·L, (m+1)·L)`` of
# ``[B, S, d]``, ``L = ceil(S / n)``, the last chunks padded with zero rows
# that no output reads.  A region's entry gathers the chunks (``gather_seq``)
# where ``copy_in`` stood and its exit keeps this process's chunk of the
# member-order sum (``scatter_seq``) where ``sum_out`` stood: each element
# is the same f32 sum in the same order, and a norm or a residual add on a
# chunk computes each row as on the whole, so the bits are TP's.  A region
# whose weights are whole (every peer computes the same output, as the MoE
# block and a leaf ``_drop_uneven`` keeps whole) enters through
# ``whole_seq`` and leaves through ``own_seq`` instead: no sum either way.


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """The sequence chunks of a ``length``-row sequence over ``mesh``'s
    "model" axis; ``whole``, when set, is the gathered sequence of the
    tensor a region enters with (a block that feeds one input to two
    regions gathers it once)."""

    mesh: ProcessMesh
    length: int
    whole: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      compare=False)

    @property
    def n(self) -> int:
        return self.mesh.axis_size("model")

    @property
    def chunk(self) -> int:
        """``L``: the rows of every process's chunk, padding included."""
        return -(-self.length // self.n)

    @property
    def start(self) -> int:
        """The first row of this process's chunk."""
        return model_coord(self.mesh) * self.chunk

    def chunks(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, B, L, ...]``: ``x [B, S, ...]`` padded with zero rows to
        ``n · L`` and cut into the chunks, by model coordinate."""
        pad = self.n * self.chunk - x.shape[1]
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[0], pad, *x.shape[2:])], 1)
        return x.reshape(x.shape[0], self.n, self.chunk, *x.shape[2:]) \
            .movedim(1, 0).contiguous()

    def join(self, parts: torch.Tensor) -> torch.Tensor:
        """``[B, S, ...]``: the chunks ``parts [n, B, L, ...]`` in order,
        the padding cut."""
        whole = parts.movedim(0, 1).reshape(parts.shape[1], -1,
                                            *parts.shape[3:])
        # contiguous, as the whole tensor a TP run holds: a product reads
        # a strided operand with other roundings
        return whole[:, :self.length].contiguous()

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This process's chunk ``[B, L, ...]`` of ``x [B, S, ...]``, a
        copy padded with zero rows past ``S`` (no gradient of its own: for
        inputs, positions and masks)."""
        part = x[:, min(self.start, x.shape[1]):self.start + self.chunk]
        pad = self.chunk - part.shape[1]
        if pad:
            part = torch.cat([part, part.new_zeros(
                part.shape[0], pad, *part.shape[2:])], 1)
        return part.contiguous()

    def gathered(self, x: torch.Tensor) -> "SeqShard":
        """This shard with ``whole`` set to the chunks of ``x`` gathered
        (no gradient: each region's entry takes its own backward)."""
        parts = _gather(self.mesh, x.detach().contiguous(),
                        "procmesh.tp_gather_seq")
        return dataclasses.replace(self, whole=self.join(parts))


def seq_shard(dist, length: int) -> Optional[SeqShard]:
    """The ``SeqShard`` of a ``length``-row sequence when ``dist`` runs SP
    (``dist.seq_shard`` with TP over "model", ``tp_size > 1``; never under
    ``pure_dp``, as the reference's ``act_seq`` is None there), else None.
    A decode step (one row) keeps its residual whole."""
    tp = tp_mesh(dist)
    if tp is None or not dist.seq_shard or length < 2:
        return None
    return SeqShard(tp, length)


class _GatherSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sp, x, whole):
        ctx.sp = sp
        if whole is not None:
            return whole.view_as(whole)
        parts = _gather(sp.mesh, x.contiguous(), "procmesh.tp_gather_seq")
        return sp.join(parts)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        return None, _scatter_sum(sp.mesh, sp.chunks(g),
                                  "procmesh.tp_gather_seq.bwd"), None


class _ScatterSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sp, x):
        ctx.sp = sp
        return _scatter_sum(sp.mesh, sp.chunks(x), "procmesh.tp_scatter_seq")

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        parts = _gather(sp.mesh, g.contiguous(),
                        "procmesh.tp_scatter_seq.bwd")
        return None, sp.join(parts)


class _WholeSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sp, x, whole):
        ctx.sp = sp
        if whole is not None:
            return whole.view_as(whole)
        parts = _gather(sp.mesh, x.contiguous(), "procmesh.tp_whole_seq")
        return sp.join(parts)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.sp.own(g), None


class _OwnSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sp, x):
        ctx.sp = sp
        return sp.own(x)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        parts = _gather(sp.mesh, g.contiguous(), "procmesh.tp_own_seq.bwd")
        return None, sp.join(parts)


def gather_seq(sp: SeqShard, x: torch.Tensor) -> torch.Tensor:
    """``[B, S, ...]``: the peers' chunks ``x [B, L, ...]`` joined along
    the sequence by model coordinate, no arithmetic (``sp.whole`` when
    set, with no collective); its gradient summed over "model" in member
    order (f32), this process's chunk kept: the entry of a TP region whose
    peers each give a partial cotangent."""
    return _GatherSeq.apply(sp, x, sp.whole)


def scatter_seq(sp: SeqShard, x: torch.Tensor) -> torch.Tensor:
    """``[B, L, ...]``: this process's chunk of the peers' partial ``x [B,
    S, ...]`` summed over "model" in member order (f32); its gradient the
    peers' cotangent chunks joined."""
    return _ScatterSeq.apply(sp, x)


def whole_seq(sp: SeqShard, x: torch.Tensor) -> torch.Tensor:
    """``gather_seq``'s forward, for a region every peer computes whole:
    the peers' cotangents are the same, so the backward keeps this
    process's chunk of its own, with no sum."""
    return _WholeSeq.apply(sp, x, sp.whole)


def own_seq(sp: SeqShard, x: torch.Tensor) -> torch.Tensor:
    """This process's chunk of ``x [B, S, ...]``, which every peer holds
    whole; its gradient the peers' cotangent chunks joined."""
    return _OwnSeq.apply(sp, x)


def enter(tp: Optional[ProcessMesh], sp: Optional[SeqShard],
          x: torch.Tensor) -> torch.Tensor:
    """A region's input: ``copy_in`` without SP; under SP the whole
    sequence, by ``gather_seq`` into a TP region (``tp``) or ``whole_seq``
    into a whole one."""
    if sp is None:
        return copy_in(tp, x)
    return gather_seq(sp, x) if tp is not None else whole_seq(sp, x)


def leave(tp: Optional[ProcessMesh], sp: Optional[SeqShard],
          x: torch.Tensor) -> torch.Tensor:
    """A region's output: ``sum_out`` without SP; under SP this process's
    chunk, of the sum over "model" (``scatter_seq``) out of a TP region or
    of ``x`` (``own_seq``) out of a whole one."""
    if sp is None:
        return sum_out(tp, x)
    return scatter_seq(sp, x) if tp is not None else own_seq(sp, x)
