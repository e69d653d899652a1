"""Decoder-only LM assembly for every non-enc-dec family: init, the
training forward and loss, prefill with a decode cache, and the one-token
decode step, for the block kinds "dense", "moe", "hybrid" (attention and a
Mamba head side by side, their normalized outputs averaged), "m" and "s"
(xLSTM's mLSTM and sLSTM, ``models/ssm.py``).

Counterpart of ``src/repro/models/transformer.py``.  Parameters live in an
``LM`` module whose attribute paths are the reference's pytree paths
(``embed``, ``final_norm.scale``, ``lm_head``, ``blocks.<i>.attn.wq``, ...).
Blocks are always a list: a stacked (``scan_layers``) reference layout
converts to it (``convert.py``), and the per-layer math is the same, including
the scan branch's window rules for mixed full/window stacks.  The decode cache
is a list of per-layer dicts, updated in place: ``{"k", "v"}`` for attention,
plus ``"ssm"`` (Mamba's state) for the hybrid, ``{"state"}`` for the
recurrent kinds.
``use_kernel=False`` runs the plain PyTorch versions of every kernel on the
path (prefill attention, the expert FFN and the exchange's pack and unpack),
with or without a mesh.

``lm_forward`` / ``lm_loss`` are the reference's training forward and loss:
with ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
(non-reentrant), and with ``cfg.remat_group`` each group of that many
layers is checkpointed around its checkpointed layers (the reference's
two-level remat).  The backward then runs every layer's forward again,
routing included, on the same deterministic kernels.  Under a gradient
the embedding table is cast to the compute dtype, then gathered, as the
reference does, so a repeated token's gradient sums in the compute dtype
in both; serving gathers, then casts only the rows it took (the same
values).

Under tensor parallelism (``dist.tp_size > 1`` on a ``ProcessMesh``;
``models/tp.py``) each leaf follows its spec: attention, the MLP and the
experts run on this process's slice (``layers.py``, ``moe.py``); a
vocabulary-sharded ``embed`` looks up this process's rows, writes zero for
ids outside them and sums over "model" (exact: one peer contributes); the
head gives this process's vocabulary shard of the logits (the tied head is
its ``embed`` shard's transpose), and ``lm_loss`` is then a
vocabulary-parallel cross entropy.  Attention runs on the query heads that
this process's ``wq`` columns touch, whole heads or, where "model" cuts
through one, the one or two that its columns reach into (``layers.py``).
The prefill's cache, and so the decode cache, holds the kv heads those
query heads read (``layers._heads``): its own where "model" divides the kv
heads, else gathered over "model" and replicated on the peers that share
one.  A leaf its spec keeps whole (an odd vocabulary, internvl2-1b's
151655 rows; every attention leaf of a width "model" does not divide)
takes the whole path, with no collective.  The recurrent blocks and the
hybrid's Mamba run on this process's slice too (``models/ssm.py``), and
their decode states hold its channels or touched heads
(``init_decode_cache`` with a shard sizes them).  The vision stub's
``patch_embeds`` take the first positions on every process, as without
TP.  ``models/encdec.py`` reuses the vocabulary-parallel lookup and loss.

Under sequence parallelism (``cfg.seq_shard_activations`` with TP; the
reference's ``act_seq = "model"``) the residual stream between the TP
regions is this process's chunk of the sequence (``tp.SeqShard``, from
``tp.seq_shard``): the embedding's lookup leaves through the chunk's
sum, the norms, the residual adds and the hybrid's ``_fuse`` run on the
chunk, each region gathers the sequence on entry and keeps its chunk of
the sum on exit (``tp.enter`` / ``tp.leave``), the hybrid gathers its
``h`` once for attention and Mamba, the MoE block gathers the whole
sequence before the router, and the head gathers it after the final
norm.  The bits are TP's.  A decode step keeps its residual whole.  Under
FSDP each block gathers its stored slices at its start
(``fsdp.gather_params``, inside the function ``_remat`` wraps, so the
backward gathers them again), and the model's own leaves are gathered
once a forward (``fsdp.gather_top``: the tied table's lookup and head
share one gather).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.registry import ModelConfig
from .dist import DistContext
from .layers import (
    MLP,
    Attention,
    Norm,
    assemble_kv_cache,
    attention_apply,
    attention_decode,
    embed_init,
    mlp_apply,
    norm_apply,
    param,
    take_rows,
)
from .fsdp import gather_params, gather_top, whole_shapes
from .moe import MoE, moe_apply
from .tp import SeqShard, argmax_over, enter, leave, max_over, seq_shard, \
    sum_out, tp_mesh, tp_of, vocab_slice
from .ssm import (
    MLSTM, SLSTM, Mamba,
    mamba_apply, mamba_decode, mamba_zero_state,
    mlstm_apply, mlstm_decode, mlstm_zero_state,
    slstm_apply, slstm_decode, slstm_zero_state,
)

__all__ = [
    "LM", "layer_kinds", "init_lm", "lm_forward", "lm_loss",
    "init_decode_cache", "lm_decode_step", "lm_prefill", "greedy_tokens",
]


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.family == "ssm":
        if not (cfg.block_pattern and
                len(cfg.block_pattern) == cfg.n_layers):
            raise ValueError(f"{cfg.name}: block_pattern must name each of "
                             f"the {cfg.n_layers} layers")
        return tuple(cfg.block_pattern)
    if cfg.family == "hybrid":
        return ("hybrid",) * cfg.n_layers
    if cfg.family == "moe":
        return ("moe",) * cfg.n_layers
    return ("dense",) * cfg.n_layers


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator,
                 device, masters: bool = False):
        super().__init__()
        d = cfg.d_model
        pdt = getattr(torch, cfg.param_dtype)
        self.norm1 = Norm(cfg, d, device)
        if kind == "m":
            self.mlstm = MLSTM(cfg, gen, pdt, device)
            return
        if kind == "s":
            self.slstm = SLSTM(cfg, gen, pdt, device)
            return
        self.attn = Attention(cfg, gen, pdt, device)
        self.norm2 = Norm(cfg, d, device)
        if kind == "moe":
            self.moe = MoE(cfg, gen, pdt, device, masters)
        elif kind == "hybrid":
            self.mamba = Mamba(cfg, gen, pdt, device)
            self.fuse_norm_attn = Norm(cfg, d, device)
            self.fuse_norm_ssm = Norm(cfg, d, device)
            self.mlp = MLP(cfg, gen, pdt, device)
        else:
            self.mlp = MLP(cfg, gen, pdt, device)


class LM(nn.Module):
    """The parameters.  ``train=True`` keeps every parameter in
    ``cfg.param_dtype`` (the expert stacks too: the masters AdamW updates)
    and lets autograd take their gradients; serving keeps the expert stacks
    in the compute dtype, frozen."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 train: bool = False):
        super().__init__()
        pdt = getattr(torch, cfg.param_dtype)
        self.embed = param(embed_init(gen, cfg.vocab, cfg.d_model, pdt,
                                      device))
        self.final_norm = Norm(cfg, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = param(embed_init(gen, cfg.vocab, cfg.d_model, pdt,
                                            device).T.contiguous())  # [d, V]
        self.blocks = nn.ModuleList(
            Block(cfg, kind, gen, device, train) for kind in layer_kinds(cfg))
        self.requires_grad_(train)


def init_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda",
            train: bool = False) -> LM:
    return LM(cfg, gen, device, train)


def _window_args(cfg: ModelConfig, full_flag: bool
                 ) -> Tuple[Optional[int], bool]:
    """(window size or None, use_window flag)."""
    if cfg.swa_window is None:
        return None, False
    return (None, False) if full_flag else (cfg.swa_window, True)


def _full_flag(cfg: ModelConfig, i: int) -> bool:
    """Layer ``i``'s full-attention override.  The reference's scanned stack
    carries it as a traced value, which its cache rules read as False."""
    return (not cfg.scan_layers) and i in cfg.full_attn_layers


def _recurrent(kind: str):
    """(apply, decode, attribute) of a recurrent block kind."""
    if kind == "m":
        return mlstm_apply, mlstm_decode, "mlstm"
    return slstm_apply, slstm_decode, "slstm"


def _fuse(cfg: ModelConfig, p: Block, attn_out: torch.Tensor,
          ssm: torch.Tensor) -> torch.Tensor:
    """The hybrid's mix of its attention and Mamba outputs."""
    return 0.5 * (norm_apply(cfg, p.fuse_norm_attn, attn_out)
                  + norm_apply(cfg, p.fuse_norm_ssm, ssm))


def _ffn(cfg: ModelConfig, p: Block, x: torch.Tensor, kind: str, dist,
         use_kernel: bool, sp: Optional[SeqShard] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second half of an attention block: (x, aux)."""
    h2 = norm_apply(cfg, p.norm2, x)
    if kind == "moe":
        y, aux = moe_apply(cfg, p.moe, h2, dist, use_kernel=use_kernel,
                           sp=sp)
        return x + y, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_apply(cfg, p.mlp, h2, tp_mesh(dist), sp), aux


def _hybrid_sp(kind: str, sp: Optional[SeqShard], h: torch.Tensor):
    """The hybrid block's attention and Mamba take one input: under SP it
    is gathered once, each region's entry keeping its own backward."""
    return sp.gathered(h) if sp is not None and kind == "hybrid" else sp


def _block_prefill(cfg: ModelConfig, p: Block, x: torch.Tensor, *,
                   positions, dist, kind: str, full_flag: bool,
                   cache_len: int, use_kernel: bool, name: str = "",
                   sp: Optional[SeqShard] = None):
    """Returns (x, aux, cache_entry).  ``name``: the block's parameter
    prefix (``"blocks.3."``), whose FSDP leaves it gathers first; ``sp``:
    the residual's sequence chunks under SP (``x`` this process's)."""
    p = gather_params(p, dist, name)
    if kind in ("m", "s"):
        apply, _, attr = _recurrent(kind)
        y, st = apply(cfg, getattr(p, attr), norm_apply(cfg, p.norm1, x),
                      return_state=True, tp=tp_mesh(dist), sp=sp)
        return x + y, torch.zeros((), dtype=torch.float32,
                                  device=x.device), {"state": st}
    window, use_window = _window_args(cfg, full_flag)
    h = norm_apply(cfg, p.norm1, x)
    hsp = _hybrid_sp(kind, sp, h)
    attn_out, (k_raw, v_raw) = attention_apply(
        cfg, p.attn, h, positions=positions, window=window,
        use_window=use_window, return_kv=True, use_kernel=use_kernel,
        tp=tp_mesh(dist), sp=hsp)
    cache_window = None if (cfg.swa_window is None or full_flag) \
        else cfg.swa_window
    k_c, v_c = assemble_kv_cache(k_raw, v_raw, cache_window, cache_len)
    cache = {"k": k_c, "v": v_c}
    if kind == "hybrid":
        ssm, cache["ssm"] = mamba_apply(cfg, p.mamba, h, return_state=True,
                                        tp=tp_mesh(dist), sp=hsp)
        x = x + _fuse(cfg, p, attn_out, ssm)
    else:
        x = x + attn_out
    x, aux = _ffn(cfg, p, x, kind, dist, use_kernel, sp)
    return x, aux, cache


def _block_train(cfg: ModelConfig, p: Block, x: torch.Tensor, *,
                 positions, dist, kind: str, full_flag: bool,
                 use_kernel: bool, name: str = "",
                 sp: Optional[SeqShard] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the training forward: (x, aux); ``name`` and ``sp`` as
    ``_block_prefill``'s."""
    p = gather_params(p, dist, name)
    if kind in ("m", "s"):
        apply, _, attr = _recurrent(kind)
        y = apply(cfg, getattr(p, attr), norm_apply(cfg, p.norm1, x),
                  tp=tp_mesh(dist), sp=sp)
        return x + y, torch.zeros((), dtype=torch.float32, device=x.device)
    window, use_window = _window_args(cfg, full_flag)
    h = norm_apply(cfg, p.norm1, x)
    hsp = _hybrid_sp(kind, sp, h)
    attn_out = attention_apply(cfg, p.attn, h, positions=positions,
                               window=window, use_window=use_window,
                               use_kernel=use_kernel, tp=tp_mesh(dist),
                               sp=hsp)
    if kind == "hybrid":
        x = x + _fuse(cfg, p, attn_out,
                      mamba_apply(cfg, p.mamba, h, tp=tp_mesh(dist),
                                  sp=hsp))
    else:
        x = x + attn_out
    return _ffn(cfg, p, x, kind, dist, use_kernel, sp)


def _layers(fns, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``fns`` (each ``x -> (x, aux)``) in order, summing aux."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for fn in fns:
        x, a = fn(x)
        aux = aux + a
    return x, aux


def _remat(fn):
    return partial(checkpoint, fn, use_reentrant=False)


def lm_forward(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
               extras: Any = None, dist: Optional[DistContext] = None,
               use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux summed over the layers);
    under TP with a sharded vocabulary this process's ``[B, S, V/tp]``."""
    b, s = tokens.shape
    sp = seq_shard(dist, s)
    params = gather_top(params, dist)
    x = _embed_tokens(cfg, params, tokens, extras, tp_mesh(dist), sp)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    kinds = layer_kinds(cfg)
    fns = [partial(_block_train, cfg, p_l, positions=positions, dist=dist,
                   kind=kinds[i], full_flag=i in cfg.full_attn_layers,
                   use_kernel=use_kernel, name=f"blocks.{i}.", sp=sp)
           for i, p_l in enumerate(params.blocks)]
    g = cfg.remat_group
    if cfg.remat and g and cfg.n_layers % g == 0:
        # two-level remat: only the group boundaries are kept; each group's
        # layers run three times in all
        fns = [_remat(partial(_layers, [_remat(f) for f in fns[i:i + g]]))
               for i in range(0, len(fns), g)]
    elif cfg.remat:
        fns = [_remat(f) for f in fns]
    x, aux = _layers(fns, x)
    return _lm_logits(cfg, params, x, tp_mesh(dist), sp), aux


def lm_loss(cfg: ModelConfig, params: LM, batch: Dict[str, Any],
            dist: Optional[DistContext] = None, use_kernel: bool = True):
    """batch: {"tokens": [B, S], "labels": [B, S], extras...} ->
    (loss, metrics): next-token cross entropy plus 0.01 * aux, with the
    reference's metrics (``loss``, ``nll``, ``aux``, ``ppl_proxy``).
    ``cfg.bf16_ce`` keeps the max and the exponentials in the logits'
    dtype and sums over the vocabulary in f32.  Over a sharded vocabulary
    it is ``_vocab_parallel_nll``."""
    logits, aux = lm_forward(cfg, params, batch["tokens"], batch, dist,
                             use_kernel)
    labels = batch["labels"].long()[..., None]
    tp = tp_of(tp_mesh(dist), logits.shape[-1], cfg.vocab)
    if tp is not None:
        lse, label_logit = _vocab_parallel_nll(cfg, tp, logits, labels)
    elif cfg.bf16_ce:
        m = logits.amax(-1, keepdim=True)
        denom = torch.exp(logits - m).sum(-1, dtype=torch.float32)
        lse = m[..., 0].float() + torch.log(denom)
        label_logit = torch.gather(logits, -1, labels)[..., 0].float()
    else:
        logits32 = logits.float()
        m = logits32.amax(-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.exp(logits32 - m).sum(-1))
        label_logit = torch.gather(logits32, -1, labels)[..., 0]
    nll = (lse - label_logit).mean()
    loss = nll + 0.01 * aux
    metrics = {"loss": loss, "nll": nll, "aux": aux,
               "ppl_proxy": torch.exp(torch.clamp(nll, max=20.0))}
    return loss, metrics


def _vocab_parallel_nll(cfg: ModelConfig, tp, logits: torch.Tensor,
                        labels: torch.Tensor):
    """(lse, label logit) of this process's vocabulary shard ``logits
    [..., V/tp]``: the max over "model" (a shift the value does not depend
    on, so it carries no gradient), the exponentials' sums added over
    "model" in member order, the label's logit from the shard that owns it.
    ``cfg.bf16_ce`` as ``lm_loss``'s."""
    local, owned = vocab_slice(tp, labels, logits.shape[-1])
    if cfg.bf16_ce:
        m = max_over(tp, logits.amax(-1, keepdim=True))
        denom = torch.exp(logits - m).sum(-1, dtype=torch.float32)
        picked = torch.gather(logits, -1, local)[..., 0].float()
    else:
        logits = logits.float()
        m = max_over(tp, logits.amax(-1, keepdim=True))
        denom = torch.exp(logits - m).sum(-1)
        picked = torch.gather(logits, -1, local)[..., 0]
    lse = m[..., 0].float() + torch.log(sum_out(tp, denom))
    label_logit = sum_out(tp, torch.where(owned[..., 0], picked,
                                          torch.zeros_like(picked)))
    return lse, label_logit


def _embed_tokens(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
                  extras, tp=None, sp: Optional[SeqShard] = None
                  ) -> torch.Tensor:
    """The tokens' embeddings (and the vision stub's patches); over a
    vocabulary sharded across ``tp``'s "model" axis, this process's rows,
    zero for ids outside them, summed over "model".  Under SP (``sp``)
    this process's sequence chunk of them (``tp.leave``).  An FSDP-stored
    table comes gathered (``fsdp.gather_top``)."""
    compute = getattr(torch, cfg.compute_dtype)
    embed = params.embed
    tp = tp_of(tp, embed.shape[0], cfg.vocab)
    if tp is None:
        x = take_rows(embed, tokens, compute)
    else:
        local, owned = vocab_slice(tp, tokens, embed.shape[0])
        rows = take_rows(embed, local, compute)
        x = torch.where(owned[..., None], rows, torch.zeros_like(rows))
    x = leave(tp, sp, x)
    if cfg.frontend == "vision_stub" and extras is not None:
        fl = cfg.frontend_len
        patch = torch.as_tensor(extras["patch_embeds"],
                                device=x.device).to(compute)
        if sp is None:
            x = torch.cat([patch, x[:, fl:]], dim=1) \
                if x.shape[1] > fl else patch[:, :x.shape[1]]
        else:
            # the patches of this process's chunk, at the positions below
            # frontend_len
            patch = patch[:, :sp.length]
            whole = torch.cat([patch, patch.new_zeros(
                patch.shape[0], sp.length - patch.shape[1],
                patch.shape[2])], 1)
            pos = sp.start + torch.arange(sp.chunk, device=x.device)
            x = torch.where((pos < fl)[None, :, None], sp.own(whole), x)
    return x


def _lm_logits(cfg: ModelConfig, params: LM, x: torch.Tensor, tp=None,
               sp: Optional[SeqShard] = None,
               last: bool = False) -> torch.Tensor:
    """The logits, or over a sharded vocabulary this process's shard of
    them; of the last position alone with ``last``.  Under SP ``x`` is
    this process's sequence chunk, gathered after the final norm."""
    if last and sp is None:
        x = x[:, -1:]
    x = norm_apply(cfg, params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    x = enter(tp_of(tp, head.shape[-1], cfg.vocab), sp, x)
    if last and sp is not None:
        x = x[:, -1:].contiguous()    # the rows a TP run's norm writes
    return x @ head.to(x.dtype)


def greedy_tokens(cfg: ModelConfig, logits: torch.Tensor,
                  dist: Optional[DistContext] = None) -> torch.Tensor:
    """The argmax of ``logits [..., V]`` (or of this process's vocabulary
    shard ``[..., V/tp]``, over every model peer's: the global index, the
    lowest among ties)."""
    return argmax_over(tp_of(tp_mesh(dist), logits.shape[-1], cfg.vocab),
                       logits)


def _phys_len(cfg: ModelConfig, seq_len: int, full_attn: bool) -> int:
    if cfg.swa_window is None or full_attn:
        return seq_len
    return min(seq_len, cfg.swa_window)


def _layer_widths(cfg: ModelConfig, p: Block, kind: str, dist) -> dict:
    """The zero-state sizes of this process's shard ``p`` of a layer under
    TP (``models/ssm.py``, ``layers._heads``): the mLSTM's touched heads
    and v columns, the sLSTM's and Mamba's own channels, the kv heads its
    query heads read."""
    from .layers import _attn_tp, _heads
    from .ssm import _mlstm_layout

    tp = tp_mesh(dist)
    if kind == "m":
        _, heads, _, cols = _mlstm_layout(cfg, p.mlstm, tp)
        dh = cfg.d_model // cfg.n_heads
        return {"heads": len(heads), "width": cols if len(heads) == 1
                else dh}
    if kind == "s":
        return {"width": p.slstm.w.shape[-1] // 4}
    out = {"kv": len(_heads(cfg, p.attn, _attn_tp(cfg, p.attn, tp))[2])}
    if kind == "hybrid":
        out["ssm"] = p.mamba.conv_w.shape[-1]
    return out


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device="cuda", params: Optional[LM] = None,
                      dist: Optional[DistContext] = None
                      ) -> List[Dict[str, Any]]:
    """The zero decode cache of every layer; with ``params`` (this
    process's shard) and the ``dist`` of a TP run, sized to what the shard
    holds (``_layer_widths``)."""
    kinds = layer_kinds(cfg)
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    compute = getattr(torch, cfg.compute_dtype)
    cache = []
    for i, kind in enumerate(kinds):
        w = {} if params is None else _layer_widths(
            cfg, whole_shapes(params.blocks[i], dist, f"blocks.{i}."), kind,
            dist)
        if kind == "m":
            cache.append({"state": mlstm_zero_state(
                cfg, batch, device, w.get("heads"), w.get("width"))})
            continue
        if kind == "s":
            cache.append({"state": slstm_zero_state(cfg, batch, device,
                                                    w.get("width"))})
            continue
        # the scanned reference cannot stack mixed window/full caches and
        # uses full-size ones everywhere
        full = (i in cfg.full_attn_layers) if not cfg.scan_layers \
            else bool(cfg.full_attn_layers)
        phys = _phys_len(cfg, seq_len, full)
        heads = w.get("kv", kv)
        entry = {
            "k": torch.zeros((batch, phys, heads, dh), dtype=compute,
                             device=device),
            "v": torch.zeros((batch, phys, heads, dh), dtype=compute,
                             device=device),
        }
        if kind == "hybrid":
            entry["ssm"] = mamba_zero_state(cfg, batch, device, w.get("ssm"))
        cache.append(entry)
    return cache


def _block_decode(cfg: ModelConfig, p: Block, cache: dict, x, pos: int, *,
                  kind: str, full_flag: bool, dist,
                  use_kernel: bool, name: str = "") -> torch.Tensor:
    p = gather_params(p, dist, name)
    if kind in ("m", "s"):
        _, decode, attr = _recurrent(kind)
        y, cache["state"] = decode(cfg, getattr(p, attr),
                                   norm_apply(cfg, p.norm1, x),
                                   cache["state"], tp=tp_mesh(dist))
        return x + y
    window = None
    if cfg.swa_window is not None:
        phys = cache["k"].shape[1]
        # ring semantics engage only when the cache is window-sized
        window = cfg.swa_window if (not full_flag and
                                    phys <= cfg.swa_window) else None
    h = norm_apply(cfg, p.norm1, x)
    attn, _, _ = attention_decode(cfg, p.attn, h, cache["k"], cache["v"],
                                  pos, window=window, tp=tp_mesh(dist))
    if kind == "hybrid":
        ssm, cache["ssm"] = mamba_decode(cfg, p.mamba, h, cache["ssm"],
                                         tp=tp_mesh(dist))
        x = x + _fuse(cfg, p, attn, ssm)
    else:
        x = x + attn
    return _ffn(cfg, p, x, kind, dist, use_kernel)[0]


def lm_decode_step(cfg: ModelConfig, params: LM, cache, tokens: torch.Tensor,
                   pos: int, dist: Optional[DistContext] = None,
                   use_kernel: bool = True):
    """tokens [B] int, pos int -> (logits [B, V], cache updated in place);
    the logits are this process's vocabulary shard under TP."""
    params = gather_top(params, dist)
    x = _embed_tokens(cfg, params, tokens[:, None], None, tp_mesh(dist))
    kinds = layer_kinds(cfg)
    for i, (p_l, cache_l) in enumerate(zip(params.blocks, cache)):
        x = _block_decode(cfg, p_l, cache_l, x, int(pos), kind=kinds[i],
                          full_flag=_full_flag(cfg, i), dist=dist,
                          use_kernel=use_kernel, name=f"blocks.{i}.")
    return _lm_logits(cfg, params, x, tp_mesh(dist))[:, 0], cache


def lm_prefill(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
               extras: Any = None, dist: Optional[DistContext] = None,
               cache_len: Optional[int] = None, use_kernel: bool = True):
    """Forward over the full prompt, emitting a decode-ready cache.

    Returns (last-position logits [B, V], cache); decode continues at
    pos = S.  ``cache_len`` sizes the cache (default: the prompt length).
    """
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError("cache must at least hold the prompt")
    sp = seq_shard(dist, s)
    params = gather_top(params, dist)
    x = _embed_tokens(cfg, params, tokens, extras, tp_mesh(dist), sp)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    kinds = layer_kinds(cfg)
    eff_cfg = cfg
    if cfg.scan_layers and cfg.full_attn_layers \
            and cfg.swa_window is not None:
        # mixed full/window layers cannot stack ring caches: the scanned
        # reference treats all as full-size
        eff_cfg = dataclasses.replace(cfg, swa_window=None)
    cache = []
    for i, p_l in enumerate(params.blocks):
        x, _, cache_l = _block_prefill(
            eff_cfg, p_l, x, positions=positions, dist=dist, kind=kinds[i],
            full_flag=_full_flag(cfg, i), cache_len=cache_len,
            use_kernel=use_kernel, name=f"blocks.{i}.", sp=sp)
        cache.append(cache_l)
    logits = _lm_logits(cfg, params, x, tp_mesh(dist), sp, last=True)
    return logits[:, 0], cache
