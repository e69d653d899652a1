"""Whisper-style encoder-decoder (audio frontend stubbed).

Counterpart of ``src/repro/models/encdec.py``.  Parameters live in an
``EncDec`` module whose attribute paths are the reference's pytree paths
(``embed``, ``enc_pos``, ``dec_pos``, ``enc_blocks.<i>.attn.wq``,
``dec_blocks.<i>.xattn.wk``, ``enc_final.scale``, ...); every one is f32,
whatever ``cfg.param_dtype`` is, as there.  ``frames`` are precomputed frame
embeddings ``[B, encoder_len, d]``.  The encoder's self-attention
(non-causal) and the decoder's (causal) run on the ``flash_attention``
kernel through ``attention_apply`` (``use_kernel=False``: the plain math);
cross-attention stays on plain math, as in the reference (``mha_einsum``):
its query and key lengths differ, and neither package's kernel takes two.

Decoder positions index a learned table of ``_MAX_DECODE_POS`` rows and
saturate at its last row.  The decode cache is a list of per-layer dicts,
``{"k", "v"}`` (self-attention, updated in place) and ``{"xk", "xv"}`` (the
projected encoder stream, static per request).

Under tensor parallelism (``dist.tp_size > 1`` on a ``ProcessMesh``;
``models/tp.py``) every leaf follows its spec through the same layer
functions as the decoder-only stacks: the self-attention, the
cross-attention and the GELU MLP (``b_up`` sharded with ``w_up``) run on
this process's slice, the cross-attention on the query heads its ``wq``
columns touch against the kv heads they read, projected from the encoder
stream (gathered over "model" where "model" cuts through them; the cross
cache holds those heads, as the self-attention cache does).  The tied head
is vocabulary-parallel where "model" divides the vocabulary (the lookup,
the logits and the cross entropy of ``models/transformer.py``), whole
where it does not (51865 rows); ``enc_pos`` and ``dec_pos`` are
replicated.  The reference leaves this layout to GSPMD.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..configs.registry import ModelConfig
from .dist import DistContext
from .layers import (
    MLP,
    Attention,
    Norm,
    _attn_tp,
    _heads,
    _own_cols,
    _project_kv,
    _project_q,
    _repeat_kv,
    attention_apply,
    attention_decode,
    embed_init,
    mha_einsum,
    mlp_apply,
    norm_apply,
    param,
    take_rows,
)
from .fsdp import gather_params, gather_top, whole_shapes
from .tp import enter, own_seq, row_parallel, seq_shard, tp_mesh, tp_of
from .transformer import _embed_tokens, _vocab_parallel_nll

__all__ = [
    "EncDec", "init_encdec", "encode", "encdec_forward", "encdec_loss",
    "encdec_init_cache", "encdec_decode_step",
]

_MAX_DECODE_POS = 8192  # learned positions table (structural superset)
_F32 = torch.float32


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, gen, _F32, device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.mlp = MLP(cfg, gen, _F32, device)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, gen, _F32, device)
        self.norm_x = Norm(cfg, cfg.d_model, device)
        # the same projections; k and v read the encoder stream
        self.xattn = Attention(cfg, gen, _F32, device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.mlp = MLP(cfg, gen, _F32, device)


class EncDec(nn.Module):
    """The parameters; ``train=True`` lets autograd take their
    gradients."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 train: bool = False):
        super().__init__()
        d = cfg.d_model
        self.embed = param(embed_init(gen, cfg.vocab, d, _F32, device))
        self.enc_pos = param(embed_init(gen, cfg.encoder_len, d, _F32,
                                        device))
        self.dec_pos = param(embed_init(gen, _MAX_DECODE_POS, d, _F32,
                                        device))
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, gen, device) for _ in range(cfg.n_encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, gen, device) for _ in range(cfg.n_layers))
        self.enc_final = Norm(cfg, d, device)
        self.dec_final = Norm(cfg, d, device)
        self.requires_grad_(train)


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device="cuda",
                train: bool = False) -> EncDec:
    return EncDec(cfg, gen, device, train)


def _cross_attend(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                  enc_k: torch.Tensor, enc_v: torch.Tensor,
                  tp=None, sp=None) -> torch.Tensor:
    """x [B, Sq, d]; enc_k, enc_v [B, Se, K, Dh] (already projected: the kv
    heads that the query heads ``p``'s columns touch read, ``_heads``);
    under SP (``sp``) ``x`` and the output are sequence chunks."""
    tp = _attn_tp(cfg, p, tp)
    heads, off, _ = _heads(cfg, p, tp)
    h, kv, dh = len(heads), enc_k.shape[2], cfg.resolved_head_dim
    q = _project_q(cfg, p, enter(tp, sp, x), tp, heads)
    b, sq = q.shape[:2]
    k = _repeat_kv(enc_k, h // kv)
    v = _repeat_kv(enc_v, h // kv)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _own_cols(mha_einsum(q, k, v, mask).reshape(b, sq, h * dh), off,
                    p.wo.shape[0])
    return row_parallel(tp, torch.matmul, out, p.wo.to(x.dtype), sp=sp)


def _project_enc_kv(cfg: ModelConfig, p: Attention, enc_out: torch.Tensor,
                    tp=None, sp=None):
    """The cross keys and values ``[B, Se, K_sel, Dh]`` of the kv heads
    that the query heads ``p``'s columns touch read (every kv head without
    TP); under SP ``enc_out`` is this process's chunk of the encoder
    stream (``sp.whole`` its gathered sequence)."""
    tp = _attn_tp(cfg, p, tp)
    return _project_kv(cfg, p, enter(tp, sp, enc_out), tp,
                       _heads(cfg, p, tp)[2])


def _logits(cfg: ModelConfig, params: EncDec, x: torch.Tensor, tp=None,
            sp=None) -> torch.Tensor:
    """The tied head's logits, or over a sharded vocabulary this process's
    shard of them; under SP ``x`` is a sequence chunk, gathered after the
    final norm."""
    x = norm_apply(cfg, params.dec_final, x)
    embed = params.embed
    x = enter(tp_of(tp, embed.shape[0], cfg.vocab), sp, x)
    return x @ embed.T.to(x.dtype)


def encode(cfg: ModelConfig, params: EncDec, frames,
           use_kernel: bool = True,
           dist: Optional[DistContext] = None, sp=None) -> torch.Tensor:
    """frames [B, encoder_len, d] stub embeddings -> the encoder stream
    [B, encoder_len, d] in the compute dtype; under SP (``sp``, the
    encoder's ``tp.SeqShard``) this process's sequence chunk of it."""
    compute = getattr(torch, cfg.compute_dtype)
    tp = tp_mesh(dist)
    params = gather_top(params, dist, ("enc_pos",))
    frames = torch.as_tensor(frames, device=params.enc_pos.device)
    if frames.dim() != 3 or tuple(frames.shape[1:]) != (cfg.encoder_len,
                                                        cfg.d_model):
        raise ValueError(f"frames must be [B, {cfg.encoder_len}, "
                         f"{cfg.d_model}], got {tuple(frames.shape)}")
    x = frames.to(compute) + params.enc_pos.to(compute)[None]
    b, se = x.shape[:2]
    positions = torch.arange(se, dtype=torch.int32,
                             device=x.device).expand(b, se)
    if sp is not None:
        x = own_seq(sp, x)
    for i, blk in enumerate(params.enc_blocks):
        blk = gather_params(blk, dist, f"enc_blocks.{i}.")
        h = norm_apply(cfg, blk.norm1, x)
        x = x + attention_apply(cfg, blk.attn, h, positions=positions,
                                causal=False, use_kernel=use_kernel, tp=tp,
                                sp=sp)
        x = x + mlp_apply(cfg, blk.mlp, norm_apply(cfg, blk.norm2, x), tp,
                          sp)
    return norm_apply(cfg, params.enc_final, x)


def _encode_gathered(cfg: ModelConfig, params: EncDec, frames,
                     use_kernel: bool, dist):
    """(the encoder stream, its ``SeqShard`` with the whole sequence
    gathered, or None without SP)."""
    sp = seq_shard(dist, cfg.encoder_len)
    enc_out = encode(cfg, params, frames, use_kernel, dist, sp)
    return enc_out, (sp.gathered(enc_out) if sp is not None else None)


def encdec_forward(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
                   extras: Dict[str, Any], dist: Optional[DistContext] = None,
                   use_kernel: bool = True):
    """The teacher-forced decoder over the full token sequence: tokens
    [B, S] and ``extras["frames"]`` -> (logits [B, S, V], aux = 0); under
    TP with a sharded vocabulary this process's ``[B, S, V/tp]``."""
    tp = tp_mesh(dist)
    enc_out, esp = _encode_gathered(cfg, params, extras["frames"],
                                    use_kernel, dist)
    params = gather_top(params, dist, ("embed", "dec_pos"))
    compute = getattr(torch, cfg.compute_dtype)
    b, s = tokens.shape
    sp = seq_shard(dist, s)
    # saturate at the learned table's last row (the reference's clamp)
    pos_idx = torch.clamp(torch.arange(s, device=enc_out.device),
                          max=_MAX_DECODE_POS - 1)
    pos = take_rows(params.dec_pos, pos_idx, compute)[None]
    x = _embed_tokens(cfg, params, tokens, None, tp, sp) \
        + (pos if sp is None else own_seq(sp, pos))
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for i, blk in enumerate(params.dec_blocks):
        blk = gather_params(blk, dist, f"dec_blocks.{i}.")
        h = norm_apply(cfg, blk.norm1, x)
        x = x + attention_apply(cfg, blk.attn, h, positions=positions,
                                causal=True, use_kernel=use_kernel, tp=tp,
                                sp=sp)
        hx = norm_apply(cfg, blk.norm_x, x)
        ek, ev = _project_enc_kv(cfg, blk.xattn, enc_out, tp, esp)
        x = x + _cross_attend(cfg, blk.xattn, hx, ek, ev, tp, sp)
        x = x + mlp_apply(cfg, blk.mlp, norm_apply(cfg, blk.norm2, x), tp,
                          sp)
    logits = _logits(cfg, params, x, tp, sp)
    return logits, torch.zeros((), dtype=_F32, device=x.device)


def encdec_loss(cfg: ModelConfig, params: EncDec, batch: Dict[str, Any],
                dist: Optional[DistContext] = None, use_kernel: bool = True):
    """Next-token cross entropy of the teacher-forced decoder in f32, with
    the reference's metrics; no aux term enters the loss, as there.  Over
    a sharded vocabulary it is ``transformer._vocab_parallel_nll``."""
    logits, aux = encdec_forward(cfg, params, batch["tokens"], batch, dist,
                                 use_kernel)
    labels = batch["labels"].long()[..., None]
    tp = tp_of(tp_mesh(dist), logits.shape[-1], cfg.vocab)
    if tp is not None:
        lse, ll = _vocab_parallel_nll(
            dataclasses.replace(cfg, bf16_ce=False), tp, logits, labels)
    else:
        logits = logits.float()
        m = logits.amax(-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
        ll = torch.gather(logits, -1, labels)[..., 0]
    nll = (lse - ll).mean()
    metrics = {"loss": nll, "nll": nll, "aux": aux,
               "ppl_proxy": torch.exp(torch.clamp(nll, max=20.0))}
    return nll, metrics


def encdec_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      frames=None, params: Optional[EncDec] = None,
                      device="cuda", use_kernel: bool = True,
                      dist: Optional[DistContext] = None
                      ) -> List[Dict[str, torch.Tensor]]:
    """The self-attention cache (``seq_len`` slots, zero) and each layer's
    projected cross K/V.  With ``frames`` and ``params`` the cross K/V hold
    the real encoder projections (on the parameters' device); otherwise
    zeros of ``encoder_len`` rows.  Under TP (``dist``, with ``params``:
    this process's shard) every entry holds the kv heads that the query
    heads of this process's columns read (``layers._heads``)."""
    tp = tp_mesh(dist)
    if tp is not None and params is None:
        raise ValueError("a cache under TP holds the kv heads of this "
                         "process's shard: pass its params")
    dh = cfg.resolved_head_dim
    compute = getattr(torch, cfg.compute_dtype)
    enc_out = esp = None
    if frames is not None and params is not None:
        enc_out, esp = _encode_gathered(cfg, params, frames, use_kernel,
                                        dist)
        device = enc_out.device
    layers = []
    for i in range(cfg.n_layers):
        if params is not None:
            attn = whole_shapes(params.dec_blocks[i], dist,
                                f"dec_blocks.{i}.").attn
        kv = cfg.n_kv_heads if params is None else len(_heads(
            cfg, attn, _attn_tp(cfg, attn, tp))[2])
        entry = {
            "k": torch.zeros((batch, seq_len, kv, dh), dtype=compute,
                             device=device),
            "v": torch.zeros((batch, seq_len, kv, dh), dtype=compute,
                             device=device),
        }
        if enc_out is not None:
            entry["xk"], entry["xv"] = _project_enc_kv(
                cfg, gather_params(params.dec_blocks[i], dist,
                                   f"dec_blocks.{i}.").xattn, enc_out, tp,
                esp)
        else:
            for key in ("xk", "xv"):
                entry[key] = torch.zeros((batch, cfg.encoder_len, kv, dh),
                                         dtype=compute, device=device)
        layers.append(entry)
    return layers


def encdec_decode_step(cfg: ModelConfig, params: EncDec, cache,
                       tokens: torch.Tensor, pos: int,
                       dist: Optional[DistContext] = None,
                       use_kernel: bool = True):
    """tokens [B] int, pos int -> (logits [B, V], cache updated in place);
    the cross K/V are static per request.  The logits are this process's
    vocabulary shard under TP."""
    tp = tp_mesh(dist)
    compute = getattr(torch, cfg.compute_dtype)
    pos = int(pos)
    params = gather_top(params, dist, ("embed", "dec_pos"))
    pos_emb = params.dec_pos[min(pos, _MAX_DECODE_POS - 1)].to(compute)
    x = _embed_tokens(cfg, params, tokens[:, None], None, tp) \
        + pos_emb[None, None]
    for i, (blk, cache_l) in enumerate(zip(params.dec_blocks, cache)):
        blk = gather_params(blk, dist, f"dec_blocks.{i}.")
        h = norm_apply(cfg, blk.norm1, x)
        attn, _, _ = attention_decode(cfg, blk.attn, h, cache_l["k"],
                                      cache_l["v"], pos, tp=tp)
        x = x + attn
        hx = norm_apply(cfg, blk.norm_x, x)
        x = x + _cross_attend(cfg, blk.xattn, hx, cache_l["xk"],
                              cache_l["xv"], tp)
        x = x + mlp_apply(cfg, blk.mlp, norm_apply(cfg, blk.norm2, x), tp)
    return _logits(cfg, params, x, tp)[:, 0], cache
