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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..configs.registry import ModelConfig
from .dist import DistContext
from .layers import (
    MLP,
    Attention,
    Norm,
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
                  enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x [B, Sq, d]; enc_k, enc_v [B, Se, K, Dh] (already projected)."""
    b, sq, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq.to(x.dtype)).reshape(b, sq, h, dh)
    k = _repeat_kv(enc_k, h // kv)
    v = _repeat_kv(enc_v, h // kv)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=x.device)
    out = mha_einsum(q, k, v, mask).reshape(b, sq, h * dh)
    return out @ p.wo.to(x.dtype)


def _project_enc_kv(cfg: ModelConfig, p: Attention, enc_out: torch.Tensor):
    b, se, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    k = (enc_out @ p.wk.to(enc_out.dtype)).reshape(b, se, kv, dh)
    v = (enc_out @ p.wv.to(enc_out.dtype)).reshape(b, se, kv, dh)
    return k, v


def encode(cfg: ModelConfig, params: EncDec, frames,
           use_kernel: bool = True) -> torch.Tensor:
    """frames [B, encoder_len, d] stub embeddings -> the encoder stream
    [B, encoder_len, d] in the compute dtype."""
    compute = getattr(torch, cfg.compute_dtype)
    frames = torch.as_tensor(frames, device=params.enc_pos.device)
    if frames.dim() != 3 or tuple(frames.shape[1:]) != (cfg.encoder_len,
                                                        cfg.d_model):
        raise ValueError(f"frames must be [B, {cfg.encoder_len}, "
                         f"{cfg.d_model}], got {tuple(frames.shape)}")
    x = frames.to(compute) + params.enc_pos.to(compute)[None]
    b, se = x.shape[:2]
    positions = torch.arange(se, dtype=torch.int32,
                             device=x.device).expand(b, se)
    for blk in params.enc_blocks:
        h = norm_apply(cfg, blk.norm1, x)
        x = x + attention_apply(cfg, blk.attn, h, positions=positions,
                                causal=False, use_kernel=use_kernel)
        x = x + mlp_apply(cfg, blk.mlp, norm_apply(cfg, blk.norm2, x))
    return norm_apply(cfg, params.enc_final, x)


def encdec_forward(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
                   extras: Dict[str, Any], dist: Optional[DistContext] = None,
                   use_kernel: bool = True):
    """The teacher-forced decoder over the full token sequence: tokens
    [B, S] and ``extras["frames"]`` -> (logits [B, S, V], aux = 0)."""
    enc_out = encode(cfg, params, extras["frames"], use_kernel)
    compute = getattr(torch, cfg.compute_dtype)
    b, s = tokens.shape
    # saturate at the learned table's last row (the reference's clamp)
    pos_idx = torch.clamp(torch.arange(s, device=enc_out.device),
                          max=_MAX_DECODE_POS - 1)
    x = take_rows(params.embed, tokens, compute) \
        + take_rows(params.dec_pos, pos_idx, compute)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for blk in params.dec_blocks:
        h = norm_apply(cfg, blk.norm1, x)
        x = x + attention_apply(cfg, blk.attn, h, positions=positions,
                                causal=True, use_kernel=use_kernel)
        hx = norm_apply(cfg, blk.norm_x, x)
        ek, ev = _project_enc_kv(cfg, blk.xattn, enc_out)
        x = x + _cross_attend(cfg, blk.xattn, hx, ek, ev)
        x = x + mlp_apply(cfg, blk.mlp, norm_apply(cfg, blk.norm2, x))
    x = norm_apply(cfg, params.dec_final, x)
    logits = x @ params.embed.T.to(x.dtype)
    return logits, torch.zeros((), dtype=_F32, device=x.device)


def encdec_loss(cfg: ModelConfig, params: EncDec, batch: Dict[str, Any],
                dist: Optional[DistContext] = None, use_kernel: bool = True):
    """Next-token cross entropy of the teacher-forced decoder, with the
    reference's metrics; no aux term enters the loss, as there."""
    logits, aux = encdec_forward(cfg, params, batch["tokens"], batch, dist,
                                 use_kernel)
    logits = logits.float()
    labels = batch["labels"].long()[..., None]
    m = logits.amax(-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
    ll = torch.gather(logits, -1, labels)[..., 0]
    nll = (lse - ll).mean()
    metrics = {"loss": nll, "nll": nll, "aux": aux,
               "ppl_proxy": torch.exp(torch.clamp(nll, max=20.0))}
    return nll, metrics


def encdec_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      frames=None, params: Optional[EncDec] = None,
                      device="cuda", use_kernel: bool = True
                      ) -> List[Dict[str, torch.Tensor]]:
    """The self-attention cache (``seq_len`` slots, zero) and each layer's
    projected cross K/V.  With ``frames`` and ``params`` the cross K/V hold
    the real encoder projections (on the parameters' device); otherwise
    zeros of ``encoder_len`` rows."""
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    compute = getattr(torch, cfg.compute_dtype)
    enc_out = None
    if frames is not None and params is not None:
        enc_out = encode(cfg, params, frames, use_kernel)
        device = enc_out.device
    layers = []
    for i in range(cfg.n_layers):
        entry = {
            "k": torch.zeros((batch, seq_len, kv, dh), dtype=compute,
                             device=device),
            "v": torch.zeros((batch, seq_len, kv, dh), dtype=compute,
                             device=device),
        }
        if enc_out is not None:
            entry["xk"], entry["xv"] = _project_enc_kv(
                cfg, params.dec_blocks[i].xattn, enc_out)
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
    the cross K/V are static per request."""
    compute = getattr(torch, cfg.compute_dtype)
    pos = int(pos)
    pos_emb = params.dec_pos[min(pos, _MAX_DECODE_POS - 1)].to(compute)
    x = take_rows(params.embed, tokens[:, None], compute) + pos_emb[None, None]
    for blk, cache_l in zip(params.dec_blocks, cache):
        h = norm_apply(cfg, blk.norm1, x)
        attn, _, _ = attention_decode(cfg, blk.attn, h, cache_l["k"],
                                      cache_l["v"], pos)
        x = x + attn
        hx = norm_apply(cfg, blk.norm_x, x)
        x = x + _cross_attend(cfg, blk.xattn, hx, cache_l["xk"],
                              cache_l["xv"])
        x = x + mlp_apply(cfg, blk.mlp, norm_apply(cfg, blk.norm2, x))
    x = norm_apply(cfg, params.dec_final, x)
    logits = x @ params.embed.T.to(x.dtype)
    return logits[:, 0], cache
