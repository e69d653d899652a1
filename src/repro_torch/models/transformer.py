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
from .moe import MoE, moe_apply
from .ssm import (
    MLSTM, SLSTM, Mamba,
    mamba_apply, mamba_decode, mamba_zero_state,
    mlstm_apply, mlstm_decode, mlstm_zero_state,
    slstm_apply, slstm_decode, slstm_zero_state,
)

__all__ = [
    "LM", "layer_kinds", "init_lm", "lm_forward", "lm_loss",
    "init_decode_cache", "lm_decode_step", "lm_prefill",
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
         use_kernel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second half of an attention block: (x, aux)."""
    h2 = norm_apply(cfg, p.norm2, x)
    if kind == "moe":
        y, aux = moe_apply(cfg, p.moe, h2, dist, use_kernel=use_kernel)
        return x + y, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_apply(cfg, p.mlp, h2), aux


def _block_prefill(cfg: ModelConfig, p: Block, x: torch.Tensor, *,
                   positions, dist, kind: str, full_flag: bool,
                   cache_len: int, use_kernel: bool):
    """Returns (x, aux, cache_entry)."""
    if kind in ("m", "s"):
        apply, _, name = _recurrent(kind)
        y, st = apply(cfg, getattr(p, name), norm_apply(cfg, p.norm1, x),
                      return_state=True)
        return x + y, torch.zeros((), dtype=torch.float32,
                                  device=x.device), {"state": st}
    window, use_window = _window_args(cfg, full_flag)
    h = norm_apply(cfg, p.norm1, x)
    attn_out, (k_raw, v_raw) = attention_apply(
        cfg, p.attn, h, positions=positions, window=window,
        use_window=use_window, return_kv=True, use_kernel=use_kernel)
    cache_window = None if (cfg.swa_window is None or full_flag) \
        else cfg.swa_window
    k_c, v_c = assemble_kv_cache(k_raw, v_raw, cache_window, cache_len)
    cache = {"k": k_c, "v": v_c}
    if kind == "hybrid":
        ssm, cache["ssm"] = mamba_apply(cfg, p.mamba, h, return_state=True)
        x = x + _fuse(cfg, p, attn_out, ssm)
    else:
        x = x + attn_out
    x, aux = _ffn(cfg, p, x, kind, dist, use_kernel)
    return x, aux, cache


def _block_train(cfg: ModelConfig, p: Block, x: torch.Tensor, *,
                 positions, dist, kind: str, full_flag: bool,
                 use_kernel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the training forward: (x, aux)."""
    if kind in ("m", "s"):
        apply, _, name = _recurrent(kind)
        y = apply(cfg, getattr(p, name), norm_apply(cfg, p.norm1, x))
        return x + y, torch.zeros((), dtype=torch.float32, device=x.device)
    window, use_window = _window_args(cfg, full_flag)
    h = norm_apply(cfg, p.norm1, x)
    attn_out = attention_apply(cfg, p.attn, h, positions=positions,
                               window=window, use_window=use_window,
                               use_kernel=use_kernel)
    if kind == "hybrid":
        x = x + _fuse(cfg, p, attn_out, mamba_apply(cfg, p.mamba, h))
    else:
        x = x + attn_out
    return _ffn(cfg, p, x, kind, dist, use_kernel)


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
    """tokens [B, S] -> (logits [B, S, V], aux summed over the layers)."""
    b, s = tokens.shape
    x = _embed_tokens(cfg, params, tokens, extras)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    kinds = layer_kinds(cfg)
    fns = [partial(_block_train, cfg, p_l, positions=positions, dist=dist,
                   kind=kinds[i], full_flag=i in cfg.full_attn_layers,
                   use_kernel=use_kernel)
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
    return _lm_logits(cfg, params, x), aux


def lm_loss(cfg: ModelConfig, params: LM, batch: Dict[str, Any],
            dist: Optional[DistContext] = None, use_kernel: bool = True):
    """batch: {"tokens": [B, S], "labels": [B, S], extras...} ->
    (loss, metrics): next-token cross entropy plus 0.01 * aux, with the
    reference's metrics (``loss``, ``nll``, ``aux``, ``ppl_proxy``).
    ``cfg.bf16_ce`` keeps the max and the exponentials in the logits'
    dtype and sums over the vocabulary in f32."""
    logits, aux = lm_forward(cfg, params, batch["tokens"], batch, dist,
                             use_kernel)
    labels = batch["labels"].long()[..., None]
    if cfg.bf16_ce:
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


def _embed_tokens(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
                  extras) -> torch.Tensor:
    compute = getattr(torch, cfg.compute_dtype)
    x = take_rows(params.embed, tokens, compute)
    if cfg.frontend == "vision_stub" and extras is not None:
        fl = cfg.frontend_len
        patch = torch.as_tensor(extras["patch_embeds"],
                                device=x.device).to(compute)
        x = torch.cat([patch, x[:, fl:]], dim=1) \
            if x.shape[1] > fl else patch[:, :x.shape[1]]
    return x


def _lm_logits(cfg: ModelConfig, params: LM, x: torch.Tensor
               ) -> torch.Tensor:
    x = norm_apply(cfg, params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head.to(x.dtype)


def _phys_len(cfg: ModelConfig, seq_len: int, full_attn: bool) -> int:
    if cfg.swa_window is None or full_attn:
        return seq_len
    return min(seq_len, cfg.swa_window)


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device="cuda") -> List[Dict[str, Any]]:
    kinds = layer_kinds(cfg)
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    compute = getattr(torch, cfg.compute_dtype)
    cache = []
    for i, kind in enumerate(kinds):
        if kind in ("m", "s"):
            zero = mlstm_zero_state if kind == "m" else slstm_zero_state
            cache.append({"state": zero(cfg, batch, device)})
            continue
        # the scanned reference cannot stack mixed window/full caches and
        # uses full-size ones everywhere
        full = (i in cfg.full_attn_layers) if not cfg.scan_layers \
            else bool(cfg.full_attn_layers)
        phys = _phys_len(cfg, seq_len, full)
        entry = {
            "k": torch.zeros((batch, phys, kv, dh), dtype=compute,
                             device=device),
            "v": torch.zeros((batch, phys, kv, dh), dtype=compute,
                             device=device),
        }
        if kind == "hybrid":
            entry["ssm"] = mamba_zero_state(cfg, batch, device)
        cache.append(entry)
    return cache


def _block_decode(cfg: ModelConfig, p: Block, cache: dict, x, pos: int, *,
                  kind: str, full_flag: bool, dist,
                  use_kernel: bool) -> torch.Tensor:
    if kind in ("m", "s"):
        _, decode, name = _recurrent(kind)
        y, cache["state"] = decode(cfg, getattr(p, name),
                                   norm_apply(cfg, p.norm1, x),
                                   cache["state"])
        return x + y
    window = None
    if cfg.swa_window is not None:
        phys = cache["k"].shape[1]
        # ring semantics engage only when the cache is window-sized
        window = cfg.swa_window if (not full_flag and
                                    phys <= cfg.swa_window) else None
    h = norm_apply(cfg, p.norm1, x)
    attn, _, _ = attention_decode(cfg, p.attn, h, cache["k"], cache["v"],
                                  pos, window=window)
    if kind == "hybrid":
        ssm, cache["ssm"] = mamba_decode(cfg, p.mamba, h, cache["ssm"])
        x = x + _fuse(cfg, p, attn, ssm)
    else:
        x = x + attn
    return _ffn(cfg, p, x, kind, dist, use_kernel)[0]


def lm_decode_step(cfg: ModelConfig, params: LM, cache, tokens: torch.Tensor,
                   pos: int, dist: Optional[DistContext] = None,
                   use_kernel: bool = True):
    """tokens [B] int, pos int -> (logits [B, V], cache updated in place)."""
    x = _embed_tokens(cfg, params, tokens[:, None], None)
    kinds = layer_kinds(cfg)
    for i, (p_l, cache_l) in enumerate(zip(params.blocks, cache)):
        x = _block_decode(cfg, p_l, cache_l, x, int(pos), kind=kinds[i],
                          full_flag=_full_flag(cfg, i), dist=dist,
                          use_kernel=use_kernel)
    return _lm_logits(cfg, params, x)[:, 0], cache


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
    x = _embed_tokens(cfg, params, tokens, extras)
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
            use_kernel=use_kernel)
        cache.append(cache_l)
    logits = _lm_logits(cfg, params, x[:, -1:])
    return logits[:, 0], cache
