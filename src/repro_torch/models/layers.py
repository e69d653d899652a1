"""Foundation layers: norms, RoPE, GQA attention (full / sliding-window /
chunked online-softmax / decode against a cache), MLPs.

Counterpart of ``src/repro/models/layers.py``.  Parameters live in
``nn.Module``s whose attribute names are the JAX dict keys (``scale``,
``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``), so the
functions below read ``p.wq`` where the reference reads ``p["wq"]``.
The prefill and training attention runs on the ``flash_attention`` kernel
(``use_kernel=True``; under autograd its backward runs on
``flash_attention_bwd``), held against the reference's ``mha_einsum`` /
``mha_chunked`` math, which ``use_kernel=False`` runs; the reference computes
it outside any Pallas kernel and calls its chunked form "mathematically
identical to the Pallas flash_attention kernel".  Decode attention is plain
PyTorch, as the reference's.  The decode cache is updated in place (the
reference returns a new one) to keep one copy of it in device memory.

Under tensor parallelism (``tp``, a ``ProcessMesh`` whose "model" axis is
above 1; ``models/tp.py``) attention runs on the query heads that this
process's ``wq`` columns touch (``tp.q_heads``) and on the kv heads they
read (``tp.kv_heads``): ``wq``/``wk``/``wv`` are column-parallel behind
``copy_in`` and ``wo`` is row-parallel (``row_parallel``); so are the
MLP's ``w_gate``/``w_up`` and ``w_down`` (the GELU form's ``b_up`` sharded,
``b_down`` added once after the sum).  Where "model" divides the query
heads a process's ``wq`` columns are whole heads and nothing is gathered;
where it cuts through one (internvl2-1b's 14 heads at 16: 56 of a 64-wide
head's columns a process), the peers' query columns are gathered over
"model" (``tp.gather_cols``), each process computes the one or two whole
heads its columns touch, and it keeps its own columns of their output for
its ``wo`` rows (``_own_cols``): two peers that touch a head compute it
bit for bit alike, and the gather's backward adds the parts of its
cotangent that each peer's columns gave.  Where "model" divides the kv
heads a process's ``wk``/``wv`` columns are exactly the kv heads it reads;
where it cuts through them, the peers' columns are gathered over "model"
(the reference's "one small K*dh all-gather after the projection") and
each process keeps the kv heads it reads, replicated on the peers that
share them, in the prefill's keys and values and the decode cache alike.
``q_norm``, ``k_norm`` and RoPE run after the gathers, on whole heads.
The replicated ``q_norm``/``k_norm`` (and a ``wk``/``wv`` that
``_drop_uneven`` keeps whole) enter through ``copy_in`` too, which sums
their gradients over the peers' heads.  Where ``_drop_uneven`` keeps
``wq`` and ``wo`` whole, attention runs whole on every process, outside
the TP region.  The kernels run unchanged on the local heads.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import trace
from ..configs.registry import ModelConfig
# the kernel's differentiable form: without a gradient to take it is the
# plain wrapper call
from ..kernels.flash_attention import flash_attention_autograd as \
    flash_attention
from .tp import copy_in, enter, gather_cols, kv_heads, model_coord, \
    q_heads, row_parallel, tp_of

NEG_INF = -1e30

__all__ = [
    "dense_init", "embed_init", "param", "take_rows", "Norm", "Attention",
    "MLP",
    "norm_apply", "rms_head_norm", "apply_rope", "attention_apply",
    "assemble_kv_cache", "attention_decode", "mlp_apply",
]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """N(0, 1/d_in) weights drawn in f32, then cast (as the reference)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return w.to(dtype) * 0.02


def param(t: torch.Tensor) -> nn.Parameter:
    """A frozen parameter: the serving path takes no gradients (training
    turns them on for the whole module, ``models.model.build_model``)."""
    return nn.Parameter(t, requires_grad=False)


def take_rows(table: torch.Tensor, idx: torch.Tensor, dtype) -> torch.Tensor:
    """Rows ``idx`` of an embedding table in ``dtype``.  Under a gradient the
    table is cast, then gathered, as the reference does, so that a repeated
    row's gradient sums in ``dtype`` as there; otherwise only the rows taken
    are cast (the same values)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return table.to(dtype)[idx]
    return table[idx].to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__()
        self.scale = param(torch.ones((d,), dtype=torch.float32,
                                      device=device))
        if cfg.norm == "layernorm":
            self.bias = param(torch.zeros((d,), dtype=torch.float32,
                                          device=device))


def norm_apply(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + 1e-6)
        y = y * p.scale + p.bias
    else:
        ms = (x32 ** 2).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + 1e-6) * p.scale
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm over head_dim (Qwen3 qk-norm)."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 ** 2).mean(-1, keepdim=True) + 1e-6)
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # [Dh/2]
    angles = positions[..., None].float() * freqs          # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        d, h, k, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim)
        self.wq = param(dense_init(gen, d, h * dh, dtype, device))
        self.wk = param(dense_init(gen, d, k * dh, dtype, device))
        self.wv = param(dense_init(gen, d, k * dh, dtype, device))
        self.wo = param(dense_init(gen, h * dh, d, dtype, device))
        if cfg.qk_norm:
            self.q_norm = param(torch.ones((dh,), dtype=torch.float32,
                                           device=device))
            self.k_norm = param(torch.ones((dh,), dtype=torch.float32,
                                           device=device))


def _heads(cfg: ModelConfig, p: Attention, tp=None
           ) -> Tuple[range, int, Tuple[int, ...]]:
    """(the query heads that ``p``'s ``wq`` columns touch, ``tp.q_heads``;
    the offset of those columns in the first; the kv heads they read,
    ``tp.kv_heads``): every head, or this process's under TP (``tp`` as
    ``_attn_tp`` gives it)."""
    if tp is None:
        return range(cfg.n_heads), 0, kv_heads(cfg.n_heads, cfg.n_kv_heads)
    heads, off = q_heads(cfg.n_heads, cfg.resolved_head_dim, p.wq.shape[-1],
                         model_coord(tp))
    return heads, off, kv_heads(cfg.n_heads, cfg.n_kv_heads,
                                tp.axis_size("model"), model_coord(tp))


def _attn_tp(cfg: ModelConfig, p: Attention, tp):
    """``tp`` if ``p`` holds a share of the heads, else None."""
    return tp_of(tp, p.wq.shape[-1], cfg.n_heads * cfg.resolved_head_dim)


def _take_heads(t: torch.Tensor, sel: Tuple[int, ...]) -> torch.Tensor:
    """``t [B, S, K, Dh]``'s heads ``sel`` (a head repeated where ``sel``
    repeats it), ``[B, S, len(sel), Dh]``: a view when ``sel`` is one
    range."""
    if sel == tuple(range(sel[0], sel[0] + len(sel))):
        return t.narrow(2, sel[0], len(sel))
    return torch.cat([t.narrow(2, head, 1) for head in sel], 2)


def _project_kv(cfg: ModelConfig, p: Attention, x: torch.Tensor, tp,
                sel: Tuple[int, ...]):
    """k, v ``[B, S, len(sel), Dh]`` of the kv heads ``sel`` (``x`` already
    inside the TP region).  A process whose ``wk``/``wv`` columns are
    those heads projects them alone; else the peers' column slices are
    gathered over "model" (``gather_cols``) or, for a whole ``wk``/``wv``,
    every head is projected, and the heads ``sel`` kept."""
    b, s, _ = x.shape
    n_kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    wk, wv = p.wk.to(x.dtype), p.wv.to(x.dtype)
    cols = wk.shape[-1]
    kv_tp = tp_of(tp, cols, n_kv * dh)
    if kv_tp is not None and cols == len(sel) * dh \
            and model_coord(kv_tp) * cols == sel[0] * dh:
        return (x @ wk).reshape(b, s, len(sel), dh), \
            (x @ wv).reshape(b, s, len(sel), dh)
    if kv_tp is not None:
        kk, v = gather_cols(kv_tp, torch.stack([x @ wk, x @ wv])).unbind(0)
    else:
        # whole weights (no TP, or a leaf its spec keeps whole: its
        # gradient summed over the peers that read it)
        wk, wv = copy_in(tp, wk), copy_in(tp, wv)
        kk, v = x @ wk, x @ wv
    kk, v = kk.reshape(b, s, n_kv, dh), v.reshape(b, s, n_kv, dh)
    if sel == tuple(range(n_kv)):
        return kk, v
    # contiguous, as the other paths' projections are
    return _take_heads(kk, sel).contiguous(), _take_heads(v, sel).contiguous()


def _project_q(cfg: ModelConfig, p: Attention, x: torch.Tensor, tp,
               heads: range) -> torch.Tensor:
    """q ``[B, S, len(heads), Dh]`` of the query heads ``heads`` that
    ``p``'s ``wq`` columns touch (``x`` already inside the TP region): the
    projection alone where those columns are the heads, else the peers'
    column slices gathered over "model" and the heads kept."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    if q.shape[-1] != len(heads) * dh:
        q = gather_cols(tp, q).narrow(-1, heads.start * dh, len(heads) * dh)
    return q.reshape(b, s, len(heads), dh)


def _own_cols(out: torch.Tensor, off: int, cols: int) -> torch.Tensor:
    """``out [..., h·Dh]``, the output of the query heads a process's
    ``wq`` columns touch, narrowed to those ``cols`` columns from ``off``:
    the rows of ``wo`` it holds."""
    return out if out.shape[-1] == cols else out.narrow(-1, off, cols)


def _project_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                 positions: torch.Tensor, rope: bool = True, tp=None,
                 sp=None):
    """q, k, v of the query heads ``p``'s ``wq`` columns touch and the kv
    heads they read (``_heads``), and the offset of those columns in the
    first head; ``tp`` (or None) as ``_attn_tp`` gives it, ``sp`` the
    sequence chunks ``x`` is one of under SP (``tp.enter``)."""
    heads, off, sel = _heads(cfg, p, tp)
    x = enter(tp, sp, x)
    q = _project_q(cfg, p, x, tp, heads)
    kk, v = _project_kv(cfg, p, x, tp, sel)
    if cfg.qk_norm:
        q = rms_head_norm(q, copy_in(tp, p.q_norm))
        kk = rms_head_norm(kk, copy_in(tp, p.k_norm))
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        kk = apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, v, off


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, k, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, k, n_rep, dh).reshape(
        b, s, k * n_rep, dh)


def _band_mask(sq: int, skv: int, q_offset: int, window: Optional[int],
               causal: bool, device) -> torch.Tensor:
    """[sq, skv] bool mask. q position = q_offset + i, kv position = j."""
    qi = q_offset + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def mha_einsum(q, k, v, mask) -> torch.Tensor:
    """Reference attention: q [B,Sq,H,Dh], k/v [B,Skv,H,Dh], mask [Sq,Skv]."""
    dh = q.shape[-1]
    # f32 scores, as the reference's division by a numpy scalar promotes
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mha_chunked(q, k, v, *, q_offset: int, window: Optional[int],
                causal: bool, use_window: bool = True, q_chunk: int = 1024,
                kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax chunked attention: O(Sq*chunk) memory."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    n_q, n_kv = sq // q_chunk, skv // kv_chunk
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    outs = []
    for qi in range(n_q):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, q_chunk, h, dh), dtype=torch.float32,
                          device=dev)
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk,
                                                      device=dev)[:, None]
        for kj in range(n_kv):
            kc = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vc = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() * scale
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos <= qpos
            if window is not None and use_window:
                mask &= kpos > qpos - window
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + pr.sum(-1)
            acc = acc * corr.transpose(1, 2)[..., None]
            acc = acc + torch.einsum("bhqk,bkhd->bqhd", pr.to(q.dtype),
                                     vc).float()
            m = m_new
        out = acc / torch.clamp(lsum.transpose(1, 2)[..., None], min=1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None, use_window: bool = True,
                    chunked_threshold: int = 2048, return_kv: bool = False,
                    use_kernel: bool = True, tp=None, sp=None):
    """Self-attention over a full sequence (prefill).

    ``use_kernel`` runs it on the ``flash_attention`` kernel over the
    un-repeated keys and values, handed as ``[B, H, S, D]`` views of the
    projections (no copy; the kernel reads through the strides and writes
    ``[B, S, H, D]``); False runs the reference's plain math.  ``use_window=False``
    drops the window.  With ``return_kv`` also returns the (pre-GQA-repeat)
    keys/values of the kv heads read (``_heads``).  ``tp``: the
    ``ProcessMesh`` of a TP run (the query heads ``p``'s columns touch and
    the kv heads they read, this process's columns of their output times
    its ``wo`` rows summed over "model"), or None.  ``sp``: under SP
    (``tp.SeqShard``) ``x`` is this process's sequence chunk, gathered on
    entry, and the output is its chunk of the sum; the keys and values are
    the whole sequence's."""
    with trace.span("attn"):
        tp = _attn_tp(cfg, p, tp)
        q, k, v, off = _project_qkv(cfg, p, x, positions, tp=tp, sp=sp)
        b, s, h = q.shape[:3]
        kv = k.shape[2]
        eff = window if (window is not None and use_window) else None
        if use_kernel:
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=eff).transpose(1, 2)
        elif s > chunked_threshold:
            out = mha_chunked(q, _repeat_kv(k, h // kv),
                              _repeat_kv(v, h // kv), q_offset=0,
                              window=window, use_window=use_window,
                              causal=causal)
        else:
            out = mha_einsum(q, _repeat_kv(k, h // kv),
                             _repeat_kv(v, h // kv),
                             _band_mask(s, s, 0, eff, causal, x.device))
        out = _own_cols(out.reshape(b, s, h * cfg.resolved_head_dim), off,
                        p.wo.shape[0])
        out = row_parallel(tp, torch.matmul, out, p.wo.to(out.dtype), sp=sp)
        if not return_kv:
            return out
        return out, (k, v)


def assemble_kv_cache(k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int], cache_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place prefill keys/values [B, S, K, Dh] into a decode cache of
    physical length min(cache_len, window or cache_len), ring-aligned so
    position p lives at slot p % phys (matching attention_decode)."""
    s = k.shape[1]
    phys = cache_len if window is None else min(cache_len, window)

    def place(x):
        if s >= phys:
            xw = x[:, s - phys:]
            shift = s % phys
            return torch.roll(xw, shift, dims=1) if shift else xw.clone()
        return F.pad(x, (0, 0, 0, 0, 0, phys - s))

    return place(k), place(v)


def attention_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window: Optional[int] = None, tp=None):
    """One-token decode against a (ring-buffered, if windowed) KV cache.

    x [B, 1, d]; caches [B, S_phys, K, Dh] (the kv heads that the query
    heads ``p``'s columns touch read, ``_heads``), written in place at
    ``pos``.  Returns (out [B, 1, d], cache_k, cache_v); ``tp`` as
    ``attention_apply``'s."""
    b, dh = x.shape[0], cfg.resolved_head_dim
    tp = _attn_tp(cfg, p, tp)
    s_phys = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new, off = _project_qkv(cfg, p, x, positions, tp=tp)
    h, kv = q.shape[2], k_new.shape[2]
    slot = pos if window is None else pos % s_phys
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    g = h // kv
    q5 = q.reshape(b, 1, kv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bqkgs", q5, cache_k).float() \
        / math.sqrt(dh)
    valid = torch.arange(s_phys, device=x.device) < min(pos + 1, s_phys)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs, cache_v)
    out = _own_cols(out.reshape(b, 1, h * dh), off, p.wo.shape[0])
    out = row_parallel(tp, torch.matmul, out, p.wo.to(x.dtype))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device, d_ff: Optional[int] = None):
        super().__init__()
        d = cfg.d_model
        f = d_ff or cfg.d_ff
        if cfg.act == "silu":
            self.w_gate = param(dense_init(gen, d, f, dtype, device))
            self.w_up = param(dense_init(gen, d, f, dtype, device))
            self.w_down = param(dense_init(gen, f, d, dtype, device))
        else:
            self.w_up = param(dense_init(gen, d, f, dtype, device))
            self.b_up = param(torch.zeros((f,), dtype=torch.float32,
                                          device=device))
            self.w_down = param(dense_init(gen, f, d, dtype, device))
            self.b_down = param(torch.zeros((d,), dtype=torch.float32,
                                            device=device))


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor,
              tp=None, sp=None) -> torch.Tensor:
    """The MLP; under TP (``tp``, and ``p`` holding a slice of the hidden
    dim) on this process's slice, the partial products summed over
    "model"; ``sp`` as ``attention_apply``'s (``b_down`` is then added to
    the chunk)."""
    dt = x.dtype
    tp = tp_of(tp, p.w_down.shape[0], cfg.d_ff)
    x = enter(tp, sp, x)
    if cfg.act == "silu":
        h = F.silu(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
        return row_parallel(tp, torch.matmul, h, p.w_down.to(dt), sp=sp)
    h = F.gelu(x @ p.w_up.to(dt) + p.b_up.to(dt), approximate="tanh")
    return row_parallel(tp, torch.matmul, h, p.w_down.to(dt), sp=sp) \
        + p.b_down.to(dt)
