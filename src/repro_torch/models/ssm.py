"""Recurrent blocks: xLSTM's mLSTM/sLSTM and Hymba's Mamba (selective SSM).

Counterpart of ``src/repro/models/ssm.py``.  Parameters live in ``MLSTM``,
``SLSTM`` and ``Mamba`` modules whose attribute names are the reference's
dict keys.  The reference's ``lax.scan`` over time is a Python loop over
time here, the same sequential form: one step function per block, shared by
the prompt pass and decode, on f32 states stabilized with the max-trick (the
``m`` state starts at ``-1e30``).  Terms that do not depend on the carried
state are computed for every time step before the loop where each element's
arithmetic stays the reference's: Mamba's ``exp(dt * a)`` and its
``dt * x * B`` input term, and its output ``sum(h * C) + D * x`` from the
stacked states after it.  Decode runs one step on a carried state.

These are plain PyTorch: the reference computes them outside any Pallas
kernel.  Each time loop runs inside a ``torch.profiler`` range named
``ssm_scan``, so that a trace can tell the loops' share of a prompt pass.

Under tensor parallelism (``tp``, a ``ProcessMesh`` whose "model" axis is
above 1; ``models/tp.py``) each block runs on this process's slice of the
reference's specs, which cut every projection's output columns and every
per-channel leaf over "model"; the input enters through ``copy_in`` and
the output projection (``wo``, ``out_proj``) is row-parallel
(``row_parallel``), so the model peers' outputs are the same bits:

* Mamba: process ``m`` owns the channels ``[m·c, (m+1)·c)`` of ``d_in``
  (``tp.channels``).  Its ``in_proj`` columns (a slice of ``[x | z]``,
  which does not line up with its channels) are gathered over "model"
  (``gather_cols``) and its own ``x`` and ``z`` channels kept
  (``_own_channels``); the conv, ``dt``'s second product, ``a_log``,
  ``d_skip`` and ``dt_bias`` act on own channels; ``w_dt``, ``wb`` and
  ``wc`` contract over ``d_in`` in one row-parallel product, summed over
  "model" in f32 once a call and entering the channels' terms through
  ``copy_in``.  The state ``h [B, c, N]`` and the conv window ``[B, K-1,
  c]`` are the reference's cache shards.
* mLSTM: the peers' ``q`` and ``k`` columns are gathered and the heads this
  process's columns touch kept (``tp.q_heads``, as attention's cut through
  a query head); ``v``, ``z`` and the output are its own columns; the
  gates' ``wif`` is gathered whole (or, kept whole by ``_drop_uneven``,
  enters through ``copy_in``).  The state holds the touched heads: ``C
  [B, h_t, dh, own v columns]`` (a touched head's ``dh`` columns, zero
  where they are not this process's, when the columns span two heads),
  ``n [B, h_t, dh]`` and ``m [B, h_t]`` whole, the same bits on the peers
  that share a head.  The reference's ``C`` spec shards the v dim of every
  head: the same bytes a process, and ``n`` replicated here.
* sLSTM: process ``m`` owns channels ``[m·c, (m+1)·c)`` of ``d``.  The
  peers' columns of ``w`` and ``r`` (z, i, f and o blocks) are gathered
  once a call and the whole products computed, its own channels' four
  gates kept: the same products as the whole layer's, so the same bits on
  the same input, where a product of another shape would round otherwise
  and the recurrence would amplify it (``PERF.md``); each step gathers
  ``h`` over "model" (``[B, c]`` to ``[B, d]``), the reference's own
  exchange under GSPMD.  ``c``, ``n`` and ``h`` are the reference's
  shards; ``m`` is kept per own channel where the reference's cache spec
  keeps it whole.

Each gather's backward is a member-order reduce-scatter, which gives each
owner the sum of the peers' cotangents of its columns: the right gradient.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..configs.registry import ModelConfig
from .layers import _own_cols, dense_init, param
from .tp import channels, copy_in, enter, gather_cols, model_coord, \
    q_heads, row_parallel, tp_of

__all__ = [
    "MLSTM", "SLSTM", "Mamba", "softplus",
    "mlstm_apply", "mlstm_decode", "mlstm_zero_state",
    "slstm_apply", "slstm_decode", "slstm_zero_state",
    "mamba_apply", "mamba_decode", "mamba_zero_state",
]

State = Dict[str, torch.Tensor]
_F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every ``x`` (torch's own
    returns ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# mLSTM (matrix memory)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        self.wq = param(dense_init(gen, d, d, dtype, device))
        self.wk = param(dense_init(gen, d, d, dtype, device))
        self.wv = param(dense_init(gen, d, d, dtype, device))
        self.wif = param(dense_init(gen, d, 2 * h, dtype, device))
        self.wz = param(dense_init(gen, d, d, dtype, device))
        self.wo = param(dense_init(gen, d, d, dtype, device))


def mlstm_zero_state(cfg: ModelConfig, batch: int, device="cuda",
                     heads: int = None, width: int = None) -> State:
    """The zero state of every head, or of ``heads`` touched heads each
    holding ``width`` v columns (a TP process's, ``_mlstm_layout``)."""
    h = cfg.n_heads if heads is None else heads
    dh = cfg.d_model // cfg.n_heads
    w = dh if width is None else width
    return {
        "C": torch.zeros((batch, h, dh, w), dtype=_F32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=_F32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=_F32, device=device),
    }


def _mlstm_step(state: State, q, k, v, it, ft) -> Tuple[State, torch.Tensor]:
    """q, k [B, H, Dh]; v [B, H, W]; it, ft [B, H]; all f32."""
    c, n, m = state["C"], state["n"], state["m"]
    fm = ft + m
    m_new = torch.maximum(fm, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(fm - m_new)
    c = f_p[..., None, None] * c \
        + i_p[..., None, None] * k[..., :, None] * v[..., None, :]
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return {"C": c, "n": n, "m": m_new}, num / den[..., None]


def _mlstm_layout(cfg: ModelConfig, p: MLSTM, tp):
    """(``tp`` if ``p`` holds a slice of the columns, else None; the heads
    its ``wv`` columns touch, ``tp.q_heads``; those columns' offset in the
    first; their number): every head without TP."""
    d = cfg.d_model
    tp = tp_of(tp, p.wv.shape[-1], d)
    if tp is None:
        return None, range(cfg.n_heads), 0, d
    heads, off = q_heads(cfg.n_heads, d // cfg.n_heads, p.wv.shape[-1],
                         model_coord(tp))
    return tp, heads, off, p.wv.shape[-1]


def _mlstm_inputs(cfg: ModelConfig, p: MLSTM, x: torch.Tensor, tp=None,
                  heads: range = None, off: int = 0):
    """q, k [B, T, H, Dh], v [B, T, H, W] and the i, f gate
    pre-activations [B, T, H], all f32; k is cast before its 1/sqrt(Dh)
    scale, as the reference's.  Under TP (``_mlstm_layout``'s, ``x``
    inside the TP region) the touched heads ``heads`` alone, and ``v`` this
    process's columns of them (a head's ``Dh``, zero outside them, when
    they span two heads)."""
    b, t, d = x.shape
    h = cfg.n_heads
    dh = d // h
    dt = x.dtype
    if tp is None:
        q = (x @ p.wq.to(dt)).reshape(b, t, h, dh).float()
        k = (x @ p.wk.to(dt)).reshape(b, t, h, dh).float() / math.sqrt(dh)
        v = (x @ p.wv.to(dt)).reshape(b, t, h, dh).float()
        gf = (x @ p.wif.to(dt)).float().reshape(b, t, 2, h)
        return q, k, v, gf[:, :, 0], gf[:, :, 1]
    n_t = len(heads)
    qk = gather_cols(tp, torch.stack([x @ p.wq.to(dt), x @ p.wk.to(dt)]))
    q, k = qk.narrow(-1, heads.start * dh, n_t * dh).unbind(0)
    q = q.reshape(b, t, n_t, dh).float()
    k = k.reshape(b, t, n_t, dh).float() / math.sqrt(dh)
    v = x @ p.wv.to(dt)
    cols = v.shape[-1]
    if n_t > 1:
        v = F.pad(v, (off, n_t * dh - off - cols))
    v = v.reshape(b, t, n_t, -1).float()
    if_tp = tp_of(tp, p.wif.shape[-1], 2 * h)
    gf = gather_cols(if_tp, x @ p.wif.to(dt)) if if_tp is not None \
        else x @ copy_in(tp, p.wif).to(dt)
    gf = gf.float().reshape(b, t, 2, h)[..., heads.start:heads.stop]
    return q, k, v, gf[:, :, 0], gf[:, :, 1]


def _mlstm_out(p: MLSTM, x: torch.Tensor, hs: torch.Tensor, tp, off: int,
               cols: int, sp=None) -> torch.Tensor:
    """``hs [B, T, H, W]`` (the touched heads' outputs): this process's
    columns of them times ``silu(z)``, into ``wo``'s rows."""
    b, t = hs.shape[:2]
    hs = _own_cols(hs.reshape(b, t, -1), off, cols).to(x.dtype)
    z = F.silu(x @ p.wz.to(x.dtype))
    return row_parallel(tp, torch.matmul, hs * z, p.wo.to(x.dtype), sp=sp)


def mlstm_apply(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                return_state: bool = False, tp=None, sp=None):
    """x [B, T, d] -> [B, T, d] (and, with ``return_state``, the state
    after the last step); ``tp`` as the module's docstring says; under SP
    (``sp``, a ``tp.SeqShard``) ``x`` and the output are this process's
    sequence chunks, the block running on the whole sequence between."""
    b = x.shape[0]
    tp, heads, off, cols = _mlstm_layout(cfg, p, tp)
    x = enter(tp, sp, x)
    ins = _mlstm_inputs(cfg, p, x, tp, heads, off)
    steps = zip(*(a.unbind(1) for a in ins))
    state = mlstm_zero_state(cfg, b, x.device, len(heads), ins[2].shape[-1])
    hs = []
    with record_function("ssm_scan"):
        for step in steps:
            state, h = _mlstm_step(state, *step)
            hs.append(h)
    out = _mlstm_out(p, x, torch.stack(hs, dim=1), tp, off, cols, sp)
    return (out, state) if return_state else out


def mlstm_decode(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                 state: State, tp=None) -> Tuple[torch.Tensor, State]:
    """x [B, 1, d]: one recurrent step."""
    tp, heads, off, cols = _mlstm_layout(cfg, p, tp)
    x = copy_in(tp, x)
    q, k, v, it, ft = _mlstm_inputs(cfg, p, x, tp, heads, off)
    state, h = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], it[:, 0],
                           ft[:, 0])
    return _mlstm_out(p, x, h[:, None], tp, off, cols), state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent gate inputs)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        d = cfg.d_model
        self.w = param(dense_init(gen, d, 4 * d, dtype, device))  # z,i,f,o
        self.r = param(dense_init(gen, d, 4 * d, dtype, device))  # recurrent
        self.wo = param(dense_init(gen, d, d, dtype, device))


def slstm_zero_state(cfg: ModelConfig, batch: int, device="cuda",
                     width: int = None) -> State:
    """The zero state of every channel, or of ``width`` channels (a TP
    process's own)."""
    d = cfg.d_model if width is None else width
    return {
        "c": torch.zeros((batch, d), dtype=_F32, device=device),
        "n": torch.ones((batch, d), dtype=_F32, device=device),
        "h": torch.zeros((batch, d), dtype=_F32, device=device),
        "m": torch.full((batch, d), -1e30, dtype=_F32, device=device),
    }


def _own_channels(t: torch.Tensor, tp) -> torch.Tensor:
    """``t [..., W]`` (a whole per-channel width, gathered over "model")
    narrowed to this process's channels (``tp.channels``)."""
    own = channels(tp, t.shape[-1])
    return t.narrow(-1, own.start, own.stop - own.start)


def _own_gates(t: torch.Tensor, tp) -> torch.Tensor:
    """``t [..., 4d]`` (the z, i, f, o blocks, whole): this process's
    channels of each block, ``[..., 4c]``."""
    return torch.cat([_own_channels(g, tp) for g in torch.chunk(t, 4, -1)],
                     -1)


def _slstm_tp(cfg: ModelConfig, p: SLSTM, tp):
    """``tp`` if ``p`` holds a slice of the gates' columns, else None."""
    tp = tp_of(tp, p.w.shape[-1], 4 * cfg.d_model)
    if tp is not None and p.wo.shape[0] == cfg.d_model:
        raise ValueError(f"sLSTM: w holds {p.w.shape[-1]} of "
                         f"{4 * cfg.d_model} columns but wo every row")
    return tp


def _slstm_step(r: torch.Tensor, state: State, wx_t: torch.Tensor,
                tp=None) -> Tuple[State, torch.Tensor]:
    """wx_t [B, 4c]: the input's share of the pre-activations of the
    channels ``state`` holds; ``r [d, 4d]`` the whole recurrent weights in
    f32.  Under TP the peers' ``h`` is gathered over "model" first and the
    own channels' gates of the whole product kept."""
    rec = gather_cols(tp, state["h"]) @ r
    pre = wx_t + (rec if tp is None else _own_gates(rec, tp))
    z, it, ft, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    fm = ft + state["m"]
    m_new = torch.maximum(fm, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(fm - m_new)
    c = f_p * state["c"] + i_p * z
    n = f_p * state["n"] + i_p
    h = o * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def _slstm_inputs(p: SLSTM, x: torch.Tensor, tp):
    """(wx [B, T, 4c] in f32 of the channels this process owns, every
    channel without TP; the whole ``r [d, 4d]`` in f32).  ``x`` lies
    inside the TP region; under TP the peers' columns of ``w`` and ``r``
    are gathered."""
    if tp is None:
        return (x @ p.w.to(x.dtype)).float(), p.r.float()
    w = gather_cols(tp, p.w)
    return _own_gates(x @ w.to(x.dtype), tp).float(), \
        gather_cols(tp, p.r.float())


def slstm_apply(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
                return_state: bool = False, tp=None, sp=None):
    """``sp`` as ``mlstm_apply``'s."""
    b = x.shape[0]
    tp = _slstm_tp(cfg, p, tp)
    x = enter(tp, sp, x)
    wx, r = _slstm_inputs(p, x, tp)
    state = slstm_zero_state(cfg, b, x.device, wx.shape[-1] // 4)
    hs = []
    with record_function("ssm_scan"):
        for wx_t in wx.unbind(1):
            state, h = _slstm_step(r, state, wx_t, tp)
            hs.append(h)
    out = row_parallel(tp, torch.matmul, torch.stack(hs, dim=1).to(x.dtype),
                       p.wo.to(x.dtype), sp=sp)
    return (out, state) if return_state else out


def slstm_decode(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
                 state: State, tp=None) -> Tuple[torch.Tensor, State]:
    tp = _slstm_tp(cfg, p, tp)
    x = copy_in(tp, x)
    wx, r = _slstm_inputs(p, x, tp)
    state, h = _slstm_step(r, state, wx[:, 0], tp)
    return row_parallel(tp, torch.matmul, h[:, None].to(x.dtype),
                        p.wo.to(x.dtype)), state


# ---------------------------------------------------------------------------
# Mamba (Hymba's parallel SSM path), Mamba-1 selective scan
# ---------------------------------------------------------------------------

_CONV_K = 4


def _dt_rank(d_in: int) -> int:
    return max(8, d_in // 16)


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        d = d_in = cfg.d_model
        n = cfg.ssm_state or 16
        r = _dt_rank(d_in)
        self.in_proj = param(dense_init(gen, d, 2 * d_in, dtype, device))
        self.conv_w = param((torch.randn((_CONV_K, d_in), generator=gen,
                                         dtype=_F32, device=device)
                             * 0.2).to(dtype))
        self.a_log = param(torch.log(torch.arange(
            1, n + 1, dtype=_F32, device=device)[None].repeat(d_in, 1)))
        self.d_skip = param(torch.ones((d_in,), dtype=_F32, device=device))
        self.wb = param(dense_init(gen, d_in, n, dtype, device))
        self.wc = param(dense_init(gen, d_in, n, dtype, device))
        self.w_dt = param(dense_init(gen, d_in, r, dtype, device))
        self.w_dt2 = param(dense_init(gen, r, d_in, dtype, device))
        self.dt_bias = param(torch.zeros((d_in,), dtype=_F32, device=device))
        self.out_proj = param(dense_init(gen, d_in, d, dtype, device))


def mamba_zero_state(cfg: ModelConfig, batch: int, device="cuda",
                     width: int = None) -> State:
    """The zero state of every channel, or of ``width`` channels (a TP
    process's own)."""
    d_in = cfg.d_model if width is None else width
    n = cfg.ssm_state or 16
    return {
        "h": torch.zeros((batch, d_in, n), dtype=_F32, device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, d_in), dtype=_F32,
                            device=device),
    }


def _mamba_tp(cfg: ModelConfig, p: Mamba, tp):
    """``tp`` if ``p`` holds a slice of the channels, else None."""
    tp = tp_of(tp, p.conv_w.shape[-1], cfg.d_model)
    if tp is None and p.in_proj.shape[-1] != 2 * cfg.d_model:
        raise ValueError(f"Mamba: in_proj holds {p.in_proj.shape[-1]} of "
                         f"{2 * cfg.d_model} columns but the channels' "
                         f"leaves are whole")
    return tp


def _mamba_in(p: Mamba, x: torch.Tensor, tp):
    """(x, z) of this process's channels from ``in_proj`` (``x`` inside the
    TP region): the peers' column slices of ``[x | z]`` gathered over
    "model", own channels of each half kept."""
    xz = x @ p.in_proj.to(x.dtype)
    if tp is None:
        return torch.chunk(xz, 2, dim=-1)
    xt, z = torch.chunk(gather_cols(tp, xz), 2, dim=-1)
    return _own_channels(xt, tp), _own_channels(z, tp)


def _mamba_scan_inputs(p: Mamba, xt: torch.Tensor, tp=None):
    """xt [B, T, c] after the conv -> dt [B, T, c], B_t, C_t [B, T, N]
    (f32): ``w_dt``, ``wb`` and ``wc`` contract over the channels in one
    product, summed over "model" under TP (one sum a call)."""
    r, n = p.w_dt.shape[-1], p.wb.shape[-1]
    w = torch.cat([p.w_dt, p.wb, p.wc], -1).float()
    dt_low, b_t, c_t = copy_in(tp, row_parallel(
        tp, torch.matmul, xt.float(), w)).split([r, n, n], -1)
    dt = softplus(dt_low @ p.w_dt2.float() + p.dt_bias)
    return dt, b_t, c_t


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, T, C]; w [K, C]; left-padded causal depthwise conv, summed tap
    by tap in x's dtype."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + t] * w[j]
    return out


def mamba_apply(cfg: ModelConfig, p: Mamba, x: torch.Tensor,
                return_state: bool = False, tp=None, sp=None):
    """x [B, T, d] -> [B, T, d].  With ``return_state`` also the decode
    state: the last SSM state and the last ``K - 1`` conv inputs, which
    needs ``T >= K - 1`` (the reference's next decode step fails on the
    shorter window of a shorter prompt).  ``tp`` as the module's docstring
    says, ``sp`` as ``mlstm_apply``'s."""
    tp = _mamba_tp(cfg, p, tp)
    x = enter(tp, sp, x)
    b, t, _ = x.shape
    if return_state and t < _CONV_K - 1:
        raise ValueError(f"a Mamba prompt needs at least {_CONV_K - 1} "
                         f"tokens to leave a decode state, got {t}")
    xt_pre, z = _mamba_in(p, x, tp)
    xt = F.silu(_causal_depthwise_conv(xt_pre, p.conv_w.to(x.dtype)))
    dt, b_t, c_t = _mamba_scan_inputs(p, xt, tp)
    a = -torch.exp(p.a_log)                                 # [c, N]
    x32 = xt.float()
    # the state-free terms for every step, time-major [T, B, c, N]
    da = torch.exp(dt.transpose(0, 1)[..., None] * a)
    dbx = (dt * x32).transpose(0, 1)[..., None] * b_t.transpose(0, 1)[
        :, :, None, :]
    h = torch.zeros((b, xt.shape[-1], a.shape[-1]), dtype=_F32,
                    device=x.device)
    hs = []
    with record_function("ssm_scan"):
        # unbind, not indexing: under autograd each index's backward would
        # write a gradient the size of the whole tensor
        for da_t, dbx_t in zip(da.unbind(0), dbx.unbind(0)):
            h = da_t * h + dbx_t
            hs.append(h)
    y = (torch.stack(hs, dim=1) * c_t[:, :, None, :]).sum(-1) \
        + p.d_skip * x32                                    # [B, T, c]
    y = y.to(x.dtype) * F.silu(z)
    out = row_parallel(tp, torch.matmul, y, p.out_proj.to(x.dtype), sp=sp)
    if not return_state:
        return out
    return out, {"h": h, "conv": xt_pre[:, t - (_CONV_K - 1):].float()}


def mamba_decode(cfg: ModelConfig, p: Mamba, x: torch.Tensor,
                 state: State, tp=None) -> Tuple[torch.Tensor, State]:
    """x [B, 1, d]: one step; the conv runs in f32 over the carried
    window."""
    tp = _mamba_tp(cfg, p, tp)
    x = copy_in(tp, x)
    xt_new, z = _mamba_in(p, x[:, 0], tp)
    win = torch.cat([state["conv"], xt_new[:, None].float()], dim=1)
    xt = F.silu((win * p.conv_w.float()[None]).sum(dim=1))  # [B, c]
    dt, b_t, c_t = _mamba_scan_inputs(p, xt[:, None], tp)
    a = -torch.exp(p.a_log)
    dt, b_t, c_t = dt[:, 0], b_t[:, 0], c_t[:, 0]
    h = torch.exp(dt[..., None] * a) * state["h"] \
        + (dt * xt)[..., None] * b_t[:, None, :]
    y = (h * c_t[:, None, :]).sum(-1) + p.d_skip * xt
    y = (y.to(x.dtype) * F.silu(z))[:, None]
    return row_parallel(tp, torch.matmul, y, p.out_proj.to(x.dtype)), \
        {"h": h, "conv": win[:, 1:]}
