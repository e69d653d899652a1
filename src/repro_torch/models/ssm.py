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
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..configs.registry import ModelConfig
from .layers import dense_init, param

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


def mlstm_zero_state(cfg: ModelConfig, batch: int, device="cuda") -> State:
    h = cfg.n_heads
    dh = cfg.d_model // h
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=_F32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=_F32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=_F32, device=device),
    }


def _mlstm_step(state: State, q, k, v, it, ft) -> Tuple[State, torch.Tensor]:
    """q, k, v [B, H, Dh]; it, ft [B, H]; all f32."""
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


def _mlstm_inputs(cfg: ModelConfig, p: MLSTM, x: torch.Tensor):
    """q, k, v [B, T, H, Dh] and the i, f gate pre-activations [B, T, H],
    all f32; k is cast before its 1/sqrt(Dh) scale, as the reference's."""
    b, t, d = x.shape
    h = cfg.n_heads
    dh = d // h
    dt = x.dtype
    q = (x @ p.wq.to(dt)).reshape(b, t, h, dh).float()
    k = (x @ p.wk.to(dt)).reshape(b, t, h, dh).float() / math.sqrt(dh)
    v = (x @ p.wv.to(dt)).reshape(b, t, h, dh).float()
    gf = (x @ p.wif.to(dt)).float().reshape(b, t, 2, h)
    return q, k, v, gf[:, :, 0], gf[:, :, 1]


def mlstm_apply(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                return_state: bool = False):
    """x [B, T, d] -> [B, T, d] (and, with ``return_state``, the state
    after the last step)."""
    b, t, d = x.shape
    steps = zip(*(a.unbind(1) for a in _mlstm_inputs(cfg, p, x)))
    state = mlstm_zero_state(cfg, b, x.device)
    hs = []
    with record_function("ssm_scan"):
        for ins in steps:
            state, h = _mlstm_step(state, *ins)
            hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(b, t, d).to(x.dtype)
    z = F.silu(x @ p.wz.to(x.dtype))
    out = (hs * z) @ p.wo.to(x.dtype)
    return (out, state) if return_state else out


def mlstm_decode(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    """x [B, 1, d]: one recurrent step."""
    q, k, v, it, ft = _mlstm_inputs(cfg, p, x)
    state, h = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], it[:, 0],
                           ft[:, 0])
    b, d = x.shape[0], x.shape[-1]
    h = h.reshape(b, 1, d).to(x.dtype)
    z = F.silu(x @ p.wz.to(x.dtype))
    return (h * z) @ p.wo.to(x.dtype), state


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


def slstm_zero_state(cfg: ModelConfig, batch: int, device="cuda") -> State:
    d = cfg.d_model
    return {
        "c": torch.zeros((batch, d), dtype=_F32, device=device),
        "n": torch.ones((batch, d), dtype=_F32, device=device),
        "h": torch.zeros((batch, d), dtype=_F32, device=device),
        "m": torch.full((batch, d), -1e30, dtype=_F32, device=device),
    }


def _slstm_step(r: torch.Tensor, state: State, wx_t: torch.Tensor
                ) -> Tuple[State, torch.Tensor]:
    """wx_t [B, 4d]: the input's share of the pre-activations; ``r`` the
    recurrent weights in f32."""
    pre = wx_t + state["h"] @ r
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


def slstm_apply(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
                return_state: bool = False):
    b = x.shape[0]
    wx = (x @ p.w.to(x.dtype)).float()                  # [B, T, 4d]
    r = p.r.float()
    state = slstm_zero_state(cfg, b, x.device)
    hs = []
    with record_function("ssm_scan"):
        for wx_t in wx.unbind(1):
            state, h = _slstm_step(r, state, wx_t)
            hs.append(h)
    out = torch.stack(hs, dim=1).to(x.dtype) @ p.wo.to(x.dtype)
    return (out, state) if return_state else out


def slstm_decode(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    wx = (x[:, 0] @ p.w.to(x.dtype)).float()
    state, h = _slstm_step(p.r.float(), state, wx)
    return h[:, None].to(x.dtype) @ p.wo.to(x.dtype), state


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


def mamba_zero_state(cfg: ModelConfig, batch: int, device="cuda") -> State:
    d_in = cfg.d_model
    n = cfg.ssm_state or 16
    return {
        "h": torch.zeros((batch, d_in, n), dtype=_F32, device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, d_in), dtype=_F32,
                            device=device),
    }


def _mamba_scan_inputs(p: Mamba, xt: torch.Tensor):
    """xt [B, T, d_in] after the conv -> dt, B_t, C_t (f32)."""
    x32 = xt.float()
    dt = softplus(x32 @ p.w_dt.float() @ p.w_dt2.float() + p.dt_bias)
    return dt, x32 @ p.wb.float(), x32 @ p.wc.float()


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
                return_state: bool = False):
    """x [B, T, d] -> [B, T, d].  With ``return_state`` also the decode
    state: the last SSM state and the last ``K - 1`` conv inputs, which
    needs ``T >= K - 1`` (the reference's next decode step fails on the
    shorter window of a shorter prompt)."""
    b, t, _ = x.shape
    if return_state and t < _CONV_K - 1:
        raise ValueError(f"a Mamba prompt needs at least {_CONV_K - 1} "
                         f"tokens to leave a decode state, got {t}")
    xt_pre, z = torch.chunk(x @ p.in_proj.to(x.dtype), 2, dim=-1)
    xt = F.silu(_causal_depthwise_conv(xt_pre, p.conv_w.to(x.dtype)))
    dt, b_t, c_t = _mamba_scan_inputs(p, xt)
    a = -torch.exp(p.a_log)                                 # [d_in, N]
    x32 = xt.float()
    # the state-free terms for every step, time-major [T, B, d_in, N]
    da = torch.exp(dt.transpose(0, 1)[..., None] * a)
    dbx = (dt * x32).transpose(0, 1)[..., None] * b_t.transpose(0, 1)[
        :, :, None, :]
    h = torch.zeros((b, x.shape[-1], a.shape[-1]), dtype=_F32,
                    device=x.device)
    hs = []
    with record_function("ssm_scan"):
        # unbind, not indexing: under autograd each index's backward would
        # write a gradient the size of the whole tensor
        for da_t, dbx_t in zip(da.unbind(0), dbx.unbind(0)):
            h = da_t * h + dbx_t
            hs.append(h)
    y = (torch.stack(hs, dim=1) * c_t[:, :, None, :]).sum(-1) \
        + p.d_skip * x32                                    # [B, T, d_in]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p.out_proj.to(x.dtype)
    if not return_state:
        return out
    return out, {"h": h, "conv": xt_pre[:, t - (_CONV_K - 1):].float()}


def mamba_decode(cfg: ModelConfig, p: Mamba, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    """x [B, 1, d]: one step; the conv runs in f32 over the carried
    window."""
    xt_new, z = torch.chunk(x[:, 0] @ p.in_proj.to(x.dtype), 2, dim=-1)
    win = torch.cat([state["conv"], xt_new[:, None].float()], dim=1)
    xt = F.silu((win * p.conv_w.float()[None]).sum(dim=1))  # [B, d_in]
    dt, b_t, c_t = _mamba_scan_inputs(p, xt[:, None])
    a = -torch.exp(p.a_log)
    dt, b_t, c_t = dt[:, 0], b_t[:, 0], c_t[:, 0]
    h = torch.exp(dt[..., None] * a) * state["h"] \
        + (dt * xt)[..., None] * b_t[:, None, :]
    y = (h * c_t[:, None, :]).sum(-1) + p.d_skip * xt
    y = (y.to(x.dtype) * F.silu(z))[:, None]
    return y @ p.out_proj.to(x.dtype), {"h": h, "conv": win[:, 1:]}
