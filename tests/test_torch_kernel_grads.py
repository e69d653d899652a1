"""The port's kernels under a gradient, on the CPU, against ``jax.grad`` of
the reference's plain versions.

* ``grouped_matmul``: the autograd Function (``grouped_matmul_autograd``,
  whose backward is two more calls of the wrapper, here its plain version)
  against ``jax.grad`` of the reference's ``grouped_matmul_ref``, with and
  without (ragged) counts.
* Attention: the forward's ``lse`` and ``flash_attention_bwd_ref`` (the
  backward kernel's plain version), through the autograd Function
  ``flash_attention_autograd``, against ``jax.grad`` of the reference's
  ``attention_ref``: causal and not, with a window, GQA, ragged lengths.
* ``a2a_pack`` / ``a2a_unpack`` under a gradient raise
  ``NotImplementedError``, as ``jax.grad`` through the reference's Pallas
  pack raises.

Tolerances, relative to the largest reference value: 1e-5 in f32 (sums in
another order) and 2e-2 in bf16 (one rounding of each result to bf16, as
the reference's own kernel tests allow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

from repro.kernels.a2a_pack import a2a_pack_op, a2a_unpack_op
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_gmm
from repro_torch.convert import to_torch
from repro_torch.kernels.a2a_pack import a2a_pack, a2a_unpack
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_autograd, flash_attention_bwd,
    flash_attention_bwd_ref)
from repro_torch.kernels.grouped_matmul import grouped_matmul_autograd

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NP = {"float32": np.float32, "bfloat16": jnp.bfloat16}


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    diff = np.abs(got.detach().float().numpy() - ref).max()
    return float(diff / (np.abs(ref).max() + 1e-9))


def _arr(rng, shape, dtype, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(
        NP[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [None, "full", "ragged"])
@pytest.mark.parametrize("shape", [(3, 37, 20, 45), (2, 64, 32, 16)])
def test_grouped_matmul_grads_vs_jax(shape, counts, dtype):
    e, c, d, f = shape
    rng = np.random.default_rng(sum(shape) + len(dtype))
    x, w = _arr(rng, (e, c, d), dtype), _arr(rng, (e, d, f), dtype, 0.3)
    dy = _arr(rng, (e, c, f), dtype)
    cnt = None
    if counts == "full":
        cnt = np.full((e,), c, np.int32)
    elif counts == "ragged":
        cnt = np.array([0, c // 3, c][:e], np.int32)

    def loss(xx, ww):
        y = jax_gmm(xx, ww, None if cnt is None else jnp.asarray(cnt))
        return jnp.sum(y.astype(jnp.float32) * dy.astype(np.float32))

    ref_dx, ref_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(w))
    tx, tw = to_torch(x).requires_grad_(), to_torch(w).requires_grad_()
    y = grouped_matmul_autograd(
        tx, tw, None if cnt is None else torch.from_numpy(cnt))
    dx, dw = torch.autograd.grad(y, (tx, tw), to_torch(dy))
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    assert _rel(dx, ref_dx) < TOL[dtype]
    assert _rel(dw, ref_dw) < TOL[dtype]
    if cnt is not None:  # rows past the counts get no gradient
        for ee in range(e):
            assert not dx[ee, cnt[ee]:].any()


ATTN_CASES = [
    # b, h, kv, s, d, causal, window
    (2, 4, 2, 16, 8, True, None),      # GQA, causal
    (1, 4, 4, 37, 16, False, None),    # ragged S, no mask
    (1, 6, 2, 37, 12, True, 5),        # GQA 3, window, odd head dim
    (2, 2, 1, 70, 8, False, 9),        # window without causality
    (1, 2, 2, 1, 8, True, None),       # one token: a row that sees itself
    (1, 4, 2, 65, 16, True, 64),       # S one past a tile, window = tile
]


def _jax_attention_grads(q, k, v, do, causal, window):
    def loss(qq, kk, vv):
        o = jax_attention(qq, kk, vv, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * do.astype(np.float32))

    out = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    return out, grads


def _jax_lse(q, k, causal, window):
    b, h, s, d = q.shape
    kk = np.repeat(np.asarray(k, np.float32), h // k.shape[1], axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", np.asarray(q, np.float32), kk) \
        / np.sqrt(d)
    qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return np.asarray(logsumexp(jnp.where(mask, scores, -1e30), axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_grads_vs_jax(case, dtype):
    b, h, kv, s, d, causal, window = case
    rng = np.random.default_rng(s * 7 + d + len(dtype))
    q, k, v = (_arr(rng, (b, n, s, d), dtype) for n in (h, kv, kv))
    do = _arr(rng, (b, h, s, d), dtype)
    ref_o, ref_grads = _jax_attention_grads(q, k, v, do, causal, window)
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_autograd(tq, tk, tv, causal=causal, window=window)
    assert _rel(o, ref_o) < TOL[dtype]
    got = torch.autograd.grad(o, (tq, tk, tv), to_torch(do))
    for g, t, r in zip(got, (tq, tk, tv), ref_grads):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, r) < TOL[dtype]
    # the pieces: the forward's lse, and the plain backward itself
    o2, lse = flash_attention(tq.detach(), tk.detach(), tv.detach(),
                              causal=causal, window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert _rel(lse, _jax_lse(q, k, causal, window)) < 1e-5
    plain = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                    o2, lse, to_torch(do), causal=causal,
                                    window=window)
    wrapped = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o2,
                                  lse, to_torch(do), causal=causal,
                                  window=window)
    for p, w_, r in zip(plain, wrapped, ref_grads):
        assert torch.equal(p, w_)
        assert _rel(p, r) < TOL[dtype]


def test_attention_without_grad_writes_no_lse():
    """Serving's path: no gradient to take, so no Function and no lse."""
    q = torch.randn(1, 2, 5, 8)
    with torch.no_grad():
        o = flash_attention_autograd(q.requires_grad_(), q, q, causal=True)
    assert o.grad_fn is None


@pytest.mark.parametrize("which", ["pack", "unpack"])
def test_a2a_under_a_gradient_raises_as_the_reference(which):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    idx = np.array([2, 0, 5, 1], np.int32)
    if which == "pack":
        def jfn(a):
            return jnp.sum(a2a_pack_op(a, jnp.asarray(idx), interpret=True))

        def tfn(t):
            return a2a_pack(t, torch.from_numpy(idx))
    else:
        x = x[:4]

        def jfn(a):
            return jnp.sum(a2a_unpack_op(a, jnp.asarray(idx), n_out_blocks=6,
                                         interpret=True))

        def tfn(t):
            return a2a_unpack(t, torch.from_numpy(idx), n_out_blocks=6)
    with pytest.raises(NotImplementedError):
        jax.grad(jfn)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = tfn(t)
    assert out.grad_fn is not None     # not a silently detached result
    with pytest.raises(NotImplementedError, match="no gradient"):
        out.sum().backward()
    with torch.no_grad():              # serving: the plain call, no guard
        assert tfn(t).grad_fn is None


@pytest.mark.parametrize("transpose_x,transpose_w", [(True, False),
                                                     (False, True),
                                                     (True, True)])
def test_grouped_matmul_reads_transposed_operands(transpose_x, transpose_w):
    """The backward's forms: x stored as x^T [E, D, C], w as w^T [E, F, D];
    the same product as the plain version of the transposes, counts
    included."""
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(3, 40, 24, generator=g), torch.randn(3, 24, 16,
                                                            generator=g)
    counts = torch.tensor([40, 7, 0], dtype=torch.int32)
    got = grouped_matmul(
        x.transpose(1, 2).contiguous() if transpose_x else x,
        w.transpose(1, 2).contiguous() if transpose_w else w, counts,
        transpose_x=transpose_x, transpose_w=transpose_w)
    assert torch.equal(got, grouped_matmul_ref(x, w, counts))


def test_transposed_x_needs_rows_of_16_bytes_for_tma():
    """x^T's rows are C long: TMA takes them when C is a multiple of 8, so
    the rule sends the training shapes' dW to TMA and a ragged C to WMMA."""
    from repro_torch.kernels.grouped_matmul import variant
    bf16 = torch.bfloat16
    assert variant(bf16, 2304, 8192, c=2048) == "tma"     # dW, gate/up
    assert variant(bf16, 2304, 2048, c=8192) == "tma"     # dW, down
    assert variant(bf16, 8192, 2048) == "tma"             # dX, w^T
    assert variant(bf16, 64, 64, c=37) == "wmma"
    assert variant(torch.float32, 64, 64, c=8) == "simt"
