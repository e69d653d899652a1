"""``flash_attention_bwd``'s instance rule and its wrapper, on the CPU.

* ``variant(dtype, d, aligned)``: ``"wgmma"`` for bf16 with a head dim that
  is a multiple of 8 and rows TMA can address (``rows_aligned``: every base
  on 16 bytes, every batch, head and sequence stride of a dimension wider
  than 1 a nonzero multiple of 16 bytes), ``"simt"`` for everything else;
  the training shapes, as ``[B, S, H, D]`` views, take ``"wgmma"``.
* ``launches_by_variant`` sits beside ``launches``, keyed by instance, and
  a CPU call (the plain version) counts in neither.
* The wrapper's backward on the CPU (its plain version) against
  ``jax.grad`` of the reference's einsum attention, at the shapes where
  the instances divide: head dims 40 and 64, GQA 4, a window of 5, S not a
  multiple of 64, contiguous and ``[B, S, H, D]`` views.  Tolerance,
  relative to the largest reference gradient: 1e-5 in f32 (sums in another
  order) and 2e-2 in bf16 (one rounding of each result to bf16, the
  reference's own kernel tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.convert import to_torch
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_autograd, flash_attention_bwd,
    rows_aligned, variant)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NP = {"float32": np.float32, "bfloat16": jnp.bfloat16}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("d", [8, 40, 64, 100, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_variant_by_dtype_and_head_dim(dtype, d):
    want = "wgmma" if dtype == "bfloat16" and d % 8 == 0 else "simt"
    assert variant(DT[dtype], d) == want
    assert variant(DT[dtype], d, aligned=False) == "simt"


def _bshd(b, s, h, d, dtype=torch.bfloat16, pad=0, offset=0):
    """A ``[B, H, S, D]`` view of ``[B, S, H, D + pad]`` memory, its base
    ``offset`` elements into the storage."""
    n = b * s * h * (d + pad)
    flat = torch.zeros(n + offset, dtype=dtype)[offset:]
    return flat.view(b, s, h, d + pad)[..., :d].transpose(1, 2)


@pytest.mark.parametrize("d", [8, 40, 64, 100, 128])
@pytest.mark.parametrize("layout", ["contiguous", "view", "padded view",
                                    "base off 16 bytes", "stride 0"])
def test_rows_aligned_and_the_rule_on_layouts(layout, d):
    b, h, s = 2, 4, 37
    if layout == "contiguous":
        t = torch.zeros((b, h, s, d), dtype=torch.bfloat16)
        want = d % 8 == 0
    elif layout == "view":
        t = _bshd(b, s, h, d)
        want = d % 8 == 0
    elif layout == "padded view":        # rows d + 3 elements apart
        t = _bshd(b, s, h, d, pad=3)
        want = False
    elif layout == "base off 16 bytes":
        t = _bshd(b, s, h, d, offset=1)
        want = False
    else:                                # one head broadcast to all
        t = torch.zeros((b, 1, s, d), dtype=torch.bfloat16).expand(
            b, h, s, d)
        want = False
    assert rows_aligned(t) == want
    assert variant(t.dtype, d, rows_aligned(t)) == \
        ("wgmma" if want else "simt")
    # a dimension of extent 1 steps nowhere: its stride does not matter
    one = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 64), (3, 5, 7, 1))
    assert rows_aligned(one)


@pytest.mark.parametrize("shape", [(32, 32, 8, 512, 64),      # megatron train
                                   (1, 32, 8, 8192, 128)])    # mixtral long
def test_training_shapes_take_wgmma(shape):
    b, h, kv, s, d = shape
    q, o, do = (torch.empty((b, s, h, d), dtype=torch.bfloat16,
                            device="meta").transpose(1, 2)
                for _ in range(3))
    k, v = (torch.empty((b, s, kv, d), dtype=torch.bfloat16,
                        device="meta").transpose(1, 2) for _ in range(2))
    # meta tensors sit at address 0: the strides decide
    aligned = rows_aligned(q, k, v, o, do)
    assert aligned
    assert variant(q.dtype, d, aligned) == "wgmma"


def test_launches_by_variant_beside_launches():
    counts = flash_attention_bwd.launches_by_variant
    assert set(counts) == {"simt", "wgmma"}
    assert all(isinstance(n, int) for n in counts.values())
    before = (flash_attention_bwd.launches, dict(counts))
    q = torch.randn(1, 2, 5, 8)
    o, lse = flash_attention(q, q, q, return_lse=True)
    flash_attention_bwd(q, q, q, o, lse, torch.ones_like(o))
    # the CPU call ran the plain version: no launch, on any instance
    assert (flash_attention_bwd.launches,
            flash_attention_bwd.launches_by_variant) == before
    # reset as a run resets every count (chip_smoke.reset_launches)
    saved = before
    try:
        flash_attention_bwd.launches = 0
        flash_attention_bwd.launches_by_variant = dict.fromkeys(counts, 0)
        assert flash_attention_bwd.launches == 0
        assert not any(flash_attention_bwd.launches_by_variant.values())
    finally:
        flash_attention_bwd.launches = saved[0]
        flash_attention_bwd.launches_by_variant = saved[1]


def _jax_grads(q, k, v, do, causal, window):
    def loss(qq, kk, vv):
        o = jax_attention(qq, kk, vv, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * do.astype(np.float32))

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _rel(got: torch.Tensor, ref, scale) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.detach().float().numpy() - ref).max() / scale)


@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # b, h, kv, s, d, causal, window
    (1, 8, 2, 70, 40, True, 5),      # GQA 4, window 5, S off the tile
    (2, 8, 2, 100, 64, True, None),  # GQA 4, causal, S off the tile
    (1, 4, 1, 130, 64, False, 5),    # GQA 4, window without causality
    (1, 8, 2, 37, 40, False, None),  # GQA 4, no mask, S under one tile
])
def test_backward_vs_jax_grad(case, dtype, views):
    b, h, kv, s, d, causal, window = case
    rng = np.random.default_rng(s * 3 + d + h + len(dtype) + views)
    arrs = [(rng.normal(size=(b, n, s, d))).astype(np.float32).astype(
        NP[dtype]) for n in (h, kv, kv, h)]
    q, k, v, do = arrs
    ref = _jax_grads(q, k, v, do, causal, window)
    scale = max(float(np.abs(np.asarray(r, np.float32)).max()) for r in ref)

    def leaf(a):
        t = to_torch(a)
        if views:   # [B, S, H, D] memory seen as [B, H, S, D]
            t = t.transpose(1, 2).contiguous().transpose(1, 2)
        return t.requires_grad_()

    tq, tk, tv = (leaf(a) for a in (q, k, v))
    o = flash_attention_autograd(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(o, (tq, tk, tv), to_torch(do))
    for g, t, r in zip(got, (tq, tk, tv), ref):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, r, scale) < TOL[dtype]
    if views:
        assert variant(tq.dtype, d, rows_aligned(tq, tk, tv, o)) == (
            "wgmma" if dtype == "bfloat16" else "simt")
