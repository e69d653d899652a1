"""The port's flash_attention and prefill attention against the reference.

* ``flash_attention`` on the CPU (its plain version) against the reference's
  Pallas kernel in interpret mode over the reference's own sweep
  (tests/test_kernels.py), absolute error < 2e-5 in f32 and < 2e-2 in bf16,
  and against the reference's plain ``attention_ref`` at ragged lengths the
  Pallas kernel cannot tile (< 2e-5, f32).
* ``attention_apply`` with ``use_kernel`` True (the kernel's path) and False
  (the plain math) against the reference's ``attention_apply``, f32, < 1e-5,
  with GQA, a sliding window and the chunked branch.
* The wrapper: what it refuses on every device, that a CPU tensor never
  reaches the build, that ``[B, S, H, D]`` memory seen as ``[B, H, S, D]``
  gives what contiguous copies give, bit for bit, and that the result is a
  view of ``[B, S, H, D]`` memory; and that ``attention_apply`` hands the
  kernel views of its projections, not copies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.kernels.flash_attention import attention_ref as ref_attention
from repro.kernels.flash_attention import flash_attention_op
from repro.models import layers as ref_layers
from repro_torch import _build
from repro_torch.configs import smoke_config
from repro_torch.convert import load_params, to_torch
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.models import layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(rng, b, h, kv, s, d, dtype):
    shapes = ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))
    arrs = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    if dtype == "bfloat16":
        arrs = [a.astype(jnp.bfloat16) for a in arrs]
    return arrs


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (2, 4, 2, 256, 64, True, None),
    (1, 4, 4, 256, 128, True, 64),
    (2, 2, 1, 512, 64, False, None),
    (1, 8, 2, 256, 128, True, 128),
    (1, 2, 2, 128, 128, True, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(b, h, kv, s, d, causal, window,
                                        dtype):
    rng = np.random.default_rng(b * s + h)
    q, k, v = _qkv(rng, b, h, kv, s, d, dtype)
    ref = flash_attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, interpret=True)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v),
                          causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(got.float().numpy() - _f32(ref)).max() < TOL[dtype]


@pytest.mark.parametrize("s", [1, 37, 130])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 5)])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_attention_ragged_matches_reference(s, causal, window, group):
    """Any S >= 1 and windows smaller than a tile: the port's plain version
    against the reference's oracle (the Pallas kernel needs S % 128 == 0)."""
    rng = np.random.default_rng(s * 10 + group)
    q, k, v = _qkv(rng, 2, 2 * group, 2, s, 16, "float32")
    ref = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < TOL["float32"]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kv,window,s,threshold", [
    (2, None, 24, 2048),    # GQA 2:1, full causal
    (2, 8, 24, 2048),       # GQA with a window shorter than the sequence
    (4, 8, 24, 2048),       # no GQA, windowed
    (2, 8, 32, 16),         # the reference's chunked branch (S > threshold)
])
def test_attention_apply_matches_reference(kv, window, s, threshold,
                                           use_kernel):
    over = dict(compute_dtype="float32", n_heads=4, n_kv_heads=kv)
    ref_cfg = dataclasses.replace(ref_smoke_config("mixtral-8x7b"), **over)
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"), **over)
    p = ref_layers.init_attention(jax.random.PRNGKey(kv + s), ref_cfg)
    attn = load_params(layers.Attention(cfg, torch.Generator(), torch.float32,
                                        "cpu"),
                       jax.tree.map(np.asarray, p))
    x = (np.random.default_rng(s).normal(size=(2, s, cfg.d_model))
         * 0.5).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    kw = dict(window=window, chunked_threshold=threshold, return_kv=True)
    ref, (rk, rv) = ref_layers.attention_apply(
        ref_cfg, p, jnp.asarray(x), positions=jnp.asarray(pos), **kw)
    with torch.no_grad():
        got, (k, v) = layers.attention_apply(
            cfg, attn, torch.from_numpy(x), positions=torch.from_numpy(pos),
            use_kernel=use_kernel, **kw)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-5
    assert np.abs(k.numpy() - np.asarray(rk)).max() < 1e-5
    assert np.abs(v.numpy() - np.asarray(rv)).max() < 1e-5


def test_use_window_false_drops_the_window():
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32")
    attn = layers.Attention(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    x = torch.from_numpy(rng.normal(size=(1, 20, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(20, dtype=torch.int32)[None]
    with torch.no_grad():
        outs = [layers.attention_apply(cfg, attn, x, positions=pos, window=w,
                                       use_window=uw, use_kernel=True)
                for w, uw in ((4, False), (None, True), (4, True))]
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError(f"CPU tensors must not load {name}")

    monkeypatch.setattr(_build, "load", no_build)
    before = flash_attention.launches
    q = torch.randn(1, 4, 9, 8)
    k = torch.randn(1, 2, 9, 8)
    got = flash_attention(q, k, k, causal=True, window=3)
    assert torch.equal(got, attention_ref(q, k, k, causal=True, window=3))
    assert flash_attention.launches == before


def test_kernel_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load("flash_attention")


@pytest.mark.parametrize("bad", ["head_dim", "noncontig", "dtype", "window",
                                 "groups", "meta"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    """Checked on every device, so a CPU run finds what the card refuses."""
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "head_dim":
        q, k, v = (torch.zeros(t.shape[:3] + (192,)) for t in (q, k, v))
    elif bad == "noncontig":  # the head dim must have unit stride
        q = torch.zeros(1, 4, 8, 32)[..., ::2]
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "window":
        kw["window"] = 0
    elif bad == "groups":
        k, v = torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16)
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_strided_views_match_contiguous_copies(group, causal, window):
    """q, k, v as [B, S, H, D] memory seen as [B, H, S, D] (what
    attention_apply passes) give the contiguous copies' result bit for bit,
    and the result is a [B, H, S, D] view of [B, S, H, D] memory."""
    rng = np.random.default_rng(group * 10 + causal)
    b, kv, s, d = 2, 2, 37, 16
    h = kv * group
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).transpose(1, 2) for n in (h, kv, kv))
    assert not q.is_contiguous() and q.stride(-1) == 1
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)
    assert torch.equal(got, want)
    assert got.shape == (b, h, s, d)
    assert got.transpose(1, 2).is_contiguous()


def test_attention_apply_hands_the_kernel_views(monkeypatch):
    """use_kernel=True passes the projections' own storage to
    flash_attention (transposed views, no .contiguous() copy) and reshapes
    the kernel's [B, S, H, D] result without a copy either."""
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32", n_heads=4,
                              n_kv_heads=2)
    attn = layers.Attention(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    seen = {}
    real_project, real_flash = layers._project_qkv, layers.flash_attention

    def project(*args, **kw):
        seen["proj"] = real_project(*args, **kw)
        return seen["proj"]

    def flash(q, k, v, **kw):
        seen["args"] = (q, k, v)
        seen["out"] = real_flash(q, k, v, **kw)
        return seen["out"]

    monkeypatch.setattr(layers, "_project_qkv", project)
    monkeypatch.setattr(layers, "flash_attention", flash)
    x = torch.randn(2, 20, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(20, dtype=torch.int32).expand(2, 20)
    with torch.no_grad():
        layers.attention_apply(cfg, attn, x, positions=pos, use_kernel=True)
    for proj, arg in zip(seen["proj"], seen["args"]):
        assert arg.untyped_storage().data_ptr() == \
            proj.untyped_storage().data_ptr()
        assert arg.shape == proj.transpose(1, 2).shape
        assert arg.stride() == proj.transpose(1, 2).stride()
    out = seen["out"].transpose(1, 2)
    assert out.is_contiguous()
    assert out.reshape(2, 20, -1).data_ptr() == out.data_ptr()
