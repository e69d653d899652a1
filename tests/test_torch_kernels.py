"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the reference's Pallas kernels run in interpret mode.

Pack and unpack must agree bit for bit (unpack on the blocks its index
names); grouped_matmul within the reference's own tolerances: relative error
< 1e-5 in f32 and < 2e-2 in bf16 (tests/test_kernels.py).  The rule that
picks grouped_matmul's kernel instance sends every served model's expert
products to the TMA + wgmma one, and shapes TMA cannot address to WMMA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.a2a_pack import a2a_pack_op, a2a_unpack_op
from repro.kernels.grouped_matmul import grouped_matmul_op
from repro_torch import _build
from repro_torch.convert import to_torch
from repro_torch.kernels.a2a_pack import a2a_pack, a2a_unpack
from repro_torch.kernels.a2a_pack.a2a_pack import _block_copy
from repro_torch.kernels.adamw import adamw as adamw_kernels
from repro_torch.configs import get_config
from repro_torch.kernels.grouped_matmul import grouped_matmul, variant

DTYPES = {"float32": np.float32, "bfloat16": jnp.bfloat16, "int8": np.int8}


def _data(rng, shape, dtype, scale=50.0):
    if dtype == "int8":
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(
        DTYPES[dtype])


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("block_rows", [1, 3, 8, 24])
@pytest.mark.parametrize("d", [5, 64, 130, 256])
def test_pack_unpack_bit_exact_vs_pallas(d, block_rows, dtype):
    """Pack by a random (repeating) index, unpack by an injective one into
    more output blocks than inputs, and the round trip."""
    rng = np.random.default_rng(d * 1000 + block_rows * 10 + len(dtype))
    r, n_blocks = block_rows, 6
    x = _data(rng, (n_blocks * r, d), dtype)
    idx = rng.integers(0, n_blocks, 10).astype(np.int32)
    ref = np.asarray(a2a_pack_op(jnp.asarray(x), jnp.asarray(idx),
                                 block_rows=r, interpret=True))
    got = a2a_pack(to_torch(x), torch.from_numpy(idx), block_rows=r)
    assert np.array_equal(_np(got).view(np.uint8), ref.view(np.uint8))

    n_out, m = 9, 5
    perm = rng.permutation(n_out)[:m].astype(np.int32)
    ref = np.asarray(a2a_unpack_op(jnp.asarray(x[: m * r]),
                                   jnp.asarray(perm), n_out_blocks=n_out,
                                   block_rows=r, interpret=True))
    got = _np(a2a_unpack(to_torch(x[: m * r]), torch.from_numpy(perm),
                         n_out_blocks=n_out, block_rows=r))
    named_ref = ref.reshape(n_out, r, d)[perm]
    named = got.reshape(n_out, r, d)[perm]
    assert np.array_equal(named.view(np.uint8), named_ref.view(np.uint8))

    order = rng.permutation(n_blocks).astype(np.int32)
    tx, ti = to_torch(x), torch.from_numpy(order)
    back = a2a_unpack(a2a_pack(tx, ti, block_rows=r), ti,
                      n_out_blocks=n_blocks, block_rows=r)
    assert torch.equal(back, tx)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("e,c,d,f", [
    (3, 37, 70, 45),
    (4, 128, 256, 128),
    (2, 64, 512, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_vs_pallas(e, c, d, f, masked, dtype):
    rng = np.random.default_rng(e * c + d + f)
    x = _data(rng, (e, c, d), dtype, 1.0)
    w = _data(rng, (e, d, f), dtype, 1.0)
    counts = rng.integers(0, c + 1, e).astype(np.int32) if masked else None
    ref = np.asarray(grouped_matmul_op(
        jnp.asarray(x), jnp.asarray(w),
        None if counts is None else jnp.asarray(counts),
        interpret=True)).astype(np.float32)
    got = grouped_matmul(to_torch(x), to_torch(w),
                         None if counts is None else torch.from_numpy(counts))
    assert got.dtype == getattr(torch, dtype)
    err = np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < (1e-5 if dtype == "float32" else 2e-2), err
    if masked:
        rows = np.arange(c)[None, :] >= counts[:, None]
        assert not got.float().numpy()[rows].any()


def test_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    """A CPU tensor never reaches the build: the wrappers call the plain
    versions and count no launch."""
    def no_build(name):
        raise AssertionError(f"CPU tensors must not load {name}")

    monkeypatch.setattr(_build, "load", no_build)
    before = (a2a_pack.launches, a2a_unpack.launches,
              grouped_matmul.launches)
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    idx = torch.tensor([2, 0, 1], dtype=torch.int32)
    assert torch.equal(a2a_pack(x, idx, block_rows=2),
                       x.reshape(3, 2, 4)[[2, 0, 1]].reshape(6, 4))
    assert torch.equal(a2a_unpack(x, idx, block_rows=2),
                       x.reshape(3, 2, 4)[[1, 2, 0]].reshape(6, 4))
    y = grouped_matmul(x.reshape(1, 6, 4), torch.ones(1, 4, 2),
                       torch.tensor([3], dtype=torch.int32))
    assert torch.equal(y[0, 3:], torch.zeros(3, 2))
    assert (a2a_pack.launches, a2a_unpack.launches,
            grouped_matmul.launches) == before


def test_kernels_raise_without_cuda():
    """Asking for a kernel with no CUDA device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("a2a_block_copy", "grouped_matmul", "adamw"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.load(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.build_all()
    x = torch.zeros(4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        _block_copy(x, x, torch.zeros(2, dtype=torch.int32), 2, 32, False)
    for fn in (adamw_kernels._norm_fn, adamw_kernels._step_fn):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


@pytest.mark.parametrize("bad", ["idx_dtype", "noncontig", "meta"])
def test_wrappers_reject_what_the_kernel_cannot_take(bad):
    """Checked on every device, so a CPU run finds what the card refuses."""
    x = torch.zeros(8, 4)
    idx = torch.zeros(2, dtype=torch.int32)
    w = torch.zeros(2, 4, 3)
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "noncontig":
        x = torch.zeros(4, 8).T
        w = torch.zeros(2, 3, 4).transpose(1, 2)
    else:
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(ValueError):
        a2a_pack(x, idx, block_rows=4)
    if bad != "idx_dtype":
        with pytest.raises(ValueError):
            grouped_matmul(x.reshape(2, 4, 4), w)


@pytest.mark.parametrize("arch", ["megatron-moe-32e", "mixtral-8x7b"])
def test_variant_rule_sends_serving_shapes_to_tma(arch):
    """Every bf16 expert product of the served models (gate/up [d, f] and
    down [f, d], prefill and decode alike: the rule reads only D and F) runs
    on the TMA + wgmma instance; shapes TMA cannot address take WMMA, f32
    takes the SIMT instance."""
    cfg = get_config(arch)
    d, f = cfg.d_model, cfg.d_ff
    for dd, ff in ((d, f), (f, d)):
        assert variant(torch.bfloat16, dd, ff) == "tma"
        assert variant(torch.float32, dd, ff) == "simt"
        assert variant(torch.bfloat16, dd, ff, aligned=False) == "wmma"
    assert variant(torch.bfloat16, 70, 45) == "wmma"       # (3, 37, 70, 45)
    assert variant(torch.bfloat16, 256, 513) == "wmma"
    assert variant(torch.bfloat16, 0, 64) == "wmma"
    assert variant(torch.bfloat16, 72, 200) == "tma"


def test_cpu_calls_count_no_variant(monkeypatch):
    """The per-instance counts move only with launches, never on the CPU."""
    monkeypatch.setattr(_build, "load", lambda name: None)
    before = dict(grouped_matmul.launches_by_variant)
    assert set(before) == {"simt", "wmma", "tma"}
    grouped_matmul(torch.ones(2, 3, 8, dtype=torch.bfloat16),
                   torch.ones(2, 8, 16, dtype=torch.bfloat16))
    assert grouped_matmul.launches_by_variant == before
