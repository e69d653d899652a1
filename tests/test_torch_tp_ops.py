"""The tensor-parallel operators (``models/tp.py``) on 2 and 4 gloo
processes of a (1, 1, tp) ``ProcessMesh``, against whole-tensor math:

* ``copy_in``: the identity forward; its gradient the sum of every peer's;
* ``sum_out``: the sum of the peers' parts forward; the gradient passed on;
  the scatter of a large operand's sum the same bits as the gather of a
  small one's;
* the vocabulary-parallel lookup (``transformer._embed_tokens`` on a table
  sharded over "model"): the whole table's rows, and the table's gradient
  the whole's slice;
* the vocabulary-parallel cross entropy (``transformer._vocab_parallel_nll``,
  f32 and ``bf16_ce``): lse and the label's logit, and their gradient with
  respect to the logits' shard;
* ``argmax_over`` on rows with planted ties, within a shard and across
  shards: the whole row's ``torch.argmax`` (the lowest index);
* the pod axis's int8 gradient compression (``train._compress_pod_grads``)
  of a leaf sharded over "model" whose largest magnitude lies in the last
  peer's slice: each peer's slice of the whole tensor's compression (its
  scale the whole tensor's, not its slice's).

The forward and ``autograd.grad`` within 1e-6 of the whole math (f32; the
bf16 cross entropy within its rounding), and every peer's forward bit for
bit the others'.  One spawn per world size.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.procs import spawn
from repro_torch.launch.train import _compress_pod_grads, make_dist_context
from repro_torch.models import tp, transformer
from repro_torch.models.tp import argmax_over, copy_in, sum_out

AXES = ("pod", "data", "model")
SIZES = (2, 4)
ROWS, D, V = 6, 5, 16


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(ROWS, D)).astype(np.float32)
    cot = rng.normal(size=(4, ROWS, D)).astype(np.float32)   # per peer
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(2, 3))
    logits = rng.normal(size=(2, 3, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(2, 3))
    tied = rng.normal(size=(5, V)).astype(np.float32)
    m = tied.max() + 1.0
    tied[0, [1, 2]] = m                 # a tie inside the first shard
    tied[1, [3, V - 1]] = m             # across the first and last
    tied[2, [V // 2, V - 2]] = m        # across two later shards
    tied[3, :] = 0.0                    # every entry equal
    return x, cot, table, ids, logits, labels, tied


def _cfg(bf16_ce):
    return dataclasses.replace(smoke_config("llama3.2-1b"), vocab=V,
                               compute_dtype="float32", bf16_ce=bf16_ce)


def _peer(mesh):
    """This process's results of every operator."""
    n = mesh.axis_size("model")
    r = mesh.rank_coords[2]
    x, cot, table, ids, logits, labels, tied = (
        torch.from_numpy(np.asarray(a)) for a in _inputs())
    sl = slice(r * V // n, (r + 1) * V // n)
    out = {}

    xa = x.clone().requires_grad_(True)
    y = copy_in(mesh, xa)
    out["copy"] = y.detach().numpy()
    out["copy_grad"] = torch.autograd.grad((y * cot[r]).sum(),
                                           xa)[0].numpy()

    part = (x * (r + 1)).requires_grad_(True)
    y = sum_out(mesh, part)
    out["sum"] = y.detach().numpy()
    out["sum_grad"] = torch.autograd.grad((y * cot[0]).sum(),
                                          part)[0].numpy()
    # the same sum through the scatter and the gather of the sums that an
    # operand past GATHER_SUM_MAX_BYTES takes beyond two peers
    limit, tp.GATHER_SUM_MAX_BYTES = tp.GATHER_SUM_MAX_BYTES, 0
    try:
        out["sum_scattered"] = sum_out(mesh, part.detach()).numpy()
    finally:
        tp.GATHER_SUM_MAX_BYTES = limit

    shard = table[sl].clone().requires_grad_(True)
    params = types.SimpleNamespace(embed=shard)
    rows = transformer._embed_tokens(_cfg(False), params, ids, None, mesh)
    out["embed"] = rows.detach().numpy()
    out["embed_grad"] = torch.autograd.grad(
        (rows * cot[0, 0]).sum(), shard)[0].numpy()

    for bf16 in (False, True):
        lg = logits[..., sl]
        if bf16:
            lg = lg.bfloat16()
        lg = lg.clone().requires_grad_(True)
        lse, label = transformer._vocab_parallel_nll(
            _cfg(bf16), mesh, lg, labels[..., None])
        key = f"ce_{'bf16' if bf16 else 'f32'}"
        out[key] = torch.stack([lse, label]).detach().numpy()
        out[key + "_grad"] = torch.autograd.grad(
            (lse - label).mean(), lg)[0].float().numpy()

    out["argmax"] = argmax_over(mesh, tied[:, sl]).numpy()
    out["compressed"] = _compress_pod_grads(
        {"w": _grad()[:, sl]}, make_dist_context(_cfg(False), mesh),
        {"w": (None, "model")})["w"].numpy()
    return out


def _grad():
    """A gradient [ROWS, V] whose largest magnitude lies in the last
    vocabulary slice."""
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(ROWS, V)).astype(np.float32))
    g[0, V - 1] = 10.0
    return g


@pytest.fixture(scope="module", params=SIZES)
def peers(request, tmp_path_factory):
    n = request.param
    rdv = tmp_path_factory.mktemp(f"rdv{n}") / "store"
    return n, spawn(_peer, (1, 1, n), AXES, "gloo", "cpu",
                    init_method=f"file://{rdv}", timeout=60.0,
                    join_timeout=120)


def _whole_ce(bf16):
    *_, logits, labels, _ = _inputs()
    lg = torch.from_numpy(logits)
    if bf16:
        lg = lg.bfloat16()
    lg.requires_grad_(True)
    lab = torch.from_numpy(labels)[..., None]
    if bf16:
        m = lg.amax(-1, keepdim=True)
        denom = torch.exp(lg - m).sum(-1, dtype=torch.float32)
        lse = m[..., 0].float() + torch.log(denom)
        label = torch.gather(lg, -1, lab)[..., 0].float()
    else:
        m = lg.amax(-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.exp(lg - m).sum(-1))
        label = torch.gather(lg, -1, lab)[..., 0]
    grad = torch.autograd.grad((lse - label).mean(), lg)[0].float()
    return torch.stack([lse, label]).detach().numpy(), grad.numpy()


def _same_on_every_peer(outs, key):
    for o in outs[1:]:
        assert np.array_equal(o[key], outs[0][key]), key


def test_copy_in(peers):
    n, outs = peers
    x, cot, *_ = _inputs()
    _same_on_every_peer(outs, "copy")
    _same_on_every_peer(outs, "copy_grad")
    assert np.array_equal(outs[0]["copy"], x)
    want = sum(cot[r] for r in range(n))
    assert np.abs(outs[0]["copy_grad"] - want).max() < 1e-6


def test_sum_out(peers):
    n, outs = peers
    x, cot, *_ = _inputs()
    _same_on_every_peer(outs, "sum")
    want = sum(x * (r + 1) for r in range(n))
    assert np.abs(outs[0]["sum"] - want).max() < 1e-6
    for o in outs:
        assert np.array_equal(o["sum_grad"], cot[0])


def test_sum_out_scattered_is_the_gathered_sum(peers):
    """A sum over more than two peers takes one gather of every peer's
    operand up to ``GATHER_SUM_MAX_BYTES``, else a scatter, a member-order
    sum of each chunk and a gather: the same bits either way."""
    _, outs = peers
    _same_on_every_peer(outs, "sum_scattered")
    for o in outs:
        assert np.array_equal(o["sum_scattered"], o["sum"])


def test_vocab_parallel_lookup(peers):
    n, outs = peers
    _, cot, table, ids, *_ = _inputs()
    _same_on_every_peer(outs, "embed")
    assert np.array_equal(outs[0]["embed"], table[ids])
    whole = np.zeros_like(table)
    np.add.at(whole, ids.reshape(-1), np.broadcast_to(
        cot[0, 0], (ids.size, D)))
    for r, o in enumerate(outs):
        sl = slice(r * V // n, (r + 1) * V // n)
        assert np.abs(o["embed_grad"] - whole[sl]).max() < 1e-6


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vocab_parallel_cross_entropy(peers, dtype):
    n, outs = peers
    key = f"ce_{dtype}"
    _same_on_every_peer(outs, key)
    want, grad = _whole_ce(dtype == "bf16")
    tol = 1e-6 if dtype == "f32" else 2e-2
    assert np.abs(outs[0][key] - want).max() <= tol * np.abs(want).max()
    for r, o in enumerate(outs):
        sl = slice(r * V // n, (r + 1) * V // n)
        g = o[key + "_grad"]
        assert np.abs(g - grad[..., sl]).max() <= tol * np.abs(grad).max()


def test_compression_scale_is_the_whole_tensors(peers):
    n, outs = peers
    mesh = make_mesh((1, 1, 1), AXES, device="cpu")
    whole = _compress_pod_grads({"w": _grad()}, make_dist_context(
        _cfg(False), mesh))["w"].numpy()
    for r, o in enumerate(outs):
        sl = slice(r * V // n, (r + 1) * V // n)
        assert np.array_equal(o["compressed"], whole[:, sl]), r


def test_sharded_argmax_keeps_the_lowest_index(peers):
    _, outs = peers
    *_, tied = _inputs()
    _same_on_every_peer(outs, "argmax")
    want = torch.from_numpy(tied).argmax(-1).numpy()
    assert np.array_equal(outs[0]["argmax"], want)
    assert list(want[:4]) == [1, 3, V // 2, 0]
