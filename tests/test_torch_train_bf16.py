"""The port's bf16 training step against the reference's ``make_train_step``.

``smoke_config("megatron-moe-32e")`` as configured (f32 parameters, bf16
compute, remat), no mesh, the same parameters (the reference's ``init_lm``,
converted) and the same batch (``SyntheticLM``), one step.  The reference
runs in one subprocess on the CPU; each side's gradients are read where its
step hands them to ``adamw_update``, and each side's routing decisions
(the expert ids of every token's top-2, per layer, in the step's forward)
where its ``_route`` returns them.

In bf16 the two frameworks round at other places (XLA may keep f32 between
fused operations, PyTorch rounds after each), so a router's near-tie can
go either way, and a token routed to another expert moves its share of
that layer's expert gradients from one expert to another.  So the step is
held as Queue 3's near-tie rule says: count the routing decisions that
differ, and bound the rest loosely enough for bf16 rounding and for those
flips:

* routing: at most 2% of the decisions differ (the chip's bf16 runs flip
  0.7% to 2% between kernels and plain math; here 1 of 256);
* ``loss`` and ``nll`` within a relative 2e-3: each is a mean over 128
  tokens, whose logits differ by bf16 rounding (2^-8 relative) in no
  common direction, and a flipped token moves one token's loss of 128
  (here they differ by 5e-5); ``aux`` within 1e-2: a flip of a token's
  first choice moves one expert's routed fraction by 1/128;
* every gradient within a relative norm of 3e-2: a sum over tokens of
  products of bf16 values, each a few 2^-8 off, over two layers (here at
  most 2.2e-2); the MoE side of a layer whose routing flipped (its router,
  expert stacks and the norm in front) within 1e-1, since the flipped
  token's share moves between experts (here at most 5.2e-2, the router's).

The embedding's gradient is also held alone, on a batch that repeats one
token many times: under a gradient the port casts the table to bf16
before its gather, as the reference does, so the repeated token's gradient
sums in bf16 in both, to the same bits (on the old order, gather then
cast, it summed in f32 and missed by a tenth).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro.models.transformer import _embed_tokens as jax_embed
from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as pt_train
from repro_torch.models import moe as pt_moe
from repro_torch.models.transformer import _embed_tokens as pt_embed

ARCH = "megatron-moe-32e"
BATCH, SEQ = 8, 16
OPTIONS = {"peak_lr": 3e-4, "warmup_steps": 1, "total_steps": 10}
FLIP_SHARE, GRAD_TOL, FLIPPED_MOE_TOL = 2e-2, 3e-2, 1e-1
LOSS_TOL = {"loss": 2e-3, "nll": 2e-3, "aux": 1e-2}

_JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.models import build_model
from repro.models import moe as M
from repro.optim import init_opt_state

real_update, real_route = T.adamw_update, M._route
routes = []

def spy_update(grads, opt, params, lr, cfg):
    p, o, n = real_update(grads, opt, params, lr, cfg)
    return p, o, {"norm": n, "grads": grads}

def spy_route(cfg, router_w, x_flat):
    gates, eids, aux = real_route(cfg, router_w, x_flat)
    # keyed by the layer's router weight: XLA runs the callbacks of the
    # forward and of remat's recompute in an order of its own
    jax.debug.callback(lambda w, e: routes.append(
        (np.asarray(w, np.float64).sum(), np.sort(np.asarray(e), -1))),
        router_w, eids)
    return gates, eids, aux

T.adamw_update = spy_update   # the step reads its gradients out
M._route = spy_route          # and its routing decisions

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}

cfg = smoke_config(ARCH)
assert cfg.compute_dtype == "bfloat16"
params0 = build_model(cfg).init(jax.random.PRNGKey(0))
out = {f"init/{k}": v for k, v in flat(params0).items()}
data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                              global_batch=BATCH), cfg)
step, _, _, _ = T.make_train_step(cfg, None, T.TrainOptions(**OPTIONS))
state = {"params": params0, "opt": init_opt_state(params0),
         "step": jnp.zeros((), jnp.int32)}
batch = {k: jnp.asarray(v) for k, v in data.batch(0).items()}
state, m = step(state, batch)
gn = m.pop("grad_norm")
jax.effects_barrier()
for k, v in m.items():
    out[f"m/{k}"] = np.asarray(v)
for k, v in flat(gn["grads"]).items():
    out[f"g/{k}"] = v
# each layer's routing; remat's recompute must agree with the forward
for i, blk in enumerate(params0["blocks"]):
    key = np.asarray(blk["moe"]["router"], np.float64).sum()
    mine = [r for k, r in routes if k == key]
    assert len(mine) == 2 and np.array_equal(mine[0], mine[1]), len(mine)
    out[f"route/{i}"] = mine[0]
assert len(routes) == 2 * cfg.n_layers, len(routes)
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's bf16 step, in one subprocess."""
    path = os.path.join(tmp_path_factory.mktemp("train_bf16"), "ref.npz")
    out = run_subprocess(
        f"ARCH = {ARCH!r}\nBATCH, SEQ = {BATCH}, {SEQ}\n"
        f"OPTIONS = {OPTIONS!r}\nOUT = {path!r}\n" + _JAX_SIDE, n_devices=1)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    tree["blocks"] = [tree["blocks"][str(i)]
                      for i in range(len(tree["blocks"]))]
    return tree


@pytest.fixture(scope="module")
def port(ref):
    return _port_step(ref)


def _port_step(ref):
    """The port's bf16 step on the reference's parameters and batch: its
    metrics, the gradients it hands to AdamW, and its forward's routing."""
    cfg = smoke_config(ARCH)
    params = from_jax_params(_unflatten(_tree(ref, "init/")), cfg,
                             device="cpu", train=True)
    seen, routes = [], []
    real_update, real_route = pt_train.adamw_update, pt_moe._route

    def spy_update(grads, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return real_update(grads, *args)

    def spy_route(cfg, router_w, x_flat):
        out = real_route(cfg, router_w, x_flat)
        routes.append((router_w.detach().double().sum().item(),
                       out[1][0].sort(dim=-1).values.numpy()))
        return out

    pt_train.adamw_update, pt_moe._route = spy_update, spy_route
    try:
        step = pt_train.make_train_step(
            cfg, None, pt_train.TrainOptions(**OPTIONS), device="cpu")
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH), cfg)
        _, m = step(pt_train.init_train_state(params), data.batch(0))
    finally:
        pt_train.adamw_update, pt_moe._route = real_update, real_route
    by_layer = []
    for blk in params.blocks:
        key = blk.moe.router.detach().double().sum().item()
        mine = [r for k, r in routes if k == key]
        assert len(mine) == 2 and np.array_equal(mine[0], mine[1])
        by_layer.append(mine[0])
    assert len(routes) == 2 * cfg.n_layers   # the forward and remat's
    return {k: float(v) for k, v in m.items()}, seen[0], by_layer


def test_bf16_step_routing_flips_are_few(ref, port):
    routes = port[2]
    flips = total = 0
    for i, got in enumerate(routes):
        want = ref[f"route/{i}"]
        assert got.shape == want.shape
        flips += int((got != want).any(-1).sum())
        total += got.shape[0]
    assert flips <= FLIP_SHARE * total, (flips, total)


@pytest.mark.parametrize("key", list(LOSS_TOL))
def test_bf16_step_loss_matches_reference(ref, port, key):
    got, want = port[0][key], float(ref[f"m/{key}"])
    assert abs(got - want) <= LOSS_TOL[key] * abs(want), (key, got, want)


def test_bf16_step_grads_match_reference(ref, port):
    grads, routes = port[1], port[2]
    flipped = {i for i, r in enumerate(routes)
               if not np.array_equal(r, ref[f"route/{i}"])}
    want = _tree(ref, "g/")
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = want[k].astype(np.float32)
        err = np.linalg.norm(g.numpy() - w) / (np.linalg.norm(w) + 1e-12)
        parts = k.split(".")
        moe_side = parts[0] == "blocks" and int(parts[1]) in flipped and \
            parts[2] in ("moe", "norm2")
        assert err < (FLIPPED_MOE_TOL if moe_side else GRAD_TOL), (k, err)


@pytest.mark.parametrize("repeats", [64, 200])
def test_embedding_grad_sums_like_the_reference(repeats):
    """One token repeated ``repeats`` times among a few others: the bf16
    table's gradient equals the reference's (``jax.grad`` through its
    cast-then-gather) bit for bit, and differs from the f32 sum the old
    gather-then-cast order gave."""
    cfg = dataclasses.replace(smoke_config(ARCH), vocab=32)
    rng = np.random.default_rng(repeats)
    table = (rng.normal(size=(cfg.vocab, cfg.d_model)) * 0.02).astype(
        np.float32)
    tokens = np.concatenate([np.full(repeats, 7),
                             rng.integers(0, cfg.vocab, 16)]).astype(
        np.int32)[None]
    cot = rng.normal(size=tokens.shape + (cfg.d_model,)).astype(np.float32)
    cot_bf16 = jnp.asarray(cot).astype(jnp.bfloat16)

    def loss(tab):
        x = jax_embed(cfg, {"embed": tab}, jnp.asarray(tokens), None)
        return jnp.sum(x.astype(jnp.float32) * cot_bf16.astype(jnp.float32))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    params = type("P", (), {"embed": t})()
    x = pt_embed(cfg, params, torch.from_numpy(tokens).long(), None)
    assert x.dtype == torch.bfloat16
    with torch.no_grad():   # serving gathers, then casts: the same values
        assert torch.equal(
            pt_embed(cfg, params, torch.from_numpy(tokens).long(), None), x)
    (x.float() * torch.from_numpy(cot).to(torch.bfloat16).float()).sum() \
        .backward()
    got = t.grad.numpy()
    assert np.array_equal(got, want)
    # the old order sums the repeated token's rows in f32
    old = torch.from_numpy(table).requires_grad_()
    xo = old[torch.from_numpy(tokens).long()].to(torch.bfloat16)
    (xo.float() * torch.from_numpy(cot).to(torch.bfloat16).float()).sum() \
        .backward()
    assert not np.array_equal(old.grad.numpy()[7], want[7])
