"""Serving with tensor parallelism over "model" on one process per rank:
smoke archs in f32 on gloo CPU processes, each holding its rows and its
"model" slice of the weights (heads, the FFN's and the experts' hidden
dim, the vocabulary), against the reference's GSPMD run on a fake-device
mesh of the same shape (its parameters placed by ``param_shardings``) and
against the port's stacked ``LocalMesh`` run of the same DP shape (whole
weights):

* llama3.2-1b on (1, 2, 2), 4 processes: dense TP, the tied
  vocabulary-parallel embedding and head, 2 / 2 kv heads;
* megatron-moe-32e on (2, 2, 2), 8 processes, through ``plan`` and
  ``flash``: the island with the experts' ``d_ff`` over "model";
* mixtral-8x7b on (1, 3, 2), 6 processes: no EP (experts replicated over
  the DP axes, ``d_ff`` over "model"), a sliding window;
* mixtral-8x7b on (2, 3, 2), 12 processes: EP over ``pod`` alone.

Checked: the prefill's and each decode step's logits gathered over the DP
axes and "model" within a relative 1e-5 of both; greedy tokens equal (the
argmax over vocabulary shards); each process's decode cache, gathered by
rows and kv heads, within 1e-5 of the reference's whole cache (the port
shards heads where the reference's cache spec shards head_dim); the
residual stream after every layer bit for bit the same on a DP rank's model
peers; and on an identical MoE input each process's token grid and
dispatch exchange bit for bit its slice of the stacked run's, its return
exchange and output within 1e-5 of it (they carry the sum over "model"),
the output the same bits on every model peer.  In bf16 the gathered
prefill logits are bit for bit the stacked run's with each row-parallel
product rounded per peer before the sum (``_TPRounding``).  Each refusal of
``convert.shard_module`` raises a ``ValueError``; what it refused before
the cut through a query head, the recurrent families' TP and ``pure_dp``
it now cuts.  ``serve --procs --mesh
2,2,2`` on the command line prints the tokens of the stacked mesh.  One
spawn a mesh; the reference runs once, in one subprocess on 12 fake
devices.
"""

import contextlib
import dataclasses
import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO, SRC, run_subprocess
from test_torch_serve_procs import _unflatten

from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params, recast, shard_module
from repro_torch.launch import serve
from repro_torch.launch.mesh import ProcessMesh, make_mesh, parse_mesh
from repro_torch.launch.shardings import shard_tensor
from repro_torch.models import layers, moe, transformer

AXES = ("pod", "data", "model")
B, S, STEPS = 12, 8, 3
# name -> (arch, mesh, exchanges served; the first through serve_procs)
CASES = {"llama": ("llama3.2-1b", (1, 2, 2), (None,)),
         "megatron": ("megatron-moe-32e", (2, 2, 2), ("plan", "flash")),
         "mixtral_none": ("mixtral-8x7b", (1, 3, 2), ("flash",)),
         "mixtral_pod": ("mixtral-8x7b", (2, 3, 2), ("flash",))}
RUNS = [(name, impl) for name, (_, _, impls) in CASES.items()
        for impl in impls]

_JAX_SIDE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.core.schedulers import get_scheduler
from repro.core.traffic import ClusterSpec, moe_workload
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_serve_step
from repro.launch.shardings import param_shardings
from repro.launch.train import make_dist_context, make_rules
from repro.models import use_mesh_rules
from repro.models.transformer import init_lm, lm_prefill

out = {}
for name, (arch, shape, impls) in CASES.items():
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    params = init_lm(jax.random.PRNGKey(1), cfg)
    out.update({f"{name}/p/" + "/".join(
        str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
        np.asarray(v) for path, v in
        jax.tree_util.tree_flatten_with_path(params)[0]})
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    out[f"{name}/prompts"] = prompts
    mesh = make_mesh(shape, ("pod", "data", "model"))
    params = jax.device_put(params, param_shardings(
        cfg, mesh, jax.eval_shape(lambda: params)))
    for impl in impls:
        plan = get_scheduler("flash").synthesize(moe_workload(
            ClusterSpec(shape[0], shape[1]), tokens_per_gpu=2048,
            bytes_per_token=2, seed=0)) if impl == "plan" else None
        dist = make_dist_context(cfg, mesh, impl, plan=plan)
        with use_mesh_rules(make_rules(cfg, mesh)):
            logits, cache = jax.jit(lambda p, t: lm_prefill(
                cfg, p, t, None, dist, cache_len=S + STEPS))(
                    params, jnp.asarray(prompts))
        key = f"{name}/{impl}"
        for i, c in enumerate(cache):
            out[f"{key}/cache{i}/k"] = np.asarray(c["k"])
            out[f"{key}/cache{i}/v"] = np.asarray(c["v"])
        out[f"{key}/logits0"] = np.asarray(logits)
        step = make_serve_step(cfg, mesh, impl, plan)
        toks = jnp.argmax(logits, -1)
        for i, t in enumerate(range(S, S + STEPS)):
            logits, cache = step(params, cache, toks, jnp.int32(t))
            out[f"{key}/logits{i + 1}"] = np.asarray(logits)
            toks = jnp.argmax(logits, -1)
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_serve") / "ref.npz")
    code = (f"CASES = {CASES!r}\nB, S, STEPS = {B}, {S}, {STEPS}\n"
            f"OUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=12)
    return dict(np.load(path))


def _cfg(name):
    return dataclasses.replace(smoke_config(CASES[name][0]),
                               compute_dtype="float32")


def _module(ref, name):
    pre = f"{name}/p/"
    params = _unflatten({k[len(pre):]: v for k, v in ref.items()
                         if k.startswith(pre)})
    return from_jax_params(params, _cfg(name), device="cpu")


def _plan(name, impl):
    shape = CASES[name][1]
    return serve.flash_plan(shape[0], shape[1], seed=0) if impl == "plan" \
        else None


def _moe_input(cfg):
    return torch.from_numpy((np.random.default_rng(5).normal(
        size=(B, S, cfg.d_model)) * 0.3).astype(np.float32))


class _Spy:
    """While active, keeps every token grid ``_expert_ffn`` runs on and
    every output of the split island's exchanges."""

    def __init__(self):
        self.grids, self.exchanged = [], []

    def __enter__(self):
        self.ffn, self.exchange = moe._expert_ffn, moe._pod_ep_exchange

        def ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw):
            self.grids.append(tokens.detach().clone())
            return self.ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw)

        def exchange(*args):
            fn = self.exchange(*args)

            def run(buf):
                got = fn(buf)
                self.exchanged.append(got.detach().clone())
                return got
            return run

        moe._expert_ffn, moe._pod_ep_exchange = ffn, exchange
        return self

    def __exit__(self, *exc):
        moe._expert_ffn, moe._pod_ep_exchange = self.ffn, self.exchange


def _moe_run(cfg, layer, x, dist):
    with _Spy() as spy, torch.no_grad():
        y, _ = moe.moe_apply(cfg, layer, x, dist)
    return {"y": y.numpy(), "grid": spy.grids[0].numpy(),
            "exchanged": [e.numpy() for e in spy.exchanged]}


def _hook(mesh, cfg, shards, rows, serve_rows, *, name, impls, plans):
    """Serve (the first exchange, through ``serve_procs``), then the other
    exchanges, then a recorded prefill (the stream after every layer, the
    cache) and the first MoE layer on an identical input."""
    from repro_torch.launch.shardings import batch_specs

    serve_rows()
    spec = batch_specs(mesh, {"tokens": torch.empty(B, S)})["tokens"]
    params = shards[0]
    out = {"coords": mesh.rank_coords, "served": {}}
    for impl, plan in zip(impls[1:], plans[1:]):
        out["served"][impl] = serve._greedy(mesh, cfg, params, rows, spec,
                                            impl, plan, STEPS + 1)
    stream, real = [], transformer._block_prefill

    def spy(*args, **kw):
        got = real(*args, **kw)
        stream.append(got[0].numpy().copy())
        return got

    transformer._block_prefill = spy
    try:
        prefill = serve.make_prefill_step(cfg, mesh, impls[0], plans[0],
                                          cache_len=S + STEPS)
        _, cache = prefill(params, {"tokens": rows})
    finally:
        transformer._block_prefill = real
    out["stream"] = stream
    out["cache"] = [(c["k"].numpy(), c["v"].numpy()) for c in cache]
    bf16 = smoke_config(CASES[name][0])
    prefill = serve.make_prefill_step(bf16, mesh, impls[0], plans[0],
                                      cache_len=S + STEPS)
    out["bf16"] = prefill(recast(params, bf16), {"tokens": rows})[0]
    if cfg.moe is not None:
        x = shard_tensor(_moe_input(cfg), spec + (None,), mesh)
        dist = serve.make_dist_context(cfg, mesh, impls[0], plans[0])
        out["moe"] = _moe_run(cfg, params.blocks[0].moe, x, dist)
    return out


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    """Every mesh's processes: rank 0's gathered serve and each rank's
    hook."""
    res = {}
    for name, (_, shape, impls) in CASES.items():
        cfg = _cfg(name)
        plans = [_plan(name, impl) for impl in impls]
        hook = functools.partial(_hook, name=name, impls=impls, plans=plans)
        rdv = tmp_path_factory.mktemp(f"rdv_{name}") / "store"
        res[name] = serve.serve_procs(
            cfg, [_module(ref, name)],
            torch.from_numpy(ref[f"{name}/prompts"]), shape, "gloo", "cpu",
            impls[0], plans[0], gen_len=STEPS + 1, hook=hook,
            init_method=f"file://{rdv}", timeout=60.0, join_timeout=240)
    return res


@pytest.fixture(scope="module")
def local(ref):
    """The stacked LocalMesh run of every (mesh, exchange), whole weights,
    the DP shape with "model" at 1; and its first MoE layer on the
    identical input."""
    out = {}
    for name, impl in RUNS:
        cfg, shape = _cfg(name), CASES[name][1]
        mesh = make_mesh(shape[:2] + (1,), AXES, device="cpu")
        module, plan = _module(ref, name), _plan(name, impl)
        prefill = serve.make_prefill_step(cfg, mesh, impl, plan,
                                          cache_len=S + STEPS, device="cpu")
        step = serve.make_serve_step(cfg, mesh, impl, plan, device="cpu")
        logits, cache = prefill(module, {"tokens": torch.from_numpy(
            ref[f"{name}/prompts"])})
        got, toks = [logits], [logits.argmax(-1)]
        for t in range(S, S + STEPS):
            logits, cache = step(module, cache, toks[-1], t)
            got.append(logits)
            toks.append(logits.argmax(-1))
        out[(name, impl)] = {"logits": got, "tokens": torch.stack(toks, 1)}
        if cfg.moe is not None and impl == CASES[name][2][0]:
            dist = serve.make_dist_context(cfg, mesh, impl, plan)
            out[(name, "moe")] = _moe_run(cfg, module.blocks[0].moe,
                                          _moe_input(cfg), dist)
    return out


class _TPRounding:
    """While active, each row-parallel product (``tp.row_parallel``) of a
    run on whole weights computes what ``parts`` model peers compute under
    TP: each contiguous slice of the contraction's product rounded to its
    dtype, the slices added in f32 in peer order and rounded once more."""

    def __init__(self, parts):
        self.parts = parts

    def __enter__(self):
        self.real = layers.row_parallel

        def split(tp, product, x, w, *extra, sp=None):
            assert tp is None and sp is None
            n = w.shape[-2] // self.parts
            outs = [product(x[..., i * n:(i + 1) * n].contiguous(),
                            w[..., i * n:(i + 1) * n, :].contiguous(),
                            *extra) for i in range(self.parts)]
            return sum(o.float() for o in outs).to(outs[0].dtype)
        layers.row_parallel = moe.row_parallel = split
        return self

    def __exit__(self, *exc):
        layers.row_parallel = moe.row_parallel = self.real


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_is_the_whole_model_with_tp_rounding(ref, procs, name):
    """In bf16 each peer rounds its partial product before the sum over
    "model", one rounding more than the whole product: the processes'
    prefill logits, gathered, are bit for bit the stacked run's with that
    rounding alone (``_TPRounding``), and not the plain stacked run's."""
    arch, shape, impls = CASES[name]
    cfg = smoke_config(arch)
    params = recast(_module(ref, name), cfg)
    prefill = serve.make_prefill_step(
        cfg, make_mesh(shape[:2] + (1,), AXES, device="cpu"), impls[0],
        _plan(name, impls[0]), cache_len=S + STEPS, device="cpu")
    batch = {"tokens": torch.from_numpy(ref[f"{name}/prompts"])}
    plain = prefill(params, batch)[0]
    with _TPRounding(shape[2]):
        witness = prefill(params, batch)[0]
    ranks = _by_coords(procs[name]["ranks"])
    got = torch.cat([torch.cat([ranks[(p, d, m)]["bf16"]
                                for m in range(shape[2])], -1)
                     for p in range(shape[0]) for d in range(shape[1])])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, witness)
    assert not torch.equal(got, plain)


def _served(procs, name, impl):
    res = procs[name]
    if impl == CASES[name][2][0]:
        return res
    return res["ranks"][0]["served"][impl]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{i}" for n, i in RUNS])
def test_logits_match_reference_and_local_mesh(ref, procs, local, run,
                                               step):
    name, impl = run
    got = _served(procs, name, impl)["logits"][step].numpy()
    assert got.shape == (B, _cfg(name).vocab)
    assert _rel(got, ref[f"{name}/{impl}/logits{step}"]) < 1e-5
    assert _rel(got, local[run]["logits"][step].numpy()) < 1e-5


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{i}" for n, i in RUNS])
def test_greedy_tokens_equal(ref, procs, local, run):
    name, impl = run
    got = _served(procs, name, impl)["tokens"]
    assert torch.equal(got, local[run]["tokens"])
    want = np.stack([ref[f"{name}/{impl}/logits{i}"].argmax(-1)
                     for i in range(STEPS + 1)], 1)
    assert np.array_equal(got.numpy(), want)


def _by_coords(ranks):
    return {tuple(r["coords"]): r for r in ranks}


@pytest.mark.parametrize("name", list(CASES))
def test_cache_gathered_by_heads_equals_reference(ref, procs, name):
    """Each process holds its rows and its kv heads of every layer's cache;
    put together they are the reference's whole cache."""
    shape = CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    impl = CASES[name][2][0]
    for layer in range(_cfg(name).n_layers):
        for j, kv in enumerate(("k", "v")):
            rows = []
            for pod in range(shape[0]):
                for data in range(shape[1]):
                    rows.append(np.concatenate(
                        [ranks[(pod, data, m)]["cache"][layer][j]
                         for m in range(shape[2])], axis=2))
            got = np.concatenate(rows)
            want = ref[f"{name}/{impl}/cache{layer}/{kv}"]
            assert got.shape == want.shape
            assert np.abs(got - want).max() < 1e-5, (layer, kv)


@pytest.mark.parametrize("name", list(CASES))
def test_residual_stream_identical_on_model_peers(procs, name):
    shape = CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = ranks[(pod, data, 0)]["stream"]
            assert len(first) == _cfg(name).n_layers
            for m in range(1, shape[2]):
                other = ranks[(pod, data, m)]["stream"]
                for a, b in zip(first, other):
                    assert np.array_equal(a, b)


def _grid_slice(grid, name, coords):
    """The stacked grid's rows of the process at ``coords``: its EP
    coordinate's experts and the block of its other DP coordinates (the
    island's grid ``[R * E_loc, G * C, d]``: rank r's experts)."""
    cfg, shape = _cfg(name), CASES[name][1]
    n_exp = cfg.moe.num_experts
    ep = serve.make_dist_context(
        cfg, make_mesh(shape, AXES, device="cpu")).ep_axes or ()
    if len(ep) == 2:
        r = coords[0] * shape[1] + coords[1]
        e_loc = n_exp // (shape[0] * shape[1])
        return grid[r * e_loc:(r + 1) * e_loc]
    sizes = dict(zip(("pod", "data"), shape[:2]))
    where = dict(zip(("pod", "data"), coords[:2]))
    others = [a for a in ("pod", "data") if a not in ep]
    experts = slice(None)
    if ep:
        e_loc = n_exp // sizes[ep[0]]
        experts = slice(where[ep[0]] * e_loc, (where[ep[0]] + 1) * e_loc)
    g = grid.reshape(n_exp, *[sizes[a] for a in others], -1, grid.shape[-1])
    return g[(experts, *[where[a] for a in others])]


MOE_CASES = [n for n in CASES if CASES[n][0] != "llama3.2-1b"]


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_grid_and_exchange_are_the_stacked_slice(procs, local, name):
    shape = CASES[name][1]
    want = local[(name, "moe")]
    n_dp = shape[0] * shape[1]
    rows = want["y"].reshape(n_dp, B // n_dp, S, -1)
    for r in procs[name]["ranks"]:
        got, c = r["moe"], r["coords"]
        assert np.array_equal(got["grid"], _grid_slice(want["grid"], name,
                                                       c))
        dp = c[0] * shape[1] + c[1]
        assert len(got["exchanged"]) == len(want["exchanged"])
        if got["exchanged"]:   # the dispatch bit for bit; the return trip
            dispatch, back = got["exchanged"]      # carries the TP sum
            assert np.array_equal(dispatch[0], want["exchanged"][0][dp])
            assert _rel(back[0], want["exchanged"][1][dp]) < 1e-5
        assert _rel(got["y"], rows[dp]) < 1e-5
    ranks = _by_coords(procs[name]["ranks"])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            for m in range(1, shape[2]):
                assert np.array_equal(ranks[(pod, data, m)]["moe"]["y"],
                                      ranks[(pod, data, 0)]["moe"]["y"])


def _fake_mesh(shape):
    return ProcessMesh(shape=shape, axis_names=AXES,
                       device=torch.device("cpu"), rank=0, backend="gloo",
                       root_shape=shape, root_axes=AXES,
                       root_coords=(0,) * len(shape), groups={})


# what shard_module refused before: a "model" axis that does not divide
# the heads, the encoder-decoder family (before the cut through a query
# head); the ssm and hybrid families and pure_dp (before their slice);
# seq_shard_activations, FSDP and pure_dp with FSDP (before theirs)
ACCEPTED = {
    "heads": ("llama3.2-1b", (1, 1, 3), {}),
    "encdec": ("whisper-tiny", (1, 1, 2), {}),
    "ssm": ("xlstm-125m", (1, 1, 2), {}),
    "hybrid": ("hymba-1.5b", (1, 1, 2), {}),
    "pure_dp": ("llama3.2-1b", (1, 1, 2), {"pure_dp": True}),
    "seq_shard": ("llama3.2-1b", (1, 1, 2),
                  {"seq_shard_activations": True}),
    "fsdp": ("llama3.2-1b", (1, 2, 1), {"fsdp": True}),
    "pure_dp_fsdp": ("llama3.2-1b", (1, 1, 2),
                     {"pure_dp": True, "fsdp": True}),
}
# case -> (leaf, the dim "model" cuts) of some TP leaves; the leaves named
# by WHOLE_LEAVES stay whole
HALF_LEAVES = {
    "encdec": (("embed", 0), ("enc_blocks.0.attn.wq", 1),
               ("dec_blocks.0.xattn.wo", 0), ("dec_blocks.1.mlp.b_up", 0)),
    "ssm": (("embed", 0), ("blocks.0.mlstm.wq", 1), ("blocks.0.mlstm.wif", 1),
            ("blocks.0.mlstm.wo", 0), ("blocks.1.slstm.r", 1),
            ("blocks.1.slstm.wo", 0)),
    "hybrid": (("blocks.0.mamba.in_proj", 1), ("blocks.0.mamba.a_log", 0),
               ("blocks.0.mamba.w_dt2", 1), ("blocks.0.mamba.out_proj", 0),
               ("blocks.1.attn.wq", 1)),
    # SP cuts the TP leaves alone; FSDP the first free dim "data" divides
    # of each leaf of two or more dims, "model" taking its place under
    # pure_dp
    "seq_shard": (("embed", 0), ("blocks.0.attn.wq", 1),
                  ("blocks.0.mlp.w_down", 0)),
    "fsdp": (("embed", 1), ("blocks.0.attn.wq", 0), ("blocks.0.attn.wo", 1),
             ("blocks.1.mlp.w_down", 1)),
    "pure_dp_fsdp": (("embed", 0), ("blocks.0.attn.wq", 0),
                     ("blocks.1.mlp.w_down", 0)),
}
WHOLE_LEAVES = {
    "encdec": ("enc_pos", "dec_pos", "dec_blocks.0.mlp.b_down"),
    "ssm": ("blocks.0.norm1.scale", "blocks.1.norm1.bias"),
    "hybrid": ("blocks.0.fuse_norm_ssm.scale",),
    "seq_shard": ("blocks.0.norm1.scale", "final_norm.scale"),
    "fsdp": ("blocks.0.norm2.scale", "final_norm.scale"),
    "pure_dp_fsdp": ("blocks.0.norm1.scale", "final_norm.scale"),
}


@pytest.mark.parametrize("case", list(ACCEPTED))
def test_shard_module_accepts_a_cut_through_a_head_and_the_encdec(case):
    """llama's smoke config on 3 keeps every leaf whole (``_drop_uneven``:
    3 divides none of its widths), and so does ``pure_dp`` on 2 (weights
    replicated); whisper-tiny's, xlstm-125m's and hymba-1.5b's on 2 hold
    half of each TP leaf (heads, ``d_ff``, the tied vocabulary, the
    recurrent blocks' columns and Mamba's channels) and the whole of the
    rest; llama's with ``seq_shard_activations`` on 2 its TP leaves' half,
    with FSDP on (1, 2, 1) and ``pure_dp`` with FSDP on 2 half of a dim of
    each leaf of two or more dims, the norms whole."""
    from repro_torch.models import build_model

    arch, shape, over = ACCEPTED[case]
    cfg = smoke_config(arch, **over)
    module = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    own = dict(shard_module(module, cfg, _fake_mesh(shape))
               .named_parameters())
    whole = dict(module.named_parameters())
    assert set(own) == set(whole)
    if case in ("heads", "pure_dp"):
        for name, w in whole.items():
            assert torch.equal(own[name], w), name
        return
    for name, dim in HALF_LEAVES[case]:
        w = whole[name]
        assert torch.equal(own[name], w.narrow(dim, 0, w.shape[dim] // 2))
    for name in WHOLE_LEAVES[case]:
        assert torch.equal(own[name], whole[name]), name


def test_shard_module_cuts_the_model_slices(ref):
    """On (1, 2, 2) the process at model coordinate 1 holds the second
    half of each TP leaf, by its spec, and the whole of the rest."""
    cfg = _cfg("llama")
    module = _module(ref, "llama")
    mesh = dataclasses.replace(_fake_mesh((1, 2, 2)), rank=1,
                               root_coords=(0, 0, 1))
    own = dict(shard_module(module, cfg, mesh).named_parameters())
    whole = dict(module.named_parameters())
    half = cfg.vocab // 2
    assert torch.equal(own["embed"], whole["embed"][half:])
    for name, dim in (("blocks.0.attn.wq", 1), ("blocks.0.attn.wo", 0),
                      ("blocks.0.mlp.w_up", 1), ("blocks.0.mlp.w_down", 0)):
        w = whole[name]
        n = w.shape[dim] // 2
        assert torch.equal(own[name], w.narrow(dim, n, n)), name
    assert torch.equal(own["final_norm.scale"], whole["final_norm.scale"])


def _samples(text):
    return [ln for ln in text.splitlines() if ln.startswith("sample:")]


def test_serve_cli_with_tp_on_processes_and_stacked(tmp_path):
    """``serve --procs --mesh 2,2,2`` (8 gloo processes, each holding its
    "model" slice) prints the greedy tokens that ``serve --mesh 2,2,2``
    (the stacked mesh, whole weights) and ``--mesh 2,2`` print."""
    args = ["--arch", "megatron-moe-32e", "--smoke", "--device", "cpu",
            "--batch", "4", "--prompt-len", "8", "--gen-len", "4"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args, "--mesh",
         "2,2,2", "--procs", "--backend", "gloo", "--init-method",
         f"file://{tmp_path / 'store'}"], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=SRC), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "on 8 processes (gloo, cpu)" in proc.stdout
    for mesh in ("2,2,2", "2,2"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(args + ["--mesh", mesh])
        assert _samples(buf.getvalue()) == _samples(proc.stdout), mesh


@pytest.mark.parametrize("text,shape", [("2,3", (2, 3, 1)),
                                        ("2,2,2", (2, 2, 2)),
                                        ("2", None), ("2,2,2,2", None),
                                        ("2,0,2", None), ("2,x", None)])
def test_parse_mesh(text, shape):
    if shape is None:
        with pytest.raises(ValueError, match="POD,DATA"):
            parse_mesh(text)
        with pytest.raises(SystemExit):
            serve.main(["--smoke", "--device", "cpu", "--mesh", text])
    else:
        assert parse_mesh(text) == shape
