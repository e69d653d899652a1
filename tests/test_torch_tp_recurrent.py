"""Tensor parallelism over "model" for the recurrent and hybrid families:
xLSTM's mLSTM and sLSTM and Hymba's Mamba beside its attention, each
process holding its slice of the reference's specs (``models/ssm.py``).
Smoke archs in f32 on gloo CPU processes against the reference's GSPMD
run on fake devices (its parameters placed by ``param_shardings``) and
against the port's stacked ``LocalMesh`` run of the same DP shape (whole
weights):

* xlstm-125m (pattern ``("m", "s")``) on (1, 1, 4): half an mLSTM head's
  columns a process (the peers' ``q`` and ``k`` gathered, ``wif``'s one
  column a process gathered whole), 8 sLSTM channels a process;
* xlstm-125m on (1, 2, 2): whole mLSTM heads, and DP;
* hymba-1.5b on (1, 1, 4): 16 Mamba channels a process (the peers'
  ``in_proj`` columns gathered, own ``x`` and ``z`` channels kept), 1
  query head and half a kv head's columns;
* hymba-1.5b with 10 heads over 2 kv heads of 16 on (1, 1, 4): 40 query
  columns a process, so coordinate 1 touches three heads, as
  hymba-1.5b's 100 columns do at 16.

Checked: the prompt pass's and each decode step's logits within a
relative 1e-5 of both, greedy tokens equal; the model peers' states and
caches put together (``whole_states``, ``whole_kv_heads``) within 1e-5
of the reference's whole, each replica (an mLSTM head's ``n`` and ``m``
on the peers that share it, a kv head) bit for bit the same; the
residual stream bit for bit the same on model peers; a shard's zero
decode cache (``Model.init_cache`` with the shard and its ``dist``) of
the prompt pass's shapes; bf16 prompt-pass logits bit for bit the
stacked run's with each row-parallel product rounded per peer (the
witness); a planted fault (each process keeping its neighbour's channels
after the ``in_proj`` gather) fails the logits check. Two training steps
at ``test_torch_train.py``'s tolerances, replicated gradients bit for
bit the same on model peers, in the serving processes. The reference
runs once, in one subprocess on 4 fake devices."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from conftest import run_subprocess
from test_torch_tp_head_cut import _nest
from test_torch_tp_serve import _by_coords, _rel, _TPRounding
from test_torch_tp_train import _hook as _train_hook
from test_torch_train import OPTIONS, STEPS as TRAIN_STEPS, \
    _check_against_ref, _tree

from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params, recast
from repro_torch.data import DataConfig
from repro_torch.launch import serve
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import whole_states
from repro_torch.models import build_model, ssm, transformer
from repro_torch.models.tp import q_heads

AXES = ("pod", "data", "model")
B, S, STEPS = 4, 8, 3
# name -> (arch, mesh, config overrides)
CASES = {"xlstm": ("xlstm-125m", (1, 1, 4), {}),
         "xlstm_dp": ("xlstm-125m", (1, 2, 2), {}),
         "hymba": ("hymba-1.5b", (1, 1, 4), {}),
         "hymba_cut": ("hymba-1.5b", (1, 1, 4),
                       {"n_heads": 10, "n_kv_heads": 2, "head_dim": 16})}
TRAIN_BATCH, TRAIN_SEQ = 4, 8
FAULT_CASE = "hymba"

_JAX_SIDE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_serve_step
from repro.launch.shardings import param_shardings
from repro.launch.train import make_dist_context, make_rules
from repro.models import build_model, use_mesh_rules
from repro.models.transformer import lm_prefill
from repro.optim import init_opt_state

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

real_update = T.adamw_update

def spy(grads, opt, params, lr, cfg):
    p, o, n = real_update(grads, opt, params, lr, cfg)
    return p, o, {"norm": n, "grads": grads}

out = {}
for name, (arch, shape, over) in CASES.items():
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                              **over)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    out.update({f"{name}/p/{k}": v for k, v in flat(params).items()})
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    out[f"{name}/prompts"] = prompts
    mesh = make_mesh(shape, ("pod", "data", "model"))
    params = jax.device_put(params, param_shardings(
        cfg, mesh, jax.eval_shape(lambda: params)))
    dist = make_dist_context(cfg, mesh, None)
    step = make_serve_step(cfg, mesh, None)
    with use_mesh_rules(make_rules(cfg, mesh)):
        logits, cache = jax.jit(lambda p, t: lm_prefill(
            cfg, p, t, None, dist, cache_len=S + STEPS))(
                params, jnp.asarray(prompts))
    for k, v in flat(cache).items():
        out[f"{name}/cache/{k}"] = v
    out[f"{name}/logits0"] = np.asarray(logits)
    toks = jnp.argmax(logits, -1)
    for i, t in enumerate(range(S, S + STEPS)):
        logits, cache = step(params, cache, toks, jnp.int32(t))
        out[f"{name}/logits{i + 1}"] = np.asarray(logits)
        toks = jnp.argmax(logits, -1)

    T.adamw_update = spy   # the step reads its gradients out via grad_norm
    params0 = build_model(cfg).init(jax.random.PRNGKey(0))
    out.update({f"train_{name}/init/{k}": v
                for k, v in flat(params0).items()})
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), cfg)
    tstep, _, state_sh, batch_fn = T.make_train_step(
        cfg, mesh, T.TrainOptions(**OPTIONS))
    state = jax.device_put({"params": params0,
                            "opt": init_opt_state(params0),
                            "step": jnp.zeros((), jnp.int32)}, state_sh)
    for i in range(TRAIN_STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        state, m = tstep(state, jax.device_put(batch, batch_fn(batch)))
        gn = m.pop("grad_norm")
        m["grad_norm"] = gn["norm"]
        for k, v in m.items():
            out[f"train_{name}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(gn["grads"]).items():
            out[f"train_{name}/g{i}/{k}"] = v
    for k, v in flat(state["params"]).items():
        out[f"train_{name}/p/{k}"] = v
    T.adamw_update = real_update
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_recurrent") / "ref.npz")
    code = (f"CASES = {CASES!r}\nB, S, STEPS = {B}, {S}, {STEPS}\n"
            f"TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = {TRAIN_BATCH}, "
            f"{TRAIN_SEQ}, {TRAIN_STEPS}\n"
            f"OPTIONS = {OPTIONS!r}\nOUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=4)
    return dict(np.load(path))


def _cfg(name, dtype="float32"):
    arch, _, over = CASES[name]
    return dataclasses.replace(smoke_config(arch), compute_dtype=dtype,
                               **over)


def _module(ref, name, prefix=None, train=False):
    return from_jax_params(_nest(_tree(ref, prefix or f"{name}/p/")),
                           _cfg(name), device="cpu", train=train)


class _Witness(_TPRounding):
    """``_TPRounding`` reaching the recurrent blocks' and Mamba's
    row-parallel products (``ssm.row_parallel``: ``wo``, ``out_proj`` and
    Mamba's f32 ``w_dt``, ``wb`` and ``wc``)."""

    def __enter__(self):
        super().__enter__()
        self.ssm_real = ssm.row_parallel
        from repro_torch.models import layers
        ssm.row_parallel = layers.row_parallel
        return self

    def __exit__(self, *exc):
        ssm.row_parallel = self.ssm_real
        super().__exit__(*exc)


class _NeighbourChannels:
    """While active, each process keeps its neighbour's channels of a
    gathered per-channel width (``ssm._own_channels``: Mamba's ``x`` and
    ``z`` after the ``in_proj`` gather): the planted fault."""

    def __enter__(self):
        self.real = real = ssm._own_channels

        def shifted(t, tp):
            n = tp.axis_size("model")
            return real(t.roll(-(t.shape[-1] // n), -1), tp)
        ssm._own_channels = shifted
        return self

    def __exit__(self, *exc):
        ssm._own_channels = self.real


class _Stream:
    """While active, records the residual stream (every norm's input, a
    replicated tensor)."""

    def __enter__(self):
        self.real, self.stream = transformer.norm_apply, []

        def norm(cfg, p, x):
            self.stream.append(x.detach().numpy().copy())
            return self.real(cfg, p, x)
        transformer.norm_apply = norm
        return self

    def __exit__(self, *exc):
        transformer.norm_apply = self.real


def _hook(mesh, cfg, shards, rows, serve_rows, *, name, train_params):
    """``serve_procs``' own serve; then a recorded prompt pass (the stream
    and the decode cache), the bf16 prompt pass, for ``FAULT_CASE`` the
    prompt pass under the planted fault; then two training steps on the
    reference's initial parameters (``train_procs``' per-rank path)."""
    serve_rows()
    params = shards[0]
    batch = {"tokens": rows}
    prefill = serve.make_prefill_step(cfg, mesh, cache_len=S + STEPS)
    out = {"coords": mesh.rank_coords}
    with torch.no_grad(), _Stream() as rec:
        _, cache = prefill(params, batch)
    out.update(stream=rec.stream, cache=cache)
    zero = build_model(cfg, "cpu").init_cache(
        rows.shape[0], S + STEPS, params, serve.make_dist_context(cfg, mesh))
    out["zero_shapes"] = [{k: tuple(v.shape) for k, v in _flat(c).items()}
                          for c in zero]
    bf16 = _cfg(name, "bfloat16")
    out["bf16"] = serve.make_prefill_step(bf16, mesh, cache_len=S + STEPS)(
        recast(params, bf16), batch)[0]
    if name == FAULT_CASE:
        with torch.no_grad(), _NeighbourChannels():
            out["fault"] = prefill(params, batch)[0]
    shards.pop()
    res = pt_train._train_rank(
        mesh, cfg, [train_params],
        DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH),
        pt_train.TrainOptions(**OPTIONS), TRAIN_STEPS, True, None,
        hook=_train_hook)
    out["train"] = res["hook"]
    return out


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    """Every case's processes: rank 0's gathered serve and each rank's
    hook (its training's included)."""
    res = {}
    for name, (_, shape, _) in CASES.items():
        prompts = torch.from_numpy(ref[f"{name}/prompts"])
        rdv = tmp_path_factory.mktemp(f"rdv_{name}") / "store"
        train_params = {k: v.detach() for k, v in _module(
            ref, name, f"train_{name}/init/", train=True)
            .named_parameters()}
        res[name] = serve.serve_procs(
            _cfg(name), [_module(ref, name)], prompts, shape, "gloo", "cpu",
            gen_len=STEPS + 1,
            hook=functools.partial(_hook, name=name,
                                   train_params=train_params),
            init_method=f"file://{rdv}", timeout=60.0, join_timeout=240)
    return res


@pytest.fixture(scope="module")
def local(ref):
    """The stacked LocalMesh run of every case: whole weights, the DP
    shape with "model" at 1."""
    out = {}
    for name, (_, shape, _) in CASES.items():
        cfg = _cfg(name)
        mesh = make_mesh(shape[:2] + (1,), AXES, device="cpu")
        module = _module(ref, name)
        prompts = torch.from_numpy(ref[f"{name}/prompts"])
        step = serve.make_serve_step(cfg, mesh, device="cpu")
        logits, cache = serve.make_prefill_step(
            cfg, mesh, cache_len=S + STEPS, device="cpu")(
                module, {"tokens": prompts})
        got, toks = [logits], [logits.argmax(-1)]
        for t in range(S, S + STEPS):
            logits, cache = step(module, cache, toks[-1], t)
            got.append(logits)
            toks.append(logits.argmax(-1))
        out[name] = {"logits": got, "tokens": torch.stack(toks, 1)}
    return out


def _assemble(procs, name, get):
    """``get(rank)`` of every process: model peers' vocabulary shards
    joined along the last dim (one copy where the vocabulary is whole),
    then the DP ranks' rows."""
    shape, vocab = CASES[name][1], _cfg(name).vocab
    ranks = _by_coords(procs[name]["ranks"])
    rows = []
    for p in range(shape[0]):
        for d in range(shape[1]):
            parts = [get(ranks[(p, d, m)]) for m in range(shape[2])]
            rows.append(parts[0] if parts[0].shape[-1] == vocab
                        else torch.cat(parts, -1))
    return torch.cat(rows)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_reference_and_local_mesh(ref, procs, local, name,
                                               step):
    got = procs[name]["logits"][step].numpy()
    assert got.shape == (B, _cfg(name).vocab)
    assert _rel(got, ref[f"{name}/logits{step}"]) < 1e-5
    assert _rel(got, local[name]["logits"][step].numpy()) < 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal(ref, procs, local, name):
    got = procs[name]["tokens"]
    assert torch.equal(got, local[name]["tokens"])
    want = np.stack([ref[f"{name}/logits{i}"].argmax(-1)
                     for i in range(STEPS + 1)], 1)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
def test_states_put_together_equal_reference(ref, procs, name):
    """Each process's decode state holds its channels or the heads its
    columns touch; the model peers' states and caches put together
    (``whole_states``, which raises where two replicas differ) are the
    reference's whole."""
    cfg, shape = _cfg(name), CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    for layer in range(cfg.n_layers):
        whole = [whole_states([ranks[(p, d, m)]["cache"][layer]
                               for m in range(shape[2])], cfg)
                 for p in range(shape[0]) for d in range(shape[1])]
        flat = [_flat(w) for w in whole]
        want = _tree(ref, f"{name}/cache/{layer}.")
        assert set(flat[0]) == set(want)
        for k, w in want.items():
            got = torch.cat([f[k] for f in flat]).numpy()
            assert got.shape == w.shape, (layer, k)
            assert np.abs(got - w).max() < 1e-5 * max(np.abs(w).max(), 1), \
                (layer, k)


@pytest.mark.parametrize("name", list(CASES))
def test_zero_cache_of_a_shard_has_the_prefill_shapes(procs, name):
    """``Model.init_cache`` with a process's shard and its TP ``dist``
    sizes every state and cache as the shard's prompt pass leaves them."""
    for r in procs[name]["ranks"]:
        assert r["zero_shapes"] == [
            {k: tuple(v.shape) for k, v in _flat(c).items()}
            for c in r["cache"]]


def test_mlstm_state_layout_and_shared_heads(procs):
    """On (1, 1, 4) each process holds half an mLSTM head's v columns of
    ``C`` and that head's ``n`` and ``m``, bit for bit its peer's; each
    sLSTM state holds its 8 channels."""
    cfg = _cfg("xlstm")
    dh = cfg.d_model // cfg.n_heads
    ranks = _by_coords(procs["xlstm"]["ranks"])
    for m in range(4):
        st = ranks[(0, 0, m)]["cache"][0]["state"]
        heads, off = q_heads(cfg.n_heads, dh, cfg.d_model // 4, m)
        assert (len(heads), off) == (1, (m % 2) * dh // 2)
        assert st["C"].shape == (B, 1, dh, dh // 2)
        assert st["n"].shape == (B, 1, dh)
        assert ranks[(0, 0, m)]["cache"][1]["state"]["c"].shape == (B, 8)
    for a, b in ((0, 1), (2, 3)):
        sa, sb = (ranks[(0, 0, m)]["cache"][0]["state"] for m in (a, b))
        assert torch.equal(sa["n"], sb["n"]) and torch.equal(sa["m"],
                                                            sb["m"])


@pytest.mark.parametrize("name", list(CASES))
def test_residual_stream_identical_on_model_peers(procs, name):
    shape = CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = ranks[(pod, data, 0)]["stream"]
            assert len(first) >= _cfg(name).n_layers
            for m in range(1, shape[2]):
                other = ranks[(pod, data, m)]["stream"]
                assert len(other) == len(first)
                for a, b in zip(first, other):
                    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_is_the_whole_model_with_tp_rounding(ref, procs, name):
    """The processes' bf16 prompt-pass logits, gathered, are bit for bit
    the stacked run's with each row-parallel product rounded per peer
    before the sum (``_Witness``): the gathers of the columns, the scans
    on own channels and heads add no rounding."""
    cfg = _cfg(name, "bfloat16")
    shape = CASES[name][1]
    params = recast(_module(ref, name), cfg)
    prefill = serve.make_prefill_step(
        cfg, make_mesh(shape[:2] + (1,), AXES, device="cpu"),
        cache_len=S + STEPS, device="cpu")
    batch = {"tokens": torch.from_numpy(ref[f"{name}/prompts"])}
    plain = prefill(params, batch)[0]
    with _Witness(shape[2]):
        witness = prefill(params, batch)[0]
    got = _assemble(procs, name, lambda r: r["bf16"])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, witness)
    assert not torch.equal(got, plain)


def test_neighbour_channels_fail_the_logits_check(ref, procs):
    """The planted fault (``_NeighbourChannels``) moves the prompt pass's
    logits far past the 1e-5 that the processes' logits meet."""
    got = _assemble(procs, FAULT_CASE, lambda r: r["fault"])
    assert got.shape == (B, _cfg(FAULT_CASE).vocab)
    assert _rel(got.numpy(), ref[f"{FAULT_CASE}/logits0"]) > 1e-2


@pytest.mark.parametrize("name", list(CASES))
def test_processes_train_as_the_reference(ref, procs, name):
    ranks = [r["train"] for r in procs[name]["ranks"]]
    assert len(ranks) == int(np.prod(CASES[name][1]))
    sharded = ranks[0]["sharded"]
    leaves = ("mlstm.wq", "mlstm.wo") if name.startswith("xlstm") else \
        ("mamba.in_proj", "mamba.out_proj", "mamba.a_log", "attn.wq")
    for leaf in leaves:
        assert f"blocks.0.{leaf}" in sharded
    if name.startswith("xlstm"):
        assert "blocks.1.slstm.r" in sharded
    _check_against_ref(ref, f"train_{name}", ranks[0]["run"])


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_gradients_identical_on_model_peers(procs, name):
    shape = CASES[name][1]
    by = _by_coords([r["train"] for r in procs[name]["ranks"]])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = by[(pod, data, 0)]["replicated"]
            assert len(first) == TRAIN_STEPS and first[0]
            for m in range(1, shape[2]):
                for a, b in zip(first, by[(pod, data, m)]["replicated"]):
                    assert set(a) == set(b)
                    for k in a:
                        assert np.array_equal(a[k], b[k]), k


def _fake_mesh(shape):
    from repro_torch.launch.mesh import ProcessMesh
    return ProcessMesh(shape=shape, axis_names=AXES,
                       device=torch.device("cpu"), rank=0, backend="gloo",
                       root_shape=shape, root_axes=AXES,
                       root_coords=(0,) * len(shape), groups={})


# leaf -> its width on one process of the published config at 16
PUBLISHED_WIDTHS = {
    "xlstm-125m": {"blocks.0.mlstm.wq": 48, "blocks.0.mlstm.wif": 8,
                   "blocks.3.slstm.w": 192, "blocks.3.slstm.r": 192},
    "hymba-1.5b": {"blocks.0.mamba.in_proj": 200, "blocks.0.mamba.conv_w": 100,
                   "blocks.0.mamba.w_dt2": 100, "blocks.0.attn.wq": 100,
                   "blocks.0.attn.wk": 20}}


@pytest.mark.parametrize("arch", sorted(PUBLISHED_WIDTHS))
def test_published_recurrent_archs_cut_on_16(arch):
    """``convert.shard_module`` accepts xlstm-125m and hymba-1.5b at their
    published widths on the reference's 16-way "model", and the specs cut
    their columns as the module's docstring says (``wif``'s 8 columns
    kept whole by ``_drop_uneven``)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_module
    from repro_torch.launch.shardings import module_specs, shard_tensor
    from repro_torch.models import build_model

    cfg = get_config(arch)
    mesh = _fake_mesh((1, 1, 16))
    module = build_model(cfg, "meta").init(torch.Generator())
    shard_module(module, cfg, mesh, device="meta")
    specs = module_specs(cfg, mesh, module)
    named = dict(module.named_parameters())
    for leaf, width in PUBLISHED_WIDTHS[arch].items():
        assert shard_tensor(named[leaf], specs[leaf], mesh).shape[-1] == width


def test_check_tp_accepts_pure_dp():
    """``convert.shard_module`` cuts a ``pure_dp`` shard: every leaf
    whole."""
    from repro_torch.convert import shard_module
    from repro_torch.models import build_model

    cfg = smoke_config("llama3.2-1b", pure_dp=True)
    whole = build_model(cfg, "meta").init(torch.Generator())
    shard = shard_module(whole, cfg, _fake_mesh((1, 1, 2)), device="meta")
    for k, v in shard.named_parameters():
        assert v.shape == whole.get_parameter(k).shape, k
