"""Tensor parallelism over "model" where "model" cuts through the kv heads
(the reference's 16-way TP over 8 kv heads, at smoke size): each process
projects its column slice of ``wk``/``wv``, the slices are gathered over
"model" (``tp.gather_cols``) and each keeps the kv heads its query heads
read (``tp.kv_heads``), replicated on the peers that share one.  Smoke
archs in f32 on gloo CPU processes against the reference's GSPMD run on
fake devices (its parameters placed by ``param_shardings``) and against the
port's stacked ``LocalMesh`` run of the same DP shape (whole weights):

* llama3.2-1b on (1, 1, 4): 8 heads over 2 kv heads, 2 query heads and
  half a kv head's ``wk`` columns a process;
* megatron-moe-32e on (2, 1, 4), through ``plan``, EP over (pod, data) as
  ``choose_ep_axes`` picks it: 1 query head and half a kv head's columns;
* qwen3-0.6b with 12 heads over 3 kv heads of dim 6 on (1, 1, 4): each
  process's 3 query heads fall in two GQA groups (one kv head a query
  head), ``wk``'s 18 columns are kept whole by ``_drop_uneven`` (read in
  part by each peer), and the qk-norm runs after the selection.

Checked: prefill and decode logits within a relative 1e-5 of both, greedy
tokens equal; the model peers' caches put together (``whole_kv_heads``)
within 1e-5 of the reference's whole cache, each kv head's replicas bit
for bit the same; the residual stream after every layer bit for bit the
same on model peers; the bf16 prefill logits bit for bit the stacked run's
with each row-parallel product rounded per peer (``_TPRounding``); a
planted fault (each process reading its neighbour's kv head) fails the
logits check.  megatron-moe-32e trained on (2, 1, 4) for 2 steps at
``test_torch_train.py``'s tolerances, replicated gradients bit for bit the
same on model peers.  ``convert.shard_module`` cuts every published
8-kv-head config on a (1, 1, 16) mesh, and internvl2-1b's 14 heads and
whisper-tiny's 6 there.
The reference runs once, in one subprocess on 8 fake devices.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from conftest import run_subprocess
from test_torch_serve_procs import _unflatten
from test_torch_tp_serve import _by_coords, _fake_mesh, _rel, _TPRounding
from test_torch_tp_train import _hook as _train_hook
from test_torch_train import OPTIONS, STEPS as TRAIN_STEPS, \
    _check_against_ref, _tree
from test_torch_train import _unflatten as _unflatten_dotted

from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import from_jax_params, recast, shard_module
from repro_torch.data import DataConfig
from repro_torch.launch import serve
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import whole_kv_heads
from repro_torch.models import layers, transformer
from repro_torch.models.tp import kv_heads

AXES = ("pod", "data", "model")
B, S, STEPS = 4, 8, 3
# name -> (arch, mesh, exchange, config overrides)
CASES = {"llama": ("llama3.2-1b", (1, 1, 4), None, {}),
         "megatron": ("megatron-moe-32e", (2, 1, 4), "plan", {}),
         "groups": ("qwen3-0.6b", (1, 1, 4), None,
                    {"n_heads": 12, "n_kv_heads": 3, "head_dim": 6})}
TRAIN = ("megatron-moe-32e", (2, 1, 4))
TRAIN_BATCH, TRAIN_SEQ = 8, 16
FAULT_CASE = "llama"

_JAX_SIDE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.core.schedulers import get_scheduler
from repro.core.traffic import ClusterSpec, moe_workload
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_serve_step
from repro.launch.shardings import param_shardings
from repro.launch.train import make_dist_context, make_rules
from repro.models import build_model, use_mesh_rules
from repro.models.transformer import init_lm, lm_prefill
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

out = {}
for name, (arch, shape, impl, over) in CASES.items():
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                              **over)
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
    plan = get_scheduler("flash").synthesize(moe_workload(
        ClusterSpec(shape[0], shape[1]), tokens_per_gpu=2048,
        bytes_per_token=2, seed=0)) if impl == "plan" else None
    dist = make_dist_context(cfg, mesh, impl, plan=plan)
    with use_mesh_rules(make_rules(cfg, mesh)):
        logits, cache = jax.jit(lambda p, t: lm_prefill(
            cfg, p, t, None, dist, cache_len=S + STEPS))(
                params, jnp.asarray(prompts))
    for i, c in enumerate(cache):
        out[f"{name}/cache{i}/k"] = np.asarray(c["k"])
        out[f"{name}/cache{i}/v"] = np.asarray(c["v"])
    out[f"{name}/logits0"] = np.asarray(logits)
    step = make_serve_step(cfg, mesh, impl, plan)
    toks = jnp.argmax(logits, -1)
    for i, t in enumerate(range(S, S + STEPS)):
        logits, cache = step(params, cache, toks, jnp.int32(t))
        out[f"{name}/logits{i + 1}"] = np.asarray(logits)
        toks = jnp.argmax(logits, -1)

real_update = T.adamw_update

def spy(grads, opt, params, lr, cfg):
    p, o, n = real_update(grads, opt, params, lr, cfg)
    return p, o, {"norm": n, "grads": grads}

T.adamw_update = spy   # the step reads its gradients out through grad_norm
arch, shape = TRAIN
cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
params0 = build_model(cfg).init(jax.random.PRNGKey(0))
out.update({f"train/init/{k}": v for k, v in flat(params0).items()})
data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH), cfg)
mesh = make_mesh(shape, ("pod", "data", "model"))
step, _, state_sh, batch_fn = T.make_train_step(cfg, mesh,
                                                T.TrainOptions(**OPTIONS))
state = jax.device_put({"params": params0, "opt": init_opt_state(params0),
                        "step": jnp.zeros((), jnp.int32)}, state_sh)
for i in range(TRAIN_STEPS):
    batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
    state, m = step(state, jax.device_put(batch, batch_fn(batch)))
    gn = m.pop("grad_norm")
    m["grad_norm"] = gn["norm"]
    for k, v in m.items():
        out[f"train/m{i}/{k}"] = np.asarray(v)
    for k, v in flat(gn["grads"]).items():
        out[f"train/g{i}/{k}"] = v
for k, v in flat(state["params"]).items():
    out[f"train/p/{k}"] = v
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_kv_cut") / "ref.npz")
    code = (f"CASES = {CASES!r}\nB, S, STEPS = {B}, {S}, {STEPS}\n"
            f"TRAIN = {TRAIN!r}\nTRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "
            f"{TRAIN_BATCH}, {TRAIN_SEQ}, {TRAIN_STEPS}\n"
            f"OPTIONS = {OPTIONS!r}\nOUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=8)
    return dict(np.load(path))


def _cfg(name, dtype="float32"):
    arch, _, _, over = CASES[name]
    return dataclasses.replace(smoke_config(arch), compute_dtype=dtype,
                               **over)


def _module(ref, name):
    pre = f"{name}/p/"
    params = _unflatten({k[len(pre):]: v for k, v in ref.items()
                         if k.startswith(pre)})
    return from_jax_params(params, _cfg(name), device="cpu")


def _plan(name):
    _, shape, impl, _ = CASES[name]
    return serve.flash_plan(shape[0], shape[1], seed=0) \
        if impl == "plan" else None


class _NextKVHead:
    """While active, each process reads the next kv head (cyclically) in
    place of each one its query heads read: the planted fault."""

    def __enter__(self):
        self.real = layers.kv_heads

        def shifted(n_heads, n_kv_heads, *place):
            return tuple((k + 1) % n_kv_heads for k in
                         self.real(n_heads, n_kv_heads, *place))
        layers.kv_heads = shifted
        return self

    def __exit__(self, *exc):
        layers.kv_heads = self.real


def _hook(mesh, cfg, shards, rows, serve_rows, *, name, plan):
    """``serve_procs``' own serve; then a recorded prefill (the stream after
    every layer, the cache), the bf16 prefill and, for ``FAULT_CASE``, the
    prefill under the planted fault."""
    serve_rows()
    impl, params = CASES[name][2], shards[0]
    out = {"coords": mesh.rank_coords}
    stream, real = [], transformer._block_prefill

    def spy(*args, **kw):
        got = real(*args, **kw)
        stream.append(got[0].numpy().copy())
        return got

    prefill = serve.make_prefill_step(cfg, mesh, impl, plan,
                                      cache_len=S + STEPS)
    transformer._block_prefill = spy
    try:
        _, cache = prefill(params, {"tokens": rows})
    finally:
        transformer._block_prefill = real
    out["stream"] = stream
    out["cache"] = [(c["k"], c["v"]) for c in cache]
    bf16 = _cfg(name, "bfloat16")
    out["bf16"] = serve.make_prefill_step(
        bf16, mesh, impl, plan, cache_len=S + STEPS)(
            recast(params, bf16), {"tokens": rows})[0]
    if name == FAULT_CASE:
        with _NextKVHead():
            out["fault"] = prefill(params, {"tokens": rows})[0]
    return out


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    """Every case's processes: rank 0's gathered serve and each rank's
    hook."""
    res = {}
    for name, (_, shape, impl, _) in CASES.items():
        plan = _plan(name)
        rdv = tmp_path_factory.mktemp(f"rdv_{name}") / "store"
        res[name] = serve.serve_procs(
            _cfg(name), [_module(ref, name)],
            torch.from_numpy(ref[f"{name}/prompts"]), shape, "gloo", "cpu",
            impl, plan, gen_len=STEPS + 1,
            hook=functools.partial(_hook, name=name, plan=plan),
            init_method=f"file://{rdv}", timeout=60.0, join_timeout=240)
    return res


@pytest.fixture(scope="module")
def local(ref):
    """The stacked LocalMesh run of every case: whole weights, the DP
    shape with "model" at 1."""
    out = {}
    for name, (_, shape, impl, _) in CASES.items():
        cfg, plan = _cfg(name), _plan(name)
        mesh = make_mesh(shape[:2] + (1,), AXES, device="cpu")
        module = _module(ref, name)
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
        out[name] = {"logits": got, "tokens": torch.stack(toks, 1)}
    return out


def _assemble(procs, name, get):
    """``get(rank)`` of every process: model peers' vocabulary shards
    joined along the last dim, then the DP ranks' rows."""
    shape = CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    return torch.cat([torch.cat([get(ranks[(p, d, m)])
                                 for m in range(shape[2])], -1)
                      for p in range(shape[0]) for d in range(shape[1])])


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
def test_replicated_cache_equals_reference(ref, procs, name):
    """Each process holds the kv heads its query heads read
    (``tp.kv_heads``); the model peers' caches put together, one copy of
    each kv head, are the reference's whole cache (``whole_kv_heads``
    raises where two replicas differ)."""
    cfg, shape = _cfg(name), CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    for (p, d, m), r in ranks.items():
        want = kv_heads(cfg.n_heads, cfg.n_kv_heads, shape[2], m)
        assert all(k.shape[2] == len(want) for k, _ in r["cache"])
    for layer in range(cfg.n_layers):
        for j, kv in enumerate(("k", "v")):
            got = torch.cat([whole_kv_heads(
                [ranks[(p, d, m)]["cache"][layer][j]
                 for m in range(shape[2])], cfg)
                for p in range(shape[0]) for d in range(shape[1])])
            want = ref[f"{name}/cache{layer}/{kv}"]
            assert got.shape == want.shape
            assert np.abs(got.numpy() - want).max() < 1e-5, (layer, kv)


@pytest.mark.parametrize("name", list(CASES))
def test_kv_head_replicas_identical_on_peers(procs, name):
    """Two model peers that read the same kv head hold it bit for bit
    alike, in every layer's keys and values."""
    cfg, shape = _cfg(name), CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    shared = 0
    for (p, d, m), r in ranks.items():
        sel = kv_heads(cfg.n_heads, cfg.n_kv_heads, shape[2], m)
        for m2 in range(m + 1, shape[2]):
            sel2 = kv_heads(cfg.n_heads, cfg.n_kv_heads, shape[2], m2)
            for i, k in enumerate(sel):
                for i2 in [i2 for i2, k2 in enumerate(sel2) if k2 == k]:
                    shared += 1
                    for a, b in zip(r["cache"], ranks[(p, d, m2)]["cache"]):
                        for t, t2 in zip(a, b):
                            assert torch.equal(t[:, :, i], t2[:, :, i2])
    assert shared


@pytest.mark.parametrize("name", list(CASES))
def test_residual_stream_identical_on_model_peers(procs, name):
    shape = CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = ranks[(pod, data, 0)]["stream"]
            assert len(first) == _cfg(name).n_layers
            for m in range(1, shape[2]):
                for a, b in zip(first, ranks[(pod, data, m)]["stream"]):
                    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_is_the_whole_model_with_tp_rounding(ref, procs, name):
    """The processes' bf16 prefill logits, gathered, are bit for bit the
    stacked run's with each row-parallel product rounded per peer before
    the sum (``_TPRounding``): the gather of the keys' and values' columns
    adds no rounding."""
    _, shape, impl, _ = CASES[name]
    cfg = _cfg(name, "bfloat16")
    params = recast(_module(ref, name), cfg)
    prefill = serve.make_prefill_step(
        cfg, make_mesh(shape[:2] + (1,), AXES, device="cpu"), impl,
        _plan(name), cache_len=S + STEPS, device="cpu")
    batch = {"tokens": torch.from_numpy(ref[f"{name}/prompts"])}
    plain = prefill(params, batch)[0]
    with _TPRounding(shape[2]):
        witness = prefill(params, batch)[0]
    got = _assemble(procs, name, lambda r: r["bf16"])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, witness)
    assert not torch.equal(got, plain)


def test_reading_the_next_kv_head_fails_the_logits_check(ref, procs):
    """The planted fault (``_NextKVHead``) moves the prefill's logits far
    past the 1e-5 that the processes' logits meet."""
    got = _assemble(procs, FAULT_CASE, lambda r: r["fault"])
    assert got.shape == (B, _cfg(FAULT_CASE).vocab)
    assert _rel(got.numpy(), ref[f"{FAULT_CASE}/logits0"]) > 1e-2


@pytest.fixture(scope="module")
def trained(ref, tmp_path_factory):
    arch, shape = TRAIN
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    module = from_jax_params(_unflatten_dotted(_tree(ref, "train/init/")),
                             cfg, device="cpu", train=True)
    rdv = tmp_path_factory.mktemp("rdv_train") / "store"
    return pt_train.train_procs(
        cfg, [module], DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), shape, "gloo",
        "cpu", pt_train.TrainOptions(**OPTIONS), TRAIN_STEPS,
        hook=_train_hook, init_method=f"file://{rdv}", timeout=60.0,
        join_timeout=240)["ranks"]


def test_processes_train_as_the_reference(ref, trained):
    assert len(trained) == int(np.prod(TRAIN[1]))
    for leaf in ("blocks.0.attn.wq", "blocks.0.attn.wk", "blocks.0.attn.wv",
                 "blocks.0.moe.w_down"):
        assert leaf in trained[0]["sharded"]
    _check_against_ref(ref, "train", trained[0]["run"])


def test_replicated_gradients_identical_on_model_peers(trained):
    shape = TRAIN[1]
    by = _by_coords(trained)
    for pod in range(shape[0]):
        first = by[(pod, 0, 0)]["replicated"]
        assert len(first) == TRAIN_STEPS and first[0]
        for m in range(1, shape[2]):
            for a, b in zip(first, by[(pod, 0, m)]["replicated"]):
                assert set(a) == set(b)
                for k in a:
                    assert np.array_equal(a[k], b[k]), k


def _shard_meta(cfg, mesh):
    """``shard_module`` of ``cfg``'s whole model on the meta device (no
    memory): the cut a process of ``mesh`` takes, refused nowhere."""
    from repro_torch.models import build_model

    whole = build_model(cfg, "meta").init(torch.Generator())
    shard = shard_module(whole, cfg, mesh, device="meta")
    assert set(dict(shard.named_parameters())) == \
        set(dict(whole.named_parameters()))
    return shard


PUBLISHED = ("llama3.2-1b", "granite-3-2b", "qwen3-0.6b", "megatron-moe-32e",
             "mixtral-8x7b", "mistral-large-123b", "dbrx-132b")


@pytest.mark.parametrize("arch", PUBLISHED)
def test_check_tp_accepts_the_published_8_kv_head_configs(arch):
    cfg = get_config(arch)
    assert cfg.n_kv_heads == 8 and cfg.n_heads % 16 == 0
    _shard_meta(cfg, _fake_mesh((1, 1, 16)))


@pytest.mark.parametrize("arch", ("internvl2-1b", "whisper-tiny"))
def test_check_tp_accepts_a_cut_through_a_query_head(arch):
    """internvl2-1b's 14 heads and whisper-tiny's 6 on the reference's
    16-way "model": each process's columns cut through a query head."""
    cfg = get_config(arch)
    assert cfg.n_heads % 16
    _shard_meta(cfg, _fake_mesh((1, 1, 16)))


@pytest.mark.parametrize("n_heads,n_kv,n,want", [
    (32, 8, 16, [(m // 2,) for m in range(16)]),
    (8, 2, 4, [(0,), (0,), (1,), (1,)]),
    (32, 8, 2, [(0, 1, 2, 3), (4, 5, 6, 7)]),
    (12, 3, 4, [(0,), (0, 1, 1), (1, 1, 2), (2,)]),
    (6, 3, 2, [(0, 0, 1), (1, 2, 2)]),
    (8, 2, 1, [(0, 1)])])
def test_kv_heads_of_each_coordinate(n_heads, n_kv, n, want):
    assert [kv_heads(n_heads, n_kv, n, c) for c in range(n)] == want
