"""Tensor parallelism over "model" where "model" cuts through a query head
(internvl2-1b's 14 heads on the reference's 16-way "model", at smoke
size), and the encoder-decoder over "model": each process projects its
``wq`` columns, the peers' columns are gathered over "model"
(``tp.gather_cols``), each process computes the whole query heads its
columns touch (``tp.q_heads``) against the kv heads they read
(``tp.kv_heads``) and keeps its own columns of their output for its
``wo`` rows.  Smoke archs in f32 on gloo CPU processes against the
reference's GSPMD run on fake devices (its parameters placed by
``param_shardings``) and against the port's stacked ``LocalMesh`` run of
the same DP shape (whole weights):

* internvl2-1b with 6 heads over 2 kv heads of dim 16 on (1, 1, 4): 1.5
  query heads and half a kv head's columns a process, ``patch_embeds``
  fed;
* whisper-tiny with 6 heads and 6 kv heads of dim 8 on (1, 1, 4): 1.5
  heads a process in the encoder, the decoder and the cross-attention, a
  vocabulary-parallel tied head;
* whisper-tiny's smoke config on (1, 2, 2): whole heads, and DP;
* llama3.2-1b on (1, 1, 3): every leaf kept whole by ``_drop_uneven``, so
  attention, the MLP and the head run whole on every process.

Checked: the prompt pass's and each decode step's logits within a
relative 1e-5 of both (an encoder-decoder's prompt pass is the encoder and
cross K/V, then the decode step over the prompt; its teacher-forced
forward too), greedy tokens equal; the model peers' caches, cross caches
included, put together (``whole_kv_heads``) within 1e-5 of the
reference's whole cache, each kv head's replicas and each shared query
head's attention output bit for bit the same on the peers; the residual
stream bit for bit the same on model peers; bf16 prompt-pass logits bit
for bit the stacked run's with each row-parallel product rounded per peer
(``_TPRounding``); a planted fault (each process keeping its neighbour's
columns) fails the logits check.  Two training steps at
``test_torch_train.py``'s tolerances, replicated gradients bit for bit
the same on model peers.  The reference runs once, in one subprocess on
4 fake devices.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from conftest import run_subprocess
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
from repro_torch.launch.shardings import whole_kv_heads
from repro_torch.models import encdec, layers, transformer
from repro_torch.models.tp import kv_heads, q_heads

AXES = ("pod", "data", "model")
B, S, STEPS = 4, 8, 3
# name -> (arch, mesh, config overrides)
CASES = {"vlm": ("internvl2-1b", (1, 1, 4),
                 {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16}),
         "whisper": ("whisper-tiny", (1, 1, 4),
                     {"n_heads": 6, "n_kv_heads": 6, "head_dim": 8}),
         "whisper_dp": ("whisper-tiny", (1, 2, 2), {}),
         "llama": ("llama3.2-1b", (1, 1, 3), {})}
CUT = ("vlm", "whisper")           # the cases whose columns cut a head
TRAIN = ("vlm", "whisper", "whisper_dp")
TRAIN_BATCH, TRAIN_SEQ = 4, 8
FAULT_CASE = "vlm"

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
from repro.models.encdec import encdec_init_cache
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

def inputs(cfg, batch):
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, S))}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out

out = {}
for name, (arch, shape, over) in CASES.items():
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                              **over)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    out.update({f"{name}/p/{k}": v for k, v in flat(params).items()})
    inp = inputs(cfg, B)
    out.update({f"{name}/in/{k}": v for k, v in inp.items()})
    mesh = make_mesh(shape, ("pod", "data", "model"))
    params = jax.device_put(params, param_shardings(
        cfg, mesh, jax.eval_shape(lambda: params)))
    dist = make_dist_context(cfg, mesh, None)
    batch = {k: jnp.asarray(v) for k, v in inp.items()}
    step = make_serve_step(cfg, mesh, None)
    with use_mesh_rules(make_rules(cfg, mesh)):
        if cfg.encdec:
            fwd, _ = jax.jit(lambda p, b: model.prefill(p, b, dist))(
                params, batch)
            out[f"{name}/fwd"] = np.asarray(fwd)
            cache = jax.jit(lambda p, f: encdec_init_cache(
                cfg, B, S + STEPS, f, p))(params, batch["frames"])
    if cfg.encdec:
        for t in range(S):
            logits, cache = step(params, cache, batch["tokens"][:, t],
                                 jnp.int32(t))
    else:
        with use_mesh_rules(make_rules(cfg, mesh)):
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            logits, cache = jax.jit(lambda p, t, e: lm_prefill(
                cfg, p, t, e or None, dist, cache_len=S + STEPS))(
                    params, batch["tokens"], extras)
    for i, c in enumerate(cache):
        for k, v in c.items():
            out[f"{name}/cache{i}/{k}"] = np.asarray(v)
    out[f"{name}/logits0"] = np.asarray(logits)
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
for name in TRAIN:
    arch, shape, over = CASES[name]
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                              **over)
    params0 = build_model(cfg).init(jax.random.PRNGKey(0))
    out.update({f"train_{name}/init/{k}": v
                for k, v in flat(params0).items()})
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), cfg)
    mesh = make_mesh(shape, ("pod", "data", "model"))
    step, _, state_sh, batch_fn = T.make_train_step(
        cfg, mesh, T.TrainOptions(**OPTIONS))
    state = jax.device_put({"params": params0,
                            "opt": init_opt_state(params0),
                            "step": jnp.zeros((), jnp.int32)}, state_sh)
    for i in range(TRAIN_STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        state, m = step(state, jax.device_put(batch, batch_fn(batch)))
        gn = m.pop("grad_norm")
        m["grad_norm"] = gn["norm"]
        for k, v in m.items():
            out[f"train_{name}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(gn["grads"]).items():
            out[f"train_{name}/g{i}/{k}"] = v
    for k, v in flat(state["params"]).items():
        out[f"train_{name}/p/{k}"] = v
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_head_cut") / "ref.npz")
    code = (f"CASES = {CASES!r}\nTRAIN = {TRAIN!r}\n"
            f"B, S, STEPS = {B}, {S}, {STEPS}\n"
            f"TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = {TRAIN_BATCH}, "
            f"{TRAIN_SEQ}, {TRAIN_STEPS}\n"
            f"OPTIONS = {OPTIONS!r}\nOUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=4)
    return dict(np.load(path))


def _cfg(name, dtype="float32"):
    arch, _, over = CASES[name]
    return dataclasses.replace(smoke_config(arch), compute_dtype=dtype,
                               **over)


def _nest(flat):
    """Dotted names -> the nested pytree ``from_jax_params`` takes (digit
    components as list indices)."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(tree)


def _module(ref, name, prefix=None, train=False):
    return from_jax_params(_nest(_tree(ref, prefix or f"{name}/p/")),
                           _cfg(name), device="cpu", train=train)


def _inputs(ref, name):
    """(prompts, extras) of a case, as the reference took them."""
    got = {k: torch.from_numpy(v) for k, v in _tree(ref, f"{name}/in/").items()}
    return got.pop("tokens"), got


def _prompt_pass(cfg, mesh, params, batch, cache_len, device=None):
    """(the last position's logits, the cache) of the prompt pass as the
    serving runs it (``serve._greedy``)."""
    step = serve.make_serve_step(cfg, mesh, device=device)
    if cfg.encdec:
        return serve._encdec_prefill(cfg, mesh, params, batch, cache_len,
                                     step)
    return serve.make_prefill_step(cfg, mesh, cache_len=cache_len,
                                   device=device)(params, batch)


class _Witness(_TPRounding):
    """``_TPRounding`` reaching the encoder-decoder's cross-attention, whose
    module holds its own name for ``row_parallel``."""

    def __enter__(self):
        super().__enter__()
        self.encdec_real = encdec.row_parallel
        encdec.row_parallel = layers.row_parallel
        return self

    def __exit__(self, *exc):
        encdec.row_parallel = self.encdec_real
        super().__exit__(*exc)


class _NeighbourColumns:
    """While active, each process keeps the columns next to its own (the
    touched heads' output rolled by its width) for its ``wo`` rows: the
    planted fault."""

    def __enter__(self):
        self.real = real = layers._own_cols

        def shifted(out, off, cols):
            return real(out.roll(-cols, -1), off, cols)
        layers._own_cols = encdec._own_cols = shifted
        return self

    def __exit__(self, *exc):
        layers._own_cols = encdec._own_cols = self.real


class _Record:
    """While active, records the residual stream (the input of every norm,
    a replicated tensor) and each attention kernel call's output with the
    query heads it computed."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.stream, self.attn = [], []

    def __enter__(self):
        self.norm, self.flash = layers.norm_apply, layers.flash_attention
        mod = encdec if self.cfg.encdec else transformer

        def norm(cfg, p, x):
            self.stream.append(x.detach().numpy().copy())
            return self.norm(cfg, p, x)

        def flash(q, k, v, **kw):
            o = self.flash(q, k, v, **kw)
            self.attn.append(o.detach().numpy().copy())
            return o
        self.mod = mod
        mod.norm_apply = norm
        layers.flash_attention = flash
        return self

    def __exit__(self, *exc):
        self.mod.norm_apply = self.norm
        layers.flash_attention = self.flash


def _hook(mesh, cfg, shards, rows, serve_rows, *, name):
    """``serve_procs``' own serve; then a recorded prompt pass (the stream,
    each attention output, the cache), an encoder-decoder's teacher-forced
    forward, the bf16 prompt pass and, for ``FAULT_CASE``, the prompt pass
    under the planted fault."""
    serve_rows()
    params, extras = shards[0], serve_rows.extras
    batch = {"tokens": rows, **extras}
    out = {"coords": mesh.rank_coords}
    with torch.no_grad(), _Record(cfg, mesh) as rec:
        if cfg.encdec:
            out["fwd"] = serve.make_prefill_step(cfg, mesh)(params, batch)[0]
        _, cache = _prompt_pass(cfg, mesh, params, batch, S + STEPS)
    out.update(stream=rec.stream, attn=rec.attn, cache=cache)
    bf16 = _cfg(name, "bfloat16")
    prefill = serve.make_prefill_step(bf16, mesh) if bf16.encdec else \
        serve.make_prefill_step(bf16, mesh, cache_len=S + STEPS)
    out["bf16"] = prefill(recast(params, bf16), batch)[0]
    if name == FAULT_CASE:
        with _NeighbourColumns():
            out["fault"] = _prompt_pass(cfg, mesh, params, batch,
                                        S + STEPS)[0]
    return out


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    """Every case's processes: rank 0's gathered serve and each rank's
    hook."""
    res = {}
    for name, (_, shape, _) in CASES.items():
        prompts, extras = _inputs(ref, name)
        rdv = tmp_path_factory.mktemp(f"rdv_{name}") / "store"
        res[name] = serve.serve_procs(
            _cfg(name), [_module(ref, name)], prompts, shape, "gloo", "cpu",
            gen_len=STEPS + 1, hook=functools.partial(_hook, name=name),
            extras=extras, init_method=f"file://{rdv}", timeout=60.0,
            join_timeout=240)
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
        prompts, extras = _inputs(ref, name)
        step = serve.make_serve_step(cfg, mesh, device="cpu")
        logits, cache = _prompt_pass(cfg, mesh, module,
                                     {"tokens": prompts, **extras},
                                     S + STEPS, device="cpu")
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


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_reference_and_local_mesh(ref, procs, local, name,
                                               step):
    got = procs[name]["logits"][step].numpy()
    assert got.shape == (B, _cfg(name).vocab)
    assert _rel(got, ref[f"{name}/logits{step}"]) < 1e-5
    assert _rel(got, local[name]["logits"][step].numpy()) < 1e-5


@pytest.mark.parametrize("name", ["whisper", "whisper_dp"])
def test_teacher_forced_forward_matches_reference(ref, procs, name):
    """The encoder-decoder's ``Model.prefill`` (the teacher-forced forward
    over the prompt, which training's loss takes) on the processes."""
    got = _assemble(procs, name, lambda r: r["fwd"]).numpy()
    want = ref[f"{name}/fwd"]
    assert got.shape == want.shape == (B, S, _cfg(name).vocab)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal(ref, procs, local, name):
    got = procs[name]["tokens"]
    assert torch.equal(got, local[name]["tokens"])
    want = np.stack([ref[f"{name}/logits{i}"].argmax(-1)
                     for i in range(STEPS + 1)], 1)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
def test_caches_put_together_equal_reference(ref, procs, name):
    """Each process's cache (an encoder-decoder's cross cache too) holds
    the kv heads that the query heads its columns touch read; the model
    peers' caches put together, one copy of each kv head, are the
    reference's whole cache (``whole_kv_heads`` raises where two replicas
    differ)."""
    cfg, shape = _cfg(name), CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    keys = ("k", "v", "xk", "xv") if cfg.encdec else ("k", "v")
    for (p, d, m), r in ranks.items():
        n = 1 if name == "llama" else shape[2]
        want = kv_heads(cfg.n_heads, cfg.n_kv_heads, n, m % n)
        assert all(c[k].shape[2] == len(want) for c in r["cache"]
                   for k in keys)
    for layer in range(cfg.n_layers):
        whole = [whole_kv_heads(
            [ranks[(p, d, m)]["cache"][layer] for m in range(shape[2])]
            if name != "llama" else [ranks[(p, d, 0)]["cache"][layer]], cfg)
            for p in range(shape[0]) for d in range(shape[1])]
        assert set(whole[0]) == set(keys)
        for k in keys:
            got = torch.cat([w[k] for w in whole]).numpy()
            want = ref[f"{name}/cache{layer}/{k}"]
            assert got.shape == want.shape
            assert np.abs(got - want).max() < 1e-5, (layer, k)


@pytest.mark.parametrize("name", ["vlm", "whisper", "llama"])
def test_kv_head_replicas_identical_on_peers(procs, name):
    """Two model peers that read the same kv head hold it bit for bit
    alike, in every layer's keys and values (and cross keys and values)."""
    cfg, shape = _cfg(name), CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    n = 1 if name == "llama" else shape[2]
    shared = 0
    for m in range(shape[2]):
        sel = kv_heads(cfg.n_heads, cfg.n_kv_heads, n, m % n)
        for m2 in range(m + 1, shape[2]):
            sel2 = kv_heads(cfg.n_heads, cfg.n_kv_heads, n, m2 % n)
            for i, k in enumerate(sel):
                for i2 in [i2 for i2, k2 in enumerate(sel2) if k2 == k]:
                    shared += 1
                    for a, b in zip(ranks[(0, 0, m)]["cache"],
                                    ranks[(0, 0, m2)]["cache"]):
                        for key in a:
                            assert torch.equal(a[key][:, :, i],
                                               b[key][:, :, i2])
    assert shared


@pytest.mark.parametrize("name", CUT)
def test_shared_query_heads_identical_on_peers(procs, name):
    """Two model peers whose columns touch the same query head compute its
    attention output bit for bit alike, in every attention call of the
    prompt pass (the encoder's and the decoder's)."""
    cfg, shape = _cfg(name), CASES[name][1]
    dh = cfg.resolved_head_dim
    cols = cfg.n_heads * dh // shape[2]
    ranks = _by_coords(procs[name]["ranks"])
    heads = [q_heads(cfg.n_heads, dh, cols, m)[0] for m in range(shape[2])]
    shared = 0
    for m in range(shape[2]):
        a = ranks[(0, 0, m)]["attn"]
        assert len(a) > 0 and all(o.shape[1] == len(heads[m]) for o in a)
        for m2 in range(m + 1, shape[2]):
            b = ranks[(0, 0, m2)]["attn"]
            assert len(b) == len(a)
            for h in set(heads[m]) & set(heads[m2]):
                i, i2 = heads[m].index(h), heads[m2].index(h)
                for oa, ob in zip(a, b):
                    assert np.array_equal(oa[:, i], ob[:, i2])
                    shared += 1
    assert shared        # 1.5 heads a process: peers 0 and 1 share head 1


@pytest.mark.parametrize("name", list(CASES))
def test_residual_stream_identical_on_model_peers(procs, name):
    shape = CASES[name][1]
    ranks = _by_coords(procs[name]["ranks"])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = ranks[(pod, data, 0)]["stream"]
            assert len(first) >= 2 * _cfg(name).n_layers
            for m in range(1, shape[2]):
                other = ranks[(pod, data, m)]["stream"]
                assert len(other) == len(first)
                for a, b in zip(first, other):
                    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_is_the_whole_model_with_tp_rounding(ref, procs, name):
    """The processes' bf16 prompt-pass logits (an encoder-decoder's
    teacher-forced forward), gathered, are bit for bit the stacked run's
    with each row-parallel product rounded per peer before the sum
    (``_Witness``): the gathers of the query, key and value columns add no
    rounding, nor does computing a shared head on two peers.  Where every
    leaf is whole (llama on 3) they are the plain stacked run's."""
    cfg = _cfg(name, "bfloat16")
    shape = CASES[name][1]
    params = recast(_module(ref, name), cfg)
    mesh = make_mesh(shape[:2] + (1,), AXES, device="cpu")
    prefill = serve.make_prefill_step(cfg, mesh, device="cpu") \
        if cfg.encdec else serve.make_prefill_step(
            cfg, mesh, cache_len=S + STEPS, device="cpu")
    prompts, extras = _inputs(ref, name)
    batch = {"tokens": prompts, **extras}
    plain = prefill(params, batch)[0]
    got = _assemble(procs, name, lambda r: r["bf16"])
    assert got.dtype == torch.bfloat16
    if name == "llama":
        assert torch.equal(got, plain)
        return
    with _Witness(shape[2]):
        witness = prefill(params, batch)[0]
    assert torch.equal(got, witness)
    assert not torch.equal(got, plain)


def test_neighbour_columns_fail_the_logits_check(ref, procs):
    """The planted fault (``_NeighbourColumns``) moves the prompt pass's
    logits far past the 1e-5 that the processes' logits meet."""
    got = _assemble(procs, FAULT_CASE, lambda r: r["fault"])
    assert got.shape == (B, _cfg(FAULT_CASE).vocab)
    assert _rel(got.numpy(), ref[f"{FAULT_CASE}/logits0"]) > 1e-2


@pytest.fixture(scope="module")
def trained(ref, tmp_path_factory):
    out = {}
    for name in TRAIN:
        cfg, shape = _cfg(name), CASES[name][1]
        module = _module(ref, name, f"train_{name}/init/", train=True)
        rdv = tmp_path_factory.mktemp(f"rdv_train_{name}") / "store"
        out[name] = pt_train.train_procs(
            cfg, [module], DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH), shape,
            "gloo", "cpu", pt_train.TrainOptions(**OPTIONS), TRAIN_STEPS,
            hook=_train_hook, init_method=f"file://{rdv}", timeout=60.0,
            join_timeout=240)["ranks"]
    return out


@pytest.mark.parametrize("name", TRAIN)
def test_processes_train_as_the_reference(ref, trained, name):
    ranks = trained[name]
    assert len(ranks) == int(np.prod(CASES[name][1]))
    attn = "blocks.0.attn" if name == "vlm" else "dec_blocks.0.xattn"
    for leaf in ("wq", "wk", "wo"):
        assert f"{attn}.{leaf}" in ranks[0]["sharded"]
    if name != "vlm":
        assert "embed" in ranks[0]["sharded"]
        assert "enc_pos" not in ranks[0]["sharded"]
    _check_against_ref(ref, f"train_{name}", ranks[0]["run"])


@pytest.mark.parametrize("name", TRAIN)
def test_replicated_gradients_identical_on_model_peers(trained, name):
    shape = CASES[name][1]
    by = _by_coords(trained[name])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = by[(pod, data, 0)]["replicated"]
            assert len(first) == TRAIN_STEPS and first[0]
            for m in range(1, shape[2]):
                for a, b in zip(first, by[(pod, data, m)]["replicated"]):
                    assert set(a) == set(b)
                    for k in a:
                        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n_heads,dh,n,want", [
    (14, 64, 16, [(0, 1, 0), (0, 2, 56), (1, 3, 48), (2, 4, 40),
                  (3, 5, 32), (4, 6, 24), (5, 7, 16), (6, 7, 8),
                  (7, 8, 0), (7, 9, 56), (8, 10, 48), (9, 11, 40),
                  (10, 12, 32), (11, 13, 24), (12, 14, 16), (13, 14, 8)]),
    (6, 16, 4, [(0, 2, 0), (1, 3, 8), (3, 5, 0), (4, 6, 8)]),
    (6, 64, 16, [(m * 24 // 64, -(-(m + 1) * 24 // 64), m * 24 % 64)
                 for m in range(16)]),
    (8, 8, 4, [(0, 2, 0), (2, 4, 0), (4, 6, 0), (6, 8, 0)]),
    (4, 12, 1, [(0, 4, 0)])])
def test_q_heads_of_each_coordinate(n_heads, dh, n, want):
    cols = n_heads * dh // n
    got = [q_heads(n_heads, dh, cols, m) for m in range(n)]
    assert [(r.start, r.stop, off) for r, off in got] == want
    for (r, off), m in zip(got, range(n)):
        # the columns lie inside the heads they touch
        assert r.start * dh + off == m * cols
        assert m * cols + cols <= r.stop * dh


@pytest.mark.parametrize("n_heads,n_kv,n,want", [
    (14, 2, 16, [(0,)] * 8 + [(1,)] * 8),
    (6, 2, 4, [(0,), (0,), (1,), (1,)]),
    (6, 3, 4, [(0,), (0, 1), (1, 2), (2,)]),
    (6, 6, 4, [(0, 1), (1, 2), (3, 4), (4, 5)]),
    (6, 6, 16, [(m * 6 // 16,) if (m * 6) % 16 + 6 <= 16 else
                (m * 6 // 16, m * 6 // 16 + 1) for m in range(16)])])
def test_kv_heads_of_the_touched_query_heads(n_heads, n_kv, n, want):
    """The kv heads a coordinate reads when its columns cut through a query
    head: those of the one or two heads it touches (a range that crosses a
    GQA group reads one kv head a query head), the same as
    ``kv_heads(..., heads=q_heads(...))``."""
    got = [kv_heads(n_heads, n_kv, n, m) for m in range(n)]
    assert got == want
    dh = 16
    for m in range(n):
        heads, _ = q_heads(n_heads, dh, n_heads * dh // n, m)
        assert kv_heads(n_heads, n_kv, heads=heads) == got[m]
