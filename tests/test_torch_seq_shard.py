"""Sequence parallelism (``seq_shard_activations``, Megatron's SP) on one
process per rank: the residual stream on a sequence chunk between the TP
regions, gathered on entry (``tp.gather_seq``) and reduce-scattered on
exit (``tp.scatter_seq``).

* ``gather_seq`` and ``scatter_seq`` (and ``whole_seq`` / ``own_seq``) on
  3 gloo processes over a 7-row sequence (chunks of 3, the last padded),
  forward and backward, bit for bit against plain torch's member-order f32
  sums;
* every family the port runs on processes, at smoke size in f32 on
  (1, 1, 2): llama3.2-1b (dense), megatron-moe-32e (MoE), internvl2-1b
  (the vision stub's patches), whisper-tiny (encoder-decoder), xlstm-125m
  (mLSTM and sLSTM), hymba-1.5b (hybrid), one layer each (xlstm-125m's
  two).  One AdamW step at ``test_torch_train.py``'s tolerances against
  the reference's ``make_train_step`` with ``seq_shard_activations=True``
  on 2 fake devices, and internvl2-1b's prompt pass within a relative
  1e-5 of its ``lm_prefill``;
  against the same mesh's TP run without SP in the same processes: the
  logits and caches bit for bit, the gradients of the leaves "model" cuts
  and of the other replicated leaves bit for bit, the gradients of the
  leaves used on a chunk (the norms, the MLP's ``b_down``) within 1e-4 and
  bit for bit the same on the model peers;
* llama3.2-1b with a 7-token prompt on 2 (a chunk of 4 and one of 3 plus
  a padded row), against the reference's prompt pass and the TP run's.

One spawn serves and trains every family; the reference runs once, in one
subprocess on 2 fake devices.
"""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import run_subprocess
from test_torch_tp_head_cut import _nest
from test_torch_tp_serve import _rel
from test_torch_train import METRICS, OPTIONS, _tree

from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params, shard_module
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import procs, serve
from repro_torch.launch import train as pt_train
from repro_torch.launch.shardings import gather_tensor, sharded_axes
from repro_torch.models import tp as T
from repro_torch.models.transformer import greedy_tokens

AXES = ("pod", "data", "model")
SHAPE = (1, 1, 2)
B, S, STEPS = 4, 12, 2
TRAIN_BATCH, TRAIN_SEQ = 4, 8
FAMILIES = {"dense": "llama3.2-1b", "moe": "megatron-moe-32e",
            "vlm": "internvl2-1b", "encdec": "whisper-tiny",
            "ssm": "xlstm-125m", "hybrid": "hymba-1.5b"}
ODD = ("odd", "llama3.2-1b", 7)        # a prompt "model" does not divide
SERVED = {**{k: (a, S) for k, a in FAMILIES.items()}, ODD[0]: ODD[1:]}
# the prompt passes held to the reference's: the vision stub's patches on a
# chunk, and the padded chunk; every family's serving is held to the TP
# run's bits, which the TP tests hold to the reference, and its training
# (the same forward) to the reference's
REF_SERVED = ("vlm", ODD[0])

_JAX_SIDE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.launch.mesh import make_mesh
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

def config(arch):
    cfg = smoke_config(arch)
    return dataclasses.replace(cfg, compute_dtype="float32",
                               seq_shard_activations=True,
                               n_layers=2 if cfg.block_pattern else 1,
                               remat=False)

def inputs(cfg, s):
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, s))}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out

mesh = make_mesh(SHAPE, ("pod", "data", "model"))
out = {}
for name, (arch, s) in SERVED.items():
    cfg = config(arch)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    out.update({f"{arch}/p/{k}": v for k, v in flat(params).items()})
    inp = inputs(cfg, s)
    out.update({f"{name}/in/{k}": v for k, v in inp.items()})
    if name not in REF_SERVED:
        continue
    params = jax.device_put(params, param_shardings(
        cfg, mesh, jax.eval_shape(lambda: params)))
    dist = make_dist_context(cfg, mesh, None)
    batch = {k: jnp.asarray(v) for k, v in inp.items()}
    with use_mesh_rules(make_rules(cfg, mesh)):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        logits, cache = jax.jit(lambda p, t, e: lm_prefill(
            cfg, p, t, e or None, dist, cache_len=s + STEPS))(
                params, batch["tokens"], extras)
    out[f"{name}/logits0"] = np.asarray(logits)

real_update = T.adamw_update

def spy(grads, opt, params, lr, cfg):
    p, o, n = real_update(grads, opt, params, lr, cfg)
    return p, o, {"norm": n, "grads": grads}

T.adamw_update = spy   # the step reads its gradients out through grad_norm
for name, arch in FAMILIES.items():
    cfg = config(arch)
    params0 = build_model(cfg).init(jax.random.PRNGKey(0))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), cfg)
    tstep, _, state_sh, batch_fn = T.make_train_step(
        cfg, mesh, T.TrainOptions(**OPTIONS))
    state = jax.device_put({"params": params0,
                            "opt": init_opt_state(params0),
                            "step": jnp.zeros((), jnp.int32)}, state_sh)
    batch = {k: jnp.asarray(v) for k, v in data.batch(0).items()}
    state, m = tstep(state, jax.device_put(batch, batch_fn(batch)))
    gn = m.pop("grad_norm")
    m["grad_norm"] = gn["norm"]
    for k, v in m.items():
        out[f"train_{name}/m/{k}"] = np.asarray(v)
    for k, v in flat(gn["grads"]).items():
        out[f"train_{name}/g/{k}"] = v
    for k, v in flat(state["params"]).items():
        out[f"train_{name}/p/{k}"] = v
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("seq_shard") / "ref.npz")
    code = (f"SHAPE = {SHAPE!r}\nB, STEPS = {B}, {STEPS}\n"
            f"SERVED = {SERVED!r}\nFAMILIES = {FAMILIES!r}\n"
            f"REF_SERVED = {REF_SERVED!r}\n"
            f"TRAIN_BATCH, TRAIN_SEQ = {TRAIN_BATCH}, {TRAIN_SEQ}\n"
            f"OPTIONS = {OPTIONS!r}\nOUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=2)
    return dict(np.load(path))


def _cfg(arch, sp=True):
    """The reference's config: f32, one layer (xlstm-125m's two, an mLSTM
    and an sLSTM), no remat (which leaves the numbers as they are and
    doubles the reference's compile)."""
    cfg = smoke_config(arch)
    return dataclasses.replace(cfg, compute_dtype="float32",
                               seq_shard_activations=sp,
                               n_layers=2 if cfg.block_pattern else 1,
                               remat=False)


# -- the operators ------------------------------------------------------------

OPS_SHAPE, OPS_ROWS = (1, 1, 3), 7


def _operand(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _ops_child(mesh):
    """Each operator's forward and gradient on this process, beside the
    plain member-order sums every process can form from the peers'
    seeded operands."""
    n, m = mesh.axis_size("model"), T.model_coord(mesh)
    sp = T.SeqShard(mesh, OPS_ROWS)
    whole = (2, OPS_ROWS, 5)
    part = (2, sp.chunk, 5)
    out = {}
    # scatter_seq: peer q's partial whole x_q -> the chunk of sum_q x_q
    x = _operand(10 + m, whole).requires_grad_()
    y = T.scatter_seq(sp, x)
    y.backward(_operand(20 + m, part))
    total = sum(_operand(10 + q, whole) for q in range(n))   # member order
    out["scatter"] = (y.detach(), sp.own(total))
    out["scatter.bwd"] = (x.grad, sp.join(torch.stack(
        [_operand(20 + q, part) for q in range(n)])))
    # gather_seq: peer q's chunk -> the joined sequence; backward the
    # member-order sum of the peers' cotangents, this chunk kept
    c = _operand(30 + m, part).requires_grad_()
    w = T.gather_seq(sp, c)
    w.backward(_operand(40 + m, whole))
    out["gather"] = (w.detach(), sp.join(torch.stack(
        [_operand(30 + q, part) for q in range(n)])))
    out["gather.bwd"] = (c.grad, sp.own(sum(_operand(40 + q, whole)
                                            for q in range(n))))
    # whole_seq / own_seq: the replicated region's pair
    c2 = _operand(30 + m, part).requires_grad_()
    w2 = T.whole_seq(sp, c2)
    w2.backward(_operand(40, whole))          # the same on every peer
    out["whole.bwd"] = (c2.grad, sp.own(_operand(40, whole)))
    x2 = _operand(50, whole).requires_grad_()
    o2 = T.own_seq(sp, x2)
    o2.backward(_operand(60 + m, part))
    out["own"] = (o2.detach(), sp.own(_operand(50, whole)))
    out["own.bwd"] = (x2.grad, sp.join(torch.stack(
        [_operand(60 + q, part) for q in range(n)])))
    return out


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv_ops") / "store"
    return procs.spawn(_ops_child, OPS_SHAPE, AXES, "gloo", "cpu",
                       init_method=f"file://{rdv}", timeout=60.0,
                       join_timeout=120)


@pytest.mark.parametrize("what", ["scatter", "scatter.bwd", "gather",
                                  "gather.bwd", "whole.bwd", "own",
                                  "own.bwd"])
def test_sequence_operators_sum_in_member_order(ops, what):
    for rank in ops:
        got, want = rank[what]
        assert got.shape == want.shape
        assert torch.equal(got, want), what


def test_seq_shard_pads_the_last_chunks():
    """7 rows on 3: chunks of 3 rows, the last holding one row and two
    zero rows; a join cuts the padding."""
    class _Mesh:
        axis_names, rank_coords = AXES, (0, 0, 2)

        @staticmethod
        def axis_size(_):
            return 3

    sp = T.SeqShard(_Mesh, 7)
    x = torch.arange(2 * 7, dtype=torch.float32).reshape(1, 7, 2)
    assert (sp.chunk, sp.start) == (3, 6)
    own = sp.own(x)
    assert torch.equal(own[0, 0], x[0, 6])
    assert not own[0, 1:].any()
    assert torch.equal(sp.join(sp.chunks(x)), x)


# -- the families ---------------------------------------------------------------

def _gather_logits(mesh, cfg, logits):
    return gather_tensor(logits, (None, "model"), mesh) \
        if logits.shape[-1] != cfg.vocab else logits


def _serve(mesh, cfg, whole, inp, s):
    """The prompt pass and ``STEPS`` greedy steps of this process's shard:
    the logits (whole vocabulary) and the prefill's cache."""
    shard = shard_module(whole, cfg, mesh)
    dist = pt_train.make_dist_context(cfg, mesh)
    step = serve.make_serve_step(cfg, mesh)
    batch = {k: v.clone() for k, v in inp.items()}
    with torch.no_grad():
        if cfg.encdec:
            logits, cache = serve._encdec_prefill(cfg, mesh, shard, batch,
                                                  s + STEPS, step)
        else:
            logits, cache = serve.make_prefill_step(
                cfg, mesh, cache_len=s + STEPS)(shard, batch)
        prefill_cache = [{k: v.clone() for k, v in c.items()
                          if torch.is_tensor(v)} for c in cache]
        got = [_gather_logits(mesh, cfg, logits)]
        toks = greedy_tokens(cfg, logits, dist)
        for t in range(s, s + STEPS):
            logits, cache = step(shard, cache, toks, t)
            got.append(_gather_logits(mesh, cfg, logits))
            toks = greedy_tokens(cfg, logits, dist)
    return got, prefill_cache


def _train(mesh, cfg, whole):
    """One AdamW step of this process's trainable shard: (metrics, its
    gradients, its parameters after the step, the specs)."""
    specs = pt_train.train_specs(cfg, mesh)
    shard = shard_module(whole, cfg, mesh, train=True)
    step = pt_train.make_train_step(cfg, mesh,
                                    pt_train.TrainOptions(**OPTIONS))
    seen, real = [], pt_train.adamw_update

    def spy(grads, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return real(grads, *args)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), cfg)
    pt_train.adamw_update = spy
    try:
        _, m = step(pt_train.init_train_state(shard), data.batch(0))
    finally:
        pt_train.adamw_update = real
    params = {k: v.detach().clone() for k, v in shard.named_parameters()}
    return {k: float(v) for k, v in m.items()}, seen[0], params, specs


def _whole(mesh, specs, named):
    return {k: gather_tensor(v, specs[k], mesh) for k, v in named.items()}


def _tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _family_child(mesh, cases):
    """For each case: served and trained with SP and without it (the same
    mesh's TP run); the comparisons between the two, and (rank 0) the SP
    run's whole logits, gradients and parameters for the reference."""
    out = {"coords": mesh.rank_coords}
    for name, (arch, s, serve_whole, train_whole, inp) in cases.items():
        serve_whole, inp = _tensors(serve_whole), _tensors(inp)
        train_whole = _tensors(train_whole) if train_whole else None
        res = {}
        sp_cfg, tp_cfg = _cfg(arch), _cfg(arch, sp=False)
        sp_logits, sp_cache = _serve(mesh, sp_cfg, serve_whole, inp, s)
        tp_logits, tp_cache = _serve(mesh, tp_cfg, serve_whole, inp, s)
        res["logits_equal"] = all(torch.equal(a, b)
                                  for a, b in zip(sp_logits, tp_logits))
        res["cache_equal"] = all(
            set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
            for a, b in zip(sp_cache, tp_cache))
        if train_whole is not None:
            sp_m, sp_g, sp_p, specs = _train(mesh, sp_cfg, train_whole)
            _, tp_g, _, _ = _train(mesh, tp_cfg, train_whole)
            partial = pt_train._seq_partial_leaves(sp_cfg, mesh, specs)
            res["partial"] = partial
            res["cut"] = sorted(k for k, sp in specs.items()
                                if sharded_axes(mesh, sp))
            res["differ"] = sorted(k for k in specs if k not in partial
                                   and not torch.equal(sp_g[k], tp_g[k]))
            res["partial_err"] = {k: _rel(sp_g[k].numpy(), tp_g[k].numpy())
                                  for k in partial}
            res["partial_grads"] = {k: sp_g[k].numpy() for k in partial}
            res["train"] = (sp_m, _whole(mesh, specs, sp_g),
                            _whole(mesh, specs, sp_p))
        res["logits"] = [lg.numpy() for lg in sp_logits]
        out[name] = res
    return out


@pytest.fixture(scope="module")
def families(ref, tmp_path_factory):
    cases = {}
    for name, (arch, s) in SERVED.items():
        params = _nest(_tree(ref, f"{arch}/p/"))
        serve_whole = {k: v.detach().numpy() for k, v in from_jax_params(
            params, _cfg(arch), device="cpu").named_parameters()}
        train_whole = None
        if name in FAMILIES:
            train_whole = {k: v.detach().numpy() for k, v in from_jax_params(
                params, _cfg(arch), device="cpu",
                train=True).named_parameters()}
        inp = _tree(ref, f"{name}/in/")
        cases[name] = (arch, s, serve_whole, train_whole, inp)
    rdv = tmp_path_factory.mktemp("rdv_families") / "store"
    return procs.spawn(_family_child, SHAPE, AXES, "gloo", "cpu", cases,
                       init_method=f"file://{rdv}", timeout=60.0,
                       join_timeout=300)


@pytest.mark.parametrize("name", REF_SERVED)
def test_logits_match_the_reference_with_seq_shard(ref, families, name):
    got = families[0][name]["logits"][0]
    want = ref[f"{name}/logits0"]
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("name", list(SERVED))
def test_serving_is_bit_identical_to_tp(families, name):
    """The prompt pass's and each decode step's logits, and the prefill's
    caches, the same bits as the same mesh's TP run without SP, on every
    process."""
    for rank in families:
        assert rank[name]["logits_equal"]
        assert rank[name]["cache_equal"]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_step_matches_the_reference_with_seq_shard(ref, families,
                                                         name):
    metrics, grads, final = families[0][name]["train"]
    case = f"train_{name}"
    for k in METRICS:
        want = float(ref[f"{case}/m/{k}"])
        assert abs(metrics[k] - want) <= 1e-5 * max(abs(want), 1e-6), k
    want = _tree(ref, f"{case}/g/")
    assert set(grads) == set(want)
    for k, g in grads.items():
        g, w = g.numpy(), want[k].astype(np.float32)
        assert np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12) < 1e-4, k
    for k, p in final.items():
        w = ref[f"{case}/p/{k}"].astype(np.float32)
        assert np.abs(p.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                         1.0), k


@pytest.mark.parametrize("name", list(FAMILIES))
def test_gradients_bit_identical_to_tp_but_the_chunk_leaves(families, name):
    """Every gradient the same bits as the TP run's, the leaves "model"
    cuts included, except those used on a sequence chunk (the norms'
    ``scale`` and ``bias``, ``b_down``): sums of per-chunk sums, within
    1e-4."""
    for rank in families:
        res = rank[name]
        assert res["cut"] and res["partial"]
        assert res["differ"] == []
        assert max(res["partial_err"].values()) < 1e-4


@pytest.mark.parametrize("name", list(FAMILIES))
def test_chunk_leaves_gradients_identical_on_model_peers(families, name):
    first = families[0][name]["partial_grads"]
    for rank in families[1:]:
        got = rank[name]["partial_grads"]
        assert set(got) == set(first)
        for k in first:
            assert np.array_equal(got[k], first[k]), k
