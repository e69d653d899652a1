"""The serving slice end to end at smoke size: ``lm_prefill`` plus four
greedy decode steps of megatron-moe-32e (f32).

* With no mesh, the port against the reference's ``lm_prefill`` and
  ``decode_step`` on the same parameters (``from_jax_params``) and prompts:
  logits within a relative error of 1e-4, identical greedy tokens.
* On a local (2, 2, 1) mesh with ``plan``, the port against its own run
  with no mesh, within 1e-4, with no token dropped on either side; the same
  mesh run with ``direct`` is bit-identical to ``plan``.
* mixtral-8x7b (smoke, f32) on a local (2, 3, 1) mesh, its experts over
  ``pod`` alone, through the rotation (``flash``), ``plan`` and ``direct``:
  within 1e-4 of its run with no mesh, equal greedy tokens, the three
  bit-identical.
* ``use_kernel=False`` reaches no kernel wrapper, with or without a mesh;
  with the kernels, prefill attention launches once per layer and decode
  never.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models.transformer import init_lm as ref_init_lm
from repro.models.transformer import lm_prefill as ref_lm_prefill
from repro_torch.comm import plan_exec
from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, layers, moe

ARCH = "megatron-moe-32e"
B, S, STEPS = 4, 16, 4


def _cfgs(**over):
    over = dict(compute_dtype="float32", **over)
    return (dataclasses.replace(ref_smoke_config(ARCH), **over),
            dataclasses.replace(smoke_config(ARCH), **over))


def _prompts(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab, (B, S))


def _ref_run(cfg, params, prompts, extras=None):
    """The reference: prefill, then STEPS greedy decode steps."""
    logits, cache = ref_lm_prefill(cfg, params, jnp.asarray(prompts),
                                   extras, cache_len=S + STEPS)
    step = jax.jit(ref_build_model(cfg).decode_step)
    out = [np.asarray(logits)]
    toks = jnp.argmax(logits, -1)
    for t in range(S, S + STEPS):
        logits, cache = step(params, cache, toks, jnp.int32(t))
        out.append(np.asarray(logits))
        toks = jnp.argmax(logits, -1)
    return out


def _port_run(cfg, params, prompts, mesh=None, impl=None, plan=None,
              extras=None):
    """The port: prefill, then STEPS greedy decode steps."""
    prefill = serve.make_prefill_step(cfg, mesh, impl, plan,
                                      cache_len=S + STEPS, device="cpu")
    step = serve.make_serve_step(cfg, mesh, impl, plan, device="cpu")
    batch = dict(extras or {}, tokens=torch.from_numpy(prompts))
    logits, cache = prefill(params, batch)
    out = [logits]
    toks = logits.argmax(-1)
    for t in range(S, S + STEPS):
        logits, cache = step(params, cache, toks, t)
        out.append(logits)
        toks = logits.argmax(-1)
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.fixture(scope="module")
def stack():
    ref_cfg, cfg = _cfgs()
    ref_params = ref_init_lm(jax.random.PRNGKey(1), ref_cfg)
    params_np = jax.tree.map(np.asarray, ref_params)
    params = from_jax_params(params_np, cfg, device="cpu")
    prompts = _prompts(cfg)
    return dict(ref_cfg=ref_cfg, cfg=cfg, params=params, prompts=prompts,
                ref=_ref_run(ref_cfg, ref_params, prompts),
                local=_port_run(cfg, params, prompts))


def test_no_mesh_matches_reference(stack):
    for step, (got, ref) in enumerate(zip(stack["local"], stack["ref"])):
        assert _rel(got.numpy(), ref) < 1e-4, step
        assert np.array_equal(got.argmax(-1).numpy(), ref.argmax(-1)), step


@pytest.mark.parametrize("arch", [
    "qwen3-0.6b",       # dense, qk-norm, tied embeddings
    "granite-3-2b",     # dense, tied embeddings
    "internvl2-1b",     # dense blocks behind the vision stub
    "mixtral-8x7b",     # moe, sliding window of 16: a ring cache
    "dbrx-132b",        # moe, layernorm
])
def test_other_archs_match_reference(arch):
    """The "dense" and "moe" block kinds of other configs, no mesh."""
    over = dict(compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    ref_params = ref_init_lm(jax.random.PRNGKey(4), ref_cfg)
    params = from_jax_params(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab, (B, S))
    extras = None
    if cfg.frontend == "vision_stub":
        extras = {"patch_embeds": (rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)) * 0.1).astype(
                np.float32)}
    ref = _ref_run(ref_cfg, ref_params, prompts, extras)
    got = _port_run(cfg, params, prompts, extras=extras)
    for step, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g.numpy(), r) < 1e-4, (arch, step)
        assert np.array_equal(g.argmax(-1).numpy(), r.argmax(-1)), step


@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None)])
def test_chunked_attention_matches_reference(causal, window):
    """The online-softmax path taken above 2048 tokens, at small chunks."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 32, 4, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(q_offset=0, window=window, causal=causal, q_chunk=8,
              kv_chunk=8)
    ref = np.asarray(ref_layers.mha_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = layers.mha_chunked(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw).numpy()
    assert np.abs(got - ref).max() < 1e-5
    mask = layers._band_mask(32, 32, 0, window, causal, "cpu")
    full = layers.mha_einsum(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), mask).numpy()
    assert np.abs(got - full).max() < 1e-5


def test_stacked_layout_converts(stack):
    """scan_layers=True stacks the blocks; the conversion splits them and
    the prefill matches the reference's scanned prefill."""
    ref_cfg, cfg = _cfgs(scan_layers=True)
    ref_params = ref_init_lm(jax.random.PRNGKey(2), ref_cfg)
    assert isinstance(ref_params["blocks"], dict)
    params = from_jax_params(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    ref, _ = ref_lm_prefill(ref_cfg, ref_params,
                            jnp.asarray(stack["prompts"]))
    got, _ = serve.make_prefill_step(cfg, None, device="cpu")(
        params, {"tokens": torch.from_numpy(stack["prompts"])})
    assert _rel(got.numpy(), np.asarray(ref)) < 1e-4


def _plan():
    return serve.flash_plan(2, 2, seed=0)


@pytest.fixture(scope="module")
def mesh_runs(stack):
    """Plan and direct runs on a (2, 2, 1) mesh, recording every
    dispatch's keep flags (the local run's too)."""
    keeps = []
    real = moe._dispatch

    def spy(*args):
        out = real(*args)
        keeps.append(bool(out[2].all()))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(moe, "_dispatch", spy)
    try:
        cfg, params, prompts = stack["cfg"], stack["params"], stack["prompts"]
        _port_run(cfg, params, prompts)
        mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
        runs = {impl: _port_run(cfg, params, prompts, mesh, impl, plan)
                for impl, plan in (("plan", _plan()), ("direct", None))}
    finally:
        mp.undo()
    return runs, keeps


def test_mesh_plan_matches_no_mesh(stack, mesh_runs):
    runs, keeps = mesh_runs
    assert keeps and all(keeps), "a token was dropped"
    for step, (got, ref) in enumerate(zip(runs["plan"], stack["local"])):
        assert _rel(got.numpy(), ref.numpy()) < 1e-4, step
        assert torch.equal(got.argmax(-1), ref.argmax(-1)), step


def test_mesh_direct_bit_identical_to_plan(mesh_runs):
    runs, _ = mesh_runs
    for a, b in zip(runs["plan"], runs["direct"]):
        assert torch.equal(a, b)


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2, 2, 1), ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.make_serve_step(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_unported_impl_raises_at_the_entry_point():
    """A name the port's registry does not hold (``rotation`` is a
    schedule, not a registry impl) raises at the entry point and is never
    replaced by another; every registered impl and the config's own
    ``flash`` build; ``plan`` without a plan raises."""
    cfg = smoke_config(ARCH)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    for impl in (None, "flash", "hierarchical", "direct", "auto"):
        serve.make_prefill_step(cfg, mesh, impl)
    with pytest.raises(ValueError, match="unknown"):
        serve.make_prefill_step(cfg, mesh, "rotation")
    with pytest.raises(ValueError, match="plan"):
        serve.make_prefill_step(cfg, mesh, "plan")


MIX = "mixtral-8x7b"
MIX_MESH = (2, 3, 1)


@pytest.fixture(scope="module")
def mixtral_runs():
    """Smoke mixtral (f32) with no mesh and on (2, 3, 1) through flash,
    plan and direct, recording every dispatch's keep flags.  The batch of
    6 divides the 6 ranks, so the mesh runs take the split island."""
    cfg = dataclasses.replace(smoke_config(MIX), compute_dtype="float32")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(6))
    prompts = np.random.default_rng(8).integers(0, cfg.vocab, (6, S))
    mesh = make_mesh(MIX_MESH, ("pod", "data", "model"), device="cpu")
    keeps = []
    real = moe._dispatch

    def spy(*args):
        out = real(*args)
        keeps.append(bool(out[2].all()))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(moe, "_dispatch", spy)
    try:
        runs = {"local": _port_run(cfg, params, prompts)}
        for impl, plan in (("flash", None),
                           ("plan", serve.flash_plan(2, 3, seed=0)),
                           ("direct", None)):
            runs[impl] = _port_run(cfg, params, prompts, mesh, impl, plan)
    finally:
        mp.undo()
    return runs, keeps


@pytest.mark.parametrize("impl", ["flash", "plan"])
def test_mixtral_mesh_matches_no_mesh(mixtral_runs, impl):
    runs, keeps = mixtral_runs
    assert keeps and all(keeps), "a token was dropped"
    for step, (got, ref) in enumerate(zip(runs[impl], runs["local"])):
        assert _rel(got.numpy(), ref.numpy()) < 1e-4, step
        assert torch.equal(got.argmax(-1), ref.argmax(-1)), step


def test_mixtral_mesh_impls_bit_identical(mixtral_runs):
    runs, _ = mixtral_runs
    for other in ("plan", "direct"):
        for a, b in zip(runs["flash"], runs[other]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,mesh_shape", [
    (ARCH, None), (ARCH, (2, 2, 1)), (MIX, None), (MIX, MIX_MESH)])
def test_use_kernel_false_reaches_no_kernel(arch, mesh_shape, monkeypatch):
    """Spies on every kernel wrapper the serving path calls: with
    use_kernel=False none is called, with or without a mesh; with the
    kernels each of the path's wrappers is, and flash_attention once per
    layer in the prefill and never in decode."""
    calls = collections.Counter()
    for mod, name in ((layers, "flash_attention"), (moe, "grouped_matmul"),
                      (plan_exec, "a2a_pack"), (plan_exec, "a2a_unpack")):
        def counted(*a, _real=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    mesh = plan = None
    batch = 4
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, ("pod", "data", "model"), device="cpu")
        plan = serve.flash_plan(mesh_shape[0], mesh_shape[1], seed=0)
        batch = mesh_shape[0] * mesh_shape[1]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, 8)))
    for use_kernel in (False, True):
        calls.clear()
        prefill = serve.make_prefill_step(
            cfg, mesh, "plan" if mesh else None, plan, cache_len=10,
            use_kernel=use_kernel, device="cpu")
        step = serve.make_serve_step(cfg, mesh, "plan" if mesh else None,
                                     plan, use_kernel=use_kernel,
                                     device="cpu")
        logits, cache = prefill(params, {"tokens": tokens})
        n_attn = calls["flash_attention"]
        step(params, cache, logits.argmax(-1), 8)
        if not use_kernel:
            assert not calls, calls
            continue
        want = {"flash_attention", "grouped_matmul"}
        if mesh is not None:
            want |= {"a2a_pack", "a2a_unpack"}
        assert set(calls) == want, calls
        assert n_attn == calls["flash_attention"] == cfg.n_layers


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh",
                "2,2", "--a2a", "plan", "--batch", "4", "--prompt-len", "8",
                "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "n_plan_stages=" in out and "generated=3 tokens/req" in out
    assert "dispatch planning [inline" in out
