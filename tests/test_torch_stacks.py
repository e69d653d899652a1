"""The recurrent and hybrid stacks end to end at smoke size, f32:
xlstm-125m (mLSTM and sLSTM blocks) and hymba-1.5b (attention beside a
Mamba head), hymba both listed and stacked (``scan_layers=True``, which
drops the windows from its prefill and sizes every cache to the full
length, as the reference's scanned stack does).

* Prefill and 4 greedy decode steps against the reference's ``lm_prefill``
  and ``decode_step`` on the same parameters (``from_jax_params``) and
  prompts: logits within a relative 1e-4, identical tokens.  The listed
  hymba's prompt outruns its window of 16, so its windowed layer decodes
  on a ring cache.
* The port's teacher-forced decode chain against its own forward
  (``lm_forward``), every position within a relative 1e-4.
* One step's loss and every gradient against ``jax.value_and_grad`` of the
  reference's ``Model.loss`` (remat on, as the configs have it), the loss
  within a relative 1e-5 and every gradient within a relative norm of 1e-4.
* Every registered arch builds, serves (prefill and two decode steps) and
  takes an AdamW step through ``make_train_step`` at smoke size on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.models.transformer import init_lm as ref_init_lm
from repro.models.transformer import lm_prefill as ref_lm_prefill
from repro_torch.configs import list_archs, smoke_config
from repro_torch.convert import _flatten, from_jax_params
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models.transformer import lm_forward

B, S, STEPS, TRAIN_SEQ = 2, 20, 4, 24
CASES = {
    "xlstm": ("xlstm-125m", {}),
    "hymba": ("hymba-1.5b", {}),
    "hymba-stacked": ("hymba-1.5b", {"scan_layers": True}),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _unstack(tree, n_layers):
    """A stacked reference pytree with its blocks split into a list."""
    tree = dict(tree)
    if isinstance(tree["blocks"], dict):
        tree["blocks"] = [jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
                          for i in range(n_layers)]
    return tree


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch, over = CASES[request.param]
    over = dict(compute_dtype="float32", **over)
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    ref_params = jax.jit(lambda key: ref_init_lm(key, ref_cfg))(
        jax.random.PRNGKey(1))
    params = from_jax_params(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    return dict(name=request.param, ref_cfg=ref_cfg, cfg=cfg,
                ref_params=ref_params, params=params, prompts=prompts)


def test_serving_matches_reference(case):
    ref_cfg, cfg = case["ref_cfg"], case["cfg"]
    prompts = case["prompts"]
    logits, cache = jax.jit(lambda p, x: ref_lm_prefill(
        ref_cfg, p, x, cache_len=S + STEPS))(case["ref_params"],
                                             jnp.asarray(prompts))
    ref_step = jax.jit(ref_build_model(ref_cfg).decode_step)
    ref = [np.asarray(logits)]
    toks = jnp.argmax(logits, -1)
    for t in range(S, S + STEPS):
        logits, cache = ref_step(case["ref_params"], cache, toks,
                                 jnp.int32(t))
        ref.append(np.asarray(logits))
        toks = jnp.argmax(logits, -1)

    prefill = serve.make_prefill_step(cfg, None, cache_len=S + STEPS,
                                      device="cpu")
    step = serve.make_serve_step(cfg, None, device="cpu")
    logits, cache = prefill(case["params"],
                            {"tokens": torch.from_numpy(prompts)})
    got = [logits]
    toks = logits.argmax(-1)
    for t in range(S, S + STEPS):
        logits, cache = step(case["params"], cache, toks, t)
        got.append(logits)
        toks = logits.argmax(-1)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g.numpy(), r) < 1e-4, (case["name"], i)
        assert np.array_equal(g.argmax(-1).numpy(), r.argmax(-1)), i
    if case["name"] == "hymba":   # the windowed layer's ring cache
        assert cache[1]["k"].shape[1] == cfg.swa_window < S + STEPS
        assert cache[0]["k"].shape[1] == S + STEPS


def test_decode_chain_matches_forward(case):
    """Teacher-forced decode from an empty cache against the forward.  The
    stacked hymba's decode drops its windows once the cache outgrows them,
    as the reference's does, so its chain stops at the window."""
    cfg, params = case["cfg"], case["params"]
    n = S if case["name"] != "hymba-stacked" else cfg.swa_window
    tokens = torch.from_numpy(case["prompts"][:, :n])
    model = build_model(cfg, "cpu")
    with torch.no_grad():
        full, _ = lm_forward(cfg, params, tokens)
        cache = model.init_cache(B, n)
        for t in range(n):
            logits, cache = model.decode_step(params, cache, tokens[:, t], t)
            assert _rel(logits.numpy(), full[:, t].numpy()) < 1e-4, t


def test_train_loss_and_gradients_match_reference(case):
    ref_cfg, cfg = case["ref_cfg"], case["cfg"]
    assert cfg.remat
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=B, seed=0), cfg)
    batch = data.batch(0)
    ref_model = ref_build_model(ref_cfg)
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, ref_batch), has_aux=True))(
            case["ref_params"])
    ref_flat = {}
    _flatten(_unstack(ref_grads, cfg.n_layers), "", ref_flat)

    params = from_jax_params(
        jax.tree.map(np.asarray, case["ref_params"]), cfg, device="cpu",
        train=True)
    model = build_model(cfg, "cpu", train=True)
    named = dict(params.named_parameters())
    loss, _ = model.loss(params, {k: torch.as_tensor(v).long()
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    assert _rel(loss.item(), float(ref_loss)) < 1e-5
    assert set(named) == set(ref_flat)
    errs = {k: _rel_norm(g.numpy(), ref_flat[k])
            for k, g in zip(named, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_serves_and_trains(arch):
    cfg = smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 8)))
    batch = {"tokens": tokens}
    frames = None
    if cfg.frontend == "audio_stub":
        frames = torch.from_numpy((rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)) * 0.02).astype(np.float32))
        batch["frames"] = frames
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.zeros((B, cfg.frontend_len,
                                             cfg.d_model))
    with torch.no_grad():
        if cfg.encdec:
            from repro_torch.models.encdec import encdec_init_cache

            logits, _ = model.prefill(params, batch)
            assert logits.shape == (B, 8, cfg.vocab)
            cache = encdec_init_cache(cfg, B, 10, frames, params,
                                      device="cpu")
            logits = logits[:, -1]
            start = 0
        else:
            logits, cache = model.prefill(params, batch, cache_len=10)
            start = 8
        for t in range(start, start + 2):
            logits, cache = model.decode_step(params, cache,
                                              logits.argmax(-1), t)
    assert logits.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits).all())

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=B, seed=0), cfg)
    step = train.make_train_step(cfg, None, device="cpu")
    state = train.init_train_state(
        build_model(cfg, "cpu", train=True).init(
            torch.Generator().manual_seed(0)))
    state, metrics = step(state, data.batch(0))
    assert int(state["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
