"""The encoder-decoder stack (``models/encdec.py``) against the reference's,
whisper-tiny at smoke size in f32, on the reference's ``init_encdec``
parameters (converted) and the same numpy frames and tokens.

* ``encdec_forward``'s logits within a relative 1e-4;
* ``encdec_loss`` within a relative 1e-5 and every gradient within a
  relative norm of 1e-4 (``jax.value_and_grad``);
* ``encdec_init_cache`` without frames (zeros of the reference's shapes)
  and with them (the projected encoder stream within 1e-5);
* a teacher-forced decode chain over the prompt and 3 greedy steps against
  the reference's ``encdec_decode_step`` (within 1e-4, identical tokens),
  and the chain against the port's own forward at every position;
* decoder positions saturate at the table's last row (a step at 9000);
* the reference's quirks: ``Model.prefill`` is the forward and returns no
  cache (so it refuses a ``cache_len``), ``Model.init_cache`` holds zero
  cross K/V; frames must have ``encoder_len`` rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import encdec as ref_encdec
from repro_torch.configs import smoke_config
from repro_torch.convert import _flatten, from_jax_params
from repro_torch.models import build_model, encdec

ARCH = "whisper-tiny"
B, S, STEPS = 2, 12, 3


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def setup():
    over = dict(compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(ARCH), **over)
    cfg = dataclasses.replace(smoke_config(ARCH), **over)
    ref_params = jax.jit(lambda k: ref_encdec.init_encdec(k, ref_cfg))(
        jax.random.PRNGKey(2))
    params_np = jax.tree.map(np.asarray, ref_params)
    rng = np.random.default_rng(4)
    frames = (rng.standard_normal((B, cfg.encoder_len, cfg.d_model))
              * 0.5).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    labels = rng.integers(0, cfg.vocab, (B, S))
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
                params_np=params_np,
                params=from_jax_params(params_np, cfg, device="cpu"),
                frames=frames, tokens=tokens, labels=labels)


def test_converted_parameters_are_f32(setup):
    params = setup["params"]
    assert isinstance(params, encdec.EncDec)
    assert all(p.dtype == torch.float32 for p in params.parameters())
    assert params.dec_pos.shape[0] == encdec._MAX_DECODE_POS


def test_forward_matches_reference(setup):
    ref, _ = jax.jit(lambda p, t, f: ref_encdec.encdec_forward(
        setup["ref_cfg"], p, t, {"frames": f}))(
            setup["ref_params"], jnp.asarray(setup["tokens"]),
            jnp.asarray(setup["frames"]))
    with torch.no_grad():
        got, aux = encdec.encdec_forward(
            setup["cfg"], setup["params"], torch.from_numpy(setup["tokens"]),
            {"frames": setup["frames"]})
    assert got.shape == (B, S, setup["cfg"].vocab)
    assert float(aux) == 0.0
    assert _rel(got, ref) < 1e-4


def test_loss_and_gradients_match_reference(setup):
    batch = {"tokens": setup["tokens"], "labels": setup["labels"],
             "frames": setup["frames"]}
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_m), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_encdec.encdec_loss(setup["ref_cfg"], p, ref_batch),
        has_aux=True))(setup["ref_params"])
    params = from_jax_params(setup["params_np"], setup["cfg"], device="cpu",
                             train=True)
    model = build_model(setup["cfg"], "cpu", train=True)
    named = dict(params.named_parameters())
    loss, metrics = model.loss(params, {
        "tokens": torch.from_numpy(batch["tokens"]),
        "labels": torch.from_numpy(batch["labels"]),
        "frames": torch.from_numpy(batch["frames"])})
    grads = torch.autograd.grad(loss, list(named.values()))
    # no 0.01 * aux in the loss, as the reference's
    assert metrics["loss"].item() == metrics["nll"].item()
    assert _rel(loss.item(), float(ref_loss)) < 1e-5
    assert _rel(metrics["ppl_proxy"].item(), float(ref_m["ppl_proxy"])) < 1e-4
    ref_flat = {}
    _flatten(ref_grads, "", ref_flat)
    assert set(named) == set(ref_flat)
    errs = {k: _rel_norm(g.numpy(), ref_flat[k])
            for k, g in zip(named, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("with_frames", [False, True])
def test_init_cache_matches_reference(setup, with_frames):
    cfg, ref_cfg = setup["cfg"], setup["ref_cfg"]
    extra = ({"frames": setup["frames"], "params": setup["ref_params"]}
             if with_frames else {})
    ref = ref_encdec.encdec_init_cache(ref_cfg, B, S + STEPS, **extra)
    with torch.no_grad():
        got = encdec.encdec_init_cache(
            cfg, B, S + STEPS,
            setup["frames"] if with_frames else None,
            setup["params"] if with_frames else None, device="cpu")
    assert len(got) == len(ref) == cfg.n_layers
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"k", "v", "xk", "xv"}
        for key in r:
            assert tuple(g[key].shape) == r[key].shape, key
        assert not g["k"].any() and not g["v"].any()
        if with_frames:
            assert _rel(g["xk"], r["xk"]) < 1e-5
            assert _rel(g["xv"], r["xv"]) < 1e-5
        else:
            assert not g["xk"].any() and not g["xv"].any()


def test_decode_chain_matches_reference_and_forward(setup):
    cfg, ref_cfg = setup["cfg"], setup["ref_cfg"]
    tokens, frames = setup["tokens"], setup["frames"]
    ref_step = jax.jit(lambda p, c, t, pos: ref_encdec.encdec_decode_step(
        ref_cfg, p, c, t, pos))
    ref_cache = ref_encdec.encdec_init_cache(ref_cfg, B, S + STEPS, frames,
                                             setup["ref_params"])
    model = build_model(cfg, "cpu")
    with torch.no_grad():
        full, _ = model.prefill(setup["params"], {
            "tokens": torch.from_numpy(tokens), "frames": frames})
        cache = encdec.encdec_init_cache(cfg, B, S + STEPS, frames,
                                         setup["params"], device="cpu")
        ref_tok = got_tok = None
        for t in range(S + STEPS):
            if t < S:    # teacher-forced over the prompt
                ref_in = jnp.asarray(tokens[:, t])
                got_in = torch.from_numpy(tokens[:, t])
            else:        # greedy
                ref_in, got_in = ref_tok, got_tok
            ref_logits, ref_cache = ref_step(setup["ref_params"], ref_cache,
                                             ref_in, jnp.int32(t))
            logits, cache = model.decode_step(setup["params"], cache,
                                              got_in, t)
            assert _rel(logits, ref_logits) < 1e-4, t
            if t < S:
                assert _rel(logits, full[:, t].numpy()) < 1e-4, t
            ref_tok = jnp.argmax(ref_logits, -1)
            got_tok = logits.argmax(-1)
            assert np.array_equal(got_tok.numpy(), np.asarray(ref_tok)), t


def test_decode_position_saturates(setup):
    """A step at position 9000 reads the table's last row (8191)."""
    cfg, ref_cfg = setup["cfg"], setup["ref_cfg"]
    pos, n = 9000, 9001
    toks = setup["tokens"][:1, 0]
    ref_cache = ref_encdec.encdec_init_cache(ref_cfg, 1, n,
                                             setup["frames"][:1],
                                             setup["ref_params"])
    ref, _ = jax.jit(lambda p, c, t: ref_encdec.encdec_decode_step(
        ref_cfg, p, c, t, jnp.int32(pos)))(setup["ref_params"], ref_cache,
                                           jnp.asarray(toks))
    with torch.no_grad():
        cache = encdec.encdec_init_cache(cfg, 1, n, setup["frames"][:1],
                                         setup["params"], device="cpu")
        got, _ = encdec.encdec_decode_step(cfg, setup["params"], cache,
                                           torch.from_numpy(toks), pos)
    assert _rel(got, ref) < 1e-4


def test_reference_quirks_are_kept(setup):
    cfg = setup["cfg"]
    model = build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(setup["tokens"]),
             "frames": setup["frames"]}
    with pytest.raises(ValueError, match="no cache"):
        model.prefill(setup["params"], batch, cache_len=S + STEPS)
    cache = model.init_cache(B, S)
    assert all(not c["xk"].any() and not c["xv"].any() for c in cache)
    assert cache[0]["xk"].shape == (B, cfg.encoder_len, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)
    short = {"tokens": batch["tokens"], "frames": setup["frames"][:, :-1]}
    with pytest.raises(ValueError, match="frames must be"):
        model.prefill(setup["params"], short)
