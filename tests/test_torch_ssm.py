"""The recurrent blocks (``models/ssm.py``) against the reference's, f32.

mLSTM and sLSTM at ``smoke_config("xlstm-125m")``'s widths and Mamba at
``smoke_config("hymba-1.5b")``'s, with the reference's ``init_*``
parameters (converted) and the same numpy inputs:

* ``*_apply`` over a prompt: the output and the state after the last step;
* ``*_decode`` from the zero state, step by step over the same prompt: the
  state after each step and each step's output, and the chain against the
  port's own ``*_apply``;
* ``softplus`` is ``jax.nn.softplus`` above torch's threshold of 20 too,
  and Mamba with ``dt``'s pre-activations above 20;
* the causal depthwise conv, and the refusal of a prompt too short to leave
  Mamba a conv window.

Tolerance: a relative 1e-5 (the largest difference over the largest
reference value of the tensor).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import ssm as ref_ssm
from repro_torch.configs import smoke_config
from repro_torch.convert import load_params
from repro_torch.models import ssm

B, T = 2, 9
TOL = 1e-5

# kind -> (arch, module, reference init, apply/decode/zero-state names)
KINDS = {
    "mlstm": ("xlstm-125m", ssm.MLSTM, ref_ssm.init_mlstm),
    "slstm": ("xlstm-125m", ssm.SLSTM, ref_ssm.init_slstm),
    "mamba": ("hymba-1.5b", ssm.Mamba, ref_ssm.init_mamba),
}


def _rel(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _setup(kind, seed=0, **param_over):
    arch, module, ref_init = KINDS[kind]
    over = dict(compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    params_np = jax.tree.map(np.asarray,
                             ref_init(jax.random.PRNGKey(seed), ref_cfg))
    params_np.update(param_over)
    gen = torch.Generator().manual_seed(0)
    p = load_params(module(cfg, gen, torch.float32, "cpu"), params_np)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    ref_p = jax.tree.map(jnp.asarray, params_np)
    return ref_cfg, cfg, ref_p, p, x


def _fns(kind, pkg):
    return (getattr(pkg, f"{kind}_apply"), getattr(pkg, f"{kind}_decode"),
            getattr(pkg, f"{kind}_zero_state"))


def _check_state(got, ref, what):
    assert set(got) == set(ref), what
    for key in ref:
        assert got[key].dtype == torch.float32, (what, key)
        err = _rel(got[key], ref[key])
        assert err < TOL, (what, key, err)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_apply_matches_reference(kind):
    ref_cfg, cfg, ref_p, p, x = _setup(kind)
    ref_apply, _, _ = _fns(kind, ref_ssm)
    apply, _, _ = _fns(kind, ssm)
    ref_out, ref_state = jax.jit(lambda q, y: ref_apply(
        ref_cfg, q, y, return_state=True))(ref_p, jnp.asarray(x))
    with torch.no_grad():
        out, state = apply(cfg, p, torch.from_numpy(x), return_state=True)
    assert out.shape == (B, T, cfg.d_model)
    assert _rel(out, ref_out) < TOL
    _check_state(state, ref_state, "apply")
    with torch.no_grad():
        assert torch.equal(apply(cfg, p, torch.from_numpy(x)), out)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_steps_match_reference(kind):
    """The state after each step and each step's output, from the zero
    state; the port's chain also against its own prompt pass."""
    ref_cfg, cfg, ref_p, p, x = _setup(kind)
    _, ref_decode, ref_zero = _fns(kind, ref_ssm)
    apply, decode, zero = _fns(kind, ssm)
    ref_step = jax.jit(lambda q, y, st: ref_decode(ref_cfg, q, y, st))
    ref_state = ref_zero(ref_cfg, B)
    state = zero(cfg, B, "cpu")
    _check_state(state, ref_state, "zero")
    outs = []
    with torch.no_grad():
        for t in range(T):
            ref_y, ref_state = ref_step(ref_p, jnp.asarray(x[:, t:t + 1]),
                                        ref_state)
            y, state = decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), state)
            assert y.shape == (B, 1, cfg.d_model)
            assert _rel(y, ref_y) < TOL, t
            _check_state(state, ref_state, f"step {t}")
            outs.append(y)
        full, full_state = apply(cfg, p, torch.from_numpy(x),
                                 return_state=True)
    assert _rel(torch.cat(outs, dim=1), full.numpy()) < TOL
    for key in full_state:
        assert _rel(state[key], full_state[key].numpy()) < TOL, key


def test_softplus_matches_jax_above_torchs_threshold():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 20.0, 20.5, 25.0,
                  40.0, 90.0], np.float32)
    got = ssm.softplus(torch.from_numpy(x))
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    # in f64 torch's own softplus returns x itself above 20, where
    # logaddexp(x, 0) keeps log1p(exp(-x)): the reason for logaddexp
    x64 = x.astype(np.float64)
    got64 = ssm.softplus(torch.from_numpy(x64)).numpy()
    np.testing.assert_allclose(got64, np.logaddexp(x64, 0.0), rtol=1e-15,
                               atol=0)
    torch64 = torch.nn.functional.softplus(torch.from_numpy(x64)).numpy()
    near = (x64 > 20) & (x64 < 30)   # where exp(-x) is not lost in x
    assert near.sum() == 2 and (torch64[near] < got64[near]).all()


def test_mamba_with_large_dt_pre_activations():
    """dt_bias of 25 puts every dt pre-activation above 20."""
    d_in = smoke_config("hymba-1.5b").d_model
    ref_cfg, cfg, ref_p, p, x = _setup(
        "mamba", seed=3, dt_bias=np.full((d_in,), 25.0, np.float32))
    ref_out, ref_state = ref_ssm.mamba_apply(ref_cfg, ref_p, jnp.asarray(x),
                                             return_state=True)
    with torch.no_grad():
        out, state = ssm.mamba_apply(cfg, p, torch.from_numpy(x),
                                     return_state=True)
        dt, _, _ = ssm._mamba_scan_inputs(p, torch.from_numpy(x))
    assert float(dt.min()) > 20.0
    assert _rel(out, ref_out) < TOL
    _check_state(state, ref_state, "apply")


def test_causal_depthwise_conv_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    got = ssm._causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w))
    ref = ref_ssm._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w))
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("t", [1, 2])
def test_mamba_refuses_a_prompt_without_a_conv_window(t):
    _, cfg, _, p, x = _setup("mamba")
    with pytest.raises(ValueError, match="at least 3 tokens"):
        ssm.mamba_apply(cfg, p, torch.from_numpy(x[:, :t]),
                        return_state=True)
    # without a state to leave, any length runs
    assert ssm.mamba_apply(cfg, p, torch.from_numpy(x[:, :t])).shape == (
        B, t, cfg.d_model)
