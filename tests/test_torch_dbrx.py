"""DBRX on the port's paths, at smoke widths in f32 on the CPU.

DBRX clamps q, k and v to [-8, 8] as projected (``attn_config.clip_qkv``),
which ``models/published.py`` states for the registered name, each
``layers.Attention`` takes once when built and ``layers._project_qkv``
applies.  With planted attention weights whose
projections pass ±8, checked against plain math of the clamp:

* prefill: the keys and values handed to the cache are the clamped
  projections (the keys rotated after the clamp);
* decode: the cache slot written is the clamped projection, and the
  decoded position's output equals the prefill's over the whole sequence;
* under a gradient: a value projection clamped everywhere passes no
  gradient to ``wv``;
* tensor parallelism on 2 gloo processes of a (1, 1, 2) ``ProcessMesh``:
  each process's clamped kv head, and the peers' summed output the whole
  attention's;

each output differing from the same computation without the clamp.  The
intra-pod all-to-all (dbrx's 4 smoke experts over "data" alone on (2, 4, 1))
opens an ``a2a.intra`` span, and the stacked prefill's logits equal the
single-device path's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.procs import spawn
from repro_torch.models import build_model, layers, published

AXES = ("pod", "data", "model")
B, S = 2, 6
CLIP = 8.0


def _cfg():
    return dataclasses.replace(smoke_config("dbrx-132b"),
                               compute_dtype="float32")


def _planted():
    """An attention block whose projections are about N(0, 10^2): most
    entries pass ±8, some do not; and an input ``x [B, S, d]``."""
    cfg = _cfg()
    p = layers.Attention(cfg, torch.Generator().manual_seed(3),
                         torch.float32, "cpu")
    with torch.no_grad():
        for w in (p.wq, p.wk, p.wv):
            w.mul_(10.0)
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    return cfg, p, x


def _heads(t, n):
    return t.reshape(*t.shape[:-1], n, -1)


@pytest.fixture
def no_clip():
    """Run the attention block ``p`` without DBRX's clamp."""
    def off(p):
        p.clip_qkv = None
    return off


def test_published_clip_by_name():
    assert published.clip_qkv("dbrx-132b") == CLIP
    assert published.clip_qkv("dbrx-132b-smoke") == CLIP
    assert published.clip_qkv("mixtral-8x7b") is None
    assert published.clip_qkv(_cfg().name) == CLIP


@pytest.mark.parametrize("arch,clip", [("dbrx-132b", CLIP),
                                       ("mixtral-8x7b", None)])
def test_attention_takes_its_clip_when_built(arch, clip):
    """Every block's attention holds its model's clip from the build on: a
    config renamed afterwards leaves it as built."""
    cfg = smoke_config(arch)
    lm = build_model(cfg, "meta").init(torch.Generator())
    assert [b.attn.clip_qkv for b in lm.blocks] == [clip] * cfg.n_layers
    cfg, p, x = _planted()
    renamed = dataclasses.replace(cfg, name="renamed")
    pos = torch.arange(S)[None].expand(B, S)
    _, (_, v) = layers.attention_apply(renamed, p, x, positions=pos,
                                       return_kv=True, use_kernel=False)
    assert float(v.abs().max()) == CLIP


def test_prefill_keys_and_values_are_clamped(no_clip):
    cfg, p, x = _planted()
    pos = torch.arange(S)[None].expand(B, S)
    out, (k, v) = layers.attention_apply(cfg, p, x, positions=pos,
                                         return_kv=True, use_kernel=False)
    raw_v = _heads(x @ p.wv, cfg.n_kv_heads)
    raw_k = _heads(x @ p.wk, cfg.n_kv_heads)
    assert raw_v.abs().max() > 2 * CLIP and (raw_v.abs() < CLIP).any()
    torch.testing.assert_close(v, raw_v.clamp(-CLIP, CLIP), rtol=0, atol=0)
    torch.testing.assert_close(
        k, layers.apply_rope(raw_k.clamp(-CLIP, CLIP), pos, cfg.rope_theta),
        rtol=1e-6, atol=1e-6)
    no_clip(p)
    plain, (_, v2) = layers.attention_apply(cfg, p, x, positions=pos,
                                            return_kv=True, use_kernel=False)
    torch.testing.assert_close(v2, raw_v, rtol=0, atol=0)
    assert (plain - out).abs().max() > 1e-2 * plain.abs().max()


def test_decode_writes_clamped_kv_and_matches_prefill(no_clip):
    cfg, p, x = _planted()
    pos = torch.arange(S)[None].expand(B, S)
    outs = []
    for clip in (True, False):
        if not clip:
            no_clip(p)
        whole = layers.attention_apply(cfg, p, x, positions=pos,
                                       use_kernel=False)
        _, (k, v) = layers.attention_apply(
            cfg, p, x[:, :-1], positions=pos[:, :-1], return_kv=True,
            use_kernel=False)
        ck, cv = layers.assemble_kv_cache(k, v, None, S)
        out, ck, cv = layers.attention_decode(cfg, p, x[:, -1:], ck, cv,
                                              S - 1)
        # f32 sums in another order: within 1e-5 of the largest entry
        torch.testing.assert_close(out[:, 0], whole[:, -1], rtol=1e-5,
                                   atol=1e-5 * float(whole.abs().max()))
        raw_v = _heads(x[:, -1:] @ p.wv, cfg.n_kv_heads)[:, 0]
        # a product of another shape than the decode's rounds otherwise
        torch.testing.assert_close(
            cv[:, S - 1], raw_v.clamp(-CLIP, CLIP) if clip else raw_v,
            rtol=1e-6, atol=1e-6 * float(raw_v.abs().max()))
        assert (cv[:, S - 1].abs().max() == CLIP) == clip
        outs.append(out)
    assert (outs[0] - outs[1]).abs().max() > 1e-2 * outs[1].abs().max()


def test_no_gradient_past_the_clip(no_clip):
    """Every value projection beyond +8: ``wv`` gets no gradient, ``wo``
    does; without the clamp ``wv`` does too."""
    cfg, p, _ = _planted()
    x = torch.rand((B, S, cfg.d_model),
                   generator=torch.Generator().manual_seed(5)) + 0.5
    pos = torch.arange(S)[None].expand(B, S)
    with torch.no_grad():
        p.wv.copy_(p.wv.abs() * 10.0)
    assert (x @ p.wv).min() > CLIP
    grads = []
    for clip in (True, False):
        if not clip:
            no_clip(p)
        p.wv.requires_grad_(True)
        p.wo.requires_grad_(True)
        out = layers.attention_apply(cfg, p, x, positions=pos,
                                     use_kernel=False)
        grads.append(torch.autograd.grad(out.square().sum(), (p.wv, p.wo)))
    (gv, go), (gv_plain, _) = grads
    assert torch.count_nonzero(gv) == 0
    assert torch.count_nonzero(go) > 0 and torch.count_nonzero(gv_plain) > 0


def _peer(mesh, weights, x):
    """This process's attention over its column slices of ``wq``, ``wk``,
    ``wv`` and rows of ``wo``: (the summed output, its kv heads' values)."""
    n, r = mesh.axis_size("model"), mesh.rank_coords[2]
    cfg = _cfg()
    p = layers.Attention(cfg, torch.Generator(), torch.float32, "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv"):
            w = torch.from_numpy(weights[name])
            c = w.shape[1] // n
            setattr(p, name, torch.nn.Parameter(w[:, r * c:(r + 1) * c],
                                                requires_grad=False))
        wo = torch.from_numpy(weights["wo"])
        c = wo.shape[0] // n
        p.wo = torch.nn.Parameter(wo[r * c:(r + 1) * c], requires_grad=False)
    x = torch.from_numpy(x)
    pos = torch.arange(S)[None].expand(B, S)
    out, (_, v) = layers.attention_apply(cfg, p, x, positions=pos,
                                         return_kv=True, use_kernel=False,
                                         tp=mesh)
    return out.numpy(), v.numpy()


def test_tensor_parallel_slices_clamp(tmp_path):
    cfg, p, x = _planted()
    weights = {k: getattr(p, k).detach().numpy() for k in
               ("wq", "wk", "wv", "wo")}
    peers = spawn(_peer, (1, 1, 2), AXES, "gloo", "cpu", weights, x.numpy(),
                  init_method=f"file://{tmp_path / 'store'}", timeout=60.0,
                  join_timeout=120)
    pos = torch.arange(S)[None].expand(B, S)
    whole = layers.attention_apply(cfg, p, x, positions=pos,
                                   use_kernel=False)
    raw_v = _heads(x @ p.wv, cfg.n_kv_heads).clamp(-CLIP, CLIP)
    for r, (out, v) in enumerate(peers):
        np.testing.assert_allclose(out, whole.numpy(), rtol=1e-5, atol=1e-5)
        # 2 kv heads over 2 peers: one each
        np.testing.assert_array_equal(v, raw_v[:, :, r:r + 1].numpy())
        assert np.abs(v).max() == CLIP


def test_intra_pod_exchange_opens_its_span_and_matches_one_device(tmp_path):
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, a2a_impl="direct", moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts
                                       // cfg.moe.top_k)))
    mesh = make_mesh((2, 4, 1), AXES, device="cpu")
    assert serve.make_dist_context(cfg, mesh).ep_axes == ("data",)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (8, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.profiler.profile() as prof:
        stacked, _ = serve.make_prefill_step(cfg, mesh, "direct",
                                             device="cpu")(
            params, {"tokens": tokens})
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e["name"] == "a2a.intra"]
    # two exchanges a layer
    assert len(spans) == 2 * cfg.n_layers
    one, _ = serve.make_prefill_step(cfg, None, device="cpu")(
        params, {"tokens": tokens})
    torch.testing.assert_close(stacked, one, rtol=1e-5, atol=1e-5)
