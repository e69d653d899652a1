"""The port's placement layer against the reference's
(``repro.launch.shardings``, ``repro.models.sharding``).

* ``param_specs``, ``cache_specs``, ``batch_specs`` and ``state_specs`` of
  the port's own state shapes (``serve_state_shapes``,
  ``make_train_state_shapes``, ``input_specs``: meta tensors) equal the
  reference's ``spec_tree`` leaf by leaf for all 11 archs at their
  published configs, on (2, 2, 2) and (2, 2, 1) meshes; the ``pure_dp``
  and ``fsdp`` branches on three archs; ``_drop_uneven`` through
  internvl2-1b's odd vocab and a batch of one.
* ``MeshRules.spec``'s right-most-wins deduplication and ``make_rules``.
* ``input_specs``' shapes and dtypes; ``module_specs`` maps a scanned
  stack's spec to each layer; ``gather_tensor(shard_tensor(x))`` is ``x``
  on a ``LocalMesh`` (the ``ProcessMesh`` form runs in
  ``test_torch_process_mesh.py``).

The reference runs once, in one subprocess on 8 fake devices.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve_state_shapes
from repro_torch.launch.train import make_rules, make_train_state_shapes
from repro_torch.models import build_model, input_specs

ARCHS = sorted(list_archs())
MESHES = {"2x2x2": (2, 2, 2), "2x2x1": (2, 2, 1)}
AXES = ("pod", "data", "model")
BATCH, SEQ = 8, 64
# the pure_dp and fsdp branches (no config sets them; the reference's tests
# force them the same way)
VARIANTS = {"pure_dp": dict(pure_dp=True), "fsdp": dict(fsdp=True),
            "pure_dp_fsdp": dict(pure_dp=True, fsdp=True)}
VARIANT_ARCHS = ("llama3.2-1b", "megatron-moe-32e", "hymba-1.5b")
NAMES = [("batch", "act_seq", "ff"), ("batch", "seq", "heads", "head_dim"),
         ("batch", "act_seq", "model_dim"), ("vocab", "model_dim"),
         ("experts", "model_dim", "expert_ff"), ("batch", None, "kv_feature"),
         ("layers", "heads", "ff")]
RULE_CASES = {"default": {}, "seq_shard": dict(seq_shard_activations=True),
              "pure_dp": dict(pure_dp=True),
              "pure_dp_fsdp": dict(pure_dp=True, fsdp=True)}

_JAX_SIDE = """
import dataclasses, json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.launch.serve import serve_state_shapes
from repro.launch.shardings import batch_shardings, spec_tree
from repro.launch.train import make_rules, make_train_state_shapes
from repro.models import input_specs

def key(p):
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)

def flat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {"/".join(key(p) for p in path): [
        list(e) if isinstance(e, tuple) else e for e in s]
        for path, s in leaves}

out = {}
for mname, shape in MESHES.items():
    mesh = make_mesh(shape, ("pod", "data", "model"))
    cases = [(a, a, {}) for a in ARCHS] + [
        (f"{a}+{v}", a, over) for v, over in VARIANTS.items()
        for a in VARIANT_ARCHS]
    for case, arch, over in cases:
        cfg = dataclasses.replace(get_config(arch), **over)
        _, psh, _, csh = serve_state_shapes(cfg, mesh, BATCH, SEQ)
        _, ssh = make_train_state_shapes(cfg, mesh)
        batch = input_specs(cfg, "train", SEQ, BATCH)
        batch["one"] = jax.ShapeDtypeStruct((1, SEQ), jnp.int32)
        batch["pos"] = jax.ShapeDtypeStruct((), jnp.int32)
        out[f"{mname}|{case}"] = {
            "params": flat(spec_tree(psh)), "cache": flat(spec_tree(csh)),
            "state": flat(spec_tree(ssh)),
            "batch": flat(spec_tree(batch_shardings(
                mesh, batch, pure_dp=cfg.pure_dp)))}
    for rname, over in RULE_CASES.items():
        rules = make_rules(dataclasses.replace(get_config("llama3.2-1b"),
                                               **over), mesh)
        out[f"{mname}|rules|{rname}"] = [
            [list(e) if isinstance(e, tuple) else e for e in rules.spec(*n)]
            for n in NAMES]
cfg = get_config("internvl2-1b")
out["inputs"] = {k: {kind: [list(v.shape), str(v.dtype)] for kind, v in
                     input_specs(cfg, k, SEQ, BATCH).items()}
                 for k in ("train", "prefill", "decode")}
with open(OUT, "w") as f:
    json.dump(out, f)
print("JAX_SIDE_OK")
"""


def _json_spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(specs):
    return {"/".join(str(p) for p in path): _json_spec(s)
            for path, s in S.flatten_with_path(specs).items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shardings") / "ref.json")
    code = (f"MESHES = {MESHES!r}\nARCHS = {ARCHS!r}\nVARIANTS = "
            f"{VARIANTS!r}\nVARIANT_ARCHS = {VARIANT_ARCHS!r}\nNAMES = "
            f"{NAMES!r}\nRULE_CASES = {RULE_CASES!r}\nBATCH, SEQ = {BATCH}, "
            f"{SEQ}\nOUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=8)
    with open(path) as f:
        return json.load(f)


def _port_specs(mname, arch, over):
    mesh = make_mesh(MESHES[mname], AXES, device="cpu")
    cfg = dataclasses.replace(get_config(arch), **over)
    _, psh, _, csh = serve_state_shapes(cfg, mesh, BATCH, SEQ)
    _, ssh = make_train_state_shapes(cfg, mesh)
    batch = input_specs(cfg, "train", SEQ, BATCH)
    batch["one"] = torch.empty((1, SEQ), dtype=torch.int32, device="meta")
    batch["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": _flat(S.spec_tree(psh)),
            "cache": _flat(S.spec_tree(csh)),
            "state": _flat(S.spec_tree(ssh)),
            "batch": _flat(S.batch_specs(mesh, batch,
                                         pure_dp=cfg.pure_dp))}


CASES = [(m, a, a, {}) for m in MESHES for a in ARCHS] + [
    (m, f"{a}+{v}", a, over) for m in MESHES for v, over in VARIANTS.items()
    for a in VARIANT_ARCHS]


@pytest.mark.parametrize("mname,case,arch,over", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_specs_equal_reference(ref, mname, case, arch, over):
    want = ref[f"{mname}|{case}"]
    got = _port_specs(mname, arch, over)
    for kind in ("params", "cache", "state", "batch"):
        assert set(got[kind]) == set(want[kind]), (kind, sorted(
            set(got[kind]) ^ set(want[kind]))[:6])
        bad = {k: (got[kind][k], want[kind][k]) for k in want[kind]
               if got[kind][k] != want[kind][k]}
        assert not bad, (kind, list(bad.items())[:6])


def test_branches_are_reached(ref):
    """The cases above take the ``_drop_uneven``, ``pure_dp`` and ``fsdp``
    branches: internvl2-1b's odd vocab replicates its embedding on the
    model axis, a batch of one replicates, pure_dp drops the model axis and
    fsdp shards over data."""
    odd = ref["2x2x2|internvl2-1b"]
    assert odd["params"]["embed"] == [None, None]
    assert ref["2x2x2|llama3.2-1b"]["params"]["embed"] == ["model", None]
    assert odd["batch"]["one"] == [None, None]
    pure = ref["2x2x2|llama3.2-1b+pure_dp"]["params"]
    assert all("model" not in json.dumps(v) for v in pure.values())
    fsdp = ref["2x2x2|llama3.2-1b+fsdp"]["params"]
    assert any("data" in json.dumps(v) for v in fsdp.values())


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("rname", sorted(RULE_CASES))
def test_mesh_rules_match_reference(ref, mname, rname):
    mesh = make_mesh(MESHES[mname], AXES, device="cpu")
    rules = make_rules(dataclasses.replace(get_config("llama3.2-1b"),
                                           **RULE_CASES[rname]), mesh)
    got = [_json_spec(rules.spec(*n)) for n in NAMES]
    assert got == ref[f"{mname}|rules|{rname}"]


def test_mesh_rules_right_most_wins():
    from repro_torch.models.sharding import (MeshRules, current_rules,
                                             logical_constraint,
                                             logical_spec, use_mesh_rules)

    rules = MeshRules(mesh=None, act_seq="model")
    assert rules.spec("batch", "act_seq", "ff") == \
        (("pod", "data"), None, "model")
    assert rules.spec("batch", "batch") == (None, ("pod", "data"))
    assert logical_spec("batch") is None
    with use_mesh_rules(rules):
        assert current_rules() is rules
        assert logical_spec("heads", "ff") == (None, "model")
    assert current_rules() is None
    x = torch.ones(2)
    assert logical_constraint(x, "batch") is x


def test_input_specs_match_reference(ref):
    cfg = get_config("internvl2-1b")
    for kind, want in ref["inputs"].items():
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in input_specs(cfg, kind, SEQ, BATCH).items()}
        assert got == want, kind
        assert all(v.device.type == "meta"
                   for v in input_specs(cfg, kind, SEQ, BATCH).values())


def test_module_specs_unstack_the_scanned_layers():
    """A scanned config's per-layer parameters take their stack's spec
    without the layer entry.  Under FSDP, where the reference's rule takes
    a stack's layer axis, each layer's own leaf takes the rule instead:
    its first free dim that "data" divides (the experts' stacks, whose EP
    axes hold "data" already, stay as they were)."""
    cfg = get_config("megatron-moe-32e")
    mesh = make_mesh((2, 2, 2), AXES, device="cpu")
    module = build_model(cfg, "meta").init(torch.Generator())
    specs = S.module_specs(cfg, mesh, module)
    assert specs["blocks.3.moe.w_gate"] == (("pod", "data"), None, "model")
    assert specs["blocks.0.attn.wo"] == ("model", None)
    assert specs["embed"] == ("model", None)
    assert set(specs) == {k for k, _ in module.named_parameters()}
    fsdp = S.module_specs(dataclasses.replace(cfg, fsdp=True), mesh, module)
    assert fsdp["blocks.3.moe.w_gate"] == (("pod", "data"), None, "model")
    assert fsdp["blocks.3.moe.router"] == ("data", None)
    assert fsdp["blocks.0.attn.wq"] == ("data", "model")
    assert fsdp["blocks.0.attn.wo"] == ("model", "data")
    assert fsdp["embed"] == ("model", "data")
    assert fsdp["blocks.0.norm1.scale"] == (None,)


@pytest.mark.parametrize("spec", [
    (("pod", "data"), None, "model"), ("data", None, None), (None, "pod"),
    ((), None), ("model", ("pod", "data"))])
def test_gather_inverts_shard_on_a_local_mesh(spec):
    mesh = make_mesh((2, 2, 2), AXES, device="cpu")
    x = torch.arange(8 * 4 * 2, dtype=torch.float32).reshape(8, 4, 2)
    spec = tuple(None if e == () else e for e in spec)
    spec = spec + (None,) * (x.dim() - len(spec))
    parts = torch.stack([S.shard_tensor(x, spec, mesh, c)
                         for c in mesh.coords()])
    assert torch.equal(S.gather_tensor(parts, spec, mesh), x)
    # numpy arrays cut the same way
    a = x.numpy()
    c = mesh.coords()[5]
    assert np.array_equal(S.shard_tensor(a, spec, mesh, c),
                          S.shard_tensor(x, spec, mesh, c).numpy())


def test_shard_tensor_needs_coords_on_a_local_mesh():
    mesh = make_mesh((2, 2, 1), AXES, device="cpu")
    with pytest.raises(ValueError, match="coords"):
        S.shard_tensor(torch.ones(4), ("data",), mesh)
    with pytest.raises(ValueError, match="split"):
        S.shard_tensor(torch.ones(3), ("data",), mesh, (0, 0, 0))
