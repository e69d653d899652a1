"""The placement layer on the meshes where the MoE archs leave the island:
(2, 3, 1), (3, 2, 1) and (1, 3, 1).

There ``choose_ep_axes`` puts the experts of mixtral-8x7b, dbrx-132b and
megatron-moe-32e over ``pod`` alone, over ``data`` alone and over no axis:
8, 16 and 32 experts divide neither 6 nor 3 on (2, 3, 1) but divide 2;
neither 6 nor 3 on (3, 2, 1) but 2; neither 3 nor 1 on (1, 3, 1).

* ``param_specs``, ``cache_specs``, ``batch_specs`` and ``state_specs`` of
  the three archs at their published configs equal the reference's
  ``spec_tree`` leaf by leaf on each mesh (``test_torch_shardings.py``'s
  program, run once in one subprocess on 6 fake devices).
* ``shard_params`` (the reference's parameters cut for one process) and
  ``shard_module`` (a port module's cut) give the same tensors for one
  rank of each mesh, at each arch's smoke config (4 experts, the same
  layouts): the rank's ``E_loc`` experts (all of them with no EP) and the
  replicated rest.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from conftest import run_subprocess
from test_torch_shardings import _JAX_SIDE, NAMES, _flat

from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import from_jax_params, shard_module, shard_params
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import ProcessMesh, make_mesh
from repro_torch.launch.serve import serve_state_shapes
from repro_torch.launch.train import make_train_state_shapes
from repro_torch.models import choose_ep_axes, input_specs

ARCHS = ("dbrx-132b", "megatron-moe-32e", "mixtral-8x7b")
MESHES = {"2x3x1": (2, 3, 1), "3x2x1": (3, 2, 1), "1x3x1": (1, 3, 1)}
EP = {"2x3x1": ("pod",), "3x2x1": ("data",), "1x3x1": None}
AXES = ("pod", "data", "model")
BATCH, SEQ = 12, 64
# the rank cut on each mesh: one whose coordinates are all nonzero where
# the axis has more than one
RANKS = {"2x3x1": 5, "3x2x1": 3, "1x3x1": 2}

_PARAMS_SIDE = """
from repro.configs import smoke_config
from repro.models.transformer import init_lm
smoke = {}
for arch in ARCHS:
    params = init_lm(jax.random.PRNGKey(1), smoke_config(arch))
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        smoke[arch + "|" + "/".join(key(p) for p in path)] = np.asarray(v)
np.savez(OUT_PARAMS, **smoke)
print("PARAMS_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's specs on the three meshes and its smoke parameters,
    in one subprocess on 6 fake devices."""
    d = tmp_path_factory.mktemp("shardings_pod_ep")
    path, params = str(d / "ref.json"), str(d / "params.npz")
    code = (f"import numpy as np\nMESHES = {MESHES!r}\nARCHS = "
            f"{list(ARCHS)!r}\nVARIANTS = {{}}\nVARIANT_ARCHS = ()\nNAMES = "
            f"{NAMES!r}\nRULE_CASES = {{}}\nBATCH, SEQ = {BATCH}, {SEQ}\n"
            f"OUT = {path!r}\nOUT_PARAMS = {params!r}\n" + _JAX_SIDE
            + _PARAMS_SIDE)
    out = run_subprocess(code, n_devices=6)
    assert "JAX_SIDE_OK" in out and "PARAMS_SIDE_OK" in out
    with open(path) as f:
        specs = json.load(f)
    return specs, dict(np.load(params))


def _port_specs(shape, arch):
    mesh = make_mesh(shape, AXES, device="cpu")
    cfg = get_config(arch)
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


CASES = [(m, a) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("mname,arch", CASES,
                         ids=[f"{m}-{a}" for m, a in CASES])
def test_specs_equal_reference(ref, mname, arch):
    mesh = make_mesh(MESHES[mname], AXES, device="cpu")
    assert choose_ep_axes(get_config(arch), mesh) == EP[mname]
    want = ref[0][f"{mname}|{arch}"]
    got = _port_specs(MESHES[mname], arch)
    for kind in ("params", "cache", "state", "batch"):
        assert set(got[kind]) == set(want[kind]), (kind, sorted(
            set(got[kind]) ^ set(want[kind]))[:6])
        bad = {k: (got[kind][k], want[kind][k]) for k in want[kind]
               if got[kind][k] != want[kind][k]}
        assert not bad, (kind, list(bad.items())[:6])
    experts = [v for k, v in want["params"].items()
               if k.endswith("moe/w_gate")]
    assert experts and all(v[1] == (EP[mname][0] if EP[mname] else None)
                           for v in experts), experts


def _unflatten(flat):
    """``{"a/0/b": array}`` -> nested dicts, digit keys as list indices."""
    root = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(root)


@pytest.mark.parametrize("mname,arch", CASES,
                         ids=[f"{m}-{a}" for m, a in CASES])
def test_shard_params_equals_shard_module(ref, mname, arch):
    shape = MESHES[mname]
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    params = _unflatten({k.split("|", 1)[1]: v for k, v in ref[1].items()
                         if k.startswith(arch + "|")})
    rank = RANKS[mname]
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    mesh = ProcessMesh(shape=shape, axis_names=AXES,
                       device=torch.device("cpu"), rank=rank,
                       backend="gloo", root_shape=shape, root_axes=AXES,
                       root_coords=coords, groups={})
    assert choose_ep_axes(cfg, mesh) == EP[mname]
    _, specs, _, _ = serve_state_shapes(cfg, mesh, BATCH, SEQ)
    cut = from_jax_params(shard_params(params, specs, mesh, coords), cfg,
                          device="cpu", shard=True)
    module = from_jax_params(params, cfg, device="cpu")
    own = shard_module(module, cfg, mesh)
    got = dict(cut.named_parameters())
    assert set(got) == set(dict(own.named_parameters()))
    for name, p in own.named_parameters():
        assert torch.equal(got[name], p), name
    n_exp = cfg.moe.num_experts
    ep = EP[mname]
    p = mesh.axis_size(ep) if ep else 1
    c = coords[AXES.index(ep[0])] if ep else 0
    e_loc = n_exp // p
    for i, blk in enumerate(module.blocks):
        w = own.blocks[i].moe.w_gate
        assert w.shape[0] == e_loc
        assert torch.equal(w, blk.moe.w_gate[c * e_loc:(c + 1) * e_loc])
        assert torch.equal(own.blocks[i].moe.router, blk.moe.router)
