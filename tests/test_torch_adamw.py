"""The port's AdamW kernels on the CPU: their plain versions (``ref.py``,
through the wrappers and ``optim.adamw_update``) against the reference's
``adamw_update`` over five steps, for f32 and bf16 masters with gradients
in either dtype, clipped and not; the leaf table the wrappers cut into
launches and blocks; what the wrappers refuse on every device; and the
``adamw.update`` span and counters.

Tolerances: f32 within 1e-6 of each tensor's largest value (the same f32
arithmetic, fused differently); a bf16 master within one bf16 ulp of the
reference's, element by element (both round the same f32 update once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch import trace
from repro_torch.kernels.adamw import (BLOCK_ELEMS, CAPACITY, Launch,
                                       adamw_step, plan, sq_norm)
from repro_torch.launch.roofline import count
from repro_torch.optim import (AdamWConfig, adamw_update, cosine_schedule,
                               init_opt_state)

# no 0-d leaf: a tensor of one element whose first moment nears zero by
# cancellation has no largest value to hold its rounding against
SHAPES = {"a": (4, 5), "b": (7,), "c": (2, 1), "d": (3, 11)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tree(rng):
    return {k: (rng.normal(size=s) * 3).astype(np.float32)
            for k, s in SHAPES.items()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 bits of significand)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("master, grad", [("f32", "f32"), ("bf16", "bf16"),
                                          ("bf16", "f32")])
def test_plain_version_matches_reference(master, grad, clip):
    rng = np.random.default_rng(len(master) * 10 + len(grad)
                                + (clip is None))
    p0 = _tree(rng)
    pt, pj = DTYPES[master]
    gt, gj = DTYPES[grad]
    cfg, ref_cfg = AdamWConfig(clip_norm=clip), RefAdamWConfig(clip_norm=clip)
    ref_p = {k: jnp.asarray(v, dtype=pj) for k, v in p0.items()}
    ref_s = ref_init_opt_state(ref_p)
    p = {k: torch.tensor(v).to(pt) for k, v in p0.items()}
    s = init_opt_state(p)
    sched, ref_sched = cosine_schedule(1e-2, 2, 10), ref_cosine(1e-2, 2, 10)
    for step in range(5):
        g = _tree(rng)
        ref_p, ref_s, ref_n = ref_adamw_update(
            {k: jnp.asarray(v, dtype=gj) for k, v in g.items()}, ref_s,
            ref_p, ref_sched(step), ref_cfg)
        _, s, n = adamw_update({k: torch.tensor(v).to(gt)
                                for k, v in g.items()}, s, p, sched(step),
                               cfg)
        assert abs(float(n) - float(ref_n)) <= 1e-6 * float(ref_n)
        for k in p0:
            assert p[k].dtype == pt and s.m[k].dtype == torch.float32
            for got, want in ((s.m[k], ref_s.m[k]), (s.v[k], ref_s.v[k])):
                want = np.asarray(want)
                assert np.abs(got.numpy() - want).max() \
                    <= 1e-6 * np.abs(want).max(), (step, k)
            got = p[k].float().numpy()
            want = np.asarray(jnp.asarray(ref_p[k], jnp.float32))
            if master == "f32":
                assert np.abs(got - want).max() \
                    <= 1e-6 * np.abs(want).max(), (step, k)
            else:
                assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
                    (step, k)
    assert int(s.count) == int(ref_s.count) == 5


def _check_plan(sizes, block, capacity):
    launches = plan(sizes, block, capacity)
    assert [i for x in launches for i in x.leaves] == list(range(len(sizes)))
    for x in launches:
        assert 1 <= len(x.leaves) <= capacity
        assert len(x.first) == len(x.leaves) + 1 and x.first[0] == 0
        for i, a, b in zip(x.leaves, x.first, x.first[1:]):
            assert b - a == -(-sizes[i] // block)
            # the blocks hold the leaf, the last one its tail
            assert (b - a) * block >= sizes[i] > (b - a - 1) * block \
                or sizes[i] == b - a == 0
    return launches


@pytest.mark.parametrize("sizes, block, capacity, want", [
    # tails, an empty leaf, more leaves than one table holds
    ([5, 0, 40, 16, 17], 16, 2,
     [Launch((0, 1), (0, 1, 1)), Launch((2, 3), (0, 3, 4)),
      Launch((4,), (0, 2))]),
    ([32, 33], 32, 4, [Launch((0, 1), (0, 1, 3))]),
    ([], 8, 4, []),
])
def test_plan_cuts_leaves_into_launches_and_blocks(sizes, block, capacity,
                                                   want):
    assert _check_plan(sizes, block, capacity) == want


def test_plan_at_the_kernels_constants():
    """megatron-moe-32e's 23 training leaves take one launch; 150 ragged
    leaves take three, every table full but the last."""
    d, f, e, v = 2048, 8192, 32, 50304
    layer = [d, d * 2048, d * 512, d * 512, 2048 * d, d, d * e,
             e * d * f, e * d * f, e * f * d]
    sizes = [v * d, d, d * v] + 2 * layer
    (one,) = _check_plan(sizes, BLOCK_ELEMS, CAPACITY)
    assert len(one.leaves) == 23 and sum(sizes) == 3_448_383_488
    assert one.first[-1] == sum(-(-n // BLOCK_ELEMS) for n in sizes)
    ragged = [(i * 7919) % 100_003 for i in range(150)]
    launches = _check_plan(ragged, BLOCK_ELEMS, CAPACITY)
    assert [len(x.leaves) for x in launches] == [CAPACITY, CAPACITY, 22]


def _update_args(n=3, **bad):
    t = {k: [torch.zeros(5, 8) for _ in range(n)] for k in "pgmv"}
    for k, v in bad.items():
        t[k][1] = v
    return t


BAD = {
    "noncontig": dict(g=torch.zeros(8, 5).T),
    "moment_bf16": dict(m=torch.zeros(5, 8, dtype=torch.bfloat16)),
    "f16_param": dict(p=torch.zeros(5, 8, dtype=torch.float16)),
    "f64_grad": dict(g=torch.zeros(5, 8, dtype=torch.float64)),
    "shape": dict(v=torch.zeros(40)),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("bad", list(BAD))
def test_wrappers_reject_what_the_kernels_cannot_take(bad, device):
    """Checked on every device (meta while counting, as in the dry run),
    so a CPU run finds what the card refuses."""
    t = {k: [x.to(device) for x in v]
         for k, v in _update_args(**BAD[bad]).items()}
    with count():
        with pytest.raises(ValueError):
            adamw_step(t["p"], t["g"], t["m"], t["v"], lr=1e-3, b1=0.9,
                       b2=0.95, eps=1e-8, weight_decay=0.1, bc1=0.1,
                       bc2=0.05, norm=torch.ones((), device=device),
                       clip_norm=1.0)
        if bad in ("noncontig", "f16_param", "f64_grad"):
            with pytest.raises(ValueError):
                sq_norm(t["g"] if "g" in BAD[bad] else t["p"])


def test_wrappers_reject_meta_outside_a_count():
    x = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError):
        sq_norm(x)
    with pytest.raises(ValueError):
        adamw_step(x, x, x, x, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                   weight_decay=0.1, bc1=0.1, bc2=0.05)


def test_wrappers_on_meta_report_their_bytes():
    """The dry run's view: no work, the formulas' bytes (28 B a f32
    parameter for the update, 4 B a f32 gradient and one f32 a leaf for
    the norm)."""
    t = {k: [torch.zeros(s, device="meta") for s in ((3, 4), (5,))]
         for k in "pgmv"}
    with count() as c:
        assert sq_norm(t["g"]).shape == (2,)
        adamw_step(t["p"], t["g"], t["m"], t["v"], lr=1e-3, b1=0.9,
                   b2=0.95, eps=1e-8, weight_decay=0.1, bc1=0.1, bc2=0.05)
    k = c.summary()["kernels"]
    assert k["sq_norm"] == {"calls": 1, "flops": 0, "bytes": 17 * 4 + 8}
    assert k["adamw_step"] == {"calls": 1, "flops": 0, "bytes": 17 * 28}


def test_trace_records_the_update_span_and_counters():
    p = {"w": torch.ones(6, 4), "b": torch.zeros(5, dtype=torch.bfloat16)}
    g = {"w": torch.full((6, 4), 0.5), "b": torch.ones(5)}
    s = init_opt_state(p)
    trace.reset()
    try:
        with torch.profiler.profile() as prof:
            adamw_update(g, s, p, 1e-3)
        got = trace.snapshot()
    finally:
        trace.reset()
    names = [e.name for e in prof.events()]
    assert "adamw.update" in names and "train.optimizer" in names
    assert got["adamw.elems"] == 29
    # the CPU runs the plain version: no element through the kernel
    assert got.get("adamw.kernel_elems", 0) == 0
    # off the profiler nothing counts
    adamw_update(g, s, p, 1e-3)
    assert trace.snapshot() == {}


@pytest.mark.parametrize("clip", [None, 1.0])
def test_use_kernel_false_runs_the_plain_versions(clip, monkeypatch):
    """``use_kernel=False`` (the step builders' plain path) never calls the
    wrappers, and gives the bits the wrappers' CPU path gives, a
    non-contiguous gradient included."""
    import repro_torch.optim.adamw as opt

    rng = np.random.default_rng(7)
    p = {k: torch.tensor(v) for k, v in _tree(rng).items()}
    p["e"] = torch.tensor(rng.normal(size=(3, 4)), dtype=torch.bfloat16)
    trees = [p, {k: v.clone() for k, v in p.items()}]
    g = {k: torch.tensor(v) for k, v in _tree(rng).items()}
    g["e"] = torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32).T
    assert not g["e"].is_contiguous()
    cfg = AdamWConfig(clip_norm=clip)
    states = [init_opt_state(p) for p in trees]
    _, states[0], n0 = adamw_update(g, states[0], trees[0], 1e-2, cfg)

    def refuse(*a, **kw):
        raise AssertionError("use_kernel=False called a kernel wrapper")
    monkeypatch.setattr(opt, "sq_norm", refuse)
    monkeypatch.setattr(opt, "adamw_step", refuse)
    _, states[1], n1 = adamw_update(g, states[1], trees[1], 1e-2, cfg,
                                    use_kernel=False)
    assert torch.equal(n0, n1)
    for k in trees[0]:
        for a, b in ((trees[0][k], trees[1][k]),
                     (states[0].m[k], states[1].m[k]),
                     (states[0].v[k], states[1].v[k])):
            assert a.dtype == b.dtype and torch.equal(a, b), k
