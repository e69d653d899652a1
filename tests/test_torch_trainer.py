"""The port's fault-tolerant ``Trainer``, its checkpoints, AdamW and the
cosine schedule.

The cases of ``tests/test_trainer.py`` for the port (loss decreases, resume
continues, resume is bit for bit an unbroken run, a preemption checkpoint,
the straggler watchdog), on ``smoke_config("qwen3-0.6b")`` as there and on
megatron-moe-32e's smoke config on a local (2, 2, 1) mesh; the checkpoint
format's round trip, garbage collection, torn saves and shape checks; and
AdamW and the cosine schedule against the reference's on the same numpy
trees (within 1e-6 of each tensor's largest value: the same f32
arithmetic, fused differently).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch.checkpoint import (available_steps, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import (TrainOptions, init_train_state,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_update, constant_schedule,
                               cosine_schedule, global_norm, init_opt_state)
from repro_torch.runtime import Trainer, TrainerConfig


def _setup(arch="qwen3-0.6b", steps=12, seq=32, batch=4, mesh=None):
    cfg = smoke_config(arch)
    opts = TrainOptions(peak_lr=5e-3, warmup_steps=2, total_steps=steps)
    m = make_mesh(mesh, ("pod", "data", "model"), device="cpu") \
        if mesh else None
    step_fn = make_train_step(cfg, m, opts, device="cpu")
    model = build_model(cfg, "cpu", train=True)

    def init_state():   # a fresh state each time: the step works in place
        return init_train_state(model.init(torch.Generator().manual_seed(0)))

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch), cfg)
    return step_fn, init_state, data.batch


def test_loss_decreases(tmp_path):
    step_fn, init_state, batches = _setup(steps=30)
    tcfg = TrainerConfig(total_steps=30, ckpt_dir=str(tmp_path),
                         ckpt_every=100, log_every=5)
    Trainer(tcfg, step_fn, init_state, batches).run()
    recs = [json.loads(line) for line in
            open(os.path.join(str(tmp_path), "metrics.jsonl"))]
    assert recs[-1]["loss"] < recs[0]["loss"] * 0.9, (
        recs[0]["loss"], recs[-1]["loss"])


def test_resume_continues_from_checkpoint(tmp_path):
    step_fn, init_state, batches = _setup(steps=8)
    ckpt = str(tmp_path)
    r1 = Trainer(TrainerConfig(total_steps=4, ckpt_dir=ckpt, ckpt_every=2),
                 step_fn, init_state, batches).run()
    assert r1["stopped_at"] == 4
    seen = []

    def batches2(step):
        seen.append(step)
        return batches(step)

    r2 = Trainer(TrainerConfig(total_steps=8, ckpt_dir=ckpt, ckpt_every=2),
                 step_fn, init_state, batches2).run()
    assert r2["stopped_at"] == 8
    assert min(seen) == 4, f"resume did not skip completed steps: {seen}"
    assert int(r2["state"]["step"]) == 8


@pytest.mark.parametrize("arch,mesh", [("qwen3-0.6b", None),
                                       ("megatron-moe-32e", (2, 2, 1))])
def test_resume_bitwise_identical(tmp_path, arch, mesh):
    """A run stopped at step 3 and resumed equals an unbroken run, bit for
    bit on the CPU: parameters, moments and the step count."""
    step_fn, init_state, batches = _setup(arch, steps=6, batch=8, mesh=mesh)
    ra = Trainer(TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "a"),
                               ckpt_every=100), step_fn, init_state,
                 batches).run()
    ckpt_b = str(tmp_path / "b")
    Trainer(TrainerConfig(total_steps=3, ckpt_dir=ckpt_b, ckpt_every=3),
            step_fn, init_state, batches).run()
    rb = Trainer(TrainerConfig(total_steps=6, ckpt_dir=ckpt_b,
                               ckpt_every=100), step_fn, init_state,
                 batches).run()
    sa, sb = ra["state"], rb["state"]
    for (ka, a), (kb, b) in zip(sa["params"].named_parameters(),
                                sb["params"].named_parameters()):
        assert ka == kb and torch.equal(a, b), ka
    for k in sa["opt"].m:
        assert torch.equal(sa["opt"].m[k], sb["opt"].m[k])
        assert torch.equal(sa["opt"].v[k], sb["opt"].v[k])
    assert int(sa["opt"].count) == int(sb["opt"].count) == 6
    assert int(sb["step"]) == 6


def test_preemption_checkpoint(tmp_path):
    """SIGTERM-style preemption saves at the step boundary and reports."""
    step_fn, init_state, batches = _setup(steps=20)
    trainer = Trainer(TrainerConfig(total_steps=20, ckpt_dir=str(tmp_path),
                                    ckpt_every=1000),
                      step_fn, init_state, batches)
    orig = trainer.train_step

    def step_then_preempt(state, batch):
        out = orig(state, batch)
        if int(out[0]["step"]) == 3:
            trainer._preempted = True  # simulate SIGTERM delivery
        return out

    trainer.train_step = step_then_preempt
    result = trainer.run()
    assert result["preempted"]
    assert result["stopped_at"] == 3
    assert latest_step(str(tmp_path)) == 3


def test_straggler_watchdog(tmp_path):
    events = []
    trainer = Trainer(
        TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path)),
        train_step=None, init_state=None, batches=None,
        straggler_cb=lambda s, dt, med: events.append((s, dt, med)))
    for i in range(20):
        trainer._watch_straggler(i, 0.1)
    trainer._watch_straggler(20, 1.0)  # 10x median
    assert len(events) == 1 and events[0][0] == 20


# -- checkpoints ----------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.randn(16, generator=g)},
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.ones(3), torch.randn(2, 2, generator=g)
                       .to(torch.bfloat16)]}


def _leaves(tree):
    return [tree["params"]["w"], tree["params"]["b"], tree["step"],
            *tree["nested"]]


def test_checkpoint_roundtrip_in_place(tmp_path):
    tree = _tree(0)
    save_checkpoint(str(tmp_path), 7, tree)
    target = _tree(1)
    ptrs = [t.data_ptr() for t in _leaves(target)]
    restored, step = restore_checkpoint(str(tmp_path), target)
    assert step == 7 and restored is target
    assert [t.data_ptr() for t in _leaves(target)] == ptrs
    for a, b in zip(_leaves(tree), _leaves(target)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_layout_latest_and_gc(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        save_checkpoint(root, s, _tree(s), keep_last=2)
    assert available_steps(root) == [3, 4] and latest_step(root) == 4
    d = os.path.join(root, "step_000000004")
    assert sorted(os.listdir(d)) == ["_COMMITTED", "leaves_000.npz",
                                     "manifest.json"]


def test_torn_save_ignored(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree())
    torn = os.path.join(root, "step_000000002")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write("{}")
    assert latest_step(root) == 1


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad)


def test_train_state_roundtrip(tmp_path):
    """A train state (module, OptState, step) restores into a fresh one."""
    cfg = smoke_config("megatron-moe-32e")
    model = build_model(cfg, "cpu", train=True)
    a = init_train_state(model.init(torch.Generator().manual_seed(0)))
    a["opt"].m["embed"].fill_(0.5)
    a["step"] += 3
    save_checkpoint(str(tmp_path), 3, a)
    b = init_train_state(model.init(torch.Generator().manual_seed(1)))
    restore_checkpoint(str(tmp_path), b)
    for (k, p), (_, q) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(b["opt"].m["embed"], a["opt"].m["embed"])
    assert int(b["step"]) == 3


# -- AdamW and the schedule against the reference -----------------------------

def _np_tree(rng):
    return {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "c": np.float32(rng.normal())}


@pytest.mark.parametrize("clip", [None, 1.0, 100.0])
def test_adamw_matches_reference(clip):
    rng = np.random.default_rng(0)
    p0 = _np_tree(rng)
    cfg = AdamWConfig(clip_norm=clip)
    ref_cfg = RefAdamWConfig(clip_norm=clip)
    ref_p = jax.tree.map(jnp.asarray, p0)
    ref_s = ref_init_opt_state(ref_p)
    p = {k: torch.tensor(v) for k, v in p0.items()}
    s = init_opt_state(p)
    sched = cosine_schedule(1e-2, 2, 10)
    ref_sched = ref_cosine(1e-2, 2, 10)
    for step in range(5):
        g = _np_tree(rng)
        ref_p, ref_s, ref_n = ref_adamw_update(
            jax.tree.map(jnp.asarray, g), ref_s, ref_p, ref_sched(step),
            ref_cfg)
        _, s, n = adamw_update({k: torch.tensor(v) for k, v in g.items()},
                               s, p, sched(step), cfg)
        assert abs(float(n) - float(ref_n)) <= 1e-6 * float(ref_n)
        for k in p0:
            for got, want in ((p[k], ref_p[k]), (s.m[k], ref_s.m[k]),
                              (s.v[k], ref_s.v[k])):
                want = np.asarray(want)
                assert np.abs(got.numpy() - want).max() \
                    <= 1e-6 * np.abs(want).max(), (step, k)
    assert int(s.count) == int(ref_s.count) == 5


def test_adamw_clip_and_decay():
    p = {"x": torch.zeros(4)}
    _, _, n = adamw_update({"x": torch.full((4,), 100.0)}, init_opt_state(p),
                           p, 0.1, AdamWConfig(clip_norm=1.0))
    assert float(n) == pytest.approx(200.0)       # reported before clipping
    p = {"x": torch.full((), 10.0)}
    adamw_update({"x": torch.zeros(())}, init_opt_state(p), p, 0.1,
                 AdamWConfig(weight_decay=0.1, clip_norm=None))
    assert float(p["x"]) == pytest.approx(10.0 - 0.1 * 0.1 * 10.0)
    assert float(global_norm({"a": torch.ones(2, 2), "b": torch.ones(5)})) \
        == pytest.approx(3.0)


def test_schedules_match_reference():
    for args in ((1e-3, 10, 100), (3e-4, 1, 10), (5e-3, 0, 7)):
        ours, ref = cosine_schedule(*args), ref_cosine(*args)
        for step in range(0, args[2] + 3):
            want = float(ref(step))
            assert abs(ours(step) - want) <= 1e-6 * abs(want), (args, step)
    assert constant_schedule(0.1)(5) == float(np.float32(0.1))
