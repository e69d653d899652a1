"""The plain reference against the port's path at test size on the CPU:
with the program computing in f32 the two agree to rounding, so what the
cells' limits hold at bf16 is the program's precision, not a difference
of semantics."""

import time

import pytest
import torch

from chipbench import harness
from chipbench.reference import model

SEED = 2 ** 31 + 99


def test_prefill_agrees_in_f32(small_f32_suite):
    res = harness.run_cell(small_f32_suite, "mixtral-8x7b.prefill-plan",
                           SEED, 0.2, False, "cpu", time.perf_counter(),
                           control=True)
    program = res["readings"]["program"]
    # every request, not a rank's median: in f32 nothing lies near a tie
    assert program["logit_err_max"] < 1e-5
    assert program["served_gap_max"] < 1e-4
    assert res["checks"]["rank_logit_err"]["value"] < 1e-5
    assert res["attempted"] > 0 and res["failed"] == 0


def test_training_agrees_in_f32(small_f32_suite):
    res = harness.run_cell(small_f32_suite, "megatron-moe-32e.train", SEED,
                           0.2, False, "cpu", time.perf_counter())
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["loss_gap"] < 1e-6
    assert checks["grad_gap"] < 1e-4
    assert checks["change_gap"] < 1e-4


@pytest.mark.parametrize("tokens,experts,cap", [
    (512, 8, 264),      # mixtral's rank: int(2 * 512 * 2 // 8) + 1 = 257
    (512, 32, 72),      # megatron's rank: 65, to a multiple of 8
    (1024, 8, 640),     # from 1024 tokens, to a multiple of 128
    (16, 4, 24),
    (4, 8, 8),          # at least 8
])
def test_capacity(tokens, experts, cap):
    assert model.capacity(tokens, experts, 2, 2.0) == cap


def test_capacity_drops_later_choices_first():
    """Three tokens all routed to expert 0 first, capacity 8 of 24 choices:
    the (token, choice) pairs past the expert's slots add nothing."""
    m = {"num_experts": 2, "top_k": 1, "capacity_factor": 0.01,
         "d_model": 4}
    router = torch.tensor([[1.0, -1.0]] * 4)
    eye = torch.eye(4)
    leaves = {"b.moe.router": router, "b.moe.w_gate": torch.stack([eye, eye]),
              "b.moe.w_up": torch.stack([eye, eye]),
              "b.moe.w_down": torch.stack([eye, eye])}
    h = torch.ones(1, 10, 4)
    y, _ = model.moe(m, leaves.__getitem__, "b.", h, 1)
    kept = (y.abs().sum(-1) > 0)[0]
    assert kept.tolist() == [True] * 8 + [False] * 2


def test_fp8_control_rounds_to_e4m3():
    x = torch.randn(64, 64, dtype=torch.float64).float()
    q = model._fp8(x)
    assert torch.allclose(q, x, rtol=2 ** -3, atol=x.abs().max() / 448 * 2 ** -6)
    assert not torch.equal(q, x)
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)
    model.fp8_matmul(a, b).sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
