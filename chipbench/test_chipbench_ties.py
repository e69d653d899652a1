"""The reference's branches at its routing ties, and the served cell's
numbers over ranks, on the CPU at test size."""

import pytest
import torch

from chipbench import weights
from chipbench.reference import compare, model, ties

M = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
         d_ff=96, vocab=256, num_experts=4, top_k=2, capacity_factor=2.0,
         swa_window=16, rope_theta=1e6, rms_norm_eps=1e-6)


def prompts(n=6, s=24):
    return torch.randint(0, M["vocab"], (n, s),
                         generator=torch.Generator().manual_seed(3))


def leaf(m=M):
    return weights.LayerLeaves(dict(m, compute_dtype="bfloat16"), False,
                               2 ** 31 + 17, "cpu")


def test_no_margin_is_the_reference_itself():
    tok = prompts()
    br = ties.branches(M, leaf(), tok, 1, 0.0)
    assert br.owner.tolist() == list(range(6))
    assert br.margin.tolist() == [0.0] * 6
    torch.testing.assert_close(br.logits, model.last_logits(M, leaf(), tok, 1),
                               rtol=1e-5, atol=1e-5)


def test_each_tie_is_taken_both_ways_own_way_first():
    tok = prompts()
    br = ties.branches(M, leaf(), tok, 1, 10.0)
    owner = br.owner.tolist()
    # a margin above every gap splits each request at every layer
    assert owner == sorted(owner)
    assert all(owner.count(r) == 2 ** M["n_layers"] for r in range(6))
    first = [owner.index(r) for r in range(6)]
    assert br.margin[first].tolist() == [0.0] * 6
    torch.testing.assert_close(br.logits[first],
                               model.last_logits(M, leaf(), tok, 1),
                               rtol=1e-5, atol=1e-5)
    assert (br.margin[[i for i in range(len(owner)) if i not in first]]
            > 0).all()
    capped = ties.branches(M, leaf(), tok, 1, 10.0, most=3)
    assert all(capped.owner.tolist().count(r) == 3 for r in range(6))


def test_a_dropping_configuration_is_refused():
    m = dict(M, capacity_factor=0.5)
    with pytest.raises(ValueError, match="dropless"):
        ties.branches(m, leaf(m), prompts(), 1, 0.2)


def test_nearest_branch_and_rank_median():
    tok = prompts()
    br = ties.branches(M, leaf(), tok, 1, 10.0)
    owner = br.owner.tolist()
    # a program that answers each request as its last branch does
    last = [len(owner) - 1 - owner[::-1].index(r) for r in range(6)]
    program = br.logits[last]
    near = compare.tie_readings(program, br, 10.0)
    assert max(near["errs"]) < 1e-6 and max(near["gaps"]) < 1e-6
    own = compare.tie_readings(program, br, 0.0)
    assert max(own["errs"]) > 1e-3
    # one stray request of a rank's four passes, two do not
    ranks = [0, 0, 0, 0, 1, 1, 1, 1]
    assert compare.rank_median([0.03, 0.5, 0.02, 0.04] + [0.03] * 4,
                               ranks) == pytest.approx(0.03)
    assert compare.rank_median([0.03, 0.5, 0.6, 0.04] + [0.03] * 4,
                               ranks) == pytest.approx(0.04)
    assert compare.rank_median([0.03, 0.5, 0.6, 0.7] + [0.03] * 4,
                               ranks) == pytest.approx(0.5)
