"""The serving cell's check at test size on the CPU: a sound run comes
out correct under the cell's limit, the control (the reference in float8
in the program's place) and each fault the cell can have do not.  The
look for a card is skipped; everything after it is the run's."""

import time

import pytest

from chipbench import faults, harness

CELL = "mixtral-8x7b.prefill-plan"
SEED = 2 ** 31 + 4242


def run(suite, control=False):
    return harness.run_cell(suite, CELL, SEED, 0.3, False, "cpu",
                            time.perf_counter(), control=control)


def test_sound_run_is_correct_and_the_control_is_not(small_suite):
    res = run(small_suite, control=True)
    assert res["correct"], res["checks"]
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    from chipbench.reference import compare

    assert not compare.judge(res["readings"]["control"], limits)["ok"]


# a serving step carries no state from one batch to the next
@pytest.mark.parametrize("fault", ["no_exchange", "pair_skipped",
                                   "half_batch", "token_altered"])
def test_fault_is_not_correct(small_suite, fault):
    with faults.planted(fault):
        res = run(small_suite)
    assert not res["correct"], (fault, res["checks"])
