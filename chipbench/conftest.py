"""Test sizes of the benchmark's cells, for the CPU tests: each cell's own
files with its model and traffic cut to a few widths, in a directory that
stands before the benchmark's own (``harness.Suite``)."""

import json

import pytest

from chipbench import harness

# mixtral's experts over "pod" alone (4 experts divide neither 6 ranks
# nor 3), megatron's over (pod, data): the cells' two MoE paths
SMALL = {
    "mixtral-8x7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=96, vocab=256, num_experts=4,
                         swa_window=16),
    "megatron-moe-32e": dict(n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
                             num_experts=4),
}
MESH = {"mixtral-8x7b": [2, 3, 1], "megatron-moe-32e": [2, 2, 1]}
ROWS = {"prefill-32x512": 6, "train-32x512": 4}


def write_small(root, compute_dtype=None):
    for kind in ("configs", "traffic"):
        (root / kind).mkdir(exist_ok=True)
    for name, over in SMALL.items():
        cfg = json.loads((harness.HERE / "configs" /
                          f"{name}.json").read_text())
        cfg["model"].update(over)
        if compute_dtype:
            cfg["model"]["compute_dtype"] = compute_dtype
        cfg["deployment"]["mesh"] = MESH[name]
        cfg["test_size"] = True
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, rows in ROWS.items():
        tr = json.loads((harness.HERE / "traffic" /
                         f"{name}.json").read_text())
        tr.update(rows=rows, seq_len=16)
        (root / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    return harness.Suite([root, harness.HERE])


@pytest.fixture
def small_suite(tmp_path):
    """The cells at test size, computing in bf16 as the cells do."""
    return write_small(tmp_path)


@pytest.fixture
def small_f32_suite(tmp_path):
    """The cells at test size with the program computing in f32."""
    return write_small(tmp_path, "float32")
