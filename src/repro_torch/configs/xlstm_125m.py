"""xlstm-125m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(pf=2 mLSTM / pf=4/3 sLSTM style folded into the block), no separate FFN.
Recurrent state => ``long_500k`` applicable.  Block pattern follows the
7:1 mLSTM:sLSTM ratio of the paper, adapted to 12 layers.
"""

from .registry import ModelConfig, register

_PATTERN = ("m", "m", "m", "s", "m", "m", "m", "s", "m", "m", "m", "s")


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        block_pattern=_PATTERN,
        norm="layernorm",
        act="gelu",
        scan_layers=False,  # heterogeneous pattern: unrolled
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke",
        family="ssm",
        n_layers=2,
        d_model=32,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab=128,
        block_pattern=("m", "s"),
        norm="layernorm",
        act="gelu",
        scan_layers=False,
    )


register("xlstm-125m", full, smoke)
