"""hymba-1.5b [hybrid]: parallel attn + mamba heads [arXiv:2411.13676].

Each block runs attention heads and Mamba (SSM, state=16) heads in
parallel on the same input and fuses their (normalized) outputs.  Most
layers use sliding-window attention; three use full attention (per the
paper).  SSM state + SWA cache => ``long_500k`` applicable.
"""

from .registry import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        head_dim=64,
        ssm_state=16,
        swa_window=1024,
        full_attn_layers=(0, 15, 31),
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke",
        family="hybrid",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=128,
        head_dim=16,
        ssm_state=4,
        swa_window=16,
        full_attn_layers=(0,),
        scan_layers=False,
    )


register("hymba-1.5b", full, smoke)
