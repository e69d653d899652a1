"""mixtral-8x7b [moe]: 8 experts top-2, SWA [arXiv:2401.04088].

EP mapping: 8 experts over ``pod``(2) x part of ICI -> dispatch/combine
cross DCN; this is the paper-representative FLASH cell (DESIGN.md section 3).
Sliding-window attention (w=4096) makes ``long_500k`` applicable.
"""

from .registry import ModelConfig, MoESpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        moe=MoESpec(num_experts=8, top_k=2),
        swa_window=4096,
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        moe=MoESpec(num_experts=4, top_k=2),
        swa_window=16,
        scan_layers=False,
    )


register("mixtral-8x7b", full, smoke)
