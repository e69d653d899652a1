"""megatron-moe-32e: the paper's OWN evaluation workload (section 6.2).

Megatron-LM MoE with 32 experts (one per 'GPU' in the paper's 4x8 testbed;
here: EP over pod(2) x data(16) = 32 shards -> dispatch/combine maximally
cross DCN).  This is the primary arch for validating the end-to-end FLASH
integration (Fig 14) and the capacity-pooling perf work.
"""

from .registry import ModelConfig, MoESpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="megatron-moe-32e",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=50304,
        moe=MoESpec(num_experts=32, top_k=2),
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="megatron-moe-32e-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        moe=MoESpec(num_experts=4, top_k=2),
        scan_layers=False,
    )


register("megatron-moe-32e", full, smoke)
